"""Real cepstrum, mel filterbank, MFCC.

Reference: ``src/cepstrum.rs:12-98``. The mel filterbank's triangular-filter
loops (``cepstrum.rs:36-69``) become a precomputed sparse (n_mags, n_mel)
weight matrix applied as one matmul (SURVEY.md component 22) —
bit-matching the reference's integer bin-edge arithmetic, including its
``floor(f * (n_fft + 1) / sample_rate)`` bin mapping and its skip of
degenerate filters. MFCC = mel -> log(+1e-12) -> DCT-II, truncated.

The reference's cepstrum accepts only power-of-two n; this build accepts
any n (capability superset).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import lax_precision
from ..errors import EmptyInputError, InvalidValueError, require
from ..plan import tables
from .dct import dct2
from ..config import trace_key
from .fft import _is_tracer, engine_fft_planes, resolve_backend
from ._complex import host_float

__all__ = ["real_cepstrum", "mel_filterbank_matrix", "mel_filterbank", "mfcc"]


def _cepstrum_traced(x, backend: str):
    # unified engine ladder for both FFT passes
    n = x.shape[-1]
    dtype = str(x.dtype)
    yr, yi = engine_fft_planes(x, jnp.zeros_like(x), n, False, dtype,
                               backend)
    logmag = jnp.log(jnp.sqrt(yr * yr + yi * yi) + 1e-12)
    zr, _ = engine_fft_planes(logmag, jnp.zeros_like(logmag), n, True,
                              dtype, backend)
    return zr / n


@functools.lru_cache(maxsize=None)
def _jit_cepstrum(n: int, backend: str, ck: tuple = ()):
    """``ck`` carries config.trace_key() so runtime setters invalidate
    warm entries."""
    return jax.jit(functools.partial(_cepstrum_traced, backend=backend))


def real_cepstrum(x, backend: Optional[str] = None):
    """IFFT(log|FFT(x)| + 1e-12).real (reference ``real_cepstrum``,
    ``cepstrum.rs:12-33``)."""
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    x = host_float(x) if host else jnp.asarray(x)
    require(x.ndim >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "cepstrum input must be non-empty")
    b = resolve_backend(backend)
    if _is_tracer(x):
        return _cepstrum_traced(x, b)
    return _jit_cepstrum(x.shape[-1], b, trace_key())(x)


def mel_filterbank_matrix(n_mags: int, sample_rate: float,
                          num_filters: int) -> np.ndarray:
    """(n_mags, num_filters) triangular-filter weights, reproducing the
    reference's bin arithmetic exactly (``cepstrum.rs:36-69``)."""
    require(num_filters >= 1, InvalidValueError, "num_filters must be >= 1")
    require(sample_rate > 0, InvalidValueError, "sample_rate must be > 0")

    def build():
        f_min, f_max = 0.0, sample_rate / 2.0
        mel_min = 2595.0 * math.log10(1.0 + f_min / 700.0)
        mel_max = 2595.0 * math.log10(1.0 + f_max / 700.0)
        mel_pts = [mel_min + (mel_max - mel_min) * i / (num_filters + 1)
                   for i in range(num_filters + 2)]
        freqs = [700.0 * (10.0 ** (m / 2595.0) - 1.0) for m in mel_pts]
        bins = [int(math.floor(f * (n_mags + 1.0) / sample_rate))
                for f in freqs]
        w = np.zeros((n_mags, num_filters), dtype=np.float32)
        for m in range(1, num_filters + 1):
            b0, b1, b2 = bins[m - 1], bins[m], bins[m + 1]
            if b1 == b0 or b2 == b1:
                continue  # degenerate filter skipped (cepstrum.rs:55-57)
            for k in range(b0, min(b1, n_mags)):
                w[k, m - 1] += (k - b0) / (b1 - b0)
            for k in range(b1, min(b2, n_mags)):
                w[k, m - 1] += (b2 - k) / (b2 - b1)
        return w
    return tables.custom(("mel", n_mags, float(sample_rate), num_filters,
                          "float32"), build)


def mel_filterbank(fft_mags, sample_rate: float, num_filters: int):
    """Mel energies: one matmul against the cached filter matrix."""
    host = not isinstance(fft_mags, (jax.Array, jax.core.Tracer))
    x = (host_float(fft_mags) if host
         else jnp.asarray(fft_mags))
    require(x.ndim >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "mel_filterbank input must be non-empty")
    w = mel_filterbank_matrix(x.shape[-1], sample_rate, num_filters)
    y = jnp.einsum("...i,ik->...k", jnp.asarray(x), w,
                   precision=lax_precision())
    return np.asarray(y) if host and not _is_tracer(y) else y


def mfcc(fft_mags, sample_rate: float, num_mel: int, num_coeffs: int):
    """MFCCs from a magnitude spectrum: mel -> log -> DCT-II -> truncate
    (reference ``mfcc``, ``cepstrum.rs:72-98``)."""
    require(num_coeffs <= num_mel, InvalidValueError,
            f"num_coeffs ({num_coeffs}) > num_mel ({num_mel})")
    mel = mel_filterbank(fft_mags, sample_rate, num_mel)
    logmel = jnp.log(jnp.asarray(mel) + 1e-12)
    coeffs = dct2(logmel)[..., :num_coeffs]
    host = not isinstance(fft_mags, (jax.Array, jax.core.Tracer))
    if host and not _is_tracer(coeffs):
        return np.asarray(coeffs)
    return coeffs
