"""Bluestein (chirp-Z) FFT for arbitrary / non-smooth sizes.

Reference: planner chirp cache ``src/fft.rs:410-433``, algorithm
``src/fft.rs:1088-1132``. Identity used (same as the reference):

    jk = (j^2 + k^2 - (k-j)^2) / 2
    X[k] = c[k] * sum_j (x[j] * c[j]) * conj(c)[k - j],   c[j] = e^{-i pi j^2 / n}

i.e. a linear convolution with the conjugate chirp, computed as a circular
convolution of pow2 size m >= 2n-1 over the smooth matmul engine. The
FFT of the padded conjugate-chirp kernel is precomputed on host in float64
and cached as a device constant (the reference caches ``fft(b)`` in its
planner the same way). Compile-cache cardinality stays bounded because m is
bucketed to the next power of two (SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..plan import chirp_np, next_pow2, tables
from ._complex import cmul


def _bfft_tables(n: int, m: int, dtype: str):
    """Cached constants: FFT of the wrapped conjugate chirp b, length m."""
    def build():
        cr, ci = chirp_np(n)           # c[j] = exp(-i pi j^2 / n), float64
        b = np.zeros(m, dtype=np.complex128)
        c = cr + 1j * ci
        bc = np.conj(c)                # b[j] = exp(+i pi j^2 / n)
        b[:n] = bc
        if n > 1:
            b[m - n + 1:] = bc[1:][::-1]   # b[m - j] = b[j], j = 1..n-1
        bf = np.fft.fft(b)             # host float64 — constant generation
        return (bf.real.astype(dtype), bf.imag.astype(dtype))
    return tables.custom(("bluestein_bfft", n, m, dtype), build)


def _bluestein_planes(xr, xi, n: int, dtype: str, backend: str = "auto"):
    """Unnormalized forward DFT of non-smooth length n on SoA planes.

    The caller's backend threads through to the inner pow2 transforms:
    'auto' rides the dispatched engine, an
    explicit name is honored exactly (engine_fft_planes contract)."""
    from .fft import engine_fft_planes  # no recursion: m is pow2-smooth

    m = next_pow2(2 * n - 1)
    cr, ci = tables.chirp(n, dtype)

    ar, ai = cmul(xr, xi, cr, ci)
    pad = [(0, 0)] * (ar.ndim - 1) + [(0, m - n)]
    ar = jnp.pad(ar, pad)
    ai = jnp.pad(ai, pad)

    fr, fi = engine_fft_planes(ar, ai, m, False, dtype, backend)
    br, bi = _bfft_tables(n, m, dtype)
    pr, pi = cmul(fr, fi, br, bi)
    # unnormalized inverse (= m * ifft), so scale by 1/m
    qr, qi = engine_fft_planes(pr, pi, m, True, dtype, backend)
    qr = qr[..., :n] * (1.0 / m)
    qi = qi[..., :n] * (1.0 / m)
    return cmul(qr, qi, cr, ci)
