"""Hilbert transform / analytic signal via FFT one-sided doubling.

Reference: ``src/hilbert.rs:13-47`` — FFT, double bins 1..n/2 (even n) or
1..(n-1)/2 (odd n), zero the negative-frequency half, IFFT. The reference
accepts only power-of-two n (a no_std limitation, ``hilbert.rs:17-19``);
this build accepts any n since the engine handles arbitrary sizes — a
capability superset, not a semantic divergence.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import trace_key
from ..errors import EmptyInputError, require
from ._complex import merge, host_float
from .fft import _is_tracer, engine_fft_planes, resolve_backend

__all__ = ["hilbert_analytic", "hilbert_analytic_split", "hilbert"]


def _sideband_mask(n: int) -> np.ndarray:
    """Gain per bin: 1 at DC (and Nyquist for even n), 2 for positive
    frequencies, 0 for negative (reference ``hilbert.rs:28-44``)."""
    g = np.zeros(n, dtype=np.float32)
    g[0] = 1.0
    if n % 2 == 0:
        g[n // 2] = 1.0
        g[1: n // 2] = 2.0
    else:
        g[1: (n - 1) // 2 + 1] = 2.0
    return g


def _analytic_planes(x, backend: str):
    # unified engine ladder: the FFT->mask->IFFT composite rides the
    # same engines as the core transforms
    n = x.shape[-1]
    dtype = str(x.dtype)
    yr, yi = engine_fft_planes(x, jnp.zeros_like(x), n, False, dtype,
                               backend)
    g = _sideband_mask(n)
    yr, yi = yr * g, yi * g
    zr, zi = engine_fft_planes(yr, yi, n, True, dtype, backend)
    return zr / n, zi / n


@functools.lru_cache(maxsize=None)
def _jit(n: int, backend: str, ck: tuple = ()):
    """``ck`` carries config.trace_key() so runtime setters invalidate
    warm entries."""
    return jax.jit(functools.partial(_analytic_planes, backend=backend))


def hilbert_analytic_split(x, backend: Optional[str] = None):
    """Analytic signal as (re, im) planes (traceable)."""
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    x = host_float(x) if host else jnp.asarray(x)
    require(x.ndim >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "hilbert input must be non-empty")
    b = resolve_backend(backend)
    if _is_tracer(x):
        return _analytic_planes(x, b)
    return _jit(x.shape[-1], b, trace_key())(x)


def hilbert_analytic(x, backend: Optional[str] = None):
    """Analytic signal: x + i*H[x] (reference ``hilbert_analytic``)."""
    return merge(*hilbert_analytic_split(x, backend=backend))


def hilbert(x, backend: Optional[str] = None):
    """The Hilbert transform itself, H[x] = Im(analytic(x))."""
    _, zi = hilbert_analytic_split(x, backend=backend)
    return zi
