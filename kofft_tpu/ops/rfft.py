"""Real FFT: one-sided ``n//2 + 1`` spectrum, numpy/reference layout.

Capability counterpart of the reference's ``src/rfft.rs`` (937 LoC). The
reference's algorithm — pack even/odd samples into a half-size complex
FFT, Hermitian-unpack with twiddles (``rfft.rs:425-508``), SIMD
post-processing variants (``rfft.rs:510-774``) — halves FLOPs at the
price of stride-2 deinterleaves and reversals. This build computes the
full complex FFT of the real signal and slices one side; the inverse
reconstructs the Hermitian spectrum with a single half-length flip and
keeps the real plane of the full inverse. Outputs are identical to the
reference/numpy to f32 precision; the API surface (rfft/irfft + split
variants) mirrors ``RealFftImpl`` (``rfft.rs:775-837``).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import trace_key
from ..errors import (EmptyInputError, InvalidValueError,
                      MismatchedLengthsError, require)
from ._complex import merge, split
from .fft import (_is_tracer, _norm_scale, _use_jnp_fft, engine_fft_planes,
                  resolve_backend)

__all__ = ["rfft", "irfft", "rfft_split", "irfft_split"]


def _rfft_planes(x, n: int, backend: str):
    """real (..., n) -> one-sided planes (..., n//2+1), unnormalized.

    Full n-point complex FFT of the real signal, sliced to one side. The
    textbook half-size even/odd packing (which the reference implements,
    ``rfft.rs:425-465``) halves the FLOPs but pays a stride-2 deinterleave
    plus Hermitian-unpack flips; it has not been measured on the H100."""
    if _use_jnp_fft(backend, n):
        y = jnp.fft.rfft(x.astype(jnp.promote_types(x.dtype, jnp.float32)),
                         n)
        return jnp.real(y).astype(x.dtype), jnp.imag(y).astype(x.dtype)
    yr, yi = engine_fft_planes(x, jnp.zeros_like(x), n, False, str(x.dtype),
                               backend)
    return yr[..., : n // 2 + 1], yi[..., : n // 2 + 1]


def _irfft_planes(yr, yi, n: int, backend: str):
    """one-sided planes (..., n//2+1) -> real (..., n), unnormalized (n*x).

    Rebuilds the full Hermitian spectrum (one half-length flip) and takes
    the real plane of the full inverse — which also reproduces numpy's
    implicit discard of unrealizable DC/Nyquist imaginary parts exactly
    (numpy computes Re(ifft(full)) the same way)."""
    tail_r = jnp.flip(yr[..., 1: (n + 1) // 2], axis=-1)
    tail_i = -jnp.flip(yi[..., 1: (n + 1) // 2], axis=-1)
    fr = jnp.concatenate([yr[..., : n // 2 + 1], tail_r], axis=-1)
    fi = jnp.concatenate([yi[..., : n // 2 + 1], tail_i], axis=-1)
    xr, _ = engine_fft_planes(fr, fi, n, True, str(yr.dtype), backend)
    return xr


# --------------------------------------------------------------------------
# traced + jitted entries
# --------------------------------------------------------------------------

def _rfft_traced(x, n: int, norm: Optional[str], backend: str):
    yr, yi = _rfft_planes(x, n, backend)
    s = _norm_scale(n, norm, False)
    if s is not None:
        yr, yi = yr * s, yi * s
    return yr, yi


def _irfft_traced(yr, yi, n: int, norm: Optional[str], backend: str):
    x = _irfft_planes(yr, yi, n, backend)
    s = _norm_scale(n, norm, True)
    if s is not None:
        x = x * s
    return x


@functools.lru_cache(maxsize=None)
def _jitted_rfft(n: int, norm: Optional[str], backend: str, ck: tuple = ()):
    def f(x):
        yr, yi = _rfft_traced(x, n, norm, backend)
        return merge(yr, yi)
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _jitted_rfft_pp(n: int, norm: Optional[str], backend: str,
                    ck: tuple = ()):
    return jax.jit(functools.partial(_rfft_traced, n=n, norm=norm,
                                     backend=backend))


@functools.lru_cache(maxsize=None)
def _jitted_irfft_pp(n: int, norm: Optional[str], backend: str,
                     ck: tuple = ()):
    return jax.jit(functools.partial(_irfft_traced, n=n, norm=norm,
                                     backend=backend))


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def _prep_real(x, n: Optional[int], axis: int):
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    xp = np if host else jnp
    x = xp.asarray(x)
    require(x.ndim >= 1, EmptyInputError, "input must have at least 1 dim")
    require(not (host and np.iscomplexobj(x)) and
            not (not host and jnp.iscomplexobj(x)),
            InvalidValueError, "rfft input must be real")
    if host:
        from ._complex import host_float
        x = host_float(x)
    ax = axis if axis >= 0 else x.ndim + axis
    require(0 <= ax < x.ndim, InvalidValueError,
            f"axis {axis} out of range for ndim {x.ndim}")
    if ax != x.ndim - 1:
        x = xp.moveaxis(x, ax, -1)
    m = x.shape[-1]
    require(m >= 1 or (n is not None and n >= 1), EmptyInputError,
            "rfft input must be non-empty")
    if n is not None:
        require(n >= 1, InvalidValueError, f"n must be >= 1, got {n}")
        if n < m:
            x = x[..., :n]
        elif n > m:
            pad = [(0, 0)] * (x.ndim - 1) + [(0, n - m)]
            x = xp.pad(x, pad)
        m = n
    return x, m


def rfft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None, backend: Optional[str] = None):
    """One-sided real FFT (length ``n//2 + 1`` along ``axis``).

    Reference surface: ``RealFftImpl::rfft`` (``src/rfft.rs:775-837``)."""
    b = resolve_backend(backend)
    x, m = _prep_real(x, n, axis)
    if _is_tracer(x):
        yr, yi = _rfft_traced(x, m, norm, b)
        y = merge(yr, yi)
    else:
        y = _jitted_rfft(m, norm, b, trace_key())(x)
    ax = axis if axis >= 0 else y.ndim + axis
    if ax != y.ndim - 1:
        y = jnp.moveaxis(y, -1, ax)
    return y


def irfft(y, n: Optional[int] = None, axis: int = -1,
          norm: Optional[str] = None, backend: Optional[str] = None):
    """Inverse of :func:`rfft` -> real signal of length ``n``
    (default ``2*(y.shape[axis]-1)``). Reference ``irfft``
    (``src/rfft.rs:468-508``)."""
    b = resolve_backend(backend)
    host = not isinstance(y, (jax.Array, jax.core.Tracer))
    xp = np if host else jnp
    y = xp.asarray(y)
    require(y.ndim >= 1 and y.shape[axis] >= 1, EmptyInputError,
            "irfft input must be non-empty")
    ax = axis if axis >= 0 else y.ndim + axis
    if ax != y.ndim - 1:
        y = xp.moveaxis(y, ax, -1)
    k = y.shape[-1]
    m = n if n is not None else 2 * (k - 1)
    require(m >= 1, InvalidValueError, f"output length must be >= 1, got {m}")
    want = m // 2 + 1
    if k < want:
        pad = [(0, 0)] * (y.ndim - 1) + [(0, want - k)]
        y = xp.pad(y, pad)
    elif k > want:
        y = y[..., :want]
    if host:
        from ._complex import host_float_dtype
        ft = host_float_dtype(y.real.dtype)
        yr = np.ascontiguousarray(y.real).astype(ft)
        yi = np.ascontiguousarray(y.imag).astype(ft)
    else:
        yr, yi = split(y)
    if _is_tracer(yr):
        x = _irfft_traced(yr, yi, m, norm, b)
    else:
        x = _jitted_irfft_pp(m, norm, b, trace_key())(yr, yi)
    if ax != x.ndim - 1:
        x = jnp.moveaxis(x, -1, ax)
    return x


def rfft_split(x, norm: Optional[str] = None, backend: Optional[str] = None):
    """Real FFT with SoA plane outputs (traceable)."""
    x = jnp.asarray(x)
    require(x.ndim >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "rfft input must be non-empty")
    n = x.shape[-1]
    b = resolve_backend(backend)
    if _is_tracer(x):
        return _rfft_traced(x, n, norm, b)
    return _jitted_rfft_pp(n, norm, b, trace_key())(x)


def irfft_split(yr, yi, n: Optional[int] = None, norm: Optional[str] = None,
                backend: Optional[str] = None):
    """Inverse real FFT from SoA planes (traceable)."""
    yr = jnp.asarray(yr)
    yi = jnp.asarray(yi)
    require(yr.shape == yi.shape, MismatchedLengthsError,
            f"re/im plane shapes differ: {yr.shape} vs {yi.shape}")
    k = yr.shape[-1]
    m = n if n is not None else 2 * (k - 1)
    b = resolve_backend(backend)
    if _is_tracer(yr) or _is_tracer(yi):
        return _irfft_traced(yr, yi, m, norm, b)
    return _jitted_irfft_pp(m, norm, b, trace_key())(yr, yi)
