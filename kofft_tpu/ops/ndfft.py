"""N-D FFT (single device): per-axis batched 1-D transforms.

Reference: ``src/ndfft.rs`` — 2-D/3-D FFT by row-column(-depth) decomposition
over *strided* 1-D FFTs (``ndfft.rs:74-100``, ``:114-153``), whose
gather/scatter hot spot is cache-hostile. This formulation replaces
strided access with moveaxis (XLA lays out/fuses the transpose) + the
contiguous batched matmul engine per axis — the single most important
architectural divergence from the reference (SURVEY.md §3.5). The
mesh-sharded version with all-to-all lives in
``kofft_tpu.parallel.ndfft_sharded``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import trace_key
from ..errors import (EmptyInputError, InvalidValueError,
                      MismatchedLengthsError, require)
from ._complex import merge
from .fft import _is_tracer, engine_fft_planes, resolve_backend

__all__ = ["fft2", "ifft2", "fft3", "ifft3", "fftn", "ifftn",
           "fftn_split", "rfftn", "irfftn", "rfftn_split", "irfftn_split"]


_SMALL_AXES_MAX_N = 256


def _small_axes_zone(shape: tuple, axes: tuple) -> bool:
    """Shape class for the direct per-axis einsum method: >= 2 transform
    axes, each small enough for one dense DFT matmul. Covers the 128^3
    class where the moveaxis round-trips of the generic path dominate.
    Capped at 15 total dims (the einsum letter pool); beyond that the
    generic per-axis path handles it. The 256 cap was chosen on another
    machine and has not been re-measured on the H100."""
    if len(axes) < 2 or len(shape) > 15:
        return False
    return all(2 <= shape[a] <= _SMALL_AXES_MAX_N for a in axes)


def _axis_einsum_planes(xr, xi, axes: tuple, inverse: bool, dtype: str):
    """N-D DFT over small axes as direct dense-DFT einsums IN PLACE of
    the axis — ``Y[a,k,c] = sum_j F[j,k] X[a,j,c]`` — with the Gauss
    3-multiply complex form. No explicit moveaxis: XLA fuses the axis
    relayout into the GEMM. Replaces the reference's strided per-axis
    decomposition (``ndfft.rs:114-153``) for small-axis grids. Inverse
    via conjugation; the 1/n scaling is applied by the caller per axis
    convention."""
    from ..config import lax_precision
    from ..plan import tables
    if inverse:
        yr, yi = _axis_einsum_planes(xr, -xi, axes, False, dtype)
        return yr, -yi
    p = lax_precision()
    nd = xr.ndim
    ltrs = "abcdefghilmnopq"[:nd]   # j, k reserved for the contraction

    def ein(sub, m, v):
        return jnp.einsum(sub, m, v, precision=p)

    for ax in axes:
        a = ax % nd
        n = xr.shape[a]
        fr, fi = tables.dft_matrix(n, dtype)      # symmetric: F[j,k]
        src = ltrs[:a] + "j" + ltrs[a + 1:]
        dst = ltrs[:a] + "k" + ltrs[a + 1:]
        sub = f"jk,{src}->{dst}"
        t1 = ein(sub, jnp.asarray(fr), xr)
        t2 = ein(sub, jnp.asarray(fi), xi)
        t3 = ein(sub, jnp.asarray(fr + fi), xr + xi)
        xr, xi = t1 - t2, t3 - t1 - t2
    return xr, xi


def _inverse_rescale(yr, yi, shape: tuple, axes: tuple, inverse: bool):
    """1/n-per-axis scaling for paths whose engine returns the
    UNNORMALIZED inverse (the einsum route)."""
    if not inverse:
        return yr, yi
    scale = 1.0
    for a in axes:
        scale = scale * shape[a]
    return yr / scale, yi / scale


def _fftn_planes(xr, xi, axes: tuple, inverse: bool, backend: str):
    dtype = str(xr.dtype)
    nd = xr.ndim
    if backend == "jnpfft":
        x = merge(xr, xi)
        y = (jnp.fft.ifftn(x, axes=axes) if inverse
             else jnp.fft.fftn(x, axes=axes))
        return jnp.real(y), jnp.imag(y)
    if backend in ("auto", "xla") and _small_axes_zone(xr.shape, axes):
        yr, yi = _axis_einsum_planes(xr, xi, axes, inverse, dtype)
        return _inverse_rescale(yr, yi, xr.shape, axes, inverse)
    for ax in axes:
        a = ax % nd
        if a != nd - 1:
            xr = jnp.moveaxis(xr, a, -1)
            xi = jnp.moveaxis(xi, a, -1)
        n = xr.shape[-1]
        xr, xi = engine_fft_planes(xr, xi, n, inverse, dtype, backend)
        if inverse:
            xr, xi = xr / n, xi / n
        if a != nd - 1:
            xr = jnp.moveaxis(xr, -1, a)
            xi = jnp.moveaxis(xi, -1, a)
    return xr, xi


@functools.lru_cache(maxsize=None)
def _jit_fftn(shape: tuple, axes: tuple, inverse: bool, backend: str,
              ck: tuple = ()):
    return jax.jit(functools.partial(_fftn_planes, axes=axes,
                                     inverse=inverse, backend=backend))


def _norm_axes(ndim: int, axes: Optional[Sequence[int]]) -> tuple:
    if axes is None:
        axes = tuple(range(ndim))
    axes = tuple(int(a) % ndim for a in axes)
    require(len(set(axes)) == len(axes), InvalidValueError,
            f"repeated axes in {axes}")
    return axes


def fftn_split(xr, xi, axes: Optional[Sequence[int]] = None,
               inverse: bool = False, backend: Optional[str] = None):
    """N-D FFT on SoA planes (traceable)."""
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    require(xr.ndim >= 1, EmptyInputError, "fftn input must have >= 1 dim")
    axes = _norm_axes(xr.ndim, axes)
    b = resolve_backend(backend)
    if _is_tracer(xr) or _is_tracer(xi):
        return _fftn_planes(xr, xi, axes, inverse, b)
    return _jit_fftn(xr.shape, axes, inverse, b, trace_key())(xr, xi)


def _dispatch_nd(x, axes, inverse, backend):
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    if host:
        from ._complex import host_float_dtype
        x = np.asarray(x)
        ft = host_float_dtype(x.real.dtype)
        xr = np.ascontiguousarray(x.real).astype(ft)
        xi = (np.ascontiguousarray(x.imag).astype(ft)
              if np.iscomplexobj(x) else np.zeros_like(xr))
    else:
        x = jnp.asarray(x)
        if jnp.iscomplexobj(x):
            xr, xi = jnp.real(x), jnp.imag(x)
        else:
            xr, xi = x, jnp.zeros_like(x)
    require(xr.ndim >= 1 and min(xr.shape) >= 1, EmptyInputError,
            "fftn input must be non-empty")
    axes = _norm_axes(xr.ndim, axes)
    b = resolve_backend(backend)
    if _is_tracer(xr):
        yr, yi = _fftn_planes(xr, xi, axes, inverse, b)
        return merge(yr, yi)
    yr, yi = _jit_fftn(xr.shape, axes, inverse, b, trace_key())(xr, xi)
    return merge(yr, yi)


def fftn(x, axes: Optional[Sequence[int]] = None,
         backend: Optional[str] = None):
    """N-D FFT over ``axes`` (default: all)."""
    return _dispatch_nd(x, axes, False, backend)


def ifftn(x, axes: Optional[Sequence[int]] = None,
          backend: Optional[str] = None):
    return _dispatch_nd(x, axes, True, backend)


def fft2(x, backend: Optional[str] = None):
    """2-D FFT over the last two axes (reference ``fft2d_inplace``,
    ``ndfft.rs:74-100``)."""
    require(np.ndim(x) >= 2, InvalidValueError, "fft2 needs >= 2 dims")
    return fftn(x, axes=(-2, -1), backend=backend)


def ifft2(x, backend: Optional[str] = None):
    require(np.ndim(x) >= 2, InvalidValueError, "ifft2 needs >= 2 dims")
    return ifftn(x, axes=(-2, -1), backend=backend)


def rfftn_split(x, axes: Optional[Sequence[int]] = None,
                backend: Optional[str] = None):
    """N-D FFT of a REAL input on SoA planes (numpy ``rfftn``
    convention, no reference analog): real one-sided FFT along the LAST
    of ``axes`` (length ``n//2 + 1``), complex FFT over the remaining
    axes. Composes the verified rfft and fftn engines."""
    from .rfft import rfft_split
    x = jnp.asarray(x)
    # uniform complex rejection: host callers hit the same typed error
    # (rfftn below), matching rfft's _prep_real and numpy's complex-input
    # rejection — previously a complex jax.Array slipped through to the
    # engine while host input was silently .real-stripped
    require(not jnp.iscomplexobj(x), InvalidValueError,
            "rfftn input must be real")
    require(x.ndim >= 1 and min(x.shape) >= 1, EmptyInputError,
            "rfftn input must be non-empty")
    axes = _norm_axes(x.ndim, axes)
    require(len(axes) >= 1, InvalidValueError,
            "rfftn needs at least one axis (numpy raises here too)")
    last = axes[-1]
    if last != x.ndim - 1:
        x = jnp.moveaxis(x, last, -1)
    yr, yi = rfft_split(x, backend=backend)
    if last != yr.ndim - 1:
        yr = jnp.moveaxis(yr, -1, last)
        yi = jnp.moveaxis(yi, -1, last)
    if len(axes) > 1:
        yr, yi = fftn_split(yr, yi, axes=axes[:-1], backend=backend)
    return yr, yi


def irfftn_split(yr, yi, n: Optional[int] = None,
                 axes: Optional[Sequence[int]] = None,
                 backend: Optional[str] = None):
    """Inverse of :func:`rfftn_split` -> real signal. ``n`` sets the
    LAST transformed axis's output length (default
    ``2*(shape[axes[-1]] - 1)``, numpy convention); the other axes keep
    their lengths."""
    from .rfft import irfft_split
    yr = jnp.asarray(yr)
    yi = jnp.asarray(yi)
    require(yr.shape == yi.shape, MismatchedLengthsError,
            f"re/im plane shapes differ: {yr.shape} vs {yi.shape}")
    require(yr.ndim >= 1 and min(yr.shape) >= 1, EmptyInputError,
            "irfftn input must be non-empty")
    axes = _norm_axes(yr.ndim, axes)
    require(len(axes) >= 1, InvalidValueError,
            "irfftn needs at least one axis")
    last = axes[-1]
    if len(axes) > 1:
        yr, yi = fftn_split(yr, yi, axes=axes[:-1], inverse=True,
                            backend=backend)
    if last != yr.ndim - 1:
        yr = jnp.moveaxis(yr, last, -1)
        yi = jnp.moveaxis(yi, last, -1)
    x = irfft_split(yr, yi, n=n, backend=backend)
    if last != x.ndim - 1:
        x = jnp.moveaxis(x, -1, last)
    return x


def rfftn(x, axes: Optional[Sequence[int]] = None,
          backend: Optional[str] = None):
    """N-D real FFT (complex output; see :func:`rfftn_split`)."""
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    if host:
        from ._complex import host_float_dtype
        x = np.asarray(x)
        require(not np.iscomplexobj(x), InvalidValueError,
                "rfftn input must be real")
        x = np.ascontiguousarray(x).astype(host_float_dtype(x.dtype))
    yr, yi = rfftn_split(x, axes=axes, backend=backend)
    return merge(yr, yi)


def irfftn(y, n: Optional[int] = None,
           axes: Optional[Sequence[int]] = None,
           backend: Optional[str] = None):
    """Inverse N-D real FFT from a complex spectrum (numpy ``irfftn``
    convention for the last transformed axis's length ``n``)."""
    host = not isinstance(y, (jax.Array, jax.core.Tracer))
    if host:
        from ._complex import host_float_dtype
        y = np.asarray(y)
        ft = host_float_dtype(y.real.dtype)
        yr = np.ascontiguousarray(y.real).astype(ft)
        yi = (np.ascontiguousarray(y.imag).astype(ft)
              if np.iscomplexobj(y) else np.zeros_like(yr))
    else:
        y = jnp.asarray(y)
        yr, yi = (jnp.real(y), jnp.imag(y)) if jnp.iscomplexobj(y) \
            else (y, jnp.zeros_like(y))
    return irfftn_split(yr, yi, n=n, axes=axes, backend=backend)


def fft3(x, backend: Optional[str] = None):
    """3-D FFT over the last three axes (reference ``fft3d_inplace``,
    ``ndfft.rs:114-153``)."""
    require(np.ndim(x) >= 3, InvalidValueError, "fft3 needs >= 3 dims")
    return fftn(x, axes=(-3, -2, -1), backend=backend)


def ifft3(x, backend: Optional[str] = None):
    require(np.ndim(x) >= 3, InvalidValueError, "ifft3 needs >= 3 dims")
    return ifftn(x, axes=(-3, -2, -1), backend=backend)
