"""O(n log n) FFT-composed fast paths for the trigonometric transforms.

The DCT/DST modules' primary engine is a cached cosine/sine-matrix matmul
— fine for small/mid n but O(n^2) in both FLOPs and
*matrix bytes* (n = 2^16 would need a 16 GB table). The reference's
``DctPlanner`` solves this with a length-2n rfft (``src/dct.rs:22-105``);
these are the equivalents here, one identity per kind, all reducing to

    extend/chirp-premultiply -> FFT_m -> twiddle postmultiply -> Re/Im

with m = 2n (2(n-1) / 2(n+1) for the type-I transforms), so large
transforms ride the same FFT engine ladder as everything else.

Identities (verified against the matrix forms in tests/test_transforms):
  DCT-II : X_k = Re( e^{-i pi k/(2n)}      F_{2n}([x, 0])_k )
  DCT-III: X_k = Re( F_{2n}([x' c, 0])_k ),      x'_0 = x_0/2, c_i = e^{-i pi i/(2n)}
  DCT-IV : X_k = Re( e^{-i pi (2k+1)/(4n)} F_{2n}([x c, 0])_k )
  DCT-I  : X_k = Re( rfft([x, x_{n-2}..x_1])_k )            (m = 2(n-1))
  DST-II : X_k = -Im( e^{-i pi (k+1)/(2n)} F_{2n}([x, 0])_{k+1} )
  DST-III: X_k = x_0/2 - Im( F_{2n}([x c, 0])_k )           (reference's
           idiosyncratic constant term; c as in DCT-III)
  DST-IV : X_k = -Im( e^{-i pi (2k+1)/(4n)} F_{2n}([x c, 0])_k )
  DST-I  : X_k = -Im( rfft([0, x, 0, -x_{n-1}..-x_0])_{k+1} ) / 2
           (m = 2(n+1) antisymmetric extension)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..plan import tables


def _post(kind: str, n: int, dtype: str):
    """(re, im) of the k-indexed post-twiddle, host f64 -> dtype."""
    def build():
        k = np.arange(n, dtype=np.float64)
        if kind == "half":           # e^{-i pi k/(2n)}
            ang = -np.pi * k / (2 * n)
        elif kind == "half_shift":   # e^{-i pi (k+1)/(2n)}
            ang = -np.pi * (k + 1.0) / (2 * n)
        else:                        # "quarter": e^{-i pi (2k+1)/(4n)}
            ang = -np.pi * (2 * k + 1.0) / (4 * n)
        return (np.cos(ang).astype(dtype), np.sin(ang).astype(dtype))

    return tables.custom(("trig_post", kind, n, dtype), build)


def _chirp(n: int, dtype: str):
    """c_i = e^{-i pi i/(2n)} as (re, im) — the same table as the 'half'
    post-twiddle, aliased so each (n, dtype) materializes it once."""
    return _post("half", n, dtype)


def _fft2n_planes(xr, xi, m: int):
    """Engine FFT of zero-padded planes to length m (unnormalized)."""
    from .fft import _fft_traced_planes, resolve_backend
    pad = [(0, 0)] * (xr.ndim - 1) + [(0, m - xr.shape[-1])]
    xr = jnp.pad(xr, pad)
    xi = jnp.pad(xi, pad)
    return _fft_traced_planes(xr, xi, m, False, None, resolve_backend())


def _rfft_m_planes(x, m: int):
    from .fft import resolve_backend
    from .rfft import _rfft_planes
    if x.shape[-1] < m:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, m - x.shape[-1])]
        x = jnp.pad(x, pad)
    return _rfft_planes(x, m, resolve_backend())


def fast_dct(kind: int, x):
    """FFT-composed DCT along the last axis; reference conventions
    (same outputs as the matrix path within f32 tolerance)."""
    n = x.shape[-1]
    dtype = str(x.dtype)
    if kind == 1:
        # symmetric extension [x, x_{n-2}..x_1], length 2(n-1)
        ext = jnp.concatenate([x, jnp.flip(x[..., 1:-1], axis=-1)], axis=-1)
        yr, _ = _rfft_m_planes(ext, 2 * (n - 1))
        return yr[..., :n]
    if kind == 2:
        yr, yi = _rfft_m_planes(x, 2 * n)
        pr, pi = _post("half", n, dtype)
        return yr[..., :n] * pr - yi[..., :n] * pi
    if kind == 3:
        cr, ci = _chirp(n, dtype)
        head = x[..., :1] * 0.5
        xp = jnp.concatenate([head, x[..., 1:]], axis=-1)
        yr, _yi = _fft2n_planes(xp * cr, xp * ci, 2 * n)
        return yr[..., :n]
    # kind == 4
    cr, ci = _chirp(n, dtype)
    yr, yi = _fft2n_planes(x * cr, x * ci, 2 * n)
    pr, pi = _post("quarter", n, dtype)
    return yr[..., :n] * pr - yi[..., :n] * pi


def fast_dst(kind: int, x):
    """FFT-composed DST along the last axis; reference conventions
    (including the reference's non-standard DST-III constant term)."""
    n = x.shape[-1]
    dtype = str(x.dtype)
    if kind == 1:
        zero = jnp.zeros_like(x[..., :1])
        ext = jnp.concatenate([zero, x, zero, -jnp.flip(x, axis=-1)],
                              axis=-1)
        _, yi = _rfft_m_planes(ext, 2 * (n + 1))
        return -0.5 * yi[..., 1: n + 1]
    if kind == 2:
        yr, yi = _rfft_m_planes(x, 2 * n)
        pr, pi = _post("half_shift", n, dtype)
        # -Im(post * Y_{k+1}) = -(yr*pi + yi*pr)
        return -(yr[..., 1: n + 1] * pi + yi[..., 1: n + 1] * pr)
    if kind == 3:
        cr, ci = _chirp(n, dtype)
        _, yi = _fft2n_planes(x * cr, x * ci, 2 * n)
        return x[..., :1] * 0.5 - yi[..., :n]
    # kind == 4
    cr, ci = _chirp(n, dtype)
    yr, yi = _fft2n_planes(x * cr, x * ci, 2 * n)
    pr, pi = _post("quarter", n, dtype)
    return -(yr[..., :n] * pi + yi[..., :n] * pr)
