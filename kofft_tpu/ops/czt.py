"""Chirp Z-Transform: X_k = sum_i x_i * a^{-i} * w^{i*k},  k in [0, m).

Reference: ``src/czt.rs:16-54`` — a naive O(n*m) double loop over real
input with complex ``w`` and starting point ``a``. Two paths:

  * ``czt`` (default): the O(n*m) kernel *as a matmul* against the cached
    (n, m) chirp matrix; supports arbitrary (possibly non-unit-modulus)
    ``w``/``a`` exactly like the reference.
  * ``czt_fast``: O((n+m) log) Bluestein factorization
    w^{ik} = w^{(i^2 + k^2 - (k-i)^2)/2} -> chirp-premultiply, FFT
    convolution with the conjugate chirp, chirp-postmultiply. Requires
    |w| = 1 (chirp powers explode otherwise); used for large unit-modulus
    transforms (the zoom-FFT use case).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import lax_precision, trace_key
from ..errors import EmptyInputError, InvalidValueError, require
from ..plan import next_pow2, tables
from ._complex import cmul, merge, host_float
from .fft import engine_fft_planes, _is_tracer

__all__ = ["czt", "czt_fast", "czt_split"]


def _czt_matrix(n: int, m: int, w: complex, a: complex, dtype: str):
    """M[i, k] = a^{-i} * w^{i*k}, host complex128."""
    def build():
        i = np.arange(n, dtype=np.float64)[:, None]
        k = np.arange(m, dtype=np.float64)[None, :]
        # powers via exp/log in complex128 (handles non-unit modulus);
        # a == 0 follows the reference's guard (a^-1 treated as 0)
        ai = np.zeros(n, np.complex128) if a == 0 else np.exp(
            -i[:, 0] * np.log(complex(a)))
        wik = np.exp((i * k) * np.log(complex(w)))
        mat = ai[:, None] * wik
        return (mat.real.astype(dtype), mat.imag.astype(dtype))
    return tables.custom(("czt", n, m, complex(w), complex(a), dtype), build)


def _czt_traced(x, m: int, w: complex, a: complex):
    n = x.shape[-1]
    mr, mi = _czt_matrix(n, m, w, a, str(x.dtype))
    p = lax_precision()
    yr = jnp.einsum("...i,ik->...k", x, mr, precision=p)
    yi = jnp.einsum("...i,ik->...k", x, mi, precision=p)
    return yr, yi


@functools.lru_cache(maxsize=None)
def _jit(n: int, m: int, w: complex, a: complex, ck: tuple = ()):
    return jax.jit(lambda x: _czt_traced(x, m, w, a))


def czt_split(x, m: int, w: complex, a: complex = 1.0 + 0j):
    """CZT returning (re, im) planes (traceable)."""
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    x = host_float(x) if host else jnp.asarray(x)
    require(x.ndim >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "czt input must be non-empty")
    require(m >= 1, InvalidValueError, f"m must be >= 1, got {m}")
    w = complex(w)
    a = complex(a)
    if _is_tracer(x):
        return _czt_traced(x, m, w, a)
    return _jit(x.shape[-1], m, w, a, trace_key())(x)


def czt(x, m: int, w: complex, a: complex = 1.0 + 0j):
    """CZT of a real signal at m bins (reference ``czt_f32``,
    ``czt.rs:16-54``)."""
    return merge(*czt_split(x, m, w, a))


@functools.lru_cache(maxsize=None)
def _czt_fast_fn(n: int, m: int, w: complex, a: complex, dtype: str,
                 backend: str = "auto", ck: tuple = ()):
    """Cached traced/jitted Bluestein-CZT closure for a fixed signature.
    ``backend`` pins the inner pow2 FFTs when the caller forced one;
    ``ck`` keys the cache on config.trace_key() so runtime setters apply
    to warm signatures."""
    L = next_pow2(n + m - 1)
    theta = np.angle(complex(w))  # w = e^{i*theta}

    def build_consts():
        i = np.arange(max(n, m), dtype=np.float64)
        # chirp c[j] = w^{j^2/2} = e^{i theta j^2 / 2}
        half = np.exp(1j * theta * (i * i) / 2.0)
        apow = (np.zeros(n, np.complex128) if a == 0
                else np.exp(-np.arange(n) * np.log(complex(a))))
        pre = apow * half[:n]                  # x premultiplier a^{-i} w^{i^2/2}
        post = half[:m]                         # output multiplier w^{k^2/2}
        # kernel b[j] = w^{-j^2/2} over j in (-(n-1) .. m-1), wrapped in L
        b = np.zeros(L, np.complex128)
        j = np.arange(max(n, m), dtype=np.float64)
        bneg = np.exp(-1j * theta * (j * j) / 2.0)
        b[:m] = bneg[:m]
        b[L - n + 1:] = bneg[1:n][::-1]
        bf = np.fft.fft(b)
        return (pre.real.astype(dtype), pre.imag.astype(dtype),
                post.real.astype(dtype), post.imag.astype(dtype),
                bf.real.astype(dtype), bf.imag.astype(dtype))

    pre_r, pre_i, post_r, post_i, bfr, bfi = tables.custom(
        ("czt_fast", n, m, complex(w), complex(a), dtype), build_consts)

    def traced(xx):
        ar, ai = xx * pre_r, xx * pre_i
        pad = [(0, 0)] * (ar.ndim - 1) + [(0, L - n)]
        ar, ai = jnp.pad(ar, pad), jnp.pad(ai, pad)
        fr, fi = engine_fft_planes(ar, ai, L, False, dtype, backend)
        pr, pi = cmul(fr, fi, bfr, bfi)
        qr, qi = engine_fft_planes(pr, pi, L, True, dtype, backend)
        qr, qi = qr[..., :m] / L, qi[..., :m] / L
        return cmul(qr, qi, post_r, post_i)

    return traced, jax.jit(traced)


def czt_fast(x, m: int, w: complex, a: complex = 1.0 + 0j,
             backend: Optional[str] = None):
    """Bluestein-factorized CZT (O((n+m) log); requires |w| = 1)."""
    w = complex(w)
    a = complex(a)
    require(abs(abs(w) - 1.0) < 1e-6, InvalidValueError,
            "czt_fast requires |w| == 1; use czt() for general w")
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    x = host_float(x) if host else jnp.asarray(x)
    n = x.shape[-1]
    require(n >= 1 and m >= 1, EmptyInputError, "czt input must be non-empty")
    dtype = str(x.dtype)    # host_float already resolved the f64 tier
    traced, jitted = _czt_fast_fn(n, m, w, a, dtype, backend or "auto",
                                  trace_key())
    if _is_tracer(x):
        return merge(*traced(x))
    return merge(*jitted(x))
