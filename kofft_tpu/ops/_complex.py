"""SoA (split re/im) complex helpers for the matmul FFT engine.

The analog of the reference's split-complex types
(``SplitComplex``/``ComplexVec``, ``src/num.rs:236-330``) and its
FMA-specialized complex multiply (``src/num.rs:145-188``): complex tensors
are carried as separate real/imag float planes so every multiply is a
real matmul and every elementwise op works on contiguous floats. AoS<->SoA conversion (``src/num.rs:332-348``)
becomes ``split``/``merge`` at the public API boundary only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import lax_precision


def host_float_dtype(dtype):
    """The working float dtype for a host input of ``dtype``: f64 is
    preserved when the x64 tier is active (``config.x64_active``: jax
    x64 on), everything else lands on f32 — the
    single policy every transform entry point shares (reference generic
    Float, ``src/num.rs:5-29``). Complex-input sites apply it to the
    component dtype (``x.real.dtype``)."""
    import numpy as np

    from ..config import x64_active
    return (np.float64 if np.dtype(dtype) == np.float64 and x64_active()
            else np.float32)


def host_float(x):
    """Coerce a HOST array to the working float dtype (see
    :func:`host_float_dtype`)."""
    import numpy as np

    x = np.asarray(x)
    ft = host_float_dtype(x.dtype)
    return x.astype(ft) if x.dtype != ft else x


def split(x):
    """complex array -> (re, im) float planes. Real input gets zero imag."""
    if jnp.iscomplexobj(x):
        return jnp.real(x), jnp.imag(x)
    return x, jnp.zeros_like(x)


def merge(re, im):
    """(re, im) float planes -> complex array (complex64 for f32 planes)."""
    return jax.lax.complex(re, im)


def cmul(ar, ai, br, bi):
    """Elementwise complex multiply on planes (FMA-friendly form)."""
    return ar * br - ai * bi, ar * bi + ai * br


def conj(ar, ai):
    return ar, -ai


def cmatmul_last(ar, ai, br, bi, precision=None):
    """Complex contraction over the last axis of a with the first of b:
    ``y[..., k] = sum_j a[..., j] * b[j, k]`` as four real matmuls.

    The 3-multiply Gauss/Karatsuba trick is deliberately not used: the extra
    adds worsen f32 error.
    """
    p = precision if precision is not None else lax_precision()
    e = "...j,jk->...k"
    rr = jnp.einsum(e, ar, br, precision=p)
    ii = jnp.einsum(e, ai, bi, precision=p)
    ri = jnp.einsum(e, ar, bi, precision=p)
    ir = jnp.einsum(e, ai, br, precision=p)
    return rr - ii, ri + ir
