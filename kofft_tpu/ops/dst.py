"""DST I-IV, matching the reference's (unnormalized) conventions exactly.

Reference: ``src/dst.rs`` — naive O(n^2) loops (``dst.rs:89-147``) plus a
``DstPlanner`` sine-table path (``dst.rs:19-87``). Same design as
:mod:`kofft_tpu.ops.dct`: cached sine-matrix matmul.

Conventions (reference formulas, ``dst.rs:89-147``):
  DST-I  : X_k = sum_i x_i sin(pi (i+1)(k+1) / (n+1))
  DST-II : X_k = sum_i x_i sin(pi (i+1/2)(k+1) / n)
  DST-III: X_k = x_0/2 + sum_{i>=1} x_i sin(pi (k+1/2) i / n)
  DST-IV : X_k = sum_i x_i sin(pi (i+1/2)(k+1/2) / n)

Note the reference's DST-III mirrors its DCT-III mechanically (constant
x_0/2 term); it is *not* scipy's DST-III and not the exact inverse of its
DST-II. Behavior, not textbook form, is the compatibility contract here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import lax_precision, trace_key
from ..errors import EmptyInputError, InvalidValueError, require
from ..plan import tables
from ._complex import host_float

__all__ = ["dst1", "dst2", "dst3", "dst4", "dst", "dst_batch",
           "dst_multi_channel"]


def _dst_matrix_np(kind: int, n: int) -> np.ndarray:
    """M[i, k] such that X = x @ M (host float64)."""
    i = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    if kind == 1:
        return np.sin(np.pi * (i + 1.0) * (k + 1.0) / (n + 1))
    if kind == 2:
        return np.sin(np.pi * (i + 0.5) * (k + 1.0) / n)
    if kind == 3:
        m = np.sin(np.pi * (k + 0.5) * i / n)
        m[0, :] = 0.5
        return m
    if kind == 4:
        return np.sin(np.pi * (i + 0.5) * (k + 0.5) / n)
    raise InvalidValueError(f"DST type must be 1..4, got {kind}")


def _matrix(kind: int, n: int, dtype: str):
    return tables.custom(("dst", kind, n, dtype),
                         lambda: _dst_matrix_np(kind, n).astype(dtype))


# Same large-n FFT-composed route as ops/dct.py (see the note there).
FAST_CUTOFF = 4096


def _traced(kind: int, x, n: int, dtype: str):
    if n > FAST_CUTOFF and n >= 2:
        from ._trig import fast_dst
        return fast_dst(kind, x)
    m = _matrix(kind, n, dtype)
    return jnp.einsum("...i,ik->...k", x, m, precision=lax_precision())


@functools.lru_cache(maxsize=None)
def _jit_apply(kind: int, n: int, dtype: str, cutoff: int, ck: tuple = ()):
    return jax.jit(lambda x: _traced(kind, x, n, dtype))


def _apply(kind: int, x):
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    x = host_float(x) if host else jnp.asarray(x)
    require(x.ndim >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "DST input must be non-empty")
    n = x.shape[-1]
    dtype = str(x.dtype)
    if isinstance(x, jax.core.Tracer):
        return _traced(kind, x, n, dtype)
    return _jit_apply(kind, n, dtype, FAST_CUTOFF,
                      trace_key())(x)


def dst1(x):
    """DST-I (reference ``dst1``, ``dst.rs:89-101``)."""
    return _apply(1, x)


def dst2(x):
    """DST-II (reference ``dst2``, ``dst.rs:104-116``)."""
    return _apply(2, x)


def dst3(x):
    """DST-III (reference ``dst3``, ``dst.rs:119-131``)."""
    return _apply(3, x)


def dst4(x):
    """DST-IV (reference ``dst4``, ``dst.rs:134-147``)."""
    return _apply(4, x)


_KINDS = {1: dst1, 2: dst2, 3: dst3, 4: dst4}


def dst(x, type: int = 2):
    require(type in _KINDS, InvalidValueError,
            f"DST type must be 1..4, got {type}")
    return _KINDS[type](x)


def dst_batch(xs, type: int = 1):
    """Batch over leading dims (reference ``dst.rs:149-192``)."""
    return dst(xs, type=type)


def dst_multi_channel(xs, type: int = 1):
    return dst(xs, type=type)
