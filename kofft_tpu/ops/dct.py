"""DCT I-IV, matching the reference's (unnormalized) conventions exactly.

Reference: ``src/dct.rs`` — naive O(n^2) loops (``dct.rs:108-178``) plus a
``DctPlanner`` whose "fast" path does DCT-II via cosine tables / a length-2n
rfft (``dct.rs:22-105``). Here the O(n^2) form *as a matmul against a
cached cosine matrix* serves small and mid n (one fused matmul, no
permutation gathers, no complex arithmetic); an FFT-composed path takes
over at large n (``FAST_CUTOFF``). The cosine matrices are computed on host in float64 with
exact phase reduction and cached per (type, n, dtype) — the analog of the
planner's cosine-table cache (``dct.rs:30-56``).

Conventions (reference formulas, ``dct.rs:108-178``; note these are
scipy's unnormalized transforms scaled by 1/2 except DCT-I):
  DCT-I  : X_k = x_0 + (-1)^k x_{n-1} + 2 sum_{i=1}^{n-2} x_i cos(pi i k/(n-1))
  DCT-II : X_k = sum_i x_i cos(pi (i+1/2) k / n)
  DCT-III: X_k = x_0/2 + sum_{i>=1} x_i cos(pi i (k+1/2) / n)
  DCT-IV : X_k = sum_i x_i cos(pi (i+1/2)(k+1/2) / n)
DCT-I of n=1 returns 2*x_0 (reference special case, ``dct.rs:112``).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import lax_precision, trace_key
from ..errors import EmptyInputError, InvalidValueError, require
from ..plan import tables
from ._complex import host_float

__all__ = ["dct1", "dct2", "dct3", "dct4", "dct", "idct",
           "dct_batch", "dct_multi_channel"]


def _dct_matrix_np(kind: int, n: int) -> np.ndarray:
    """M[i, k] such that X = x @ M (host float64)."""
    i = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    if kind == 1:
        if n == 1:
            return np.array([[2.0]])
        m = 2.0 * np.cos(np.pi * i * k / (n - 1))
        m[0, :] = 1.0
        m[n - 1, :] = (-1.0) ** np.arange(n)
        return m
    if kind == 2:
        return np.cos(np.pi * (i + 0.5) * k / n)
    if kind == 3:
        m = np.cos(np.pi * i * (k + 0.5) / n)
        m[0, :] = 0.5
        return m
    if kind == 4:
        return np.cos(np.pi * (i + 0.5) * (k + 0.5) / n)
    raise InvalidValueError(f"DCT type must be 1..4, got {kind}")


def _matrix(kind: int, n: int, dtype: str):
    return tables.custom(("dct", kind, n, dtype),
                         lambda: _dct_matrix_np(kind, n).astype(dtype))


# Above this the cosine matrix is too big to be a sane device constant
# (n^2 floats: 64 MB at 4096) and the O(n log n) FFT-composed path wins —
# the analog of the reference DctPlanner's length-2n rfft route
# (``dct.rs:22-105``). Matmul stays the oracle and the fast path for
# small/mid n. Tunable for tests.
FAST_CUTOFF = 4096


def _traced(kind: int, x, n: int, dtype: str):
    if n > FAST_CUTOFF and n >= 2:
        from ._trig import fast_dct
        return fast_dct(kind, x)
    m = _matrix(kind, n, dtype)
    return jnp.einsum("...i,ik->...k", x, m, precision=lax_precision())


@functools.lru_cache(maxsize=None)
def _jit_apply(kind: int, n: int, dtype: str, cutoff: int, ck: tuple = ()):
    return jax.jit(lambda x: _traced(kind, x, n, dtype))


def _apply(kind: int, x):
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    x = host_float(x) if host else jnp.asarray(x)
    require(x.ndim >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "DCT input must be non-empty")
    n = x.shape[-1]
    dtype = str(x.dtype)
    if isinstance(x, jax.core.Tracer):
        return _traced(kind, x, n, dtype)
    return _jit_apply(kind, n, dtype, FAST_CUTOFF,
                      trace_key())(x)


def dct1(x):
    """DCT-I (reference ``dct1``, ``dct.rs:108-130``)."""
    return _apply(1, x)


def dct2(x):
    """DCT-II (reference ``dct2``, ``dct.rs:133-146``)."""
    return _apply(2, x)


def dct3(x):
    """DCT-III (reference ``dct3``, ``dct.rs:149-162``)."""
    return _apply(3, x)


def dct4(x):
    """DCT-IV (reference ``dct4``, ``dct.rs:165-178``)."""
    return _apply(4, x)


_KINDS = {1: dct1, 2: dct2, 3: dct3, 4: dct4}


def dct(x, type: int = 2):
    require(type in _KINDS, InvalidValueError,
            f"DCT type must be 1..4, got {type}")
    return _KINDS[type](x)


def idct(x, type: int = 2):
    """Inverse of :func:`dct` under the reference conventions.

    DCT-II and DCT-III are mutual inverses up to 2/n; DCT-IV is self-inverse
    up to 2/n; DCT-I is self-inverse up to 2/(n-1)."""
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    arr = np.asarray(x) if host else jnp.asarray(x)
    n = arr.shape[-1]
    if type == 2:
        return dct3(x) * (2.0 / n)
    if type == 3:
        return dct2(x) * (2.0 / n)
    if type == 4:
        return dct4(x) * (2.0 / n)
    if type == 1:
        require(n >= 2, InvalidValueError, "inverse DCT-I needs n >= 2")
        return dct1(x) * (1.0 / (2.0 * (n - 1)))
    raise InvalidValueError(f"DCT type must be 1..4, got {type}")


def dct_batch(xs, type: int = 2):
    """Batch over the leading dim (reference ``dct.rs:263-306``) — leading
    dims are already batched; provided for API parity."""
    return dct(xs, type=type)


def dct_multi_channel(xs, type: int = 2):
    """Multi-channel = batch (reference multi-channel loops,
    ``dct.rs:263-306``)."""
    return dct(xs, type=type)
