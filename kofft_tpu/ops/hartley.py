"""Discrete Hartley Transform.

Reference: ``src/hartley.rs:12-46`` — naive O(n^2) cas-kernel loop. Here
the DHT is the composite DHT(x) = Re(FFT(x)) - Im(FFT(x)) over the matmul
FFT engine (cas(t) = cos t + sin t and FFT uses cos t - i sin t), so every
FFT strategy (four-step, Bluestein) is inherited for free.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import trace_key
from ..errors import EmptyInputError, require
from .fft import _is_tracer, engine_fft_planes, resolve_backend
from ._complex import host_float

__all__ = ["dht", "dht_batch", "dht_multi_channel"]


def _dht_traced(x, backend: str):
    n = x.shape[-1]
    # the unified engine ladder: the DHT composite inherits every
    # engine for free
    yr, yi = engine_fft_planes(x, jnp.zeros_like(x), n, False,
                               str(x.dtype), backend)
    return yr - yi


@functools.lru_cache(maxsize=None)
def _jit(n: int, backend: str, ck: tuple = ()):
    """``ck`` carries config.trace_key() so runtime setters invalidate
    warm entries (the discipline every jitted entry follows)."""
    return jax.jit(functools.partial(_dht_traced, backend=backend))


def dht(x, backend: Optional[str] = None):
    """DHT along the last axis: X_k = sum_i x_i cas(2*pi*i*k/n)."""
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    x = host_float(x) if host else jnp.asarray(x)
    require(x.ndim >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "DHT input must be non-empty")
    b = resolve_backend(backend)
    if _is_tracer(x):
        return _dht_traced(x, b)
    return _jit(x.shape[-1], b, trace_key())(x)


def dht_batch(xs, backend: Optional[str] = None):
    """Batch DHT (reference ``hartley.rs:48-57``)."""
    return dht(xs, backend=backend)


def dht_multi_channel(xs, backend: Optional[str] = None):
    return dht(xs, backend=backend)
