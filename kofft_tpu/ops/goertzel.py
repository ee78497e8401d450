"""Goertzel single-bin DFT detector.

Reference: ``src/goertzel.rs:16-60`` — bin k = floor(freq * n / sample_rate),
recurrence s = x + 2cos(w) s1 - s2, magnitude = sqrt(s1^2 + s2^2 - coeff*s1*s2),
which equals |X_k| for X_k = sum_i x_i e^{-j w i}.

Design (SURVEY.md component 20): the recurrence is a dot product in
disguise — ``goertzel`` computes |X_k| as two basis dots (one fused pass, batched over leading dims and over many bins at once via
``goertzel_bins``). ``goertzel_scan`` keeps the literal O(n) recurrence as a
``lax.scan`` for streaming parity.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..config import lax_precision, trace_key
from ..errors import EmptyInputError, InvalidValueError, require
from ..plan import tables
from ._complex import host_float

__all__ = ["goertzel", "goertzel_bins", "goertzel_scan"]


def _bin_of(n: int, sample_rate: float, target_freq: float) -> int:
    return int(math.floor(target_freq * n / sample_rate))


def _basis(n: int, bins: tuple, dtype: str):
    def build():
        k = np.asarray(bins, dtype=np.float64)[None, :]
        i = np.arange(n, dtype=np.float64)[:, None]
        ang = -2.0 * np.pi * i * k / n
        return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)
    return tables.custom(("goertzel", n, bins, dtype), build)


def _validate(x, sample_rate: float):
    require(x.ndim >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "goertzel input must be non-empty")
    require(sample_rate > 0.0, InvalidValueError,
            f"sample_rate must be > 0, got {sample_rate}")


@functools.lru_cache(maxsize=None)
def _jit_bins(n: int, bins: tuple, dtype: str, ck: tuple = ()):
    cr, ci = _basis(n, bins, dtype)

    def f(x):
        p = lax_precision()
        re = jnp.einsum("...i,ik->...k", x, cr, precision=p)
        im = jnp.einsum("...i,ik->...k", x, ci, precision=p)
        return jnp.sqrt(re * re + im * im)
    return jax.jit(f)


def goertzel_bins(x, bins):
    """|X_k| for many integer bins at once (one batched dot)."""
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    x = host_float(x) if host else jnp.asarray(x)
    require(x.ndim >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "goertzel input must be non-empty")
    bins = tuple(int(b) for b in bins)
    n = x.shape[-1]
    dtype = "float32" if host else str(x.dtype)
    if isinstance(x, jax.core.Tracer):
        cr, ci = _basis(n, bins, dtype)
        p = lax_precision()
        re = jnp.einsum("...i,ik->...k", x, cr, precision=p)
        im = jnp.einsum("...i,ik->...k", x, ci, precision=p)
        return jnp.sqrt(re * re + im * im)
    return _jit_bins(n, bins, dtype, trace_key())(x)


def goertzel(x, sample_rate: float, target_freq: float):
    """Magnitude at the bin nearest ``target_freq`` (reference
    ``goertzel_f32`` semantics incl. floor() bin selection)."""
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    xa = host_float(x) if host else jnp.asarray(x)
    _validate(xa, sample_rate)
    k = _bin_of(xa.shape[-1], sample_rate, target_freq)
    out = goertzel_bins(xa, (k,))
    return out[..., 0]


def goertzel_scan(x, sample_rate: float, target_freq: float):
    """Literal Goertzel recurrence via ``lax.scan`` (streaming-shaped;
    same rounding order as the reference's scalar loop)."""
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    xa = host_float(x) if host else jnp.asarray(x)
    _validate(xa, sample_rate)
    n = xa.shape[-1]
    k = _bin_of(n, sample_rate, target_freq)
    omega = 2.0 * math.pi * k / n
    coeff = jnp.float32(2.0 * math.cos(omega))

    def step(carry, xi):
        s1, s2 = carry
        s = xi + coeff * s1 - s2
        return (s, s1), None

    def run(sig):
        (s1, s2), _ = jax.lax.scan(
            step, (jnp.float32(0.0), jnp.float32(0.0)), sig)
        power = s2 * s2 + s1 * s1 - coeff * s1 * s2
        return jnp.sqrt(jnp.maximum(power, 0.0))

    flatten = xa.reshape(-1, n)
    out = jax.vmap(lambda s: run(s))(jnp.asarray(flatten))
    out = out.reshape(xa.shape[:-1])
    return np.asarray(out) if host else out
