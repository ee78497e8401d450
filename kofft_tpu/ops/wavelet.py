"""Discrete wavelet transforms: Haar, db2, db4, sym4, coif1 + multi-level.

Reference: ``src/wavelet.rs`` (732 LoC). Semantics reproduced exactly:

  * analysis: approx[i] = sum_k h[k] * x[reflect(2i + k)] (and g for
    detail), with whole-point symmetric reflection at both edges
    (``wavelet.rs:168-186``: idx < 0 -> -idx; idx >= n -> 2(n-1) - idx),
  * synthesis: out[reflect(2i + k)] += gs[k]*approx[i] + hs[k]*detail[i]
    (scatter-add with the same reflection, ``wavelet.rs:189-224``),
  * Haar uses plain averaging/differencing with no reflection
    (``wavelet.rs:12-33``),
  * multi-level: odd-length levels repeat the last sample before the next
    analysis step (``wavelet.rs:54-119``).

Design (SURVEY.md component 18): the analysis pass is a gather with a
host-precomputed reflected index matrix followed by a small tensordot (a
strided depthwise conv in disguise — the explicit index form keeps the
reference's reflection bit-exact); synthesis is a scatter-add with the same
indices. Filter taps are the standard published Daubechies/Symlet/Coiflet
constants, laid out in the reference's tap order (including its per-family
synthesis-bank conventions, which differ between db2 and db4 — behavior,
not textbook form, is the contract).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import EmptyInputError, InvalidValueError, require
from ..plan import tables

__all__ = ["haar_forward", "haar_inverse", "wavelet_forward",
           "wavelet_inverse", "multi_level_forward", "multi_level_inverse",
           "dwt", "idwt", "dwt_multi", "idwt_multi", "FAMILIES"]

# Filter banks: (analysis_h, analysis_g, synthesis_g, synthesis_h) in the
# reference's exact tap order (wavelet.rs:154-536).
_DB2_H = [0.4829629131445341, 0.8365163037378079, 0.2241438680420134,
          -0.1294095225512604]
_DB2_G = [-0.1294095225512604, -0.2241438680420134, 0.8365163037378079,
          -0.4829629131445341]
_DB4_H = [-0.010597401785069032, 0.0328830116668852, 0.030841381835560764,
          -0.18703481171909309, -0.027983769416859854, 0.6308807679298589,
          0.7148465705529157, 0.2303778133088965]
_DB4_G = [-0.2303778133088965, 0.7148465705529157, -0.6308807679298589,
          -0.027983769416859854, 0.18703481171909309, 0.030841381835560764,
          -0.0328830116668852, -0.010597401785069032]
_SYM4_H = [-0.07576571478927333, -0.02963552764599851, 0.49761866763201545,
           0.8037387518059161, 0.29785779560527736, -0.09921954357684722,
           -0.012603967262037833, 0.0322231006040427]
_SYM4_G = [-0.0322231006040427, -0.012603967262037833, 0.09921954357684722,
           0.29785779560527736, -0.8037387518059161, 0.49761866763201545,
           0.02963552764599851, -0.07576571478927333]
_COIF1_H = [-0.015655728135791993, -0.07273261951252645, 0.3848648468648578,
            0.8525720202116004, 0.3378976624574818, -0.07273261951252645]
_COIF1_G = [0.07273261951252645, 0.3378976624574818, -0.8525720202116004,
            0.3848648468648578, 0.07273261951252645, -0.015655728135791993]

FAMILIES = {
    # name: (h, g, synth_g, synth_h) — synth banks as the reference writes
    # them (gk/hk helpers for db2, wavelet.rs:225-248; literal arrays
    # elsewhere, wavelet.rs:311-336, :417-434, :495-514)
    "db2": (_DB2_H, _DB2_G,
            [0.4829629131445341, 0.8365163037378079, 0.2241438680420134,
             -0.1294095225512604],
            [-0.1294095225512604, -0.2241438680420134, 0.8365163037378079,
             -0.4829629131445341]),
    "db4": (_DB4_H, _DB4_G,
            [0.2303778133088965, 0.7148465705529157, 0.6308807679298589,
             -0.027983769416859854, -0.18703481171909309,
             0.030841381835560764, 0.0328830116668852,
             -0.010597401785069032],
            [-0.010597401785069032, -0.0328830116668852,
             0.030841381835560764, 0.18703481171909309,
             -0.027983769416859854, -0.6308807679298589,
             0.7148465705529157, -0.2303778133088965]),
    "sym4": (_SYM4_H, _SYM4_G,
             [0.0322231006040427, -0.012603967262037833,
              -0.09921954357684722, 0.29785779560527736, 0.8037387518059161,
              0.49761866763201545, -0.02963552764599851,
              -0.07576571478927333],
             [-0.07576571478927333, 0.02963552764599851,
              0.49761866763201545, -0.8037387518059161, 0.29785779560527736,
              0.09921954357684722, -0.012603967262037833,
              -0.0322231006040427]),
    "coif1": (_COIF1_H, _COIF1_G,
              [-0.07273261951252645, 0.3378976624574818, 0.8525720202116004,
               0.3848648468648578, -0.07273261951252645,
               -0.015655728135791993],
              [-0.015655728135791993, 0.07273261951252645,
               0.3848648468648578, -0.8525720202116004, 0.3378976624574818,
               0.07273261951252645]),
}


def _reflect_idx(n: int, taps: int) -> np.ndarray:
    """idx[i, k] = reflect(2i + k) into [0, n) (wavelet.rs reflection)."""
    out = np.zeros((n // 2, taps), dtype=np.int32)
    for i in range(n // 2):
        for k in range(taps):
            idx = 2 * i + k
            while idx < 0 or idx >= n:
                idx = -idx if idx < 0 else 2 * (n - 1) - idx
            out[i, k] = idx
    return out


def _analysis_consts(family: str, n: int):
    h, g, _, _ = FAMILIES[family]
    taps = len(h)
    return tables.custom(("wavelet_fwd", family, n), lambda: (
        _reflect_idx(n, taps),
        np.asarray(h, np.float32), np.asarray(g, np.float32)))


def _synthesis_consts(family: str, n_half: int):
    _, _, gs, hs = FAMILIES[family]
    taps = len(gs)
    return tables.custom(("wavelet_inv", family, n_half), lambda: (
        _reflect_idx(2 * n_half, taps),
        np.asarray(gs, np.float32), np.asarray(hs, np.float32)))


def _to_arr(x):
    host = not isinstance(x, (jax.Array, jax.core.Tracer))
    return (np.asarray(x, dtype=np.float32) if host
            else jnp.asarray(x)), host


def _maybe_np(y, host):
    return np.asarray(y) if host and not isinstance(
        y, jax.core.Tracer) else y


@functools.lru_cache(maxsize=None)
def _jit_forward(family: str, n: int):
    """Analysis as a stride-2 depthwise conv (both filters as output
    channels) over the signal extended by its reflected tail — gather-free.
    Only the tail can leave [0, n): 2i + k >= 0 always, and for n >= taps
    one reflection suffices (index max n+taps-3 <= 2(n-1)), so the exact
    reference reflection reduces to appending flip(x[n-taps+1 : n-1]).
    Tiny n keeps the gather path (multiple reflections)."""
    h, g, _, _ = FAMILIES[family]
    taps = len(h)

    if n < 2 * taps:
        idx, h_t, g_t = _analysis_consts(family, n)

        def f_gather(x):
            win = x[..., idx]             # (..., n/2, taps)
            return jnp.tensordot(win, h_t, axes=(-1, 0)), \
                jnp.tensordot(win, g_t, axes=(-1, 0))
        return jax.jit(f_gather)

    kern = np.stack([h, g]).astype(np.float32)[:, None, :]  # (2, 1, taps)

    def f(x):
        batch = x.shape[:-1]
        b = 1
        for s in batch:
            b *= s
        if taps > 2:
            tail = jnp.flip(x[..., n - taps + 1: n - 1], axis=-1)
            xp = jnp.concatenate([x, tail], axis=-1)
        else:
            xp = x
        out = jax.lax.conv_general_dilated(
            xp.reshape(b, 1, xp.shape[-1]), jnp.asarray(kern),
            window_strides=(2,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            precision=jax.lax.Precision.HIGHEST)   # (b, 2, n//2)
        return (out[:, 0].reshape(*batch, n // 2),
                out[:, 1].reshape(*batch, n // 2))
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _jit_inverse(family: str, n_half: int):
    """Synthesis as a fractionally-strided (lhs-dilated) conv producing the
    linear scatter y_lin[2i+k] += gs[k] a[i] + hs[k] d[i], then folding the
    over-the-edge tail back with one static flip-add — the exact
    scatter-with-reflection of the reference, gather/scatter-free."""
    _, _, gs, hs = FAMILIES[family]
    taps = len(gs)
    n = 2 * n_half

    if n < 2 * taps:
        idx, gs_t, hs_t = _synthesis_consts(family, n_half)

        def f_scatter(a, d):
            contrib = (a[..., :, None] * gs_t + d[..., :, None] * hs_t)
            out = jnp.zeros((*a.shape[:-1], n), dtype=a.dtype)
            return out.at[..., idx].add(contrib)
        return jax.jit(f_scatter)

    # rhs[o=1, c=2, k] = K[c, taps-1-k] (correlation of the dilated lhs
    # with the reversed bank sums both channels)
    kern = np.stack([gs, hs]).astype(np.float32)[:, ::-1]
    rhs = np.ascontiguousarray(kern[None])            # (1, 2, taps)

    def f(a, d):
        batch = a.shape[:-1]
        b = 1
        for s in batch:
            b *= s
        lhs = jnp.stack([a.reshape(b, n_half), d.reshape(b, n_half)],
                        axis=1)                        # (b, 2, n_half)
        y = jax.lax.conv_general_dilated(
            lhs, jnp.asarray(rhs), window_strides=(1,),
            padding=[(taps - 1, taps - 1)], lhs_dilation=(2,),
            dimension_numbers=("NCH", "OIH", "NCH"),
            precision=jax.lax.Precision.HIGHEST)[:, 0]  # (b, n + taps - 2)
        out = y[..., :n]
        if taps > 2:
            out = out.at[..., n - taps + 1: n - 1].add(
                jnp.flip(y[..., n:], axis=-1))
        return out.reshape(*batch, n)
    return jax.jit(f)


def haar_forward(x):
    """Single-level Haar: (avg, diff) halves (wavelet.rs:12-21);
    avg = (x0+x1)/2, diff = (x0-x1)/2."""
    x, host = _to_arr(x)
    require(x.shape[-1] >= 2, EmptyInputError, "haar needs >= 2 samples")
    ev, od = x[..., 0::2], x[..., 1::2]
    n2 = 2 * (x.shape[-1] // 2)
    ev, od = ev[..., : n2 // 2], od[..., : n2 // 2]
    return _maybe_np((ev + od) * 0.5, host), _maybe_np((ev - od) * 0.5, host)


def haar_inverse(avg, diff):
    """Inverse single-level Haar (wavelet.rs:24-33)."""
    a, host = _to_arr(avg)
    d, _ = _to_arr(diff)
    require(a.shape == d.shape, InvalidValueError,
            "avg/diff shapes must match")
    out = jnp.stack([jnp.asarray(a) + jnp.asarray(d),
                     jnp.asarray(a) - jnp.asarray(d)], axis=-1)
    return _maybe_np(out.reshape(*a.shape[:-1], 2 * a.shape[-1]), host)


def wavelet_forward(x, family: str):
    """Single-level analysis for db2/db4/sym4/coif1 (symmetric reflection
    boundaries). Returns (approx, detail), each length n//2."""
    if family == "haar":
        return haar_forward(x)
    require(family in FAMILIES, InvalidValueError,
            f"unknown wavelet family {family!r}; "
            f"available: haar, {sorted(FAMILIES)}")
    x, host = _to_arr(x)
    require(x.shape[-1] >= 2, EmptyInputError,
            "wavelet needs >= 2 samples")
    a, d = _jit_forward(family, x.shape[-1])(jnp.asarray(x))
    return _maybe_np(a, host), _maybe_np(d, host)


def wavelet_inverse(approx, detail, family: str):
    """Single-level synthesis (scatter-add with reflection)."""
    if family == "haar":
        return haar_inverse(approx, detail)
    require(family in FAMILIES, InvalidValueError,
            f"unknown wavelet family {family!r}")
    a, host = _to_arr(approx)
    d, _ = _to_arr(detail)
    require(a.shape == d.shape, InvalidValueError,
            "approx/detail shapes must match")
    out = _jit_inverse(family, a.shape[-1])(jnp.asarray(a), jnp.asarray(d))
    return _maybe_np(out, host)


# --------------------------------------------------------------------------
# perfect-reconstruction DWT (capability superset)
#
# The reference's synthesis banks for db4/sym4/coif1 are not perfect-
# reconstruction inverses — its own test concedes the roundtrip error is
# only "less than the max signal value" (wavelet.rs db2_tests comment).
# ``wavelet_forward``/``wavelet_inverse`` above reproduce that behavior for
# compatibility; ``dwt``/``idwt`` below are the *correct* orthogonal DWT
# with periodic extension: analysis is an orthogonal matrix (rows = h, g
# shifted by 2i mod n; g derived by the QMF rule g[k] = (-1)^k h[L-1-k]),
# so synthesis is its exact transpose and reconstruction is exact to f32.
# --------------------------------------------------------------------------

_PR_H = {
    "haar": [0.7071067811865476, 0.7071067811865476],
    "db2": _DB2_H, "db4": _DB4_H, "sym4": _SYM4_H, "coif1": _COIF1_H,
}


def _qmf(h):
    L = len(h)
    return [((-1.0) ** k) * h[L - 1 - k] for k in range(L)]


def _periodic_idx(n: int, taps: int) -> np.ndarray:
    i = np.arange(n // 2, dtype=np.int64)[:, None] * 2
    return ((i + np.arange(taps, dtype=np.int64)[None, :]) % n).astype(
        np.int32)


def _pr_consts(family: str, n: int):
    h = _PR_H[family]
    g = _qmf(h)
    return tables.custom(("dwt_pr", family, n), lambda: (
        _periodic_idx(n, len(h)),
        np.asarray(h, np.float32), np.asarray(g, np.float32)))


@functools.lru_cache(maxsize=None)
def _jit_dwt(family: str, n: int):
    idx, h, g = _pr_consts(family, n)

    def f(x):
        win = x[..., idx]
        return (jnp.tensordot(win, h, axes=(-1, 0)),
                jnp.tensordot(win, g, axes=(-1, 0)))
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _jit_idwt(family: str, n_half: int):
    idx, h, g = _pr_consts(family, 2 * n_half)

    def f(a, d):
        contrib = a[..., :, None] * h + d[..., :, None] * g
        out = jnp.zeros((*a.shape[:-1], 2 * n_half), dtype=a.dtype)
        return out.at[..., idx].add(contrib)
    return jax.jit(f)


def dwt(x, family: str = "haar"):
    """Single-level orthogonal DWT, periodic extension, perfect
    reconstruction. Requires even length."""
    require(family in _PR_H, InvalidValueError,
            f"unknown wavelet family {family!r}; available: "
            f"{sorted(_PR_H)}")
    x, host = _to_arr(x)
    n = x.shape[-1]
    require(n >= 2 and n % 2 == 0, InvalidValueError,
            f"dwt needs even length, got {n}")
    a, d = _jit_dwt(family, n)(jnp.asarray(x))
    return _maybe_np(a, host), _maybe_np(d, host)


def idwt(approx, detail, family: str = "haar"):
    """Exact inverse of :func:`dwt` (transpose of the analysis matrix)."""
    require(family in _PR_H, InvalidValueError,
            f"unknown wavelet family {family!r}")
    a, host = _to_arr(approx)
    d, _ = _to_arr(detail)
    require(a.shape == d.shape, InvalidValueError,
            "approx/detail shapes must match")
    out = _jit_idwt(family, a.shape[-1])(jnp.asarray(a), jnp.asarray(d))
    return _maybe_np(out, host)


def dwt_multi(x, levels: int, family: str = "haar"):
    """Multi-level PR decomposition (length must be divisible by 2^levels)."""
    require(levels >= 1, InvalidValueError, "levels must be >= 1")
    cur, host = _to_arr(x)
    require(cur.shape[-1] % (1 << levels) == 0, InvalidValueError,
            f"length {cur.shape[-1]} not divisible by 2^{levels}")
    details = []
    for _ in range(levels):
        cur, d = dwt(cur, family)
        details.append(d)
    return cur, details


def idwt_multi(approx, details, family: str = "haar"):
    cur = approx
    for d in reversed(details):
        cur = idwt(cur, d, family)
    return cur


def multi_level_forward(x, levels: int, family: str = "haar"):
    """Multi-level decomposition (wavelet.rs:54-72): odd-length levels
    repeat the last sample. Returns (approx, [details...])."""
    require(levels >= 1, InvalidValueError, "levels must be >= 1")
    cur, host = _to_arr(x)
    details = []
    for _ in range(levels):
        if cur.shape[-1] % 2 != 0:
            xp = np if isinstance(cur, np.ndarray) else jnp
            cur = xp.concatenate([cur, cur[..., -1:]], axis=-1)
        a, d = wavelet_forward(cur, family)
        details.append(d)
        cur = a
    return cur, details


def multi_level_inverse(approx, details, family: str = "haar"):
    """Multi-level reconstruction (wavelet.rs:75-86)."""
    cur = approx
    # Level sizes can disagree by one sample when the forward side padded an
    # odd-length level (wavelet.rs:60-66). The reference's driver has no
    # defined behavior there (its per-level inverse would index out of
    # bounds); we realize the intent by dropping the padded tail so each
    # level's approx matches its detail length.
    for d in reversed(details):
        dn = (np.asarray(d) if isinstance(d, np.ndarray) else d).shape[-1]
        if cur.shape[-1] > dn:
            cur = cur[..., :dn]
        cur = wavelet_inverse(cur, d, family)
    return cur
