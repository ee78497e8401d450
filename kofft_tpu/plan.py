"""Plan objects, twiddle/DFT-matrix tables, and the plan cache.

The analog of the reference's ``FftPlanner`` (``src/fft.rs:332-445``):
the planner there caches per-stage twiddle tables and Bluestein chirp pairs;
here the cache holds *device-resident constant arrays* keyed by ``(n, dtype)``
plus the factor tree that drives the matmul four-step engine, and the jitted
callables themselves (JAX's jit cache plays the role of the reference's
reusable scratch buffers — zero allocations on a warm call,
cf. ``tests/bluestein.rs:5-30``).

Why matmul / four-step instead of a butterfly port
--------------------------------------------------
The reference's hot loop is a Stockham butterfly pass (``src/fft.rs:634-786``)
vectorized with SSE/NEON/AVX lanes. On an accelerator the matrix units
hold most of the arithmetic throughput, so this design computes the DFT
as matrix products:

  * n <= cutoff:  y = x @ F_n  (one complex matmul; F_n is the symmetric DFT
    matrix, held as a cached device constant),
  * larger n = n1*n2 (Bailey/four-step):
        A = x.reshape(n1, n2)
        B = F_{n1} contracted over axis j1      (batched matmul)
        C = B * W  with W[k1, j2] = w_n^{k1*j2} (fused elementwise twiddle)
        D = C @ F_{n2}                          (batched matmul)
        X = D.T.reshape(n)
    applied recursively, so 2^20 = (32*32) * (32*32) ... decomposes into a
    tree whose leaves are all matmuls.

All tables are computed on host in float64 (so twiddle angles for n = 2^20
keep full precision; exponents reduced mod n in exact integer arithmetic)
and cast to the working dtype once, mirroring the reference's
compile-time-twiddle option (``build.rs:6-95``).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .config import get_config
from .errors import EmptyInputError, InvalidValueError, require

# --------------------------------------------------------------------------
# factorization
# --------------------------------------------------------------------------

_SMALL_PRIMES = (2, 3, 5, 7, 11, 13)


def factorize(n: int) -> list[int]:
    """Prime factorization over the smooth primes + one leftover cofactor.

    Mirrors the reference's mixed-radix front-end factorization over
    {2,3,5,7,...} with Bluestein fallback (``src/fft.rs:1573-1706``).
    The caller decides what to do with a non-smooth cofactor (> max_factor):
    the engine routes such sizes to Bluestein.
    """
    require(n >= 1, InvalidValueError, f"n must be >= 1, got {n}")
    out: list[int] = []
    m = n
    for p in _SMALL_PRIMES:
        while m % p == 0:
            out.append(p)
            m //= p
    if m > 1:
        out.append(m)  # rough cofactor
    return out


def is_smooth(n: int, max_factor: Optional[int] = None) -> bool:
    mf = max_factor if max_factor is not None else get_config().max_factor
    return all(f <= mf for f in factorize(n))


def balanced_split(n: int) -> tuple[int, int]:
    """Split smooth n into n1*n2 with n1, n2 as close as possible.

    Balanced splits minimize total matmul FLOPs in the four-step recursion
    (cost per element ~ n1 + n2 at each level).
    """
    best = (1, n)
    best_gap = n
    f = 1
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            gap = abs((n // d) - d)
            if gap < best_gap:
                best_gap = gap
                best = (d, n // d)
    n1, n2 = best
    if n1 == 1:  # prime — caller should have used Bluestein / direct
        return (1, n)
    return (n1, n2)


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


# --------------------------------------------------------------------------
# host-side table construction (float64, exact integer phase reduction)
# --------------------------------------------------------------------------

def _dft_matrix_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) planes of the symmetric DFT matrix F[j,k] = exp(-2πi·jk/n).

    Phases are reduced mod n in exact int64 before the float64 angle is
    formed, so even n = 2^20 twiddles are accurate to f64 ulp.
    """
    j = np.arange(n, dtype=np.int64)
    jk = np.mod(np.outer(j, j), n)
    ang = (-2.0 * np.pi / n) * jk.astype(np.float64)
    return np.cos(ang), np.sin(ang)


def _twiddle_matrix_np(n1: int, n2: int) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of W[k1, j2] = exp(-2πi·k1·j2 / (n1*n2)) — the four-step
    inter-stage twiddle (reference's per-stage twiddle tables,
    ``src/fft.rs:370-408``, reorganized for the matmul formulation)."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.int64)
    j2 = np.arange(n2, dtype=np.int64)
    ph = np.mod(np.outer(k1, j2), n)
    ang = (-2.0 * np.pi / n) * ph.astype(np.float64)
    return np.cos(ang), np.sin(ang)


def chirp_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of the Bluestein chirp c[j] = exp(-πi·j²/n), j in [0, n).

    Phase j²/2 reduced mod n exactly in integers: j² mod 2n keeps the
    half-angle exact. Reference chirp cache: ``src/fft.rs:410-433``.
    """
    j = np.arange(n, dtype=np.int64)
    ph = np.mod(j * j, 2 * n)  # j^2 mod 2n, angle = -pi * ph / n
    ang = (-np.pi / n) * ph.astype(np.float64)
    return np.cos(ang), np.sin(ang)


# --------------------------------------------------------------------------
# factor tree
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DftLeaf:
    """Direct DFT matmul base case (small-n; the analog of
    the reference's unrolled fft2/4/8/16 base cases, ``src/fft_kernels.rs``)."""
    n: int


@dataclass(frozen=True)
class FourStepNode:
    """n = n1*n2 Bailey split. ``left`` transforms length-n1 lines,
    ``right`` transforms length-n2 lines."""
    n: int
    n1: int
    n2: int
    left: "FactorTree"
    right: "FactorTree"


FactorTree = object  # union[DftLeaf, FourStepNode]


def build_factor_tree(n: int, cutoff: Optional[int] = None) -> FactorTree:
    """Build the recursive four-step plan for a smooth n."""
    c = cutoff if cutoff is not None else get_config().dft_cutoff
    require(n >= 1, EmptyInputError, "n must be >= 1")
    if n <= c:
        return DftLeaf(n)
    n1, n2 = balanced_split(n)
    if n1 == 1:
        # prime larger than cutoff: fall back to one big DFT matmul leaf —
        # the engine only calls this for smooth n, so this is a safety net.
        return DftLeaf(n)
    return FourStepNode(n, n1, n2, build_factor_tree(n1, c),
                        build_factor_tree(n2, c))


def tree_leaf_sizes(tree: FactorTree) -> set[int]:
    if isinstance(tree, DftLeaf):
        return {tree.n}
    return tree_leaf_sizes(tree.left) | tree_leaf_sizes(tree.right)


def tree_twiddle_keys(tree: FactorTree) -> set[tuple[int, int]]:
    if isinstance(tree, DftLeaf):
        return set()
    return ({(tree.n1, tree.n2)}
            | tree_twiddle_keys(tree.left)
            | tree_twiddle_keys(tree.right))


# --------------------------------------------------------------------------
# device-constant cache
# --------------------------------------------------------------------------

class _TableCache:
    """Process-wide cache of host-side constant tables (numpy, final dtype).

    Values are deliberately *numpy* arrays: the engine entry points are all
    jitted, so these become baked XLA constants at trace time (device
    resident inside the executable) — caching ``jnp`` arrays instead would
    leak tracers when a table is first built inside a trace.

    Keyed by (kind, params, dtype). Thread-safe. The reference's planner
    cache guarantees zero allocations on a warm call
    (``tests/bluestein.rs:60-66``); here the analogous discipline is that a
    warm call re-uses both these device constants and the jitted executable
    (no retrace / no re-upload) — asserted by the compile-count tests.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._store: dict[tuple, tuple] = {}

    def _get(self, key: tuple, builder):
        with self._lock:
            hit = self._store.get(key)
        if hit is not None:
            return hit
        val = builder()
        with self._lock:
            # double-build race is benign; keep the first
            return self._store.setdefault(key, val)

    def dft_matrix(self, n: int, dtype: str = "float32"):
        def build():
            re, im = _dft_matrix_np(n)
            return (re.astype(dtype), im.astype(dtype))

        return self._get(("dft", n, dtype), build)

    def twiddle(self, n1: int, n2: int, dtype: str = "float32"):
        def build():
            re, im = _twiddle_matrix_np(n1, n2)
            return (re.astype(dtype), im.astype(dtype))

        return self._get(("tw", n1, n2, dtype), build)

    def chirp(self, n: int, dtype: str = "float32"):
        def build():
            re, im = chirp_np(n)
            return (re.astype(dtype), im.astype(dtype))

        return self._get(("chirp", n, dtype), build)

    def custom(self, key: tuple, builder):
        """Cache arbitrary derived constants (rfft unpack twiddles, DCT
        post-twiddles, Bluestein premultiplied kernels, window tables...)."""
        return self._get(key, builder)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)


tables = _TableCache()
