"""Mesh-sharded 1-D FFT: the four-step factorization at pod scale.

For a single signal too long for one chip, n = n1 * n2 (SURVEY.md §5.7:
"batched n2-FFT -> twiddle multiply -> transpose (all-to-all over ICI) ->
batched n1-FFT; the Stockham staging is the within-chip version of the
same recursion"). The flat signal is viewed as the row-major (n1, n2)
matrix, rows sharded over the mesh:

    1. all_to_all        (m1, n2)       -> (n1, n2/D)   [gather j1, split j2]
    2. local DFT_{n1}    over j1 (batched engine, axis moved last)
    3. twiddle           W[k1, j2] = w_n^{k1 j2}, built per chip from a
                         local base B[t, k1] = w_n^{k1 t} and a tiny
                         per-chip row C[c, k1] = w_n^{k1 c n2/D}
                         (separable: no n-sized global constant)
    4. all_to_all        (n2/D, n1)     -> (n2, n1/D)   [gather j2, split k1]
    5. local DFT_{n2}    over j2
    -> shard c holds X[k1 + n1*k2] for k1 in its n1/D-slice, all k2
       ("transposed digit order", the classic distributed-FFT layout);
       ``restore_layout=True`` pays a third all_to_all + local transpose
       to return the natural-order flat spectrum sharded contiguously.

Communication: 2 (3 with restore) all_to_alls moving (D-1)/D of the array
each — the canonical volume, constant per chip in weak scaling.

``overlap=K`` replaces the sequential compute -> all_to_all -> compute
barriers with K independent chunk chains per stage (``_build_overlap``):
chunk k+1's collective flies while chunk k's DFT runs. Volume is
unchanged; the HLO dependency structure (2K independent collective
sources vs 2) is machine-checked by ``validate``.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import trace_key
from ..errors import InvalidValueError, require
from ..ops.fft import _fft_planes
from ..plan import tables
from .mesh import make_mesh
from .ndfft_sharded import shard_map, _mesh_key, _MESHES

__all__ = ["fft_sharded", "ifft_sharded"]


def _split_for_mesh(n: int, d: int):
    """n = n1 * n2, both divisible by d, as balanced as possible."""
    best = None
    f = 1
    while f * f <= n:
        if n % f == 0:
            n1, n2 = f, n // f
            if n1 % d == 0 and n2 % d == 0:
                best = (n1, n2)
        f += 1
    return best


def _twiddle_consts(n: int, n1: int, n2: int, d: int, dtype: str,
                    k_chunks: int = 1):
    """Separable twiddle parts (host f64, exact integer phase mod n).

    With ``k_chunks`` > 1 (the overlap pipeline) the base table covers
    one chunk's per-chip rows (n2/(d*K)) and the offset table has one
    row per (chunk, chip) pair: offset(k, c) = k*n2/K + c*n2/(d*K)."""
    def build():
        rows = n2 // (d * k_chunks)
        t = np.arange(rows, dtype=np.int64)
        k1 = np.arange(n1, dtype=np.int64)
        ang_b = (-2.0 * np.pi / n) * np.mod(np.outer(t, k1), n).astype(
            np.float64)                                   # (rows, n1)
        ks = np.arange(k_chunks, dtype=np.int64)[:, None] * (n2 // k_chunks)
        cs = np.arange(d, dtype=np.int64)[None, :] * rows
        off = (ks + cs).reshape(-1)                       # (K*d,)
        ang_c = (-2.0 * np.pi / n) * np.mod(np.outer(off, k1), n).astype(
            np.float64)                                   # (K*d, n1)
        return (np.cos(ang_b).astype(dtype), np.sin(ang_b).astype(dtype),
                np.cos(ang_c).astype(dtype), np.sin(ang_c).astype(dtype))

    return tables.custom(("fft_sharded_tw", n, n1, n2, d, dtype, k_chunks),
                         build)


@functools.lru_cache(maxsize=None)
def _build(mesh_key, n: int, n1: int, n2: int, backend: str,
           restore_layout: bool, ck: tuple = (), overlap: int = 1,
           dtype: str = "float32"):
    mesh, axis_name = _MESHES[mesh_key]
    d = mesh.shape[axis_name]
    m1 = n1 // d
    if overlap > 1:
        return _build_overlap(mesh, axis_name, n, n1, n2, d, backend,
                              overlap, dtype)
    br, bi, cr, ci = _twiddle_consts(n, n1, n2, d, dtype)

    def body(xr, xi):  # local flat shard (m1 * n2,)
        xr = xr.reshape(m1, n2)
        xi = xi.reshape(m1, n2)
        # 1. re-pencil: gather j1, split j2
        xr = jax.lax.all_to_all(xr, axis_name, split_axis=1, concat_axis=0,
                                tiled=True)               # (n1, n2/d)
        xi = jax.lax.all_to_all(xi, axis_name, split_axis=1, concat_axis=0,
                                tiled=True)
        # 2. DFT over j1: move it last
        xr = jnp.swapaxes(xr, 0, 1)                       # (n2/d, n1)
        xi = jnp.swapaxes(xi, 0, 1)
        yr, yi = _fft_planes(xr, xi, n1, False, backend, dtype)
        # 3. separable twiddle for this chip's j2 range
        me = jax.lax.axis_index(axis_name)
        crow_r = jax.lax.dynamic_index_in_dim(jnp.asarray(cr), me, axis=0,
                                              keepdims=False)   # (n1,)
        crow_i = jax.lax.dynamic_index_in_dim(jnp.asarray(ci), me, axis=0,
                                              keepdims=False)
        wr = jnp.asarray(br) * crow_r[None, :] - jnp.asarray(bi) * crow_i[None, :]
        wi = jnp.asarray(br) * crow_i[None, :] + jnp.asarray(bi) * crow_r[None, :]
        tr = yr * wr - yi * wi                            # (n2/d, n1)
        ti = yr * wi + yi * wr
        # 4. re-pencil: gather j2, split k1
        tr = jax.lax.all_to_all(tr, axis_name, split_axis=1, concat_axis=0,
                                tiled=True)               # (n2, n1/d)
        ti = jax.lax.all_to_all(ti, axis_name, split_axis=1, concat_axis=0,
                                tiled=True)
        # 5. DFT over j2: move it last
        tr = jnp.swapaxes(tr, 0, 1)                       # (m1, n2)
        ti = jnp.swapaxes(ti, 0, 1)
        zr, zi = _fft_planes(tr, ti, n2, False, backend, dtype)
        # shard holds X[k1 + n1*k2] at [k1_local, k2]
        if not restore_layout:
            return zr.reshape(m1 * n2), zi.reshape(m1 * n2)
        # 6. natural order: gather k1, split k2, local transpose
        zr = jax.lax.all_to_all(zr, axis_name, split_axis=1, concat_axis=0,
                                tiled=True)               # (n1, n2/d)
        zi = jax.lax.all_to_all(zi, axis_name, split_axis=1, concat_axis=0,
                                tiled=True)
        zr = jnp.swapaxes(zr, 0, 1)                       # (n2/d, n1)
        zi = jnp.swapaxes(zi, 0, 1)
        return zr.reshape((n2 // d) * n1), zi.reshape((n2 // d) * n1)

    spec = P(axis_name)
    f = shard_map(body, mesh, in_specs=(spec, spec), out_specs=(spec, spec))
    return jax.jit(f), NamedSharding(mesh, spec)


def _build_overlap(mesh, axis_name: str, n: int, n1: int, n2: int, d: int,
                   backend: str, k_chunks: int, dtype: str = "float32"):
    """Chunked double-buffered four-step: communication/compute overlap.

    The strictly sequential program (compute -> all_to_all -> compute)
    puts a full barrier at each collective; on a pod slice that is the
    first-order weak-scaling loss (SURVEY §7 names overlapping
    communication with per-axis compute as THE hard part behind the
    >= 85% weak-scaling target; reference decomposition
    /root/reference/src/ndfft.rs:114-153). Here each stage is split into
    K independent chunk chains so chunk k+1's ``all_to_all`` can fly
    while chunk k's local DFT runs — XLA's latency-hiding
    scheduler overlaps independent collective/compute chains; on CPU the
    chains compile to 2K mutually independent collective ops per stage
    (machine-checked by ``validate.hlo_a2a_independent_sources``).

    Chunking layout (restore_layout-only; natural-order output == the
    sequential program's bit-for-bit):
      stage A  chunk k = j2 columns [k*n2/K, (k+1)*n2/K): slice ->
               all_to_all (gather j1, split j2) -> DFT_{n1} -> twiddle
               with per-(chunk, chip) offset rows (offset = k*n2/K +
               c*n2/(dK), exact integer phase)
      stage B  chunk q = k1 columns [q*n1/K, (q+1)*n1/K) of the
               concatenated stage-A results: all_to_all (gather j2,
               split k1) -> static row un-permute ((c', k, t) ->
               (k, c', t), a free reshape/transpose) -> DFT_{n2} ->
               per-chunk restore all_to_all (gather k1, split k2)
    Total collective volume is unchanged (the comm audit still checks
    the canonical bytes); only the granularity changes.
    """
    require(n1 % (d * k_chunks) == 0 and n2 % (d * k_chunks) == 0,
            InvalidValueError,
            f"overlap={k_chunks} needs n1={n1} and n2={n2} divisible by "
            f"mesh_size*overlap = {d * k_chunks}")
    m1 = n1 // d
    br, bi, c2r, c2i = _twiddle_consts(n, n1, n2, d, dtype, k_chunks)
    ca = n2 // k_chunks            # stage-A chunk columns
    ra = ca // d                   # stage-A per-chip rows per chunk
    cb = n1 // k_chunks            # stage-B chunk columns
    rb = cb // d                   # stage-B per-chip columns per chunk

    def body(xr, xi):  # local flat shard (m1 * n2,)
        xr = xr.reshape(m1, n2)
        xi = xi.reshape(m1, n2)
        me = jax.lax.axis_index(axis_name)
        # ---- stage A: K independent (a2a -> DFT_{n1} -> twiddle) chains
        ys = []
        for k in range(k_chunks):
            ar = jax.lax.all_to_all(xr[:, k * ca:(k + 1) * ca], axis_name,
                                    split_axis=1, concat_axis=0,
                                    tiled=True)           # (n1, ra)
            ai = jax.lax.all_to_all(xi[:, k * ca:(k + 1) * ca], axis_name,
                                    split_axis=1, concat_axis=0,
                                    tiled=True)
            ar = jnp.swapaxes(ar, 0, 1)                   # (ra, n1)
            ai = jnp.swapaxes(ai, 0, 1)
            yr, yi = _fft_planes(ar, ai, n1, False, backend, dtype)
            row = k * d + me
            crow_r = jax.lax.dynamic_index_in_dim(jnp.asarray(c2r), row,
                                                  axis=0, keepdims=False)
            crow_i = jax.lax.dynamic_index_in_dim(jnp.asarray(c2i), row,
                                                  axis=0, keepdims=False)
            wr = (jnp.asarray(br) * crow_r[None, :]
                  - jnp.asarray(bi) * crow_i[None, :])
            wi = (jnp.asarray(br) * crow_i[None, :]
                  + jnp.asarray(bi) * crow_r[None, :])
            ys.append((yr * wr - yi * wi, yr * wi + yi * wr))
        yr_all = jnp.concatenate([p[0] for p in ys], axis=0)  # (n2/d, n1)
        yi_all = jnp.concatenate([p[1] for p in ys], axis=0)
        # rows: (k, t) -> j2 = k*ca + me*ra + t (chunk-major, permuted
        # relative to the sequential program's contiguous j2 range)
        # ---- stage B: K independent (a2a -> DFT_{n2} -> restore) chains
        outs = []
        for q in range(k_chunks):
            sr = jax.lax.all_to_all(yr_all[:, q * cb:(q + 1) * cb],
                                    axis_name, split_axis=1, concat_axis=0,
                                    tiled=True)           # (n2, rb)
            si = jax.lax.all_to_all(yi_all[:, q * cb:(q + 1) * cb],
                                    axis_name, split_axis=1, concat_axis=0,
                                    tiled=True)
            # un-permute rows: received order (c', k, t) -> j2-sorted
            # (k, c', t); a static local reshape/transpose
            sr = sr.reshape(d, k_chunks, ra, rb).transpose(1, 0, 2, 3)
            si = si.reshape(d, k_chunks, ra, rb).transpose(1, 0, 2, 3)
            sr = jnp.swapaxes(sr.reshape(n2, rb), 0, 1)   # (rb, n2)
            si = jnp.swapaxes(si.reshape(n2, rb), 0, 1)
            zr, zi = _fft_planes(sr, si, n2, False, backend, dtype)
            # restore: gather this chunk's k1 across chips, split k2
            zr = jax.lax.all_to_all(zr, axis_name, split_axis=1,
                                    concat_axis=0, tiled=True)  # (cb, n2/d)
            zi = jax.lax.all_to_all(zi, axis_name, split_axis=1,
                                    concat_axis=0, tiled=True)
            outs.append((jnp.swapaxes(zr, 0, 1), jnp.swapaxes(zi, 0, 1)))
        # (n2/d, cb) chunks side by side -> (n2/d, n1) natural order
        zr = jnp.concatenate([p[0] for p in outs], axis=1)
        zi = jnp.concatenate([p[1] for p in outs], axis=1)
        return zr.reshape((n2 // d) * n1), zi.reshape((n2 // d) * n1)

    spec = P(axis_name)
    f = shard_map(body, mesh, in_specs=(spec, spec), out_specs=(spec, spec))
    return jax.jit(f), NamedSharding(mesh, spec)


def fft_sharded(xr, xi, mesh: Optional[Mesh] = None, axis_name: str = "d",
                inverse: bool = False, backend: str = "xla",
                restore_layout: bool = False, n1: Optional[int] = None,
                overlap: int = 1):
    """Distributed 1-D DFT of flat (n,) planes sharded over the mesh.

    ``restore_layout=True`` returns the natural-order spectrum (matching
    ``kofft_tpu.fft``) sharded contiguously; the default returns the
    transposed-digit layout — element ``[k1, k2]`` of the row-major
    (n1, n2) view holds ``X[k1 + n1*k2]`` — saving one all_to_all when
    downstream elementwise stages (convolution kernels, filtering masks
    laid out in the same digit order) can consume it. ``ifft_sharded`` is
    NOT such a consumer: it is the conjugate-wrapped forward program and
    requires natural row-major input — chain it only after
    ``restore_layout=True``. Inverse applies the 1/n backward
    normalization.

    ``overlap=K`` (K > 1) splits each stage into K independent chunk
    chains so collectives overlap local DFT compute (the weak-scaling
    pipeline; see ``_build_overlap``). Requires ``restore_layout=True``
    (the chunked digit-order layout would differ from the sequential
    contract) and n1, n2 divisible by mesh_size * K."""
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    d = mesh.shape[axis_name]
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    require(xr.ndim == 1 and xr.shape == xi.shape, InvalidValueError,
            "fft_sharded takes flat 1-D (re, im) planes")
    require(overlap >= 1, InvalidValueError, "overlap must be >= 1")
    require(overlap == 1 or restore_layout, InvalidValueError,
            "overlap > 1 requires restore_layout=True (natural order)")
    n = xr.shape[0]
    split = (n1, n // n1) if n1 else _split_for_mesh(n, d)
    require(split is not None and n % split[0] == 0
            and split[0] % d == 0 and split[1] % d == 0, InvalidValueError,
            f"n={n} has no n1*n2 factorization with both factors "
            f"divisible by the mesh size {d}")
    if inverse:
        yr, yi = fft_sharded(xr, -xi, mesh=mesh, axis_name=axis_name,
                             backend=backend, restore_layout=restore_layout,
                             n1=split[0], overlap=overlap)
        return yr / n, -yi / n
    fn, sharding = _build(_mesh_key(mesh, axis_name), n, split[0], split[1],
                          backend, restore_layout, trace_key(), overlap,
                          str(xr.dtype))
    xr = jax.device_put(xr, sharding)
    xi = jax.device_put(xi, sharding)
    return fn(xr, xi)


def ifft_sharded(xr, xi, mesh: Optional[Mesh] = None, axis_name: str = "d",
                 backend: str = "xla", restore_layout: bool = False,
                 n1: Optional[int] = None, overlap: int = 1):
    return fft_sharded(xr, xi, mesh=mesh, axis_name=axis_name, inverse=True,
                       backend=backend, restore_layout=restore_layout, n1=n1,
                       overlap=overlap)
