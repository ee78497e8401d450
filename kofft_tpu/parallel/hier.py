"""Two-level (slice, chip) mesh programs: ICI + DCN hierarchy.

SURVEY §2/§5.8 specifies collectives "over ICI (intra-slice) and DCN
(multi-slice)". A flat all_to_all over s*c chips makes every chip pair a
peer — on a multi-slice deployment most pairs then cross the DCN with
small per-peer messages. The hierarchical factorization replaces each
global re-pencil with TWO tiled all_to_alls:

    1. intra-slice, over the "chip" axis (c peers, rides ICI)
    2. inter-slice, over the "slice" axis (s peers, rides DCN)

The inter-slice step moves exactly the (s-1)/s fraction that MUST cross
slices (same cross-DCN bytes as the flat program) but in s-1 large
messages instead of d-c small ones, and as a separate op the scheduler
can overlap independently of the ICI leg. The price is bookkeeping: the
nested redistribution assigns digit ranges (chip-major, slice-minor), so
offsets, row un-permutes and the output PartitionSpec ordering all follow
the nested digits — worked out below and pinned by parity tests on a
(2, 4) virtual mesh.

Reference analog: none (the reference is single-process); this is the
scaling design the survey derives from its strided N-D
decomposition (``/root/reference/src/ndfft.rs:114-153``).
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
from ..ops.ndfft import _fftn_planes
from ..plan import tables
from .ndfft_sharded import shard_map

__all__ = ["make_hier_mesh", "fft_sharded_hier", "fftn_sharded_hier",
           "ifftn_sharded_hier", "ifft_sharded_hier"]

_MESHES2: dict = {}


def make_hier_mesh(n_slices: int, chips_per_slice: int,
                   names=("slice", "chip")) -> Mesh:
    """A (slice, chip) mesh over the first n_slices*chips_per_slice
    devices — rows are slices (DCN axis), columns chips (ICI axis)."""
    d = n_slices * chips_per_slice
    devs = np.asarray(jax.devices()[:d]).reshape(n_slices, chips_per_slice)
    return Mesh(devs, names)


def _mesh2_key(mesh: Mesh):
    key = (tuple(dv.id for dv in mesh.devices.flat), mesh.axis_names,
           mesh.devices.shape)
    _MESHES2[key] = mesh
    return key


def _hier_twiddles(n: int, n1: int, n2: int, s: int, c: int, dtype: str,
                   k_chunks: int = 1):
    """Separable twiddle for the nested j2 digits: base rows t in
    [0, n2/(K*s*c)) and one offset row per (chunk, slice, chip):
    off(k, sigma, gamma) = k*(n2/K) + gamma*(n2/(K*c)) +
    sigma*(n2/(K*s*c)), row index k*s*c + sigma*c + gamma. Host f64,
    exact integer phase mod n."""
    def build():
        ca = n2 // k_chunks
        rows = ca // (s * c)
        t = np.arange(rows, dtype=np.int64)
        k1 = np.arange(n1, dtype=np.int64)
        ang_b = (-2.0 * np.pi / n) * np.mod(np.outer(t, k1), n).astype(
            np.float64)
        ks = np.arange(k_chunks, dtype=np.int64)[:, None, None] * ca
        sg = np.arange(s, dtype=np.int64)[None, :, None] * rows
        gm = np.arange(c, dtype=np.int64)[None, None, :] * (ca // c)
        off = (ks + sg + gm).reshape(-1)     # row r = k*s*c + sigma*c + gm
        ang_c = (-2.0 * np.pi / n) * np.mod(np.outer(off, k1), n).astype(
            np.float64)
        return (np.cos(ang_b).astype(dtype), np.sin(ang_b).astype(dtype),
                np.cos(ang_c).astype(dtype), np.sin(ang_c).astype(dtype))

    return tables.custom(("fft_hier_tw", n, n1, n2, s, c, dtype, k_chunks),
                         build)


def _a2a(x, name, split_axis, concat_axis):
    return jax.lax.all_to_all(x, name, split_axis=split_axis,
                              concat_axis=concat_axis, tiled=True)


def _hier_repencil(a, c_name: str, s_name: str, split_axis: int = 1,
                   concat_axis: int = 0):
    """The two-level redistribution: intra-slice (ICI) leg first, then
    inter-slice (DCN). The ordering is a correctness invariant — the
    nested (chip-major, slice-minor) digit assignment, the per-tier
    volume audit and every un-permute depend on it — so it lives in ONE
    place for all hierarchical programs."""
    a = _a2a(a, c_name, split_axis, concat_axis)
    return _a2a(a, s_name, split_axis, concat_axis)


@functools.lru_cache(maxsize=None)
def _build_fft_hier(mesh_key, n: int, n1: int, n2: int, backend: str,
                    ck: tuple = (), dtype: str = "float32",
                    overlap: int = 1):
    mesh = _MESHES2[mesh_key]
    s_name, c_name = mesh.axis_names
    s, c = mesh.devices.shape
    d = s * c
    m1 = n1 // d
    if overlap > 1:
        return _build_fft_hier_overlap(mesh, n, n1, n2, backend, dtype,
                                       overlap)
    r1 = n2 // d                       # per-chip j2 rows after re-pencil
    br, bi, c2r, c2i = _hier_twiddles(n, n1, n2, s, c, dtype)

    def body(xr, xi):                  # local flat shard (m1 * n2,)
        xr = xr.reshape(m1, n2)
        xi = xi.reshape(m1, n2)
        me_s = jax.lax.axis_index(s_name)
        me_c = jax.lax.axis_index(c_name)

        # rows gathered slice-locally over ICI then across slices over
        # DCN stay ascending (sigma-major input order); cols land at
        # the nested (gamma-major) digit offset
        xr = _hier_repencil(xr, c_name, s_name)    # (n1, n2/d)
        xi = _hier_repencil(xi, c_name, s_name)
        xr = jnp.swapaxes(xr, 0, 1)    # (r1, n1)
        xi = jnp.swapaxes(xi, 0, 1)
        yr, yi = _fft_planes(xr, xi, n1, False, backend, dtype)
        row = me_s * c + me_c
        crow_r = jax.lax.dynamic_index_in_dim(jnp.asarray(c2r), row,
                                              axis=0, keepdims=False)
        crow_i = jax.lax.dynamic_index_in_dim(jnp.asarray(c2i), row,
                                              axis=0, keepdims=False)
        wr = (jnp.asarray(br) * crow_r[None, :]
              - jnp.asarray(bi) * crow_i[None, :])
        wi = (jnp.asarray(br) * crow_i[None, :]
              + jnp.asarray(bi) * crow_r[None, :])
        tr = yr * wr - yi * wi         # (r1, n1)
        ti = yr * wi + yi * wr

        def repencil2(a):
            # gather j2 (rows), split k1 (cols): rows arrive in nested
            # (sigma', gamma', t) order with j2 = gamma'*(n2/c) +
            # sigma'*r1 + t -> un-permute to ascending (gamma'-major)
            a = _hier_repencil(a, c_name, s_name)   # (n2, n1/d)
            a = a.reshape(s, c, r1, n1 // d).transpose(1, 0, 2, 3)
            return a.reshape(n2, n1 // d)

        tr = repencil2(tr)
        ti = repencil2(ti)
        tr = jnp.swapaxes(tr, 0, 1)    # (n1/d, n2)
        ti = jnp.swapaxes(ti, 0, 1)
        zr, zi = _fft_planes(tr, ti, n2, False, backend, dtype)

        def restore(a):
            # gather k1 (rows), split k2 (cols); rows arrive nested
            # (sigma', gamma', u) with k1 = gamma'*(n1/c) + sigma'*
            # (n1/d) + u -> un-permute, then transpose to (k2, k1)
            a = _hier_repencil(a, c_name, s_name)   # (n1, n2/d)
            a = a.reshape(s, c, n1 // d, r1).transpose(1, 0, 2, 3)
            return jnp.swapaxes(a.reshape(n1, r1), 0, 1)   # (r1, n1)

        zr = restore(zr)
        zi = restore(zi)
        return zr.reshape(r1 * n1), zi.reshape(r1 * n1)

    in_spec = P((s_name, c_name))          # sigma-major input shards
    out_spec = P((c_name, s_name))         # gamma-major natural output
    f = shard_map(body, mesh, in_specs=(in_spec, in_spec),
                  out_specs=(out_spec, out_spec))
    return jax.jit(f), NamedSharding(mesh, in_spec)


def _build_fft_hier_overlap(mesh, n: int, n1: int, n2: int, backend: str,
                            dtype: str, k_chunks: int):
    """Chunked pipeline on the two-level mesh: each four-step stage runs
    as K independent chains of (intra-slice a2a -> inter-slice a2a ->
    local DFT), so chunk k+1's collectives — including the DCN leg,
    exactly the one worth hiding — fly while chunk k's DFT runs. Digit
    bookkeeping composes the hierarchy's nested (chip-major,
    slice-minor) offsets with the chunk offsets; stage-B/restore rows
    un-permute via static reshapes. Natural-order output identical to
    the sequential hierarchical program."""
    s_name, c_name = mesh.axis_names
    s, c = mesh.devices.shape
    d = s * c
    m1 = n1 // d
    require(n1 % (d * k_chunks) == 0 and n2 % (d * k_chunks) == 0,
            InvalidValueError,
            f"overlap={k_chunks} needs n1={n1} and n2={n2} divisible by "
            f"mesh_size*overlap = {d * k_chunks}")
    br, bi, c2r, c2i = _hier_twiddles(n, n1, n2, s, c, dtype, k_chunks)
    ca = n2 // k_chunks            # stage-A chunk columns
    ra = ca // d                   # per-chip rows per stage-A chunk
    cb = n1 // k_chunks            # stage-B chunk columns
    rb = cb // d                   # per-chip columns per stage-B chunk

    def body(xr, xi):              # local flat shard (m1 * n2,)
        xr = xr.reshape(m1, n2)
        xi = xi.reshape(m1, n2)
        me_s = jax.lax.axis_index(s_name)
        me_c = jax.lax.axis_index(c_name)

        # ---- stage A: K independent (a2a-pair -> DFT -> twiddle) chains
        ys = []
        for k in range(k_chunks):
            ar = _hier_repencil(xr[:, k * ca:(k + 1) * ca],
                                c_name, s_name)         # (n1, ra)
            ai = _hier_repencil(xi[:, k * ca:(k + 1) * ca],
                                c_name, s_name)
            ar = jnp.swapaxes(ar, 0, 1)                 # (ra, n1)
            ai = jnp.swapaxes(ai, 0, 1)
            yr, yi = _fft_planes(ar, ai, n1, False, backend, dtype)
            row = k * (s * c) + me_s * c + me_c
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
        # rows: (k, t) with j2 = k*ca + gamma*(ca/c) + sigma*ra + t

        # ---- stage B: K independent (a2a-pair -> DFT -> restore) chains
        outs = []
        r0 = ra                    # finest j2 run length == ca // d
        for q in range(k_chunks):
            sr = _hier_repencil(yr_all[:, q * cb:(q + 1) * cb],
                                c_name, s_name)         # (n2, rb)
            si = _hier_repencil(yi_all[:, q * cb:(q + 1) * cb],
                                c_name, s_name)
            # received rows (sigma', gamma', k, t) -> ascending j2 =
            # (k, gamma', sigma', t)
            sr = (sr.reshape(s, c, k_chunks, r0, rb)
                  .transpose(2, 1, 0, 3, 4).reshape(n2, rb))
            si = (si.reshape(s, c, k_chunks, r0, rb)
                  .transpose(2, 1, 0, 3, 4).reshape(n2, rb))
            sr = jnp.swapaxes(sr, 0, 1)                     # (rb, n2)
            si = jnp.swapaxes(si, 0, 1)
            zr, zi = _fft_planes(sr, si, n2, False, backend, dtype)
            # restore: gather this chunk's k1, split k2; received rows
            # (sigma', gamma', u) -> ascending k1-within-chunk
            zr = _hier_repencil(zr, c_name, s_name)     # (cb, n2/d)
            zi = _hier_repencil(zi, c_name, s_name)
            zr = (zr.reshape(s, c, rb, n2 // d)
                  .transpose(1, 0, 2, 3).reshape(cb, n2 // d))
            zi = (zi.reshape(s, c, rb, n2 // d)
                  .transpose(1, 0, 2, 3).reshape(cb, n2 // d))
            outs.append((jnp.swapaxes(zr, 0, 1), jnp.swapaxes(zi, 0, 1)))
        zr = jnp.concatenate([p[0] for p in outs], axis=1)  # (n2/d, n1)
        zi = jnp.concatenate([p[1] for p in outs], axis=1)
        return zr.reshape((n2 // d) * n1), zi.reshape((n2 // d) * n1)

    in_spec = P((s_name, c_name))
    out_spec = P((c_name, s_name))
    f = shard_map(body, mesh, in_specs=(in_spec, in_spec),
                  out_specs=(out_spec, out_spec))
    return jax.jit(f), NamedSharding(mesh, in_spec)


def fft_sharded_hier(xr, xi, mesh: Optional[Mesh] = None,
                     inverse: bool = False, backend: str = "xla",
                     n1: Optional[int] = None, overlap: int = 1):
    """Distributed 1-D DFT over a two-level (slice, chip) mesh.

    Natural-order output (the ``restore_layout=True`` contract of
    :func:`fft_sharded`): the gathered global array equals ``np.fft``.
    Every re-pencil is an intra-slice all_to_all (ICI) followed by an
    inter-slice all_to_all (DCN) — 6 collectives total, with exactly the
    flat program's cross-slice byte volume but in s-1 large DCN messages
    per step instead of d-c small ones.

    ``overlap=K`` runs each stage as K independent chunk chains so the
    collectives — ICI and DCN legs both — fly behind the per-chunk DFTs
    (see ``_build_fft_hier_overlap``)."""
    mesh = mesh if mesh is not None else make_hier_mesh(
        1, len(jax.devices()))
    require(len(mesh.axis_names) == 2, InvalidValueError,
            "fft_sharded_hier needs a 2-D (slice, chip) mesh")
    s, c = mesh.devices.shape
    d = s * c
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    require(xr.ndim == 1 and xr.shape == xi.shape, InvalidValueError,
            "fft_sharded_hier takes flat 1-D (re, im) planes")
    require(overlap >= 1, InvalidValueError, "overlap must be >= 1")
    n = xr.shape[0]
    from .fft_sharded import _split_for_mesh
    split = (n1, n // n1) if n1 else _split_for_mesh(n, d)
    require(split is not None and n % split[0] == 0
            and split[0] % d == 0 and split[1] % d == 0, InvalidValueError,
            f"n={n} has no n1*n2 factorization with both factors "
            f"divisible by the mesh size {d}")
    if inverse:
        yr, yi = fft_sharded_hier(xr, -xi, mesh=mesh, backend=backend,
                                  n1=split[0], overlap=overlap)
        return yr / n, -yi / n
    fn, sharding = _build_fft_hier(_mesh2_key(mesh), n, split[0], split[1],
                                   backend, trace_key(), str(xr.dtype),
                                   overlap)
    xr = jax.device_put(xr, sharding)
    xi = jax.device_put(xi, sharding)
    return fn(xr, xi)


def ifft_sharded_hier(xr, xi, mesh: Optional[Mesh] = None,
                      backend: str = "xla", n1: Optional[int] = None,
                      overlap: int = 1):
    return fft_sharded_hier(xr, xi, mesh=mesh, inverse=True,
                            backend=backend, n1=n1, overlap=overlap)


@functools.lru_cache(maxsize=None)
def _build_fftn_hier(mesh_key, ndim: int, inverse: bool, backend: str,
                     restore_layout: bool, ck: tuple = (),
                     overlap: int = 1):
    mesh = _MESHES2[mesh_key]
    s_name, c_name = mesh.axis_names
    in_spec = P((s_name, c_name), *([None] * (ndim - 1)))
    out_spec = (in_spec if restore_layout
                else P(*([None] * (ndim - 1)), (c_name, s_name)))

    if overlap > 1:
        # chunked pipeline (restore-only): the last axis is transformed
        # first, then each output-column chunk runs mid-axes FFT ->
        # ICI/DCN re-pencil -> axis-0 FFT -> ICI/DCN restore as an
        # independent chain; the restore pair inverts the forward pair
        # per chunk so concatenating chunks rebuilds the input layout
        def body(xr, xi):
            xr, xi = _fftn_planes(xr, xi, (ndim - 1,), inverse, backend)
            lc = xr.shape[-1]
            ckw = lc // overlap
            mids = tuple(range(1, ndim - 1))
            outs = []
            for k in range(overlap):
                cr = xr[..., k * ckw:(k + 1) * ckw]
                ci = xi[..., k * ckw:(k + 1) * ckw]
                if mids:
                    cr, ci = _fftn_planes(cr, ci, mids, inverse, backend)
                cr = _hier_repencil(cr, c_name, s_name, ndim - 1, 0)
                ci = _hier_repencil(ci, c_name, s_name, ndim - 1, 0)
                cr, ci = _fftn_planes(cr, ci, (0,), inverse, backend)
                for name in (s_name, c_name):
                    cr = _a2a(cr, name, 0, ndim - 1)
                    ci = _a2a(ci, name, 0, ndim - 1)
                outs.append((cr, ci))
            xr = jnp.concatenate([o[0] for o in outs], axis=-1)
            xi = jnp.concatenate([o[1] for o in outs], axis=-1)
            return xr, xi
    else:
        def body(xr, xi):
            # 1. all non-sharded axes locally
            local_axes = tuple(range(1, ndim))
            if local_axes:
                xr, xi = _fftn_planes(xr, xi, local_axes, inverse, backend)
            # 2. hierarchical re-pencil: ICI gather within the slice,
            # DCN gather across slices; last axis lands at the nested
            # (chip-major, slice-minor) digit — matching out_spec's
            # (c_name, s_name) ordering
            xr = _hier_repencil(xr, c_name, s_name, ndim - 1, 0)
            xi = _hier_repencil(xi, c_name, s_name, ndim - 1, 0)
            # 3. the (now local) leading axis
            xr, xi = _fftn_planes(xr, xi, (0,), inverse, backend)
            if restore_layout:
                for name in (s_name, c_name):
                    xr = _a2a(xr, name, 0, ndim - 1)
                    xi = _a2a(xi, name, 0, ndim - 1)
            return xr, xi

    f = shard_map(body, mesh, in_specs=(in_spec, in_spec),
                  out_specs=(out_spec, out_spec))
    return jax.jit(f), NamedSharding(mesh, in_spec)


def fftn_sharded_hier(xr, xi, mesh: Optional[Mesh] = None,
                      inverse: bool = False, backend: str = "xla",
                      restore_layout: bool = False, overlap: int = 1):
    """Distributed N-D FFT over a two-level (slice, chip) mesh: the
    pencil re-distribution runs as intra-slice (ICI) then inter-slice
    (DCN) all_to_alls. Output sharded on the last axis in nested
    (chip, slice) order unless ``restore_layout``; the gathered global
    array is identical to :func:`fftn_sharded`'s. ``overlap=K`` runs K
    independent chunk chains per stage (requires ``restore_layout=True``
    and the last axis divisible by mesh_size*K)."""
    mesh = mesh if mesh is not None else make_hier_mesh(
        1, len(jax.devices()))
    require(len(mesh.axis_names) == 2, InvalidValueError,
            "fftn_sharded_hier needs a 2-D (slice, chip) mesh")
    s, c = mesh.devices.shape
    d = s * c
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    require(xr.ndim >= 2 and xr.shape == xi.shape, InvalidValueError,
            "fftn_sharded_hier takes >= 2-D equal-shape planes")
    require(xr.shape[0] % d == 0 and xr.shape[-1] % d == 0,
            InvalidValueError,
            f"axis 0 ({xr.shape[0]}) and axis -1 ({xr.shape[-1]}) must be "
            f"divisible by the mesh size {d}")
    require(overlap >= 1, InvalidValueError, "overlap must be >= 1")
    require(overlap == 1 or restore_layout, InvalidValueError,
            "overlap > 1 requires restore_layout=True (natural order)")
    require(xr.shape[-1] % (d * overlap) == 0, InvalidValueError,
            f"overlap={overlap} needs axis -1 ({xr.shape[-1]}) divisible "
            f"by mesh_size*overlap = {d * overlap}")
    fn, in_sharding = _build_fftn_hier(_mesh2_key(mesh), xr.ndim, inverse,
                                       backend, restore_layout, trace_key(),
                                       overlap)
    xr = jax.device_put(xr, in_sharding)
    xi = jax.device_put(xi, in_sharding)
    return fn(xr, xi)


def ifftn_sharded_hier(xr, xi, mesh: Optional[Mesh] = None,
                       backend: str = "xla", restore_layout: bool = False,
                       overlap: int = 1):
    return fftn_sharded_hier(xr, xi, mesh=mesh, inverse=True,
                             backend=backend, restore_layout=restore_layout,
                             overlap=overlap)
