"""Sharded NDFFT / STFT on the 8-virtual-device CPU mesh.

These pin the parity contract: mesh-sharded execution is bit-compatible
(up to f32 reduction order) with the single-device engine — the analog
of the reference's parallel-vs-serial threshold tests
(tests/parallel_stockham.rs:6-28).
"""

import numpy as np
import pytest
import jax

from kofft_tpu.ops import ndfft, stft as S, window as W
from kofft_tpu.ops.dft import snr_db
from kofft_tpu.parallel import (fftn_sharded, ifftn_sharded, istft_sharded,
                                make_mesh, should_shard, stft_sharded)

SNR = 95.0


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


def test_should_shard_threshold():
    from kofft_tpu.config import set_shard_threshold
    set_shard_threshold(1000)
    assert not should_shard(999 * 8, 8)
    assert should_shard(1000 * 8, 8)
    assert not should_shard(10 ** 9, 1)
    set_shard_threshold(None)


def test_fftn_sharded_2d(rng, mesh):
    x = (rng.standard_normal((32, 64))
         + 1j * rng.standard_normal((32, 64))).astype(np.complex64)
    yr, yi = fftn_sharded(np.ascontiguousarray(x.real),
                          np.ascontiguousarray(x.imag), mesh=mesh)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    ref = np.fft.fft2(x.astype(np.complex128))
    assert snr_db(ref, got) > SNR


def test_fftn_sharded_3d(rng, mesh):
    x = (rng.standard_normal((16, 8, 24))
         + 1j * rng.standard_normal((16, 8, 24))).astype(np.complex64)
    yr, yi = fftn_sharded(np.ascontiguousarray(x.real),
                          np.ascontiguousarray(x.imag), mesh=mesh)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    ref = np.fft.fftn(x.astype(np.complex128))
    assert snr_db(ref, got) > SNR


def test_fftn_sharded_roundtrip_restore_layout(rng, mesh):
    x = (rng.standard_normal((16, 16))
         + 1j * rng.standard_normal((16, 16))).astype(np.complex64)
    yr, yi = fftn_sharded(np.ascontiguousarray(x.real),
                          np.ascontiguousarray(x.imag), mesh=mesh,
                          restore_layout=True)
    zr, zi = ifftn_sharded(yr, yi, mesh=mesh, restore_layout=True)
    back = np.asarray(zr) + 1j * np.asarray(zi)
    assert snr_db(x, back) > SNR


def test_fftn_sharded_bad_divisibility(rng, mesh):
    import kofft_tpu as kt
    with pytest.raises(kt.KofftError):
        fftn_sharded(np.zeros((10, 16), np.float32),
                     np.zeros((10, 16), np.float32), mesh=mesh)


def test_stft_sharded_matches_single(rng, mesh):
    n, win, hop = 8 * 64, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    fr, fi = stft_sharded(x, w, hop, mesh=mesh)
    got = np.asarray(fr) + 1j * np.asarray(fi)
    ref = np.asarray(S.stft(x, w, hop))
    assert got.shape == ref.shape
    assert snr_db(ref, got) > SNR


def test_istft_sharded_matches_single(rng, mesh):
    n, win, hop = 8 * 64, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    frames = np.asarray(S.stft(x, w, hop))
    nf = frames.shape[0]
    offline = np.asarray(S.istft(frames, w, hop,
                                 length=(nf - 1) * hop + win))
    out = istft_sharded(np.ascontiguousarray(frames.real),
                        np.ascontiguousarray(frames.imag), w, hop,
                        mesh=mesh)
    out = np.asarray(out)
    # sharded istft returns the push region (F*hop samples)
    assert out.shape == (nf * hop,)
    assert snr_db(offline[: nf * hop], out) > SNR


def test_stft_istft_sharded_roundtrip(rng, mesh):
    n, win, hop = 8 * 128, 128, 32
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    fr, fi = stft_sharded(x, w, hop, mesh=mesh)
    out = np.asarray(istft_sharded(fr, fi, w, hop, mesh=mesh))
    assert snr_db(x[win:n - win], out[win:n - win]) > SNR


def test_fftn_auto_routes(rng, mesh):
    """Auto dispatch shards when above threshold, stays local below
    (reference parallel-vs-serial threshold behavior)."""
    from kofft_tpu.config import set_shard_threshold
    from kofft_tpu.parallel import fftn_auto
    x = (rng.standard_normal((16, 16))
         + 1j * rng.standard_normal((16, 16))).astype(np.complex64)
    ref = np.fft.fft2(x.astype(np.complex128))
    set_shard_threshold(1)      # force sharding
    yr, yi = fftn_auto(np.ascontiguousarray(x.real),
                       np.ascontiguousarray(x.imag))
    assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > SNR
    set_shard_threshold(10 ** 9)  # force local
    yr, yi = fftn_auto(np.ascontiguousarray(x.real),
                       np.ascontiguousarray(x.imag))
    assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > SNR
    set_shard_threshold(None)


def test_stft_auto_routes(rng, mesh):
    from kofft_tpu.config import set_shard_threshold
    from kofft_tpu.parallel import stft_auto
    from kofft_tpu.ops import window as W
    n, win, hop = 8 * 128, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    ref = np.asarray(S.stft(x, w, hop))
    set_shard_threshold(1)
    fr, fi = stft_auto(x, w, hop)
    assert snr_db(ref, np.asarray(fr) + 1j * np.asarray(fi)) > SNR
    set_shard_threshold(None)


# ---------------------------------------------------------------------------
# distributed 1-D FFT (four-step over all-to-all, SURVEY §5.7)
# ---------------------------------------------------------------------------

def test_fft_sharded_natural_order(rng):
    from kofft_tpu.parallel import fft_sharded, make_mesh
    mesh = make_mesh()
    n = 1 << 12
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    yr, yi = fft_sharded(np.ascontiguousarray(x.real),
                         np.ascontiguousarray(x.imag), mesh=mesh,
                         restore_layout=True)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    ref = np.fft.fft(x.astype(np.complex128))
    assert snr_db(ref, got) > 100.0


def test_fft_sharded_digit_layout(rng):
    """Default layout: element [k1, k2] of the (n1, n2) view holds
    X[k1 + n1*k2]."""
    from kofft_tpu.parallel import fft_sharded, make_mesh
    from kofft_tpu.parallel.fft_sharded import _split_for_mesh
    mesh = make_mesh()
    d = mesh.devices.size
    n = 1 << 12
    n1, n2 = _split_for_mesh(n, d)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    yr, yi = fft_sharded(np.ascontiguousarray(x.real),
                         np.ascontiguousarray(x.imag), mesh=mesh)
    got = (np.asarray(yr) + 1j * np.asarray(yi)).reshape(n1, n2)
    ref = np.fft.fft(x.astype(np.complex128))
    # undo the digit transpose: got[k1, k2] == X[k1 + n1*k2]
    unscrambled = got.T.reshape(n)
    assert snr_db(ref, unscrambled) > 100.0


def test_fft_sharded_roundtrip(rng):
    from kofft_tpu.parallel import fft_sharded, ifft_sharded, make_mesh
    mesh = make_mesh()
    n = 1 << 12
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    yr, yi = fft_sharded(np.ascontiguousarray(x.real),
                         np.ascontiguousarray(x.imag), mesh=mesh,
                         restore_layout=True)
    br, bi = ifft_sharded(np.asarray(yr), np.asarray(yi), mesh=mesh,
                          restore_layout=True)
    back = np.asarray(br) + 1j * np.asarray(bi)
    assert np.abs(back - x).max() < 1e-4


def test_fft_sharded_matches_single_chip(rng):
    """Distributed result == the single-chip engine (the reference's
    parallel-vs-serial parity discipline, tests/parallel_stockham.rs)."""
    import kofft_tpu as kt
    from kofft_tpu.parallel import fft_sharded, make_mesh
    mesh = make_mesh()
    n = 3 * (1 << 10)    # non-pow2 smooth n: 3072 = 2^10 * 3
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    yr, yi = fft_sharded(np.ascontiguousarray(x.real),
                         np.ascontiguousarray(x.imag), mesh=mesh,
                         restore_layout=True)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    want = kt.asnumpy(kt.fft(x))
    assert np.abs(got - want).max() < 1e-2 * max(1.0, np.abs(want).max())


def test_fft_auto_routes(rng, mesh):
    """fft_auto shards above the gate (multi-device output sharding) and
    stays local below it — both sides forced via the runtime setter
    (reference pattern tests/parallel_stockham.rs:6-28)."""
    from kofft_tpu.config import set_shard_threshold
    from kofft_tpu.parallel import fft_auto
    n = 1 << 12
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    ref = np.fft.fft(x.astype(np.complex128))
    try:
        set_shard_threshold(1)      # force sharding
        yr, yi = fft_auto(np.ascontiguousarray(x.real),
                          np.ascontiguousarray(x.imag))
        assert len(yr.sharding.device_set) > 1, "expected sharded output"
        assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > SNR
        set_shard_threshold(10 ** 9)  # force local
        yr, yi = fft_auto(np.ascontiguousarray(x.real),
                          np.ascontiguousarray(x.imag))
        assert len(yr.sharding.device_set) == 1, "expected local output"
        assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > SNR
    finally:
        set_shard_threshold(None)


def test_istft_auto_routes(rng, mesh):
    from kofft_tpu.config import set_shard_threshold
    from kofft_tpu.parallel import istft_auto
    n, win, hop = 8 * 64, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    frames = np.asarray(S.stft(x, w, hop))
    nf = frames.shape[0]
    offline = np.asarray(S.istft(frames, w, hop,
                                 length=(nf - 1) * hop + win))[: nf * hop]
    fr = np.ascontiguousarray(frames.real)
    fi = np.ascontiguousarray(frames.imag)
    try:
        set_shard_threshold(1)
        out = np.asarray(istft_auto(fr, fi, w, hop))
        assert out.shape == (nf * hop,)
        assert snr_db(offline, out) > SNR
        set_shard_threshold(10 ** 9)
        out2 = np.asarray(istft_auto(fr, fi, w, hop))
        assert out2.shape == (nf * hop,)
        assert snr_db(offline, out2) > SNR
    finally:
        set_shard_threshold(None)


def test_calibrate_shard_threshold(mesh):
    """The probe runs on the live mesh, returns a positive points-per-chip
    threshold, and only mutates config when it measured a sharding win
    (reference calibration probe analog, src/fft.rs:128-140)."""
    from kofft_tpu.config import get_config, set_shard_threshold
    from kofft_tpu.parallel import calibrate_shard_threshold
    try:
        before = get_config().shard_threshold
        out = calibrate_shard_threshold(probe_points=1 << 12, apply=False)
        assert isinstance(out, int) and out > 0
        assert get_config().shard_threshold == before  # apply=False
        out2 = calibrate_shard_threshold(probe_points=1 << 12, apply=True)
        assert get_config().shard_threshold in (before, out2)
    finally:
        set_shard_threshold(None)


def test_fft_sharded_comm_volume_invariant(mesh):
    """The compiled distributed FFT moves EXACTLY the canonical
    all_to_all volume — 2 (3 with restore) x both planes x n/D local
    bytes, of which (D-1)/D crosses chips. This is the machine-checked
    proxy for the >= 85% weak-scaling claim (VERDICT r1 item 10): the
    per-chip collective volume is constant in weak scaling by
    construction, and any XLA or program regression that inflates
    traffic fails here."""
    from kofft_tpu.parallel.validate import (
        check_fft_sharded_comm_volume, fft_sharded_expected_a2a_bytes)
    rep = check_fft_sharded_comm_volume(1 << 12, mesh,
                                        restore_layout=True)
    assert rep["local_a2a_bytes"] == fft_sharded_expected_a2a_bytes(
        1 << 12, 8, True) == 3 * 2 * (1 << 9) * 4
    rep2 = check_fft_sharded_comm_volume(1 << 12, mesh,
                                         restore_layout=False)
    assert rep2["local_a2a_bytes"] == 2 * 2 * (1 << 9) * 4


def test_hlo_a2a_bytes_counts_async_pairs_once():
    """Async start/done lowering is counted exactly once, via the DONE
    op's result type — regardless of how many aliased operand buffers the
    START tuple lists (ADVICE r2 item 2: the start-tuple layout varies
    across XLA versions; the done result is the transferred shard)."""
    from kofft_tpu.parallel.validate import hlo_all_to_all_local_bytes
    # start lists operand aliases AND results AND a control scalar; done
    # carries only the result — 16x16 f32 = 1024 B
    async_txt = """
  %all-to-all-start.1 = (f32[16,16]{1,0}, f32[16,16]{1,0}, s32[]) all-to-all-start(%p0), replica_groups={}
  %all-to-all-done.1 = f32[16,16]{1,0} all-to-all-done(%all-to-all-start.1)
"""
    assert hlo_all_to_all_local_bytes(async_txt) == 16 * 16 * 4
    # start-only variants with asymmetric tuples must not contribute
    start_heavy = """
  %all-to-all-start.2 = (f32[16,16]{1,0}, f32[16,16]{1,0}, f32[16,16]{1,0}, u32[2]) all-to-all-start(%p1)
  %all-to-all-done.2 = f32[16,16]{1,0} all-to-all-done(%all-to-all-start.2)
"""
    assert hlo_all_to_all_local_bytes(start_heavy) == 16 * 16 * 4
    # sync tuple-of-chunks form: result shapes sum to the local shard
    sync_txt = """
  %all-to-all.3 = (f32[8,16]{1,0}, f32[8,16]{1,0}) all-to-all(%a, %b), dimensions={0}
"""
    assert hlo_all_to_all_local_bytes(sync_txt) == 2 * 8 * 16 * 4


def test_calibrate_shard_threshold_bounded_upward_scan(mesh):
    """When sharding loses at the probe, the scan probes UPWARD (a
    threshold wrong on the high side is the case that costs performance
    on a pod — VERDICT r2 weak #3), bounded by max_points."""
    from kofft_tpu.config import get_config, set_shard_threshold
    from kofft_tpu.parallel import calibrate_shard_threshold
    try:
        before = get_config().shard_threshold
        # max_points == probe_points: the upward scan is a no-op, so the
        # call must terminate after the single probe either way
        out = calibrate_shard_threshold(probe_points=1 << 12, apply=False,
                                        max_points=1 << 12)
        assert isinstance(out, int) and out > 0
        assert get_config().shard_threshold == before
    finally:
        set_shard_threshold(None)


# --------------------------------------------------------------------------
# communication/compute overlap pipeline (r3, VERDICT item 1)
# --------------------------------------------------------------------------

def test_fft_sharded_overlap_parity(mesh, rng):
    """The chunked overlap pipeline returns the sequential program's
    natural-order spectrum bit-compatibly (same algorithm, same twiddle
    phases, different collective granularity)."""
    from kofft_tpu.parallel.fft_sharded import fft_sharded, ifft_sharded
    n = 1 << 13
    xr = rng.standard_normal(n).astype(np.float32)
    xi = rng.standard_normal(n).astype(np.float32)
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    seq_r, seq_i = fft_sharded(xr, xi, mesh=mesh, restore_layout=True)
    seq = np.asarray(seq_r) + 1j * np.asarray(seq_i)
    for k in (2, 4):
        yr, yi = fft_sharded(xr, xi, mesh=mesh, restore_layout=True,
                             overlap=k)
        got = np.asarray(yr) + 1j * np.asarray(yi)
        assert snr_db(ref, got) > SNR
        assert snr_db(seq, got) > SNR
    # inverse roundtrip through the pipeline
    br, bi = ifft_sharded(np.asarray(seq_r), np.asarray(seq_i), mesh=mesh,
                          restore_layout=True, overlap=4)
    assert snr_db(xr + 1j * xi,
                  np.asarray(br) + 1j * np.asarray(bi)) > SNR - 5


def test_fftn_sharded_overlap_parity(mesh, rng):
    from kofft_tpu.parallel.ndfft_sharded import fftn_sharded
    for shape in ((32, 64), (16, 8, 32)):
        xr = rng.standard_normal(shape).astype(np.float32)
        xi = rng.standard_normal(shape).astype(np.float32)
        ref = np.fft.fftn(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        for k in (2,):
            yr, yi = fftn_sharded(xr, xi, mesh=mesh, restore_layout=True,
                                  overlap=k)
            assert np.asarray(yr).shape == shape
            assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > SNR


def test_overlap_comm_volume_and_independence(mesh):
    """Two machine-checked pipeline invariants (VERDICT r3 item 1 'Done'
    criteria): (a) the overlap program moves EXACTLY the canonical
    collective bytes — only granularity changes; (b) the HLO dependency
    graph has 2K mutually independent collective source chains (the
    schedulability property the latency-hiding scheduler exploits),
    vs exactly 2 for the sequential program."""
    from kofft_tpu.parallel.validate import check_fft_sharded_comm_volume
    n = 1 << 13
    rep1 = check_fft_sharded_comm_volume(n, mesh, restore_layout=True,
                                         overlap=1)
    assert rep1["total"] == 6 and rep1["independent_sources"] == 2
    for k in (2, 4):
        rep = check_fft_sharded_comm_volume(n, mesh, restore_layout=True,
                                            overlap=k)
        assert rep["local_a2a_bytes"] == rep1["local_a2a_bytes"]
        assert rep["total"] == 6 * k
        assert rep["independent_sources"] == 2 * k


def test_fftn_overlap_independence(mesh):
    import jax
    from kofft_tpu.config import trace_key
    from kofft_tpu.parallel.ndfft_sharded import _build, _mesh_key
    from kofft_tpu.parallel.validate import hlo_a2a_independent_sources
    fn, sh = _build(_mesh_key(mesh, "d"), 2, False, "xla", True,
                    trace_key(), 4)
    x = jax.device_put(np.zeros((32, 64), np.float32), sh)
    txt = fn.lower(x, x).compile().as_text()
    rep = hlo_a2a_independent_sources(txt)
    assert rep["total"] == 16 and rep["independent_sources"] == 8


def test_overlap_validation_errors(mesh):
    from kofft_tpu.errors import InvalidValueError
    from kofft_tpu.parallel.fft_sharded import fft_sharded
    from kofft_tpu.parallel.ndfft_sharded import fftn_sharded
    x = np.zeros(1 << 12, np.float32)
    with pytest.raises(InvalidValueError):   # overlap without restore
        fft_sharded(x, x, mesh=mesh, overlap=2)
    with pytest.raises(InvalidValueError):   # factors don't divide d*K
        fft_sharded(x, x, mesh=mesh, restore_layout=True, overlap=64)
    x2 = np.zeros((16, 16), np.float32)
    with pytest.raises(InvalidValueError):
        fftn_sharded(x2, x2, mesh=mesh, restore_layout=True, overlap=4)


def test_fft_auto_uses_overlap_when_divisible(mesh, rng):
    """fft_auto picks the largest configured overlap that divides the
    factorization and still returns the natural-order spectrum."""
    from kofft_tpu.config import set_overlap_chunks, set_shard_threshold
    from kofft_tpu.parallel import fft_auto
    n = 1 << 13
    xr = rng.standard_normal(n).astype(np.float32)
    xi = rng.standard_normal(n).astype(np.float32)
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    try:
        set_shard_threshold(1)
        for k in (1, 4):
            set_overlap_chunks(k)
            yr, yi = fft_auto(xr, xi)
            assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > SNR
    finally:
        set_shard_threshold(None)
        set_overlap_chunks(None)


# --------------------------------------------------------------------------
# two-level (slice, chip) hierarchy (r3, VERDICT item 5; SURVEY §5.8)
# --------------------------------------------------------------------------

def test_fft_sharded_hier_parity(rng):
    """Hierarchical (ICI-then-DCN) distributed FFT: the gathered global
    spectrum equals numpy on both (2,4) and (4,2) virtual topologies,
    and the inverse round-trips."""
    from kofft_tpu.parallel.hier import (fft_sharded_hier, ifft_sharded_hier,
                                         make_hier_mesh)
    n = 1 << 13
    xr = rng.standard_normal(n).astype(np.float32)
    xi = rng.standard_normal(n).astype(np.float32)
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    for s, c in ((2, 4), (4, 2)):
        mesh = make_hier_mesh(s, c)
        yr, yi = fft_sharded_hier(xr, xi, mesh=mesh)
        assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > SNR
    mesh = make_hier_mesh(2, 4)
    yr, yi = fft_sharded_hier(xr, xi, mesh=mesh)
    br, bi = ifft_sharded_hier(np.asarray(yr), np.asarray(yi), mesh=mesh)
    assert snr_db(xr + 1j * xi,
                  np.asarray(br) + 1j * np.asarray(bi)) > SNR - 5


def test_fftn_sharded_hier_parity(mesh, rng):
    """Hierarchical pencil N-D FFT matches the flat-mesh program's
    gathered result bit-for-bit in both layout modes."""
    from kofft_tpu.parallel.hier import fftn_sharded_hier, make_hier_mesh
    from kofft_tpu.parallel.ndfft_sharded import fftn_sharded
    h = make_hier_mesh(2, 4)
    for shape in ((16, 4, 32), (32, 64)):
        xr = rng.standard_normal(shape).astype(np.float32)
        xi = rng.standard_normal(shape).astype(np.float32)
        fr, fi = fftn_sharded(xr, xi, mesh=mesh, restore_layout=True)
        flat = np.asarray(fr) + 1j * np.asarray(fi)
        for restore in (False, True):
            yr, yi = fftn_sharded_hier(xr, xi, mesh=h,
                                       restore_layout=restore)
            got = np.asarray(yr) + 1j * np.asarray(yi)
            assert got.shape == shape
            assert snr_db(flat, got) > 135.0   # same engine, same math


def test_hier_per_axis_comm_volume(rng):
    """The ICI/DCN split is a checked property: on a (2, 4) mesh the
    compiled hierarchical FFT moves equal local bytes in
    chips_per_slice-sized groups (ICI) and n_slices-sized groups (DCN)
    - 3 re-pencils x 2 planes x n/d local elements each."""
    import jax
    from kofft_tpu.config import trace_key
    from kofft_tpu.parallel.hier import (_build_fft_hier, _mesh2_key,
                                         make_hier_mesh)
    from kofft_tpu.parallel.validate import hlo_a2a_bytes_by_group_size
    mesh = make_hier_mesh(2, 4)
    n = 1 << 12
    fn, sh = _build_fft_hier(_mesh2_key(mesh), n, 64, 64, "xla",
                             trace_key())
    x = jax.device_put(np.zeros(n, np.float32), sh)
    txt = fn.lower(x, x).compile().as_text()
    per = hlo_a2a_bytes_by_group_size(txt)
    leg = 3 * 2 * (n // 8) * 4
    assert per == {4: leg, 2: leg}, per


def test_fft_sharded_hier_overlap_parity(rng):
    """overlap=K composes with the (slice, chip) hierarchy: K chunk
    chains of (ICI a2a -> DCN a2a -> DFT) per stage, natural-order
    output identical to the sequential hierarchical program."""
    from kofft_tpu.parallel.hier import (fft_sharded_hier,
                                         ifft_sharded_hier, make_hier_mesh)
    n = 1 << 13
    xr = rng.standard_normal(n).astype(np.float32)
    xi = rng.standard_normal(n).astype(np.float32)
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    for s, c in ((2, 4), (4, 2)):
        mesh = make_hier_mesh(s, c)
        for k in (2, 4):
            yr, yi = fft_sharded_hier(xr, xi, mesh=mesh, overlap=k)
            assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > SNR
    mesh = make_hier_mesh(2, 4)
    br, bi = ifft_sharded_hier(
        *fft_sharded_hier(xr, xi, mesh=mesh, overlap=2), mesh=mesh,
        overlap=2)
    assert snr_db(xr + 1j * xi,
                  np.asarray(br) + 1j * np.asarray(bi)) > SNR - 5


def test_hier_overlap_audits(rng):
    """The hierarchical overlap pipeline keeps both machine-checked
    invariants: per-interconnect-tier byte volume unchanged vs the
    sequential hierarchy, and 2K independent collective source chains."""
    import jax
    from kofft_tpu.config import trace_key
    from kofft_tpu.parallel.hier import (_build_fft_hier, _mesh2_key,
                                         make_hier_mesh)
    from kofft_tpu.parallel.validate import (hlo_a2a_bytes_by_group_size,
                                             hlo_a2a_independent_sources)
    mesh = make_hier_mesh(2, 4)
    n = 1 << 14
    base = None
    for k in (1, 2):
        fn, sh = _build_fft_hier(_mesh2_key(mesh), n, 128, 128, "xla",
                                 trace_key(), "float32", k)
        x = jax.device_put(np.zeros(n, np.float32), sh)
        txt = fn.lower(x, x).compile().as_text()
        per = hlo_a2a_bytes_by_group_size(txt)
        dep = hlo_a2a_independent_sources(txt)
        if base is None:
            base = per
            assert dep["independent_sources"] == 2
        else:
            assert per == base                    # volume invariant
            assert dep["total"] == 24             # 2 chunks x 3 x 2 x 2
            assert dep["independent_sources"] == 4


def test_fftn_sharded_hier_overlap_parity(rng):
    """overlap=K on the hierarchical N-D program (restore-only): per
    chunk, the ICI/DCN restore pair inverts the forward pair so the
    concatenated chunks rebuild the input layout exactly."""
    from kofft_tpu.parallel.hier import fftn_sharded_hier, make_hier_mesh
    mesh = make_hier_mesh(2, 4)
    for shape in ((16, 4, 32), (32, 64)):
        ar = rng.standard_normal(shape).astype(np.float32)
        ai = rng.standard_normal(shape).astype(np.float32)
        ref = np.fft.fftn(ar.astype(np.float64) + 1j * ai.astype(np.float64))
        for k in (2,):
            zr, zi = fftn_sharded_hier(ar, ai, mesh=mesh,
                                       restore_layout=True, overlap=k)
            assert np.asarray(zr).shape == shape
            assert snr_db(ref, np.asarray(zr) + 1j * np.asarray(zi)) > SNR
    from kofft_tpu.errors import InvalidValueError
    x2 = np.zeros((16, 16), np.float32)
    with pytest.raises(InvalidValueError):     # overlap without restore
        fftn_sharded_hier(x2, x2, mesh=mesh, overlap=2)


def test_calibrate_scan_down_with_forced_win(mesh, monkeypatch):
    """Deterministic calibration coverage: when sharding 'wins' at the
    probe (forced via an instant fake), the probe scans DOWN to find the
    smallest winning size and apply=True persists points-per-chip."""
    from kofft_tpu.config import get_config, set_shard_threshold
    import importlib
    from kofft_tpu.parallel import auto as A
    FS = importlib.import_module("kofft_tpu.parallel.fft_sharded")
    monkeypatch.setattr(FS, "fft_sharded",
                        lambda a, b, **kw: (a, b))    # instant 'winner'
    try:
        out = A.calibrate_shard_threshold(probe_points=1 << 13,
                                          apply=True)
        assert isinstance(out, int) and out > 0
        d = A._usable_devices()
        assert out <= (1 << 13) // d           # scanned at/below probe
        assert get_config().shard_threshold == out
    finally:
        set_shard_threshold(None)


def test_calibrate_single_device_returns_current(monkeypatch):
    from kofft_tpu.config import get_config
    from kofft_tpu.parallel import auto as A
    monkeypatch.setattr(A, "_usable_devices", lambda: 1)
    cur = get_config().shard_threshold
    assert A.calibrate_shard_threshold(probe_points=1 << 12) == cur


def test_calibrate_unprobeable_size_keeps_current(mesh, monkeypatch):
    """_split_for_mesh -> None (size not factorable over the mesh):
    the probe leaves the threshold untouched."""
    from kofft_tpu.config import get_config
    import importlib
    from kofft_tpu.parallel import auto as A
    FS = importlib.import_module("kofft_tpu.parallel.fft_sharded")
    monkeypatch.setattr(FS, "_split_for_mesh", lambda n, d: None)
    cur = get_config().shard_threshold
    assert A.calibrate_shard_threshold(probe_points=1 << 12) == cur


def test_stft_auto_falls_through_on_small_or_indivisible(rng, mesh):
    """Signals that don't meet the halo/divisibility preconditions take
    the single-chip path regardless of the threshold."""
    import kofft_tpu as kt
    from kofft_tpu.ops import window as W
    from kofft_tpu.parallel.auto import stft_auto
    x = rng.standard_normal(40).astype(np.float32)  # 40 % (8*4) != 0
    w = np.asarray(W.hann(8))
    yr, yi = stft_auto(x, w, hop=4)
    rr, ri = kt.stft_split(x, w, hop=4)
    np.testing.assert_allclose(np.asarray(yr), np.asarray(rr), atol=1e-6)
    np.testing.assert_allclose(np.asarray(yi), np.asarray(ri), atol=1e-6)


def test_fft_auto_overlap_chunk_fallback(rng, mesh):
    """fft_auto reduces overlap chunks until they divide both factors
    (config overlap_chunks larger than the divisibility allows)."""
    from kofft_tpu import config as C
    from kofft_tpu.parallel.auto import fft_auto
    from kofft_tpu.ops.dft import snr_db
    n = 1 << 14
    xr = rng.standard_normal(n).astype(np.float32)
    xi = rng.standard_normal(n).astype(np.float32)
    old_thr = C.get_config().shard_threshold
    old_ov = C.get_config().overlap_chunks
    try:
        C.set_shard_threshold(1)               # force the sharded branch
        C.set_overlap_chunks(64)               # force the k //= 2 loop
        yr, yi = fft_auto(xr, xi)
        ref = np.fft.fft((xr + 1j * xi).astype(np.complex128))
        assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > 80.0
    finally:
        C.set_shard_threshold(old_thr if old_thr else None)
        C.set_overlap_chunks(old_ov)


def test_fftn_auto_wires_overlap(rng, mesh, monkeypatch):
    """fftn_auto passes the configured (divisibility-degraded) overlap
    chunking through to fftn_sharded (r3 review: the config docstring
    promises both auto paths pipeline collectives, not just the 1-D one)."""
    from kofft_tpu import config as C
    from kofft_tpu.parallel import auto as A
    seen = {}

    def spy(xr, xi, **kw):
        seen.update(kw)
        from kofft_tpu.parallel.ndfft_sharded import fftn_sharded
        return fftn_sharded(xr, xi, **kw)

    monkeypatch.setattr(A, "fftn_sharded", spy)
    x = (rng.standard_normal((16, 16))
         + 1j * rng.standard_normal((16, 16))).astype(np.complex64)
    ref = np.fft.fft2(x.astype(np.complex128))
    old_ov = C.get_config().overlap_chunks
    try:
        C.set_shard_threshold(1)               # force the sharded branch
        C.set_overlap_chunks(64)               # must degrade: 16 % (8*64)
        yr, yi = A.fftn_auto(np.ascontiguousarray(x.real),
                             np.ascontiguousarray(x.imag))
        assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > SNR
        d = len(jax.devices())
        k = seen.get("overlap")
        assert k is not None and k >= 1 and 16 % (d * k) == 0
        assert seen.get("restore_layout") is True
    finally:
        C.set_shard_threshold(None)
        C.set_overlap_chunks(old_ov)


def test_fft_sharded_hier_rejects_nondividing_n1():
    """A user n1 that does not divide n must fail eagerly with the typed
    error, not an opaque reshape error inside shard_map (r3 review; the
    flat fft_sharded has had this check since r2)."""
    from kofft_tpu.errors import InvalidValueError
    from kofft_tpu.parallel.hier import fft_sharded_hier, make_hier_mesh
    n = 1092
    x = np.zeros(n, np.float32)
    with pytest.raises(InvalidValueError):
        fft_sharded_hier(x, x, mesh=make_hier_mesh(2, 2), n1=16)


def test_calibrate_scan_up_reaches_max_points(mesh, monkeypatch):
    """The upward scan walks the full octave ladder to max_points (r3
    review: a hard 4-iteration cap stopped at probe*16, contradicting
    the docstring): a win found 5 octaves above the probe is applied.

    Timing is faked with a simulated perf_counter clock the fakes
    advance, not real sleeps — sleep-based fakes proved flaky when the
    suite shares the machine with a chip benchmark (a loaded scheduler
    can stretch a 2 ms sleep past the loser's 4 ms)."""
    import importlib
    import time as _time
    from kofft_tpu.config import get_config, set_shard_threshold
    from kofft_tpu.parallel import auto as A
    FS = importlib.import_module("kofft_tpu.parallel.fft_sharded")
    win_at = 1 << 17                               # probe 1<<12 + 5 octaves
    clock = [0.0]

    def fake_sharded(a, b, **kw):
        clock[0] += 4.0 if a.shape[0] < win_at else 1.0
        return a, b

    def fake_local(a, b, **kw):
        clock[0] += 2.0                            # local path: constant
        return a, b

    monkeypatch.setattr(_time, "perf_counter", lambda: clock[0])
    monkeypatch.setattr(FS, "fft_sharded", fake_sharded)
    import kofft_tpu.ops.fft as OF
    monkeypatch.setattr(OF, "fft_split", fake_local)
    try:
        out = A.calibrate_shard_threshold(probe_points=1 << 12, apply=True,
                                          max_points=1 << 18)
        d = A._usable_devices()
        assert out == win_at // d                  # found BEYOND 4 octaves
        assert get_config().shard_threshold == out
    finally:
        set_shard_threshold(None)


def test_stft_sharded_hier_matches_single(rng):
    """Hierarchical (slice, chip) STFT parity vs the single-chip engine,
    on a (2, 4) virtual mesh (SURVEY §5.8; VERDICT r3 missing #2)."""
    from kofft_tpu.parallel import stft_sharded_hier
    from kofft_tpu.parallel.hier import make_hier_mesh
    h = make_hier_mesh(2, 4)
    n, win, hop = 8 * 64, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    fr, fi = stft_sharded_hier(x, w, hop, mesh=h)
    got = np.asarray(fr) + 1j * np.asarray(fi)
    ref = np.asarray(S.stft(x, w, hop))
    assert got.shape == ref.shape
    assert snr_db(ref, got) > SNR


def test_istft_sharded_hier_matches_single(rng):
    from kofft_tpu.parallel import istft_sharded_hier
    from kofft_tpu.parallel.hier import make_hier_mesh
    h = make_hier_mesh(2, 4)
    n, win, hop = 8 * 64, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    frames = np.asarray(S.stft(x, w, hop))
    nf = frames.shape[0]
    offline = np.asarray(S.istft(frames, w, hop,
                                 length=(nf - 1) * hop + win))
    out = np.asarray(istft_sharded_hier(
        np.ascontiguousarray(frames.real),
        np.ascontiguousarray(frames.imag), w, hop, mesh=h))
    assert out.shape == (nf * hop,)
    assert snr_db(offline[: nf * hop], out) > SNR


def test_stft_istft_hier_roundtrip(rng):
    from kofft_tpu.parallel import istft_sharded_hier, stft_sharded_hier
    from kofft_tpu.parallel.hier import make_hier_mesh
    h = make_hier_mesh(4, 2)          # the other factorization too
    n, win, hop = 8 * 128, 128, 32
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    fr, fi = stft_sharded_hier(x, w, hop, mesh=h)
    out = np.asarray(istft_sharded_hier(fr, fi, w, hop, mesh=h))
    assert snr_db(x[win:n - win], out[win:n - win]) > SNR


def test_stft_hier_halo_bytes_by_tier(rng):
    """The halo's tier split is a checked property: the compiled
    hierarchical STFT's collective-permutes move halo bytes over
    s*(c-1) intra-slice pairs (ICI) and exactly s-1 slice-boundary
    pairs (DCN) — each boundary halo crosses the DCN once, nothing
    else rides it."""
    import jax
    from kofft_tpu.config import trace_key
    from kofft_tpu.ops.stft import _window_key, _window_const
    from kofft_tpu.parallel.hier import make_hier_mesh, _mesh2_key
    from kofft_tpu.parallel.stft_sharded import _build_stft_hier
    from kofft_tpu.parallel.validate import hlo_ppermute_bytes_by_tier

    s, c = 2, 4
    h = make_hier_mesh(s, c)
    win, hop = 64, 16
    halo = win - hop
    w = _window_const(W.hann(win))
    n_local = 8 * hop
    fn, sh = _build_stft_hier(_mesh2_key(h), n_local, win, hop,
                              _window_key(w), "xla", trace_key())
    x = jax.device_put(np.zeros(8 * n_local, np.float32), sh)
    txt = fn.lower(x).compile().as_text()
    per = hlo_ppermute_bytes_by_tier(txt, chips_per_slice=c)
    assert per == {"ici": s * (c - 1) * halo * 4,
                   "dcn": (s - 1) * halo * 4}, per


_WRAPPED_A2A = """
%wrapped_all_to_all_computation (param_0: f32[16,16]) -> f32[16,16] {
  %param_0 = f32[16,16]{1,0} parameter(0)
  ROOT %wrapped_all_to_all = f32[16,16]{1,0} all-to-all(%param_0), replica_groups={{0,1,2,3}}, dimensions={0}
}

ENTRY %main (p0: f32[16,16], p1: f32[16,16]) -> f32[16,16] {
  %p0 = f32[16,16]{1,0} parameter(0)
  %p1 = f32[16,16]{1,0} parameter(1)
  %all-to-all-start = ((f32[16,16]{1,0}), f32[16,16]{1,0}) async-start(%p0), calls=%wrapped_all_to_all_computation
  %all-to-all-done = f32[16,16]{1,0} async-done(%all-to-all-start)
  %add = f32[16,16]{1,0} add(%all-to-all-done, %p1)
  %all-to-all-start.1 = ((f32[16,16]{1,0}), f32[16,16]{1,0}) async-start(%add), calls=%wrapped_all_to_all_computation
  ROOT %all-to-all-done.1 = f32[16,16]{1,0} async-done(%all-to-all-start.1)
}
"""


@pytest.mark.parametrize("case", ["bytes", "groups", "sources"])
def test_hlo_audits_read_async_wrapped_all_to_all(case):
    """GPU modules may wrap a synchronous all-to-all in an async
    computation under another name; the audits read the opcode, count
    the wrapped op once per async-start that calls it, and treat the
    async-start as the collective in the dependency graph."""
    from kofft_tpu.parallel import validate as V
    if case == "bytes":
        assert V.hlo_all_to_all_local_bytes(_WRAPPED_A2A) == 2 * 16 * 16 * 4
    elif case == "groups":
        assert V.hlo_a2a_bytes_by_group_size(_WRAPPED_A2A) == {
            4: 2 * 16 * 16 * 4}
    else:
        # the second start depends on the first: one independent source
        assert V.hlo_a2a_independent_sources(_WRAPPED_A2A) == {
            "total": 2, "independent_sources": 1}
