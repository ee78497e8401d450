"""f64 / complex128 tier (VERDICT r1 item 4).

The reference is generic over f32/f64 (``src/num.rs:5-29``; f64 AVX
Stockham at ``src/fft.rs:914-1052``). Here the f64 tier rides the XLA
backend on CPU/GPU: when JAX's x64 mode is on (``config.x64_active``),
f64/complex128 inputs flow through the engine end-to-end — f64 twiddle
tables, f64 matmuls, complex128 outputs. With x64 off, f64 downcasts to
f32 (the documented contract).

The reference's accuracy bar for f64 is ~1e-12 relative; these tests
assert >= 250 dB SNR round trips, far beyond anything f32 can reach
(f32 tops out near 140 dB), so they genuinely prove the f64 path ran.
"""

import numpy as np
import pytest

import jax

import kofft_tpu as kt
from kofft_tpu.ops.dft import snr_db


@pytest.fixture()
def x64():
    """Enable JAX x64 for the duration of one test."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_x64_active_reports_cpu(x64):
    from kofft_tpu.config import x64_active
    assert x64_active()


def test_fft_f64_matches_numpy(x64, rng):
    x = (rng.standard_normal((4, 1024))
         + 1j * rng.standard_normal((4, 1024)))
    y = kt.fft(x)
    assert np.asarray(y).dtype == np.complex128
    assert snr_db(np.fft.fft(x), np.asarray(y)) > 250.0


def test_fft_ifft_f64_roundtrip(x64, rng):
    x = (rng.standard_normal((2, 4096))
         + 1j * rng.standard_normal((2, 4096)))
    back = np.asarray(kt.ifft(kt.fft(x)))
    assert snr_db(x, back) > 250.0


def test_fft_f64_nonpow2_bluestein(x64, rng):
    # 1000 = 2^3 * 5^3 smooth; 1009 prime -> Bluestein, both in f64
    for n in (1000, 1009):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        y = np.asarray(kt.fft(x))
        assert snr_db(np.fft.fft(x), y) > 250.0, n


def test_rfft_irfft_f64_roundtrip(x64, rng):
    x = rng.standard_normal((3, 2048))
    y = kt.rfft(x)
    assert np.asarray(y).dtype == np.complex128
    assert snr_db(np.fft.rfft(x), np.asarray(y)) > 250.0
    back = np.asarray(kt.irfft(y, n=2048))
    assert back.dtype == np.float64
    assert snr_db(x, back) > 250.0


def test_dct_f64_roundtrip(x64, rng):
    x = rng.standard_normal((2, 512))
    y = kt.dct(x, type=2)
    assert np.asarray(y).dtype == np.float64
    back = np.asarray(kt.idct(y, type=2))
    assert snr_db(x, back) > 250.0


def test_stft_istft_f64_roundtrip(x64, rng):
    from kofft_tpu.ops.window import hann
    x = rng.standard_normal(8192)
    w = hann(512, dtype="float64")
    frames = kt.stft(x, w, hop=256)
    assert np.asarray(frames).dtype == np.complex128
    back = np.asarray(kt.istft(frames, w, hop=256, length=8192))
    assert back.dtype == np.float64
    # edge samples are not COLA-covered (hann tapers to 0); compare the
    # interior, as the reference roundtrip tests do
    assert snr_db(x[512:-512], back[512:-512]) > 250.0


def test_f64_downcast_without_x64(rng):
    """x64 off: f64 inputs keep the documented downcast-to-f32 contract."""
    x = rng.standard_normal((2, 256)).astype(np.float64)
    y = np.asarray(kt.rfft(x))
    assert y.dtype == np.complex64
    assert snr_db(np.fft.rfft(x), y) > 100.0


def test_fftn_f64_roundtrip(x64, rng):
    x = (rng.standard_normal((32, 32))
         + 1j * rng.standard_normal((32, 32)))
    y = kt.fftn(x)
    assert np.asarray(y).dtype == np.complex128
    assert snr_db(np.fft.fftn(x), np.asarray(y)) > 250.0
    back = np.asarray(kt.ifftn(y))
    assert snr_db(x, back) > 250.0


def test_secondary_transforms_accept_f64(x64, rng):
    """dst/dht/hilbert/czt keep f64 inputs under x64 (the shared
    host_float rule); czt threads f64 into its chirp constants."""
    x = rng.standard_normal(256)
    assert np.asarray(kt.dst(x, type=2)).dtype == np.float64
    assert np.asarray(kt.dht(x)).dtype == np.float64
    from kofft_tpu.ops.czt import czt_split
    yr, yi = czt_split(x, 64, w=np.exp(-2j * np.pi / 256))
    assert np.asarray(yr).dtype == np.float64
    zs = np.asarray(kt.hilbert_analytic(x))
    assert zs.dtype == np.complex128


def test_istft_stream_scan_mixed_dtype_carry(x64, rng):
    """f64 frame planes + f32 window must not change the scan carry dtype
    across steps (ADVICE r2 item 1): the planes and window are promoted
    to a common dtype before the scan, so this computes instead of
    raising a lax.scan carry-type mismatch."""
    from kofft_tpu.ops import stft as S
    from kofft_tpu.ops import window as W
    win, hop, nf = 64, 16, 8
    x = rng.standard_normal(nf * hop).astype(np.float64)
    w32 = np.asarray(W.hann(win), dtype=np.float32)
    frames = np.asarray(S.stft(x, w32.astype(np.float64), hop))[:nf]
    fr = np.ascontiguousarray(frames.real)          # float64 planes
    fi = np.ascontiguousarray(frames.imag)
    out = np.asarray(S.istft_stream_scan(fr, fi, w32, hop))
    assert out.dtype == np.float64                  # promoted, not crashed
    ref = np.asarray(S.istft(frames, w32.astype(np.float64), hop,
                             length=nf * hop))
    assert snr_db(ref, out[: nf * hop]) > 90.0


def test_sharded_transforms_f64(x64, rng):
    """The f64 tier extends to the distributed programs (r3): f64 inputs
    flow through f64 twiddle tables and f64 local DFTs on the mesh —
    >= 250 dB proves the f64 path ran (f32 tops out near 140)."""
    from kofft_tpu.parallel import fft_sharded, fftn_sharded, make_mesh
    from kofft_tpu.parallel.hier import fft_sharded_hier, make_hier_mesh
    mesh = make_mesh(8, "d")
    n = 1 << 12
    xr = rng.standard_normal(n)                  # float64
    xi = rng.standard_normal(n)
    ref = np.fft.fft(xr + 1j * xi)
    yr, yi = fft_sharded(xr, xi, mesh=mesh, restore_layout=True)
    assert np.asarray(yr).dtype == np.float64
    assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > 250.0
    yr, yi = fft_sharded(xr, xi, mesh=mesh, restore_layout=True, overlap=2)
    assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > 250.0
    hr, hi = fft_sharded_hier(xr, xi, mesh=make_hier_mesh(2, 4))
    assert snr_db(ref, np.asarray(hr) + 1j * np.asarray(hi)) > 250.0
    a = rng.standard_normal((16, 32))
    b = rng.standard_normal((16, 32))
    zr, zi = fftn_sharded(a, b, mesh=mesh, restore_layout=True)
    assert snr_db(np.fft.fftn(a + 1j * b),
                  np.asarray(zr) + 1j * np.asarray(zi)) > 250.0


def test_rfftn_and_tiled_f64(x64, rng):
    """The f64 tier extends to the r3 additions: rfftn (composed real +
    complex N-D) and the tiled pipeline entries."""
    import kofft_tpu as kt
    x = rng.standard_normal((4, 8, 16))             # float64
    got = np.asarray(kt.rfftn(x))
    assert got.dtype == np.complex128
    assert snr_db(np.fft.rfftn(x), got) > 250.0
    back = np.asarray(kt.irfftn(got, n=16))
    assert back.dtype == np.float64
    assert snr_db(x, back) > 250.0

    m, _ = kt.tiled_shape(1 << 14)
    a = rng.standard_normal((m, m))
    b = rng.standard_normal((m, m))
    yr, yi = kt.fft_split_tiled(a, b)
    assert np.asarray(yr).dtype == np.float64
    ref = np.fft.fft((a + 1j * b).reshape(m * m))
    assert snr_db(ref, (np.asarray(yr) + 1j * np.asarray(yi)
                        ).reshape(m * m)) > 250.0
    br, bi = kt.ifft_split_tiled(np.asarray(yr), np.asarray(yi))
    assert snr_db(a + 1j * b,
                  np.asarray(br) + 1j * np.asarray(bi)) > 250.0
