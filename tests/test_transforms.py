"""DCT/DST/DHT/Hilbert/CZT/Goertzel/cepstrum parity vs float64 oracles
built from the reference's own formulas."""

import numpy as np
import pytest

from kofft_tpu.ops import (cepstrum, czt, dct, dst, goertzel, hartley,
                           hilbert)
from kofft_tpu.ops.dft import snr_db

SNR = 90.0


# ---------------------------------------------------------------- oracles
def ref_dct(x, kind):
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    if kind == 1:
        if n == 1:
            return 2.0 * x
        m = 2 * np.cos(np.pi * i * k / (n - 1))
        m[0] = 1.0
        m[-1] = (-1.0) ** np.arange(n)
        return x @ m
    if kind == 2:
        return x @ np.cos(np.pi * (i + .5) * k / n)
    if kind == 3:
        m = np.cos(np.pi * i * (k + .5) / n)
        m[0] = 0.5
        return x @ m
    return x @ np.cos(np.pi * (i + .5) * (k + .5) / n)


def ref_dst(x, kind):
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    if kind == 1:
        return x @ np.sin(np.pi * (i + 1) * (k + 1) / (n + 1))
    if kind == 2:
        return x @ np.sin(np.pi * (i + .5) * (k + 1) / n)
    if kind == 3:
        m = np.sin(np.pi * (k + .5) * i / n)
        m[0] = 0.5
        return x @ m
    return x @ np.sin(np.pi * (i + .5) * (k + .5) / n)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("kind", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 8, 64, 256, 1000])
def test_dct_parity(rng, kind, n):
    if kind == 1 and n == 1:
        x = rng.standard_normal((2, 1)).astype(np.float32)
        np.testing.assert_allclose(np.asarray(dct.dct(x, kind)), 2 * x,
                                   rtol=1e-6)
        return
    x = rng.standard_normal((2, n)).astype(np.float32)
    assert snr_db(ref_dct(x, kind), np.asarray(dct.dct(x, kind))) > SNR


@pytest.mark.parametrize("kind", [2, 3, 4])
def test_idct_roundtrip(rng, kind):
    x = rng.standard_normal((2, 64)).astype(np.float32)
    back = np.asarray(dct.idct(dct.dct(x, kind), kind))
    assert snr_db(x, back) > SNR


def test_idct1_roundtrip(rng):
    x = rng.standard_normal(64).astype(np.float32)
    back = np.asarray(dct.idct(dct.dct1(x), 1))
    assert snr_db(x, back) > SNR


@pytest.mark.parametrize("kind", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [2, 8, 64, 256, 1000])
def test_dst_parity(rng, kind, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    assert snr_db(ref_dst(x, kind), np.asarray(dst.dst(x, kind))) > SNR


@pytest.mark.parametrize("n", [4, 16, 128, 1000, 31])
def test_dht_parity(rng, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    cas = np.cos(2 * np.pi * i * k / n) + np.sin(2 * np.pi * i * k / n)
    ref = x.astype(np.float64) @ cas
    assert snr_db(ref, np.asarray(hartley.dht(x))) > SNR


def test_dht_involution(rng):
    """DHT(DHT(x)) == n * x."""
    n = 256
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(hartley.dht(hartley.dht(x)))
    assert snr_db(x, y / n) > SNR


@pytest.mark.parametrize("n", [8, 64, 256, 100, 31])
def test_hilbert_analytic(rng, n):
    from scipy_free_ref import analytic_ref
    x = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(hilbert.hilbert_analytic(x))
    ref = analytic_ref(x)
    assert snr_db(ref, got) > SNR
    # real part of the analytic signal is the original signal
    assert snr_db(x, got.real) > SNR


def test_czt_matches_dft(rng):
    """CZT with w = exp(-2*pi*i/m), a = 1, m = n reduces to the DFT."""
    n = 64
    x = rng.standard_normal(n).astype(np.float32)
    w = np.exp(-2j * np.pi / n)
    got = np.asarray(czt.czt(x, n, w))
    ref = np.fft.fft(x.astype(np.float64))
    assert snr_db(ref, got) > SNR


def test_czt_fast_matches_czt(rng):
    n, m = 100, 60
    x = rng.standard_normal(n).astype(np.float32)
    w = np.exp(-2j * np.pi * 0.8 / m)
    a = np.exp(1j * 0.3)
    slow = np.asarray(czt.czt(x, m, w, a))
    fast = np.asarray(czt.czt_fast(x, m, w, a))
    assert snr_db(slow, fast) > SNR - 10


def test_czt_nonunit_w(rng):
    """General (non-unit-modulus) w against a float64 direct evaluation."""
    n, m = 16, 10
    x = rng.standard_normal(n).astype(np.float32)
    w, a = 1.02 * np.exp(-0.5j), 0.9 + 0.1j
    i = np.arange(n)[:, None]
    k = np.arange(m)[None, :]
    ref = (x.astype(np.complex128)[None, :] @
           (a ** (-i) * w ** (i * k))).ravel()
    got = np.asarray(czt.czt(x, m, w, a))
    assert snr_db(ref, got) > SNR


def test_goertzel_detects_tone(rng):
    sr, f, n = 8000.0, 1000.0, 256
    t = np.arange(n) / sr
    x = np.sin(2 * np.pi * f * t).astype(np.float32)
    mag_on = float(np.asarray(goertzel.goertzel(x, sr, f)))
    mag_off = float(np.asarray(goertzel.goertzel(x, sr, 1703.0)))
    assert mag_on > 10 * mag_off
    # matches |X_k| of the DFT at the floor-selected bin
    k = int(np.floor(f * n / sr))
    ref = abs(np.fft.fft(x.astype(np.float64))[k])
    assert mag_on == pytest.approx(ref, rel=1e-3)
    # scan variant agrees with dot variant
    scan = float(np.asarray(goertzel.goertzel_scan(x, sr, f)))
    assert scan == pytest.approx(mag_on, rel=1e-3)


def test_goertzel_bins_batch(rng):
    x = rng.standard_normal((3, 128)).astype(np.float32)
    out = np.asarray(goertzel.goertzel_bins(x, [3, 17, 40]))
    ref = np.abs(np.fft.fft(x.astype(np.float64)))[:, [3, 17, 40]]
    assert snr_db(ref, out) > SNR


def test_real_cepstrum(rng):
    n = 256
    x = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(cepstrum.real_cepstrum(x))
    f = np.fft.fft(x.astype(np.float64))
    ref = np.fft.ifft(np.log(np.abs(f) + 1e-12)).real
    assert snr_db(ref, got) > SNR


def test_mel_mfcc(rng):
    n_mags, sr, n_mel = 257, 16000.0, 26
    mags = np.abs(rng.standard_normal(n_mags)).astype(np.float32)
    mel = np.asarray(cepstrum.mel_filterbank(mags, sr, n_mel))
    assert mel.shape == (n_mel,)
    assert np.all(mel >= 0)
    co = np.asarray(cepstrum.mfcc(mags, sr, n_mel, 13))
    assert co.shape == (13,)
    # mfcc = dct2(log(mel + 1e-12)) truncated
    from kofft_tpu.ops.dct import dct2
    ref = np.asarray(dct2(np.log(mel + 1e-12).astype(np.float32)))[:13]
    np.testing.assert_allclose(co, ref, rtol=1e-4, atol=1e-4)


def test_mfcc_too_many_coeffs_raises():
    import kofft_tpu as kt
    with pytest.raises(kt.KofftError):
        cepstrum.mfcc(np.ones(64, np.float32), 8000.0, 10, 11)


# ---------------------------------------------------------------------------
# FFT-composed large-n fast paths (ops/_trig.py) vs the matrix oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [384, 777, 1024])
def test_fast_dct_matches_matrix(rng, kind, n):
    """The O(n log n) route must reproduce the cosine-matrix transform
    (reference conventions) for smooth, rough (Bluestein) and pow2 n."""
    from kofft_tpu.ops import dct as D
    x = rng.standard_normal((3, n)).astype(np.float32)
    want = np.asarray(D.dct(x, type=kind))
    old = D.FAST_CUTOFF
    D.FAST_CUTOFF = 16            # force the FFT-composed route
    try:
        got = np.asarray(D.dct(x, type=kind))
    finally:
        D.FAST_CUTOFF = old
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 2e-4 * max(scale, 1.0)


@pytest.mark.parametrize("kind", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [384, 777, 1024])
def test_fast_dst_matches_matrix(rng, kind, n):
    from kofft_tpu.ops import dst as S
    x = rng.standard_normal((3, n)).astype(np.float32)
    want = np.asarray(S.dst(x, type=kind))
    old = S.FAST_CUTOFF
    S.FAST_CUTOFF = 16
    try:
        got = np.asarray(S.dst(x, type=kind))
    finally:
        S.FAST_CUTOFF = old
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 2e-4 * max(scale, 1.0)


def test_large_dct_runs_without_matrix(rng):
    """Above the cutoff no n^2 table is built — a 2^15-point DCT-II would
    need a 4 GB matrix; the fast path must handle it."""
    from kofft_tpu.ops import dct as D
    n = 1 << 15
    x = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(D.dct(x, type=2))
    assert got.shape == (n,)
    # spot-check one analytic value: DCT-II of ones at k=0 is n
    ones = np.ones(n, np.float32)
    g0 = np.asarray(D.dct(ones, type=2))
    assert abs(g0[0] - n) < 1e-2 * n
    assert np.abs(g0[1:]).max() < 0.2   # all other bins ~0


def test_public_alias_surface(rng):
    """Every public alias works standalone (kind-dispatch entry points
    are covered elsewhere; this pins the aliases users import)."""
    import kofft_tpu as kt
    x = rng.standard_normal(32).astype(np.float32)
    for fn, kind in ((kt.dct1, 1), (kt.dct2, 2), (kt.dct3, 3),
                     (kt.dct4, 4)):
        assert snr_db(ref_dct(x, kind), np.asarray(fn(x))) > 90.0
    for fn, kind in ((kt.dst1, 1), (kt.dst2, 2), (kt.dst3, 3),
                     (kt.dst4, 4)):
        assert snr_db(ref_dst(x, kind), np.asarray(fn(x))) > 90.0


def test_istft_split_roundtrip_and_error_names(rng, tmp_path, monkeypatch):
    import kofft_tpu as kt
    from kofft_tpu.ops import window as W
    n, win, hop = 1 << 12, 256, 64
    x = rng.standard_normal(n).astype(np.float32)
    w = np.asarray(W.hann(win))
    fr, fi = kt.stft_split(x, w, hop)
    y = kt.istft_split(np.asarray(fr), np.asarray(fi), w, hop, length=n)
    # interior only: the first/last window of a hann OLA is edge-tapered
    assert snr_db(x[win:-win].astype(np.float64),
                  np.asarray(y)[win:-win]) > 50.0
    with pytest.raises(kt.InvalidHopSizeError):
        kt.stft_split(x, w, 0)
    with pytest.raises(kt.InvalidStrideError):
        kt.fft_strided_split(np.zeros(16, np.float32),
                             np.zeros(16, np.float32), stride=0)
    # compilation-cache helper smoke (config flag set + idempotent)
    import jax as _jax
    prev = _jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        for _ in range(2):
            got = kt.enable_compilation_cache(tmp_path / "cc")
            assert got == str(tmp_path / "cc")
            assert _jax.config.jax_compilation_cache_dir == got
    finally:
        _jax.config.update("jax_compilation_cache_dir", prev)


def test_dht_batch_and_multi_channel_aliases(rng):
    from kofft_tpu.ops.hartley import dht, dht_batch, dht_multi_channel
    x = rng.standard_normal((3, 32)).astype(np.float32)
    base = np.asarray(dht(x))
    assert np.allclose(np.asarray(dht_batch(x)), base)
    assert np.allclose(np.asarray(dht_multi_channel(x)), base)


def test_hilbert_public_entries(rng):
    """hilbert() = Im(analytic); hilbert_analytic merges planes."""
    from kofft_tpu.ops.hilbert import (hilbert, hilbert_analytic,
                                       hilbert_analytic_split)
    x = rng.standard_normal(64).astype(np.float32)
    zr, zi = hilbert_analytic_split(x)
    h = np.asarray(hilbert(x))
    assert np.allclose(h, np.asarray(zi), atol=1e-5)
    z = hilbert_analytic(x)
    z = np.asarray(z)
    assert np.allclose(z.real, np.asarray(zr), atol=1e-5)
    # analytic-signal property: negative frequencies vanish
    spec = np.fft.fft(z.astype(np.complex128))
    assert np.max(np.abs(spec[64 // 2 + 1:])) < 1e-2 * np.max(np.abs(spec))
