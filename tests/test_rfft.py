"""Real FFT parity (reference tests/rfft_arch_parity.rs, rfft_dispatch.rs)."""

import numpy as np
import pytest

import kofft_tpu as kt
from kofft_tpu.ops.dft import snr_db

SNR = 100.0


@pytest.mark.parametrize("n", [2, 4, 8, 16, 64, 256, 1024, 4096,
                               6, 12, 60, 1000, 7, 31, 1009])
def test_rfft_matches_numpy(rng, n):
    x = rng.standard_normal((3, n)).astype(np.float32)
    got = np.asarray(kt.rfft(x))
    ref = np.fft.rfft(x.astype(np.float64))
    assert snr_db(ref, got) > SNR, f"n={n}"


@pytest.mark.parametrize("n", [4, 16, 256, 1024, 1000, 7, 31])
def test_irfft_roundtrip(rng, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    y = kt.rfft(x)
    back = np.asarray(kt.irfft(y, n=n))
    assert snr_db(x, back) > SNR, f"n={n}"


def test_irfft_matches_numpy(rng):
    n = 512
    y = (rng.standard_normal((2, n // 2 + 1))
         + 1j * rng.standard_normal((2, n // 2 + 1))).astype(np.complex64)
    # enforce real-spectrum endpoints like numpy does implicitly
    got = np.asarray(kt.irfft(y, n=n))
    ref = np.fft.irfft(y.astype(np.complex128), n=n)
    assert snr_db(ref, got) > SNR - 10


def test_hermitian_symmetry(rng):
    """One-sided output equals the matching half of the full FFT
    (reference Hermitian checks, src/lib.rs:160-479)."""
    n = 256
    x = rng.standard_normal((n,)).astype(np.float32)
    one = np.asarray(kt.rfft(x))
    full = np.asarray(kt.fft(x.astype(np.complex64)))
    np.testing.assert_allclose(one, full[: n // 2 + 1], rtol=1e-4, atol=1e-3)
    assert abs(one[0].imag) < 1e-4
    assert abs(one[-1].imag) < 1e-4


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_rfft_norms(rng, norm):
    n = 128
    x = rng.standard_normal((n,)).astype(np.float32)
    got = np.asarray(kt.rfft(x, norm=norm))
    ref = np.fft.rfft(x.astype(np.float64), norm=norm)
    assert snr_db(ref, got) > SNR
    back = np.asarray(kt.irfft(got, n=n, norm=norm))
    assert snr_db(x, back) > SNR


def test_rfft_axis_and_pad(rng):
    x = rng.standard_normal((3, 64, 2)).astype(np.float32)
    got = np.asarray(kt.rfft(x, axis=1))
    ref = np.fft.rfft(x.astype(np.float64), axis=1)
    assert snr_db(ref, got) > SNR
    got = np.asarray(kt.rfft(x, n=128, axis=1))
    ref = np.fft.rfft(x.astype(np.float64), n=128, axis=1)
    assert snr_db(ref, got) > SNR


def test_rfft_complex_input_raises(rng):
    with pytest.raises(kt.KofftError):
        kt.rfft(np.zeros(8, np.complex64))


def test_rfft_split_planes(rng):
    n = 512
    x = rng.standard_normal((2, n)).astype(np.float32)
    yr, yi = kt.rfft_split(x)
    ref = np.fft.rfft(x.astype(np.float64))
    assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > SNR
    back = np.asarray(kt.irfft_split(yr, yi, n=n))
    assert snr_db(x, back) > SNR


def test_rfft_truncating_n(rng):
    x = rng.standard_normal(64).astype(np.float32)
    got = np.asarray(kt.rfft(x, n=32))
    ref = np.fft.rfft(x.astype(np.float64), n=32)
    assert snr_db(ref, got) > 80.0


def test_rfft_irfft_under_jit(rng):
    import jax
    x = rng.standard_normal(64).astype(np.float32)

    @jax.jit
    def f(v):
        y = kt.rfft(v)
        return kt.irfft(y, n=64)

    back = np.asarray(f(x))
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-5)


def test_rfft_zone_reroute_parity(rng, monkeypatch):
    """auto backend + a size in the capability zone reroutes to
    jnp.fft.rfft; the cap is lowered so the zone fires at a CPU-sized n.
    The inverse rides the same zone through the engine ladder. Traced
    under a fresh jit so no cached executable hides the route."""
    import jax
    from kofft_tpu.ops import fft as fft_mod
    monkeypatch.setattr(fft_mod, "TREE_MAX_POW2", 2048)
    x = rng.standard_normal((8, 4096)).astype(np.float32)
    fwd = jax.jit(lambda v: kt.rfft_split(v))
    assert "dot_general" not in fwd.lower(x).as_text()
    yr, yi = fwd(x)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert snr_db(ref, got) > 100.0
    back = np.asarray(jax.jit(
        lambda a, b: kt.irfft_split(a, b, n=4096))(yr, yi))
    assert snr_db(x.astype(np.float64), back) > 100.0


def test_irfft_short_spectrum_pads(rng):
    """k < n//2+1 one-sided bins: irfft zero-pads the spectrum
    (reference treats missing high bins as zero)."""
    x = rng.standard_normal(64).astype(np.float32)
    y = np.asarray(kt.rfft(x))
    got = np.asarray(kt.irfft(y[:20], n=64))
    full = np.zeros(33, dtype=np.complex128)
    full[:20] = y[:20]
    ref = np.fft.irfft(full, n=64)
    assert snr_db(ref, got) > 80.0


def test_irfft_long_spectrum_truncates(rng):
    x = rng.standard_normal(64).astype(np.float32)
    y = np.asarray(kt.rfft(x))
    got = np.asarray(kt.irfft(y, n=32))
    ref = np.fft.irfft(y[:17].astype(np.complex128), n=32)
    assert snr_db(ref, got) > 80.0


def test_irfft_nondefault_axis(rng):
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = np.asarray(kt.rfft(x, axis=0))
    back = np.asarray(kt.irfft(y, n=16, axis=0))
    assert snr_db(x.astype(np.float64), back) > 80.0
