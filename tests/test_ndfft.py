"""N-D FFT parity (reference ndfft.rs proptest roundtrips, ndfft.rs:311-357)."""

import numpy as np
import pytest

from kofft_tpu.ops import ndfft
from kofft_tpu.ops.dft import snr_db

SNR = 95.0


def _rc(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("shape", [(8, 8), (16, 32), (4, 100), (30, 7)])
def test_fft2_matches_numpy(rng, shape):
    x = _rc(rng, shape)
    got = np.asarray(ndfft.fft2(x))
    ref = np.fft.fft2(x.astype(np.complex128))
    assert snr_db(ref, got) > SNR


@pytest.mark.parametrize("shape", [(4, 8, 16), (8, 8, 8), (3, 5, 7)])
def test_fft3_matches_numpy(rng, shape):
    x = _rc(rng, shape)
    got = np.asarray(ndfft.fft3(x))
    ref = np.fft.fftn(x.astype(np.complex128))
    assert snr_db(ref, got) > SNR


def test_fftn_axes_subset(rng):
    x = _rc(rng, (4, 8, 16))
    got = np.asarray(ndfft.fftn(x, axes=(0, 2)))
    ref = np.fft.fftn(x.astype(np.complex128), axes=(0, 2))
    assert snr_db(ref, got) > SNR


@pytest.mark.parametrize("shape", [(8, 8), (4, 8, 16)])
def test_ifftn_roundtrip(rng, shape):
    x = _rc(rng, shape)
    back = np.asarray(ndfft.ifftn(ndfft.fftn(x)))
    assert snr_db(x, back) > SNR


def test_fft2_batched(rng):
    x = _rc(rng, (3, 8, 16))
    got = np.asarray(ndfft.fft2(x))
    ref = np.fft.fft2(x.astype(np.complex128), axes=(-2, -1))
    assert snr_db(ref, got) > SNR


def test_real_input(rng):
    x = rng.standard_normal((8, 8)).astype(np.float32)
    got = np.asarray(ndfft.fft2(x))
    ref = np.fft.fft2(x.astype(np.float64))
    assert snr_db(ref, got) > SNR


def test_fftn_split_jnpfft_backend_maps_to_xla(rng):
    """backend='jnpfft' runs XLA's own fftn over the requested axes."""
    xr = rng.standard_normal((4, 64)).astype(np.float32)
    xi = np.zeros_like(xr)
    yr, yi = ndfft.fftn_split(xr, xi, backend="jnpfft")
    ref = np.fft.fftn(xr.astype(np.complex128))
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert snr_db(ref, got) > 80.0


def test_fftn_split_xla_backend_long_axis(rng):
    """backend='xla' on an axis above the small-axes einsum zone takes
    the per-axis _fft_planes branch."""
    xr = rng.standard_normal((4, 512)).astype(np.float32)
    xi = np.zeros_like(xr)
    yr, yi = ndfft.fftn_split(xr, xi, backend="xla", inverse=True)
    ref = np.fft.ifftn(xr.astype(np.complex128), axes=(0, 1))
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert snr_db(ref, got) > 80.0


def test_fftn_host_and_device_complex_input(rng):
    x = (rng.standard_normal((8, 16))
         + 1j * rng.standard_normal((8, 16))).astype(np.complex64)
    ref = np.fft.fftn(x.astype(np.complex128))
    got_host = np.asarray(ndfft.fftn(x))
    assert snr_db(ref, got_host) > 80.0
    import jax.numpy as jnp
    got_dev = np.asarray(ndfft.fftn(jnp.asarray(x)))
    assert snr_db(ref, got_dev) > 80.0


def test_fftn_empty_input_raises():
    from kofft_tpu.errors import EmptyInputError
    with pytest.raises(EmptyInputError):
        ndfft.fftn(np.zeros((0, 4), dtype=np.float32))


def test_fft2_fft3_rank_validation():
    from kofft_tpu.errors import InvalidValueError
    with pytest.raises(InvalidValueError):
        ndfft.fft2(np.zeros(8, dtype=np.float32))
    with pytest.raises(InvalidValueError):
        ndfft.ifft2(np.zeros(8, dtype=np.float32))
    with pytest.raises(InvalidValueError):
        ndfft.fft3(np.zeros((4, 4), dtype=np.float32))
    with pytest.raises(InvalidValueError):
        ndfft.ifft3(np.zeros((4, 4), dtype=np.float32))


def test_rfftn_matches_numpy(rng):
    """numpy rfftn/irfftn convention superset: one-sided last transformed
    axis, complex FFT over the rest, roundtrip restores the signal."""
    import kofft_tpu as kt
    x = rng.standard_normal((6, 10, 16)).astype(np.float32)
    got = np.asarray(kt.rfftn(x))
    assert got.shape == (6, 10, 9)
    assert snr_db(np.fft.rfftn(x.astype(np.float64)), got) > 100.0
    back = np.asarray(kt.irfftn(got, n=16))
    assert snr_db(x.astype(np.float64), back) > 100.0
    # partial axes, non-default order
    got2 = np.asarray(kt.rfftn(x, axes=(2, 0)))
    ref2 = np.fft.rfftn(x.astype(np.float64), axes=(2, 0))
    assert got2.shape == ref2.shape
    assert snr_db(ref2, got2) > 100.0
    back2 = np.asarray(kt.irfftn(got2, n=6, axes=(2, 0)))
    assert snr_db(x.astype(np.float64), back2) > 100.0


def test_rfftn_split_planes(rng):
    import kofft_tpu as kt
    x = rng.standard_normal((4, 32)).astype(np.float32)
    yr, yi = kt.rfftn_split(x)
    ref = np.fft.rfftn(x.astype(np.float64))
    assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > 100.0
    back = kt.irfftn_split(np.asarray(yr), np.asarray(yi), n=32)
    assert snr_db(x.astype(np.float64), np.asarray(back)) > 100.0
    from kofft_tpu.errors import MismatchedLengthsError
    with pytest.raises(MismatchedLengthsError):
        kt.irfftn_split(np.zeros((4, 17), np.float32),
                        np.zeros((3, 17), np.float32))


def test_rfftn_empty_axes_typed_error():
    import kofft_tpu as kt
    from kofft_tpu.errors import InvalidValueError
    with pytest.raises(InvalidValueError):
        kt.rfftn(np.zeros((4, 4), np.float32), axes=())
    with pytest.raises(InvalidValueError):
        kt.irfftn(np.zeros((4, 3), np.complex64), axes=())


def test_rfftn_complex_input_rejected(rng):
    """Complex input raises the same typed error on BOTH the host and
    device entry (matching rfft's _prep_real; previously a complex
    jax.Array slipped through to the engine while host input was
    silently real-stripped)."""
    import jax.numpy as jnp
    import kofft_tpu as kt
    from kofft_tpu.errors import InvalidValueError

    z_host = _rc(rng, (8, 16))
    with pytest.raises(InvalidValueError):
        kt.rfftn(z_host)
    z_dev = jnp.asarray(rng.standard_normal((8, 16)).astype(np.float32)) \
        + 1j * jnp.asarray(rng.standard_normal((8, 16)).astype(np.float32))
    with pytest.raises(InvalidValueError):
        kt.rfftn(z_dev)
    with pytest.raises(InvalidValueError):
        kt.rfftn_split(z_dev)
