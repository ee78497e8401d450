"""Card-only checks: the main transforms on an NVIDIA GPU against the
f64 oracle. They skip without a GPU; on the card run
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import numpy as np
import pytest

import kofft_tpu as kt
from kofft_tpu.ops.dft import snr_db

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform is {dev.platform})")
    return dev


def _cplx(shape, dtype=np.complex64):
    rng = np.random.default_rng(0)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("backend", ["auto", "jnpfft"])
def test_fft_on_card(gpu, backend):
    import jax
    x = _cplx((1 << 20,))
    y = kt.fft(jax.device_put(x), backend=backend)
    assert snr_db(np.fft.fft(x.astype(np.complex128)), np.asarray(y)) > 120


def test_precision_tiers_on_card(gpu):
    """'highest' is full FP32 on the card; 'default' runs the tensor
    cores at TF32-class precision (about 65 dB at 2^20)."""
    import jax
    from kofft_tpu.config import set_precision
    x = _cplx((1 << 20,))
    ref = np.fft.fft(x.astype(np.complex128))
    got = {}
    for tier in ("highest", "default"):
        set_precision(tier)
        try:
            got[tier] = snr_db(ref, np.asarray(
                jax.jit(lambda a: kt.fft(a))(jax.device_put(x))))
        finally:
            set_precision(None)
    assert got["highest"] > 120
    assert 50 < got["default"] < 100


def test_above_tree_cap_routes_to_xla_fft_on_card(gpu):
    import jax
    from kofft_tpu.ops.fft import TREE_MAX_POW2
    n = 2 * TREE_MAX_POW2
    x = _cplx((n,))
    fn = jax.jit(lambda a: kt.fft(a))
    assert "dot" not in fn.lower(x).as_text()
    y = np.asarray(fn(jax.device_put(x)))
    assert snr_db(np.fft.fft(x.astype(np.complex128)), y) > 120


def test_f64_round_trip_on_card(gpu):
    import jax
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        x = _cplx((1 << 16,), np.complex128)
        back = np.asarray(kt.ifft(kt.fft(jax.device_put(x))))
        assert snr_db(x, back) > 250
    finally:
        jax.config.update("jax_enable_x64", prev)
