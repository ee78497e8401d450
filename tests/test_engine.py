"""The XLA engine at the sizes it serves, against the f64 oracle.

Covers the shape classes the public transforms route to the matmul
four-step (pow2 and odd*2^k sizes, real input, batched rows, bf16
planes), the tiled pipeline entries, gradients and forward-mode
derivatives through them, and the capability rule that sends pow2 n
above the factor-tree cap to XLA's own FFT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import kofft_tpu as kt
from kofft_tpu.ops import fft as fft_mod
from kofft_tpu.ops.dft import snr_db

F32_SNR = 100.0


def _planes(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _c(yr, yi):
    return np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)


@pytest.mark.parametrize("n", [1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18,
                               3 << 14, 5 << 12, 3 << 16, 9 << 11, 15 << 12])
def test_xla_engine_parity(rng, n):
    xr, xi = _planes(rng, (n,))
    yr, yi = kt.fft_split(xr, xi)
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi)
    assert snr_db(ref, _c(yr, yi)) > F32_SNR
    br, bi = kt.ifft_split(yr, yi)
    assert snr_db(xr + 1j * xi.astype(np.float64), _c(br, bi)) > F32_SNR


@pytest.mark.parametrize("n", [1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18])
def test_xla_engine_rfft_parity(rng, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    y = np.asarray(kt.rfft(x))
    assert y.shape == (2, n // 2 + 1)
    assert snr_db(np.fft.rfft(x.astype(np.float64)), y) > F32_SNR
    back = np.asarray(kt.irfft(y, n=n))
    assert snr_db(x.astype(np.float64), back) > F32_SNR


@pytest.mark.parametrize("shape", [(8, 1 << 14), (2, 4, 1 << 15),
                                   (6, 1 << 16)])
def test_xla_engine_batched_parity(rng, shape):
    xr, xi = _planes(rng, shape)
    y = np.asarray(kt.fft(jnp.asarray(xr + 1j * xi)))
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1)
    assert snr_db(ref, y) > F32_SNR


@pytest.mark.parametrize("shape", [(1 << 14,), (1 << 16,), (4, 1 << 15)])
def test_xla_engine_bf16_planes(rng, shape):
    """bf16 planes in, bf16 planes out: the engine computes in f32 and
    rounds back, so the result carries bf16's ~8-bit mantissa."""
    xr, xi = _planes(rng, shape)
    br = jnp.asarray(xr, jnp.bfloat16)
    bi = jnp.asarray(xi, jnp.bfloat16)
    yr, yi = kt.fft_split(br, bi)
    assert yr.dtype == jnp.bfloat16 and yr.shape == shape
    ref = np.fft.fft(np.asarray(br, np.float64)
                     + 1j * np.asarray(bi, np.float64))
    assert snr_db(ref, _c(yr, yi)) > 30.0


@pytest.mark.parametrize("m", [64, 128, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_split_tiled_plain_route(rng, m, inverse):
    """Tiled (..., m, m) planes in and out: flat row-major order is the
    1-D order on both ends, inverse scaled by 1/n."""
    n = m * m
    assert kt.tiled_shape(n) == (m, m)
    xr, xi = _planes(rng, (3, m, m))
    yr, yi = kt.fft_split_tiled(xr, xi, inverse=inverse)
    assert yr.shape == (3, m, m)
    flat = xr.reshape(3, n).astype(np.float64) + 1j * xi.reshape(3, n)
    ref = np.fft.ifft(flat) if inverse else np.fft.fft(flat)
    assert snr_db(ref, _c(yr, yi).reshape(3, n)) > F32_SNR


# -------------------------------------------------------------- derivatives

_LINEAR = ([("fft_split", (n,)) for n in (1 << 14, 1 << 16, 3 << 14)]
           + [("fftn_split", s) for s in ((64, 64), (32, 16, 8),
                                          (512, 256))])


def _linear(name):
    return getattr(kt, name)


@pytest.mark.parametrize("name,shape", _LINEAR)
def test_grad_parseval(rng, name, shape):
    """d/dx sum|Fx|^2 = 2*N*x for the unnormalized DFT (Parseval)."""
    n = int(np.prod(shape))
    xr, xi = (jnp.asarray(a) for a in _planes(rng, shape))
    f = _linear(name)

    def loss(a, b):
        yr, yi = f(a, b)
        return jnp.sum(yr * yr + yi * yi)

    gr, gi = jax.grad(loss, argnums=(0, 1))(xr, xi)
    assert snr_db(2.0 * n * np.asarray(xr, np.float64), gr) > F32_SNR
    assert snr_db(2.0 * n * np.asarray(xi, np.float64), gi) > F32_SNR


@pytest.mark.parametrize("name,shape", _LINEAR)
def test_jvp_is_the_transform(rng, name, shape):
    """The transform is linear, so its tangent map is itself."""
    xr, xi = (jnp.asarray(a) for a in _planes(rng, shape))
    tr, ti = (jnp.asarray(a) for a in _planes(rng, shape))
    f = _linear(name)
    _, (dr, di) = jax.jvp(f, (xr, xi), (tr, ti))
    wr, wi = f(tr, ti)
    assert snr_db(_c(wr, wi), _c(dr, di)) > F32_SNR


@pytest.mark.parametrize("n", [1 << 14, 1 << 15, 3 << 14])
def test_rfft_grad_matches_xla_fft(rng, n):
    """grad of a one-sided power loss agrees with the same loss taken
    through XLA's own rfft (an independent implementation)."""
    x = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32))
    wgt = jnp.asarray(rng.standard_normal(n // 2 + 1).astype(np.float32))

    def ours(v):
        yr, yi = kt.rfft_split(v)
        return jnp.sum(wgt * (yr * yr + yi * yi))

    def ref(v):
        y = jnp.fft.rfft(v)
        return jnp.sum(wgt * jnp.abs(y) ** 2)

    assert snr_db(jax.grad(ref)(x), jax.grad(ours)(x)) > 90.0


@pytest.mark.parametrize("n", [1 << 14, 1 << 15, 3 << 14])
def test_rfft_jvp_is_the_transform(rng, n):
    x = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32))
    t = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32))
    _, (dr, di) = jax.jvp(kt.rfft_split, (x,), (t,))
    wr, wi = kt.rfft_split(t)
    assert snr_db(_c(wr, wi), _c(dr, di)) > F32_SNR


# ------------------------------------------------------- capability zone

@pytest.mark.parametrize("n,zone", [(1 << 20, False), (1 << 24, False),
                                    (3 << 24, False), (1 << 25, True),
                                    (1 << 26, True)])
def test_tree_cap_zone_predicate(n, zone):
    assert fft_mod.TREE_MAX_POW2 == 1 << 24
    assert fft_mod._jnp_fft_zone(n) is zone
    assert fft_mod._use_jnp_fft("auto", n) is zone
    assert fft_mod._use_jnp_fft("xla", n) is False
    assert fft_mod._use_jnp_fft("jnpfft", n) is True


_ROUTES = {
    "fft": lambda x: kt.fft(x),
    "ifft": lambda x: kt.ifft(x),
    "rfft": lambda x: kt.rfft(jnp.real(x)),
    "irfft": lambda x: kt.irfft(x[..., :2049], n=4096),
    "fftn": lambda x: kt.fftn(x, axes=(-1,)),
}


@pytest.mark.parametrize("api", sorted(_ROUTES))
def test_auto_routes_above_cap_to_xla_fft(rng, api, monkeypatch):
    """With the cap lowered below n, every public entry's 'auto' route
    lowers to XLA's FFT (no matmuls) and stays on contract."""
    monkeypatch.setattr(fft_mod, "TREE_MAX_POW2", 2048)
    xr, xi = _planes(rng, (2, 4096))
    x = jnp.asarray(xr + 1j * xi)
    fn = jax.jit(_ROUTES[api])
    assert "dot_general" not in fn.lower(x).as_text()
    got = np.asarray(fn(x))
    monkeypatch.undo()
    want = np.asarray(jax.jit(lambda v: _ROUTES[api](v))(x))
    assert snr_db(want, got) > F32_SNR
