"""Complex FFT parity vs the float64 naive-DFT oracle.

Mirrors the reference's oracle discipline: every optimized path is checked
against a naive DFT (reference ``tests/stockham_parity.rs``,
``tests/bluestein.rs:33-66``) plus analytic vectors (impulse / ones / cosine,
reference ``src/lib.rs:160-479``) and roundtrip drift bounds
(``src/lib.rs:408-429``).
"""

import numpy as np
import pytest

import kofft_tpu as kt
from kofft_tpu.ops.dft import dft, snr_db

# smooth sizes across strategies: tiny leaf, leaf, four-step, deep four-step,
# mixed radix; plus non-smooth (Bluestein) sizes incl. primes
SMOOTH_SIZES = [1, 2, 4, 8, 16, 64, 128, 256, 1024, 2048, 4096, 8192,
                6, 12, 60, 360, 1000, 1536, 2187, 3125]
BLUESTEIN_SIZES = [17, 97, 211, 509, 1009, 1021]

SNR_FLOOR_DB = 100.0  # f32 engine vs f64 oracle


def _rand_complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.parametrize("n", SMOOTH_SIZES + BLUESTEIN_SIZES)
def test_fft_matches_oracle(rng, n):
    x = _rand_complex(rng, (3, n))
    got = np.asarray(kt.fft(x))
    ref = dft(x)
    assert snr_db(ref, got) > SNR_FLOOR_DB, f"n={n}"


@pytest.mark.parametrize("n", [16, 1024, 4096, 360, 97])
def test_ifft_roundtrip(rng, n):
    x = _rand_complex(rng, (2, n))
    y = kt.ifft(kt.fft(x))
    assert snr_db(x, np.asarray(y)) > SNR_FLOOR_DB


@pytest.mark.parametrize("n", [64, 1024, 97])
def test_repeated_roundtrip_drift(rng, n):
    """10x fft->ifft drift bound (reference src/lib.rs:408-429)."""
    x = _rand_complex(rng, (n,))
    y = x
    for _ in range(10):
        y = kt.ifft(kt.fft(y))
    assert snr_db(x, np.asarray(y)) > SNR_FLOOR_DB - 20


def test_impulse():
    x = np.zeros(256, np.complex64)
    x[0] = 1.0
    y = np.asarray(kt.fft(x))
    np.testing.assert_allclose(y, np.ones(256), atol=1e-5)


def test_ones():
    x = np.ones(128, np.complex64)
    y = np.asarray(kt.fft(x))
    expect = np.zeros(128, np.complex128)
    expect[0] = 128.0
    np.testing.assert_allclose(y, expect, atol=1e-3)


def test_cosine_bins():
    n = 512
    t = np.arange(n)
    x = np.cos(2 * np.pi * 7 * t / n).astype(np.complex64)
    y = np.asarray(kt.fft(x))
    mag = np.abs(y)
    assert mag[7] == pytest.approx(n / 2, rel=1e-4)
    assert mag[n - 7] == pytest.approx(n / 2, rel=1e-4)
    mask = np.ones(n, bool)
    mask[[7, n - 7]] = False
    assert mag[mask].max() < 1e-2


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_norm_modes(rng, norm):
    n = 256
    x = _rand_complex(rng, (n,))
    got = np.asarray(kt.fft(x, norm=norm))
    ref = np.fft.fft(x.astype(np.complex128), norm=norm)
    assert snr_db(ref, got) > SNR_FLOOR_DB
    back = np.asarray(kt.ifft(got, norm=norm))
    assert snr_db(x, back) > SNR_FLOOR_DB


def test_axis_and_n_param(rng):
    x = _rand_complex(rng, (5, 64, 3))
    got = np.asarray(kt.fft(x, axis=1))
    ref = dft(x, axis=1)
    assert snr_db(ref, got) > SNR_FLOOR_DB
    # pad + truncate semantics match numpy
    got = np.asarray(kt.fft(x, n=128, axis=1))
    ref = np.fft.fft(x.astype(np.complex128), n=128, axis=1)
    assert snr_db(ref, got) > SNR_FLOOR_DB
    got = np.asarray(kt.fft(x, n=32, axis=1))
    ref = np.fft.fft(x.astype(np.complex128), n=32, axis=1)
    assert snr_db(ref, got) > SNR_FLOOR_DB


def test_real_input_promoted(rng):
    x = rng.standard_normal(256).astype(np.float32)
    got = np.asarray(kt.fft(x))
    ref = np.fft.fft(x.astype(np.float64))
    assert snr_db(ref, got) > SNR_FLOOR_DB


def test_backend_parity(rng):
    """All backends agree (reference tests/fft_arch_parity.rs:8-39)."""
    n = 1024
    x = _rand_complex(rng, (2, n))
    ref = dft(x)
    for b in ("xla", "jnpfft", "naive"):
        got = np.asarray(kt.fft(x, backend=b))
        assert snr_db(ref, got) > SNR_FLOOR_DB, b


def test_empty_input_raises():
    with pytest.raises(kt.KofftError):
        kt.fft(np.zeros((0,), np.complex64))


def test_bad_norm_raises():
    with pytest.raises(kt.KofftError):
        kt.fft(np.zeros(8, np.complex64), norm="bogus")


def test_jit_composability(rng):
    """kt.fft is traceable inside user jit."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(x):
        return jnp.abs(kt.fft(x))

    x = _rand_complex(rng, (4, 128))
    got = np.asarray(f(x))
    ref = np.abs(dft(x))
    assert snr_db(ref, got) > SNR_FLOOR_DB


def test_warm_call_no_retrace(rng):
    """Plan/executable cache discipline: second call hits the jit cache
    (analog of the reference's zero-alloc warm-call tests,
    tests/bluestein.rs:60-66)."""
    from kofft_tpu.config import trace_key
    from kofft_tpu.ops.fft import _jitted_entry
    x = _rand_complex(rng, (2, 96))
    kt.fft(x)
    f = _jitted_entry(96, False, None, "xla", trace_key(), False)
    n0 = f._cache_size()
    kt.fft(x)
    assert f._cache_size() == n0


def test_all_strategies_agree(rng):
    """Every strategy produces the same spectrum (reference proptests over
    all strategies, fft.rs:2274-2650)."""
    from kofft_tpu.ops.fft import _fft_planes
    import jax
    n = 256
    x = _rand_complex(rng, (2, n))
    xr, xi = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    ref = dft(x)
    for strat in ("auto", "dft", "four_step", "bluestein"):
        f = jax.jit(lambda a, b, s=strat: _fft_planes(
            a, b, n, False, "xla", "float32", s))
        yr, yi = f(xr, xi)
        got = np.asarray(yr) + 1j * np.asarray(yi)
        assert snr_db(ref, got) > SNR_FLOOR_DB, strat


def test_bad_strategy_raises(rng):
    from kofft_tpu.ops.fft import _fft_planes
    import kofft_tpu as kt
    x = np.zeros((4,), np.float32)
    with pytest.raises(kt.KofftError):
        _fft_planes(x, x, 4, False, "xla", "float32", "stockham")
    with pytest.raises(kt.KofftError):
        # four_step on a rough size (prime > max_factor) is rejected eagerly
        _fft_planes(np.zeros(101, np.float32), np.zeros(101, np.float32),
                    101, False, "xla", "float32", "four_step")


def test_float64_inputs_accepted(rng):
    """f64/c128 inputs cast at the boundary (README dtype policy); values
    match the f32 path."""
    import kofft_tpu as kt
    x64 = rng.standard_normal(256).astype(np.float64)
    y = kt.asnumpy(kt.rfft(x64))
    want = kt.asnumpy(kt.rfft(x64.astype(np.float32)))
    assert np.allclose(y, want)
    c128 = (rng.standard_normal(256) + 1j * rng.standard_normal(256))
    z = kt.asnumpy(kt.fft(c128))
    wantc = kt.asnumpy(kt.fft(c128.astype(np.complex64)))
    assert np.allclose(z, wantc)


def test_invalid_norm_raises(rng):
    x = rng.standard_normal(16).astype(np.float32)
    with pytest.raises(kt.KofftError):
        kt.fft(x, norm="bogus")


def test_jnp_fft_zone_logic():
    """Capability rule for 'auto': pow2 n above the factor-tree cap runs
    on XLA's FFT (the tree's baked twiddle literals grow as n)."""
    from kofft_tpu.ops.fft import TREE_MAX_POW2, _jnp_fft_zone
    assert _jnp_fft_zone(TREE_MAX_POW2 * 2)
    assert _jnp_fft_zone(1 << 30)
    assert not _jnp_fft_zone(TREE_MAX_POW2)          # the tree's ceiling
    assert not _jnp_fft_zone(3 * TREE_MAX_POW2)      # non-pow2: tree
    assert not _jnp_fft_zone(4096)
    assert not _jnp_fft_zone(1 << 20)


def test_engine_zone_reroute_and_pallas_fallback(rng, monkeypatch):
    """'auto' reroutes zone sizes to jnp.fft; an explicit backend is law
    and keeps the matmul engine. The cap is lowered so the zone fires at
    a CPU-sized n; the route is read from the lowered program (XLA's FFT
    appears as an fft op, the matmul engine as dots)."""
    import jax
    from kofft_tpu.ops import fft as fft_mod
    monkeypatch.setattr(fft_mod, "TREE_MAX_POW2", 2048)
    xr = rng.standard_normal((4, 4096)).astype(np.float32)
    xi = rng.standard_normal((4, 4096)).astype(np.float32)

    def route(backend):
        return jax.jit(lambda a, b: fft_mod.engine_fft_planes(
            a, b, 4096, False, "float32", backend)).lower(xr, xi).as_text()

    assert "fft" in route("auto") and "dot_general" not in route("auto")
    assert "dot_general" in route("xla")
    yr, yi = fft_mod.engine_fft_planes(xr, xi, 4096, False, "float32",
                                       "auto")
    ref = np.fft.fft((xr + 1j * xi).astype(np.complex128), axis=-1)
    assert snr_db(ref, np.asarray(yr) + 1j * np.asarray(yi)) > 100.0


def test_fft_host_complex_numpy_input(rng):
    x = (rng.standard_normal(64)
         + 1j * rng.standard_normal(64)).astype(np.complex64)
    got = kt.asnumpy(kt.fft(x))
    ref = np.fft.fft(x.astype(np.complex128))
    assert snr_db(ref, got) > 80.0


def test_fft_split_under_jit(rng):
    import jax
    xr = rng.standard_normal(64).astype(np.float32)
    xi = rng.standard_normal(64).astype(np.float32)

    @jax.jit
    def f(a, b):
        yr, yi = kt.fft_split(a, b)
        return kt.ifft_split(yr, yi)

    br, bi = f(xr, xi)
    np.testing.assert_allclose(np.asarray(br), xr, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(bi), xi, rtol=1e-4, atol=1e-4)


def test_fft_batch_aliases(rng):
    xs = (rng.standard_normal((4, 32))
          + 1j * rng.standard_normal((4, 32))).astype(np.complex64)
    got = kt.asnumpy(kt.fft_batch(xs))
    ref = np.fft.fft(xs.astype(np.complex128), axis=-1)
    assert snr_db(ref, got) > 80.0
    back = kt.asnumpy(kt.ifft_batch(got.astype(np.complex64)))
    assert snr_db(xs.astype(np.complex128), back) > 80.0


def test_fft_split_tiled_semantics(rng):
    """Public tiled pipeline API: flat row-major order on both ends,
    inverse roundtrip with 1/n scaling, and spectral pointwise work
    applying directly to the tiled planes."""
    import kofft_tpu as kt
    m1, m2 = kt.tiled_shape(1 << 14)
    assert m1 == m2
    n = m1 * m1
    x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
         ).astype(np.complex64)
    ar = np.ascontiguousarray(x.real).reshape(2, m1, m1)
    ai = np.ascontiguousarray(x.imag).reshape(2, m1, m1)
    yr, yi = kt.fft_split_tiled(ar, ai)
    got = (np.asarray(yr) + 1j * np.asarray(yi)).reshape(2, n)
    ref = np.fft.fft(x.astype(np.complex128))
    assert snr_db(ref, got) > 100.0
    # pointwise spectral mask applied in tiled layout, then inverse
    h = rng.standard_normal(n).astype(np.float32)
    ht = h.reshape(m1, m1)
    br, bi = kt.ifft_split_tiled(np.asarray(yr) * ht, np.asarray(yi) * ht)
    want = np.fft.ifft(ref * h.astype(np.float64))
    back = (np.asarray(br) + 1j * np.asarray(bi)).reshape(2, n)
    assert snr_db(want, back) > 100.0


def test_fft_split_tiled_validation():
    import kofft_tpu as kt
    from kofft_tpu.errors import InvalidValueError, MismatchedLengthsError
    with pytest.raises(InvalidValueError):
        kt.tiled_shape(1 << 15)                    # odd exponent
    with pytest.raises(InvalidValueError):
        kt.fft_split_tiled(np.zeros((128, 64), np.float32),
                           np.zeros((128, 64), np.float32))
    with pytest.raises(MismatchedLengthsError):
        kt.fft_split_tiled(np.zeros((128, 128), np.float32),
                           np.zeros((64, 128), np.float32))


def test_freq_and_shift_helpers():
    import kofft_tpu as kt
    for n in (8, 9):
        assert np.allclose(kt.fftfreq(n, 0.5), np.fft.fftfreq(n, 0.5))
        assert np.allclose(kt.rfftfreq(n, 2.0), np.fft.rfftfreq(n, 2.0))
        x = np.arange(n, dtype=np.float32)
        assert np.allclose(np.asarray(kt.fftshift(x)), np.fft.fftshift(x))
        assert np.allclose(np.asarray(kt.ifftshift(kt.fftshift(x))), x)
    from kofft_tpu.errors import EmptyInputError
    with pytest.raises(EmptyInputError):
        kt.fftfreq(0)


def test_tiled_route_is_differentiable(rng):
    """grad/jvp flow through the tiled entries exactly as through flat
    fft_split — the tiled pipeline is documented as 'the pipeline form of
    fft_split'. Analytic oracle: d/dx sum|Fx|^2 = 2*n*x (Parseval,
    unnormalized)."""
    import jax
    import jax.numpy as jnp

    n = 1 << 14
    m, _ = kt.tiled_shape(n)
    ar = jnp.asarray(rng.standard_normal((1, m, m)).astype(np.float32))
    ai = jnp.asarray(rng.standard_normal((1, m, m)).astype(np.float32))

    def loss(xr, xi):
        yr, yi = kt.fft_split_tiled(xr, xi)
        return jnp.sum(yr * yr + yi * yi)

    gr, gi = jax.grad(loss, argnums=(0, 1))(ar, ai)
    assert snr_db(2.0 * n * np.asarray(ar, np.float64),
                  np.asarray(gr)) > 100.0
    assert snr_db(2.0 * n * np.asarray(ai, np.float64),
                  np.asarray(gi)) > 100.0
    _, tang = jax.jvp(loss, (ar, ai), (jnp.ones_like(ar),
                                       jnp.zeros_like(ai)))
    assert np.isfinite(float(tang))
    # inverse entry differentiates too (1/n-scaled linear map)
    gr2, _ = jax.grad(
        lambda xr, xi: jnp.sum(sum(kt.ifft_split_tiled(xr, xi))),
        argnums=(0, 1))(ar, ai)
    assert np.all(np.isfinite(np.asarray(gr2)))


def test_tiled_bf16_io(rng):
    """Tiled pipeline entries accept bf16 planes: the engine computes in
    f32 and rounds back, dtype contract bf16 in -> bf16 out."""
    import jax.numpy as jnp
    n = 1 << 14
    m, _ = kt.tiled_shape(n)
    x = (rng.standard_normal((1, m * m))
         + 1j * rng.standard_normal((1, m * m))).astype(np.complex64)
    ar = jnp.asarray(x.real.reshape(1, m, m), jnp.bfloat16)
    ai = jnp.asarray(x.imag.reshape(1, m, m), jnp.bfloat16)
    yr, yi = kt.fft_split_tiled(ar, ai)
    assert yr.dtype == jnp.bfloat16
    got = (np.asarray(yr, np.float64)
           + 1j * np.asarray(yi, np.float64)).reshape(1, m * m)
    s = snr_db(np.fft.fft(x.astype(np.complex128)), got)
    assert s > 30.0, s


def test_d2_dense_default_tier_zone_and_parity(rng):
    """The d=2 no-transpose dense route (default tier, smooth n with
    large odd factors — VERDICT r3 missing #1): zone gates and parity
    vs numpy f64, incl. batch dims. On CPU the default tier computes in
    full f32, so the oracle floor applies."""
    import jax.numpy as jnp

    from kofft_tpu.config import set_precision
    from kofft_tpu.ops.fft import _d2_dense_planes, _d2_zone

    n = 72000                        # 2^5 * 3^2 * 5^3
    assert not _d2_zone(n, "float32")          # highest tier: tree
    set_precision("default")
    try:
        assert _d2_zone(n, "float32")
        assert not _d2_zone(1 << 10, "float32")    # below min
        assert not _d2_zone(1009, "float32")       # rough
        x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
             ).astype(np.complex64)
        # direct route parity (batched)
        yr, yi = _d2_dense_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                                  n, "float32")
        ref = np.fft.fft(x.astype(np.complex128))
        got = np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)
        assert snr_db(ref, got) > 90.0
        # public dispatch lands on it (auto backend, auto strategy)
        pr, pi = kt.fft_split(jnp.asarray(x.real[0]),
                              jnp.asarray(x.imag[0]))
        pgot = np.asarray(pr, np.float64) + 1j * np.asarray(pi, np.float64)
        assert snr_db(ref[0], pgot) > 90.0
    finally:
        set_precision(None)


def test_jnpfft_backend_matches_oracle(rng):
    """The jnpfft engine (XLA's own FFT) stays on contract for values and
    normalization."""
    n = 1 << 12
    x = (rng.standard_normal((64, n)) + 1j * rng.standard_normal((64, n))
         ).astype(np.complex64)
    got = kt.asnumpy(kt.fft(x, backend="jnpfft"))
    assert snr_db(np.fft.fft(x.astype(np.complex128)), got) > 100.0
    back = kt.asnumpy(kt.ifft(got, backend="jnpfft"))
    assert np.abs(back - x).max() < 1e-3


def test_fft_transpose_identity(rng):
    """The real-linear transpose of the forward planes map is the
    unnormalized inverse (and vice versa) — the identity reverse-mode AD
    relies on. Verified via jax.linear_transpose on the engine."""
    import jax
    import jax.numpy as jnp
    from kofft_tpu.ops.fft import _fft_planes

    n = 256
    xr = rng.standard_normal(n).astype(np.float32)
    xi = rng.standard_normal(n).astype(np.float32)
    ctr = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    cti = jnp.asarray(rng.standard_normal(n).astype(np.float32))

    fwd = lambda a, b: _fft_planes(a, b, n, False, "xla", "float32")
    inv = lambda a, b: _fft_planes(a, b, n, True, "xla", "float32")

    # linear_transpose returns a tuple of cotangents matching the inputs
    got = jax.linear_transpose(fwd, jnp.asarray(xr),
                               jnp.asarray(xi))((ctr, cti))
    want = inv(ctr, cti)
    assert np.allclose(np.asarray(got[0]), np.asarray(want[0]), atol=1e-2)
    assert np.allclose(np.asarray(got[1]), np.asarray(want[1]), atol=1e-2)

    got_i = jax.linear_transpose(inv, jnp.asarray(xr),
                                 jnp.asarray(xi))((ctr, cti))
    want_i = fwd(ctr, cti)
    assert np.allclose(np.asarray(got_i[0]), np.asarray(want_i[0]),
                       atol=1e-2)
    assert np.allclose(np.asarray(got_i[1]), np.asarray(want_i[1]),
                       atol=1e-2)


def test_backend_request_semantics():
    """'auto' is first-class (the capability zone may reroute it); an
    explicit backend is honored exactly and never rerouted; the removed
    'pallas' name is rejected."""
    from kofft_tpu.config import set_backend
    from kofft_tpu.ops.fft import resolve_backend
    assert resolve_backend(None) == "auto"
    assert resolve_backend("jnpfft") == "jnpfft"
    assert resolve_backend("xla") == "xla"
    set_backend("xla")
    try:
        assert resolve_backend(None) == "xla"       # config override
        assert resolve_backend("jnpfft") == "jnpfft"  # explicit still wins
    finally:
        set_backend(None)
    assert resolve_backend(None) == "auto"
    with pytest.raises(ValueError):
        set_backend("pallas")


def test_bf16_engine_fallback(rng):
    """bf16 planes upcast to the f32 engine and round back — public
    fft_split and rfft_split keep the dtype contract."""
    import jax.numpy as jnp
    n = 2048
    x = rng.standard_normal((3, n)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    yr, yi = kt.fft_split(xb, jnp.zeros_like(xb))
    assert yr.dtype == jnp.bfloat16
    ref = np.fft.fft(x.astype(np.float64))
    s = snr_db(ref, np.asarray(yr, np.float64)
               + 1j * np.asarray(yi, np.float64))
    assert s > 30.0, s
    from kofft_tpu.ops.rfft import rfft_split
    hr, hi = rfft_split(xb)
    assert hr.dtype == jnp.bfloat16 and hr.shape == (3, n // 2 + 1)
