"""Plan API, strided FFT, config system (env overrides + runtime setters —
reference tests/env_overrides.rs:10-38, fft.rs:2651-2685)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import kofft_tpu as kt
from kofft_tpu import config as C
from kofft_tpu.ops.dft import dft, snr_db

REPO = Path(__file__).resolve().parent.parent
SNR = 100.0


def test_fft_plan(rng):
    plan = kt.FftPlan(256).warmup((2,))
    x = (rng.standard_normal((2, 256))
         + 1j * rng.standard_normal((2, 256))).astype(np.complex64)
    yr, yi = plan(np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
    assert snr_db(dft(x), np.asarray(yr) + 1j * np.asarray(yi)) > SNR
    br, bi = plan.inverse(yr, yi)
    assert snr_db(x, np.asarray(br) + 1j * np.asarray(bi)) > SNR


def test_plan_executable_shared(rng):
    """Two plans of the same signature share the jitted executable
    (reference twiddle-cache identity test, tests/static_twiddles.rs)."""
    a = kt.FftPlan(128)
    b = kt.FftPlan(128)
    assert a._fwd is b._fwd


def test_fft_strided(rng):
    stride, n = 4, 64
    x = (rng.standard_normal(stride * n)
         + 1j * rng.standard_normal(stride * n)).astype(np.complex64)
    yr, yi = kt.fft_strided_split(np.ascontiguousarray(x.real),
                                  np.ascontiguousarray(x.imag), stride)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    for off in range(stride):
        line = x[off::stride]
        np.testing.assert_allclose(got[off::stride],
                                   np.fft.fft(line.astype(np.complex128)),
                                   rtol=1e-4, atol=1e-2)


def test_fft_strided_bad_stride():
    with pytest.raises(kt.KofftError):
        kt.fft_strided_split(np.zeros(8, np.float32),
                             np.zeros(8, np.float32), 0)
    with pytest.raises(kt.KofftError):
        kt.fft_strided_split(np.zeros(9, np.float32),
                             np.zeros(9, np.float32), 2)


def test_runtime_setters_revert():
    """None reverts to the env/heuristic default (reference atomics with
    0 = revert, fft.rs:176-209)."""
    d = C.get_config().dft_cutoff
    C.set_dft_cutoff(512)
    assert C.get_config().dft_cutoff == 512
    C.set_dft_cutoff(None)
    assert C.get_config().dft_cutoff == d
    with pytest.raises(ValueError):
        C.set_backend("nope")
    with pytest.raises(ValueError):
        C.set_precision("nope")


def test_env_override_subprocess():
    """Env vars apply at import in a fresh process (reference re-exec env
    test, tests/env_overrides.rs)."""
    code = ("import kofft_tpu as kt; c = kt.get_config(); "
            "print(c.dft_cutoff, c.backend, c.shard_threshold)")
    env = dict(os.environ, KOFFT_TPU_DFT_CUTOFF="333",
               KOFFT_TPU_BACKEND="jnpfft", KOFFT_TPU_SHARD_THRESHOLD="7777",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-3:] == ["333", "jnpfft", "7777"]


def test_bad_env_value_rejected():
    code = "import kofft_tpu"
    env = dict(os.environ, KOFFT_TPU_BACKEND="bogus")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "KOFFT_TPU_BACKEND" in r.stderr


def test_prewarm_hits_real_caches(rng):
    """prewarm must populate the same executable caches real calls use
    (it previously warmed internal entries under a cache key no public
    call ever passes, so first real calls still compiled)."""
    import jax.numpy as jnp
    import kofft_tpu as kt
    from kofft_tpu.config import trace_key
    from kofft_tpu.ops.fft import _jitted_entry_pp, resolve_backend
    from kofft_tpu.utils.observability import prewarm

    n = 192
    prewarm([n])
    b = resolve_backend(None)
    info = _jitted_entry_pp.cache_info()
    # the exact entry a real planes call uses must now be a cache HIT
    _jitted_entry_pp(n, False, None, b, trace_key(), False)
    assert _jitted_entry_pp.cache_info().hits > info.hits
    # and the public call itself runs without building a new jit wrapper
    before = _jitted_entry_pp.cache_info().misses
    z = jnp.zeros((n,), jnp.float32)
    kt.fft_split(z, z)
    assert _jitted_entry_pp.cache_info().misses == before


def test_balanced_split_prime_and_tree_helpers():
    """balanced_split of a prime returns (1, n) (the Bluestein signal);
    build_factor_tree's prime safety net emits one DFT leaf; the tree
    introspection helpers enumerate leaves and twiddle keys."""
    from kofft_tpu.plan import (DftLeaf, balanced_split, build_factor_tree,
                                tree_leaf_sizes, tree_twiddle_keys)
    assert balanced_split(7919) == (1, 7919)
    leaf = build_factor_tree(7919)
    assert isinstance(leaf, DftLeaf) and leaf.n == 7919
    t = build_factor_tree(1024, cutoff=32)
    assert tree_leaf_sizes(t) <= {2, 4, 8, 16, 32}
    for n1, n2 in tree_twiddle_keys(t):
        assert n1 * n2 in (1024, 32, 64)   # node sizes of the tree


def test_table_cache_clear_and_len():
    from kofft_tpu.plan import tables
    tables.dft_matrix(8, "float32")
    assert len(tables) > 0
    tables.clear()
    assert len(tables) == 0
    # rebuilt on demand after clear
    fr, fi = tables.dft_matrix(8, "float32")
    assert fr.shape == (8, 8) and len(tables) == 1


def test_env_parsing_errors(monkeypatch):
    from kofft_tpu.config import _env_int, _env_str
    monkeypatch.setenv("KOFFT_TEST_INT", "notanint")
    import pytest as _pytest
    with _pytest.raises(ValueError):
        _env_int("KOFFT_TEST_INT", 3)
    monkeypatch.setenv("KOFFT_TEST_INT", "")
    assert _env_int("KOFFT_TEST_INT", 3) == 3
    monkeypatch.setenv("KOFFT_TEST_STR", "bogus")
    with _pytest.raises(ValueError):
        _env_str("KOFFT_TEST_STR", "a", ("a", "b"))


def test_setter_validation_errors():
    import pytest as _pytest
    from kofft_tpu.config import (set_dft_cutoff, set_overlap_chunks,
                                  get_config)
    with _pytest.raises(ValueError):
        set_dft_cutoff(1)
    with _pytest.raises(ValueError):
        set_overlap_chunks(-2)
    set_overlap_chunks(None)           # restores the env default
    assert get_config().overlap_chunks >= 1
