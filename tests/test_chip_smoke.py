"""chip_smoke.py at tiny sizes on the CPU: every phase's control flow,
references and checks, plus its refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TINY = {
    "fft_1d": lambda s: cs.phase_fft_1d(
        s, shapes=((1024,), (2, 1024), (3 << 6,), (1000,), (97,)),
        split_n=256, donate_n=512),
    "rfft": lambda s: cs.phase_rfft(s, shapes=((256,), (2, 256))),
    "nd": lambda s: cs.phase_nd(s, fft2_shapes=((16, 16),),
                                fftn_shapes=((8, 8, 8),),
                                rfftn_shape=(8, 16)),
    "stft": lambda s: cs.phase_stft(s, seconds=0.5, push_seconds=0.1,
                                    web_requests=3),
    "other": lambda s: cs.phase_other(s, n=512, dct_sizes=(64,), batch=2,
                                      czt_m=16, mel=16, levels=2),
    "models": lambda s: cs.phase_models(s, batch=4, seconds=0.1, steps=3),
    "engines": lambda s: cs.phase_engines(
        s, shapes=(("fft", (1024,)), ("fftn", (16, 16))),
        tiers={"n": 256, "grid": 16, "cube": 8, "win": 64, "hop": 16},
        reps=1, chain=2),
    "f64": lambda s: cs.phase_f64(s, n=256, cube=(8, 8, 8)),
    "four": lambda s: cs.phase_four(s, grid=32, n_long=1 << 14,
                                    audio_s=2.0, batch=8, clip_s=0.1),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_at_tiny_size(phase, capsys):
    s = cs.Smoke(seed=0, reps=1)
    TINY[phase](s)
    s.end()
    out = capsys.readouterr().out
    assert s.rows, out
    assert not s.failed, out
    assert "FAIL" not in out


def test_engines_table_pairs_both_backends():
    s = cs.Smoke(seed=0, reps=1)
    table = TINY["engines"](s)
    pairs = [r for r in table if "api" in r]
    assert [r["api"] for r in pairs] == ["fft", "fftn"]
    for r in pairs:
        assert r["auto"]["snr_db"] > cs.F32_FLOOR_DB
        assert r["jnpfft"]["snr_db"] > cs.F32_FLOOR_DB
        assert r["auto"]["chained_ms"] > 0 and r["jnpfft"]["chained_ms"] > 0
    tiers = [r["tier"] for r in table if "tier" in r]
    assert tiers == [t for t in ("highest", "high", "default")
                     for _ in range(7)]
    assert all(r["snr_db"] > cs.F32_FLOOR_DB for r in table
               if r.get("tier") == "highest")


def test_check_records_failure_below_floor(capsys):
    s = cs.Smoke()
    s.begin("unit")
    s.check("low", 10.0, cs.F32_FLOOR_DB)
    s.check("high", 130.0, cs.F32_FLOOR_DB)
    s.expect("flag", False, "detail")
    assert s.failed == ["unit: low", "unit: flag"]
    assert "FAIL" in capsys.readouterr().out


def test_references_match_numpy():
    """The smoke's f64 references agree with the transforms they stand
    for: framed STFT and the wavelet pair's reflection rule."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000)
    w = np.hanning(64)
    ref = cs._stft_ref(x, w, 16)
    assert ref.shape == (-(-1000 // 16), 64)
    np.testing.assert_allclose(ref[3], np.fft.fft(x[48:112] * w))
    assert list(cs._reflect(np.array([-2, -1, 0, 4, 5, 6]), 5)) == [
        2, 1, 0, 4, 3, 2]
    assert cs.snr_db(x, x) == float("inf")


def _run(args, cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    r = _run(["chip_smoke.py"], ROOT, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_refuses_alone_in_a_directory(tmp_path):
    """Copied out of the repository, the script has nothing to drive."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path, {"JAX_PLATFORMS": "cpu",
                                           "PYTHONPATH": ""})
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines()
                if ln.startswith("{") and json.loads(ln).get("ok")]
