"""End-to-end golden pipeline + IO utils
(reference tests/spectrogram_parity.rs:9-75, sanity-check/tests/audio_formats.rs)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kofft_tpu.media import SongIndex
from kofft_tpu.utils.audio import read_audio, read_wav, write_wav
from kofft_tpu.utils.image import decode_png, encode_png, save_png, save_svg

REPO = Path(__file__).resolve().parent.parent
SUBENV = dict(os.environ, JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def wav_440(tmp_path_factory):
    """Synthesized 440 Hz fixture (the reference test synthesizes the same,
    spectrogram_parity.rs:16-24)."""
    p = tmp_path_factory.mktemp("audio") / "tone440.wav"
    sr = 8000
    t = np.arange(sr) / sr
    write_wav(p, 0.5 * np.sin(2 * np.pi * 440 * t), sr)
    return p


def test_wav_roundtrip(tmp_path, rng):
    p = tmp_path / "x.wav"
    x = (rng.uniform(-0.9, 0.9, 1000)).astype(np.float32)
    write_wav(p, x, 16000)
    got, sr = read_wav(p)
    assert sr == 16000
    np.testing.assert_allclose(got, x, atol=1.0 / 32767 + 1e-6)


def test_read_audio_wav_keeps_interleaved(tmp_path):
    """The reference wav path does NOT downmix stereo
    (sanity-check/src/lib.rs:99-107)."""
    p = tmp_path / "st.wav"
    left = np.ones(10, np.float32) * 0.5
    right = -np.ones(10, np.float32) * 0.5
    inter = np.empty(20, np.float32)
    inter[0::2], inter[1::2] = left, right
    write_wav(p, inter, 8000, channels=2)
    got, sr = read_audio(p)
    assert got.shape == (20,)  # interleaved, not downmixed


def test_png_roundtrip_8_16(tmp_path, rng):
    img8 = (rng.random((5, 7, 3)) * 255).astype(np.uint8)
    data = encode_png(img8)
    np.testing.assert_array_equal(decode_png(data), img8)
    img16 = (rng.random((4, 6, 3)) * 65535).astype(np.uint16)
    np.testing.assert_array_equal(decode_png(encode_png(img16)), img16)


def test_save_png_depth_conversion(tmp_path):
    img16 = np.full((2, 2, 3), 0x1234, np.uint16)
    p8 = tmp_path / "a.png"
    save_png(img16, p8, "eight")
    got = decode_png(p8.read_bytes())
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.full((2, 2, 3), 0x12, np.uint8))
    p16 = tmp_path / "b.png"
    save_png(img16, p16, "sixteen")
    assert decode_png(p16.read_bytes()).dtype == np.uint16


def test_save_svg(tmp_path):
    img = np.zeros((2, 3, 3), np.uint16)
    img[0, 0] = [65535, 0, 0]
    p = tmp_path / "img.svg"
    save_svg(img, p)
    text = p.read_text()
    assert text.startswith("<svg")
    assert 'fill="#ff0000"' in text
    assert text.count("<rect") == 6


def test_cli_renders_png(tmp_path, wav_440):
    out = tmp_path / "spec.png"
    r = subprocess.run(
        [sys.executable, "-m", "kofft_tpu.cli.sanity_check", str(wav_440),
         str(out), "--win-len", "256"],
        cwd=REPO, env=SUBENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    img = decode_png(out.read_bytes())
    assert img.shape == (128, int(np.ceil(8000 / 128)), 3)
    # the 440 Hz band must light up: row = height-1 - round(440*256/8000)
    band = img.shape[0] - 1 - round(440 * 256 / 8000)
    assert img[band].astype(int).sum() > 1.5 * img[10].astype(int).sum()


def test_golden_parity_example_vs_cli(tmp_path, wav_440):
    """Example script and CLI produce byte-identical PNGs (the reference's
    spectrogram_parity contract)."""
    out1 = tmp_path / "a.png"
    out2 = tmp_path / "b.png"
    r1 = subprocess.run(
        [sys.executable, "examples/spectrogram_example.py", str(wav_440),
         str(out1), "256"], cwd=REPO, env=SUBENV, capture_output=True, text=True,
        timeout=300)
    assert r1.returncode == 0, r1.stderr
    r2 = subprocess.run(
        [sys.executable, "-m", "kofft_tpu.cli.sanity_check", str(wav_440),
         str(out2), "--win-len", "256"],
        cwd=REPO, env=SUBENV, capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr
    assert out1.read_bytes() == out2.read_bytes()


def test_cli_log_scale_and_depth(tmp_path, wav_440):
    out = tmp_path / "log16.png"
    r = subprocess.run(
        [sys.executable, "-m", "kofft_tpu.cli.sanity_check", str(wav_440),
         str(out), "--win-len", "128", "--scale-mode", "log",
         "--png-depth", "sixteen", "--colormap", "viridis"],
        cwd=REPO, env=SUBENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert decode_png(out.read_bytes()).dtype == np.uint16


def test_cli_missing_file_errors(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "kofft_tpu.cli.sanity_check",
         str(tmp_path / "missing.wav"), str(tmp_path / "o.png")],
        cwd=REPO, env=SUBENV, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert "error" in r.stderr.lower()


# ------------------------------------------------------------- media index
def test_media_index_metadata_skips_hash(tmp_path):
    """Reference test: identify() by name works after the file is deleted
    (index.rs tests)."""
    idx = SongIndex()
    p = tmp_path / "song.bin"
    p.write_bytes(b"song data")
    sid = idx.index_song(p)
    p.unlink()
    assert idx.identify(p) == sid


def test_media_index_same_content_same_id(tmp_path):
    idx = SongIndex()
    p1 = tmp_path / "a.bin"
    p2 = tmp_path / "b.bin"
    p1.write_bytes(b"data")
    p2.write_bytes(b"data")
    id1 = idx.index_song(p1)
    assert idx.identify(p2) == id1


def test_media_index_auto_insert(tmp_path):
    idx = SongIndex()
    p = tmp_path / "u.bin"
    p.write_bytes(b"unique")
    id1 = idx.identify(p)
    p.unlink()
    assert idx.identify(p) == id1


def test_non_wav_without_ffmpeg_errors(tmp_path, monkeypatch):
    """FLAC/MP3 need ffmpeg; without it the error names the limitation
    (the reference decodes these natively via symphonia — documented
    divergence, PARITY.md)."""
    import shutil as _sh
    import kofft_tpu.utils.audio as A
    monkeypatch.setattr(_sh, "which", lambda name: None)
    p = tmp_path / "x.flac"
    p.write_bytes(b"fLaC....")
    with pytest.raises(Exception, match="ffmpeg|wav"):
        A.read_audio(p)


def test_prewarm():
    from kofft_tpu.utils.observability import prewarm
    # smoke: compiles without error, incl. the N-D entry
    prewarm([64], rfft_sizes=[64], ndfft_shapes=[(8, 8)])


def test_sanity_check_main_inprocess(tmp_path, wav_440):
    """The CLI entry in-process (the subprocess golden test above cannot
    be traced by in-process coverage tooling; this pins the same path
    for tools/coverage_gate.py and exercises every flag branch)."""
    from kofft_tpu.cli.sanity_check import main
    out8 = tmp_path / "t8.png"
    rc = main([str(wav_440), str(out8), "--win-len", "128",
               "--colormap", "fire", "--scale-mode", "log",
               "--dynamic-range", "90"])
    assert rc == 0 and out8.exists() and out8.stat().st_size > 0
    out16 = tmp_path / "t16.png"
    rc = main([str(wav_440), str(out16),
               "--win-len", "128", "--png-depth", "sixteen"])
    assert rc == 0 and out16.exists()
    svg = tmp_path / "t.svg"
    rc = main([str(wav_440), str(svg), "--win-len", "128"])
    assert rc == 0 and b"<svg" in svg.read_bytes()
    # error path: unreadable input
    rc = main([str(tmp_path / "missing.wav"), str(tmp_path / "x.png")])
    assert rc == 1


def test_bench_harness_inprocess(tmp_path, monkeypatch):
    """timeit_chained's chained timer + the JSON-history rotation,
    in-process on CPU (this pins the mechanism, not a device time)."""
    import jax
    import jax.numpy as jnp
    from kofft_tpu.bench import harness
    from kofft_tpu.bench.harness import (BenchRecord, run_history,
                                         timeit_chained,
                                         timeit_chained_scalar)
    t = timeit_chained(lambda p: (p[0] + 1.0,),
                       (jnp.zeros(8, jnp.float32),), iters=4)
    assert t > 0
    ts = timeit_chained_scalar(
        lambda a, acc: acc + jnp.sum(a) * 1e-9,
        jnp.ones(8, jnp.float32), iters=4)
    assert ts > 0
    monkeypatch.setattr(harness, "card_info",
                        lambda: {"gpu": ["unit"], "power_limit": ["1 W"]})
    rec = BenchRecord("kofft_tpu", "unit", 8, "test", t * 1e9, 1.0 / t,
                      "cpu", snr_db=100.0)
    doc1 = run_history([rec], out_dir=tmp_path)
    assert doc1["records"][0]["prev_time_per_op_ns"] is None
    env = doc1["environment"]
    assert env["shard_threshold"] > 0
    assert env["device_kind"] == jax.devices()[0].device_kind
    assert env["device_count"] == len(jax.devices())
    assert env["power_limit"] == ["1 W"]
    rec2 = BenchRecord("kofft_tpu", "unit", 8, "test", t * 2e9, 0.5 / t,
                       "cpu")
    doc2 = run_history([rec2], out_dir=tmp_path)
    r2 = doc2["records"][0]
    assert r2["prev_time_per_op_ns"] == rec.time_per_op_ns
    assert abs(r2["change_vs_prev"] - 1.0) < 1e-6
    assert (tmp_path / "previous.json").exists()
    # history from another device kind is never compared against
    import json
    old = json.loads((tmp_path / "latest.json").read_text())
    old["environment"]["device_kind"] = "another device"
    (tmp_path / "latest.json").write_text(json.dumps(old))
    doc3 = run_history([rec], out_dir=tmp_path)
    assert doc3["records"][0]["change_vs_prev"] is None


def test_wav_bit_depths(tmp_path):
    """8/24/32-bit PCM wav decode branches (reference hound covers all
    PCM widths; here the stdlib-wave fallback must too)."""
    import wave as _wave
    x = np.linspace(-0.8, 0.8, 64).astype(np.float32)

    def write_width(p, width):
        with _wave.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(width)
            w.setframerate(8000)
            if width == 1:
                pcm = (np.clip(np.round(x * 127.0), -128, 127)
                       + 128).astype(np.uint8).tobytes()
            elif width == 3:
                v = np.clip(np.round(x * (2 ** 23 - 1)), -(2 ** 23),
                            2 ** 23 - 1).astype(np.int32)
                b = np.zeros((64, 3), np.uint8)
                b[:, 0] = v & 0xFF
                b[:, 1] = (v >> 8) & 0xFF
                b[:, 2] = (v >> 16) & 0xFF
                pcm = b.tobytes()
            else:
                dt = "<i4"
                pcm = np.clip(np.round(x * (2 ** 31 - 1)),
                              -(2 ** 31), 2 ** 31 - 1).astype(dt).tobytes()
            w.writeframes(pcm)

    for width, tol in ((1, 1.0 / 127 + 1e-5), (3, 1e-6), (4, 1e-7)):
        p = tmp_path / f"w{width}.wav"
        write_width(p, width)
        got, sr = read_wav(p)
        assert sr == 8000
        np.testing.assert_allclose(got, x, atol=tol)


def test_read_audio_without_ffmpeg(tmp_path, monkeypatch):
    """Non-wav without ffmpeg raises the typed error (this image has no
    ffmpeg; the monkeypatch makes the test hermetic elsewhere too)."""
    import shutil as _sh
    from kofft_tpu.errors import InvalidValueError
    monkeypatch.setattr(_sh, "which", lambda name: None)
    p = tmp_path / "x.mp3"
    p.write_bytes(b"\xff\xfbnot really an mp3")
    with pytest.raises(InvalidValueError):
        read_audio(p)


def test_observability_trace_context(tmp_path):
    """The jax.profiler trace context manager produces a trace dir."""
    import jax.numpy as jnp
    from kofft_tpu.utils.observability import trace
    d = tmp_path / "tr"
    with trace(d):
        float(jnp.sum(jnp.ones(16)))
    assert d.exists() and any(d.rglob("*"))


def test_asnumpy_paths(rng):
    """asnumpy covers numpy passthrough, real, and complex downloads."""
    from kofft_tpu.utils.transfer import asnumpy
    import jax.numpy as jnp
    a = rng.standard_normal(8).astype(np.float32)
    assert asnumpy(a) is a
    assert np.allclose(asnumpy(jnp.asarray(a)), a)
    c = a + 1j * a[::-1].copy()
    got = asnumpy(jnp.asarray(c))
    assert np.allclose(got, c, atol=1e-6)


def test_read_via_ffmpeg_fake_decoder(tmp_path, monkeypatch):
    """Decode command construction + f32le parse, with a faked ffmpeg
    (this image has none): probed-rate path keeps the stream rate;
    probe-failure path force-resamples to 44100 and reports that rate
    (a silently wrong rate would skew every downstream bin mapping)."""
    import shutil
    import subprocess as sp
    from kofft_tpu.utils import audio as A

    samples = np.linspace(-0.5, 0.5, 64).astype("<f4")
    calls = []

    def fake_which(name):
        return f"/fake/{name}"

    def fake_run(cmd, capture_output=None, text=None, check=None):
        calls.append(cmd)
        class R:
            pass
        r = R()
        if "ffprobe" in cmd[0]:
            r.stdout = "22050\n"
            return r
        assert cmd[:2] == ["/fake/ffmpeg", "-v"]
        r.stdout = samples.tobytes()
        return r

    monkeypatch.setattr(shutil, "which", fake_which)
    monkeypatch.setattr(sp, "run", fake_run)
    monkeypatch.setattr(A, "subprocess", sp)
    p = tmp_path / "x.mp3"
    p.write_bytes(b"\x00")
    data, sr = A.read_audio(p)
    assert sr == 22050 and np.allclose(data, samples)
    assert not any("-ar" in c for c in calls)     # probed rate: no resample

    calls.clear()

    def fake_run_noprobe(cmd, capture_output=None, text=None, check=None):
        calls.append(cmd)
        class R:
            pass
        r = R()
        if "ffprobe" in cmd[0]:
            raise sp.CalledProcessError(1, cmd)
        r.stdout = samples.tobytes()
        return r

    monkeypatch.setattr(sp, "run", fake_run_noprobe)
    data, sr = A.read_audio(p)
    assert sr == 44100                            # forced resample rate
    assert any("-ar" in c for c in calls)
    assert np.allclose(data, samples)


def test_snr_tier_policy_check():
    """check_snr_policy: rows clearing their tier floor pass, a
    below-floor row fails the bench run loudly, unannotated and
    unpoliced rows are ignored (ARCHITECTURE §1c)."""
    import pytest

    from kofft_tpu.bench import BenchRecord, SNR_POLICY_DB, check_snr_policy

    ok = BenchRecord("kofft_tpu", "complex", 1 << 20, "single_fast",
                     1.0, 1.0, "gpu", snr_db=65.1)
    unannotated = BenchRecord("kofft_tpu", "complex", 1 << 20, "single",
                              1.0, 1.0, "gpu")
    unpoliced = BenchRecord("kofft_tpu", "bluestein", 4099, "single",
                            1.0, 1.0, "gpu", snr_db=10.0)
    check_snr_policy([ok, unannotated, unpoliced])
    floor = SNR_POLICY_DB[("istft_frames", "single_fast")]
    bad = BenchRecord("kofft_tpu", "istft_frames", 4096, "single_fast",
                      1.0, 1.0, "gpu", snr_db=floor - 5.0)
    with pytest.raises(AssertionError, match="istft_frames"):
        check_snr_policy([ok, bad])


@pytest.mark.parametrize("case", ["env", "env_with_path", "default",
                                  "explicit"])
def test_compilation_cache_placement(case, tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, enable_compilation_cache
    leaves JAX's setting from it untouched and sets no other directory
    (even when handed a path); unset, the cache goes to one fixed
    directory inside the checkout (or the path the caller names)."""
    import jax
    from kofft_tpu.utils import observability as obs
    prev = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "jax-owned")
    try:
        jax.config.update("jax_compilation_cache_dir", sentinel)
        if case.startswith("env"):
            env_dir = str(tmp_path / "from-env")
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
            arg = tmp_path / "ignored" if case == "env_with_path" else None
            assert obs.enable_compilation_cache(arg) == env_dir
            assert jax.config.jax_compilation_cache_dir == sentinel
            assert not (tmp_path / "ignored").exists()
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            if case == "default":
                monkeypatch.setattr(obs, "DEFAULT_CACHE_DIR",
                                    tmp_path / "repo" / ".jax_cache")
                want = str(tmp_path / "repo" / ".jax_cache")
                assert obs.enable_compilation_cache() == want
            else:
                want = str(tmp_path / "mine")
                assert obs.enable_compilation_cache(want) == want
            assert jax.config.jax_compilation_cache_dir == want
            assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_default_cache_dir_is_fixed_in_checkout():
    """The default directory is a fixed path in the checkout (the cache
    key includes the path, so it must not move between runs), and git
    ignores it."""
    from pathlib import Path
    from kofft_tpu.utils import observability as obs
    root = Path(__file__).resolve().parents[1]
    assert obs.DEFAULT_CACHE_DIR == root / ".jax_cache"
    assert ".jax_cache/" in (root / ".gitignore").read_text().splitlines()
