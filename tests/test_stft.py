"""STFT/ISTFT semantics + streaming parity
(reference tests/stft.rs, tests/istft_stream.rs:5-49)."""

import numpy as np
import pytest

import kofft_tpu as kt
from kofft_tpu.ops import stft as S
from kofft_tpu.ops import window as W
from kofft_tpu.ops.dft import dft, snr_db

SNR = 95.0


def _ref_stft(x, w, hop):
    """Reference-semantics STFT in float64 numpy (stft.rs:76-104)."""
    n = len(x)
    win = len(w)
    nf = -(-n // hop)
    frames = np.zeros((nf, win), dtype=np.float64)
    for f in range(nf):
        s = f * hop
        seg = x[s: s + win]
        frames[f, : len(seg)] = seg
    return np.fft.fft(frames * w, axis=-1)


def _ref_istft(frames, w, hop, length):
    """Reference-semantics ISTFT (stft.rs:117-152)."""
    win = len(w)
    out = np.zeros(length, dtype=np.float64)
    norm = np.zeros(length, dtype=np.float64)
    t = np.fft.ifft(frames, axis=-1).real * w
    for f in range(frames.shape[0]):
        s = f * hop
        e = min(s + win, length)
        out[s:e] += t[f, : e - s]
        norm[s:e] += (w * w)[: e - s]
    mask = norm > 1e-8
    out[mask] /= norm[mask]
    return out


@pytest.mark.parametrize("n,win,hop", [(1000, 64, 16), (512, 128, 32),
                                       (333, 64, 64), (100, 32, 8)])
def test_stft_matches_reference_semantics(rng, n, win, hop):
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win).astype(np.float64)
    got = np.asarray(S.stft(x, w.astype(np.float32), hop))
    ref = _ref_stft(x.astype(np.float64), w, hop)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > SNR


def test_stft_istft_roundtrip(rng):
    n, win, hop = 2048, 256, 64
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    frames = S.stft(x, w, hop)
    back = np.asarray(S.istft(frames, w, hop, length=n))
    # interior reconstruction is exact; edges attenuated by window onset
    assert snr_db(x[win:-win], back[win:-win]) > SNR


def test_istft_matches_reference_semantics(rng):
    n, win, hop = 777, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w64 = W.hann(win).astype(np.float64)
    frames = _ref_stft(x.astype(np.float64), w64, hop)
    ref = _ref_istft(frames, w64, hop, n)
    got = np.asarray(S.istft(frames.astype(np.complex64), W.hann(win), hop,
                             length=n))
    assert snr_db(ref, got) > SNR


def test_stft_onesided(rng):
    n, win, hop = 512, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    full = np.asarray(S.stft(x, w, hop))
    one = np.asarray(S.stft(x, w, hop, onesided=True))
    np.testing.assert_allclose(one, full[..., : win // 2 + 1],
                               rtol=1e-4, atol=1e-3)


def test_stft_batched(rng):
    x = rng.standard_normal((3, 500)).astype(np.float32)
    w = W.hann(64)
    got = np.asarray(S.stft(x, w, 16))
    for b in range(3):
        ref = _ref_stft(x[b].astype(np.float64), w.astype(np.float64), 16)
        assert snr_db(ref, got[b]) > SNR


def test_streaming_stft_matches_batch(rng):
    n, win, hop = 400, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    batch = np.asarray(S.stft(x, w, hop))
    stream = S.StftStream(x, w, hop)
    frames = [np.asarray(fr) + 1j * np.asarray(fi) for fr, fi in stream]
    assert len(frames) == batch.shape[0]
    assert snr_db(batch, np.stack(frames)) > SNR


def test_streaming_istft_matches_offline(rng):
    """Streaming push/flush == offline istft incl. the flush tail
    (reference tests/istft_stream.rs:5-49)."""
    n, win, hop = 512, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    frames = np.asarray(S.stft(x, w, hop))
    nf = frames.shape[0]
    offline = np.asarray(S.istft(frames, w, hop,
                                 length=(nf - 1) * hop + win))
    stream = S.IstftStream(win, hop, w)
    chunks = [stream.push_frame(frames[f]) for f in range(nf)]
    chunks.append(stream.flush())
    got = np.concatenate(chunks)
    assert got.shape == offline.shape
    assert snr_db(offline, got) > SNR


def test_frame_apis(rng):
    n, win = 200, 64
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    fr, fi = S.frame_split(x, w, start=32)
    ref = np.fft.fft(x[32:32 + win].astype(np.float64) * w)
    assert snr_db(ref, np.asarray(fr) + 1j * np.asarray(fi)) > SNR
    # zero-padded past the end
    fr, fi = S.frame_split(x, w, start=n - 10)
    seg = np.zeros(win)
    seg[:10] = x[n - 10:]
    ref = np.fft.fft(seg * w)
    assert snr_db(ref, np.asarray(fr) + 1j * np.asarray(fi)) > SNR


def test_bad_hop_raises():
    with pytest.raises(kt.KofftError):
        S.stft(np.zeros(64, np.float32), W.hann(16), 0)
    with pytest.raises(kt.KofftError):
        S.istft(np.zeros((4, 16), np.complex64), W.hann(16), 0)


def test_istft_frame_window_mismatch_raises():
    with pytest.raises(kt.KofftError):
        S.istft(np.zeros((4, 32), np.complex64), W.hann(16), 8)


def test_istft_stream_scan_matches_push_flush(rng):
    """The scan-based device-side streaming ISTFT emits EXACTLY what the
    push/flush streaming class emits (SURVEY §7's scan-friendly carried
    OLA state), and is jittable as one executable."""
    import jax
    from kofft_tpu.ops.stft import IstftStream, istft_stream_scan
    win, hop, nf = 64, 16, 12
    x = rng.standard_normal(nf * hop + win).astype(np.float32)
    w = W.hann(win)
    frames = np.asarray(S.stft(x[: nf * hop], w, hop))[:nf]
    fr = np.ascontiguousarray(frames.real)
    fi = np.ascontiguousarray(frames.imag)

    st = IstftStream(win, hop, w)
    pushed = [st.push_frame(fr[k], fi[k]) for k in range(nf)]
    ref = np.concatenate(pushed + [st.flush()])

    got = np.asarray(istft_stream_scan(fr, fi, w, hop))
    assert got.shape == ref.shape
    # f32 accumulation order differs between the scan and per-call jits;
    # near-zero window norms amplify that to ~2e-5 at the chunk edges
    assert snr_db(ref, got) > 90.0
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)

    # jit-composability: same result under jit
    got2 = np.asarray(jax.jit(
        lambda a, b: istft_stream_scan(a, b, w, hop))(fr, fi))
    assert snr_db(ref, got2) > 90.0


def test_stft_stream_scan_matches_offline(rng):
    """The scan-based device-side forward STFT emits EXACTLY the offline
    frames — including the zero-padded final partial frames — in one
    executable (VERDICT r2 item 4; reference StftStream contract,
    src/stft.rs:160-206)."""
    import jax
    from kofft_tpu.ops.stft import stft_stream_scan
    win, hop = 64, 16
    n = 50 * hop + 7                      # non-multiple: partial tail
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    rr, ri = S.stft_split(x, w, hop)
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    yr, yi = stft_stream_scan(x, w, hop)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert got.shape == ref.shape == (S.num_frames(n, hop), win)
    assert snr_db(ref, got) > SNR

    # one-sided variant matches the one-sided offline path
    hr, hi = S.stft_split(x, w, hop, onesided=True)
    or_, oi = stft_stream_scan(x, w, hop, onesided=True)
    assert np.asarray(or_).shape == (S.num_frames(n, hop), win // 2 + 1)
    assert snr_db(np.asarray(hr) + 1j * np.asarray(hi),
                  np.asarray(or_) + 1j * np.asarray(oi)) > SNR

    # jit-composability: the stream is a traceable function
    jr, ji = jax.jit(lambda s: stft_stream_scan(s, w, hop))(x)
    assert snr_db(ref, np.asarray(jr) + 1j * np.asarray(ji)) > SNR


def test_stft_stream_scan_matches_streaming_class(rng):
    """Scan frames == the per-frame StftStream iterator, frame by frame."""
    from kofft_tpu.ops.stft import StftStream, stft_stream_scan
    win, hop, n = 32, 8, 100
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hamming(win)
    yr, yi = stft_stream_scan(x, w, hop)
    frames = [(np.asarray(a), np.asarray(b)) for a, b in StftStream(x, w, hop)]
    assert len(frames) == np.asarray(yr).shape[0]
    for f, (fr, fi) in enumerate(frames):
        assert snr_db(fr + 1j * fi,
                      np.asarray(yr)[f] + 1j * np.asarray(yi)[f]) > SNR


def test_stft_push_stream_chunked_parity(rng):
    """push() in irregular chunk sizes + flush() reproduces the offline
    stft exactly: k frames per launch, pow2-bucketed executables
    (VERDICT r2 item 4's chunked push contract)."""
    from kofft_tpu.ops.stft import StftPushStream
    win, hop = 64, 16
    n = 37 * hop + 5
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    rr, ri = S.stft_split(x, w, hop)
    ref = np.asarray(rr) + 1j * np.asarray(ri)

    st = StftPushStream(w, hop)
    got_r, got_i = [], []
    pos = 0
    for chunk in (3, 200, 1, 64, 500, 10):   # irregular arrival
        fr, fi = st.push(x[pos: pos + chunk])
        pos += chunk
        got_r.append(fr); got_i.append(fi)
    fr, fi = st.push(x[pos:])
    got_r.append(fr); got_i.append(fi)
    fr, fi = st.flush()
    got_r.append(fr); got_i.append(fi)
    got = np.concatenate(got_r) + 1j * np.concatenate(got_i)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > SNR
    assert st.buffered == 0                  # flush resets


def test_stft_push_stream_onesided_and_empty(rng):
    from kofft_tpu.ops.stft import StftPushStream
    win, hop = 32, 8
    w = W.hann(win)
    st = StftPushStream(w, hop, onesided=True)
    fr, fi = st.push(np.zeros(4, np.float32))      # below win: no frames
    assert fr.shape == (0, win // 2 + 1)
    x = rng.standard_normal(win + 3 * hop).astype(np.float32)
    fr, fi = st.push(x)
    assert fr.shape == (4, win // 2 + 1)           # (b-win)//hop+1
    rr, ri = S.stft_split(np.concatenate([np.zeros(4, np.float32), x]),
                          w, hop, onesided=True)
    ref = (np.asarray(rr) + 1j * np.asarray(ri))[:4]
    assert snr_db(ref, fr + 1j * fi) > SNR


def test_stft_push_stream_hop_greater_than_win(rng):
    """hop > win desync regression (r3 review finding, confirmed
    failing before the fix): the drain can exceed the buffer and the
    inter-frame gap must be remembered, or subsequent frames come from
    the wrong stream positions."""
    from kofft_tpu.ops.stft import StftPushStream
    win, hop, n = 32, 100, 405
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    rr, ri = S.stft_split(x, w, hop)
    ref = np.asarray(rr) + 1j * np.asarray(ri)

    st = StftPushStream(w, hop)
    parts = []
    for a, b in ((0, 135), (135, 300), (300, 405)):
        parts.append(st.push(x[a:b]))
    parts.append(st.flush())
    got = (np.concatenate([p[0] for p in parts])
           + 1j * np.concatenate([p[1] for p in parts]))
    assert got.shape == ref.shape          # exactly ceil(N/hop) frames
    assert snr_db(ref, got) > SNR


def test_istft_nondivisible_hop_gather_path(rng):
    """win % hop != 0 takes the index-matrix gather OLA (the general
    fallback of the k-shifted-adds form); roundtrip parity."""
    x = rng.standard_normal(64).astype(np.float32)
    w = np.asarray(W.hann(8))
    y = np.asarray(kt.stft(x, w, hop=3))
    ref = _ref_stft(x.astype(np.float64), w.astype(np.float64), 3)
    assert snr_db(ref, y) > SNR
    back = np.asarray(kt.istft(y, w, hop=3, length=64))
    rback = _ref_istft(ref, w.astype(np.float64), 3, 64)
    assert snr_db(rback, back) > SNR


def test_istft_length_longer_than_ola_pads(rng):
    x = rng.standard_normal(64).astype(np.float32)
    w = np.asarray(W.hann(16))
    y = np.asarray(kt.stft(x, w, hop=8))
    out = np.asarray(kt.istft(y, w, hop=8, length=200))
    assert out.shape[-1] == 200
    assert np.all(out[100:] == 0.0)


def test_stft_istft_device_input_and_jit(rng):
    import jax
    import jax.numpy as jnp
    x = rng.standard_normal(128).astype(np.float32)
    w = np.asarray(W.hann(16))
    y_dev = kt.stft(jnp.asarray(x), w, hop=8)        # device-resident input
    ref = _ref_stft(x.astype(np.float64), w.astype(np.float64), 8)
    assert snr_db(ref, np.asarray(y_dev)) > SNR

    @jax.jit
    def roundtrip(v):
        yy = kt.stft(v, w, hop=8)
        return kt.istft(yy, w, hop=8, length=128)

    back = np.asarray(roundtrip(x))                  # tracer branches
    rback = _ref_istft(ref, w.astype(np.float64), 8, 128)
    assert snr_db(rback, back) > SNR


def test_inverse_frame_split_roundtrip(rng):
    """frame -> inverse_frame gives the windowed time segment
    (reference inverse_frame, stft.rs:384-399)."""
    x = rng.standard_normal(64).astype(np.float32)
    w = np.asarray(W.hann(16))
    fr, fi = S.frame_split(x, w, start=8)
    tr = np.asarray(S.inverse_frame_split(fr, fi, w))
    ref = (x[8:24] * w) * w                          # analysis+synthesis win
    assert snr_db(ref.astype(np.float64), tr) > SNR


def test_istft_stream_scan_hop_equals_win(rng):
    """hop == win: no overlap tail, the scan stream IS the signal."""
    x = rng.standard_normal(64).astype(np.float32)
    w = np.ones(8, dtype=np.float32)
    y = np.asarray(kt.stft(x, w, hop=8))
    fr = np.ascontiguousarray(y.real).astype(np.float32)
    fi = np.ascontiguousarray(y.imag).astype(np.float32)
    out = np.asarray(S.istft_stream_scan(fr, fi, w, hop=8))
    assert snr_db(x.astype(np.float64), out) > SNR


def test_istft_stream_flush_edge_cases():
    w = np.ones(8, dtype=np.float32)
    s = S.IstftStream(8, 8, w)                       # win == hop: no tail
    s.push_frame(np.ones(8, np.float32), np.zeros(8, np.float32))
    assert s.flush().shape == (0,)
    s2 = S.IstftStream(8, 4, w)
    assert s2.flush().shape == (0,)                  # nothing pushed yet


def test_istft_synthesis_tier_floor():
    """ISTFT synthesis dots never run below the 'high' tier: the
    context manager promotes 'default' during tracing and restores it;
    other tiers pass through; trace_key (the jit cache key) is taken
    OUTSIDE the context so entries stay keyed on the public tier."""
    from kofft_tpu.config import get_config, set_precision, trace_key
    from kofft_tpu.ops.stft import _synthesis_tier

    set_precision("default")
    try:
        key_before = trace_key()
        with _synthesis_tier():
            assert get_config().precision == "high"
        assert get_config().precision == "default"
        assert trace_key() == key_before
    finally:
        set_precision(None)
    set_precision("highest")
    try:
        with _synthesis_tier():
            assert get_config().precision == "highest"
    finally:
        set_precision(None)
