"""STFT / ISTFT: batch, streaming, and frame-level APIs.

Accelerator build of the reference's ``src/stft.rs`` (925 LoC). The
reference's per-frame loop (window-multiply, zero-pad, fft —
``stft.rs:91-103``) becomes one gather into a frame matrix + one batched
FFT; its Rayon frame-parallel map (``stft.rs:232-343``) becomes
the leading batch dims (shard the frame axis under a mesh for multi-chip —
see ``kofft_tpu.parallel.stft_sharded``).

Semantics (bit-matching the reference):
  * frame count = ceil(N / hop); frame f starts at f*hop and is zero-padded
    past the signal end (``stft.rs:88-100``),
  * frames are full complex spectra of length win_len (``stft.rs:76-104``);
    a one-sided rfft variant is provided for real pipelines,
  * istft: inverse FFT each frame, multiply by synthesis window,
    overlap-add, then normalize by the accumulated window-square where it
    exceeds 1e-8 (``stft.rs:117-152``),
  * streaming ISTFT emits ``hop`` samples per pushed frame and a
    ``win_len - hop`` tail on flush (``stft.rs:453-519``); parity with the
    offline path including the flush tail is tested
    (reference ``tests/istft_stream.rs:5-49``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import trace_key
from ..errors import (EmptyInputError, InvalidHopSizeError,
                      MismatchedLengthsError, require)
from ..plan import tables
from ._complex import merge, split
from .fft import (_fft_planes, _is_tracer, engine_fft_planes,
                  resolve_backend)
from .rfft import _rfft_planes

__all__ = ["stft", "istft", "stft_split", "istft_split", "frame_split",
           "inverse_frame_split", "StftStream", "StftPushStream",
           "IstftStream", "istft_stream_scan", "stft_stream_scan",
           "num_frames"]


def num_frames(n: int, hop: int) -> int:
    """Frame count for a length-n signal: ceil(n / hop) (stft.rs:88)."""
    return -(-n // hop)


def _frame_indices(n_frames: int, win: int, hop: int) -> np.ndarray:
    i = np.arange(n_frames, dtype=np.int32)[:, None] * hop
    return i + np.arange(win, dtype=np.int32)[None, :]


def _window_const(window) -> np.ndarray:
    from ._complex import host_float
    w = host_float(window)
    require(w.ndim == 1 and w.size >= 1, EmptyInputError,
            "window must be a non-empty 1-D array")
    return w


def _ola_norm_const(win_sq: np.ndarray, n_frames: int, hop: int,
                    length: int) -> np.ndarray:
    """Accumulated window-square normalization buffer — a pure function of
    (window, hop, frames, length), so computed on host as a constant
    (the reference recomputes it in its scratch each call, stft.rs:140-146)."""
    win = win_sq.shape[0]
    norm = np.zeros(length, dtype=np.float64)
    for f in range(n_frames):
        s = f * hop
        e = min(s + win, length)
        if s < length:
            norm[s:e] += win_sq[: e - s]
    return norm.astype(win_sq.dtype)


# --------------------------------------------------------------------------
# traced cores
# --------------------------------------------------------------------------

def _frame_matrix(x, win: int, hop: int, nf: int):
    """Gather-free framing when win % hop == 0: reshape the signal into
    hop-chunks and concatenate k = win//hop shifted views — pure
    reshape/slice ops that XLA lays out without a 2-D gather."""
    n = x.shape[-1]
    k = win // hop
    chunks_needed = nf + k - 1
    padded = chunks_needed * hop
    if padded > n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, padded - n)]
        x = jnp.pad(x, pad)
    c = x[..., :padded].reshape(*x.shape[:-1], chunks_needed, hop)
    return jnp.concatenate([c[..., j: j + nf, :] for j in range(k)],
                           axis=-1)


def _stft_planes(x, window_np: np.ndarray, hop: int, onesided: bool,
                 backend: str, nf: Optional[int] = None):
    """real (..., N) -> frame spectra planes (..., F, K).

    ``nf`` overrides the frame count (default ceil(N/hop)) — the chunked
    streaming path computes exactly the completable frames of a segment."""
    win = window_np.shape[0]
    n = x.shape[-1]
    nf = nf if nf is not None else num_frames(n, hop)
    if win % hop == 0:
        frames = _frame_matrix(x, win, hop, nf) * window_np
    else:
        padded = (nf - 1) * hop + win
        if padded > n:
            pad = [(0, 0)] * (x.ndim - 1) + [(0, padded - n)]
            x = jnp.pad(x, pad)
        idx = _frame_indices(nf, win, hop)
        frames = x[..., idx] * window_np  # (..., F, win)
    if onesided:
        return _rfft_planes(frames, win, backend)
    return engine_fft_planes(frames, jnp.zeros_like(frames), win, False,
                             str(frames.dtype), backend)


def _ola_add(y, win: int, hop: int, nf: int):
    """Overlap-add of windowed frames y (..., F, win) -> (..., (F-1)*hop+win).

    Gather-free when win % hop == 0 (the transposed form of
    ``_frame_matrix``): split each frame into k = win//hop hop-chunks;
    chunk j of frame f lands at chunk slot f + j, so the whole OLA is k
    shifted pads summed — elementwise only, no scatter-add."""
    k = win // hop
    if win % hop != 0:
        idx = _frame_indices(nf, win, hop)           # (F, win)
        out = jnp.zeros((*y.shape[:-2], (nf - 1) * hop + win),
                        dtype=y.dtype)
        return out.at[..., idx].add(y)
    chunks = nf + k - 1
    c3 = y.reshape(*y.shape[:-1], k, hop)            # (..., F, k, hop)
    out3 = jnp.zeros((*y.shape[:-2], chunks, hop), dtype=y.dtype)
    for j in range(k):
        out3 = out3.at[..., j: j + nf, :].add(c3[..., :, j, :])
    return out3.reshape(*y.shape[:-2], chunks * hop)


import contextlib


@contextlib.contextmanager
def _synthesis_tier():
    """ISTFT synthesis dots never run below the 'high' tier.

    OLA reconstruction converts per-frame dot error straight into signal
    error, so synthesis keeps at least the 'high' tier, the form here of
    the reference's full-precision normalize (stft.rs:117-152). On an
    H100 (80GB HBM3, 700 W) 'high' and 'default' both run the tensor
    cores at TF32-class precision, so the floor changes nothing there:
    a 2^20-sample STFT at 'default' reads 69.6 dB and its ISTFT round
    trip 75.7 dB on the interior (48.1 dB in full — the hann w[0] = 0
    edge sample is unrecoverable at any precision). Applies at TRACE
    time only (lax precision is baked into the jitted program; entries
    key on trace_key, which is unchanged)."""
    from ..config import get_config, set_precision
    prev = get_config().precision
    if prev == "default":
        set_precision("high")
    try:
        yield
    finally:
        set_precision(prev)


def _istft_planes(fr, fi, window_np: np.ndarray, hop: int, length: int,
                  backend: str):
    """frame spectra planes (..., F, win) -> real signal (..., length)."""
    win = window_np.shape[0]
    nf = fr.shape[-2]
    dtype = str(fr.dtype)
    # engine inverse is unnormalized (win * ifft)
    with _synthesis_tier():
        tr, _ = engine_fft_planes(fr, fi, win, True, dtype, backend)
    y = (tr / win) * window_np                       # (..., F, win)
    out = _ola_add(y, win, hop, nf)
    if out.shape[-1] < length:
        pad = [(0, 0)] * (out.ndim - 1) + [(0, length - out.shape[-1])]
        out = jnp.pad(out, pad)
    else:
        out = out[..., :length]
    norm = _ola_norm_const(window_np * window_np, nf, hop, length)
    return jnp.where(norm > 1e-8, out / jnp.where(norm > 1e-8, norm, 1.0),
                     out)


# --------------------------------------------------------------------------
# jitted entries
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jit_stft(win: int, hop: int, onesided: bool, backend: str,
              window_key: tuple, ck: tuple = ()):
    window_np = _window_cache[window_key]
    return jax.jit(lambda x: _stft_planes(x, window_np, hop, onesided,
                                          backend))


@functools.lru_cache(maxsize=None)
def _jit_istft(win: int, hop: int, length: int, backend: str,
               window_key: tuple, ck: tuple = ()):
    window_np = _window_cache[window_key]
    return jax.jit(lambda fr, fi: _istft_planes(fr, fi, window_np, hop,
                                                length, backend))


_window_cache: dict[tuple, np.ndarray] = {}


def _window_key(w: np.ndarray) -> tuple:
    key = (w.shape[0], hash(w.tobytes()))
    _window_cache.setdefault(key, w)
    return key


def _resolve_planes_backend(backend: Optional[str]) -> str:
    b = resolve_backend(backend)
    return "xla" if b in ("jnpfft",) else b


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def stft(signal, window, hop: int, onesided: bool = False,
         backend: Optional[str] = None):
    """STFT of a real signal: (..., N) -> complex frames (..., F, K) where
    F = ceil(N/hop), K = win_len (or win_len//2+1 when ``onesided``).

    Reference: ``stft`` (``src/stft.rs:76-104``)."""
    require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
    w = _window_const(window)
    host = not isinstance(signal, (jax.Array, jax.core.Tracer))
    if host:
        from ._complex import host_float
        x = host_float(signal)
    else:
        x = jnp.asarray(signal)
    require(x.ndim >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "signal must be non-empty")
    b = _resolve_planes_backend(backend)
    if _is_tracer(x):
        return merge(*_stft_planes(x, w, hop, onesided, b))
    yr, yi = _jit_stft(w.shape[0], hop, onesided, b, _window_key(w),
                       trace_key())(x)
    return merge(yr, yi)


def istft(frames, window, hop: int, length: Optional[int] = None,
          backend: Optional[str] = None):
    """Inverse STFT with window-square overlap-add normalization.

    ``frames``: complex (..., F, win_len). Returns real (..., length),
    default length (F-1)*hop + win_len. Reference ``istft``
    (``src/stft.rs:117-152``)."""
    require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
    w = _window_const(window)
    win = w.shape[0]
    host = not isinstance(frames, (jax.Array, jax.core.Tracer))
    f = np.asarray(frames) if host else jnp.asarray(frames)
    require(f.ndim >= 2, EmptyInputError, "frames must be (..., F, win)")
    require(f.shape[-1] == win, MismatchedLengthsError,
            f"frame length {f.shape[-1]} != window length {win}")
    nf = f.shape[-2]
    length = length if length is not None else (nf - 1) * hop + win
    b = _resolve_planes_backend(backend)
    if _is_tracer(f):
        fr, fi = split(f)
        return _istft_planes(fr, fi, w, hop, length, b)
    if host:
        from ._complex import host_float_dtype
        ft = host_float_dtype(f.real.dtype)
        fr = np.ascontiguousarray(f.real).astype(ft)
        fi = np.ascontiguousarray(f.imag).astype(ft)
    else:
        fr, fi = split(f)
    return _jit_istft(win, hop, length, b, _window_key(w),
                      trace_key())(fr, fi)


def stft_split(signal, window, hop: int, onesided: bool = False,
               backend: Optional[str] = None):
    """STFT returning SoA planes (traceable)."""
    require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
    w = _window_const(window)
    x = jnp.asarray(signal)
    b = _resolve_planes_backend(backend)
    if _is_tracer(x):
        return _stft_planes(x, w, hop, onesided, b)
    return _jit_stft(w.shape[0], hop, onesided, b, _window_key(w),
                     trace_key())(x)


def istft_split(fr, fi, window, hop: int, length: Optional[int] = None,
                backend: Optional[str] = None):
    """Inverse STFT from SoA planes (traceable)."""
    require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
    w = _window_const(window)
    fr = jnp.asarray(fr)
    fi = jnp.asarray(fi)
    require(fr.shape == fi.shape, MismatchedLengthsError,
            "re/im plane shapes differ")
    nf = fr.shape[-2]
    length = length if length is not None else (nf - 1) * hop + w.shape[0]
    b = _resolve_planes_backend(backend)
    if _is_tracer(fr):
        return _istft_planes(fr, fi, w, hop, length, b)
    return _jit_istft(w.shape[0], hop, length, b, _window_key(w),
                      trace_key())(fr, fi)


def frame_split(signal, window, start: int, backend: Optional[str] = None):
    """Single-frame STFT at ``start`` (no-alloc frame API parity,
    reference ``frame``, ``stft.rs:355-372``)."""
    w = _window_const(window)
    win = w.shape[0]
    x = jnp.asarray(signal)
    n = x.shape[-1]
    avail = max(0, min(win, n - start))
    seg = jax.lax.dynamic_slice_in_dim(
        jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, win)]),
        start, win, axis=-1)
    mask = (np.arange(win) < avail).astype(np.float32)
    fr = seg * w * mask
    b = _resolve_planes_backend(backend)
    return _fft_planes(fr, jnp.zeros_like(fr), win, False, b, str(fr.dtype))


def inverse_frame_split(fr, fi, window, backend: Optional[str] = None):
    """Single-frame inverse: time-domain windowed samples for overlap-add
    (reference ``inverse_frame``, ``stft.rs:384-399``)."""
    w = _window_const(window)
    win = w.shape[0]
    b = _resolve_planes_backend(backend)
    with _synthesis_tier():
        tr, _ = _fft_planes(jnp.asarray(fr), jnp.asarray(fi), win, True, b,
                            str(jnp.asarray(fr).dtype))
    return (tr / win) * w


# --------------------------------------------------------------------------
# streaming
# --------------------------------------------------------------------------

class StftStream:
    """Streaming STFT over a fixed signal (reference ``StftStream``,
    ``stft.rs:160-206``): ``next_frame()`` yields one spectrum per hop until
    the signal is exhausted."""

    def __init__(self, signal, window, hop: int,
                 backend: Optional[str] = None):
        require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
        self._w = _window_const(window)
        self._sig = np.asarray(signal, dtype=np.float32)
        require(self._sig.ndim == 1, EmptyInputError,
                "streaming STFT takes a 1-D signal")
        self._hop = hop
        self._pos = 0
        self._backend = _resolve_planes_backend(backend)
        win = self._w.shape[0]
        self._fn = jax.jit(lambda seg: _fft_planes(
            seg * self._w, jnp.zeros_like(seg), win, False, self._backend,
            "float32"))

    def next_frame(self):
        """Returns (re, im) planes of the next frame, or None when done."""
        if self._pos >= self._sig.size:
            return None
        win = self._w.shape[0]
        seg = np.zeros(win, dtype=np.float32)
        avail = min(win, self._sig.size - self._pos)
        seg[:avail] = self._sig[self._pos: self._pos + avail]
        self._pos += self._hop
        return self._fn(seg)

    def __iter__(self):
        while True:
            f = self.next_frame()
            if f is None:
                return
            yield f


@functools.lru_cache(maxsize=None)
def _jit_stft_chunk(win: int, hop: int, nf: int, onesided: bool,
                    backend: str, window_key: tuple, ck: tuple = ()):
    """Jitted chunk worker: (win + (nf-1)*hop,) segment -> (nf, K) planes.
    Cache keyed on the pow2-bucketed frame count so arbitrary push sizes
    hit a bounded set of executables."""
    window_np = _window_cache[window_key]
    return jax.jit(lambda seg: _stft_planes(seg, window_np, hop, onesided,
                                            backend, nf=nf))


class StftPushStream:
    """Real-time chunked streaming STFT: ``push(samples)`` accepts an
    arbitrary-length chunk and returns the spectra of ALL frames it
    completes — ``⌈len/hop⌉`` frames per single device launch, not one
    launch per frame (the chunked form amortizes the launch cost across
    the chunk). This is the push-style symmetric twin of
    :class:`IstftStream` and the device-side contract behind the web
    streaming state (reference ``State::compute_frame`` accumulate/drain
    semantics, ``web-spectrogram/src/lib.rs:211-234``, generalized from
    1 frame per call to k).

    Frame semantics match :func:`stft`/:class:`StftStream`: frame f
    covers ``[f*hop, f*hop+win)``; a frame is emitted once its window is
    fully buffered; ``flush()`` zero-pads and emits the remaining
    partial frames so that push(whole signal) + flush() reproduces the
    offline ``stft_split`` exactly (``F = ceil(N/hop)`` frames).

    Chunk executables are compile-cached per pow2-bucketed frame count:
    a segment is zero-padded up to the bucket and the spurious frames
    sliced off, so arbitrary audio-callback sizes reuse O(log F) compiled
    programs instead of one per distinct k."""

    def __init__(self, window, hop: int, onesided: bool = False,
                 backend: Optional[str] = None):
        require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
        self._w = _window_const(window)
        self._hop = hop
        self._onesided = onesided
        self._backend = _resolve_planes_backend(backend)
        self._buf = np.zeros(0, dtype=self._w.dtype)
        # global stream bookkeeping: buf[0] sits at stream index _start,
        # the next unemitted frame begins at _pos. Draining by k*hop
        # alone desynchronizes when hop > win (the drain can exceed the
        # buffer and the inter-frame gap is silently lost)
        self._start = 0
        self._pos = 0

    @property
    def buffered(self) -> int:
        """Samples currently waiting for their frame to complete."""
        return int(self._buf.size)

    def _run_chunk(self, seg: np.ndarray, k: int):
        win, hop = self._w.shape[0], self._hop
        kb = 1 << max(0, (k - 1).bit_length())    # pow2 bucket
        need = win + (kb - 1) * hop
        # seg.size <= need always: push slices exactly win+(k-1)*hop and
        # at flush every unemitted frame is partial (end - _pos < win),
        # so padding up to the bucket is the only relayout (fuzz-checked)
        if seg.size < need:
            seg = np.concatenate(
                [seg, np.zeros(need - seg.size, seg.dtype)])
        fr, fi = _jit_stft_chunk(win, hop, kb, self._onesided,
                                 self._backend, _window_key(self._w),
                                 trace_key())(seg)
        return np.asarray(fr)[:k], np.asarray(fi)[:k]

    def _empty(self):
        kdim = (self._w.shape[0] // 2 + 1 if self._onesided
                else self._w.shape[0])
        z = np.zeros((0, kdim), dtype=self._w.dtype)
        return z, z.copy()

    def push(self, samples):
        """Buffer ``samples``; returns (re, im) planes of shape (k, K)
        for the k frames this chunk completed (k may be 0)."""
        s = np.asarray(samples, dtype=self._w.dtype).ravel()
        self._buf = np.concatenate([self._buf, s])
        win, hop = self._w.shape[0], self._hop
        end = self._start + self._buf.size
        if self._pos + win > end:
            return self._empty()
        k = (end - win - self._pos) // hop + 1
        off = self._pos - self._start
        out = self._run_chunk(self._buf[off: off + win + (k - 1) * hop], k)
        self._pos += k * hop
        # drop consumed samples; with hop > win the next frame start can
        # lie beyond the buffer — _pos remembers the gap to skip
        drop = min(self._buf.size, self._pos - self._start)
        self._start += drop
        self._buf = self._buf[drop:]
        return out

    def flush(self):
        """Zero-pad and emit the remaining partial frames (the streaming
        tail), then reset; offline parity: push+flush emits exactly
        ``ceil(total/hop)`` frames."""
        win, hop = self._w.shape[0], self._hop
        end = self._start + self._buf.size
        if self._pos >= end:
            out = self._empty()
        else:
            k = -(-(end - self._pos) // hop)
            off = self._pos - self._start
            out = self._run_chunk(self._buf[off:], k)
        self._buf = np.zeros(0, dtype=self._w.dtype)
        self._start = 0
        self._pos = 0
        return out


def stft_stream_scan(signal, window, hop: int, onesided: bool = False,
                     backend: Optional[str] = None):
    """Device-side streaming forward STFT: ONE ``lax.scan`` over the frame
    index emitting one spectrum per hop — the scan form of
    :class:`StftStream` (reference ``StftStream``, ``src/stft.rs:160-206``),
    symmetric with :func:`istft_stream_scan`. Exact parity with the
    streaming class including the zero-padded final partial frames:
    frame ``f`` covers ``[f*hop, f*hop + win)`` of the zero-extended
    signal, ``F = ceil(N / hop)`` frames total (``stft.rs:88-100``).

    Unlike the offline frame-matrix path this never materializes the
    (F, win) frame matrix before the FFT — each scan step slices one
    window from the padded signal — so peak memory is O(N + F*K) instead
    of O(N * win/hop + F*K), which is what makes hour-long signals
    streamable on one chip. The whole stream is a single executable (no
    per-frame launch cost) and is jit/AD-composable. The offline batched
    ``stft_split`` computes all frames in one batched FFT: prefer it
    whenever the whole signal is already resident; the scan exists for
    bounded-memory streams and for carrying state through ``lax.scan``
    compositions.

    Returns (re, im) planes of shape (F, K), K = win (``win//2+1`` when
    ``onesided``)."""
    require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
    w_np = _window_const(window)
    win = w_np.shape[0]
    x = jnp.asarray(signal)
    require(x.ndim == 1 and x.shape[0] >= 1, EmptyInputError,
            "stft_stream_scan takes a non-empty 1-D signal")
    n = x.shape[0]
    nf = num_frames(n, hop)
    b = _resolve_planes_backend(backend)
    ct = jnp.promote_types(x.dtype, jnp.asarray(w_np).dtype)
    x = x.astype(ct)
    w = jnp.asarray(w_np).astype(ct)
    padded = (nf - 1) * hop + win
    if padded > n:
        x = jnp.pad(x, (0, padded - n))

    def step(pos, _):
        seg = jax.lax.dynamic_slice_in_dim(x, pos, win) * w
        if onesided:
            fr, fi = _rfft_planes(seg, win, b)
        else:
            fr, fi = _fft_planes(seg, jnp.zeros_like(seg), win, False, b,
                                 str(ct))
        return pos + hop, (fr, fi)

    _, (yr, yi) = jax.lax.scan(step, jnp.int32(0), None, length=nf)
    return yr, yi


def istft_stream_scan(fr, fi, window, hop: int,
                      backend: Optional[str] = None):
    """Device-side streaming ISTFT: ONE ``lax.scan`` over the frame axis
    carrying the rolling overlap-add (buf, norm) state — the
    scan-friendly form of :class:`IstftStream` (SURVEY §7's "streaming
    ISTFT state on device" hard part). Emits exactly what F
    successive ``push_frame`` calls followed by ``flush`` emit — F*hop streamed
    samples plus the ``win-hop`` tail, concatenated — but the whole
    stream runs in a single executable (no per-frame launch cost) and
    the function is traceable/jit/AD-composable — use the class only
    for genuine real-time chunk arrival.

    ``fr, fi``: (F, win) frame spectrum planes. Returns a
    (F*hop + max(0, win-hop),) real signal."""
    require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
    w_np = _window_const(window)
    win = w_np.shape[0]
    fr = jnp.asarray(fr)
    fi = jnp.asarray(fi)
    require(fr.ndim == 2 and fr.shape == fi.shape, MismatchedLengthsError,
            "istft_stream_scan takes (F, win) planes")
    require(fr.shape[-1] == win, MismatchedLengthsError,
            f"frame length {fr.shape[-1]} != window length {win}")
    b = _resolve_planes_backend(backend)
    # coerce frames and window to one dtype BEFORE the scan: the carry
    # (buf, norm) is initialized from the window while y follows the
    # frame planes, and a dtype mismatch (e.g. f64 frames + f32 window
    # under x64) would change the carry dtype across the first step and
    # make lax.scan raise instead of computing (ADVICE r2 item 1)
    ct = jnp.promote_types(fr.dtype, jnp.asarray(w_np).dtype)
    fr = fr.astype(ct)
    fi = fi.astype(ct)
    w = jnp.asarray(w_np).astype(ct)
    dtype = str(ct)

    def step(carry, f):
        buf, norm = carry
        with _synthesis_tier():
            tr, _ = _fft_planes(f[0], f[1], win, True, b, dtype)
        y = (tr / win) * w
        buf = buf + y
        norm = norm + (w * w)
        out = jnp.where(norm[:hop] > 1e-8,
                        buf[:hop] / jnp.where(norm[:hop] > 1e-8,
                                              norm[:hop], 1.0),
                        buf[:hop])
        buf = jnp.concatenate([buf[hop:], jnp.zeros(hop, buf.dtype)])
        norm = jnp.concatenate([norm[hop:], jnp.zeros(hop, norm.dtype)])
        return (buf, norm), out

    init = (jnp.zeros(win, w.dtype), jnp.zeros(win, w.dtype))
    (buf, norm), outs = jax.lax.scan(step, init, (fr, fi))
    stream = outs.reshape(-1)
    tail_n = win - hop
    if tail_n <= 0:
        return stream
    tb = buf[:tail_n]
    tn = norm[:tail_n]
    tail = jnp.where(tn > 1e-8, tb / jnp.where(tn > 1e-8, tn, 1.0), tb)
    return jnp.concatenate([stream, tail])


class IstftStream:
    """Streaming ISTFT with rolling overlap-add state (reference
    ``IstftStream``, ``stft.rs:407-520``): ``push_frame`` returns the next
    ``hop`` normalized samples; ``flush`` returns the ``win_len - hop``
    tail. Exactly matches the offline ``istft`` including the flush tail
    (reference parity test ``tests/istft_stream.rs:5-49``)."""

    def __init__(self, win_len: int, hop: int, window,
                 backend: Optional[str] = None):
        require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
        w = _window_const(window)
        require(w.shape[0] == win_len, MismatchedLengthsError,
                f"window length {w.shape[0]} != win_len {win_len}")
        self._w = w
        self._win = win_len
        self._hop = hop
        self._backend = _resolve_planes_backend(backend)
        # carried OLA state: win_len accumulated samples + norm
        self._buf = jnp.zeros(win_len, jnp.float32)
        self._norm = jnp.zeros(win_len, jnp.float32)
        self._count = 0
        b = self._backend

        def step(buf, norm, fr, fi):
            with _synthesis_tier():
                tr, _ = _fft_planes(fr, fi, win_len, True, b, "float32")
            y = (tr / win_len) * w
            buf = buf + y
            norm = norm + (w * w)
            out = jnp.where(norm[:hop] > 1e-8,
                            buf[:hop] / jnp.where(norm[:hop] > 1e-8,
                                                  norm[:hop], 1.0),
                            buf[:hop])
            buf = jnp.concatenate([buf[hop:], jnp.zeros(hop, jnp.float32)])
            norm = jnp.concatenate([norm[hop:], jnp.zeros(hop, jnp.float32)])
            return out, buf, norm

        self._step = jax.jit(step)

    def push_frame(self, fr, fi=None):
        """Push one spectrum (complex array or (re, im) planes); returns
        the next ``hop`` samples as numpy."""
        if fi is None:
            f = np.asarray(fr)
            fr = np.ascontiguousarray(f.real).astype(np.float32)
            fi = np.ascontiguousarray(f.imag).astype(np.float32)
        require(np.asarray(fr).shape == (self._win,), MismatchedLengthsError,
                f"frame must have length {self._win}")
        out, self._buf, self._norm = self._step(self._buf, self._norm,
                                                jnp.asarray(fr),
                                                jnp.asarray(fi))
        self._count += 1
        return np.asarray(out)

    def flush(self):
        """Remaining ``win_len - hop`` normalized tail samples (numpy)."""
        if self._count == 0:
            return np.zeros(0, dtype=np.float32)
        tail = self._win - self._hop
        if tail <= 0:
            return np.zeros(0, dtype=np.float32)
        buf = np.asarray(self._buf)[:tail]
        norm = np.asarray(self._norm)[:tail]
        out = np.where(norm > 1e-8, buf / np.where(norm > 1e-8, norm, 1.0),
                       buf)
        self._count = 0
        self._buf = jnp.zeros(self._win, jnp.float32)
        self._norm = jnp.zeros(self._win, jnp.float32)
        return out.astype(np.float32)
