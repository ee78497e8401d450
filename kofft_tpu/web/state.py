"""Streaming spectrogram state: push samples -> RGBA rows.

Reference: the web-spectrogram WASM ``State::compute_frame``
(``web-spectrogram/src/lib.rs:191-234``): WIN_LEN=1024, HOP=512,
FLOOR_DB=-80; accumulate samples, once >= WIN_LEN window-multiply + FFT,
take the half-spectrum magnitudes, track the running max (init 1e-12),
colorize each bin to RGBA (alpha=255), drain HOP samples. Default palette
Rainbow; ``set_colormap``/``reset`` mirror the WASM exports
(``lib.rs:238-252``).

Device path: the chunked :class:`kofft_tpu.ops.stft.StftPushStream` —
every push computes ALL frames the chunk completes in ONE launch
(generalizing the reference's 1-frame-per-call contract to k frames, so
the launch cost is paid once per chunk).
The running max is still applied *sequentially* per frame — frame f is
colorized against the max over frames <= f — matching the reference's
frame-at-a-time semantics exactly even when k frames arrive in a batch.
"""

from __future__ import annotations

import threading

import numpy as np

from ..ops import stft as _stft
from ..ops import window as _window
from ..visual.spectrogram import Colormap, color_from_magnitude_u8

WIN_LEN = 1024
HOP = WIN_LEN // 2
FLOOR_DB = -80.0


class StreamingSpectrogram:
    """Stateful streaming spectrogram: ring buffer + chunked transform +
    running max (the streaming/stateful API contract from SURVEY.md §3.4)."""

    def __init__(self, win_len: int = WIN_LEN, hop: int = HOP,
                 floor_db: float = FLOOR_DB,
                 colormap: str = "rainbow"):
        self.win_len = win_len
        self.hop = hop
        self.floor_db = floor_db
        self._window = _window.hann(win_len)
        self._cmap = Colormap.parse(colormap)
        # one-sided: the spectrogram uses only win//2 bins, and the
        # real-input kernel path halves the FFT write traffic
        self._stream = _stft.StftPushStream(self._window, hop,
                                            onesided=True)
        self._max_mag = 1e-12
        # one state instance is shared across ThreadingHTTPServer handler
        # threads; without the lock two concurrent pushes race on the
        # ring buffer (dropped samples / double-drained hop)
        self._lock = threading.Lock()

    def set_colormap(self, name: str) -> None:
        with self._lock:
            self._cmap = Colormap.parse(name)

    def reset(self) -> None:
        with self._lock:
            self._stream = _stft.StftPushStream(self._window, self.hop,
                                                onesided=True)
            self._max_mag = 1e-12
            self._cmap = Colormap.RAINBOW

    def compute_frame(self, samples) -> np.ndarray:
        """Push samples; returns the RGBA rows of every frame the chunk
        completed — shape flattened (k * win_len//2 * 4,) uint8, empty
        when no frame completed. One device launch per call regardless
        of k. Thread-safe (serialized on the instance lock)."""
        s = np.asarray(samples, dtype=np.float32).ravel()
        with self._lock:
            return self._compute_frames_locked(s)

    def _compute_frames_locked(self, s) -> np.ndarray:
        fr, fi = self._stream.push(s)
        k = fr.shape[0]
        if k == 0:
            return np.zeros((0,), dtype=np.uint8)
        half = self.win_len // 2
        mags = np.sqrt(fr[:, :half] ** 2 + fi[:, :half] ** 2)  # (k, half)
        # sequential running max: frame f sees max over frames <= f
        row_max = np.maximum.accumulate(
            np.maximum(mags.max(axis=1, initial=0.0), self._max_mag))
        self._max_mag = float(row_max[-1])
        rgb = color_from_magnitude_u8(mags, row_max[:, None],
                                      self.floor_db, self._cmap)
        rows = np.concatenate(
            [rgb, np.full((k, half, 1), 255, np.uint8)], axis=-1)
        return rows.reshape(-1)
