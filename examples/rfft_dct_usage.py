"""Real FFT + DCT/DST batch usage (reference examples/rfft_usage.rs and
dct_usage.rs analogs) — BASELINE.json config #2: rfft + DCT-II/DST-II over
4096x1024-sample real frames."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import kofft_tpu as kt

rng = np.random.default_rng(0)
frames = rng.standard_normal((4096, 1024)).astype(np.float32)

spec = kt.rfft(frames)                       # (4096, 513) one-sided
print("rfft:", np.asarray(spec).shape)

back = np.asarray(kt.irfft(spec, n=1024))
print(f"irfft roundtrip max err: {np.abs(back - frames).max():.2e}")

c2 = kt.dct(frames, 2)                       # DCT-II (cosine-matrix matmul)
d2 = kt.dst(frames, 2)                       # DST-II
rec = np.asarray(kt.idct(c2, 2))
print(f"dct2/idct2 roundtrip max err: {np.abs(rec - frames).max():.2e}")
print("dst2:", np.asarray(d2).shape)
