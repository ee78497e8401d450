"""Basic FFT usage (reference examples/basic_usage.rs analog):
1024-point c32 FFT + ifft round-trip — BASELINE.json config #1."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import kofft_tpu as kt

rng = np.random.default_rng(0)
x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
     ).astype(np.complex64)

spectrum = kt.fft(x)
back = kt.asnumpy(kt.ifft(spectrum))
err = np.abs(back - x).max()
print(f"1024-pt fft→ifft roundtrip max err: {err:.2e}")

# planes (SoA) API — the engine's native calling convention
yr, yi = kt.fft_split(np.ascontiguousarray(x.real),
                      np.ascontiguousarray(x.imag))
print(f"one-sided energy: {float((np.asarray(yr)**2 + np.asarray(yi)**2).sum()):.3f}")

# plan API for repeated transforms
plan = kt.FftPlan(1024).warmup()
yr, yi = plan(np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
print("plan:", plan)
