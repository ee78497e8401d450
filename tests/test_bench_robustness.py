"""Tests for bench.py's pure logic: the headline document, the
wall-clock Budgeter, the refusal to run without a GPU, and the
subsampled SNR oracles — all off-chip."""

from __future__ import annotations

import numpy as np
import pytest

import bench


def test_headline_doc_schema_and_baseline_math():
    doc = bench._headline_doc(7.5e9)
    assert doc["metric"] == "c32_fft_2^20_points_per_sec_per_chip"
    assert doc["unit"] == "points/s"
    # vs_baseline is against the reference's measured 59.265 ms/op at
    # 2^20 (BASELINE.md:72)
    expected = 7.5e9 / ((1 << 20) / 59.265e-3)
    assert doc["vs_baseline"] == pytest.approx(expected, rel=1e-3)
    tagged = bench._headline_doc(1.0e9, {"device": {"count": 1}})
    assert tagged["device"] == {"count": 1}


def test_budgeter_soft_gate(monkeypatch):
    b = bench.Budgeter(100.0)  # soft gate at 80 s
    monkeypatch.setattr(bench, "elapsed", lambda: 10.0)
    assert b.ok("early_section")
    assert b.skipped == []
    monkeypatch.setattr(bench, "elapsed", lambda: 81.0)
    assert not b.ok("late_section")
    assert not b.ok("later_section")
    assert b.skipped == ["late_section", "later_section"]


def test_bench_refuses_without_gpu():
    """On a host without a GPU the sweep stops before measuring anything
    (it never falls back to the CPU)."""
    with pytest.raises(SystemExit, match="no GPU"):
        bench.main()


def _snr_full(x, y):
    err = np.abs(y - x) ** 2
    return 10.0 * np.log10(np.sum(np.abs(x) ** 2) / np.sum(err))


def test_snr_rows_2d_subsampled_oracle_matches_full():
    # the subsampled exact-row oracle (used where the full f64 fftn of a
    # 4096^2 image is host-minutes) must agree with the full oracle on a
    # size where the full oracle is cheap
    rng = np.random.default_rng(3)
    n = 64
    xr = rng.standard_normal((n, n)).astype(np.float32)
    xi = rng.standard_normal((n, n)).astype(np.float32)
    full = np.fft.fftn(xr.astype(np.complex128) + 1j * xi)
    # a "measured" output: the exact spectrum plus white f32-scale noise
    noise = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    got = full + 1e-6 * noise * np.sqrt(np.mean(np.abs(full) ** 2))
    s_sub = bench._snr_rows_2d(xr, xi, got.real, got.imag, n_rows=16)
    s_full = _snr_full(full, got)
    assert s_sub == pytest.approx(s_full, abs=3.0)  # dB, subsample jitter


def test_snr_rows_3d_subsampled_oracle_matches_full():
    rng = np.random.default_rng(4)
    n = 16
    xr = rng.standard_normal((n, n, n)).astype(np.float32)
    xi = rng.standard_normal((n, n, n)).astype(np.float32)
    full = np.fft.fftn(xr.astype(np.complex128) + 1j * xi)
    noise = (rng.standard_normal(full.shape)
             + 1j * rng.standard_normal(full.shape))
    got = full + 1e-6 * noise * np.sqrt(np.mean(np.abs(full) ** 2))
    s_sub = bench._snr_rows_3d(xr, xi, got.real, got.imag, n_slabs=8)
    s_full = _snr_full(full, got)
    assert s_sub == pytest.approx(s_full, abs=3.0)


def test_snr_rows_2d_exact_output_is_near_lossless():
    rng = np.random.default_rng(5)
    n = 32
    xr = rng.standard_normal((n, n)).astype(np.float32)
    xi = rng.standard_normal((n, n)).astype(np.float32)
    full = np.fft.fftn(xr.astype(np.complex128) + 1j * xi)
    s = bench._snr_rows_2d(xr, xi, full.real, full.imag, n_rows=8)
    assert s > 200.0  # exact rows -> only the oracle's own rounding
