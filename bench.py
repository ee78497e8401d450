"""kofft benchmark sweep (one GPU).

Prints the headline JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Headline metric: c32 FFT points/sec at 2^20, compared against the
reference's measured 59.265 ms/op on its benchmark host (BASELINE.md).
Detail records (FFT sizes, rfft, STFT frames/s, SNR) go to
benchmarks/latest.json (reference JSON-history workflow) and a summary
table to stderr. A wall-clock budget (env KOFFT_BENCH_BUDGET_S, default
900 s) skips the remaining detail sections once 80% is spent.

The run fails when JAX finds no GPU. Timing chains N applications of an
op in one executable and ends in ``block_until_ready``
(kofft_tpu.bench.harness).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_T0 = time.monotonic()
_BUDGET_S = float(os.environ.get("KOFFT_BENCH_BUDGET_S", "900"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def elapsed() -> float:
    return time.monotonic() - _T0


def _headline_doc(pts_per_sec: float, extra: dict | None = None) -> dict:
    kofft_baseline_pts = (1 << 20) / 59.265e-3  # BASELINE.md
    doc = {
        "metric": "c32_fft_2^20_points_per_sec_per_chip",
        "value": round(pts_per_sec, 1),
        "unit": "points/s",
        "vs_baseline": round(pts_per_sec / kofft_baseline_pts, 3),
    }
    if extra:
        doc.update(extra)
    return doc


class Budgeter:
    """Soft wall-clock gate for detail sections (layer 2): once 80% of
    the budget is spent, remaining sections are skipped with a note."""

    def __init__(self, budget_s: float):
        self.soft = 0.8 * budget_s
        self.skipped: list[str] = []

    def ok(self, name: str) -> bool:
        if elapsed() <= self.soft:
            return True
        self.skipped.append(name)
        log(f"budget: skipping section '{name}' "
            f"({elapsed():.0f}s > soft budget {self.soft:.0f}s)")
        return False


def _snr_rows_2d(x_r: np.ndarray, x_i: np.ndarray, yr, yi,
                 n_rows: int = 8) -> float:
    """Exact-f64 SNR on a subsample of output rows of a 2-D FFT.

    The full f64 fftn oracle of a 4096^2 image takes host-minutes;
    instead compute A = fft(x, axis=1) in c128 (cheap,
    row-wise) and the selected output rows exactly as W[k,:] @ A, where
    W is the n0-point DFT matrix restricted to the sampled rows.
    """
    from kofft_tpu.ops.dft import snr_db
    n0 = x_r.shape[0]
    ks = np.linspace(0, n0 - 1, n_rows).astype(np.int64)
    a = np.fft.fft(x_r.astype(np.complex128) + 1j * x_i, axis=1)
    w = np.exp(-2j * np.pi * ks[:, None] * np.arange(n0)[None, :] / n0)
    ref_rows = w @ a
    got = np.asarray(yr, np.float64)[ks] + 1j * np.asarray(yi, np.float64)[ks]
    return float(snr_db(ref_rows, got))


def _snr_rows_3d(x_r: np.ndarray, x_i: np.ndarray, yr, yi,
                 n_slabs: int = 4) -> float:
    """Exact-f64 SNR on a subsample of axis-0 output slabs of a 3-D FFT
    (same subsampled-oracle trick as :func:`_snr_rows_2d`)."""
    from kofft_tpu.ops.dft import snr_db
    n0 = x_r.shape[0]
    ks = np.linspace(0, n0 - 1, n_slabs).astype(np.int64)
    a = np.fft.fftn(x_r.astype(np.complex128) + 1j * x_i, axes=(1, 2))
    w = np.exp(-2j * np.pi * ks[:, None] * np.arange(n0)[None, :] / n0)
    ref = np.tensordot(w, a, axes=(1, 0))
    got = np.asarray(yr, np.float64)[ks] + 1j * np.asarray(yi, np.float64)[ks]
    return float(snr_db(ref, got))


def main() -> None:
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX platform is {devs[0].platform!r})")

    import kofft_tpu as kt
    from kofft_tpu.bench import (BenchRecord, check_snr_policy, run_history,
                                 timeit_chained, timeit_chained_scalar)
    from kofft_tpu.ops.dft import snr_db
    from kofft_tpu.ops import window as W
    from kofft_tpu.utils.observability import enable_compilation_cache
    from kofft_tpu.config import set_precision

    # the full sweep compiles ~40 executables; persist them so reruns
    # start warm
    enable_compilation_cache()

    budget = Budgeter(_BUDGET_S)
    platform = jax.default_backend()
    rng = np.random.default_rng(0)
    records = []

    # ---- headline FIRST: 2^20 c32 FFT --------------------------------
    # single-transform rows use RANK-1 operands (the reference benches
    # one Vec per op)
    n = 1 << 20
    xr = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    xi = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    t = timeit_chained(lambda p: kt.fft_split(p[0], p[1]), (xr, xi),
                       iters=200)
    pts_per_sec = n / t
    records.append(BenchRecord("kofft_tpu", "complex", n, "single",
                               t * 1e9, 1.0 / t, platform))
    log(f"c32 FFT 2^20: {t * 1e3:.3f} ms  ({pts_per_sec / 1e9:.3f} Gpts/s)"
        f"  [kofft 59.265 ms]")
    headline = _headline_doc(pts_per_sec, {
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)}})
    print(json.dumps(headline), flush=True)

    # competitor row (the reference benches vs rustfft; ours is jnp.fft)
    def jnpfft_planes(q):
        y = jnp.fft.fft(jax.lax.complex(q[0], q[1]))
        return jnp.real(y), jnp.imag(y)

    tj = timeit_chained(jnpfft_planes, (xr, xi), iters=200)
    records.append(BenchRecord("jnpfft", "complex", n, "single",
                               tj * 1e9, 1.0 / tj, platform))
    log(f"jnp.fft 2^20: {tj * 1e3:.3f} ms (competitor)")

    # ---- FFT size sweep (reference bench sizes subset) ---------------
    if budget.ok("size_sweep"):
        for p2 in (10, 12, 14, 16, 18):
            m = 1 << p2
            ar = jnp.asarray(rng.standard_normal(m).astype(np.float32))
            ai = jnp.asarray(rng.standard_normal(m).astype(np.float32))
            tm = timeit_chained(lambda q: kt.fft_split(q[0], q[1]), (ar, ai),
                                iters=400)
            records.append(BenchRecord("kofft_tpu", "complex", m, "single",
                                       tm * 1e9, 1.0 / tm, platform))
            log(f"c32 FFT 2^{p2}: {tm * 1e6:.1f} us")

    n22 = 1 << 22
    xr22 = jnp.asarray(rng.standard_normal(n22).astype(np.float32))
    xi22 = jnp.asarray(rng.standard_normal(n22).astype(np.float32))
    if budget.ok("pow2_22"):
        t22 = timeit_chained(lambda q: kt.fft_split(q[0], q[1]),
                             (xr22, xi22), iters=50)
        records.append(BenchRecord("kofft_tpu", "complex", n22, "single",
                                   t22 * 1e9, 1.0 / t22, platform))
        log(f"c32 FFT 2^22: {t22 * 1e3:.3f} ms "
            f"({n22 / t22 / 1e9:.3f} Gpts/s)")

    # large 1-D sizes beside XLA's FFT
    big_ops = {}
    for p2 in (23, 24, 25, 26):
        if not budget.ok(f"pow2_{p2}"):
            break
        nb = 1 << p2
        br_ = jnp.asarray(rng.standard_normal(nb).astype(np.float32))
        bi_ = jnp.asarray(rng.standard_normal(nb).astype(np.float32))
        tbig = timeit_chained(
            lambda q: tuple(a * 1e-3 for a in kt.fft_split(q[0], q[1])),
            (br_, bi_), iters=10)
        records.append(BenchRecord("kofft_tpu", "complex", nb, "single",
                                   tbig * 1e9, 1.0 / tbig, platform))
        tbigj = timeit_chained(
            lambda q: tuple(a * 1e-3 for a in jnpfft_planes(q)),
            (br_, bi_), iters=10)
        records.append(BenchRecord("jnpfft", "complex", nb, "single",
                                   tbigj * 1e9, 1.0 / tbigj, platform))
        if p2 <= 25:
            # kept for the default-tier leg below (2^26 operands are
            # dropped: 0.5 GB of planes and a heavy extra compile for
            # one more row)
            big_ops[p2] = (br_, bi_)
        else:
            del br_, bi_
        log(f"c32 FFT 2^{p2}: {tbig * 1e3:.3f} ms "
            f"({nb / tbig / 1e9:.3f} Gpts/s; jnp {tbigj * 1e3:.3f} ms)")

    # batched throughput row (the production-serving shape)
    bt = 8
    xrb = jnp.asarray(rng.standard_normal((bt, n)).astype(np.float32))
    xib = jnp.asarray(rng.standard_normal((bt, n)).astype(np.float32))
    m2, _ = kt.tiled_shape(n)
    art = xrb.reshape(bt, m2, m2)
    ait = xib.reshape(bt, m2, m2)
    if budget.ok("batched"):
        tb = timeit_chained(lambda q: kt.fft_split(q[0], q[1]), (xrb, xib),
                            iters=50)
        records.append(BenchRecord("kofft_tpu", "complex", n, "batch8",
                                   tb * 1e9, 1.0 / tb, platform))
        log(f"8x2^20 batched: {tb * 1e3:.3f} ms = "
            f"{bt * n / tb / 1e9:.2f} Gpts/s ({tb * 1e6 / bt:.1f} us/row)")

        # tiled pipeline row: same transform on pre-tiled (m, m) planes
        # (fft_split_tiled)
        tt = timeit_chained(lambda q: kt.fft_split_tiled(q[0], q[1]),
                            (art, ait), iters=50)
        records.append(BenchRecord("kofft_tpu", "complex", n, "batch8_tiled",
                                   tt * 1e9, 1.0 / tt, platform))
        log(f"8x2^20 tiled: {tt * 1e3:.3f} ms = "
            f"{bt * n / tt / 1e9:.2f} Gpts/s ({tt * 1e6 / bt:.1f} us/row)")

        # batched mid-size rows
        brm = jnp.asarray(
            rng.standard_normal((256, 1 << 14)).astype(np.float32))
        bim = jnp.asarray(
            rng.standard_normal((256, 1 << 14)).astype(np.float32))
        tbm = timeit_chained(lambda q: kt.fft_split(q[0], q[1]), (brm, bim))
        records.append(BenchRecord("kofft_tpu", "complex", 1 << 14,
                                   "batch256", tbm * 1e9, 1.0 / tbm,
                                   platform))
        log(f"256x2^14 batched: {tbm * 1e3:.3f} ms = "
            f"{256 * (1 << 14) / tbm / 1e9:.2f} Gpts/s")

    # N-D rows (one card)
    from kofft_tpu.ops.ndfft import fftn_split

    def jfftn(q):
        y = jnp.fft.fftn(jax.lax.complex(q[0], q[1]))
        return jnp.real(y), jnp.imag(y)

    if budget.ok("fft3d_128"):
        x3r = jnp.asarray(
            rng.standard_normal((128, 128, 128)).astype(np.float32))
        x3i = jnp.asarray(
            rng.standard_normal((128, 128, 128)).astype(np.float32))
        t3d = timeit_chained(lambda q: fftn_split(q[0], q[1]), (x3r, x3i))
        records.append(BenchRecord("kofft_tpu", "fft3d", 128 ** 3, "single",
                                   t3d * 1e9, 1.0 / t3d, platform))
        t3dj = timeit_chained(jfftn, (x3r, x3i))
        records.append(BenchRecord("jnpfft", "fft3d", 128 ** 3, "single",
                                   t3dj * 1e9, 1.0 / t3dj, platform))
        log(f"fft3 128^3: {t3d * 1e6:.1f} us (jnp {t3dj * 1e6:.1f} us)")

        # throughput tier (precision=default)
        try:
            set_precision("default")
            t3df = timeit_chained(lambda q: fftn_split(q[0], q[1]),
                                  (x3r, x3i))
            yr3, yi3 = fftn_split(x3r, x3i)
            ref3 = np.fft.fftn(np.asarray(x3r).astype(np.float64)
                               + 1j * np.asarray(x3i).astype(np.float64))
            s3 = float(snr_db(ref3, np.asarray(yr3) + 1j * np.asarray(yi3)))
            records.append(BenchRecord("kofft_tpu", "fft3d", 128 ** 3,
                                       "single_fast", t3df * 1e9, 1.0 / t3df,
                                       platform, snr_db=s3))
            log(f"fft3 128^3 default tier: {t3df * 1e6:.1f} us "
                f"({s3:.1f} dB)")
        finally:
            set_precision(None)

    # 2-D image FFT
    if budget.ok("fft2d_1024"):
        x2r = jnp.asarray(
            rng.standard_normal((1024, 1024)).astype(np.float32))
        x2i = jnp.asarray(
            rng.standard_normal((1024, 1024)).astype(np.float32))
        t2d = timeit_chained(lambda q: fftn_split(q[0], q[1]), (x2r, x2i))
        records.append(BenchRecord("kofft_tpu", "fft2d", 1024 ** 2, "single",
                                   t2d * 1e9, 1.0 / t2d, platform))
        t2dj = timeit_chained(jfftn, (x2r, x2i))
        records.append(BenchRecord("jnpfft", "fft2d", 1024 ** 2, "single",
                                   t2dj * 1e9, 1.0 / t2dj, platform))
        ref2 = np.fft.fftn(np.asarray(x2r).astype(np.float64)
                           + 1j * np.asarray(x2i).astype(np.float64))
        try:
            set_precision("default")
            t2df = timeit_chained(lambda q: fftn_split(q[0], q[1]),
                                  (x2r, x2i))
            yr2, yi2 = fftn_split(x2r, x2i)
            s2 = float(snr_db(ref2, np.asarray(yr2) + 1j * np.asarray(yi2)))
            records.append(BenchRecord("kofft_tpu", "fft2d", 1024 ** 2,
                                       "single_fast", t2df * 1e9, 1.0 / t2df,
                                       platform, snr_db=s2))
        finally:
            set_precision(None)
        log(f"fft2 1024^2: {t2d * 1e6:.1f} us (jnp {t2dj * 1e6:.1f} us); "
            f"default tier {t2df * 1e6:.1f} us ({s2:.1f} dB)")

    # 2048^2, both tiers
    if budget.ok("fft2d_2048"):
        x2r = jnp.asarray(
            rng.standard_normal((2048, 2048)).astype(np.float32))
        x2i = jnp.asarray(
            rng.standard_normal((2048, 2048)).astype(np.float32))
        t4h = timeit_chained(lambda q: fftn_split(q[0], q[1]), (x2r, x2i),
                             iters=50)
        records.append(BenchRecord("kofft_tpu", "fft2d", 2048 ** 2, "single",
                                   t4h * 1e9, 1.0 / t4h, platform))
        log(f"fft2 2048^2: {t4h * 1e6:.1f} us")
        try:
            set_precision("default")
            t4f = timeit_chained(lambda q: fftn_split(q[0], q[1]),
                                 (x2r, x2i), iters=50)
            yr4, yi4 = fftn_split(x2r, x2i)
            s4 = _snr_rows_2d(np.asarray(x2r), np.asarray(x2i), yr4, yi4)
            records.append(BenchRecord("kofft_tpu", "fft2d", 2048 ** 2,
                                       "single_fast", t4f * 1e9, 1.0 / t4f,
                                       platform, snr_db=s4))
        finally:
            set_precision(None)
        t4j = timeit_chained(jfftn, (x2r, x2i), iters=50)
        records.append(BenchRecord("jnpfft", "fft2d", 2048 ** 2, "single",
                                   t4j * 1e9, 1.0 / t4j, platform))
        log(f"fft2 2048^2 default tier: {t4f * 1e6:.1f} us ({s4:.1f} dB; "
            f"jnp {t4j * 1e6:.1f} us)")

    # 4096^2 (2^24 points), both tiers. SNR via the subsampled exact-row
    # oracle (a full f64 fftn here takes host-minutes).
    if budget.ok("fft2d_4096"):
        x2r = jnp.asarray(
            rng.standard_normal((4096, 4096)).astype(np.float32))
        x2i = jnp.asarray(
            rng.standard_normal((4096, 4096)).astype(np.float32))
        t5 = timeit_chained(lambda q: fftn_split(q[0], q[1]), (x2r, x2i),
                            iters=10)
        records.append(BenchRecord("kofft_tpu", "fft2d", 4096 ** 2, "single",
                                   t5 * 1e9, 1.0 / t5, platform))
        try:
            set_precision("default")
            t5f = timeit_chained(lambda q: fftn_split(q[0], q[1]),
                                 (x2r, x2i), iters=10)
            yr5, yi5 = fftn_split(x2r, x2i)
            s5 = _snr_rows_2d(np.asarray(x2r), np.asarray(x2i), yr5, yi5)
            records.append(BenchRecord("kofft_tpu", "fft2d", 4096 ** 2,
                                       "single_fast", t5f * 1e9, 1.0 / t5f,
                                       platform, snr_db=s5))
        finally:
            set_precision(None)
        t5j = timeit_chained(jfftn, (x2r, x2i), iters=10)
        records.append(BenchRecord("jnpfft", "fft2d", 4096 ** 2, "single",
                                   t5j * 1e9, 1.0 / t5j, platform))
        log(f"fft2 4096^2: {t5 * 1e6:.1f} us; default tier "
            f"{t5f * 1e6:.1f} us ({s5:.1f} dB; jnp {t5j * 1e6:.1f} us)")

    # 256^3. SNR via the subsampled exact-slab oracle.
    if budget.ok("fft3d_256"):
        x6r = jnp.asarray(
            rng.standard_normal((256, 256, 256)).astype(np.float32))
        x6i = jnp.asarray(
            rng.standard_normal((256, 256, 256)).astype(np.float32))
        t6 = timeit_chained(lambda q: fftn_split(q[0], q[1]), (x6r, x6i),
                            iters=10)
        records.append(BenchRecord("kofft_tpu", "fft3d", 256 ** 3, "single",
                                   t6 * 1e9, 1.0 / t6, platform))
        try:
            set_precision("default")
            t6f = timeit_chained(lambda q: fftn_split(q[0], q[1]),
                                 (x6r, x6i), iters=10)
            yr6, yi6 = fftn_split(x6r, x6i)
            s6c = _snr_rows_3d(np.asarray(x6r), np.asarray(x6i), yr6, yi6)
            records.append(BenchRecord("kofft_tpu", "fft3d", 256 ** 3,
                                       "single_fast", t6f * 1e9, 1.0 / t6f,
                                       platform, snr_db=s6c))
        finally:
            set_precision(None)
        t6j = timeit_chained(jfftn, (x6r, x6i), iters=10)
        records.append(BenchRecord("jnpfft", "fft3d", 256 ** 3, "single",
                                   t6j * 1e9, 1.0 / t6j, platform))
        log(f"fft3 256^3: {t6 * 1e6:.1f} us; default tier "
            f"{t6f * 1e6:.1f} us ({s6c:.1f} dB; jnp {t6j * 1e6:.1f} us)")

    # ---- real FFT 2^20. Ping-pong chain (outputs rebuilt into the next
    # real input via one concat) so the row is methodology-matched with
    # the complex row above ---
    xrr = jnp.asarray(rng.standard_normal(n).astype(np.float32))

    def rfft_pp(a):
        yr, yi = kt.rfft_split(a)
        nxt = jnp.concatenate([yr[..., : n // 2], yi[..., : n // 2]],
                              axis=-1) * 1e-3
        return (nxt,)

    if budget.ok("rfft"):
        trfft = timeit_chained(lambda p: rfft_pp(p[0]), (xrr,), iters=100)
        records.append(BenchRecord("kofft_tpu", "real", n, "single",
                                   trfft * 1e9, 1.0 / trfft, platform))
        log(f"rfft 2^20: {trfft * 1e3:.3f} ms  [kofft 66.946 ms]")

    # ---- smooth non-pow2 sizes ----------------------------------------
    # coverage between "pow2" and "Bluestein"
    if budget.ok("smooth"):
        for ns in (3 << 18, 5 << 16, 10 ** 6):
            sr = jnp.asarray(rng.standard_normal(ns).astype(np.float32))
            si = jnp.asarray(rng.standard_normal(ns).astype(np.float32))
            ts = timeit_chained(
                lambda q: tuple(a * 1e-3 for a in kt.fft_split(q[0], q[1])),
                (sr, si), iters=50)
            records.append(BenchRecord("kofft_tpu", "complex", ns, "single",
                                       ts * 1e9, 1.0 / ts, platform))
            tsj = timeit_chained(
                lambda q: tuple(a * 1e-3 for a in jnpfft_planes(q)),
                (sr, si), iters=50)
            records.append(BenchRecord("jnpfft", "complex", ns, "single",
                                       tsj * 1e9, 1.0 / tsj, platform))
            log(f"smooth n={ns}: {ts * 1e6:.1f} us (jnp {tsj * 1e6:.1f} us)")

    # ---- throughput tier: precision=default ---------------------------
    # an SNR-annotated tier so the trade is regression-tracked
    if budget.ok("default_tier"):
        try:
            set_precision("default")
            td = timeit_chained(
                lambda q: tuple(a * 1e-3 for a in kt.fft_split(q[0], q[1])),
                (xr, xi), iters=100)
            dyr, dyi = kt.fft_split(xr, xi)
            dref = np.fft.fft(np.asarray(xr).astype(np.float64)
                              + 1j * np.asarray(xi).astype(np.float64))
            dsnr = float(snr_db(dref,
                                np.asarray(dyr) + 1j * np.asarray(dyi)))
            records.append(BenchRecord("kofft_tpu", "complex", n,
                                       "single_fast", td * 1e9, 1.0 / td,
                                       platform, snr_db=dsnr))
            tdr = timeit_chained(lambda p: rfft_pp(p[0]), (xrr,), iters=100)
            rr_, ri_ = kt.rfft_split(xrr)
            rsnr = float(snr_db(
                np.fft.rfft(np.asarray(xrr).astype(np.float64)),
                np.asarray(rr_) + 1j * np.asarray(ri_)))
            records.append(BenchRecord("kofft_tpu", "real", n, "single_fast",
                                       tdr * 1e9, 1.0 / tdr, platform,
                                       snr_db=rsnr))
            log(f"default-precision tier 2^20: complex {td * 1e6:.1f} us, "
                f"rfft {tdr * 1e6:.1f} us, SNR {dsnr:.1f} dB")
            # the production-serving batched shape on the throughput tier
            tdb = timeit_chained(lambda q: kt.fft_split(q[0], q[1]),
                                 (xrb, xib), iters=30)
            byr, byi = kt.fft_split(xrb, xib)
            bsnr = float(snr_db(
                np.fft.fft(np.asarray(xrb)[0].astype(np.float64)
                           + 1j * np.asarray(xib)[0].astype(np.float64)),
                np.asarray(byr)[0] + 1j * np.asarray(byi)[0]))
            records.append(BenchRecord("kofft_tpu", "complex", n,
                                       "batch8_fast", tdb * 1e9, 1.0 / tdb,
                                       platform, snr_db=bsnr))
            log(f"8x2^20 default tier: {tdb * 1e3:.3f} ms = "
                f"{bt * n / tdb / 1e9:.2f} Gpts/s "
                f"({tdb * 1e6 / bt:.1f} us/row)")
            # bf16-plane pipeline form on pre-tiled operands
            artb = art.astype(jnp.bfloat16)
            aitb = ait.astype(jnp.bfloat16)
            tdbt = timeit_chained(lambda q: kt.fft_split_tiled(q[0], q[1]),
                                  (artb, aitb), iters=30)
            tyr, tyi = kt.fft_split_tiled(artb, aitb)
            tbsnr = float(snr_db(
                np.fft.fft((np.asarray(art, np.float64)
                            + 1j * np.asarray(ait, np.float64)
                            ).reshape(bt, n)[0]),
                (np.asarray(tyr, np.float64)
                 + 1j * np.asarray(tyi, np.float64)).reshape(bt, n)[0]))
            records.append(BenchRecord("kofft_tpu", "complex", n,
                                       "batch8_tiled_bf16", tdbt * 1e9,
                                       1.0 / tdbt, platform, snr_db=tbsnr))
            log(f"8x2^20 tiled bf16 default: {tdbt * 1e3:.3f} ms = "
                f"{tdbt * 1e6 / bt:.1f} us/row ({tbsnr:.1f} dB)")
            # 2^22 on the throughput tier
            td22 = timeit_chained(
                lambda q: tuple(a * 1e-3 for a in kt.fft_split(q[0], q[1])),
                (xr22, xi22), iters=50)
            d22r, d22i = kt.fft_split(xr22, xi22)
            s22 = float(snr_db(
                np.fft.fft(np.asarray(xr22).astype(np.complex128)
                           + 1j * np.asarray(xi22)),
                np.asarray(d22r, np.float64)
                + 1j * np.asarray(d22i, np.float64)))
            records.append(BenchRecord("kofft_tpu", "complex", n22,
                                       "single_fast", td22 * 1e9, 1.0 / td22,
                                       platform, snr_db=s22))
            log(f"2^22 default tier: {td22 * 1e6:.1f} us = "
                f"{n22 / td22 / 1e9:.2f} Gpts/s ({s22:.1f} dB)")
            # 2^23/2^24 on the throughput tier
            for p2 in sorted(big_ops):
                nb = 1 << p2
                br_, bi_ = big_ops[p2]
                tdb_ = timeit_chained(
                    lambda q: tuple(a * 1e-3
                                    for a in kt.fft_split(q[0], q[1])),
                    (br_, bi_), iters=10)
                dbr, dbi = kt.fft_split(br_, bi_)
                sb_ = float(snr_db(
                    np.fft.fft(np.asarray(br_).astype(np.complex128)
                               + 1j * np.asarray(bi_)),
                    np.asarray(dbr, np.float64)
                    + 1j * np.asarray(dbi, np.float64)))
                records.append(BenchRecord("kofft_tpu", "complex", nb,
                                           "single_fast", tdb_ * 1e9,
                                           1.0 / tdb_, platform, snr_db=sb_))
                log(f"2^{p2} default tier: {tdb_ * 1e6:.1f} us = "
                    f"{nb / tdb_ / 1e9:.2f} Gpts/s ({sb_:.1f} dB)")
            # large-odd smooth class on the throughput tier (the d=2
            # dense route)
            n6 = 10 ** 6
            s6r = jnp.asarray(rng.standard_normal(n6).astype(np.float32))
            s6i = jnp.asarray(rng.standard_normal(n6).astype(np.float32))
            td6 = timeit_chained(
                lambda q: tuple(a * 1e-3 for a in kt.fft_split(q[0], q[1])),
                (s6r, s6i), iters=50)
            d6r, d6i = kt.fft_split(s6r, s6i)
            s6 = float(snr_db(
                np.fft.fft(np.asarray(s6r).astype(np.complex128)
                           + 1j * np.asarray(s6i)),
                np.asarray(d6r, np.float64)
                + 1j * np.asarray(d6i, np.float64)))
            records.append(BenchRecord("kofft_tpu", "complex", n6,
                                       "single_fast", td6 * 1e9, 1.0 / td6,
                                       platform, snr_db=s6))
            log(f"10^6 default tier: {td6 * 1e6:.1f} us = "
                f"{n6 / td6 / 1e9:.2f} Gpts/s ({s6:.1f} dB)")
        finally:
            set_precision(None)

    # ---- STFT frames/s -------------------------------------------------
    if budget.ok("stft"):
        win, hop = 1024, 256
        sig = jnp.asarray(rng.standard_normal((1 << 20,)).astype(np.float32))
        w = W.hann(win)
        f_stft = jax.jit(lambda s: kt.stft_split(s, w, hop, onesided=True))
        jax.block_until_ready(f_stft(sig))

        def stft_step(s, acc):
            fr, fi = kt.stft_split(s * (1.0 + 1e-9 * acc), w, hop,
                                   onesided=True)
            return acc + fr[0, 0] * 1e-20

        tstft = timeit_chained_scalar(stft_step, sig)
        nframes = (1 << 20) // hop
        records.append(BenchRecord("kofft_tpu", "stft_frames", nframes,
                                   "single", tstft * 1e9 / nframes,
                                   nframes / tstft, platform))
        log(f"STFT 2^20 samples (win={win}, hop={hop}): "
            f"{tstft * 1e3:.3f} ms = {nframes / tstft / 1e6:.2f} Mframes/s")

        # inverse (overlap-add) leg of the config-#3 pipeline
        sfr, sfi = kt.stft_split(np.asarray(sig), w, hop, onesided=False)
        sfr = jnp.asarray(np.asarray(sfr))
        sfi = jnp.asarray(np.asarray(sfi))

        def istft_step(p, acc):
            a, b2 = p
            y = kt.istft_split(a * (1.0 + 1e-9 * acc), b2, w, hop,
                               length=1 << 20)
            return acc + y[0] * 1e-20

        tistft = timeit_chained_scalar(istft_step, (sfr, sfi))
        records.append(BenchRecord("kofft_tpu", "istft_frames", nframes,
                                   "single", tistft * 1e9 / nframes,
                                   nframes / tistft, platform))
        log(f"ISTFT 2^20 samples: {tistft * 1e3:.3f} ms "
            f"= {nframes / tistft / 1e6:.2f} Mframes/s")

        # throughput tier for the config-#3 workload. SNR columns: STFT
        # spectra vs the f64 numpy oracle; ISTFT reconstruction vs the
        # original signal (roundtrip).
        try:
            set_precision("default")
            tstft_d = timeit_chained_scalar(stft_step, sig)
            s64 = np.asarray(sig).astype(np.float64)
            pad64 = np.zeros((nframes + win // hop - 1) * hop)
            pad64[: 1 << 20] = s64
            fidx = (np.arange(nframes)[:, None] * hop
                    + np.arange(win)[None, :])
            st64 = np.fft.rfft(pad64[fidx] * np.asarray(w, dtype=np.float64))
            dfr, dfi = kt.stft_split(np.asarray(sig), w, hop, onesided=True)
            stsnr = float(snr_db(st64,
                                 np.asarray(dfr) + 1j * np.asarray(dfi)))
            records.append(BenchRecord(
                "kofft_tpu", "stft_frames", nframes, "single_fast",
                tstft_d * 1e9 / nframes, nframes / tstft_d, platform,
                snr_db=stsnr))
            tistft_d = timeit_chained_scalar(istft_step, (sfr, sfi))
            yrec = kt.istft_split(np.asarray(sfr), np.asarray(sfi), w, hop,
                                  length=1 << 20)
            # the hann edge sample (w[0] = 0) is unrecoverable, so the
            # full round trip depends on the draw; the interior SNR is
            # the policy-asserted row
            recsnr = float(snr_db(s64, np.asarray(yrec)))
            intsnr = float(snr_db(s64[win:-win],
                                  np.asarray(yrec)[win:-win]))
            records.append(BenchRecord(
                "kofft_tpu", "istft_frames", nframes, "single_fast",
                tistft_d * 1e9 / nframes, nframes / tistft_d, platform,
                snr_db=recsnr))
            records.append(BenchRecord(
                "kofft_tpu", "istft_frames", nframes,
                "single_fast_interior", tistft_d * 1e9 / nframes,
                nframes / tistft_d, platform, snr_db=intsnr))
            log(f"default tier: STFT {tstft_d * 1e3:.3f} ms "
                f"({nframes / tstft_d / 1e6:.2f} Mframes/s, {stsnr:.1f} dB), "
                f"ISTFT {tistft_d * 1e3:.3f} ms "
                f"(roundtrip {recsnr:.1f} dB, interior {intsnr:.1f} dB)")
        finally:
            set_precision(None)

    # ---- rfft + DCT-II/DST-II over 4096x1024 real
    # frames (examples/rfft_usage.rs, dct_usage.rs workload shape) --------
    if budget.ok("frame_suite"):
        from kofft_tpu.ops import dct as DCT, dst as DST
        frames = jnp.asarray(
            rng.standard_normal((4096, 1024)).astype(np.float32))

        def frame_suite_step(a, acc):
            ar = a * (1.0 + 1e-9 * acc)
            yr, yi = kt.rfft_split(ar)
            d2 = DCT.dct2(ar)
            s2_ = DST.dst2(ar)
            return acc + (yr[0, 0] + d2[0, 0] + s2_[0, 0]) * 1e-20

        tfs = timeit_chained_scalar(frame_suite_step, frames)
        records.append(BenchRecord("kofft_tpu", "rfft+dct2+dst2", 1024,
                                   "batch4096", tfs * 1e9, 1.0 / tfs,
                                   platform))
        log(f"rfft+DCT-II+DST-II 4096x1024 frames: {tfs * 1e3:.3f} ms")

    # ---- Bluestein + CZT + Goertzel + wavelet suite -
    if budget.ok("czt_suite"):
        from kofft_tpu.ops.czt import czt_fast
        from kofft_tpu.ops.goertzel import goertzel_bins
        from kofft_tpu.ops.wavelet import wavelet_forward
        sig_np = rng.standard_normal((1 << 16,)).astype(np.float32)
        prime_r = jnp.asarray(
            rng.standard_normal((1, 4099)).astype(np.float32))
        prime_i = jnp.asarray(
            rng.standard_normal((1, 4099)).astype(np.float32))
        tblu = timeit_chained(lambda q: kt.fft_split(q[0], q[1]),
                              (prime_r, prime_i))
        records.append(BenchRecord("kofft_tpu", "bluestein", 4099, "single",
                                   tblu * 1e9, 1.0 / tblu, platform))
        sj = jnp.asarray(sig_np)

        czt_w = complex(np.exp(-2j * np.pi / (1 << 16)))

        def suite_step(a, acc):
            ar = a * (1.0 + 1e-9 * acc)
            c = czt_fast(ar, 1 << 10, czt_w)
            g = goertzel_bins(ar, range(1, 33))
            lo, hi = wavelet_forward(ar, "db4")
            return acc + (jnp.real(c)[0] + g[0] + lo[0] + hi[0]) * 1e-20

        tsuite = timeit_chained_scalar(suite_step, sj)
        records.append(BenchRecord("kofft_tpu", "czt+goertzel+wavelet",
                                   1 << 16, "single", tsuite * 1e9,
                                   1.0 / tsuite, platform))
        log(f"Bluestein 4099: {tblu * 1e6:.1f} us; "
            f"CZT+Goertzel+db4 suite 2^16: {tsuite * 1e3:.3f} ms")

    # ---- SNR gate (quality guard on the headline path) ----------------
    small = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
             ).astype(np.complex64)
    got = kt.asnumpy(kt.fft(small))
    snr = snr_db(np.fft.fft(small.astype(np.complex128)), got)
    log(f"SNR 4096 vs f64: {snr:.1f} dB")

    # ---- SNR tier policy: every annotated row must clear its floor ----
    check_snr_policy(records)
    log("SNR tier policy: all annotated rows clear their floors")

    run_history(records)
    if budget.skipped:
        log(f"budget: sections skipped this run: {budget.skipped}")
    log(f"bench completed in {elapsed():.0f}s "
        f"(budget {_BUDGET_S:.0f}s, {len(records)} records)")


if __name__ == "__main__":
    main()
