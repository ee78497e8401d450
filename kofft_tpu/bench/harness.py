"""Timing + JSON-history benchmark harness.

``timeit_chained`` runs N dependency-chained applications of an op inside
one executable (``lax.fori_loop``) and times the call with
``block_until_ready``: one launch per N ops, so the per-op time is not
dominated by host dispatch at small sizes. (The reference's criterion
harness plays the allocation/variance role of this file,
``bench_fft.rs:106-297``.)
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Optional

import jax
import jax.numpy as jnp


def _per_op(chained: Callable, operand, iters: int, reps: int) -> float:
    """Best-of-``reps`` seconds per op of ``chained(operand)``, which runs
    ``iters`` ops; the first call compiles and warms."""
    jax.block_until_ready(chained(operand))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(operand))
        best = min(best, time.perf_counter() - t0)
    return best / iters


def timeit_chained(fn: Callable, operand, iters: int = 20,
                   reps: int = 3) -> float:
    """Per-op seconds for ``fn(pytree) -> pytree`` of identical
    structure/shapes/dtypes, chained ``iters`` times in one executable."""
    @jax.jit
    def chained(a):
        return jax.lax.fori_loop(0, iters, lambda _, acc: fn(acc), a)

    return _per_op(chained, operand, iters, reps)


def timeit_chained_scalar(step: Callable, operand, iters: int = 20,
                          reps: int = 3) -> float:
    """Chained timing for ops whose output shape differs from the input
    (rfft, stft, ...): ``step(operand, acc) -> acc`` must fold the op's
    output into a float32 scalar carry that perturbs the next
    iteration's input, forming the data-dependency chain."""
    @jax.jit
    def chained(a):
        return jax.lax.fori_loop(
            0, iters, lambda _, acc: step(a, acc), jnp.float32(0.0))

    return _per_op(chained, operand, iters, reps)


@dataclasses.dataclass
class BenchRecord:
    """Schema mirrors the reference BenchRecord (``bench_fft.rs:70-101``)
    with device fields added (SURVEY.md §5.5)."""
    library: str
    transform: str
    size: int
    mode: str
    time_per_op_ns: float
    ops_per_sec: float
    platform: str = ""
    n_devices: int = 1
    prev_time_per_op_ns: Optional[float] = None
    change_vs_prev: Optional[float] = None
    best: bool = False
    # accuracy column for precision-tier rows (vs the f64 oracle):
    # recording SNR beside the time makes the tier's trade visible
    snr_db: Optional[float] = None

    def to_dict(self):
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------
# SNR tier policy: what each precision tier GUARANTEES per transform,
# asserted on every bench run so a tier regression fails the row instead
# of drifting silently. Floors sit about 3 dB under the values measured
# on an H100 80GB HBM3 at 700 W (white data vs the f64 oracle) to absorb
# data/seed variance, NOT regressions. On that card the 'default' tier
# runs the tensor cores at TF32 (~65 dB at 2^20) and 'high' is no more
# precise. The analog of the reference's explicit tolerance policy
# (src/lib.rs:408-429).
#
#   tier      transform           floor dB   measured (H100)
#   default   complex 1-D         62         65.1 single / 65.1 batch
#   default   bf16 tiled planes   49         52.4
#   default   real 1-D            62         65.8
#   default   2-D                 63         66.6 (1024^2, 2048^2), 66.5 (4096^2)
#   default   3-D                 60         63.7 (128^3), 63.6 (256^3)
#   default   STFT forward        66         69.6
#   default   ISTFT roundtrip     45         48.1 (draw-dependent, below)
#   default   ISTFT interior      72         75.7 (2^20), 72.1 (smoke)
#   highest   everything          120        126-138 (chip_smoke.py,
#                                            not per bench row)
# --------------------------------------------------------------------------

SNR_POLICY_DB = {
    ("complex", "single_fast"): 62.0,
    ("complex", "batch8_fast"): 62.0,
    # bf16 planes both sides: bf16's output quantization stacks on the
    # tier's error
    ("complex", "batch8_tiled_bf16"): 49.0,
    ("real", "single_fast"): 62.0,
    ("fft2d", "single_fast"): 63.0,
    ("fft3d", "single_fast"): 60.0,
    ("stft_frames", "single_fast"): 66.0,
    # roundtrip SNR is dominated by the unrecoverable hann edge sample
    # (w[0] = 0, error = |x[0]| of that draw), so it swings with the
    # signal draw; the floor sits safely below that variance
    ("istft_frames", "single_fast"): 45.0,
    # INTERIOR roundtrip SNR (edge windows excluded) is the stable
    # tier-quality guarantee and the regression tripwire the
    # full-roundtrip number cannot be
    ("istft_frames", "single_fast_interior"): 72.0,
}


def check_snr_policy(records: list[BenchRecord]) -> None:
    """Assert every SNR-annotated row clears its tier floor (fail the
    bench run loudly rather than record a silent quality regression)."""
    bad = []
    for r in records:
        if r.snr_db is None:
            continue
        floor = SNR_POLICY_DB.get((r.transform, r.mode))
        if floor is not None and r.snr_db < floor:
            bad.append(f"{r.transform}/{r.mode} n={r.size}: "
                       f"{r.snr_db:.1f} dB < policy floor {floor:.1f}")
    if bad:
        raise AssertionError("SNR tier policy violated:\n  "
                             + "\n  ".join(bad))


def card_info() -> dict:
    """Name and power limit of each visible GPU, from ``nvidia-smi``
    (a child process that stays off JAX); empty where there is none."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    rows = [ln.split(",") for ln in out.strip().splitlines() if ln]
    return {"gpu": [r[0].strip() for r in rows],
            "power_limit": [r[1].strip() for r in rows if len(r) > 1]}


def run_history(records: list[BenchRecord],
                out_dir: str | Path = "benchmarks") -> dict:
    """Write latest.json, rotating the old latest to previous.json and
    computing change_vs_prev per (library, transform, size, mode) against
    a previous run on the same device kind — the reference's
    JSON-history workflow (``bench_fft.rs:69-103``, ``:439``)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    latest_p = out / "latest.json"
    prev_p = out / "previous.json"
    kind = jax.devices()[0].device_kind
    prev_map = {}
    if latest_p.exists():
        old = json.loads(latest_p.read_text())
        prev_p.write_text(json.dumps(old, indent=1))
        if old.get("environment", {}).get("device_kind") == kind:
            for r in old.get("records", []):
                key = (r["library"], r["transform"], r["size"], r["mode"])
                prev_map[key] = r["time_per_op_ns"]
    for r in records:
        key = (r.library, r.transform, r.size, r.mode)
        if key in prev_map:
            r.prev_time_per_op_ns = prev_map[key]
            r.change_vs_prev = ((r.time_per_op_ns - prev_map[key])
                                / prev_map[key])
    from ..config import get_config
    cfg = get_config()
    doc = {
        "environment": {
            "platform": jax.default_backend(),
            "device_kind": kind,
            "device_count": len(jax.devices()),
            **card_info(),
            "jax_version": jax.__version__,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            # run-defining tunables, so results are reproducible
            "backend": cfg.backend,
            "precision": cfg.precision,
            "shard_threshold": cfg.shard_threshold,
            "dft_cutoff": cfg.dft_cutoff,
            "overlap_chunks": cfg.overlap_chunks,
        },
        "records": [r.to_dict() for r in records],
    }
    latest_p.write_text(json.dumps(doc, indent=1))
    return doc
