"""Mesh-sharded transforms (reference examples/parallel_benchmark.rs
analog): distributed N-D FFT, distributed single long FFT, frame-sharded
STFT/ISTFT, and the auto dispatch gate — on whatever devices are present
(run with XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu for an 8-virtual-device mesh on one host)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

import kofft_tpu as kt
from kofft_tpu.ops import window as W
from kofft_tpu.parallel import (fft_auto, fft_sharded, fftn_sharded,
                                istft_auto, make_mesh, should_shard,
                                stft_sharded)

d = len(jax.devices())
print(f"devices: {d} x {jax.default_backend()}")
rng = np.random.default_rng(0)

if d > 1:
    mesh = make_mesh(d)

    # distributed 3-D FFT: pencil decomposition over two all_to_alls
    shape = (d * 8, 16, d * 4)
    xr = rng.standard_normal(shape).astype(np.float32)
    yr, yi = fftn_sharded(xr, np.zeros_like(xr), mesh=mesh)
    ref = np.fft.fftn(xr.astype(np.complex128))
    got = np.asarray(yr) + 1j * np.asarray(yi)
    print(f"fftn_sharded {shape}: max err "
          f"{np.abs(got - ref).max() / np.abs(ref).max():.2e}")

    # one long signal too big for a chip: distributed four-step
    n = d * d * 64
    zr, zi = fft_sharded(rng.standard_normal(n).astype(np.float32),
                         np.zeros(n, np.float32), mesh=mesh,
                         restore_layout=True)
    print(f"fft_sharded n={n}: output sharded over "
          f"{len(zr.sharding.device_set)} devices")

    # frame-sharded STFT with ppermute halo exchange
    win, hop = 64, 16
    sig = rng.standard_normal(d * 8 * hop).astype(np.float32)
    fr, fi = stft_sharded(sig, W.hann(win), hop, mesh=mesh)
    print(f"stft_sharded: frames {fr.shape} sharded over the mesh")

    # comm/compute overlap: K independent chunk chains per stage, so
    # chunk k+1's all_to_all flies during chunk k's DFT
    n = (2 * d) ** 2
    sigr = rng.standard_normal(n).astype(np.float32)
    or_, oi_ = fft_sharded(sigr, np.zeros(n, np.float32), mesh=mesh,
                           restore_layout=True, overlap=2)
    base_r, _ = fft_sharded(sigr, np.zeros(n, np.float32), mesh=mesh,
                            restore_layout=True)
    err = np.abs(np.asarray(or_) - np.asarray(base_r)).max()
    print(f"fft_sharded overlap=2: matches sequential to {err:.2e}")

    # two-level (slice, chip) hierarchy: every re-pencil runs as an
    # intra-slice (ICI) then inter-slice (DCN) all_to_all
    if d >= 4 and d % 2 == 0:
        from kofft_tpu.parallel import fft_sharded_hier, make_hier_mesh
        hm = make_hier_mesh(2, d // 2)
        hr, hi = fft_sharded_hier(sigr, np.zeros(n, np.float32), mesh=hm)
        err = np.abs(np.asarray(hr) - np.asarray(base_r)).max()
        print(f"fft_sharded_hier (2, {d // 2}): matches flat to {err:.2e}")

# auto dispatch: the points-per-chip gate decides single-chip vs sharded
# (the reference's Rayon threshold heuristic, src/fft.rs:244-307)
n = 1 << 12
print(f"should_shard({n} pts, {d} dev) -> {should_shard(n, d)}")
ar, ai = fft_auto(rng.standard_normal(n).astype(np.float32),
                  np.zeros(n, np.float32))
print(f"fft_auto: {np.asarray(ar).shape} on "
      f"{len(ar.sharding.device_set)} device(s)")
