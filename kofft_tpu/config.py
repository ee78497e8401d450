"""Configuration system: env vars + runtime setters + feature booleans.

The reference has a three-layer config (SURVEY.md §5.6):
  * compile-time cargo features          -> here: config booleans,
  * process env ``KOFFT_PAR_FFT_*``       -> here: ``KOFFT_TPU_*`` env vars
    read once at import (reference reads via OnceLock, ``src/fft.rs:77-125``),
  * runtime atomic setters with 0 = revert-to-heuristic
    (``src/fft.rs:176-209``) -> here: ``set_*`` functions where ``None``
    reverts to the env/heuristic value.

Tunables
--------
KOFFT_TPU_BACKEND        auto | xla | jnpfft | naive
KOFFT_TPU_DFT_CUTOFF     max n computed by a single direct DFT matmul
                         (the matmul base case; default 128)
KOFFT_TPU_PRECISION      highest | high | default  — engine matmul precision
KOFFT_TPU_SHARD_THRESHOLD  points-per-chip below which we stay single-chip
                         (analog of KOFFT_PAR_FFT_THRESHOLD heuristic,
                         reference ``src/fft.rs:244-307``)
KOFFT_TPU_MAX_FACTOR     largest acceptable smooth factor before Bluestein
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}")


def _env_str(name: str, default: str, choices: tuple[str, ...]) -> str:
    v = os.environ.get(name, default).lower()
    if v not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {v!r}")
    return v


_BACKENDS = ("auto", "xla", "jnpfft", "naive")
_PRECISIONS = ("highest", "high", "default")


@dataclass
class _Config:
    # env-derived defaults (read once at import, like the reference OnceLock)
    backend: str = field(
        default_factory=lambda: _env_str("KOFFT_TPU_BACKEND", "auto", _BACKENDS))
    # chosen on another machine; not re-measured on the H100
    dft_cutoff: int = field(
        default_factory=lambda: _env_int("KOFFT_TPU_DFT_CUTOFF", 128))
    precision: str = field(
        default_factory=lambda: _env_str("KOFFT_TPU_PRECISION", "highest",
                                         _PRECISIONS))
    shard_threshold: int = field(
        default_factory=lambda: _env_int("KOFFT_TPU_SHARD_THRESHOLD", 1 << 16))
    # chunk count for the comm/compute-overlap pipeline in the sharded
    # transforms (1 = sequential program); the auto paths use it when
    # shapes divide (analog of KOFFT_PAR_FFT_BLOCK_SIZE, fft.rs:195-200)
    overlap_chunks: int = field(
        default_factory=lambda: _env_int("KOFFT_TPU_OVERLAP_CHUNKS", 4))
    max_factor: int = field(
        default_factory=lambda: _env_int("KOFFT_TPU_MAX_FACTOR", 13))
    # feature booleans (analog of cargo features, Cargo.toml:46-62)
    keep_naive_oracles: bool = True  # `slow` feature analog


_config = _Config()
_env_defaults = _Config()  # frozen copy of env-derived values for revert


def get_config() -> _Config:
    return _config


def set_backend(name: Optional[str]) -> None:
    """Override the backend; ``None`` reverts to the env/auto default
    (mirrors reference runtime setters where 0 = revert, fft.rs:176-209)."""
    if name is None:
        _config.backend = _env_defaults.backend
        return
    name = name.lower()
    if name not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {name!r}")
    _config.backend = name


def set_dft_cutoff(n: Optional[int]) -> None:
    if n is None or n == 0:
        _config.dft_cutoff = _env_defaults.dft_cutoff
        return
    if n < 2:
        raise ValueError("dft_cutoff must be >= 2")
    _config.dft_cutoff = int(n)


def set_precision(p: Optional[str]) -> None:
    if p is None:
        _config.precision = _env_defaults.precision
        return
    p = p.lower()
    if p not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {p!r}")
    _config.precision = p


def set_shard_threshold(n: Optional[int]) -> None:
    """Points-per-chip threshold gating sharded execution; ``None``/0 reverts
    (analog of ``set_parallel_fft_threshold``, reference fft.rs:176-185)."""
    if n is None or n == 0:
        _config.shard_threshold = _env_defaults.shard_threshold
        return
    _config.shard_threshold = int(n)


def set_overlap_chunks(k: Optional[int]) -> None:
    """Chunk count for the sharded-transform overlap pipeline; ``None``/0
    reverts to the env/default (analog of ``set_parallel_fft_block_size``,
    reference fft.rs:195-200). 1 disables overlap (sequential program)."""
    if k is None or k == 0:
        _config.overlap_chunks = _env_defaults.overlap_chunks
        return
    if k < 1:
        raise ValueError("overlap_chunks must be >= 1")
    _config.overlap_chunks = int(k)


def trace_key() -> tuple:
    """Config values that alter traced computation (matmul precision, plan
    shape). Every lru-cached jitted entry point includes this in its cache
    key, so the runtime setters take effect even for shapes that already
    have a warm executable (otherwise set_precision() would be silently
    ignored after the first call)."""
    return (_config.precision, _config.dft_cutoff, _config.max_factor)


def x64_active() -> bool:
    """Whether the f64/complex128 tier is live: JAX's x64 mode is on (the
    reference is generic over f32/f64, ``src/num.rs:5-29``; CPU and GPU
    XLA backends run f64 natively)."""
    import jax
    return bool(jax.config.jax_enable_x64)


def lax_precision():
    """The jax.lax.Precision used for all real matmuls in the engine.

    On the GPU, 'highest' computes f32 dots in full FP32 and is the
    default; 'high' and 'default' let XLA use the tensor cores at reduced
    input precision (TF32-class). ``chip_smoke.py`` prints the SNR each
    tier reaches on the card.
    """
    import jax
    return {
        "highest": jax.lax.Precision.HIGHEST,
        "high": jax.lax.Precision.HIGH,
        "default": jax.lax.Precision.DEFAULT,
    }[_config.precision]
