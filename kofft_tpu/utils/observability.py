"""Observability helpers: profiler traces + persistent compile cache.

SURVEY.md §5.1/§5.4: the reference's performance observation is its
criterion harness; its only persistent state is reconstructible planner
caches. The equivalents here are jax.profiler traces and the XLA
persistent compilation cache (so warm processes skip the first
compile — the analog of the reference's precomputed-twiddles build flag).
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

# One fixed in-checkout directory: the cache key includes the path, so a
# directory that moves between runs never hits.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache(path: str | Path | None = None) -> str:
    """Turn on the persistent XLA compilation cache and return its
    directory. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX has already
    taken its directory from it and this sets no other (``path`` is then
    ignored); otherwise the cache goes to ``path``, by default
    :data:`DEFAULT_CACHE_DIR`."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        p = env
    else:
        p = str(Path(path).expanduser() if path else DEFAULT_CACHE_DIR)
        Path(p).mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", p)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return p


def prewarm(sizes, batch_shape: tuple = (), rfft_sizes=(),
            ndfft_shapes=()):
    """Pre-build tables and compile executables for the given FFT sizes
    (the analog of the reference's compile-time twiddle embedding,
    ``build.rs:6-95``): after ``prewarm``, first real calls are cache hits.
    Combine with :func:`enable_compilation_cache` to persist across
    processes.

    Goes through the PUBLIC entry points so it populates exactly the
    executable caches a real call will hit (the jitted-entry caches key
    on config.trace_key() and on the complex-vs-planes calling
    convention; warming internal entries under different keys compiles
    executables no real call ever uses)."""
    import jax
    import jax.numpy as jnp
    from .. import fft, ifft, fft_split, ifft_split, rfft_split

    for n in sizes:
        z = jnp.zeros((*batch_shape, n), jnp.float32)
        jax.block_until_ready(fft_split(z, z))
        jax.block_until_ready(ifft_split(z, z))
        # the complex-object path has its own jitted entry
        zc = jnp.zeros((*batch_shape, n), jnp.complex64)
        jax.block_until_ready(fft(zc))
        jax.block_until_ready(ifft(zc))
    for n in rfft_sizes:
        z = jnp.zeros((*batch_shape, n), jnp.float32)
        jax.block_until_ready(rfft_split(z))
    for shape in ndfft_shapes:
        from ..ops.ndfft import fftn_split
        z = jnp.zeros(tuple(shape), jnp.float32)
        yr, yi = fftn_split(z, z)
        jax.block_until_ready(fftn_split(yr, yi, inverse=True))


@contextlib.contextmanager
def trace(log_dir: str | Path = "kofft_trace"):
    """jax.profiler trace context: ``with trace("out/t"): run()``;
    inspect with TensorBoard / xprof."""
    import jax
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()
