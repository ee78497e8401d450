"""kofft_tpu.parallel — mesh-sharded transforms over ICI collectives.

The reference's parallelism is Rayon shared-memory work-stealing gated by a
cost heuristic (``src/fft.rs:47-307``); its equivalent here is a
device ``Mesh`` with ``shard_map`` + ``jax.lax`` collectives: ``all_to_all``
for N-D FFT pencil transposes, ``ppermute`` halo exchange for STFT/ISTFT
overlap, ``psum`` for reductions (SURVEY.md §2 "distributed communication
backend" and §5.7-5.8).
"""

from .mesh import make_mesh, should_shard  # noqa: F401
from .ndfft_sharded import fftn_sharded, ifftn_sharded  # noqa: F401
from .fft_sharded import fft_sharded, ifft_sharded  # noqa: F401
from .stft_sharded import (stft_sharded, istft_sharded,  # noqa: F401
                           stft_sharded_hier, istft_sharded_hier)
from .auto import (calibrate_shard_threshold, fft_auto, fftn_auto,  # noqa: F401
                   istft_auto, stft_auto)
from .hier import (fft_sharded_hier, fftn_sharded_hier,  # noqa: F401
                   ifft_sharded_hier, ifftn_sharded_hier, make_hier_mesh)
