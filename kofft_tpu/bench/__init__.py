"""kofft_tpu.bench — benchmark harness (JSON history, reference-style).

Analog of the reference's criterion harness + JSON history
(``kofft-bench/benches/bench_fft.rs:20-103``): records BenchRecord-shaped
entries {library, transform, size, mode, time_per_op_ns, ops_per_sec,
...} with previous-run deltas, plus device fields.
"""

from .harness import (timeit_chained, timeit_chained_scalar, BenchRecord,
                      card_info, run_history, SNR_POLICY_DB,
                      check_snr_policy)  # noqa: F401
