"""kofft: a spectral transform framework in JAX, run on NVIDIA GPUs.

A JAX/XLA implementation of the capability surface of the reference DSP
library (okian/kofft): complex FFT (matmul-DFT + four-step + Bluestein
engine, or XLA's own FFT), real FFT, N-D FFT (one device and
mesh-sharded), DCT/DST I-IV, Hartley, Hilbert, cepstrum/MFCC, Goertzel, CZT,
wavelets, windows, STFT/ISTFT (batch, streaming, sharded), spectrograms and
tooling. See SURVEY.md for the layer map this implements.
"""

from .config import (get_config, set_backend, set_dft_cutoff,  # noqa: F401
                     set_overlap_chunks, set_precision, set_shard_threshold)
from .errors import (KofftError, EmptyInputError,  # noqa: F401
                     MismatchedLengthsError, InvalidStrideError,
                     InvalidHopSizeError, InvalidValueError)
from .ops.fft import (fft, ifft, fft_batch, ifft_batch,  # noqa: F401
                      fft_split, ifft_split, fft_split_tiled,
                      ifft_split_tiled, tiled_shape, fftfreq, rfftfreq,
                      fftshift, ifftshift)
from .ops.rfft import rfft, irfft, rfft_split, irfft_split  # noqa: F401
from .ops.ndfft import (fft2, ifft2, fft3, ifft3, fftn,  # noqa: F401
                        ifftn, fftn_split, rfftn, irfftn, rfftn_split,
                        irfftn_split)
from .ops.stft import (stft, istft, stft_split, istft_split,  # noqa: F401
                       StftStream, StftPushStream, IstftStream,
                       istft_stream_scan, stft_stream_scan)
from .ops.dct import dct, idct, dct1, dct2, dct3, dct4  # noqa: F401
from .ops.dst import dst, dst1, dst2, dst3, dst4  # noqa: F401
from .ops.hartley import dht  # noqa: F401
from .ops.hilbert import hilbert, hilbert_analytic  # noqa: F401
from .ops.czt import czt, czt_fast  # noqa: F401
from .ops.goertzel import (goertzel, goertzel_bins,  # noqa: F401
                           goertzel_scan)
from .ops.cepstrum import real_cepstrum, mel_filterbank, mfcc  # noqa: F401
from .ops.wavelet import (haar_forward, haar_inverse,  # noqa: F401
                          wavelet_forward, wavelet_inverse,
                          multi_level_forward, multi_level_inverse,
                          dwt, idwt, dwt_multi, idwt_multi)
from . import visual  # noqa: F401
from .ops import window  # noqa: F401
from .ops.plan_api import FftPlan, fft_strided_split  # noqa: F401
from .utils.transfer import asnumpy  # noqa: F401
from .utils.observability import enable_compilation_cache, trace  # noqa: F401
from . import parallel  # noqa: F401

__version__ = "0.1.0"
