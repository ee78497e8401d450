"""Example: render a spectrogram PNG from a WAV file.

Counterpart of the reference's example binary used by its golden-image
parity test (``tests/spectrogram_parity.rs:9-75``): this script and the
sanity-check CLI must produce byte-identical PNGs for the same input.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kofft_tpu.cli.sanity_check import render
from kofft_tpu.utils.audio import read_audio
from kofft_tpu.utils.image import save_png


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        # self-demo (CI smoke mode): synthesize the 440 Hz tone the
        # golden-parity test uses and render it to a temp PNG
        import tempfile

        import numpy as np

        from kofft_tpu.utils.audio import write_wav
        sr = 16000
        t = np.arange(sr, dtype=np.float64) / sr
        tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
        tmp = Path(tempfile.mkdtemp(prefix="kofft_spec_demo_"))
        write_wav(tmp / "tone.wav", tone, sr)
        argv = [str(tmp / "tone.wav"), str(tmp / "tone.png")]
        print(f"no args: demo render -> {argv[1]}", file=sys.stderr)
    inp, outp = Path(argv[0]), Path(argv[1])
    win_len = int(argv[2]) if len(argv) > 2 else 1024
    samples, _sr = read_audio(inp)
    img = render(samples, win_len, "inferno", "linear", 120.0)
    save_png(img, outp, "eight")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
