"""On-card smoke run: drives kofft's public transforms and models once on
one NVIDIA GPU, at the sizes users run, and checks every result against
a float64 reference.

    python chip_smoke.py            # one card, phases 1-8
    python chip_smoke.py --four     # four cards: the sharded transforms
                                    # against their one-card results

Each phase prints, per call: the compile seconds, the warm time of the
call (ending in ``block_until_ready``), the SNR in dB against the f64
reference with its floor, and the memory analysis of the phase's
largest executable. The card's name and power limit come from
``nvidia-smi``. The last line is one JSON object naming the device; it
is printed only when every phase passed. Without a GPU the script exits
nonzero before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

SIZE_MB = 1 << 20
F32_FLOOR_DB = 120.0          # f32 at the 'highest' tier vs the f64 oracle
F64_FLOOR_DB = 250.0          # complex128 round trip (tests/test_f64.py)


def require_gpu():
    """The JAX device list, or exit nonzero when JAX finds no GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX platform is "
                 f"{devs[0].platform!r}); refusing to run")
    return devs


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.complex128)
    got = np.asarray(got, np.complex128)
    err = np.sum(np.abs(ref - got) ** 2)
    sig = np.sum(np.abs(ref) ** 2)
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10(sig / err))


def planes(y):
    """(re, im) host planes of a complex result or a planes pair."""
    if isinstance(y, tuple):
        return np.asarray(y[0]) + 1j * np.asarray(y[1])
    return np.asarray(y)


class Smoke:
    """Collects one row per checked call and the largest executable per
    phase; failures are counted, and reported at the end."""

    def __init__(self, seed: int = 0, reps: int = 3):
        self.rng = np.random.default_rng(seed)
        self.reps = reps
        self.failed: list[str] = []
        self.rows: list[dict] = []
        self.phase = ""
        self._biggest = None

    # -- data ---------------------------------------------------------
    def cplx(self, shape) -> np.ndarray:
        re = self.rng.standard_normal(shape, dtype=np.float32)
        im = self.rng.standard_normal(shape, dtype=np.float32)
        return re + 1j * im

    def real(self, shape) -> np.ndarray:
        return self.rng.standard_normal(shape, dtype=np.float32)

    # -- phases and rows ----------------------------------------------
    def begin(self, name: str) -> None:
        self.end()
        self.phase = name
        self._biggest = None
        print(f"== {name}", flush=True)

    def end(self) -> None:
        if self.phase and self._biggest is not None:
            label, desc, _ = self._biggest
            print(f"   largest executable: {label}: {desc}", flush=True)
        self._biggest = None

    def _note_memory(self, label: str, compiled) -> None:
        mem = compiled.memory_analysis()
        if mem is None:
            return
        total = (mem.argument_size_in_bytes + mem.output_size_in_bytes
                 + mem.temp_size_in_bytes)
        desc = (f"args {mem.argument_size_in_bytes / SIZE_MB:.1f} MiB, "
                f"out {mem.output_size_in_bytes / SIZE_MB:.1f} MiB, "
                f"temp {mem.temp_size_in_bytes / SIZE_MB:.1f} MiB, "
                f"code {mem.generated_code_size_in_bytes / SIZE_MB:.1f} MiB")
        if self._biggest is None or total > self._biggest[2]:
            self._biggest = (label, desc, total)

    def check(self, label: str, snr: float, floor: float,
              compile_s: float | None = None,
              warm_s: float | None = None) -> float:
        ok = snr >= floor
        row = {"phase": self.phase, "call": label, "snr_db": snr,
               "floor_db": floor, "compile_s": compile_s, "warm_s": warm_s,
               "ok": ok}
        self.rows.append(row)
        cs = "-" if compile_s is None else f"{compile_s:.2f}s"
        ws = "-" if warm_s is None else f"{warm_s * 1e3:.3f}ms"
        print(f"   {label:<44} compile {cs:>8}  warm {ws:>12}  "
              f"SNR {snr:7.1f} dB (floor {floor:.0f}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(f"{self.phase}: {label}")
        return snr

    def expect(self, label: str, ok: bool, detail: str) -> None:
        print(f"   {label:<44} {detail} {'ok' if ok else 'FAIL'}",
              flush=True)
        self.rows.append({"phase": self.phase, "call": label,
                          "detail": detail, "ok": bool(ok)})
        if not ok:
            self.failed.append(f"{self.phase}: {label}")

    # -- timing -------------------------------------------------------
    def jitted(self, label: str, fn, *args):
        """Compile ``fn`` for ``args``; returns (output, compile seconds,
        best warm seconds over ``reps`` calls)."""
        import jax
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        compile_s = time.perf_counter() - t0
        self._note_memory(label, compiled)
        out = jax.block_until_ready(compiled(*args))
        warm = []
        for _ in range(self.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(*args))
            warm.append(time.perf_counter() - t0)
        return out, compile_s, min(warm)

    def eager(self, fn, make_args):
        """Call an eager public entry twice on fresh arguments: returns
        (output, first-call seconds less the warm time, warm seconds)."""
        import jax
        args = make_args()
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        first = time.perf_counter() - t0
        warm = []
        for _ in range(self.reps):
            args = make_args()
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            warm.append(time.perf_counter() - t0)
        return out, max(first - min(warm), 0.0), min(warm)


# ---------------------------------------------------------------------------
# phase 1: 1-D complex
# ---------------------------------------------------------------------------

def phase_fft_1d(s: Smoke, shapes=((1 << 20,), (8, 1 << 20), (1 << 24,),
                                   (1 << 26,), (3 << 18,), (1_000_000,),
                                   (4099,), (1_000_003,)),
                 split_n: int = 1 << 20, donate_n: int = 1 << 24) -> None:
    import jax
    import kofft_tpu as kt
    s.begin("phase 1: 1-D complex fft/ifft")
    for shape in shapes:
        x = s.cplx(shape)
        xd = jax.device_put(x.astype(np.complex64))
        (y, back), cs, ws = s.jitted(
            f"fft+ifft {shape}",
            lambda a: (lambda f: (f, kt.ifft(f)))(kt.fft(a)), xd)
        ref = np.fft.fft(x.astype(np.complex128), axis=-1)
        s.check(f"fft {shape}", snr_db(ref, y), F32_FLOOR_DB, cs, ws)
        s.check(f"ifft(fft) {shape}", snr_db(x, back), F32_FLOOR_DB)
        del y, back, xd, ref

    x = s.cplx((split_n,))
    xr = np.ascontiguousarray(x.real)
    xi = np.ascontiguousarray(x.imag)
    y, cs, ws = s.eager(kt.fft_split, lambda: (xr, xi))
    s.check(f"fft_split host planes ({split_n},)",
            snr_db(np.fft.fft(x.astype(np.complex128)), planes(y)),
            F32_FLOOR_DB, cs, ws)

    x = s.cplx((donate_n,))
    ref = np.fft.fft(x.astype(np.complex128))
    xr = np.ascontiguousarray(x.real)
    xi = np.ascontiguousarray(x.imag)

    def put():
        return jax.device_put(xr), jax.device_put(xi)

    ins = put()
    t0 = time.perf_counter()
    y = jax.block_until_ready(kt.fft_split(*ins, donate=True))
    first = time.perf_counter() - t0
    s.expect(f"fft_split donate=True ({donate_n},)",
             all(a.is_deleted() for a in ins), "inputs donated")
    ins = put()
    t0 = time.perf_counter()
    y = jax.block_until_ready(kt.fft_split(*ins, donate=True))
    warm = time.perf_counter() - t0
    s.check(f"fft_split donate=True ({donate_n},)",
            snr_db(ref, planes(y)), F32_FLOOR_DB, max(first - warm, 0.0),
            warm)


# ---------------------------------------------------------------------------
# phase 2: real FFT
# ---------------------------------------------------------------------------

def phase_rfft(s: Smoke, shapes=((1 << 20,), (8, 1 << 20))) -> None:
    import jax
    import kofft_tpu as kt
    s.begin("phase 2: rfft/irfft")
    for shape in shapes:
        x = s.real(shape)
        n = shape[-1]
        (y, back), cs, ws = s.jitted(
            f"rfft+irfft {shape}",
            lambda a: (lambda f: (f, kt.irfft(f, n=n)))(kt.rfft(a)),
            jax.device_put(x))
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        s.check(f"rfft {shape}", snr_db(ref, y), F32_FLOOR_DB, cs, ws)
        s.check(f"irfft(rfft) {shape}", snr_db(x, back), F32_FLOOR_DB)


# ---------------------------------------------------------------------------
# phase 3: N-D
# ---------------------------------------------------------------------------

def phase_nd(s: Smoke, fft2_shapes=((1024, 1024), (4096, 4096)),
             fftn_shapes=((128, 128, 128), (256, 256, 256)),
             rfftn_shape=(512, 512)) -> None:
    import jax
    import kofft_tpu as kt
    s.begin("phase 3: N-D fft2/fftn/rfftn")
    for shape in tuple(fft2_shapes) + tuple(fftn_shapes):
        api = kt.fft2 if len(shape) == 2 else kt.fftn
        iapi = kt.ifft2 if len(shape) == 2 else kt.ifftn
        x = s.cplx(shape)
        (y, back), cs, ws = s.jitted(
            f"{api.__name__}+inverse {shape}",
            lambda a: (lambda f: (f, iapi(f)))(api(a)),
            jax.device_put(x.astype(np.complex64)))
        ref = np.fft.fftn(x.astype(np.complex128))
        s.check(f"{api.__name__} {shape}", snr_db(ref, y), F32_FLOOR_DB,
                cs, ws)
        s.check(f"inverse {shape}", snr_db(x, back), F32_FLOOR_DB)
        del y, back, ref
    x = s.real(rfftn_shape)
    (y, back), cs, ws = s.jitted(
        f"rfftn+irfftn {rfftn_shape}",
        lambda a: (lambda f: (f, kt.irfftn(f, n=rfftn_shape[-1])))(
            kt.rfftn(a)), jax.device_put(x))
    s.check(f"rfftn {rfftn_shape}",
            snr_db(np.fft.rfftn(x.astype(np.float64)), y), F32_FLOOR_DB,
            cs, ws)
    s.check(f"irfftn(rfftn) {rfftn_shape}", snr_db(x, back), F32_FLOOR_DB)


# ---------------------------------------------------------------------------
# phase 4: STFT, streaming, and the web server
# ---------------------------------------------------------------------------

def _stft_ref(x: np.ndarray, w: np.ndarray, hop: int) -> np.ndarray:
    """f64 frames of the reference semantics: ceil(N/hop) frames, each
    zero-padded past the end, windowed, full complex FFT."""
    n, win = x.shape[0], w.shape[0]
    nf = -(-n // hop)
    xp = np.zeros((nf - 1) * hop + win)
    xp[:n] = x
    idx = np.arange(nf)[:, None] * hop + np.arange(win)[None, :]
    return np.fft.fft(xp[idx] * w.astype(np.float64), axis=-1)


def phase_stft(s: Smoke, seconds: float = 600.0, rate: int = 16000,
               win: int = 512, hop: int = 160,
               push_seconds: float = 0.5, web_requests: int = 5) -> None:
    import jax
    import kofft_tpu as kt
    from kofft_tpu.ops import window as W
    s.begin(f"phase 4: STFT on {seconds:g} s of {rate} Hz audio "
            f"(hann {win}, hop {hop})")
    n = int(seconds * rate)
    x = s.real((n,))
    w = np.asarray(W.hann(win), np.float32)
    ref = _stft_ref(x.astype(np.float64), w, hop)
    xd = jax.device_put(x)
    (frames, back), cs, ws = s.jitted(
        "stft+istft",
        lambda a: (lambda f: (f, kt.istft(f, w, hop, length=n)))(
            kt.stft(a, w, hop)), xd)
    s.check(f"stft ({n},) -> {tuple(frames.shape)}", snr_db(ref, frames),
            F32_FLOOR_DB, cs, ws)
    # the OLA norm is not full within one window of either edge (and the
    # hann w[0] = 0 sample is unrecoverable), so the round trip is scored
    # on the interior
    s.check("istft(stft) interior", snr_db(x[win:-win], back[win:-win]),
            F32_FLOOR_DB)
    del frames, back

    yr_yi, cs, ws = s.jitted(
        "stft_stream_scan", lambda a: kt.stft_stream_scan(a, w, hop), xd)
    s.check("stft_stream_scan", snr_db(ref, planes(yr_yi)), F32_FLOOR_DB,
            cs, ws)
    del yr_yi

    chunk = int(push_seconds * rate)
    stream = kt.StftPushStream(w, hop)
    got = []
    t0 = time.perf_counter()
    for i in range(0, n, chunk):
        got.append(planes(stream.push(x[i: i + chunk])))
    got.append(planes(stream.flush()))
    t_push = time.perf_counter() - t0
    pushes = -(-n // chunk)
    out = np.concatenate(got, axis=0)
    s.check(f"StftPushStream {pushes} pushes of {chunk}", snr_db(ref, out),
            F32_FLOOR_DB, None, t_push / pushes)
    del ref, out, got

    _web_requests(s, x, rate, web_requests)


def _web_requests(s: Smoke, x: np.ndarray, rate: int, count: int) -> None:
    """The spectrogram server answers ``count`` compute_frame pushes and
    one /api/stft request, from a thread of this process."""
    import threading
    import urllib.request

    from kofft_tpu.web.server import make_server
    from kofft_tpu.web.state import HOP, WIN_LEN

    srv = make_server(port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path: str, body: dict) -> dict:
        req = urllib.request.Request(
            url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        rows = 0
        times = []
        for i in range(count):
            seg = x[i * WIN_LEN: (i + 1) * WIN_LEN]
            t0 = time.perf_counter()
            r = post("/api/compute_frame", {"samples": seg.tolist()})
            times.append(time.perf_counter() - t0)
            rows += r["rows"]
        want = (count * WIN_LEN - WIN_LEN) // HOP + 1
        s.expect(f"POST /api/compute_frame x{count}", rows == want,
                 f"{rows} rows (want {want}), "
                 f"median {np.median(times) * 1e3:.2f} ms")
        clip = x[: rate]
        win, hop = 1024, 256
        t0 = time.perf_counter()
        r = post("/api/stft", {"samples": clip.tolist(), "win_len": win,
                               "hop": hop})
        t_stft = time.perf_counter() - t0
        from kofft_tpu.ops import window as W
        ref = np.abs(_stft_ref(clip.astype(np.float64),
                               np.asarray(W.hann(win)), hop))[:, : win // 2]
        s.check("POST /api/stft magnitudes", snr_db(ref, r["mags"]),
                F32_FLOOR_DB, None, t_stft)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


# ---------------------------------------------------------------------------
# phase 5: other transforms
# ---------------------------------------------------------------------------

def phase_other(s: Smoke, n: int = 1 << 16, dct_sizes=(4096, 16384),
                batch: int = 8, czt_m: int = 256, mel: int = 40,
                levels: int = 5) -> None:
    import jax
    import scipy.fft as sf
    import kofft_tpu as kt
    from kofft_tpu.ops.cepstrum import mel_filterbank_matrix
    s.begin(f"phase 5: other transforms (n = {n})")

    for m in dct_sizes:
        x = s.real((batch, m))
        xd = jax.device_put(x)
        x64 = x.astype(np.float64)
        y, cs, ws = s.eager(lambda a: kt.dct(a, 2), lambda: (xd,))
        s.check(f"dct-II ({batch}, {m})", snr_db(sf.dct(x64, 2) / 2, y),
                F32_FLOOR_DB, cs, ws)
        back, cs, ws = s.eager(lambda a: kt.idct(a, 2), lambda: (y,))
        s.check(f"idct(dct) ({batch}, {m})", snr_db(x64, back),
                F32_FLOOR_DB, cs, ws)
        y, cs, ws = s.eager(lambda a: kt.dst(a, 2), lambda: (xd,))
        s.check(f"dst-II ({batch}, {m})", snr_db(sf.dst(x64, 2) / 2, y),
                F32_FLOOR_DB, cs, ws)

    x = s.real((n,))
    xd = jax.device_put(x)
    x64 = x.astype(np.float64)
    wz = np.exp(-2j * np.pi / n)
    y, cs, ws = s.eager(lambda a: kt.czt_fast(a, n, wz), lambda: (xd,))
    s.check(f"czt_fast m={n} (the DFT)", snr_db(np.fft.fft(x64), y),
            F32_FLOOR_DB, cs, ws)
    wz2 = np.exp(-2j * np.pi * 0.25 / czt_m)
    a2 = np.exp(0.5j)
    i = np.arange(n)[:, None]
    k = np.arange(czt_m)[None, :]
    ref = x64 @ (a2 ** (-i) * wz2 ** (i * k))
    y, cs, ws = s.eager(lambda a: kt.czt(a, czt_m, wz2, a2), lambda: (xd,))
    s.check(f"czt m={czt_m} (zoom)", snr_db(ref, y), F32_FLOOR_DB, cs, ws)

    xb = s.real((batch, n))
    xbd = jax.device_put(xb)
    bins = list(range(1, n // 2, n // 128))
    y, cs, ws = s.eager(lambda a: kt.goertzel_bins(a, bins), lambda: (xbd,))
    ref = np.abs(np.fft.fft(xb.astype(np.float64)))[:, bins]
    s.check(f"goertzel_bins ({batch}, {n}) x{len(bins)}", snr_db(ref, y),
            F32_FLOOR_DB, cs, ws)

    f = np.fft.fft(xb.astype(np.float64))
    g = np.zeros(n)
    g[0] = g[n // 2] = 1.0
    g[1: n // 2] = 2.0
    ref = np.fft.ifft(f * g).imag
    y, cs, ws = s.eager(kt.hilbert, lambda: (xbd,))
    s.check(f"hilbert ({batch}, {n})", snr_db(ref, y), F32_FLOOR_DB, cs, ws)

    rate = 16000.0
    mags = np.abs(f[:, : n // 2 + 1])
    fb = np.asarray(mel_filterbank_matrix(n // 2 + 1, rate, mel), np.float64)
    ref = (sf.dct(np.log(mags @ fb + 1e-12), 2) / 2)[:, :13]
    magsd = jax.device_put(mags.astype(np.float32))
    y, cs, ws = s.eager(lambda a: kt.mfcc(a, rate, mel, 13),
                        lambda: (magsd,))
    s.check(f"mfcc ({batch}, {n // 2 + 1}) mel {mel}", snr_db(ref, y),
            F32_FLOOR_DB, cs, ws)

    from kofft_tpu.ops.wavelet import FAMILIES
    h, gh, gs, hs = FAMILIES["db4"]
    (approx, details), cs, ws = s.eager(
        lambda a: kt.multi_level_forward(a, levels, "db4"), lambda: (xd,))
    cur = x64
    ref_details = []
    for _ in range(levels):
        cur, d = _wavelet_forward_ref(cur, h, gh)
        ref_details.append(d)
    got = np.concatenate([np.asarray(approx)]
                         + [np.asarray(d) for d in details])
    want = np.concatenate([cur] + ref_details)
    s.check(f"wavelet_forward db4 x{levels} ({n},)", snr_db(want, got),
            F32_FLOOR_DB, cs, ws)
    back, cs, ws = s.eager(
        lambda a, d: kt.multi_level_inverse(a, d, "db4"),
        lambda: (approx, details))
    cur = np.asarray(approx, np.float64)
    for d in reversed(details):
        cur = _wavelet_inverse_ref(cur, np.asarray(d, np.float64), gs, hs)
    s.check(f"wavelet_inverse db4 x{levels} ({n},)", snr_db(cur, back),
            F32_FLOOR_DB, cs, ws)


def _reflect(i: np.ndarray, n: int) -> np.ndarray:
    """Whole-point symmetric reflection into [0, n)."""
    i = np.abs(i)
    period = 2 * (n - 1)
    i = i % period if period else np.zeros_like(i)
    return np.where(i >= n, period - i, i)


def _wavelet_forward_ref(x, h, g):
    """f64 analysis with whole-point reflection (wavelet.rs:168-186)."""
    n = x.shape[0]
    idx = _reflect(2 * np.arange(n // 2)[:, None]
                   + np.arange(len(h))[None, :], n)
    return x[idx] @ np.asarray(h), x[idx] @ np.asarray(g)


def _wavelet_inverse_ref(a, d, gs, hs):
    """f64 synthesis scatter-add with reflection (wavelet.rs:189-224)."""
    n = a.shape[0]
    out = np.zeros(2 * n)
    idx = _reflect(2 * np.arange(n)[:, None]
                   + np.arange(len(gs))[None, :], 2 * n)
    np.add.at(out, idx, a[:, None] * np.asarray(gs)[None, :]
              + d[:, None] * np.asarray(hs)[None, :])
    return out


# ---------------------------------------------------------------------------
# phase 6: models
# ---------------------------------------------------------------------------

# loss at the 'default' tier vs the 'highest' tier, relative to
# max(|loss|, 1)
MODEL_RTOL = 1e-2


def _train(model, module, params, steps, lr, *data):
    import jax
    losses = []
    t_first = None
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, loss = module.train_step(model, params, *data, lr=lr)
        loss = float(jax.block_until_ready(loss))
        dt = time.perf_counter() - t0
        if t_first is None:
            t_first = dt
        else:
            times.append(dt)
        losses.append(loss)
    warm = min(times) if times else t_first
    return params, losses, max(t_first - warm, 0.0), warm


def phase_models(s: Smoke, batch: int = 64, seconds: float = 1.0,
                 rate: int = 16000, steps: int = 5,
                 denoise_steps: int = 2, lr: float = 1e-4) -> None:
    import jax
    from kofft_tpu.config import set_precision
    from kofft_tpu.models import denoiser as dn
    from kofft_tpu.models import spectral_net as sn
    s.begin(f"phase 6: models (batch {batch} x {seconds:g} s at {rate} Hz)")
    n = int(seconds * rate)
    sig = jax.device_put(s.real((batch, n)))
    labels = jax.device_put(
        s.rng.integers(0, 8, size=(batch,)).astype(np.int32))
    clean = s.real((batch, n))
    noisy = jax.device_put(clean + 0.3 * s.real((batch, n)))
    clean = jax.device_put(clean)

    runs = {}
    for tier in ("highest", "default"):
        set_precision(tier)
        try:
            model = sn.SpectralNet()
            _, losses, cs, ws = _train(model, sn, model.init(seed=0), steps,
                                       lr, sig, labels)
            dmodel = dn.SpectralDenoiser()
            dparams = dmodel.init(seed=0)
            out = jax.block_until_ready(
                jax.jit(dmodel.apply)(dparams, noisy))
            _, dlosses, dcs, dws = _train(dmodel, dn, dparams,
                                          denoise_steps, 1e-2, noisy, clean)
        finally:
            set_precision(None)
        runs[tier] = (losses, dlosses)
        s.expect(f"SpectralNet {steps} steps lr {lr:g} [{tier}]",
                 all(np.isfinite(losses))
                 and all(b < a for a, b in zip(losses, losses[1:])),
                 f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
                 f"compile {cs:.2f}s, step {ws * 1e3:.2f}ms")
        s.expect(f"SpectralDenoiser fwd + {denoise_steps} steps [{tier}]",
                 bool(np.all(np.isfinite(np.asarray(out))))
                 and all(np.isfinite(dlosses)),
                 f"loss {dlosses[0]:.6f} -> {dlosses[-1]:.6f}, "
                 f"compile {dcs:.2f}s, step {dws * 1e3:.2f}ms")
    for k, name in ((0, "SpectralNet"), (1, "SpectralDenoiser")):
        hi = np.asarray(runs["highest"][k])
        lo = np.asarray(runs["default"][k])
        rel = float(np.max(np.abs(lo - hi) / np.maximum(np.abs(hi), 1.0)))
        s.expect(f"{name} default vs highest tier", rel <= MODEL_RTOL,
                 f"max rel loss diff {rel:.2e} (tol {MODEL_RTOL:g})")


# ---------------------------------------------------------------------------
# phase 7: f64 tier
# ---------------------------------------------------------------------------

def phase_f64(s: Smoke, n: int = 1 << 20, cube=(128, 128, 128)) -> None:
    import jax
    import kofft_tpu as kt
    s.begin("phase 7: complex128 tier")
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        for shape, fwd, inv in (((n,), kt.fft, kt.ifft),
                                (cube, kt.fftn, kt.ifftn)):
            x = s.rng.standard_normal(shape) + 1j * s.rng.standard_normal(
                shape)
            xd = jax.device_put(x)
            (y, back), cs, ws = s.jitted(
                f"{fwd.__name__} c128 {shape}",
                lambda a: (lambda f: (f, inv(f)))(fwd(a)), xd)
            s.expect(f"{fwd.__name__} c128 {shape} dtype",
                     y.dtype == np.complex128, str(y.dtype))
            s.check(f"{fwd.__name__} c128 {shape}",
                    snr_db(np.fft.fftn(x), y), F64_FLOOR_DB, cs, ws)
            s.check(f"round trip c128 {shape}", snr_db(x, back),
                    F64_FLOOR_DB)
    finally:
        jax.config.update("jax_enable_x64", prev)


# ---------------------------------------------------------------------------
# phase 8: the engine XLA compiles vs XLA's own FFT, and precision tiers
# ---------------------------------------------------------------------------

def _median_time(fn, arg, reps: int) -> float:
    import jax
    jax.block_until_ready(fn(arg))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_engines(s: Smoke, shapes=(("fft", (1 << 20,)),
                                    ("fft", (8, 1 << 20)),
                                    ("fft", (3 << 18,)), ("fft", (1 << 24,)),
                                    ("fftn", (1024, 1024)),
                                    ("fftn", (4096, 4096)),
                                    ("fftn", (128, 128, 128))),
                  tiers: dict | None = None, reps: int = 20,
                  chain: int = 20) -> list:
    import jax
    import kofft_tpu as kt
    from kofft_tpu.bench import timeit_chained
    from kofft_tpu.config import set_precision
    s.begin("phase 8: backend='auto' (matmul engine) vs 'jnpfft' "
            "(XLA's FFT), and precision tiers")
    table = []
    for name, shape in shapes:
        x = s.cplx(shape)
        xd = jax.device_put(x.astype(np.complex64))
        api = getattr(kt, name)
        ref = getattr(np.fft, name)(x.astype(np.complex128))
        row = {"api": name, "shape": list(shape)}
        scale = 1.0 / np.sqrt(shape[-1] if name == "fft" else x.size)
        for backend in ("auto", "jnpfft"):
            fn = jax.jit(lambda a, b=backend: api(a, backend=b))
            t = _median_time(fn, xd, reps)
            snr = snr_db(ref, fn(xd))
            # per-op device-bound time: chained applications in one
            # executable (one launch), unitary scaling keeps the norm
            tc = timeit_chained(
                lambda a, b=backend: api(a, backend=b) * scale, xd,
                iters=chain)
            row[backend] = {"ms": t * 1e3, "chained_ms": tc * 1e3,
                            "snr_db": snr}
            s.check(f"{api.__name__} {shape} backend={backend}", snr,
                    F32_FLOOR_DB, None, t)
            s.expect(f"  chained x{chain}", True, f"{tc * 1e3:.4f} ms/op")
        table.append(row)
        del xd, ref
    cases = _tier_cases(s, **(tiers or {}))
    for tier in ("highest", "high", "default"):
        set_precision(tier)
        try:
            for i, (label, f, x, ref, timed) in enumerate(cases):
                fn = jax.jit(lambda a, f=f: f(a))
                xd = jax.device_put(x)
                snr = snr_db(ref, fn(xd))
                t = _median_time(fn, xd, reps) if timed else None
                dots = _dot_algorithms(fn, xd) if i == 0 else ""
                ts = "" if t is None else f", {t * 1e3:.3f} ms"
                s.expect(f"{label} precision={tier}", True,
                         f"SNR {snr:.1f} dB{ts}"
                         + (f", dots: {dots}" if dots else ""))
                table.append({"call": label, "tier": tier, "snr_db": snr,
                              "ms": None if t is None else t * 1e3,
                              **({"dots": dots} if dots else {})})
        finally:
            set_precision(None)
    return table


def _tier_cases(s: Smoke, n: int = 1 << 20, grid: int = 1024,
                cube: int = 128, win: int = 1024, hop: int = 256) -> list:
    """(label, public call, input, f64 reference, timed) for the SNR of
    each precision tier; the first two are also timed."""
    import kofft_tpu as kt
    from kofft_tpu.ops import window as W
    x1, x2 = s.cplx((n,)), s.cplx((grid, grid))
    xb, x3 = s.cplx((8, n)), s.cplx((cube,) * 3)
    xr = s.real((n,))
    xr64 = xr.astype(np.float64)
    w = np.asarray(W.hann(win), np.float32)
    c64, c128 = np.complex64, np.complex128
    return [
        (f"fft ({n},)", kt.fft, x1.astype(c64),
         np.fft.fft(x1.astype(c128)), True),
        (f"fft2 ({grid}, {grid})", kt.fft2, x2.astype(c64),
         np.fft.fft2(x2.astype(c128)), True),
        (f"fft (8, {n})", kt.fft, xb.astype(c64),
         np.fft.fft(xb.astype(c128)), False),
        (f"rfft ({n},)", kt.rfft, xr, np.fft.rfft(xr64), False),
        (f"fftn {(cube,) * 3}", kt.fftn, x3.astype(c64),
         np.fft.fftn(x3.astype(c128)), False),
        (f"stft ({n},) hann {win} hop {hop} one-sided",
         lambda a: kt.stft(a, w, hop, onesided=True), xr,
         _stft_ref(xr64, w, hop)[:, : win // 2 + 1], False),
        ("istft(stft) interior",
         lambda a: kt.istft(kt.stft(a, w, hop), w, hop, length=n)[win:-win],
         xr, xr64[win:-win], False),
    ]


def _dot_algorithms(fn, arg) -> str:
    """What the compiled program asks of its matmuls: the distinct
    precision/algorithm settings of its dots and GEMM calls."""
    import re
    txt = fn.lower(arg).compile().as_text()
    found = set(re.findall(
        r'(?:algorithm=\w+|"precision_config":\{[^}]*\}|'
        r'"compute_type":"\w+"|operand_precision=\{[^}]*\})', txt))
    return "; ".join(sorted(found)) or "no dot settings in HLO"


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _plane_snr_db(got, want) -> float:
    """SNR of the (re, im) planes ``got`` against ``want``, computed on
    the device that holds ``want`` without forming complex arrays."""
    import jax
    import jax.numpy as jnp
    dev = next(iter(want[0].devices()))
    err = sig = 0.0
    for g, w in zip(got, want):
        g = jax.device_put(g, dev)
        err += float(jnp.sum((g - w) ** 2))
        sig += float(jnp.sum(w * w))
        del g
    return float(10.0 * np.log10(sig / err)) if err else float("inf")


def _spread(x) -> str:
    return ", ".join(sorted(str(d.id) for d in x.devices()))


def phase_four(s: Smoke, grid: int = 1024, n_long: int = 1 << 28,
               audio_s: float = 3600.0, rate: int = 16000,
               win: int = 512, hop: int = 160, batch: int = 64,
               clip_s: float = 1.0) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import kofft_tpu as kt
    from kofft_tpu.ops import window as W
    from kofft_tpu.parallel import (fft_sharded, fftn_sharded, istft_sharded,
                                    make_mesh, stft_sharded)
    from kofft_tpu.parallel.validate import check_fft_sharded_comm_volume
    devs = jax.devices()
    d = 4
    mesh = make_mesh(d)
    one = devs[0]
    sh0 = NamedSharding(mesh, P("d"))
    key = jax.random.PRNGKey(0)

    def normal(k, shape, sharding):
        return jax.jit(lambda kk: jax.random.normal(kk, shape, jnp.float32),
                       out_shardings=sharding)(k)

    s.begin(f"four cards: fftn_sharded {grid}^3 c64 vs one-card fftn")
    shape = (grid, grid, grid)
    k1, k2, key = jax.random.split(key, 3)
    xr = normal(k1, shape, sh0)
    xi = normal(k2, shape, sh0)
    s.expect("input spread", len(xr.devices()) == d,
             f"devices {_spread(xr)}")
    t0 = time.perf_counter()
    ys = jax.block_until_ready(fftn_sharded(xr, xi, mesh=mesh))
    first = time.perf_counter() - t0
    del ys
    t0 = time.perf_counter()
    ys = jax.block_until_ready(fftn_sharded(xr, xi, mesh=mesh))
    warm = time.perf_counter() - t0
    s.expect("output spread", len(ys[0].devices()) == d,
             f"devices {_spread(ys[0])}")
    x1 = (jax.device_put(xr, one), jax.device_put(xi, one))
    del xr, xi
    t0 = time.perf_counter()
    z = jax.block_until_ready(kt.fftn_split(*x1))
    t_one = time.perf_counter() - t0
    del x1
    s.check(f"fftn_sharded {shape} vs one card", _plane_snr_db(ys, z),
            F32_FLOOR_DB, max(first - warm, 0.0), warm)
    s.expect("one-card fftn (first call)", True, f"{t_one:.3f}s")
    del ys, z

    s.begin(f"four cards: fft_sharded 2^{n_long.bit_length() - 1} vs "
            f"jnp.fft on one card")
    k1, k2, key = jax.random.split(key, 3)
    xr = normal(k1, (n_long,), sh0)
    xi = normal(k2, (n_long,), sh0)
    t0 = time.perf_counter()
    yr, yi = jax.block_until_ready(
        fft_sharded(xr, xi, mesh=mesh, restore_layout=True))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    yr, yi = jax.block_until_ready(
        fft_sharded(xr, xi, mesh=mesh, restore_layout=True))
    warm = time.perf_counter() - t0
    s.expect("output spread", len(yr.devices()) == d,
             f"devices {_spread(yr)}")
    z = jax.jit(lambda a, b: (lambda y: (jnp.real(y), jnp.imag(y)))(
        jnp.fft.fft(jax.lax.complex(a, b))))(jax.device_put(xr, one),
                                             jax.device_put(xi, one))
    s.check(f"fft_sharded ({n_long},) vs jnp.fft", _plane_snr_db((yr, yi), z),
            F32_FLOOR_DB, max(first - warm, 0.0), warm)
    del yr, yi, z, xr, xi
    rep = check_fft_sharded_comm_volume(n_long, mesh, restore_layout=True)
    s.expect("HLO all_to_all volume audit", True,
             f"{rep['local_a2a_bytes']} B local = canonical, "
             f"{rep['total']} all-to-alls")

    s.begin(f"four cards: stft_sharded + istft_sharded on "
            f"{audio_s:g} s of {rate} Hz audio")
    n = int(audio_s * rate)
    n -= n % (d * hop)
    w = np.asarray(W.hann(win), np.float32)
    sig = normal(key, (n,), sh0)
    t0 = time.perf_counter()
    fr, fi = jax.block_until_ready(stft_sharded(sig, w, hop, mesh=mesh))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    fr, fi = jax.block_until_ready(stft_sharded(sig, w, hop, mesh=mesh))
    warm = time.perf_counter() - t0
    s.expect("frames spread", len(fr.devices()) == d,
             f"devices {_spread(fr)}")
    sig1 = jax.device_put(sig, one)
    g = kt.stft_split(sig1, w, hop)
    s.check(f"stft_sharded ({n},) vs one card", _plane_snr_db((fr, fi), g),
            F32_FLOOR_DB, max(first - warm, 0.0), warm)
    out = jax.block_until_ready(istft_sharded(fr, fi, w, hop, mesh=mesh))
    back = kt.istft_split(*g, w, hop)
    del g
    m = out.shape[0]
    s.check("istft_sharded vs one-card istft (interior)",
            _plane_snr_db((jax.device_put(out, one)[win:m - win],),
                          (back[win:m - win],)), F32_FLOOR_DB)
    del fr, fi, out, back, sig, sig1

    s.begin(f"four cards: SpectralNet dp=2 x tp=2 step at batch {batch}")
    from kofft_tpu.models import SpectralNet
    from kofft_tpu.models.spectral_net import SpectralNetParams, loss_fn
    mesh2 = Mesh(np.asarray(devs[:4]).reshape(2, 2), ("dp", "tp"))
    model = SpectralNet()
    params = model.init(seed=0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((batch, int(clip_s * rate)), dtype=np.float32)
    y = rng.integers(0, model.n_classes, size=(batch,)).astype(np.int32)

    def step(p, xx, yy):
        loss, grads = jax.value_and_grad(
            lambda q: loss_fn(model, q, xx, yy))(p)
        return jax.tree_util.tree_map(lambda a, g: a - 1e-2 * g, p,
                                      grads), loss

    psh = SpectralNetParams(mel=NamedSharding(mesh2, P(None, "tp")),
                            w_head=NamedSharding(mesh2, P("tp", None)),
                            b_head=NamedSharding(mesh2, P()))
    pd = jax.device_put(params, psh)
    xd = jax.device_put(x, NamedSharding(mesh2, P("dp", None)))
    yd = jax.device_put(y, NamedSharding(mesh2, P("dp")))
    t0 = time.perf_counter()
    new, loss = jax.block_until_ready(jax.jit(step)(pd, xd, yd))
    first = time.perf_counter() - t0
    s.expect("params spread", len(new.mel.devices()) == d,
             f"devices {_spread(new.mel)}")
    new1, loss1 = jax.jit(step)(jax.device_put(params, one),
                                jax.device_put(x, one),
                                jax.device_put(y, one))
    rel = abs(float(loss) - float(loss1)) / abs(float(loss1))
    s.expect("dp x tp loss vs one card", rel <= 1e-5,
             f"{float(loss):.7f} vs {float(loss1):.7f} (rel {rel:.1e}, "
             f"tol 1e-5), first step {first:.2f}s")
    s.check("dp x tp updated params vs one card",
            snr_db(np.concatenate([np.ravel(np.asarray(a)) for a in new1]),
                   np.concatenate([np.ravel(np.asarray(a)) for a in new])),
            F32_FLOOR_DB)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run the sharded transforms on four cards, "
                         "and nothing else")
    args = ap.parse_args(argv)
    if args.four:
        # the one-card comparisons hold an 8 GB grid, its transform and
        # the gathered sharded result on device 0 at once
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")
    devs = require_gpu()
    import jax
    import kofft_tpu as kt
    from kofft_tpu.bench import card_info
    print(f"compile cache: {kt.enable_compilation_cache()}")
    card = card_info()
    if not card:
        sys.exit("chip_smoke: nvidia-smi gave no card name and power limit")
    for name, limit in zip(card["gpu"], card["power_limit"]):
        print(f"card: {name}, {limit}")
    print(f"device: {devs[0].device_kind} x{len(devs)}, "
          f"jax {jax.__version__}", flush=True)
    s = Smoke(seed=args.seed)
    t0 = time.perf_counter()
    if args.four:
        if len(devs) < 4:
            sys.exit(f"--four needs 4 GPUs, found {len(devs)}")
        phase_four(s)
    else:
        phase_fft_1d(s)
        phase_rfft(s)
        phase_nd(s)
        phase_stft(s)
        phase_other(s)
        phase_models(s)
        table = phase_engines(s)
        phase_f64(s)
        print("phase 8 table: " + json.dumps(table))
    s.end()
    print(f"total {time.perf_counter() - t0:.1f}s, "
          f"{len(s.rows)} checks, {len(s.failed)} failed")
    if s.failed:
        for f in s.failed:
            print(f"FAILED: {f}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
