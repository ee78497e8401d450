"""Dev driver CLI (the reference's ``xtask`` equivalent, component 27).

The reference xtask detects host CPU capabilities and computes feature
flags/RUSTFLAGS (``xtask/src/lib.rs:25-111``); here the analogous detection
is the JAX platform/device topology, and the subcommands wrap the dev
workflows: info / test / bench / smoke / lint / sanity /
update-bench-readme. Subcommands that run the program do so in a child
process, one at a time; the parent never touches the device meanwhile.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def cmd_info(_args) -> int:
    import jax
    print(f"platform:  {jax.default_backend()}")
    devs = jax.devices()
    print(f"devices:   {len(devs)} x {devs[0].device_kind if devs else '-'}")
    print(f"jax:       {jax.__version__}")
    from kofft_tpu.config import get_config
    cfg = get_config()
    print(f"backend:   {cfg.backend}")
    print(f"dft_cutoff: {cfg.dft_cutoff}  precision: {cfg.precision}  "
          f"shard_threshold: {cfg.shard_threshold}")
    if len(devs) > 1:
        print(f"suggested mesh: 1-D ({len(devs)},) axis 'd'")
    return 0


def cmd_test(args) -> int:
    cmd = [sys.executable, "-m", "pytest", "tests/", "-q"]
    if args.k:
        cmd += ["-k", args.k]
    if args.x:
        cmd += ["-x"]
    return subprocess.call(cmd, cwd=REPO)


def cmd_bench(_args) -> int:
    return subprocess.call([sys.executable, "bench.py"], cwd=REPO)


def cmd_smoke(args) -> int:
    """The on-card smoke run (chip_smoke.py); ``--four`` runs the sharded
    transforms on four GPUs instead."""
    cmd = [sys.executable, "chip_smoke.py"] + (["--four"] if args.four
                                               else [])
    return subprocess.call(cmd, cwd=REPO)


def cmd_coverage(_args) -> int:
    """Vendored stdlib-only 90% line-coverage gate (writes
    benchmarks/coverage.json)."""
    return subprocess.call(
        [sys.executable, "tools/coverage_gate.py", "--fail-under", "90"],
        cwd=REPO)


def cmd_lint(_args) -> int:
    """Byte-compile every source file (import-safety gate) and require a
    clean git tree. The analog of the reference xtask's fmt/clippy gate
    (xtask/src/main.rs:12-60)."""
    import compileall
    ok = compileall.compile_dir(str(REPO / "kofft_tpu"), quiet=1)
    ok &= compileall.compile_file(str(REPO / "bench.py"), quiet=1)
    ok &= compileall.compile_file(str(REPO / "tasks.py"), quiet=1)
    dirty = subprocess.run(
        ["git", "status", "--porcelain"], cwd=REPO,
        capture_output=True, text=True).stdout.strip()
    if dirty:
        print("lint: dirty tree:")
        print(dirty)
        ok = False
    print("lint:", "OK" if ok else "FAILED")
    return 0 if ok else 1


def cmd_sanity(args) -> int:
    """Synthesize a tone and render a spectrogram PNG (smoke test)."""
    import numpy as np
    from kofft_tpu.utils.audio import write_wav
    out_dir = Path(args.out or (REPO / "target"))
    out_dir.mkdir(parents=True, exist_ok=True)
    wav = out_dir / "tone.wav"
    sr = 16000
    t = np.arange(sr * 2) / sr
    write_wav(wav, 0.5 * np.sin(2 * np.pi * 440 * t)
              + 0.25 * np.sin(2 * np.pi * 2000 * t), sr)
    png = out_dir / "tone.png"
    rc = subprocess.call(
        [sys.executable, "-m", "kofft_tpu.cli.sanity_check", str(wav),
         str(png)], cwd=REPO)
    if rc == 0:
        print(f"wrote {png}")
    return rc


def cmd_web(args) -> int:
    """Serve the streaming spectrogram app (reference ``xtask
    web-spectrogram``, ``xtask/src/main.rs``)."""
    from kofft_tpu.web.server import make_server
    srv = make_server(args.port)
    host, port = srv.server_address[:2]
    print(f"spectrogram app on http://{host}:{port} (ctrl-c to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
    return 0


def cmd_examples(_args) -> int:
    """Run every example (smoke; the CI examples job's local twin)."""
    import subprocess
    rc = 0
    for ex in sorted((REPO / "examples").glob("*.py")):
        print(f"== {ex.name}")
        r = subprocess.run([sys.executable, str(ex)])
        rc = rc or r.returncode
    return rc


def cmd_update_bench_readme(_args) -> int:
    """Regenerate the benchmark table in benchmarks/README.md from
    latest.json (reference update_bench_readme.rs:33-82)."""
    latest = REPO / "benchmarks" / "latest.json"
    if not latest.exists():
        print("no benchmarks/latest.json — run `python tasks.py bench`")
        return 1
    doc = json.loads(latest.read_text())
    env = doc["environment"]
    card = ", ".join(f"{g} at {p}" for g, p in zip(
        env.get("gpu", []), env.get("power_limit", [])))
    lines = [
        "# kofft benchmarks",
        "",
        f"Environment: {env['device_count']} x {env['device_kind']} "
        f"({card or 'no nvidia-smi'}), jax {env['jax_version']}, "
        f"run {env['timestamp']}.",
        "",
        "| Library | Transform | N | Mode | Time/op | Ops/sec | SNR | vs prev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in doc["records"]:
        tpo = r["time_per_op_ns"]
        t = (f"{tpo / 1e6:.3f} ms" if tpo >= 1e6 else f"{tpo / 1e3:.1f} us")
        chg = ("" if r.get("change_vs_prev") is None
               else f"{r['change_vs_prev'] * 100:+.1f}%")
        snr = ("" if r.get("snr_db") is None else f"{r['snr_db']:.1f} dB")
        lines.append(f"| {r['library']} | {r['transform']} | {r['size']} | "
                     f"{r['mode']} | {t} | {r['ops_per_sec']:.1f} | {snr} "
                     f"| {chg} |")
    (REPO / "benchmarks" / "README.md").write_text("\n".join(lines) + "\n")
    print("benchmarks/README.md updated")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tasks.py")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("info")
    t = sub.add_parser("test")
    t.add_argument("-k", default=None)
    t.add_argument("-x", action="store_true")
    sub.add_parser("bench")
    c = sub.add_parser("smoke")
    c.add_argument("--four", action="store_true")
    sub.add_parser("coverage")
    sub.add_parser("lint")
    s = sub.add_parser("sanity")
    s.add_argument("--out", default=None)
    sub.add_parser("update-bench-readme")
    w = sub.add_parser("web")
    w.add_argument("--port", type=int, default=3000)
    sub.add_parser("examples")
    args = p.parse_args(argv)
    return {"info": cmd_info, "test": cmd_test, "bench": cmd_bench,
            "smoke": cmd_smoke, "coverage": cmd_coverage,
            "lint": cmd_lint, "sanity": cmd_sanity,
            "update-bench-readme": cmd_update_bench_readme,
            "web": cmd_web, "examples": cmd_examples}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
