"""The benchmark's command: one run of one cell on this machine's cards.

    python3 -m bench.run --workload s14-count-k7 --seed 7 --seconds 51 --trace 0

Run from the root of a checkout.  The last line of standard output is the
result as one JSON object; the numbers the verdict compared, each beside
its limit, are the last lines of standard error.  Without a CUDA device,
with fewer than the cell's chips, or without the program's sources
(``src/repro_torch``) beside ``bench/``, it prints no result and exits 2;
if JAX or the JAX package (top-level ``jax``, ``jaxlib``, ``flax``,
``repro``) was loaded, it names them and exits 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        _log(f"no program at {ROOT / 'src' / 'repro_torch'}: nothing to run")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from bench import harness

    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        _log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
             f"{have} available")
        return 2
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, log=_log)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        _log(f"nvidia-smi: {smi.stdout.strip()}")
    except (OSError, subprocess.SubprocessError) as exc:
        _log(f"nvidia-smi: not read ({exc})")
    found = harness.forbidden_modules()
    if found:
        _log(f"loaded in this process, which may not load them: "
             f"{', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        _log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
