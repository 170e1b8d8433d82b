"""The verdict's control: the reference put in the program's place, with
one of the configuration's guarantees broken, judged by the same verdict.

    python3 -m bench.control --workload s14-count-k7 --seeds 1,2,3

A count cell's control sums the reference's partial counts in float32,
the nearest precision below the exact int64 count the configuration
states.  A list cell's control lists with a fixed emit buffer of
:data:`CONTROL_CAP` rows per anchor edge that truncates on overflow,
where the configuration states that no listing is ever truncated.  Each
must come out not correct; the seeds' readings are printed, one JSON
object a seed.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import graph500, harness
from .reference import kclique

#: rows per anchor edge the list control keeps
CONTROL_CAP = 8192


def control_checks(cell_name: str, seed: int, device: str,
                   config: dict = None) -> dict:
    spec = harness.load_spec()
    cell = harness.find_cell(spec, cell_name)
    config = config or harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    n, edges = graph500.graph_for(config, seed)
    k = int(traffic["k"])
    if traffic["query"] == "count":
        q = harness.Query(0.0, count=kclique.count_kcliques(
            n, edges, k, device, accumulate="float32"))
    else:
        q = harness.Query(0.0, rows=kclique.list_kcliques(
            n, edges, k, device, cap=CONTROL_CAP))
    checks, _ = harness.verdict(traffic, n, edges, [q], device)
    return {"seed": seed, "correct": harness.passed(checks),
            "checks": {name: c["value"] for name, c in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds.split(","):
        print(json.dumps(control_checks(args.workload, int(seed),
                                        "cuda:0")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
