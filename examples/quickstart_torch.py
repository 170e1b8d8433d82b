"""Quickstart of the PyTorch/CUDA port: list and count k-cliques with EBBkC.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # no card

The twin of ``examples/quickstart.py`` on ``repro_torch``: the host
engines (EBBkC's python-int recursion and the VBBkC baseline) count the
same cliques, the listing and the device engine run on the CUDA device
by default (raising without one), and the last line says whether the
device engine agrees with the host count.
"""
import argparse

from repro_torch.core import ebbkc, vbbkc
from repro_torch.device import resolve_device
from repro_torch.core.graph import degeneracy_order
from repro_torch.core.truss import truss_decomposition
from repro_torch.data import planted_cliques


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the device engine (default: the "
                         "CUDA device; 'cpu' runs the plain torch versions)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # build a graph: 5 planted 8-cliques + noise
    g = planted_cliques(400, 5, 8, p_noise=0.01, seed=1)
    td = truss_decomposition(g)
    _, delta = degeneracy_order(g)
    print(f"graph: n={g.n} m={g.m} tau={td.tau} delta={delta} "
          f"(Lemma 4.1: tau < delta -> {td.tau < delta})")

    for k in (4, 5, 6):
        r = ebbkc.count(g, k, order="hybrid", et_t=3,
                        backend="host")                    # EBBkC-H + ET
        v = vbbkc.count(g, k, variant="ddegcol")           # VBBkC baseline
        assert r.count == v.count
        print(f"k={k}: {r.count} cliques | EBBkC branches="
              f"{r.stats.branches} et_hits={r.stats.et_hits} vs VBBkC "
              f"branches={v.stats.branches}")

    # list the 6-cliques (bounded output) with the list kernel
    cliques, _ = ebbkc.list_cliques(g, 6, max_out=10, device=device)
    print("first 6-cliques:", cliques[:3].tolist())

    # the device engine (the count kernels on the card by default)
    r_dev = ebbkc.count(g, 5, device=device)
    host = ebbkc.count(g, 5, backend="host").count
    print(f"device engine agrees: {r_dev.count == host} "
          f"(engine: {r_dev.stats.backend})")


if __name__ == "__main__":
    main()
