"""Training launcher: ``python -m repro_torch.launch.train --arch granite-3-8b``.

    python -m repro_torch.launch.train --arch ARCH [--shape SHAPE]
        [--steps 20] [--full] [--ckpt-dir DIR] [--ckpt-every 10]
        [--fail-at N] [--device cpu]

The port of the reference's ``launch.train``: the fault-tolerant
``TrainLoop`` over ``launch.steps``' train step of an LM, GNN (gin-tu,
meshgraphnet, egnn, nequip) or recsys (dcn-v2) arch, on the CUDA device
by default (raising without one); ``--device cpu`` runs it on the CPU.
The reduced config by default, ``--full`` the arch's published widths;
the shape is the arch's first train cell unless ``--shape`` names one.
Params are drawn from a ``torch.Generator`` seeded 1 on the device: the
LM family's own init, and for the GNN and recsys families the
reference's rule (every float leaf normal x 0.02, every int leaf 0).
The batches come from the family's pipeline: ``LMDataPipeline``, the
reference launcher's GNN pipeline (:class:`GnnPipeline`) and
``RecsysPipeline``.  Auto-resumes from ``--ckpt-dir`` if a committed
checkpoint exists; ``--fail-at N`` raises before step N (a simulated
crash).
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch

from .. import configs
from ..data import LMDataPipeline, RecsysPipeline
from ..device import resolve_device
from ..models import transformer as tr
from ..optim import adamw_init, tree_leaves, tree_unflatten
from ..runtime import TrainLoop, TrainLoopConfig
from .steps import gnn_train_cell, lm_train_cell, recsys_cell

FAMILIES = ("lm", "gnn", "recsys")


class GnnPipeline:
    """The reference launcher's GNN batches (its ``_GnnPipe``): step s
    draws every input of ``batch_shapes`` in order from
    ``default_rng([7, s])``, integers in ``[0, max(n_nodes, 2))`` and
    floats standard normal, then sets ``edge_mask`` to ones (after its
    draw, which still advances the generator).  Byte-identical to the
    reference's batches."""

    def __init__(self, batch_shapes: Dict[str, Tuple], n_nodes: int):
        self.batch_shapes = batch_shapes
        self.n_nodes = n_nodes
        self.step = 0

    def next_batch(self):
        rng = np.random.default_rng([7, self.step])
        self.step += 1
        out = {}
        for k, (shape, dtype) in self.batch_shapes.items():
            if np.issubdtype(dtype, np.integer):
                hi = max(self.n_nodes, 2)
                out[k] = rng.integers(0, hi, shape).astype(dtype)
            else:
                out[k] = rng.normal(size=shape).astype(dtype)
        if "edge_mask" in out:
            out["edge_mask"] = np.ones_like(out["edge_mask"])
        return out

    def state(self):
        return {"step": self.step}

    def restore(self, s):
        self.step = int(s["step"])


def drawn_params(init, gen: torch.Generator, device):
    """The reference launcher's params for the GNN and recsys families:
    the tree ``init`` makes, every float leaf drawn normal x 0.02 from
    ``gen`` in tree order, every int leaf zeros."""
    shapes = init(torch.Generator(), "meta")

    def draw(leaf):
        if not leaf.is_floating_point():
            return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
        out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
        return out.normal_(generator=gen).mul_(0.02)
    return tree_unflatten(shapes, [draw(x) for x in tree_leaves(shapes)])


def build(spec, shape: str, reduced: bool, device):
    """(step_fn, params, pipeline) of ``spec``'s train cell ``shape``,
    params drawn on ``device`` from a generator seeded 1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    cell = spec.cells[shape]
    if spec.family == "lm":
        ts = lm_train_cell(spec, cell, reduced=reduced)
        return (ts.step_fn, tr.init_params(gen, ts.cfg, device),
                LMDataPipeline(vocab=ts.cfg.vocab, batch=ts.batch,
                               seq_len=ts.seq_len))
    if spec.family == "gnn":
        mc = gnn_train_cell(spec, cell, reduced=reduced)
        pipe = GnnPipeline(mc.batch_shapes, mc.meta["n_nodes"])
    elif spec.family == "recsys":
        mc = recsys_cell(spec, cell, reduced=reduced)
        cfg = mc.cfg
        pipe = RecsysPipeline(n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                              vocab=cfg.vocab, batch=mc.meta["batch"],
                              bag=cfg.bag)
    else:
        raise KeyError(spec.family)
    return mc.step_fn, drawn_params(mc.init, gen, device), pipe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths (default: its "
                         "reduced smoke config)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, which "
                         "must exist; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    spec = configs.get(args.arch)
    if spec.family not in FAMILIES:
        raise SystemExit(f"train launcher drives the {FAMILIES} families; "
                         f"{args.arch!r} is {spec.family!r}")
    shape = args.shape or next(
        n for n, c in spec.cells.items() if c.kind == "train" and not c.skip)
    device = resolve_device(args.device)
    step_fn, params, pipeline = build(spec, shape, not args.full, device)
    loop = TrainLoop(
        TrainLoopConfig(total_steps=args.steps,
                        checkpoint_dir=args.ckpt_dir,
                        checkpoint_every=args.ckpt_every,
                        fail_at_step=args.fail_at),
        step_fn, params, adamw_init(params), pipeline)
    out = loop.run()
    m = {k: float(v) for k, v in out["metrics"].items()}
    print(f"done at step {out['final_step']} on {device}: {m}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
