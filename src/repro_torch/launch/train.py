"""Training launcher: ``python -m repro_torch.launch.train --arch granite-3-8b``.

    python -m repro_torch.launch.train --arch granite-3-8b [--shape train_4k]
        [--steps 20] [--full] [--ckpt-dir DIR] [--ckpt-every 10]
        [--fail-at N] [--device cpu]

The port of the reference's ``launch.train`` for the LM family: the
fault-tolerant ``TrainLoop`` over ``launch.steps``' train step, on the
CUDA device by default (raising without one); ``--device cpu`` runs it on
the CPU.  The reduced config by default (B, S = 2, min(S, 64), one
microbatch), ``--full`` the arch's published widths.  Params are drawn
from a ``torch.Generator`` seeded 1 on the device.  Auto-resumes from
``--ckpt-dir`` if a committed checkpoint exists; ``--fail-at N`` raises
before step N (a simulated crash).  The GNN and recsys archs are not
ported yet (the registry raises, naming ROADMAP A13d).
"""
from __future__ import annotations

import argparse

import torch

from .. import configs
from ..data import LMDataPipeline
from ..device import resolve_device
from ..models import transformer as tr
from ..optim import adamw_init
from ..runtime import TrainLoop, TrainLoopConfig
from .steps import lm_train_cell


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
    if spec.family != "lm":
        raise SystemExit(f"train launcher drives LM archs; {args.arch!r} "
                         f"is {spec.family!r}")
    shape = args.shape or next(
        n for n, c in spec.cells.items() if c.kind == "train" and not c.skip)
    device = resolve_device(args.device)
    ts = lm_train_cell(spec, spec.cells[shape], reduced=not args.full)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    params = tr.init_params(gen, ts.cfg, device)
    pipeline = LMDataPipeline(vocab=ts.cfg.vocab, batch=ts.batch,
                              seq_len=ts.seq_len)
    loop = TrainLoop(
        TrainLoopConfig(total_steps=args.steps,
                        checkpoint_dir=args.ckpt_dir,
                        checkpoint_every=args.ckpt_every,
                        fail_at_step=args.fail_at),
        ts.step_fn, params, adamw_init(params), pipeline)
    out = loop.run()
    m = {k: float(v) for k, v in out["metrics"].items()}
    print(f"done at step {out['final_step']} on {device}: {m}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
