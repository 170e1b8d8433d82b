"""Train a small LM (~10M params) for a few hundred steps with the port's
stack: arch registry config, data pipeline, AdamW + schedule and the
fault-tolerant loop (the twin of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 [--device cpu]

Runs on the CUDA device by default (raising without one); ``--device
cpu`` runs on the CPU.  ``--ckpt DIR`` checkpoints every 100 steps and
resumes from DIR (off by default).  Prints the first and the final loss.
"""
import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.data import LMDataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import transformer as tr
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, tree_leaves)
from repro_torch.runtime import TrainLoop, TrainLoopConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, which "
                         "must exist; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # granite family scaled to ~10M params
    base = configs.get("granite-3-8b").reduced
    cfg = dataclasses.replace(base, n_layers=4, d_model=128, n_heads=8,
                              n_kv_heads=4, d_head=16, d_ff=512, vocab=512)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = tr.init_params(gen, cfg, device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {n_params / 1e6:.1f}M params on {device}")
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=3e-3, weight_decay=0.01,
                       schedule=cosine_schedule(20, args.steps))
    losses = []

    def step(params, opt, batch):
        loss, grads = loss_and_grads(params, batch, cfg, 1)
        params, opt, m = adamw_update(grads, opt, params, ocfg)
        losses.append(loss)
        return params, opt, {"loss": loss, **m}

    pipe = LMDataPipeline(vocab=cfg.vocab, batch=8, seq_len=64, seed=0)
    loop = TrainLoop(TrainLoopConfig(total_steps=args.steps,
                                     checkpoint_dir=args.ckpt,
                                     checkpoint_every=100),
                     step, params, opt, pipe)
    out = loop.run()
    if not losses:
        print(f"nothing to do: resumed at step {out['final_step']}")
        return
    print(f"first loss {float(losses[0]):.4f}; finished at step "
          f"{out['final_step']}: loss={float(losses[-1]):.4f} (stragglers "
          f"logged: {len(out['stragglers'])})")


if __name__ == "__main__":
    main()
