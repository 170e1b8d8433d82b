"""Serving launcher: batched greedy prefill + decode over synthetic requests.

    python -m repro_torch.launch.serve --arch granite-3-8b --requests 8 \\
        --prompt-len 32 --tokens 16 [--full] [--device cpu]

The port of the reference's ``launch.serve``: the same loop (prefill the
prompts, then greedy decode with argmax over the padded vocab), on the
CUDA device by default (raising without one); ``--device cpu`` runs it on
the CPU.  Params are drawn from a seeded ``torch.Generator`` on the
device; ``--full`` takes the arch's published widths, the default its
reduced smoke config.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import configs
from ..device import resolve_device
from ..models import transformer as tr


@dataclasses.dataclass
class Generation:
    """What one batched greedy run gave back."""
    tokens: torch.Tensor                 # (B, n) generated ids
    prefill_logits: torch.Tensor         # (B, padded_vocab), last position
    decode_logits: Optional[torch.Tensor]  # first decode step's, if any
    prefill_s: float
    decode_s: float


def make_inputs(cfg: tr.TransformerConfig, requests: int, prompt_len: int,
                device, seed: int = 0) -> Tuple[Dict, torch.Tensor]:
    """Seeded params and prompts (ids in [0, vocab)) on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = tr.init_params(gen, cfg, device)
    prompts = torch.randint(0, cfg.vocab, (requests, prompt_len),
                            generator=gen, device=device)
    return params, prompts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(params, prompts: torch.Tensor, cfg: tr.TransformerConfig,
             tokens: int) -> Generation:
    """Prefill ``prompts`` (B, S), then ``tokens - 1`` greedy decode steps.

    Times are host clocks around work that ends in a device sync.
    """
    device = prompts.device
    B, S = prompts.shape
    max_len = S + tokens
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = tr.prefill(params, prompts, cfg, max_len=max_len)
    prefill_logits = logits
    nxt = torch.argmax(logits, -1)[:, None]
    _sync(device)
    t1 = time.perf_counter()
    lengths = torch.full((B,), S, dtype=torch.int64, device=device)
    out_tokens = [nxt]
    decode_logits = None
    for _ in range(tokens - 1):
        logits, cache = tr.decode_step(params, cache, nxt, lengths, cfg)
        if decode_logits is None:
            decode_logits = logits
        nxt = torch.argmax(logits, -1)[:, None]
        lengths = lengths + 1
        out_tokens.append(nxt)
    gen = torch.cat(out_tokens, dim=1)
    _sync(device)
    t2 = time.perf_counter()
    return Generation(gen, prefill_logits, decode_logits, t1 - t0, t2 - t1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths (default: its "
                         "reduced smoke config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, which "
                         "must exist; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    spec = configs.get(args.arch)
    if spec.family != "lm":
        raise SystemExit(f"serve launcher drives LM archs; {args.arch!r} "
                         f"is {spec.family!r}")
    cfg = spec.full if args.full else spec.reduced
    device = resolve_device(args.device)
    params, prompts = make_inputs(cfg, args.requests, args.prompt_len,
                                  device)
    out = generate(params, prompts, cfg, args.tokens)
    B = args.requests
    dt = out.prefill_s + out.decode_s
    print(f"served {B} requests x {args.tokens} tokens in {dt:.2f}s "
          f"({B * args.tokens / dt:.1f} tok/s) on {device}")
    print("sample:", np.asarray(out.tokens[0].cpu())[:10])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
