"""Shared model building blocks (plain functions on tensors).

The port of the reference's ``models.common``: the same formulas, in
torch.  Initialisers take an explicit ``torch.Generator`` and the device
to make the tensor on; the generator must live on that device.  Random
draws differ from ``jax.random``'s, so parity tests carry the reference's
weights across (:func:`repro_torch.convert.lm_params_to_torch`).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F


def uniform_init(gen: torch.Generator, shape, scale, device,
                 dtype=torch.float32) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.uniform_(-scale, scale, generator=gen)


def normal_init(gen: torch.Generator, shape, stddev, device,
                dtype=torch.float32) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(0.0, 1.0, generator=gen).mul_(stddev)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, device,
               dtype=torch.float32) -> torch.Tensor:
    """LeCun-normal weight for a (d_in, d_out) matmul."""
    return normal_init(gen, (d_in, d_out), (1.0 / d_in) ** 0.5, device, dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm in f32 with the scale stored as an offset from 1 (zeros
    at init), cast back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _squared_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu":
        return F.relu
    if name == "squared_relu":  # Primer / Nemotron-4
        return _squared_relu
    raise ValueError(f"unknown activation {name}")


def init_mlp(gen: torch.Generator, dims: Sequence[int], device,
             dtype=torch.float32):
    """Plain MLP params: list of {"w", "b"}."""
    return [{"w": dense_init(gen, dims[i], dims[i + 1], device, dtype),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=device)}
            for i in range(len(dims) - 1)]


def apply_mlp(params, x: torch.Tensor, act: str = "relu",
              final_act: bool = False) -> torch.Tensor:
    fn = act_fn(act)
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or final_act:
            x = fn(x)
    return x


def rope_frequencies(d_head: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exps = -torch.arange(0, d_head, 2, dtype=torch.float32,
                         device=device) / d_head
    return torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    Half-split layout (not interleaved): the first D/2 features rotate
    against the last D/2.
    """
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)          # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in f32; labels -100 are masked."""
    logits = logits.float()
    mask = (labels >= 0).float()
    labels_c = labels.clamp_min(0)
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    if z_loss:
        loss = loss + z_loss * ((logz * mask) ** 2).sum() / denom
    return loss
