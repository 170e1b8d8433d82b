"""Decoder-only transformer: the dense-LM serving path of the reference's
``models.transformer``, in torch.

* GQA attention + RoPE, causal, f32 softmax, chunked scores so a long
  prefill never materializes (S, S);
* optional sliding-window "local" layers (gemma3's 5:1 local:global) --
  local layers only read a window-sized KV slice and keep a window-sized
  rolling KV cache;
* dense FFN (gated silu/gelu or squared-ReLU);
* layers grouped by kind (every local layer before every global one, as
  the reference's ``layer_groups``), each group's weights stacked on a
  leading axis and run by a Python loop over the stack (the reference's
  ``lax.scan``).

Params are a dict with the reference's keys and stacked per-group shapes
(``groups/<kind>/wq`` is (count, d, H, dh), ...), kept in f32; each
layer's weights are cast to ``cfg.dtype`` where they are used, one layer
at a time.  The attention keeps the reference's formulation (scores in
f32 with a -1e30 additive bias, softmax in f32 cast to ``v``'s dtype),
so the port agrees with it within f32 rounding.

Not here yet: the MoE FFN (a config with ``moe`` raises; ROADMAP A13b),
the training loss and rematerialization (A13c), sharding (A13e).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from .common import act_fn, apply_rope, normal_init, rms_norm


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Kept as data: the MoE FFN is not ported yet (ROADMAP A13b)."""
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "silu"
    gated: bool = True
    moe: Optional[MoEConfig] = None
    local_window: Optional[int] = None
    local_per_global: int = 0        # 5 -> gemma-style 5:1; 0 -> all global
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    remat: bool = True               # training only (not ported yet)
    q_block: int = 512               # query block for chunked attention
    analysis_unroll: bool = False    # the reference's cost-analysis mode;
    #   the port's loops are Python loops, so it changes nothing here
    groups_override: Any = None      # ((kind, count), ...) probe override

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables pad the vocab to a multiple of 512 (the
        reference's table padding; the loss never selects padded ids)."""
        return -(-self.vocab // 512) * 512

    @property
    def layer_groups(self) -> List[Tuple[str, int]]:
        if self.groups_override is not None:
            return [tuple(g) for g in self.groups_override]
        if self.local_per_global <= 0 or self.local_window is None:
            return [("global", self.n_layers)]
        n_global = self.n_layers // (self.local_per_global + 1)
        return [("local", self.n_layers - n_global), ("global", n_global)]

    def num_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        if self.moe:
            e = self.moe
            ffn = e.n_experts * 3 * d * e.d_expert + d * e.n_experts \
                + e.n_shared * 3 * d * e.d_expert
        else:
            ffn = (3 if self.gated else 2) * d * f
        return self.n_layers * (attn + ffn + 2 * d) + 2 * v * d + d

    def active_params(self) -> int:
        """Per-token active parameters (MoE: routed top-k + shared only)."""
        if not self.moe:
            return self.num_params()
        d = self.d_model
        e = self.moe
        attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        ffn = (e.top_k + e.n_shared) * 3 * d * e.d_expert + d * e.n_experts
        return self.n_layers * (attn + ffn + 2 * d) + 2 * self.vocab * d + d


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN is not ported to repro_torch yet "
            "(ROADMAP A13b)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer_stack(gen: torch.Generator, cfg: TransformerConfig,
                      count: int, device) -> Dict[str, torch.Tensor]:
    d, dh, f = cfg.d_model, cfg.d_head, cfg.d_ff
    p = {
        "ln1": torch.zeros((count, d), device=device),
        "ln2": torch.zeros((count, d), device=device),
        "wq": normal_init(gen, (count, d, cfg.n_heads, dh), d ** -0.5,
                          device),
        "wk": normal_init(gen, (count, d, cfg.n_kv_heads, dh), d ** -0.5,
                          device),
        "wv": normal_init(gen, (count, d, cfg.n_kv_heads, dh), d ** -0.5,
                          device),
        "wo": normal_init(gen, (count, cfg.n_heads, dh, d),
                          (cfg.n_heads * dh) ** -0.5, device),
        "w1": normal_init(gen, (count, d, f), d ** -0.5, device),
        "w2": normal_init(gen, (count, f, d), f ** -0.5, device),
    }
    if cfg.gated:
        p["w3"] = normal_init(gen, (count, d, f), d ** -0.5, device)
    return p


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device) -> Dict:
    """f32 params on ``device`` (the reference's keys and shapes), drawn
    from ``gen``, which must live on ``device``."""
    _dense_only(cfg)
    params = {
        "embed": normal_init(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                             device),
        "final_ln": torch.zeros((cfg.d_model,), device=device),
        "head": normal_init(gen, (cfg.d_model, cfg.padded_vocab),
                            cfg.d_model ** -0.5, device),
        "groups": {},
    }
    for kind, count in cfg.layer_groups:
        params["groups"][kind] = _init_layer_stack(gen, cfg, count, device)
    return params


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, bias):
    """q: (B,Qb,Hk,G,D); k/v: (B,Skv,Hk,D); bias: (Qb,Skv) additive mask."""
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float()
    scores = scores * (q.shape[-1] ** -0.5) + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      q_block: int):
    """Blocked attention; never materializes (S, S).

    q: (B,S,Hq,D), k/v: (B,S,Hk,D).  ``q`` is padded to ``nblk * q_block``
    rows; local layers slice KV to the window around each query block,
    starting at the clipped ``start`` of the reference.
    """
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    qb = min(q_block, S)
    nblk = (S + qb - 1) // qb
    pad = nblk * qb - S
    if pad:
        q = torch.cat([q, q.new_zeros((B, pad, Hq, D))], dim=1)
    qr = q.reshape(B, nblk, qb, Hk, G, D)
    kv_span = S if window is None else min(S, window + qb)
    outs = []
    for i in range(nblk):
        q0 = i * qb
        if window is None:
            start = 0
        else:
            start = min(max(q0 + qb - kv_span, 0), S - kv_span)
        ks = k[:, start:start + kv_span]
        vs = v[:, start:start + kv_span]
        kpos = start + torch.arange(kv_span, device=q.device)
        qpos = q0 + torch.arange(qb, device=q.device)
        mask = torch.ones((qb, kv_span), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        bias = torch.where(mask, 0.0, -1e30).float()
        outs.append(_attend_block(qr[:, i], ks, vs, bias))
    out = torch.stack(outs, dim=1).reshape(B, nblk * qb, Hq, D)
    return out[:, :S]


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: Optional[int]):
    """One-token attention against a cache.

    q: (B,1,Hq,D); caches: (B,Sc,Hk,D); lengths: (B,) valid entries.
    For local layers the cache is a rolling buffer of size window and all
    entries are valid once full.
    """
    B, Sc, Hk, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hk
    qr = q.reshape(B, 1, Hk, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qr, k_cache).float()
    scores = scores * (D ** -0.5)
    pos = torch.arange(Sc, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(B, 1, Hq, D)


# ---------------------------------------------------------------------------
# FFN / layers / forward
# ---------------------------------------------------------------------------

def dense_ffn(x, p, cfg: TransformerConfig):
    a = act_fn(cfg.act)
    h = x @ p["w1"].to(x.dtype)
    if cfg.gated:
        h = a(h) * (x @ p["w3"].to(x.dtype))
    else:
        h = a(h)
    return h @ p["w2"].to(x.dtype)


def _qkv(h, p, cfg: TransformerConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(h.dtype))
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(h.dtype))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _out_ffn(x, o, p, cfg: TransformerConfig):
    x = x + torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
    return x + dense_ffn(rms_norm(x, p["ln2"]), p, cfg)


def _layer(x, p, cfg: TransformerConfig, kind: str):
    """One layer over a whole sequence; returns (x, k, v), the roped
    keys and the values being what prefill writes to the cache."""
    S = x.shape[1]
    h = rms_norm(x, p["ln1"])
    pos = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(h, p, cfg, pos)
    window = cfg.local_window if kind == "local" else None
    o = chunked_attention(q, k, v, causal=True, window=window,
                          q_block=cfg.q_block)
    return _out_ffn(x, o, p, cfg), k, v


def _layers(stack: Dict[str, torch.Tensor], count: int):
    """The per-layer views of one group's stacked weights, in order."""
    for i in range(count):
        yield {name: w[i] for name, w in stack.items()}


def _head(x, params):
    return torch.einsum("...d,dv->...v", x,
                        params["head"].to(x.dtype)).float()


def forward_hidden(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> final hidden states (B, S, d)."""
    _dense_only(cfg)
    x = params["embed"][tokens].to(cfg.dtype)
    for kind, count in cfg.layer_groups:
        for lp in _layers(params["groups"][kind], count):
            x = _layer(x, lp, cfg, kind)[0]
    return rms_norm(x, params["final_ln"])


def forward(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> f32 logits (B, S, padded_vocab)."""
    return _head(forward_hidden(params, tokens, cfg), params)


# ---------------------------------------------------------------------------
# serving: prefill + decode with per-group KV caches
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device):
    """Per-group KV caches; local groups keep only a window-sized buffer."""
    cache = {}
    for kind, count in cfg.layer_groups:
        S = cfg.local_window if kind == "local" else max_len
        S = min(S, max_len)
        shape = (count, batch, S, cfg.n_kv_heads, cfg.d_head)
        cache[kind] = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                       "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    return cache


def decode_step(params, cache, tokens, lengths, cfg: TransformerConfig):
    """One decode step. tokens: (B, 1) new token; lengths: (B,) cache fill.

    Returns (f32 logits (B, padded_vocab), cache); the cache is updated in
    place.  A local layer's cache is a rolling buffer: position p lives in
    slot p % Sc, and its valid length is min(lengths + 1, Sc).
    """
    _dense_only(cfg)
    B = tokens.shape[0]
    bidx = torch.arange(B, device=tokens.device)
    x = params["embed"][tokens].to(cfg.dtype)     # (B,1,d)
    for kind, count in cfg.layer_groups:
        kc, vc = cache[kind]["k"], cache[kind]["v"]
        Sc = kc.shape[2]
        window = cfg.local_window if kind == "local" else None
        slot = lengths if window is None else lengths % Sc
        eff_len = torch.clamp(lengths + 1, max=Sc)
        for i, lp in enumerate(_layers(params["groups"][kind], count)):
            h = rms_norm(x, lp["ln1"])
            q, k, v = _qkv(h, lp, cfg, lengths[:, None])
            kc[i, bidx, slot] = k[:, 0].to(kc.dtype)
            vc[i, bidx, slot] = v[:, 0].to(vc.dtype)
            o = decode_attention(q, kc[i], vc[i], eff_len, window=window)
            x = _out_ffn(x, o, lp, cfg)
    x = rms_norm(x, params["final_ln"])
    return _head(x[:, 0], params), cache


def prefill(params, tokens, cfg: TransformerConfig, max_len: int):
    """Full-sequence forward that also fills the KV cache.

    Returns (f32 logits of the last position (B, padded_vocab), cache).
    A local group's rolling buffer takes positions S - take .. S - 1 into
    slots p % Sc, the slots decode reads.
    """
    _dense_only(cfg)
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, tokens.device)
    x = params["embed"][tokens].to(cfg.dtype)
    for kind, count in cfg.layer_groups:
        kc, vc = cache[kind]["k"], cache[kind]["v"]
        Sc = kc.shape[2]
        take = min(Sc, S)
        slots = torch.arange(S - take, S, device=tokens.device) % Sc
        for i, lp in enumerate(_layers(params["groups"][kind], count)):
            x, k, v = _layer(x, lp, cfg, kind)
            kc[i][:, slots] = k[:, S - take:].to(kc.dtype)
            vc[i][:, slots] = v[:, S - take:].to(vc.dtype)
    x = rms_norm(x, params["final_ln"])
    return _head(x[:, -1], params), cache
