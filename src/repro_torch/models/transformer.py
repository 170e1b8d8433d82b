"""Decoder-only transformer: the reference's ``models.transformer`` on one
device, in torch.

* GQA attention + RoPE, causal, f32 softmax, chunked scores so a long
  prefill never materializes (S, S);
* optional sliding-window "local" layers (gemma3's 5:1 local:global) --
  local layers only read a window-sized KV slice and keep a window-sized
  rolling KV cache;
* dense FFN (gated silu/gelu or squared-ReLU) or MoE (shared + routed
  fine-grained experts, top-k, capacity-based dispatch over every expert
  on the device);
* layers grouped by kind (every local layer before every global one, as
  the reference's ``layer_groups``), each group's weights stacked on a
  leading axis and run by a Python loop over the stack (the reference's
  ``lax.scan``), each layer under activation checkpointing when
  ``cfg.remat`` is set and grad is enabled;
* the training loss with the head and cross-entropy chunked over the
  sequence, each chunk checkpointed.

Params are a dict with the reference's keys and stacked per-group shapes
(``groups/<kind>/wq`` is (count, d, H, dh), ...), kept in f32; each
layer's weights are cast to ``cfg.dtype`` where they are used, one layer
at a time.  The attention keeps the reference's formulation (scores in
f32 with a -1e30 additive bias, softmax in f32 cast to ``v``'s dtype),
so the port agrees with it within f32 rounding.

Not here: sharding (the reference's ``ShardCtx``, ``_gather_layer`` and
the expert-parallel ``shard_map`` of ``moe_ffn``; ROADMAP A13e-2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import act_fn, apply_rope, normal_init, rms_norm


@dataclasses.dataclass(frozen=True)
class MoEConfig:
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
    remat: bool = True               # checkpoint each layer under grad
    q_block: int = 512               # query block for chunked attention
    analysis_unroll: bool = False    # the reference's cost-analysis mode,
    #   which belongs to its dry run (ROADMAP A13e-2); kept as data here
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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer_stack(gen: torch.Generator, cfg: TransformerConfig,
                      count: int, device) -> Dict[str, torch.Tensor]:
    d, dh = cfg.d_model, cfg.d_head
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
    }
    if cfg.moe:
        e = cfg.moe
        fe = e.d_expert
        p["router"] = normal_init(gen, (count, d, e.n_experts), d ** -0.5,
                                  device)
        p["we1"] = normal_init(gen, (count, e.n_experts, d, fe), d ** -0.5,
                               device)
        p["we3"] = normal_init(gen, (count, e.n_experts, d, fe), d ** -0.5,
                               device)
        p["we2"] = normal_init(gen, (count, e.n_experts, fe, d), fe ** -0.5,
                               device)
        if e.n_shared:
            fs = e.n_shared * fe
            p["ws1"] = normal_init(gen, (count, d, fs), d ** -0.5, device)
            p["ws3"] = normal_init(gen, (count, d, fs), d ** -0.5, device)
            p["ws2"] = normal_init(gen, (count, fs, d), fs ** -0.5, device)
    else:
        f = cfg.d_ff
        p["w1"] = normal_init(gen, (count, d, f), d ** -0.5, device)
        p["w2"] = normal_init(gen, (count, f, d), f ** -0.5, device)
        if cfg.gated:
            p["w3"] = normal_init(gen, (count, d, f), d ** -0.5, device)
    return p


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device) -> Dict:
    """f32 params on ``device`` (the reference's keys and shapes), drawn
    from ``gen``, which must live on ``device``."""
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
# FFN / MoE
# ---------------------------------------------------------------------------

def dense_ffn(x, p, cfg: TransformerConfig):
    a = act_fn(cfg.act)
    h = x @ p["w1"].to(x.dtype)
    if cfg.gated:
        h = a(h) * (x @ p["w3"].to(x.dtype))
    else:
        h = a(h)
    return h @ p["w2"].to(x.dtype)


def _route(x2d, router, top_k: int):
    """The router: logits in ``x2d``'s dtype, an f32 softmax over the
    experts, the ``top_k`` largest probabilities renormalised to sum to 1.

    Ties go to the lower expert id, as ``lax.top_k`` breaks them: the top
    k is taken from a stable descending sort (``torch.topk`` promises no
    order for ties, and bf16 logits tie often).  Returns (weights (T, K)
    f32, experts (T, K) int64), each row in descending weight order.
    """
    logits = (x2d @ router.to(x2d.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :top_k], topi[:, :top_k]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    return topw, topi


def capacity(moe: MoEConfig, T: int) -> int:
    """Slots an expert for T tokens: the reference's float floor
    arithmetic on Python numbers, ``int(max(1, ceil(T K cf / E)))``."""
    return int(max(1, -(-T * moe.top_k * moe.capacity_factor
                        // moe.n_experts)))


def _moe_dispatch_local(x2d, p, cfg: TransformerConfig):
    """Capacity-based grouped-GEMM MoE over every expert on this device:
    the reference's ``_moe_dispatch_local`` with ``e_loc = n_experts``,
    ``e0 = 0`` and no psum.

    x2d: (T, d).  The T * K assignments are sorted by expert (a stable
    sort, as ``jnp.argsort``); an assignment's position in its expert's
    group decides whether it fits the capacity C, computed from Python
    numbers as the reference does.  Slot (e, c) of the (E, C, d) buffer
    holds the token of expert e's c-th assignment (a gather: every kept
    slot has one token, so this equals the reference's scatter-add), the
    expert GEMMs run as three batched matmuls, and each token sums its
    kept contributions, weighted, in ascending expert order (the order of
    the reference's ``segment_sum`` over the sorted assignments), one add
    at a time in ``x2d``'s dtype: a fixed order, so two runs give the same
    bits (an ``index_add_`` would add in atomic order on the card).
    Every shape comes from Python ints: no host sync.
    """
    moe = cfg.moe
    T, d = x2d.shape
    E, K = moe.n_experts, moe.top_k
    a = act_fn(cfg.act)
    dev = x2d.device
    topw, topi = _route(x2d, p["router"], K)
    flat_e = topi.reshape(-1)                                # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    experts = torch.arange(E, device=dev)
    starts = torch.searchsorted(se, experts)
    ends = torch.searchsorted(se, experts, right=True)
    C = capacity(moe, T)
    # dispatch: slot (e, c) <- the c-th assignment of expert e, if any
    slot = starts[:, None] + torch.arange(C, device=dev)     # (E, C)
    filled = slot < ends[:, None]
    src = torch.div(order[slot.clamp_max(T * K - 1)], K,
                    rounding_mode="floor")                   # token ids
    buf = torch.where(filled[..., None], x2d[src], 0.0)      # (E, C, d)
    h = a(torch.bmm(buf, p["we1"].to(x2d.dtype))) \
        * torch.bmm(buf, p["we3"].to(x2d.dtype))
    y = torch.bmm(h, p["we2"].to(x2d.dtype))                 # (E, C, d)
    # combine: each assignment's position in its expert's group
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * K, device=dev) - starts[se]
    pos = pos.reshape(T, K)
    by_e = torch.argsort(topi, dim=-1)       # a token's experts ascending
    ei, pi = topi.gather(1, by_e), pos.gather(1, by_e)
    wi = ((pi < C) * topw.gather(1, by_e)).to(x2d.dtype)
    yt = y[ei, pi.clamp_max(C - 1)] * wi[..., None]          # (T, K, d)
    out = yt[:, 0]
    for k in range(1, K):
        out = out + yt[:, k]
    return out


def moe_ffn(x, p, cfg: TransformerConfig):
    """Routed experts plus the shared experts, if any: x (B, S, d)."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    out = _moe_dispatch_local(x2d, p, cfg)
    if cfg.moe.n_shared:
        a = act_fn(cfg.act)
        h = a(x2d @ p["ws1"].to(x.dtype)) * (x2d @ p["ws3"].to(x.dtype))
        out = out + h @ p["ws2"].to(x.dtype)
    return out.reshape(B, S, d)


# ---------------------------------------------------------------------------
# layers / forward / loss
# ---------------------------------------------------------------------------

def _qkv(h, p, cfg: TransformerConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(h.dtype))
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(h.dtype))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _out_ffn(x, o, p, cfg: TransformerConfig):
    x = x + torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
    h = rms_norm(x, p["ln2"])
    return x + (moe_ffn(h, p, cfg) if cfg.moe else dense_ffn(h, p, cfg))


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


def _layer_out(x, p, cfg: TransformerConfig, kind: str):
    return _layer(x, p, cfg, kind)[0]


def _layers(stack: Dict[str, torch.Tensor], count: int):
    """The per-layer views of one group's stacked weights, in order
    (``unbind``: under autograd one node stacks the layers' grads)."""
    views = {name: w.unbind(0) for name, w in stack.items()}
    for i in range(count):
        yield {name: v[i] for name, v in views.items()}


def _head(x, params):
    return torch.einsum("...d,dv->...v", x,
                        params["head"].to(x.dtype)).float()


def forward_hidden(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> final hidden states (B, S, d).

    With ``cfg.remat`` and grad enabled, each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
    scan body): the backward pass recomputes it from its input.
    """
    x = params["embed"][tokens].to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for kind, count in cfg.layer_groups:
        for lp in _layers(params["groups"][kind], count):
            if remat:
                x = checkpoint(_layer_out, x, lp, cfg, kind,
                               use_reentrant=False)
            else:
                x = _layer_out(x, lp, cfg, kind)
    return rms_norm(x, params["final_ln"])


def forward(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> f32 logits (B, S, padded_vocab)."""
    return _head(forward_hidden(params, tokens, cfg), params)


def _chunk_nll(xc, lb, head):
    """(summed nll, token count) of one sequence chunk, both f32."""
    logits = torch.einsum("bsd,dv->bsv", xc, head.to(xc.dtype)).float()
    mask = (lb >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lb.clamp_min(0)[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def loss_fn(params, batch, cfg: TransformerConfig, loss_chunk: int = 1024):
    """Causal LM loss with sequence-chunked head + cross-entropy.

    ``batch``: ``tokens`` and ``labels`` (B, S) int tensors, labels of -100
    masked.  The (B, S, vocab) logits are never materialized: the head
    matmul and log-softmax run per chunk, and under grad each chunk is
    checkpointed (the reference's ``@jax.checkpoint`` chunk body), so
    only one chunk's f32 logits live at a time.  Returns the mean nll
    over unmasked tokens, f32.
    """
    x = forward_hidden(params, batch["tokens"], cfg)
    labels = batch["labels"]
    B, S, d = x.shape
    ck = min(loss_chunk, S)
    nchunk = -(-S // ck)
    pad = nchunk * ck - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-100)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_tok = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nchunk):
        xc, lb = x[:, i * ck:(i + 1) * ck], labels[:, i * ck:(i + 1) * ck]
        if torch.is_grad_enabled():
            nll, n = checkpoint(_chunk_nll, xc, lb, params["head"],
                                use_reentrant=False)
        else:
            nll, n = _chunk_nll(xc, lb, params["head"])
        nll_sum = nll_sum + nll
        n_tok = n_tok + n
    return nll_sum / torch.clamp_min(n_tok, 1.0)


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
