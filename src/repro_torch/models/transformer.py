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

Sharding (:class:`ShardCtx`): without a mesh every function runs on one
device as above.  With a mesh (a ``DeviceMesh``) every rank runs the same
code on its own blocks, laid out by ``sharding.rules``'s
``transformer_param_specs`` (storage) and ``transformer_layer_specs``
(compute), and calls the collectives that the reference's GSPMD places
(``sharding.spmd``):

* FSDP: each layer's weights (and ``final_ln``) are all-gathered over
  ``data`` from their storage spec to their compute spec just before use
  (:func:`_gather_layer`); the gather's backward reduce-scatters the
  grads, their sum over ``data``.
* Tensor parallelism (Megatron): the q heads, kv heads, ff and shared
  experts' ff are split over ``model``; a replicated activation enters a
  column-parallel product through ``copy_to`` (sum backward) and a
  row-parallel product's output is ``psum``-ed (identity backward).
  When ``n_kv_heads`` does not divide over ``model`` the kv heads are
  replicated and each rank uses those its q heads read (head ``h``
  reads kv head ``h // G``); when ``n_heads`` does not either, the
  attention is replicated and no ``psum`` follows it.
* Vocab parallelism: ``embed`` is looked up by a masked local gather and
  a ``psum``; ``head`` gives this rank's vocab block of the logits; the
  loss takes its log-sum-exp over the split vocab (``pmax``, then a
  summed ``exp``) and the gold logit from the rank that owns it.
* Expert parallelism: each rank holds ``E / model`` experts and keeps
  only its own assignments of its data shard's tokens (capacity from the
  local T), then a ``psum`` over ``model``.
* The KV cache: a rank holds its block by the cell's cache spec; where
  the cache length is split (``ShardCtx.cache_len_axes``: the GQA
  fallback over ``model``, ``long_500k`` over the data axes) only the
  rank owning a slot writes it, and decode combines the ranks' partial
  softmaxes (``pmax`` of the row maxima, ``psum`` of the rescaled sums
  and of the weighted values).

A loss on a mesh is the mean over the global batch's unmasked tokens
(the nll sum and the token count summed over the data axes).  Params
whose grads each rank holds only in part (the router, replicated kv
weights under sharded q heads) and params stored without a data axis
are all-reduced by the train step (``launch.steps``).  On a 1-rank mesh
every collective is the identity and the results equal the unsharded
ones to the bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..sharding import spmd
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
    analysis_unroll: bool = False    # the reference's cost-analysis mode
    #   (XLA counts a scan body once); the port's dry run counts every
    #   layer as it runs, so this is kept as data only
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


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """How the model maps onto the mesh (``mesh=None``: one device).

    The reference's fields, plus what manual SPMD must be told of the
    layout that GSPMD reads off the arrays: ``param_specs``, the storage
    specs of the params (``transformer_param_specs`` filtered to the
    mesh), and ``cache_len_axes``, the axes the KV cache's length is
    split over (empty: the cache splits batch and kv heads only)."""
    mesh: Optional[Any] = None
    data_axes: Tuple[str, ...] = ("pod", "data")
    model_axis: str = "model"
    layer_specs: Optional[Dict] = None  # per-layer compute specs
    param_specs: Optional[Dict] = None  # storage specs of the params
    cache_len_axes: Tuple[str, ...] = ()


def _split(ctx: ShardCtx, name: str, dim: int) -> Tuple[str, ...]:
    """The mesh axes that dimension ``dim`` of layer weight ``name`` is
    split over when it is used (() without a mesh)."""
    if ctx.mesh is None or ctx.layer_specs is None:
        return ()
    return spmd.present(spmd.part_axes(ctx.layer_specs[name][dim]),
                        ctx.mesh)


def _vocab_axes(ctx: ShardCtx) -> Tuple[str, ...]:
    if ctx.mesh is None or ctx.param_specs is None:
        return ()
    return spmd.present(spmd.part_axes(ctx.param_specs["embed"][0]),
                        ctx.mesh)


def _block(ctx: ShardCtx, axes) -> int:
    return spmd.block_index(ctx.mesh, axes)[0]


def _to_spec(x, have, want, mesh):
    """``x`` stored by spec ``have``, all-gathered to spec ``want``: each
    dimension over the axes it is split over in ``have`` but not in
    ``want``."""
    for d, (h, w) in enumerate(zip(have, want)):
        extra = [a for a in spmd.part_axes(h)
                 if a not in spmd.part_axes(w)]
        if extra:
            x = spmd.all_gather_dim(x, d, extra, mesh)
    return x


def _gather_layer(lp: Dict, ctx: ShardCtx) -> Dict:
    """FSDP's per-layer gather: one layer's weights from their storage
    spec (the stacked spec without the layers axis) to their compute
    spec, just before use."""
    if ctx.mesh is None or ctx.layer_specs is None:
        return lp
    store = next(iter(ctx.param_specs["groups"].values()))
    out = dict(lp)
    for k, spec in ctx.layer_specs.items():
        if k in out:
            out[k] = _to_spec(out[k], store[k][1:], spec, ctx.mesh)
    return out


def _final_ln(params, ctx: ShardCtx):
    if ctx.mesh is None or ctx.param_specs is None:
        return params["final_ln"]
    return _to_spec(params["final_ln"], ctx.param_specs["final_ln"], (None,),
                    ctx.mesh)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer_stack(gen: torch.Generator, cfg: TransformerConfig,
                      count: int, device, keep) -> Dict[str, torch.Tensor]:
    d, dh = cfg.d_model, cfg.d_head
    p = {}

    def draw(name, shape, std):
        p[name] = keep(name, normal_init(gen, shape, std, device))

    p["ln1"] = keep("ln1", torch.zeros((count, d), device=device))
    p["ln2"] = keep("ln2", torch.zeros((count, d), device=device))
    draw("wq", (count, d, cfg.n_heads, dh), d ** -0.5)
    draw("wk", (count, d, cfg.n_kv_heads, dh), d ** -0.5)
    draw("wv", (count, d, cfg.n_kv_heads, dh), d ** -0.5)
    draw("wo", (count, cfg.n_heads, dh, d), (cfg.n_heads * dh) ** -0.5)
    if cfg.moe:
        e = cfg.moe
        fe = e.d_expert
        draw("router", (count, d, e.n_experts), d ** -0.5)
        draw("we1", (count, e.n_experts, d, fe), d ** -0.5)
        draw("we3", (count, e.n_experts, d, fe), d ** -0.5)
        draw("we2", (count, e.n_experts, fe, d), fe ** -0.5)
        if e.n_shared:
            fs = e.n_shared * fe
            draw("ws1", (count, d, fs), d ** -0.5)
            draw("ws3", (count, d, fs), d ** -0.5)
            draw("ws2", (count, fs, d), fs ** -0.5)
    else:
        f = cfg.d_ff
        draw("w1", (count, d, f), d ** -0.5)
        draw("w2", (count, f, d), f ** -0.5)
        if cfg.gated:
            draw("w3", (count, d, f), d ** -0.5)
    return p


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device, keep=None) -> Dict:
    """f32 params on ``device`` (the reference's keys and shapes), drawn
    from ``gen``, which must live on ``device``.

    ``keep(path, leaf)``, if given, sees each leaf as soon as it is drawn
    (``path``: its keys, ``("groups", kind, name)`` in a layer group) and
    its result is kept instead, so a rank of a mesh keeps its block of
    the same draw and holds one whole leaf at a time."""
    def kept(path):
        return (lambda name, x: x) if keep is None else \
            (lambda name, x: keep((*path, name), x))

    top = kept(())
    params = {
        "embed": top("embed", normal_init(
            gen, (cfg.padded_vocab, cfg.d_model), 0.02, device)),
        "final_ln": top("final_ln", torch.zeros((cfg.d_model,),
                                                device=device)),
        "head": top("head", normal_init(
            gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5,
            device)),
        "groups": {},
    }
    for kind, count in cfg.layer_groups:
        params["groups"][kind] = _init_layer_stack(
            gen, cfg, count, device, kept(("groups", kind)))
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


def _decode_attention_split(q, k_cache, v_cache, lengths, c0: int, axes,
                            mesh):
    """:func:`decode_attention` over a cache whose length is split over
    ``axes``: this rank holds positions ``c0 .. c0 + Sc - 1``.  Each rank
    takes its partial softmax against the global row maximum (``pmax``),
    and the rescaled sums and weighted values (f32) are summed over the
    axes."""
    B, Sc, Hk, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hk
    qr = q.reshape(B, 1, Hk, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qr, k_cache).float()
    scores = scores * (D ** -0.5)
    pos = c0 + torch.arange(Sc, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, None, :], -1e30)
    mx = spmd.pmax(scores.amax(-1, keepdim=True), axes, mesh)
    p = torch.exp(scores - mx)
    den = spmd.psum(p.sum(-1, keepdim=True), axes, mesh)
    num = spmd.psum(torch.einsum("bkgqs,bskd->bkgqd", p, v_cache.float()),
                    axes, mesh)
    out = (num / den).permute(0, 3, 1, 2, 4)            # (B, 1, Hk, G, D)
    return out.reshape(B, 1, Hq, D).to(v_cache.dtype)


def _kv_for_q(k, v, cfg: TransformerConfig, ctx: ShardCtx, h0: int,
              hq: int):
    """The kv heads (dim 2 of ``k``, ``v``, which hold all of them) that
    q heads ``h0 .. h0 + hq - 1`` read, head ``h`` reading kv head
    ``h // G``: a slice when each kv head serves an equal run of the
    local q heads, else one kv head per q head."""
    G = cfg.n_heads // cfg.n_kv_heads
    idx = [(h0 + i) // G for i in range(hq)]
    k0, n = idx[0], idx[-1] + 1 - idx[0]
    if hq % n == 0 and idx == [k0 + i // (hq // n) for i in range(hq)]:
        return k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def _local_kv(q, k, v, cfg: TransformerConfig, ctx: ShardCtx):
    """The k, v that this rank's q heads attend to: the local kv heads
    as they are, or, where the kv heads are replicated under sharded q
    heads (the GQA fallback), the ones its q heads read."""
    model = _split(ctx, "wq", 1)
    if not model or _split(ctx, "wk", 1):
        return k, v
    hq = q.shape[2]
    return _kv_for_q(k, v, cfg, ctx, _block(ctx, model) * hq, hq)


# ---------------------------------------------------------------------------
# FFN / MoE
# ---------------------------------------------------------------------------

def dense_ffn(x, p, cfg: TransformerConfig, ctx: ShardCtx = ShardCtx()):
    a = act_fn(cfg.act)
    model = _split(ctx, "w1", 1)
    x = spmd.copy_to(x, model, ctx.mesh)
    h = x @ p["w1"].to(x.dtype)
    if cfg.gated:
        h = a(h) * (x @ p["w3"].to(x.dtype))
    else:
        h = a(h)
    return spmd.psum(h @ p["w2"].to(x.dtype), model, ctx.mesh)


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


def _moe_dispatch_local(x2d, p, cfg: TransformerConfig,
                        e_loc: Optional[int] = None, e0: int = 0,
                        psum_axis: Tuple[str, ...] = (), mesh=None):
    """Capacity-based grouped-GEMM MoE over the ``e_loc`` experts from
    global id ``e0`` that ``p``'s expert weights hold (all ``n_experts``
    by default), then a ``psum`` over ``psum_axis`` of ``mesh``: the
    reference's ``_moe_dispatch_local``.

    x2d: (T, d), the local tokens (replicated over the expert axis).  The
    T * K assignments are sorted by expert (a stable sort, as
    ``jnp.argsort``); an assignment's position in its expert's group
    decides whether it fits the capacity C, computed from Python numbers
    and the local T, as the reference does.  Slot (e, c) of the
    (e_loc, C, d) buffer holds the token of local expert e's c-th
    assignment (a gather: every kept slot has one token, so this equals
    the reference's scatter-add), the expert GEMMs run as three batched
    matmuls, and each token sums its kept contributions from the local
    experts, weighted, in ascending expert order (the order of the
    reference's ``segment_sum`` over the sorted assignments), one add at a
    time in ``x2d``'s dtype: a fixed order, so two runs give the same bits
    (an ``index_add_`` would add in atomic order on the card).  Every
    shape comes from Python ints: no host sync.
    """
    moe = cfg.moe
    T, d = x2d.shape
    E, K = moe.n_experts, moe.top_k
    e_loc = E if e_loc is None else e_loc
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
    # dispatch: slot (e, c) <- the c-th assignment of local expert e
    slot = starts[e0:e0 + e_loc, None] + torch.arange(C, device=dev)
    filled = slot < ends[e0:e0 + e_loc, None]
    src = torch.div(order[slot.clamp_max(T * K - 1)], K,
                    rounding_mode="floor")                   # token ids
    buf = torch.where(filled[..., None], x2d[src], 0.0)      # (e_loc, C, d)
    h = a(torch.bmm(buf, p["we1"].to(x2d.dtype))) \
        * torch.bmm(buf, p["we3"].to(x2d.dtype))
    y = torch.bmm(h, p["we2"].to(x2d.dtype))                 # (e_loc, C, d)
    # combine: each assignment's position in its expert's group
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * K, device=dev) - starts[se]
    pos = pos.reshape(T, K)
    by_e = torch.argsort(topi, dim=-1)       # a token's experts ascending
    ei, pi = topi.gather(1, by_e), pos.gather(1, by_e)
    kept = pi < C
    if e_loc != E:
        kept = kept & (ei >= e0) & (ei < e0 + e_loc)
        ei = (ei - e0).clamp(0, e_loc - 1)
    wi = (kept * topw.gather(1, by_e)).to(x2d.dtype)
    yt = y[ei, pi.clamp_max(C - 1)] * wi[..., None]          # (T, K, d)
    out = yt[:, 0]
    for k in range(1, K):
        out = out + yt[:, k]
    return spmd.psum(out, psum_axis, mesh)


def moe_ffn(x, p, cfg: TransformerConfig, ctx: ShardCtx = ShardCtx()):
    """Routed experts plus the shared experts, if any: x (B, S, d).  On a
    mesh the experts are split over ``model`` (each rank keeps its own
    assignments, then a ``psum``) and the shared experts are Megatron
    column / row parallel; the tokens enter through ``copy_to``, since
    each rank's router and expert grads come from its own experts."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    ep = _split(ctx, "we1", 0)
    if ep:
        x2d = spmd.copy_to(x2d, ep, ctx.mesh)
        e_loc = cfg.moe.n_experts // spmd.axis_size(ctx.mesh, ep)
        out = _moe_dispatch_local(x2d, p, cfg, e_loc, _block(ctx, ep) * e_loc,
                                  ep, ctx.mesh)
    else:
        out = _moe_dispatch_local(x2d, p, cfg)
    if cfg.moe.n_shared:
        a = act_fn(cfg.act)
        model = _split(ctx, "ws1", 1)
        xs = x2d if ep else spmd.copy_to(x2d, model, ctx.mesh)
        h = a(xs @ p["ws1"].to(x.dtype)) * (xs @ p["ws3"].to(x.dtype))
        out = out + spmd.psum(h @ p["ws2"].to(x.dtype), model, ctx.mesh)
    return out.reshape(B, S, d)


# ---------------------------------------------------------------------------
# layers / forward / loss
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg: TransformerConfig, ctx: ShardCtx):
    """The embedding rows of ``tokens`` in ``cfg.dtype``; with the vocab
    split, a masked gather of the local rows (others zero) and a
    ``psum``."""
    vocab = _vocab_axes(ctx)
    table = params["embed"]
    if not vocab:
        return table[tokens].to(cfg.dtype)
    V = table.shape[0]
    local = tokens - _block(ctx, vocab) * V
    hit = (local >= 0) & (local < V)
    rows = torch.where(hit[..., None], table[local.clamp(0, V - 1)], 0.0)
    return spmd.psum(rows.to(cfg.dtype), vocab, ctx.mesh)


def _qkv(h, p, cfg: TransformerConfig, positions, ctx: ShardCtx = ShardCtx()):
    """q (this rank's heads), k and v (the heads its cache block holds),
    roped at ``positions``."""
    h = spmd.copy_to(h, _split(ctx, "wq", 1), ctx.mesh)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(h.dtype))
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(h.dtype))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _out_ffn(x, o, p, cfg: TransformerConfig, ctx: ShardCtx = ShardCtx()):
    attn = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
    x = x + spmd.psum(attn, _split(ctx, "wq", 1), ctx.mesh)
    h = rms_norm(x, p["ln2"])
    return x + (moe_ffn(h, p, cfg, ctx) if cfg.moe
                else dense_ffn(h, p, cfg, ctx))


def _layer(x, p, cfg: TransformerConfig, kind: str,
           ctx: ShardCtx = ShardCtx()):
    """One layer over a whole sequence (its weights gathered first on a
    mesh); returns (x, k, v), the roped keys and the values being what
    prefill writes to the cache."""
    p = _gather_layer(p, ctx)
    S = x.shape[1]
    h = rms_norm(x, p["ln1"])
    pos = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(h, p, cfg, pos, ctx)
    window = cfg.local_window if kind == "local" else None
    ka, va = _local_kv(q, k, v, cfg, ctx)
    o = chunked_attention(q, ka, va, causal=True, window=window,
                          q_block=cfg.q_block)
    return _out_ffn(x, o, p, cfg, ctx), k, v


def _layer_out(x, p, cfg: TransformerConfig, kind: str,
               ctx: ShardCtx = ShardCtx()):
    return _layer(x, p, cfg, kind, ctx)[0]


def _layers(stack: Dict[str, torch.Tensor], count: int):
    """The per-layer views of one group's stacked weights, in order
    (``unbind``: under autograd one node stacks the layers' grads)."""
    views = {name: w.unbind(0) for name, w in stack.items()}
    for i in range(count):
        yield {name: v[i] for name, v in views.items()}


def _head(x, params, ctx: ShardCtx = ShardCtx()):
    """f32 logits of ``x`` (this rank's vocab block on a mesh)."""
    x = spmd.copy_to(x, _vocab_axes(ctx), ctx.mesh)
    return torch.einsum("...d,dv->...v", x,
                        params["head"].to(x.dtype)).float()


def forward_hidden(params, tokens, cfg: TransformerConfig,
                   ctx: ShardCtx = ShardCtx()):
    """tokens (B, S) -> final hidden states (B, S, d).

    With ``cfg.remat`` and grad enabled, each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
    scan body): the backward pass recomputes it, its FSDP gather and
    collectives included, from its input.
    """
    x = _embed(params, tokens, cfg, ctx)
    remat = cfg.remat and torch.is_grad_enabled()
    for kind, count in cfg.layer_groups:
        for lp in _layers(params["groups"][kind], count):
            if remat:
                x = checkpoint(_layer_out, x, lp, cfg, kind, ctx,
                               use_reentrant=False)
            else:
                x = _layer_out(x, lp, cfg, kind, ctx)
    return rms_norm(x, _final_ln(params, ctx))


def forward(params, tokens, cfg: TransformerConfig,
            ctx: ShardCtx = ShardCtx()):
    """tokens (B, S) -> f32 logits (B, S, padded_vocab); on a mesh this
    rank's block (its batch rows, its vocab columns)."""
    return _head(forward_hidden(params, tokens, cfg, ctx), params, ctx)


class _VocabLogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of logits whose columns are
    split over ``axes``: the global maximum (``pmax``), the summed
    ``exp``; the same arithmetic as ATen's ``logsumexp`` and its
    backward, so on a 1-rank mesh it gives the same bits."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        mx = spmd.pmax(x.amax(-1, keepdim=True), axes, mesh)
        mx.masked_fill_(mx.abs() == float("inf"), 0)
        s = spmd.psum(torch.exp(x - mx).sum(-1), axes, mesh)
        out = s.log_().add_(mx[..., 0])
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * (x - out[..., None]).exp(), None, None


def _chunk_nll(xc, lb, head, ctx: ShardCtx = ShardCtx()):
    """(summed nll, token count) of one sequence chunk, both f32 (this
    rank's rows; the vocab whole after the collectives)."""
    vocab = _vocab_axes(ctx)
    xc = spmd.copy_to(xc, vocab, ctx.mesh)
    logits = torch.einsum("bsd,dv->bsv", xc, head.to(xc.dtype)).float()
    mask = (lb >= 0).float()
    if not vocab:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lb.clamp_min(0)[..., None])[..., 0]
        return ((logz - gold) * mask).sum(), mask.sum()
    logz = _VocabLogSumExp.apply(logits, vocab, ctx.mesh)
    V = logits.shape[-1]
    local = lb.clamp_min(0) - _block(ctx, vocab) * V
    hit = (local >= 0) & (local < V)
    gold = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    gold = spmd.psum(torch.where(hit, gold, 0.0), vocab, ctx.mesh)
    return ((logz - gold) * mask).sum(), mask.sum()


def loss_fn(params, batch, cfg: TransformerConfig, ctx: ShardCtx = ShardCtx(),
            loss_chunk: int = 1024):
    """Causal LM loss with sequence-chunked head + cross-entropy.

    ``batch``: ``tokens`` and ``labels`` (B, S) int tensors, labels of -100
    masked.  The (B, S, vocab) logits are never materialized: the head
    matmul and log-softmax run per chunk, and under grad each chunk is
    checkpointed (the reference's ``@jax.checkpoint`` chunk body), so
    only one chunk's f32 logits live at a time.  Returns the mean nll
    over unmasked tokens, f32; on a mesh over the global batch's (the
    nll sum and the token count summed over the data axes).
    """
    x = forward_hidden(params, batch["tokens"], cfg, ctx)
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
            nll, n = checkpoint(_chunk_nll, xc, lb, params["head"], ctx,
                                use_reentrant=False)
        else:
            nll, n = _chunk_nll(xc, lb, params["head"], ctx)
        nll_sum = nll_sum + nll
        n_tok = n_tok + n
    if ctx.mesh is not None:
        nll_sum = spmd.psum(nll_sum, ctx.data_axes, ctx.mesh)
        n_tok = spmd.psum(n_tok.detach(), ctx.data_axes, ctx.mesh)
    return nll_sum / torch.clamp_min(n_tok, 1.0)


# ---------------------------------------------------------------------------
# serving: prefill + decode with per-group KV caches
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device,
               ctx: ShardCtx = ShardCtx()):
    """Per-group KV caches; local groups keep only a window-sized buffer.
    On a mesh, this rank's block for ``batch`` local rows: its kv heads
    (where they split over ``model``) and its part of the length (split
    over ``ctx.cache_len_axes``)."""
    n_len = spmd.axis_size(ctx.mesh, ctx.cache_len_axes)
    n_kv = spmd.axis_size(ctx.mesh, _split(ctx, "wk", 1))
    cache = {}
    for kind, count in cfg.layer_groups:
        S = cfg.local_window if kind == "local" else max_len
        S = min(S, max_len)
        shape = (count, batch, S // n_len, cfg.n_kv_heads // n_kv,
                 cfg.d_head)
        cache[kind] = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                       "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    return cache


def _decode_attend(q, kc, vc, eff_len, window, cfg: TransformerConfig,
                   ctx: ShardCtx, c0: int):
    """This rank's heads of the attention output of a decode step against
    its cache block (positions ``c0 ..`` of the length)."""
    axes = spmd.present(ctx.cache_len_axes, ctx.mesh)
    if not axes:
        ka, va = _local_kv(q, kc, vc, cfg, ctx)
        return decode_attention(q, ka, va, eff_len, window=window)
    model = _split(ctx, "wq", 1)
    if model and model[0] in axes:
        # the length splits over the q heads' own axis: every rank
        # attends with all q heads to its part, then keeps its heads
        hq = q.shape[2]
        h0 = _block(ctx, model) * hq
        q = spmd.unshard(q, (None, None, model, None), ctx.mesh)
        o = _decode_attention_split(q, kc, vc, eff_len, c0, axes, ctx.mesh)
        return o[:, :, h0:h0 + hq]
    ka, va = _local_kv(q, kc, vc, cfg, ctx)
    return _decode_attention_split(q, ka, va, eff_len, c0, axes, ctx.mesh)


def decode_step(params, cache, tokens, lengths, cfg: TransformerConfig,
                ctx: ShardCtx = ShardCtx()):
    """One decode step. tokens: (B, 1) new token; lengths: (B,) cache fill.

    Returns (f32 logits (B, padded_vocab), cache); the cache is updated in
    place.  A local layer's cache is a rolling buffer: position p lives in
    slot p % Sc, and its valid length is min(lengths + 1, Sc).  With the
    cache length split, only the rank holding a row's slot writes it.
    """
    B = tokens.shape[0]
    bidx = torch.arange(B, device=tokens.device)
    x = _embed(params, tokens, cfg, ctx)     # (B,1,d)
    axes = spmd.present(ctx.cache_len_axes, ctx.mesh)
    for kind, count in cfg.layer_groups:
        kc, vc = cache[kind]["k"], cache[kind]["v"]
        Sc = kc.shape[2] * spmd.axis_size(ctx.mesh, axes)
        window = cfg.local_window if kind == "local" else None
        slot = lengths if window is None else lengths % Sc
        eff_len = torch.clamp(lengths + 1, max=Sc)
        c0 = 0
        if axes:
            c0 = _block(ctx, axes) * kc.shape[2]
            local = slot - c0
            own = ((local >= 0) & (local < kc.shape[2]))[:, None, None]
            slot = local.clamp(0, kc.shape[2] - 1)
        for i, lp in enumerate(_layers(params["groups"][kind], count)):
            lp = _gather_layer(lp, ctx)
            h = rms_norm(x, lp["ln1"])
            q, k, v = _qkv(h, lp, cfg, lengths[:, None], ctx)
            k, v = k[:, 0].to(kc.dtype), v[:, 0].to(vc.dtype)
            if axes:
                k = torch.where(own, k, kc[i, bidx, slot])
                v = torch.where(own, v, vc[i, bidx, slot])
            kc[i, bidx, slot] = k
            vc[i, bidx, slot] = v
            o = _decode_attend(q, kc[i], vc[i], eff_len, window, cfg, ctx,
                               c0)
            x = _out_ffn(x, o, lp, cfg, ctx)
    x = rms_norm(x, _final_ln(params, ctx))
    return _head(x[:, 0], params, ctx), cache


def prefill(params, tokens, cfg: TransformerConfig, max_len: int,
            ctx: ShardCtx = ShardCtx()):
    """Full-sequence forward that also fills the KV cache.

    Returns (f32 logits of the last position (B, padded_vocab), cache).
    A local group's rolling buffer takes positions S - take .. S - 1 into
    slots p % Sc, the slots decode reads; with the cache length split,
    each rank writes the slots of its part.
    """
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, tokens.device, ctx)
    x = _embed(params, tokens, cfg, ctx)
    axes = spmd.present(ctx.cache_len_axes, ctx.mesh)
    for kind, count in cfg.layer_groups:
        kc, vc = cache[kind]["k"], cache[kind]["v"]
        Sl = kc.shape[2]
        Sc = Sl * spmd.axis_size(ctx.mesh, axes)
        take = min(Sc, S)
        if axes:
            c0 = _block(ctx, axes) * Sl
            mine = [p for p in range(S - take, S) if c0 <= p % Sc < c0 + Sl]
            src = torch.tensor(mine, dtype=torch.long, device=tokens.device)
            slots = (src % Sc) - c0
        else:
            src = slice(S - take, S)
            slots = torch.arange(S - take, S, device=tokens.device) % Sc
        for i, lp in enumerate(_layers(params["groups"][kind], count)):
            x, k, v = _layer(x, lp, cfg, kind, ctx)
            kc[i][:, slots] = k[:, src].to(kc.dtype)
            vc[i][:, slots] = v[:, src].to(vc.dtype)
    x = rms_norm(x, _final_ln(params, ctx))
    return _head(x[:, -1], params, ctx), cache
