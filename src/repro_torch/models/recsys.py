"""DCN-v2 (arXiv:2008.13535) with a hand-built EmbeddingBag.

The port of the reference's ``models.recsys``: the same formulas, in
torch.  The bag lookup is a row gather over the one (n_sparse * vocab,
dim) table plus a masked sum, as in the reference; the gather's gradient
sums the rows of each repeated index in a fixed order
(:func:`.scatter.gather_rows`), so two runs of a training step give the
same table on the card.  Single-valued categorical fields are the
bag-size-1 special case of the same code path.

Shapes:
  dense   (B, n_dense) float
  sparse  (B, n_sparse, bag) int indices into per-field vocab (padded -1)
Field f's rows start at f * vocab.

:func:`retrieval_scores` takes its top-k from a stable descending sort,
so equal scores come out lower index first, as ``lax.top_k`` gives them.

Sharding hooks: ``shard`` (a :class:`repro_torch.sharding.spmd.Rows` over
the model axis, or ``None``) says the table holds only this rank's block
of rows; the bag sums the ids that fall in it and the partial bags are
summed over the axis (identity backward: the dense part after it is
replicated over the axis).  ``cand_shard`` does the same for the
retrieval candidates: a top-k of the rank's block, gathered and merged.
"""
from __future__ import annotations

import dataclasses

import torch

from .common import apply_mlp, dense_init, init_mlp, normal_init
from .scatter import gather_rows


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    n_dense: int = 13
    n_sparse: int = 26
    vocab: int = 1_000_000       # rows per field
    embed_dim: int = 16
    n_cross: int = 3
    mlp_dims: tuple = (1024, 1024, 512)
    bag: int = 1                 # multi-hot bag size per field

    @property
    def d_x0(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


def init_dcn(gen: torch.Generator, cfg: DCNConfig, device):
    d = cfg.d_x0
    params = {
        "table": normal_init(gen, (cfg.n_sparse * cfg.vocab, cfg.embed_dim),
                             0.01, device),
        "cross": [],
        "mlp": init_mlp(gen, [d, *cfg.mlp_dims], device),
        "head": dense_init(gen, cfg.mlp_dims[-1] + d, 1, device),
    }
    for _ in range(cfg.n_cross):
        params["cross"].append({
            "w": dense_init(gen, d, d, device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device),
        })
    return params


def embedding_bag(table, indices, field_offsets, mode: str = "sum",
                  shard=None):
    """table: (R, dim); indices: (B, F, bag) with -1 padding.

    Returns (B, F, dim): a row gather + masked mean/sum -- the
    EmbeddingBag.  Padding adds 0; ``mean`` divides by max(count, 1).
    With ``shard``, ``table`` is this rank's block of rows.
    """
    B, F, bag = indices.shape
    mask = indices >= 0
    flat = (indices.long().clamp_min(0)
            + field_offsets.long()[None, :, None]).reshape(-1)
    take = mask
    if shard is not None:
        flat = flat - shard.index * table.shape[0]
        mine = (flat >= 0) & (flat < table.shape[0])
        flat = torch.where(mine, flat, 0)
        take = mask & mine.view(B, F, bag)
    emb = gather_rows(table, flat).reshape(B, F, bag, -1)
    emb = emb * take[..., None].to(emb.dtype)
    out = emb.sum(dim=2)
    if shard is not None:
        out = shard.psum(out)
    if mode == "mean":
        out = out / torch.clamp_min(mask.sum(dim=2)[..., None], 1).to(
            out.dtype)
    return out


def _x0(params, dense, sparse, cfg: DCNConfig, shard=None):
    B = dense.shape[0]
    offs = torch.arange(cfg.n_sparse, device=dense.device) * cfg.vocab
    emb = embedding_bag(params["table"], sparse, offs,
                        shard=shard)                         # (B, F, dim)
    return torch.cat([dense, emb.reshape(B, -1)], dim=-1)


def dcn_forward(params, dense, sparse, cfg: DCNConfig, shard=None):
    """Returns logits (B,)."""
    x0 = _x0(params, dense, sparse, cfg, shard)
    x = x0
    for c in params["cross"]:                                # DCN-v2 cross
        x = x0 * (x @ c["w"] + c["b"]) + x
    deep = apply_mlp(params["mlp"], x0, act="relu", final_act=True)
    feat = torch.cat([x, deep], dim=-1)
    return (feat @ params["head"])[:, 0]


def bce_loss(logits, labels):
    logits = logits.float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


# ---------------------------------------------------------------------------
# retrieval scoring: one query against n_candidates (batched dot + top-k)
# ---------------------------------------------------------------------------

def retrieval_scores(params, dense, sparse, cand_embs, cfg: DCNConfig,
                     topk: int = 100, shard=None, cand_shard=None):
    """Score the candidates for each query via the deep tower's final
    layer.

    cand_embs: (n_cand, d_tower). Returns (values, indices) top-k, ties
    lower index first.  With ``cand_shard``, ``cand_embs`` is this
    rank's block: its top-k, gathered over the axis in block order and
    merged by a stable descending sort, is the whole's (a tie keeps the
    lower global index first).
    """
    x0 = _x0(params, dense, sparse, cfg, shard)
    q = apply_mlp(params["mlp"], x0, act="relu", final_act=True)  # (B, dt)
    scores = q @ cand_embs.T                                  # (B, n_cand)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :topk], idx[:, :topk]
    if cand_shard is None:
        return vals, idx
    idx = idx + cand_shard.index * cand_embs.shape[0]
    n, (B, k) = cand_shard.size, vals.shape
    vals, idx = (cand_shard.gather(x).view(n, B, k).permute(1, 0, 2)
                 .reshape(B, n * k) for x in (vals, idx))
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals[:, :topk], idx.gather(-1, order)[:, :topk]
