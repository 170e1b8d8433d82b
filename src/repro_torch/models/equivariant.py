"""NequIP-lite: O(3)-equivariant interatomic potential (arXiv:2101.03164).

The port of the reference's ``models.equivariant``.  Irrep features are
dicts {l: (N, mult, 2l+1)} with parity (-1)^l.  Tensor-product paths
(l_in x l_edge -> l_out) use *real Gaunt coefficients*, solved once by
exact least squares of real-SH products onto the real-SH basis:
:func:`_sh_np` and :func:`gaunt_paths` are the reference's numpy code,
unchanged, so both packages use the same coupling tensors (11 paths at
``l_max`` = 2).  :func:`sh_torch` and :func:`bessel_basis` are the
reference's ``sh_jax`` and ``bessel_basis`` in torch.

Message passing sorts the edges by ``dst`` once and sums through
:mod:`.scatter` (a fixed order of additions; see ``models.gnn``).  Each
layer runs under ``torch.utils.checkpoint`` (non-reentrant) when a
gradient is being taken, as the reference checkpoints each layer;
``scan_layers`` is kept in the config and the port loops either way.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import apply_mlp, init_mlp
from .gnn import _index, _pool, _remat
from .scatter import full_rows, gather_rows, num_rows, own_rows, segment_sum

L_MAX = 2


# ---------------------------------------------------------------------------
# real spherical harmonics (orthonormal) up to l=4 (needed for Gaunt solve)
# ---------------------------------------------------------------------------

def _sh_np(l: int, v: np.ndarray) -> np.ndarray:
    """v: (M, 3) unit vectors -> (M, 2l+1) real orthonormal SH."""
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    pi = np.pi
    if l == 0:
        return np.full((len(v), 1), 0.5 / np.sqrt(pi))
    if l == 1:
        c = np.sqrt(3 / (4 * pi))
        return np.stack([c * y, c * z, c * x], 1)
    if l == 2:
        c = np.sqrt(15 / pi)
        return np.stack([
            0.5 * c * x * y,
            0.5 * c * y * z,
            0.25 * np.sqrt(5 / pi) * (3 * z * z - 1),
            0.5 * c * x * z,
            0.25 * c * (x * x - y * y),
        ], 1)
    # l = 3, 4 via explicit polynomials (only used in the Gaunt solve basis)
    if l == 3:
        return np.stack([
            0.25 * np.sqrt(35 / (2 * pi)) * y * (3 * x * x - y * y),
            0.5 * np.sqrt(105 / pi) * x * y * z,
            0.25 * np.sqrt(21 / (2 * pi)) * y * (5 * z * z - 1),
            0.25 * np.sqrt(7 / pi) * z * (5 * z * z - 3),
            0.25 * np.sqrt(21 / (2 * pi)) * x * (5 * z * z - 1),
            0.25 * np.sqrt(105 / pi) * (x * x - y * y) * z,
            0.25 * np.sqrt(35 / (2 * pi)) * x * (x * x - 3 * y * y),
        ], 1)
    if l == 4:
        return np.stack([
            0.75 * np.sqrt(35 / pi) * x * y * (x * x - y * y),
            0.75 * np.sqrt(35 / (2 * pi)) * y * z * (3 * x * x - y * y),
            0.75 * np.sqrt(5 / pi) * x * y * (7 * z * z - 1),
            0.75 * np.sqrt(5 / (2 * pi)) * y * z * (7 * z * z - 3),
            (3 / 16) * np.sqrt(1 / pi) * (35 * z ** 4 - 30 * z * z + 3),
            0.75 * np.sqrt(5 / (2 * pi)) * x * z * (7 * z * z - 3),
            (3 / 8) * np.sqrt(5 / pi) * (x * x - y * y) * (7 * z * z - 1),
            0.75 * np.sqrt(35 / (2 * pi)) * x * z * (x * x - 3 * y * y),
            (3 / 16) * np.sqrt(35 / pi) * (x ** 4 - 6 * x * x * y * y + y ** 4),
        ], 1)
    raise ValueError(l)


def sh_torch(l: int, v: torch.Tensor) -> torch.Tensor:
    """v: (..., 3) unit vectors -> (..., 2l+1), the torch version for
    l <= 2 (the reference's ``sh_jax``)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    pi = np.pi
    if l == 0:
        return torch.full(v.shape[:-1] + (1,), 0.5 / np.sqrt(pi),
                          dtype=v.dtype, device=v.device)
    if l == 1:
        c = np.sqrt(3 / (4 * pi))
        return torch.stack([c * y, c * z, c * x], -1)
    if l == 2:
        c = np.sqrt(15 / pi)
        return torch.stack([
            0.5 * c * x * y,
            0.5 * c * y * z,
            0.25 * np.sqrt(5 / pi) * (3 * z * z - 1),
            0.5 * c * x * z,
            0.25 * c * (x * x - y * y),
        ], -1)
    raise ValueError(l)


@functools.lru_cache(maxsize=None)
def gaunt_paths(l_max: int = L_MAX) -> Tuple[Tuple[int, int, int, np.ndarray], ...]:
    """All parity-allowed paths (l1, l2, l3, C[2l1+1, 2l2+1, 2l3+1]).

    C solved exactly: Y_{l1,a} * Y_{l2,b} = sum_{l3,c} C[a,b,c] Y_{l3,c};
    each path tensor normalized to unit Frobenius norm.
    """
    rng = np.random.default_rng(12345)
    M = 4096
    v = rng.normal(size=(M, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    basis = np.concatenate([_sh_np(l, v) for l in range(0, 5)], axis=1)
    offsets = np.cumsum([0] + [2 * l + 1 for l in range(0, 5)])
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l_max, l1 + l2) + 1):
                if (l1 + l2 + l3) % 2 == 1:
                    continue
                Y1, Y2 = _sh_np(l1, v), _sh_np(l2, v)
                prod = Y1[:, :, None] * Y2[:, None, :]       # (M, d1, d2)
                flat = prod.reshape(M, -1)
                coef, *_ = np.linalg.lstsq(basis, flat, rcond=None)
                block = coef[offsets[l3]:offsets[l3 + 1]]    # (d3, d1*d2)
                C = block.T.reshape(2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1)
                n = np.linalg.norm(C)
                if n < 1e-8:
                    continue
                paths.append((l1, l2, l3, (C / n).astype(np.float32)))
    return tuple(paths)


def bessel_basis(r, n_rbf: int, cutoff: float):
    """Normalized Bessel radial basis with smooth polynomial envelope."""
    r = torch.clamp_min(r, 1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rb = np.sqrt(2.0 / cutoff) * torch.sin(n * np.pi * r[..., None] / cutoff) \
        / r[..., None]
    u = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1 - 10 * u ** 3 + 15 * u ** 4 - 6 * u ** 5
    return rb * env[..., None]


# ---------------------------------------------------------------------------
# NequIP-lite model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    n_layers: int = 5
    mult: int = 32            # multiplicity per irrep l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 4
    radial_hidden: int = 64
    scan_layers: bool = False  # the reference's lax.scan; a loop here


def _paths(cfg: NequIPConfig):
    return [p for p in gaunt_paths(cfg.l_max)]


def init_nequip(gen: torch.Generator, cfg: NequIPConfig, device):
    n_paths = len(_paths(cfg))
    params = {"layers": []}
    params["embed"] = init_mlp(gen, [cfg.n_species, cfg.mult], device)
    for _ in range(cfg.n_layers):
        layer = {
            "radial": init_mlp(gen, [cfg.n_rbf, cfg.radial_hidden,
                                     n_paths * cfg.mult], device),
            "self": {},
        }
        for l in range(cfg.l_max + 1):
            w = torch.empty((cfg.mult, cfg.mult), device=device)
            layer["self"][str(l)] = w.normal_(generator=gen) / np.sqrt(
                cfg.mult)
        layer["gate"] = init_mlp(gen, [cfg.mult, cfg.l_max * cfg.mult],
                                 device)
        params["layers"].append(layer)
    params["head"] = init_mlp(gen, [cfg.mult, cfg.mult, 1], device)
    return params


def nequip_forward(params, species_onehot, positions, edges, edge_mask,
                   cfg: NequIPConfig, graph_ids=None, n_graphs: int = 1,
                   shard=None):
    """species_onehot: (N, n_species); positions: (N, 3); edges: (2, E).

    Returns per-graph energy (n_graphs, 1) if graph_ids given else (N, 1)
    per-node energies.  ``shard``: the sharding hook (:mod:`.scatter`).
    """
    paths = _paths(cfg)
    N = positions.shape[0]
    ei, edge_mask = _index(edges, edge_mask, num_rows(positions, shard))
    src, dst = ei.src, ei.dst
    pos = full_rows(positions, shard)
    vec = pos.index_select(0, src) - pos.index_select(0, dst)
    r = torch.linalg.norm(vec, dim=-1)
    rhat = vec / torch.clamp_min(r[:, None], 1e-6)
    # zero-length (self-loop / padded) edges would contribute constant,
    # non-transforming Y_l values -> mask them (equivariance guard)
    edge_mask = edge_mask * (r > 1e-6).to(edge_mask.dtype)
    Y = {l: sh_torch(l, rhat) for l in range(cfg.l_max + 1)}  # (E, 2l+1)
    rbf = bessel_basis(r, cfg.n_rbf, cfg.cutoff)              # (E, n_rbf)
    Cs = [torch.as_tensor(C, device=positions.device)
          for _, _, _, C in paths]

    h: Dict[int, torch.Tensor] = {
        0: apply_mlp(params["embed"], species_onehot)[:, :, None]}
    for l in range(1, cfg.l_max + 1):
        h[l] = torch.zeros((N, cfg.mult, 2 * l + 1), dtype=positions.dtype,
                           device=positions.device)

    def one_layer(h, layer):
        w_all = apply_mlp(layer["radial"], rbf, act="silu")    # (E, P*mult)
        w_all = w_all.reshape(-1, len(paths), cfg.mult)
        msg = {l: 0.0 for l in range(cfg.l_max + 1)}
        hf = {l: full_rows(v, shard) for l, v in h.items()}
        for pi, (l1, l2, l3, _) in enumerate(paths):
            hj = gather_rows(hf[l1], src, ei.by_src)           # (E, mult, d1)
            w = w_all[:, pi] * edge_mask[:, None]              # (E, mult)
            # m[e, m, c] = w * sum_ab C[a,b,c] hj[e,m,a] Y_l2[e,b]
            m = torch.einsum("ema,abc,eb->emc", hj, Cs[pi], Y[l2])
            msg[l3] = msg[l3] + m * w[:, :, None]
        upd = {}
        for l in range(cfg.l_max + 1):
            agg = own_rows(segment_sum(msg[l], ei.by_dst), shard) \
                if not isinstance(msg[l], float) else 0.0
            upd[l] = h[l] + torch.einsum(
                "nmd,mk->nkd", agg, layer["self"][str(l)]) \
                if not isinstance(agg, float) else h[l]
        # gate: scalars pass through silu; l>0 multiplied by sigmoid gates
        scalars = F.silu(upd[0][:, :, 0])
        gates = torch.sigmoid(apply_mlp(layer["gate"], scalars))
        gates = gates.reshape(N, cfg.l_max, cfg.mult)
        h = {0: scalars[:, :, None]}
        for l in range(1, cfg.l_max + 1):
            h[l] = upd[l] * gates[:, l - 1, :, None]
        return h

    for layer in params["layers"]:
        # remat: per-edge TP messages over 60M-edge graphs must not be
        # kept alive for the backward pass
        h = _remat(one_layer, h, layer)

    energy = apply_mlp(params["head"], h[0][:, :, 0], act="silu")  # (N, 1)
    if graph_ids is not None:
        return _pool(energy, graph_ids, n_graphs, shard)
    return energy
