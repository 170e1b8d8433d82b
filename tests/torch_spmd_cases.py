"""The multi-rank cases of ``tests/test_torch_spmd.py``: seeded inputs
(numpy only, shared with the reference's subprocess) and the body each
spawned gloo rank runs.

Every rank runs every case of its world in order (so the collectives
line up), records each case's failure and writes its record to
``<out>/world<n>_rank<r>.json``.  A case compares the port on a mesh with
the port without one on the same seeded inputs (and, where the reference
saved its own result, with that).
"""
import datetime
import json
import os
import re
import traceback

import numpy as np

CASES = {
    2: ["clique (2, 1)", "clique (1, 2)", "compress world 2",
        "recsys (1, 2)", "checkpoint (2, 1)", "shard (2, 1)",
        "copy_to world 2", "all_gather_dim world 2", "pmax world 2"],
    4: ["clique (2, 2)", "clique (2, 2) vs reference", "gnn gin-tu (2, 2)",
        "gnn egnn (2, 2)", "recsys (2, 2)", "compress world 4",
        "shard (2, 2)", "shard (2, 1, 2)", "checkpoint (2, 2)",
        "copy_to world 4", "all_gather_dim world 4", "pmax world 4"],
}
COMPRESS_SHAPE = (5, 7)          # 35 elements: padded at worlds 2 and 4
SCATTER_REL = 1e-5


def compress_inputs(n: int):
    """(x, err): rank r's gradient and error buffer are row r."""
    rng = np.random.default_rng(100 + n)
    x = rng.normal(size=(n, *COMPRESS_SHAPE)).astype(np.float32)
    err = (rng.normal(size=(n, *COMPRESS_SHAPE)) * 1e-3).astype(np.float32)
    return x, err


def clique_inputs(B: int = 256, T: int = 32):
    """(B, T, T // 32) uint32 symmetric adjacency words and (B, W)
    candidate words, p = 0.3."""
    rng = np.random.default_rng(11)
    upper = np.triu(rng.random((B, T, T)) < 0.3, 1)
    dense = upper | upper.transpose(0, 2, 1)
    cand = rng.random((B, T)) < 0.8

    def pack(bits):
        w = bits.reshape(*bits.shape[:-1], -1, 32).astype(np.uint64)
        return (w << np.arange(32, dtype=np.uint64)).sum(-1).astype(
            np.uint32)
    return pack(dense), pack(cand)


# ---------------------------------------------------------------------------
# the rank body (torch from here on)
# ---------------------------------------------------------------------------

def run_rank(rank: int, world: int, store: str, out: str, ref: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    record = {}
    try:
        ref_arrays = dict(np.load(ref)) if os.path.exists(ref) else {}
        for case in CASES[world]:
            try:
                _CASE_FNS[case.split()[0]](case, rank, world, ref_arrays,
                                           out)
                record[case] = None
            except Exception:
                record[case] = traceback.format_exc()
    finally:
        with open(os.path.join(out, f"world{world}_rank{rank}.json"),
                  "w") as f:
            json.dump(record, f)
        dist.destroy_process_group()


def _shape(case: str):
    inner = re.search(r"\(([\d, ]+)\)", case).group(1)
    return tuple(int(x) for x in inner.split(","))


def _mesh(case: str):
    from repro_torch.launch.mesh import make_local_mesh
    shape = _shape(case)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                            "model")
    return make_local_mesh(shape, axes, device="cpu")


def _cell(arch, shape, mesh):
    from repro_torch import configs
    from repro_torch.launch import steps
    return steps.build_cell(configs.get(arch), shape, mesh, reduced=True,
                            device="cpu")


def _equal(a, b, what):
    import torch
    assert torch.equal(a, b), f"{what}: {a} != {b}"


def _close(got, want, what):
    """Within :data:`SCATTER_REL` of the reference's largest magnitude
    (a sum's rounding is relative to the magnitudes it adds)."""
    import torch
    got, want = got.detach().double(), want.detach().double()
    bound = SCATTER_REL * max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert got.shape == want.shape and err <= bound, \
        f"{what}: max |diff| {err:.3e} > {bound:.3e}"


def case_clique(case, rank, world, ref, out):
    import torch
    from repro_torch.sharding import spmd
    mesh = _mesh(case)
    A, cand = clique_inputs()
    cell = _cell("ebbkc", "ep_tri_1m", mesh)
    want = _cell("ebbkc", "ep_tri_1m", None).step_fn(A, cand)
    At = torch.from_numpy(A.view(np.int32))
    ct = torch.from_numpy(cand.view(np.int32))
    ts, cs = cell.in_specs
    got = cell.step_fn(spmd.shard(At, ts, mesh), spmd.shard(ct, cs, mesh))
    _equal(got[0], want[0], "total")
    for name, g, w, s in zip("nv t f".split(), got[1:], want[1:],
                             cell.out_specs[1:]):
        _equal(spmd.unshard(g, s, mesh), w, name)
    if case.endswith("vs reference"):
        assert float(got[0]) == float(ref["clique_total"])
        for name, g, s in zip("nv t f".split(), got[1:], cell.out_specs[1:]):
            np.testing.assert_array_equal(
                spmd.unshard(g, s, mesh).numpy(), ref[f"clique_{name}"])


def case_compress(case, rank, world, ref, out):
    import torch
    import torch.distributed as dist
    from repro_torch.optim import compressed_allreduce
    x, err = compress_inputs(world)
    got, new_err = compressed_allreduce(torch.from_numpy(x[rank]),
                                        torch.from_numpy(err[rank]),
                                        dist.group.WORLD)
    want = ref[f"compress{world}_reduced"]
    want_err = ref[f"compress{world}_err"]
    if world == 2:
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(new_err.numpy(), want_err)
        return
    # four terms sum in an order of their own: each element within one
    # quantum (its shard's scale) of the reference's
    flat = (x.astype(np.float64).sum(0) / world).reshape(-1)
    e = err.astype(np.float64).reshape(world, -1)
    m = -(-flat.size // world)
    quantum = np.empty(flat.size)
    for i in range(world):
        part = slice(i * m, min((i + 1) * m, flat.size))
        quantum[part] = np.abs(flat[part] + e[i, part]).max() / 127
    quantum = 1.001 * quantum.reshape(COMPRESS_SHAPE)
    assert (np.abs(got.numpy() - want) <= quantum).all()
    assert (np.abs(new_err.numpy() - want_err) <= quantum).all()


def _draw(cell, seed):
    import torch
    from repro_torch.launch.train import drawn_params
    gen = torch.Generator()
    gen.manual_seed(seed)
    return drawn_params(cell.init, gen, "cpu")


def _clone(tree):
    from repro_torch.optim import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [x.detach().clone()
                                 for x in tree_leaves(tree)])


def _params_equal_across_ranks(params):
    import torch
    import torch.distributed as dist
    from repro_torch.optim import tree_leaves
    flat = torch.cat([p.detach().reshape(-1) for p in tree_leaves(params)])
    every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(every, flat)
    for i, other in enumerate(every):
        _equal(other, flat, f"rank {i}'s params")


def case_gnn(case, rank, world, ref, out):
    import torch
    from repro_torch.launch.train import GnnPipeline
    from repro_torch.optim import adamw_init, tree_leaves
    from repro_torch.sharding import spmd
    arch = case.split()[1]
    shape = {"gin-tu": "full_graph_sm", "egnn": "molecule"}[arch]
    mesh = _mesh(case)
    cell, plain = _cell(arch, shape, mesh), _cell(arch, shape, None)
    batch = GnnPipeline(cell.batch_shapes, cell.meta["n_nodes"]).next_batch()
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = _draw(cell, 3)
    want_loss, want_g = plain.grads_fn(_clone(params), batch)
    local = spmd.shard_tree(batch, cell.in_specs[2], mesh)
    loss, grads = cell.grads_fn(_clone(params), local)
    _close(loss, want_loss, "loss")
    for i, (g, w) in enumerate(zip(tree_leaves(grads), tree_leaves(want_g))):
        _close(g, w, f"grad leaf {i}")
    p, o = _clone(params), adamw_init(params)
    p, o, m = cell.step_fn(p, o, local)
    _, _, wm = plain.step_fn(_clone(params), adamw_init(params), batch)
    _close(m["grad_norm"], wm["grad_norm"], "grad_norm")
    _params_equal_across_ranks(p)


def case_recsys(case, rank, world, ref, out):
    import torch
    from repro_torch.data import RecsysPipeline
    from repro_torch.optim import adamw_init, tree_leaves
    from repro_torch.sharding import spmd
    mesh = _mesh(case)
    cell, plain = (_cell("dcn-v2", "train_batch", m) for m in (mesh, None))
    cfg = cell.cfg
    params = _draw(cell, 4)
    batch = RecsysPipeline(n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                           vocab=cfg.vocab, batch=cell.meta["batch"],
                           bag=cfg.bag, seed=5).next_batch()
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pspec, _, bspec = cell.in_specs
    local_p = spmd.shard_tree(_clone(params), pspec, mesh)
    local_b = spmd.shard_tree(batch, bspec, mesh)
    want_loss, want_g = plain.grads_fn(_clone(params), batch)
    loss, grads = cell.grads_fn(_clone(local_p), local_b)
    _close(loss, want_loss, "loss")
    whole = spmd.unshard_tree(grads, pspec, mesh)
    for i, (g, w) in enumerate(zip(tree_leaves(whole), tree_leaves(want_g))):
        _close(g, w, f"grad leaf {i}")
    p, o, m = cell.step_fn(_clone(local_p), adamw_init(local_p), local_b)
    _, _, wm = plain.step_fn(_clone(params), adamw_init(params), batch)
    _close(m["loss"], wm["loss"], "step loss")
    _close(m["grad_norm"], wm["grad_norm"], "grad_norm")

    serve, splain = (_cell("dcn-v2", "serve_p99", m) for m in (mesh, None))
    sp, dspec, sspec = serve.in_specs
    dense, sparse = batch["dense"], batch["sparse"]
    logits = serve.step_fn(local_p, spmd.shard(dense, dspec, mesh),
                           spmd.shard(sparse, sspec, mesh))
    _close(spmd.unshard(logits, serve.out_specs, mesh),
           splain.step_fn(params, dense, sparse), "serve logits")

    ret, rplain = (_cell("dcn-v2", "retrieval_cand", m)
                   for m in (mesh, None))
    rng = np.random.default_rng(6)
    n_cand = ret.meta["n_candidates"]
    cand = torch.from_numpy(rng.normal(size=(n_cand, cfg.mlp_dims[-1]))
                            .astype(np.float32))
    q_dense, q_sparse = dense[:2], sparse[:2]
    # the top candidate copied into the other half: a tie across the
    # candidate blocks, the lower global index first
    top = int(rplain.step_fn(params, q_dense, q_sparse, cand)[1][0, 0])
    cand[(top + n_cand // 2) % n_cand] = cand[top]
    v, i = ret.step_fn(local_p, q_dense, q_sparse,
                       spmd.shard(cand, ret.in_specs[3], mesh))
    wv, wi = rplain.step_fn(params, q_dense, q_sparse, cand)
    assert wv[0, 0] == wv[0, 1]
    _equal(i, wi, "retrieval indices")
    _close(v, wv, "retrieval scores")


def case_shard(case, rank, world, ref, out):
    import torch
    from repro_torch.sharding import P, spmd
    mesh = _mesh(case)
    names = spmd.axis_names(mesh)
    x = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    specs = [P(names, None, None), P(None, "model", None),
             P("data", None, None), P(("data", "model"), None, None),
             P("data", "model", None), P(None, None, None), P()]
    if "pod" in names:
        specs += [P(("pod", "data"), "model", None),
                  P("pod", None, ("data", "model"))]
    for s in specs:
        s = spmd.filter_spec(s, mesh)
        block = spmd.shard(x, s, mesh)
        assert tuple(block.shape) == spmd.local_shape(x.shape, s, mesh), s
        _equal(spmd.unshard(block, s, mesh), x, f"round trip {s}")


def case_checkpoint(case, rank, world, ref, out):
    import torch
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.sharding import P, spmd
    mesh = _mesh(case)
    tree = {"table": torch.arange(32.).reshape(8, 4),
            "tiles": torch.arange(48, dtype=torch.int32).reshape(4, 12),
            "scale": torch.tensor(2.5)}
    specs = {"table": P("model", None), "tiles": P(("data", "model"), None),
             "scale": None}
    d = os.path.join(out, f"ckpt{world}_{rank}")
    save_checkpoint(d, 3, tree)
    got = restore_checkpoint(d, tree, mesh=mesh, specs=specs)
    assert got["step"] == 3
    for k, v in tree.items():
        want = v if specs[k] is None else spmd.shard(v, specs[k], mesh)
        _equal(got["tree"][k], want, k)


def _world_mesh(world):
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh((world,), ("model",), device="cpu")


def _rank_values(world, shape, seed):
    """(every rank's seeded value, stacked on dim 0): rank r's is row r."""
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(world, *shape))
                            .astype(np.float32))


def case_copy_to(case, rank, world, ref, out):
    """copy_to is ``x`` forward; its backward sums every rank's cotangent:
    d/dx of sum_r <w_r, x> is sum_r w_r (one all-reduce, tallied)."""
    import torch
    from repro_torch.sharding import spmd
    mesh = _world_mesh(world)
    x = _rank_values(1, (3, 5), 20)[0].requires_grad_(True)
    w = _rank_values(world, (3, 5), 21)
    with spmd.tally() as t:
        y = spmd.copy_to(x, ("model",), mesh)
        _equal(y.detach(), x.detach(), "forward")
        (gx,) = torch.autograd.grad((y * w[rank]).sum(), [x])
    torch.testing.assert_close(gx, w.sum(0), rtol=1e-6, atol=1e-6)
    assert t.kinds["all-reduce"] == {"count": 1, "operand_bytes": 60,
                                     "result_bytes": 60}, t.kinds


def case_all_gather_dim(case, rank, world, ref, out):
    """all_gather_dim of each rank's block on dim 1 is the global tensor;
    its backward gives each rank its block of sum_r g_r (a
    reduce-scatter); the tally's bytes follow collective_bytes."""
    import torch
    from repro_torch.sharding import P, spmd
    mesh = _world_mesh(world)
    full = _rank_values(1, (3, 8, 5), 22)[0]
    block = spmd.shard(full, P(None, "model", None), mesh)
    block.requires_grad_(True)
    g = _rank_values(world, (3, 8, 5), 23)
    with spmd.tally() as t:
        y = spmd.all_gather_dim(block, 1, ("model",), mesh)
        _equal(y.detach(), full, "forward")
        (gb,) = torch.autograd.grad((y * g[rank]).sum(), [block])
    want = spmd.shard(g.sum(0), P(None, "model", None), mesh)
    torch.testing.assert_close(gb, want, rtol=1e-6, atol=1e-6)
    n = full.numel() * 4
    assert t.kinds["all-gather"] == {"count": 1, "operand_bytes": n // world,
                                     "result_bytes": n}, t.kinds
    assert t.kinds["reduce-scatter"] == {"count": 1, "operand_bytes": n,
                                         "result_bytes": n // world}, t.kinds


def case_pmax(case, rank, world, ref, out):
    """pmax is the elementwise max over the ranks, without a gradient."""
    from repro_torch.sharding import spmd
    mesh = _world_mesh(world)
    x = _rank_values(world, (4, 6), 24)
    got = spmd.pmax(x[rank].clone().requires_grad_(True), ("model",), mesh)
    _equal(got, x.max(0).values, "pmax")
    assert not got.requires_grad


_CASE_FNS = {"clique": case_clique, "compress": case_compress,
             "gnn": case_gnn, "recsys": case_recsys, "shard": case_shard,
             "checkpoint": case_checkpoint, "copy_to": case_copy_to,
             "all_gather_dim": case_all_gather_dim, "pmax": case_pmax}
