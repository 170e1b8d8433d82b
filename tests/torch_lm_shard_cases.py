"""The cases of ``tests/test_torch_lm_shard.py``: the LM cells on a mesh,
their seeded inputs (numpy only, shared with the reference's subprocess)
and the body each spawned gloo rank runs.

Inputs follow ``tests/test_torch_cells.py::materialize``: every leaf of
the cell's abstract arguments drawn from a seed in numpy (integers in
{0, 1}, floats ``|normal| x 0.02``), in ``tree_leaves`` order, which is
``jax.tree.flatten``'s; a train cell's first row has its first
:data:`MASKED` labels set to -100, so the two data blocks count
different tokens.

Every rank runs every case in order (so the collectives line up): it
shards the global inputs by the cell's ``in_specs``, runs the step,
gathers the outputs by ``out_specs`` and checks that blocks replicated
over some axes are bitwise equal across those axes.  Rank 0 saves the
gathered outputs, and the unsharded port's where the mesh's data axis
is 1, to ``port.npz``; each rank writes its failures to
``rank<r>.json``.
"""
import datetime
import json
import os
import traceback

import numpy as np

ARCHS = ("granite-3-8b", "nemotron-4-15b", "gemma3-27b", "deepseek-moe-16b",
         "dbrx-132b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# (arch, shape, mesh shape); "long_ctx" is gemma3's reduced config as the
# full config of an arch whose long_500k cell is a 64-token cache of one
# sequence (the reference's long_ctx layout, built with reduced=False)
CASES = ([(a, s, (2, 2)) for a in ARCHS for s in SHAPES]
         + [(a, s, (1, 4)) for a in ("granite-3-8b", "gemma3-27b",
                                     "deepseek-moe-16b") for s in SHAPES]
         + [("long_ctx", "long_500k", (2, 2))])
LONG_DIMS = dict(seq_len=64, global_batch=1)
MASKED = 5


def case_id(case) -> str:
    arch, shape, mesh = case
    return f"{arch}-{shape}-{mesh[0]}x{mesh[1]}"


def draw(leaves, seed: int, train: bool):
    """Seeded values for ``leaves``, a list of (shape, is_integer)."""
    rng = np.random.default_rng(seed)
    vals = [rng.integers(0, 2, s) if is_int
            else np.abs(rng.normal(size=s) * 0.02) for s, is_int in leaves]
    if train:        # the batch is the last leaves: labels, tokens
        vals[-2][0, :MASKED] = -100
    return vals


def seed_of(case) -> int:
    return CASES.index(case) + 1


# ---------------------------------------------------------------------------
# the rank body (torch from here on)
# ---------------------------------------------------------------------------

def spec_and_cell(case, mesh):
    import dataclasses
    from repro_torch import configs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import steps
    arch, shape, _ = case
    if arch == "long_ctx":
        base = configs.get("gemma3-27b")
        spec = dataclasses.replace(base, full=base.reduced, cells={
            shape: ShapeCell(shape, "decode", dims=dict(LONG_DIMS))})
        reduced = False
    else:
        spec, reduced = configs.get(arch), True
    return spec, steps.build_cell(spec, shape, mesh, reduced=reduced,
                                  device="cpu")


def global_args(cell, case):
    import torch
    from repro_torch.optim import tree_leaves, tree_unflatten
    abstract = list(cell.abstract_args)
    leaves = tree_leaves(abstract)
    vals = draw([(tuple(x.shape), not x.is_floating_point()) for x in leaves],
                seed_of(case), cell.grads_fn is not None)
    return tree_unflatten(abstract, [
        torch.from_numpy(np.asarray(v)).to(x.dtype)
        for v, x in zip(vals, leaves)])


def _clone(tree):
    from repro_torch.optim import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [x.detach().clone()
                                 for x in tree_leaves(tree)])


def _coords(mesh, rank):
    grid = mesh.mesh.tolist()
    names = mesh.mesh_dim_names

    def find(g, path):
        if isinstance(g, list):
            for i, sub in enumerate(g):
                hit = find(sub, (*path, i))
                if hit is not None:
                    return hit
            return None
        return path if g == rank else None
    return dict(zip(names, find(grid, ())))


def replicated_equal(tree, specs, mesh):
    """Every leaf bitwise equal on the ranks that hold the same block of
    it (ranks that differ only on axes its spec does not use)."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim import tree_leaves
    from repro_torch.sharding import spmd
    world = dist.get_world_size()
    coords = [_coords(mesh, r) for r in range(world)]
    for i, (x, s) in enumerate(zip(tree_leaves(tree),
                                   spmd.spec_leaves(specs))):
        used = [a for part in (s or ()) for a in spmd.part_axes(part)]
        every = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(every, x.detach().contiguous())
        for r in range(world):
            for q in range(r):
                same = all(coords[r][a] == coords[q][a] for a in used)
                if same and not torch.equal(every[r], every[q]):
                    raise AssertionError(
                        f"leaf {i} (spec {s}) differs on ranks {q} and {r}")


def run_case(case, mesh, rank, saved):
    from repro_torch.optim import tree_leaves
    from repro_torch.sharding import spmd
    spec, cell = spec_and_cell(case, mesh)
    args = global_args(cell, case)
    local = spmd.shard_tree(_clone(args), cell.in_specs, mesh)
    out = cell.step_fn(*local)
    replicated_equal(out, cell.out_specs, mesh)
    whole = spmd.unshard_tree(out, cell.out_specs, mesh)
    key = case_id(case)
    if rank == 0:
        for i, x in enumerate(tree_leaves(whole)):
            saved[f"{key}/{i}"] = x.detach().float().numpy()
    if spmd.mesh_sizes(mesh)["data"] == 1 and rank == 0:
        _, plain = spec_and_cell(case, None)
        want = plain.step_fn(*_clone(args))
        for i, x in enumerate(tree_leaves(want)):
            saved[f"{key}/plain/{i}"] = x.detach().float().numpy()


def run_rank(rank: int, world: int, store: str, out: str):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    record, saved = {}, {}
    try:
        meshes = {shape: make_local_mesh(shape, device="cpu")
                  for shape in sorted({c[2] for c in CASES})}
        for case in CASES:
            try:
                run_case(case, meshes[case[2]], rank, saved)
                record[case_id(case)] = None
            except Exception:
                record[case_id(case)] = traceback.format_exc()
    finally:
        if rank == 0:
            np.savez(os.path.join(out, "port.npz"), **saved)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
        dist.destroy_process_group()
