"""Multi-pod dry run on the CPU: every (architecture x input shape) cell
on the production meshes, counted on rank 0 of a fake process-group
world of 256 or 512 ranks; the port of the reference's
``launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --arch all

Artifacts: artifacts/dryrun/<mesh>/<arch>__<shape>.json (resumable:
cells with an existing artifact are skipped unless --force).

Eager torch has no compiler to ask, so each cell's step runs once on
``meta`` tensors at rank 0's local shapes (``spmd.local_shape`` of the
cell's global shapes by its in-specs), under three counters:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions, attention; every layer is counted, and a checkpointed
  layer's recompute too);
* bytes accessed: every ATen op's input and output bytes, views and
  allocations left out; an unfused upper bound, where XLA's count is of
  the fused program;
* collectives: ``sharding.spmd.tally``, per kind the count, operand and
  result bytes, the keys of the reference's ``collective_bytes``.

An LM train step's M microbatches are the same work, as the reference's
affine probes assume: the step is counted at 1 and at 2 microbatches of
the same rows each, and the count is ``c1 + (M - 1) (c2 - c1)``.
Argument and output bytes come from the local shapes; there is no temp
size, because no allocator runs on ``meta`` tensors.  The clique cells
launch a CUDA kernel that no ``meta`` tensor runs: they record their
argument and output bytes and their f32 ``psum`` from the specs.  The
fake group is process-global state, so the dry run is a process of its
own; it needs no card.
"""
import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..optim import tree_leaves, tree_unflatten
from ..sharding import spmd
from .mesh import make_production_mesh
from .roofline import model_flops_lm, roofline_terms
from .steps import build_cell, lm_train_cell

_NOT_BYTES = {torch.ops.aten.empty.memory_format,
              torch.ops.aten.empty_strided.default,
              torch.ops.aten.empty_like.default,
              torch.ops.aten.detach.default}
NOTES = ["flops: FlopCounterMode on meta tensors (every layer and "
         "checkpoint recompute counted)",
         "bytes accessed: each ATen op's input and output bytes, views and "
         "allocations left out: an unfused upper bound",
         "memory: argument and output bytes from the local shapes; no temp "
         "size (no allocator runs on meta tensors)"]


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class ByteCount(TorchDispatchMode):
    """Sums the input and output bytes of every ATen op it sees (views,
    allocations and collectives left out)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func in _NOT_BYTES
                or func.namespace in ("c10d", "_c10d_functional")):
            ins, _ = tree_flatten((args, kwargs))
            outs, _ = tree_flatten(out)
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out


def fake_world(n: int) -> None:
    """Rank 0 of a fake process group of ``n`` ranks (collectives return
    at once and move nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def local_args(cell, mesh):
    """``meta`` tensors of rank 0's blocks of the cell's arguments."""
    leaves = tree_leaves(list(cell.abstract_args))
    specs = spmd.spec_leaves(list(cell.in_specs))
    return tuple(tree_unflatten(list(cell.abstract_args), [
        torch.empty(spmd.local_shape(x.shape, s, mesh), dtype=x.dtype,
                    device="meta") for x, s in zip(leaves, specs)]))


def count_cell(cell, mesh) -> dict:
    """FLOPs, bytes and collectives of one run of the cell's step on
    rank 0's local ``meta`` arguments."""
    args = local_args(cell, mesh)
    arg_bytes = sum(map(_nbytes, tree_leaves(list(args))))
    if cell.meta.get("method"):      # the clique cell's CUDA kernel
        specs = spmd.spec_leaves(list(cell.out_specs))
        out_bytes = 4 + sum(
            torch.Size(spmd.local_shape((cell.meta["n_tiles"],), s, mesh))
            .numel() * 4 for s in specs[1:])
        tally = spmd.Tally()
        tally.add("all-reduce", 4, 4)
        return dict(flops=0.0, bytes=float(arg_bytes + out_bytes),
                    tally=tally, arg_bytes=arg_bytes, out_bytes=out_bytes,
                    note="the tile kernel runs on CUDA only: no FLOPs or "
                         "bytes of its own are counted, the f32 psum of the "
                         "total is from the spec")
    with FlopCounterMode(display=False) as fc, ByteCount() as bc, \
            spmd.tally() as tally:
        out = cell.step_fn(*args)
    out_bytes = sum(map(_nbytes, tree_leaves(out if isinstance(
        out, (tuple, list, dict)) else [out])))
    return dict(flops=float(fc.get_total_flops()), bytes=float(bc.bytes),
                tally=tally, arg_bytes=arg_bytes, out_bytes=out_bytes)


def count_train(spec, cell_cfg, cell, mesh) -> dict:
    """:func:`count_cell` of an LM train step of M microbatches from
    the steps of 1 and 2 microbatches of the same size."""
    M = cell.microbatches
    if M == 1:
        return count_cell(cell, mesh)
    rows = cell.batch // M

    def probe(m):
        dims = dict(cell_cfg.dims, global_batch=rows * m)
        return count_cell(lm_train_cell(
            spec, dataclasses.replace(cell_cfg, dims=dims), mesh,
            microbatches=m), mesh)
    c1, c2 = probe(1), probe(2)
    tally = spmd.Tally()
    for kind, rec in tally.kinds.items():
        for key in rec:
            a, b = c1["tally"].kinds[kind][key], c2["tally"].kinds[kind][key]
            rec[key] = a + (M - 1) * (b - a)
    args = local_args(cell, mesh)
    return dict(flops=c1["flops"] + (M - 1) * (c2["flops"] - c1["flops"]),
                bytes=c1["bytes"] + (M - 1) * (c2["bytes"] - c1["bytes"]),
                tally=tally, arg_bytes=sum(map(_nbytes, tree_leaves(
                    list(args)))), out_bytes=c1["out_bytes"],
                probe={"microbatches": M, "counted_at": [1, 2],
                       "flops": [c1["flops"], c2["flops"]]})


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: str,
             force: bool = False, verbose: bool = True) -> dict:
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    path = os.path.join(out_dir, mesh_name, f"{arch}__{shape}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    spec = configs.get(arch)
    cell_cfg = spec.cells[shape]
    record = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "kind": cell_cfg.kind, "dims": cell_cfg.dims}
    if cell_cfg.skip:
        record.update(status="skipped", reason=cell_cfg.skip)
        _write(path, record)
        return record
    try:
        multi = mesh_name == "multipod"
        fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        t0 = time.time()
        cell = build_cell(spec, shape, mesh)
        t1 = time.time()
        if spec.family == "lm" and cell_cfg.kind == "train":
            got = count_train(spec, cell_cfg, cell, mesh)
            record["probe"] = got["probe"]
        else:
            got = count_cell(cell, mesh)
        t2 = time.time()
        coll = got["tally"].kinds
        coll_total = got["tally"].operand_bytes
        flops, bytes_acc = got["flops"], got["bytes"]
        n_dev = len(mesh.mesh.flatten())
        record.update(
            status="ok", lower_s=round(t1 - t0, 3),
            compile_s=round(t2 - t1, 3), n_devices=n_dev,
            memory={"argument_size_in_bytes": got["arg_bytes"],
                    "output_size_in_bytes": got["out_bytes"]},
            cost={"flops": flops, "bytes accessed": bytes_acc},
            collectives=coll, flops_per_device=flops,
            bytes_per_device=bytes_acc, collective_operand_bytes=coll_total,
            roofline=roofline_terms(flops, bytes_acc, coll_total),
            meta=cell.meta, notes=NOTES + ([got["note"]] if "note" in got
                                           else []))
        if spec.family == "lm":
            mf = model_flops_lm(cell.meta, cell_cfg.kind)
            record["model_flops_global"] = mf
            if flops > 0:
                record["model_over_hlo_flops"] = mf / (flops * n_dev)
    except Exception as e:
        record.update(status="error", error=str(e),
                      traceback=traceback.format_exc())
    _write(path, record)
    if verbose:
        stat = record["status"]
        extra = ""
        if stat == "ok":
            r = record["roofline"]
            extra = (f" count={record['compile_s']}s"
                     f" flops/dev={record['cost']['flops']:.3e}"
                     f" dominant={r['dominant']}")
        print(f"[{mesh_name}] {arch}/{shape}: {stat}{extra}", flush=True)
    return record


def _write(path, record):
    with open(path + ".tmp", "w") as f:
        json.dump(record, f, indent=1, default=str)
    os.replace(path + ".tmp", path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list(configs.all_specs()) if args.arch == "all" else [args.arch]
    meshes = ["single", "multipod"] if args.mesh == "both" else [args.mesh]
    n_ok = n_skip = n_err = 0
    t0 = time.time()
    for mesh_name in meshes:
        for arch in archs:
            spec = configs.get(arch)
            shapes = list(spec.cells) if args.shape == "all" \
                else [args.shape]
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_name, args.out, args.force)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_err += rec["status"] == "error"
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"dry-run done: ok={n_ok} skipped={n_skip} errors={n_err} "
          f"in {time.time() - t0:.1f} s")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
