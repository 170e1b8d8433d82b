"""Mesh construction: the port of the reference's ``launch.mesh``.

Functions, not module-level constants: importing this module never
touches ``torch.distributed`` state.  A mesh is a ``DeviceMesh`` over the
initialised default process group, ranks laid out row-major in the
shape; :mod:`repro_torch.sharding.spmd` takes its groups.

* One process: :func:`make_local_mesh` with the default shape ``(1, 1)``
  initialises a 1-rank group itself from an in-memory store (NCCL on
  CUDA, gloo on the CPU), so a single-process caller needs no launcher.
* Several ranks: the caller initialises the group first (``torchrun
  --nproc-per-node N``, or ``torch.multiprocessing.spawn`` with a
  ``FileStore``), then every rank builds the same mesh.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape, axes, device) -> DeviceMesh:
    dev = resolve_device(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"mesh {tuple(shape)} needs {n} ranks: initialise the "
                "process group first (torchrun, or spawn with a FileStore)")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} "
            "(start one rank a device: torchrun --nproc-per-node)")
    return _mesh(shape, axes, device)


def make_local_mesh(shape=(1, 1), axes=("data", "model"), device="cuda"):
    """Tiny mesh over the ranks of the initialised group (tests / smoke);
    a 1-rank mesh initialises its own group when none is.  A CUDA mesh
    raises without CUDA."""
    return _mesh(shape, axes, device)
