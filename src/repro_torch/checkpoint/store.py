"""Numpy checkpoints: atomic, resumable, verified, placed on restore.

The port's copy of ``repro/checkpoint/store.py``, without jax.  Layout:
``<dir>/step_<N>/{arrays.npz, meta.json, COMMITTED}``, byte for byte what
the reference writes, so a store written by either package reads in the
other.

* **Atomic**: written to ``step_<N>.tmp`` then ``os.replace``d; a crash
  mid-write never corrupts the latest checkpoint; restore picks the newest
  *committed* step.
* **Verified**: ``meta.json`` carries a length + sha256 trailer over the
  raw ``arrays.npz`` bytes; restore checks it before deserializing, so
  bit-rot or truncation surfaces as a typed
  :class:`CorruptCheckpointError` instead of a numpy traceback.  Consumers
  with a rebuild path (plan cache, tune records) pair this with
  :func:`quarantine` to move the bad step aside and fall back to absent.
* **Placed on restore**: arrays are stored as full host values and
  placed under the restarted layout, whatever topology wrote them (the
  reference's ``shardings=``, its elastic-rescale path): ``device=``
  returns torch tensors on that device (numpy arrays without it), and
  ``mesh=`` with a spec tree ``specs=`` returns each rank its own
  blocks.  Torch tensors in a saved tree are copied to the host first.
* Pipeline state and arbitrary JSON metadata ride along.
"""
from __future__ import annotations

import hashlib
import io
import itertools
import json
import logging
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..resilience import inject

log = logging.getLogger("repro.checkpoint")

# unique suffixes for quarantined step dirs within one process
_QUAR_IDS = itertools.count()


class CorruptCheckpointError(RuntimeError):
    """A committed checkpoint failed integrity checks or did not parse."""


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}/#{i}", v)
        else:
            flat[prefix] = node

    rec("", tree)
    return flat


def _unflatten_into(template, flat: Dict[str, Any]):
    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(f"{prefix}/{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [rec(f"{prefix}/#{i}", v) for i, v in enumerate(node)]
            return type(node)(vals)
        return flat[prefix]
    return rec("", template)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a torch tensor is copied off its
    device first)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _place(tree, device):
    """Every array leaf of ``tree`` as a torch tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, device) for v in tree)
    return torch.as_tensor(np.asarray(tree)).to(device)


def save_checkpoint(directory: str, step: int, tree,
                    pipeline_state: Optional[Dict] = None,
                    metadata: Optional[Dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    arrays = {k: _host(v) for k, v in flat.items()}
    arr_path = os.path.join(tmp, "arrays.npz")
    np.savez(arr_path, **arrays)
    with open(arr_path, "rb") as f:
        blob = f.read()
    meta = {"step": step, "pipeline": pipeline_state or {},
            "metadata": metadata or {},
            "integrity": {"nbytes": len(blob),
                          "sha256": hashlib.sha256(blob).hexdigest()}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "COMMITTED")):
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def restore_checkpoint(directory: str, template=None,
                       step: Optional[int] = None, device=None,
                       mesh=None, specs=None,
                       _corrupt_site: Optional[str] = None):
    """Restore into the structure of ``template``.

    With ``template=None`` the flat array dict is returned as the tree
    (keys are the flattened ``a/b/#i`` paths) -- the schema-free mode used
    by consumers whose structure is data-dependent, e.g. the
    :mod:`repro_torch.core.pipeline` plan store (a plan may or may not
    carry a truss decomposition, coloring, or either membership table).

    ``device``: where the leaves go.  ``None`` returns them as numpy
    arrays; a torch device (``"cpu"``, ``"cuda:0"``) returns torch
    tensors there, whatever device wrote them.  ``mesh`` (a
    ``DeviceMesh``) with ``specs`` (a tree of partition specs shaped like
    the tree, ``None`` for a leaf kept whole): each rank gets its blocks
    (:func:`repro_torch.sharding.spmd.shard_tree`), on ``device`` or else
    the mesh's device type.

    Integrity: when ``meta.json`` carries the length+sha256 trailer (every
    store written since it was introduced), the raw ``arrays.npz`` bytes
    are verified *before* deserialization.  Any mismatch, unreadable file,
    or parse failure raises :class:`CorruptCheckpointError` (never a raw
    numpy/json traceback).  ``_corrupt_site`` threads the named
    fault-injection site whose ``corrupt`` rule mutates the blob between
    read and verify (chaos-testing the detection path).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = os.path.join(directory, f"step_{step:010d}")
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(path, "arrays.npz"), "rb") as f:
            blob = f.read()
        if _corrupt_site is not None:
            blob = inject.corrupt_bytes(_corrupt_site, blob)
        integ = meta.get("integrity")
        if integ is not None and (
            integ.get("nbytes") != len(blob)
            or integ.get("sha256") != hashlib.sha256(blob).hexdigest()
        ):
            raise CorruptCheckpointError(
                f"{path}: arrays.npz failed its length+digest check")
        data = np.load(io.BytesIO(blob))
        flat = {k: data[k] for k in data.files}
        pipeline_state = meta["pipeline"]
        metadata = meta["metadata"]
    except CorruptCheckpointError:
        raise
    except Exception as exc:
        raise CorruptCheckpointError(
            f"{path}: unreadable checkpoint ({exc!r})") from exc
    tree = flat if template is None else _unflatten_into(template, flat)
    if mesh is not None:
        from ..sharding.spmd import shard_tree
        tree = shard_tree(_place(tree, torch.device(
            device if device is not None else mesh.device_type)),
            specs, mesh)
    elif device is not None:
        tree = _place(tree, torch.device(device))
    return {"step": step, "tree": tree, "pipeline": pipeline_state,
            "metadata": metadata}


def read_metadata(directory: str, step: Optional[int] = None
                  ) -> Optional[Dict]:
    """The ``metadata`` dict of a committed step, without loading arrays.

    Cheap lineage/inventory probe: reads only ``meta.json``.  Returns None
    when the step is absent or the metadata is unreadable -- integrity of
    the array blob is *not* checked here (that happens on the full
    :func:`restore_checkpoint`).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = os.path.join(directory, f"step_{step:010d}", "meta.json")
    try:
        with open(path) as f:
            return json.load(f).get("metadata", {})
    except (OSError, ValueError):
        return None


def quarantine(directory: str, step: Optional[int] = None,
               reason: str = "") -> Optional[str]:
    """Move a (corrupt) checkpoint step aside into ``<dir>/quarantine/``.

    The graceful-degradation half of :class:`CorruptCheckpointError`:
    instead of deleting evidence or letting every restore hit the same
    bad file, the step directory is renamed under ``quarantine/`` (same
    filesystem, atomic) so the next save rebuilds cleanly while the bad
    bytes stay inspectable.  Best-effort: returns the quarantine path, or
    None when there was nothing to move.  Never raises.
    """
    try:
        if step is None:
            step = latest_step(directory)
        if step is None:
            return None
        src = os.path.join(directory, f"step_{step:010d}")
        if not os.path.isdir(src):
            return None
        qdir = os.path.join(directory, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(
            qdir, f"step_{step:010d}.{os.getpid()}.{next(_QUAR_IDS)}")
        os.replace(src, dst)
    except OSError:
        return None
    log.warning("quarantined corrupt checkpoint %s -> %s (%s)",
                src, dst, reason or "integrity check failed")
    return dst


def restore_checkpoint_safe(directory: str, template=None,
                            step: Optional[int] = None, device=None,
                            mesh=None, specs=None,
                            _corrupt_site: Optional[str] = None):
    """:func:`restore_checkpoint` with the fall-back-to-absent contract.

    A corrupt or unreadable step is quarantined (moved aside with a
    warning log) and reads as absent (``None``), so callers with a
    rebuild path -- the plan cache, tune records -- regenerate instead of
    propagating deserialization tracebacks.
    """
    try:
        return restore_checkpoint(directory, template, step, device, mesh,
                                  specs, _corrupt_site=_corrupt_site)
    except CorruptCheckpointError as exc:
        quarantine(directory, step, reason=str(exc))
        return None


def gc_checkpoints(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(m.group(1)) for name in os.listdir(directory)
        if (m := re.fullmatch(r"step_(\d+)", name)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)
