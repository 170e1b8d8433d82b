"""The LM cells on a mesh: the port's sharded train, prefill and decode
steps against the reference's ``build_cell`` on the same mesh, on CPU
process groups over gloo.

* One subprocess runs the reference's unchanged ``build_cell(...,
  reduced=True)`` steps, jitted with their in and out shardings, on 4
  forced host devices (``XLA_FLAGS`` set in the child only): the five LM
  archs x {train, prefill, decode} on a (2, 2) mesh; granite-3-8b,
  gemma3-27b (the kv-head fallback that shards the decode cache's
  length over ``model``) and deepseek-moe-16b (2 experts a rank) on
  (1, 4); the ``long_ctx`` layout (one sequence, the cache length over
  the data axis) on (2, 2).  It saves every output leaf.
* At the same time one spawn of 4 gloo ranks (a ``FileStore`` under the
  test's temporary directory) runs the port's cells on the same meshes
  and seeded inputs (``tests/torch_lm_shard_cases.py``), each rank its
  blocks; rank 0 saves the gathered outputs and, where the data axis is
  1, the unsharded port's.

Tolerances are ``tests/test_torch_cells.py``'s: logits and caches within
``LM_ATOL`` of the arch, a train step's loss and grad norm within
``TRAIN_REL``, its lr within rtol 1e-6 and its params within 2 x lr.  A
MoE step with data > 1 computes the capacity from each data block's
tokens, as the reference's ``shard_map`` does, so it is held against the
reference on the same mesh, never against the unsharded step.  Blocks
replicated over some axes are bitwise equal across those axes (every
output leaf, the updated params and moments included).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_lm_shard_cases as cases
from test_torch_cells import LM_ATOL, TRAIN_REL, close

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = r"""
import dataclasses
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import ShapeCell
from repro.launch import steps
import torch_lm_shard_cases as cases

out = {}
for case in cases.CASES:
    arch, shape, mshape = case
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(mshape),
                ("data", "model"))
    if arch == "long_ctx":
        base = configs.get("gemma3-27b")
        spec = dataclasses.replace(base, full=base.reduced, cells={
            shape: ShapeCell(shape, "decode", dims=dict(cases.LONG_DIMS))})
        cell = steps.build_cell(spec, shape, mesh, reduced=False)
    else:
        cell = steps.build_cell(configs.get(arch), shape, mesh, reduced=True)
    leaves, tdef = jax.tree.flatten(cell.abstract_args)
    vals = cases.draw([(tuple(s.shape), jnp.issubdtype(s.dtype, jnp.integer))
                       for s in leaves], cases.seed_of(case),
                      cell.meta.get("tokens_per_step") is not None
                      and "kv_cache_tokens" not in cell.meta
                      and len(cell.abstract_args) == 3)
    args = jax.tree.unflatten(tdef, [jnp.asarray(v).astype(s.dtype)
                                     for v, s in zip(vals, leaves)])
    args = jax.device_put(args, cell.in_specs)
    got = jax.jit(cell.step_fn, in_shardings=cell.in_specs,
                  out_shardings=cell.out_specs)(*args)
    for i, x in enumerate(jax.tree.leaves(got)):
        out[f"{cases.case_id(case)}/{i}"] = np.asarray(x, np.float32)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference outputs, port outputs, per-rank failure records): the
    reference's subprocess and the port's spawn run at the same time."""
    work = tmp_path_factory.mktemp("lm_shard")
    ref_path = work / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]))
    child = subprocess.Popen([sys.executable, "-c", REFERENCE,
                              str(ref_path)], env=env, cwd=str(work))
    try:
        mp.spawn(cases.run_rank, nprocs=4, join=True,
                 args=(4, str(work / "store"), str(work)))
        assert child.wait(timeout=600) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    records = [json.loads((work / f"rank{r}.json").read_text())
               for r in range(4)]
    return dict(np.load(ref_path)), dict(np.load(work / "port.npz")), records


def leaves_of(arrays, key):
    n = sum(1 for k in arrays if k.rsplit("/", 1)[0] == key)
    return [arrays[f"{key}/{i}"] for i in range(n)]


def check_step(got, want, arch, shape):
    """``got`` against ``want``, leaves in ``tree_leaves`` order, by the
    cell kind's tolerance."""
    assert len(got) == len(want) and got
    if shape == "train_4k":
        # (params, opt state, metrics): metrics last, grad_norm, loss, lr
        gnorm, loss, lr = got[-3:]
        close(gnorm, want[-3], rtol=TRAIN_REL["grad_norm"], atol=0)
        close(loss, want[-2], rtol=TRAIN_REL["loss"], atol=0)
        close(lr, want[-1], rtol=1e-6)
        n_params = (len(got) - 4) // 3
        for a, b in zip(got[:n_params], want[:n_params]):
            close(a, b, rtol=0, atol=2 * float(want[-1]))
        assert got[n_params] == want[n_params]        # the step count
    else:
        atol = LM_ATOL["gemma3-27b" if arch == "long_ctx" else arch]
        for a, b in zip(got, want):
            close(a, b, rtol=0, atol=atol)
    for a in got:
        assert np.isfinite(a).all()


IDS = [cases.case_id(c) for c in cases.CASES]


@pytest.mark.parametrize("case", cases.CASES, ids=IDS)
def test_sharded_step_like_reference(results, case):
    ref, port, records = results
    key = cases.case_id(case)
    failures = [f"rank {r}:\n{rec.get(key, 'no record')}"
                for r, rec in enumerate(records) if rec.get(key) is not None
                or key not in rec]
    assert not failures, "\n".join(failures)
    check_step(leaves_of(port, key), leaves_of(ref, key), case[0], case[1])


DATA1 = [c for c in cases.CASES if c[2][0] == 1]


@pytest.mark.parametrize("case", DATA1, ids=[cases.case_id(c) for c in DATA1])
def test_sharded_step_like_unsharded_where_data_is_1(results, case):
    _, port, _ = results
    key = cases.case_id(case)
    check_step(leaves_of(port, key), leaves_of(port, f"{key}/plain"),
               case[0], case[1])
