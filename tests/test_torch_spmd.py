"""The port's mesh, SPMD collectives, int8-compressed all-reduce and
sharded cells, on CPU process groups over gloo.

* One subprocess runs the reference's unchanged
  ``repro.optim.compress.compressed_allreduce`` inside ``jax.shard_map``
  on 2 and 4 forced host devices, and its ``clique_cell`` on a (2, 2)
  mesh, and saves what they return.
* One spawn a world size (2 and 4 ranks, a ``FileStore`` under the test's
  temporary directory) runs every case of ``tests/torch_spmd_cases.py``:
  ``clique_cell`` per-tile outputs and totals exact against the port
  without a mesh (and the reference's on (2, 2)); the GNN and recsys
  sharded steps within ``SCATTER_REL`` = 1e-5 of the largest magnitude
  of the unsharded values, with replicated params bitwise equal across
  ranks after AdamW; ``compressed_allreduce`` bitwise equal to the
  reference at world 2 and within one quantum at world 4;
  ``shard``/``unshard`` round trips; ``restore_checkpoint(mesh=,
  specs=)``; ``copy_to``, ``all_gather_dim`` and ``pmax`` against their
  unsharded math (and the collective tally's bytes).
* In process: ``int8_compress`` / ``int8_decompress`` bitwise against
  JAX's, the mesh constructors' errors, and the LM cells of granite-3-8b
  and deepseek-moe-16b on a 1-rank mesh equal to the unsharded cells to
  the bit (world-1 collectives are copies).  ``tests/test_torch_lm_shard.py``
  holds the LM cells on larger meshes against the reference.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_spmd_cases as cases
from repro.optim import compress as jcompress
from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.optim import (compressed_allreduce, compressed_psum_tree,
                               int8_compress, int8_decompress, tree_leaves,
                               tree_unflatten)
from repro_torch.sharding import spmd

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = r"""
import sys
import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P
from repro import configs
from repro.launch import steps
from repro.optim.compress import compressed_allreduce
import torch_spmd_cases as cases

out = {}
for n in (2, 4):
    x, err = cases.compress_inputs(n)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))
    fn = jax.shard_map(
        lambda a, e: compressed_allreduce(a[0], e[0], "d"), mesh=mesh,
        in_specs=(P("d"), P("d")), out_specs=(P(), P()), check_vma=False)
    r, e = jax.jit(fn)(x, err)
    out[f"compress{n}_reduced"] = np.asarray(r)
    out[f"compress{n}_err"] = np.asarray(e)
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
cell = steps.build_cell(configs.get("ebbkc"), "ep_tri_1m", mesh,
                        reduced=True)
total, nv, t, f = jax.jit(cell.step_fn)(*cases.clique_inputs())
out.update(clique_total=np.asarray(total), clique_nv=np.asarray(nv),
           clique_t=np.asarray(t), clique_f=np.asarray(f))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("spmd")


@pytest.fixture(scope="module")
def reference(workdir):
    """The reference's results on forced host devices (saved npz)."""
    path = workdir / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]))
    subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                   check=True, timeout=600, cwd=str(workdir))
    return path


def spawn(world, workdir, reference):
    out = workdir / f"world{world}"
    out.mkdir()
    mp.spawn(cases.run_rank, nprocs=world, join=True,
             args=(world, str(out / "store"), str(out), str(reference)))
    records = [json.loads((out / f"world{world}_rank{r}.json").read_text())
               for r in range(world)]
    return {case: [rec.get(case, "no record") for rec in records]
            for case in cases.CASES[world]}


@pytest.fixture(scope="module")
def world2(workdir, reference):
    return spawn(2, workdir, reference)


@pytest.fixture(scope="module")
def world4(workdir, reference):
    return spawn(4, workdir, reference)


def check(results, case):
    failures = [f"rank {r}:\n{err}" for r, err in enumerate(results[case])
                if err is not None]
    assert not failures, "\n".join(failures)


@pytest.mark.parametrize("case", cases.CASES[2])
def test_two_ranks(world2, case):
    check(world2, case)


@pytest.mark.parametrize("case", cases.CASES[4])
def test_four_ranks(world4, case):
    check(world4, case)


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_err", [False, True])
def test_int8_compress_equals_reference_bitwise(with_err):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(33, 17)) * 3).astype(np.float32)
    x[0, 0] = 0.5 * np.abs(x).max()      # ties round half to even
    err = (rng.normal(size=x.shape) * 1e-2).astype(np.float32)
    e = err if with_err else None
    # compiled, as the reference runs it (its error is a fused multiply-add)
    jq, js, je = jax.jit(jcompress.int8_compress)(
        jnp.asarray(x), None if e is None else jnp.asarray(e))
    pq, ps, pe = int8_compress(torch.from_numpy(x),
                               None if e is None else torch.from_numpy(e))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    np.testing.assert_array_equal(int8_decompress(pq, ps).numpy(),
                                  np.asarray(jcompress.int8_decompress(jq,
                                                                       js)))
    got, got_err = compressed_allreduce(torch.from_numpy(x),
                                        torch.from_numpy(err), None)
    want, want_err = jax.jit(jcompress.compressed_allreduce,
                             static_argnums=2)(jnp.asarray(x),
                                               jnp.asarray(err), None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_err.numpy(), np.asarray(want_err))


def test_compressed_psum_tree_is_leafwise():
    tree = {"b": [torch.ones(3)], "a": torch.arange(4.)}
    errs = {"b": [torch.zeros(3)], "a": torch.zeros(4)}
    red, new = compressed_psum_tree(tree, errs, None)
    assert set(red) == {"a", "b"} and red["b"][0].shape == (3,)
    torch.testing.assert_close(red["a"] + new["a"], tree["a"])


def test_meshes_raise_where_they_cannot_run():
    with pytest.raises(RuntimeError, match=r"needs 256 devices, have 1"):
        mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match=r"needs 512 devices"):
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_local_mesh()
    with pytest.raises(RuntimeError, match="initialise the process group"):
        mesh_mod.make_local_mesh((2, 1), device="cpu")


@pytest.fixture
def one_rank_mesh():
    assert not dist.is_initialized()
    mesh = mesh_mod.make_local_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_one_rank_mesh_runs_the_clique_cell(one_rank_mesh):
    spec = configs.get("ebbkc")
    cell = steps.build_cell(spec, "ep_tri_1m", one_rank_mesh, reduced=True)
    assert cell.in_specs == ((("data", "model"), None, None),
                             (("data", "model"), None))
    A, cand = cases.clique_inputs()
    got = cell.step_fn(A, cand)
    want = steps.build_cell(spec, "ep_tri_1m", None, reduced=True,
                            device="cpu").step_fn(A, cand)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


LM_ONE_RANK = [(a, s) for a in ("granite-3-8b", "deepseek-moe-16b")
               for s in ("train_4k", "prefill_32k", "decode_32k")]


def lm_args(cell, seed):
    """Seeded global arguments of an LM cell (integers in {0, 1}, floats
    ``|normal| x 0.02``, as ``tests/test_torch_cells.py``)."""
    rng = np.random.default_rng(seed)
    abstract = list(cell.abstract_args)
    leaves = tree_leaves(abstract)
    return tree_unflatten(abstract, [
        torch.from_numpy(rng.integers(0, 2, x.shape) if not
                         x.is_floating_point() else
                         np.abs(rng.normal(size=x.shape) * 0.02)).to(x.dtype)
        for x in leaves])


@pytest.mark.parametrize("arch,shape", LM_ONE_RANK,
                         ids=[f"{a}-{s}" for a, s in LM_ONE_RANK])
def test_one_rank_mesh_runs_the_lm_cells(one_rank_mesh, arch, shape):
    spec = configs.get(arch)
    cell = steps.build_cell(spec, shape, one_rank_mesh, reduced=True)
    plain = steps.build_cell(spec, shape, None, reduced=True, device="cpu")
    assert cell.in_specs is not None and plain.in_specs is None
    args = lm_args(plain, seed=len(arch) + len(shape))

    def clone():
        return tree_unflatten(args, [x.clone() for x in tree_leaves(args)])
    got = cell.step_fn(*spmd.shard_tree(clone(), cell.in_specs,
                                        one_rank_mesh))
    want = plain.step_fn(*clone())
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_skipped_cell_raises():
    spec = configs.get("granite-3-8b")
    skipped = [n for n, c in spec.cells.items() if c.skip]
    with pytest.raises(ValueError, match="is skipped"):
        steps.build_cell(spec, skipped[0], None, reduced=True, device="cpu")
