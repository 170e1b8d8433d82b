"""The port's NequIP held against the reference on the CPU.

The numpy spherical harmonics and Gaunt paths array-equal, the torch
spherical harmonics and Bessel basis, the forward (zero-length edges
masked), loss and grads, one step of the nequip cell against
``repro.launch.steps.build_cell(..., reduced=True).step_fn``, the
twins of the rotation and translation tests, and the launcher's crash
and resume.  Tolerances as in ``tests/test_torch_gnn.py``; the
symmetry tests keep the reference tests' own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import equivariant as jeqv
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.launch import train
from repro_torch.models import equivariant as eqv
from repro_torch.optim import tree_leaves
from test_torch_gnn import (FWD, GRAD, check_cell_step, close, close_trees,
                            one_thread, random_rotation, t, to_torch)  # noqa: F401

CFG = dict(n_layers=2, mult=8, n_rbf=4, cutoff=2.5, n_species=4)


def make_system(rng, N=10, E=30):
    """The reference tests' system: random edges, self loops included."""
    pos = rng.normal(size=(N, 3)).astype(np.float32)
    sp = np.eye(4, dtype=np.float32)[rng.integers(0, 4, N)]
    edges = rng.integers(0, N, (2, E)).astype(np.int32)
    mask = np.ones((E,), np.float32)
    gid = np.zeros((N,), np.int32)
    return pos, sp, edges, mask, gid


def pair(seed=0):
    jc, pc = jeqv.NequIPConfig(**CFG), eqv.NequIPConfig(**CFG)
    jp = jeqv.init_nequip(jax.random.PRNGKey(seed), jc)
    return jc, pc, jp, to_torch(jp)


def test_gaunt_paths_and_numpy_harmonics_equal_reference():
    mine, ref = eqv.gaunt_paths(2), jeqv.gaunt_paths(2)
    assert len(mine) == len(ref) == 11
    for (a1, a2, a3, ca), (b1, b2, b3, cb) in zip(mine, ref):
        assert (a1, a2, a3) == (b1, b2, b3)
        np.testing.assert_array_equal(ca, cb)
    v = np.random.default_rng(0).normal(size=(64, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for l in range(5):
        np.testing.assert_array_equal(eqv._sh_np(l, v), jeqv._sh_np(l, v))


def test_sh_and_bessel_match_reference():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for l in range(3):
        close(eqv.sh_torch(l, t(v)), jeqv.sh_jax(l, jnp.asarray(v)), **FWD)
    r = np.concatenate([[0.0, 1e-7], rng.random(30) * 6]).astype(np.float32)
    close(eqv.bessel_basis(t(r), 8, 5.0),
          jeqv.bessel_basis(jnp.asarray(r), 8, 5.0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("graph_level", [True, False])
def test_forward_matches_reference(graph_level):
    jc, pc, jp, pp = pair()
    pos, sp, edges, mask, gid = make_system(np.random.default_rng(2))
    assert (edges[0] == edges[1]).any()   # zero-length edges are masked
    gid[5:] = 1
    g, n = (gid, 2) if graph_level else (None, 1)
    want = jeqv.nequip_forward(jp, sp, jnp.asarray(pos), edges, mask, jc,
                               g, n)
    with torch.no_grad():
        got = eqv.nequip_forward(pp, t(sp), t(pos), t(edges), t(mask), pc,
                                 None if g is None else t(g), n)
    close(got, want, **FWD)


def test_loss_and_grads_match_reference():
    jc, pc, jp, pp = pair(1)
    pos, sp, edges, mask, gid = make_system(np.random.default_rng(3))

    def jloss(p):
        e = jeqv.nequip_forward(p, sp, jnp.asarray(pos), edges, mask, jc)
        return jnp.sum(e[:, 0] * jnp.arange(10.0))

    jl, jg = jax.value_and_grad(jloss)(jp)
    leaves = tree_leaves(pp)
    for p in leaves:
        p.requires_grad_(True)
    e = eqv.nequip_forward(pp, t(sp), t(pos), t(edges), t(mask), pc)
    pl = torch.sum(e[:, 0] * torch.arange(10.0))
    close(pl.detach(), jl, rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(pl, leaves, allow_unused=True)
    close_trees([torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)], jg, **GRAD)


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm"])
def test_cell_step_matches_reference(shape):
    check_cell_step("nequip", shape)


@pytest.mark.parametrize("seed", [0, 17, 123, 401])
def test_nequip_rotation_invariance(seed):
    rng = np.random.default_rng(seed)
    pos, sp, edges, mask, gid = make_system(rng)
    Q = random_rotation(rng).astype(np.float32)
    _, pc, _, pp = pair()
    with torch.no_grad():
        e1 = eqv.nequip_forward(pp, t(sp), t(pos), t(edges), t(mask), pc,
                                t(gid), 1)
        e2 = eqv.nequip_forward(pp, t(sp), t(pos @ Q.T), t(edges), t(mask),
                                pc, t(gid), 1)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=2e-3, atol=2e-3)


def test_nequip_translation_invariance():
    rng = np.random.default_rng(1)
    pos, sp, edges, mask, gid = make_system(rng)
    _, pc, _, pp = pair()
    with torch.no_grad():
        e1 = eqv.nequip_forward(pp, t(sp), t(pos), t(edges), t(mask), pc,
                                t(gid), 1)
        e2 = eqv.nequip_forward(pp, t(sp), t(pos + 3.7), t(edges), t(mask),
                                pc, t(gid), 1)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4, atol=1e-5)


def test_train_launcher_crash_then_resume_equals_uninterrupted(tmp_path):
    base = ["--arch", "nequip", "--shape", "molecule", "--steps", "4",
            "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert train.main(base + ["--ckpt-dir", a]) == 0
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        train.main(base + ["--ckpt-dir", b, "--ckpt-every", "2",
                           "--fail-at", "3"])
    assert train.main(base + ["--ckpt-dir", b, "--ckpt-every", "2"]) == 0
    want, got = restore_checkpoint(a), restore_checkpoint(b)
    assert want["step"] == got["step"] == 4
    for k, v in want["tree"].items():
        np.testing.assert_array_equal(got["tree"][k], v)
