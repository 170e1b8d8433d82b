"""The port's DCN-v2 held against the reference on the CPU.

``embedding_bag`` (sum and mean, -1 padding), the forward, ``bce_loss``
and the grads (the table's with repeated rows), ``retrieval_scores`` on
planted ties (lower index first, as ``lax.top_k``), the train, serve and
retrieval cells against ``repro.launch.steps.build_cell(...,
reduced=True).step_fn``, and the launcher's crash and resume.
Tolerances as in ``tests/test_torch_gnn.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import RecsysPipeline as JPipeline
from repro.launch import steps as jsteps
from repro.models import recsys as jrec
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.launch import steps, train
from repro_torch.models import recsys as rec
from repro_torch.optim import adamw_init, tree_leaves
from test_torch_gnn import (FWD, GRAD, close, close_trees, drawn,  # noqa: F401
                            one_thread, t, to_torch)

SMALL = dict(n_dense=3, n_sparse=4, vocab=6, embed_dim=5, n_cross=2,
             mlp_dims=(8, 6), bag=3)


def pair(seed=0):
    jc, pc = jrec.DCNConfig(**SMALL), rec.DCNConfig(**SMALL)
    jp = jrec.init_dcn(jax.random.PRNGKey(seed), jc)
    return jc, pc, jp, to_torch(jp)


def inputs(seed=0, B=7):
    """Bags with -1 padding (one all padding), repeated rows."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(B, 3)).astype(np.float32)
    sparse = rng.integers(-1, 3, (B, 4, 3)).astype(np.int32)
    sparse[0, 0] = -1
    labels = (rng.random(B) < 0.5).astype(np.float32)
    return dense, sparse, labels


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(24, 5)).astype(np.float32)
    _, sparse, _ = inputs(2)
    offs = np.arange(4, dtype=np.int32) * 6
    want = jrec.embedding_bag(jnp.asarray(table), jnp.asarray(sparse),
                              jnp.asarray(offs), mode)
    got = rec.embedding_bag(t(table), t(sparse), t(offs), mode)
    close(got, want, **FWD)
    assert not got[0, 0].any()     # an all-padding bag is zero


def test_forward_loss_and_grads_match_reference():
    jc, pc, jp, pp = pair()
    dense, sparse, labels = inputs(3)
    jl, jg = jax.value_and_grad(lambda p: jrec.bce_loss(
        jrec.dcn_forward(p, jnp.asarray(dense), jnp.asarray(sparse), jc),
        jnp.asarray(labels)))(jp)
    with torch.no_grad():
        close(rec.dcn_forward(pp, t(dense), t(sparse), pc),
              jrec.dcn_forward(jp, jnp.asarray(dense), jnp.asarray(sparse),
                               jc), **FWD)
    leaves = tree_leaves(pp)
    for p in leaves:
        p.requires_grad_(True)
    pl = rec.bce_loss(rec.dcn_forward(pp, t(dense), t(sparse), pc),
                      t(labels))
    close(pl.detach(), jl, rtol=1e-5)
    grads = torch.autograd.grad(pl, leaves)
    close_trees(grads, jg, **GRAD)
    again = torch.autograd.grad(rec.bce_loss(
        rec.dcn_forward(pp, t(dense), t(sparse), pc), t(labels)), leaves)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_bce_loss_matches_reference_at_large_logits():
    logits = np.array([-80.0, -3.0, 0.0, 2.5, 90.0], np.float32)
    labels = np.array([1.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    close(rec.bce_loss(t(logits), t(labels)),
          jrec.bce_loss(jnp.asarray(logits), jnp.asarray(labels)), rtol=1e-6)


def test_retrieval_scores_break_ties_by_lower_index():
    """Candidates repeat rows, so scores tie: values and indices equal
    ``lax.top_k``'s."""
    jc, pc, jp, pp = pair(1)
    dense, sparse, _ = inputs(4, B=2)
    rng = np.random.default_rng(5)
    base = rng.normal(size=(5, 6)).astype(np.float32)
    cand = base[rng.integers(0, 5, 40)]
    jv, ji = jrec.retrieval_scores(jp, jnp.asarray(dense),
                                   jnp.asarray(sparse), jnp.asarray(cand),
                                   jc, topk=12)
    with torch.no_grad():
        pv, pi = rec.retrieval_scores(pp, t(dense), t(sparse), t(cand), pc,
                                      topk=12)
    close(pv, jv, **FWD)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    vals = pv.numpy()
    assert (vals[:, 1:] == vals[:, :-1]).any()       # ties were there


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def cells(shape):
    jcell = jsteps.build_cell(jconfigs.get("dcn-v2"), shape, None,
                              reduced=True)
    spec = configs.get("dcn-v2")
    mc = steps.recsys_cell(spec, spec.cells[shape], reduced=True)
    assert mc.meta == jcell.meta
    return jcell, mc


def test_train_cell_step_matches_reference():
    jcell, mc = cells("train_batch")
    jp = jax.tree.map(jnp.asarray, drawn(jcell.abstract_args[0], 6))
    jo = jadamw.adamw_init(jp)
    pp = to_torch(jp)
    po = adamw_init(pp)
    jpipe = JPipeline(vocab=1000, batch=16, seed=2)
    jstep = jax.jit(jcell.step_fn)
    lr_sum = 0.0
    for _ in range(2):
        jb = jpipe.next_batch()
        jp, jo, jm = jstep(jp, jo, jb)
        pp, po, pm = mc.step_fn(pp, po, jb)
        close(pm["loss"], jm["loss"], rtol=1e-5)
        close(pm["grad_norm"], jm["grad_norm"], rtol=1e-5)
        lr_sum += float(jm["lr"])
        for k in ("mu", "nu"):
            close_trees(po[k], jo[k], **GRAD)
    close_trees(pp, jp, rtol=0, atol=2 * lr_sum)


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_serve_and_retrieval_cells_match_reference(shape):
    jcell, mc = cells(shape)
    jp = jax.tree.map(jnp.asarray, drawn(jcell.abstract_args[0], 7))
    pp = to_torch(jp)
    rng = np.random.default_rng(8)
    args = []
    for k, (s, d) in mc.batch_shapes.items():
        if k == "sparse":
            args.append(rng.integers(0, 1000, s).astype(d))
        else:
            args.append(rng.normal(size=s).astype(d))
    want = jcell.step_fn(jp, *args)
    got = mc.step_fn(pp, *args)
    if shape == "serve_p99":
        close(got, want, **FWD)
    else:
        close(got[0], want[0], **FWD)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert mc.meta["n_candidates"] == 4096


def test_train_launcher_crash_then_resume_equals_uninterrupted(tmp_path):
    base = ["--arch", "dcn-v2", "--steps", "5", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert train.main(base + ["--ckpt-dir", a]) == 0
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        train.main(base + ["--ckpt-dir", b, "--ckpt-every", "2",
                           "--fail-at", "3"])
    assert train.main(base + ["--ckpt-dir", b, "--ckpt-every", "2"]) == 0
    want, got = restore_checkpoint(a), restore_checkpoint(b)
    assert want["step"] == got["step"] == 5
    assert want["pipeline"] == got["pipeline"]
    for k, v in want["tree"].items():
        np.testing.assert_array_equal(got["tree"][k], v)
