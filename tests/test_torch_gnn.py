"""The port's GNN family (GIN, MeshGraphNet, EGNN) held against the
reference on the CPU.

The scatters (out-of-range and negative ids dropped, empty segments 0
for a sum and -inf for a max), the fixed-order gather and propagate,
each forward, loss and grads, one step of each arch's cell against
``repro.launch.steps.build_cell(..., reduced=True).step_fn``, EGNN's
equivariance, the example twin and the launcher's crash and resume.
The reference's params cross over through ``repro_torch.convert``.

Tolerances (f32 on both sides): forwards rtol 1e-5 / atol 1e-6 (the
port adds each segment in edge order after a stable sort by dst, the
reference in edge order); grads rtol 1e-4 / atol 1e-5 (PR 20's
``GRAD``); a cell's step: loss and grad norm rtol 1e-5, moments within
``GRAD``, params within atol 2 x the summed lr (Adam moves a param by
about lr whatever its grad's size, so a grad near 0 may step the other
way).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import gnn as jgnn
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.convert import params_to_torch
from repro_torch.launch import steps, train
from repro_torch.models import gnn
from repro_torch.models.scatter import (edge_index, gather_rows, propagate,
                                        segments)
from repro_torch.optim import adamw_init, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread: the models here are small, and
    the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def close_trees(got, want, **tol):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        close(a.detach(), b, **tol)


def to_torch(tree):
    return params_to_torch(jax.tree.map(np.asarray, tree), "cpu")


def t(x):
    return torch.from_numpy(np.asarray(x))


def small_graph(seed=0, N=12, E=40, d=5):
    """Random edges (self loops and repeats included), a mask with
    zeros, node features and positions."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, N, (2, E)).astype(np.int32)
    mask = (rng.random(E) < 0.8).astype(np.float32)
    nodes = rng.normal(size=(N, d)).astype(np.float32)
    pos = rng.normal(size=(N, 3)).astype(np.float32)
    return edges, mask, nodes, pos


# ---------------------------------------------------------------------------
# scatter, gather, propagate
# ---------------------------------------------------------------------------

SCATTERS = {"sum": (gnn.scatter_sum, jgnn.scatter_sum),
            "mean": (gnn.scatter_mean, jgnn.scatter_mean),
            "max": (gnn.scatter_max, jgnn.scatter_max)}


@pytest.mark.parametrize("op", sorted(SCATTERS))
def test_scatters_match_reference(op):
    """Ids 9 and -1 lie outside [0, 6) and drop; segments 2 and 5 are
    empty (0 for sum and mean, -inf for max); grads of sum and mean."""
    mine, ref = SCATTERS[op]
    rng = np.random.default_rng(1)
    msg = rng.normal(size=(9, 3)).astype(np.float32)
    ids = np.array([0, 9, 1, 3, 0, -1, 4, 3, 1], np.int32)
    want = np.asarray(ref(jnp.asarray(msg), jnp.asarray(ids), 6))
    got = mine(t(msg), t(ids), 6)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    close(got, want, **FWD)
    if op == "max":
        assert np.isneginf(got.numpy()[[2, 5]]).all()
        return
    w = rng.normal(size=(6, 3)).astype(np.float32)
    jg = jax.grad(lambda m: jnp.sum(ref(m, jnp.asarray(ids), 6) * w))(
        jnp.asarray(msg))
    x = t(msg).requires_grad_(True)
    (g,) = torch.autograd.grad((mine(x, t(ids), 6) * t(w)).sum(), [x])
    close(g, jg, **GRAD)
    assert not g[[1, 5]].any()


def test_gather_rows_grad_sums_repeated_rows_in_order():
    """``gather_rows``'s grad equals ``x[idx]``'s (repeated and unused
    rows) and is the same tensor every run."""
    rng = np.random.default_rng(2)
    x = t(rng.normal(size=(7, 4)).astype(np.float32)).requires_grad_(True)
    idx = t(np.array([3, 0, 3, 6, 3, 0, 1], np.int64))
    w = t(rng.normal(size=(7, 4)).astype(np.float32))
    (want,) = torch.autograd.grad((x[idx] * w).sum(), [x])
    got = [torch.autograd.grad((gather_rows(x, idx) * w).sum(), [x])[0]
           for _ in range(2)]
    close(got[0], want, rtol=1e-6, atol=1e-7)
    assert torch.equal(got[0], got[1]) and not got[0][[2, 4, 5]].any()
    seg = segments(idx, 7)
    assert torch.equal(gather_rows(x, idx, seg), x[idx])


def test_propagate_and_its_grad_match_plain_sum():
    edges, mask, nodes, _ = small_graph(3)
    ei = edge_index(t(edges), 12)
    w = t(mask).index_select(0, ei.perm)
    h = t(nodes).requires_grad_(True)
    got = propagate(h, w, ei)
    want = torch.zeros_like(h.detach()).index_add(
        0, t(edges[1]).long(), h[t(edges[0]).long()] * t(mask)[:, None])
    close(got.detach(), want.detach(), **FWD)
    g = t(np.random.default_rng(4).normal(size=(12, 5)).astype(np.float32))
    (gg,) = torch.autograd.grad((got * g).sum(), [h])
    (gw,) = torch.autograd.grad((want * g).sum(), [h])
    close(gg, gw, **FWD)
    with torch.no_grad():
        assert torch.equal(propagate(h, w, ei), got.detach())


def test_edge_index_sorts_by_dst_and_rejects_out_of_range_ids():
    edges, *_ = small_graph(5)
    ei = edge_index(t(edges), 12)
    assert torch.equal(ei.dst, torch.sort(t(edges[1]).long(),
                                          stable=True).values)
    assert torch.equal(ei.src, t(edges[0]).long()[ei.perm])
    assert torch.equal(ei.by_dst.counts(),
                       torch.bincount(t(edges[1]).long(), minlength=12))
    bad = edges.copy()
    bad[0, 3] = 12
    with pytest.raises(ValueError, match=r"\[0, 12\)"):
        edge_index(t(bad), 12)


# ---------------------------------------------------------------------------
# forwards, losses and grads
# ---------------------------------------------------------------------------

def model_pair(name, seed=0):
    """(reference cfg, port cfg, reference params, port params,
    reference forward, port forward) at a small width; each forward
    takes (params, edges, mask, nodes, pos, gids)."""
    key = jax.random.PRNGKey(seed)
    if name.startswith("gin"):
        kw = dict(n_layers=2, d_hidden=8, d_in=5, n_classes=3,
                  graph_level=name == "gin-graph")
        jc, pc = jgnn.GINConfig(**kw), gnn.GINConfig(**kw)
        jp = jgnn.init_gin(key, jc)

        def jf(p, e, m, x, pos, gid):
            return jgnn.gin_forward(p, x, e, m, jc, gid, 3)

        def pf(p, e, m, x, pos, gid):
            return gnn.gin_forward(p, x, e, m, pc, gid, 3)
    elif name == "mgn":
        kw = dict(n_layers=2, d_hidden=8, d_node_in=5, d_edge_in=4,
                  d_out=3)
        jc, pc = jgnn.MGNConfig(**kw), gnn.MGNConfig(**kw)
        jp = jgnn.init_mgn(key, jc)

        def feats(e):
            n = e.shape[1]
            return np.cos(np.arange(n * 4, dtype=np.float32)).reshape(n, 4)

        def jf(p, e, m, x, pos, gid):
            return jgnn.mgn_forward(p, x, feats(e), e, m, jc)

        def pf(p, e, m, x, pos, gid):
            return gnn.mgn_forward(p, x, t(feats(e)), e, m, pc)
    else:
        kw = dict(n_layers=2, d_hidden=8, d_in=5, d_out=2)
        jc, pc = jgnn.EGNNConfig(**kw), gnn.EGNNConfig(**kw)
        jp = jgnn.init_egnn(key, jc)

        def jf(p, e, m, x, pos, gid):
            out, xs = jgnn.egnn_forward(p, x, pos, e, m, jc, gid, 3)
            return jnp.concatenate([out.reshape(-1), xs.reshape(-1)])

        def pf(p, e, m, x, pos, gid):
            out, xs = gnn.egnn_forward(p, x, pos, e, m, pc, gid, 3)
            return torch.cat([out.reshape(-1), xs.reshape(-1)])
    return jc, pc, jp, to_torch(jp), jf, pf


def graph_inputs(seed=0):
    edges, mask, nodes, pos = small_graph(seed)
    gid = np.array([0, 0, 1, 1, 1, 2, 2, 2, 2, 5, 0, 1], np.int32)
    return edges, mask, nodes, pos, gid


MODELS = ["gin", "gin-graph", "mgn", "egnn"]


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_reference(name):
    _, _, jp, pp, jf, pf = model_pair(name)
    e, m, x, pos, gid = graph_inputs(1)
    want = jf(jp, *(jnp.asarray(a) for a in (e, m, x, pos, gid)))
    with torch.no_grad():
        got = pf(pp, *(t(a) for a in (e, m, x, pos, gid)))
    close(got, want, **FWD)


@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_reference(name):
    """A weighted sum of the outputs: its value and every param's grad,
    through the checkpointed layers."""
    _, _, jp, pp, jf, pf = model_pair(name, seed=1)
    e, m, x, pos, gid = graph_inputs(2)
    jargs = [jnp.asarray(a) for a in (e, m, x, pos, gid)]
    n = jf(jp, *jargs).size
    w = np.sin(np.arange(n, dtype=np.float32))
    jl, jg = jax.value_and_grad(
        lambda p: jnp.sum(jf(p, *jargs).reshape(-1) * w))(jp)
    leaves = tree_leaves(pp)
    for p in leaves:
        p.requires_grad_(True)
    pl = (pf(pp, *(t(a) for a in (e, m, x, pos, gid))).reshape(-1)
          * t(w)).sum()
    close(pl.detach(), jl, rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(pl, leaves, allow_unused=True)
    close_trees([torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)], jg, **GRAD)


def test_one_hot_nll_counts_out_of_range_labels_as_zero_rows():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    labels = np.array([0, 3, 4, 9, -1, 2], np.int32)
    oh = jax.nn.one_hot(jnp.asarray(labels), 4)
    want = -(oh * jax.nn.log_softmax(jnp.asarray(logits))).sum(-1).mean()
    x = t(logits).requires_grad_(True)
    got = steps.one_hot_nll(x, t(labels), 4)
    close(got.detach(), want, rtol=1e-6)
    jg = jax.grad(lambda l: -(oh * jax.nn.log_softmax(l)).sum(-1).mean())(
        jnp.asarray(logits))
    close(torch.autograd.grad(got, [x])[0], jg, rtol=1e-5, atol=1e-7)


def test_egnn_grads_finite_at_zero_length_edges():
    """Four layers and a self loop: the reference's grads are NaN (the
    slope of its ``sqrt(d2)`` at 0 times 0), the port's coordinate step
    gives the same forward and finite grads; without the self loop the
    grads equal the reference's."""
    kw = dict(n_layers=4, d_hidden=8, d_in=3, d_out=1)
    jc, pc = jgnn.EGNNConfig(**kw), gnn.EGNNConfig(**kw)
    jp = jgnn.init_egnn(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    h0 = rng.normal(size=(5, 3)).astype(np.float32)
    x0 = rng.normal(size=(5, 3)).astype(np.float32)
    mask = np.ones(4, np.float32)
    for edges, loop in ((np.array([[0, 1, 2, 3], [1, 1, 3, 0]]), True),
                        (np.array([[0, 4, 2, 3], [1, 1, 3, 0]]), False)):
        edges = edges.astype(np.int32)

        def jloss(p):
            return jgnn.egnn_forward(p, h0, x0, edges, mask, jc)[0].sum()

        jl, jg = jax.value_and_grad(jloss)(jp)
        pp = to_torch(jp)
        leaves = tree_leaves(pp)
        for p in leaves:
            p.requires_grad_(True)
        pl = gnn.egnn_forward(pp, t(h0), t(x0), t(edges), t(mask),
                              pc)[0].sum()
        close(pl.detach(), jl, **FWD)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            leaves, torch.autograd.grad(pl, leaves, allow_unused=True))]
        assert all(torch.isfinite(g).all() for g in grads)
        nan = any(bool(jnp.isnan(g).any()) for g in jax.tree.leaves(jg))
        assert nan == loop
        if not loop:
            close_trees(grads, jg, **GRAD)


# ---------------------------------------------------------------------------
# the cells' steps
# ---------------------------------------------------------------------------

def drawn(tree_abs, seed):
    """Numpy params of the reference's abstract tree, normal x 0.1."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * 0.1).astype(s.dtype),
        tree_abs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))


def check_cell_step(arch, shape, n_steps=2):
    """``n_steps`` of the port's cell against the reference's on the
    same params and the port's GnnPipeline batches."""
    jcell = jsteps.build_cell(jconfigs.get(arch), shape, None, reduced=True)
    spec = configs.get(arch)
    mc = steps.gnn_train_cell(spec, spec.cells[shape], reduced=True)
    assert mc.meta["n_nodes"] == jcell.meta["n_nodes"]
    assert mc.meta["n_edges"] == jcell.meta["n_edges"]
    assert {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in
            jcell.abstract_args[2].items()} == {
        k: (s, np.dtype(d)) for k, (s, d) in mc.batch_shapes.items()}
    jp = jax.tree.map(jnp.asarray, drawn(jcell.abstract_args[0], 5))
    jo = jadamw.adamw_init(jp)
    pp = to_torch(jp)
    po = adamw_init(pp)
    pipe = train.GnnPipeline(mc.batch_shapes, mc.meta["n_nodes"])
    jstep = jax.jit(jcell.step_fn)
    lr_sum = 0.0
    for _ in range(n_steps):
        batch = pipe.next_batch()
        jp, jo, jm = jstep(jp, jo, batch)
        pp, po, pm = mc.step_fn(pp, po, batch)
        close(pm["loss"], jm["loss"], rtol=1e-5, atol=1e-7)
        close(pm["grad_norm"], jm["grad_norm"], rtol=1e-5, atol=1e-7)
        lr_sum += float(jm["lr"])
        for k in ("mu", "nu"):
            close_trees(po[k], jo[k], **GRAD)
    close_trees(pp, jp, rtol=0, atol=2 * lr_sum)
    return pm


@pytest.mark.parametrize("arch,shape", [
    ("gin-tu", "full_graph_sm"), ("gin-tu", "molecule"),
    ("meshgraphnet", "full_graph_sm"), ("egnn", "molecule")])
def test_cell_step_matches_reference(arch, shape):
    pm = check_cell_step(arch, shape)
    assert float(pm["grad_norm"]) > 0


# ---------------------------------------------------------------------------
# equivariance (the twins of tests/test_equivariance.py)
# ---------------------------------------------------------------------------

def random_rotation(rng):
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


@pytest.mark.parametrize("seed", [0, 17, 123, 401])
def test_egnn_equivariance(seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(10, 3)).astype(np.float32)
    edges = t(rng.integers(0, 10, (2, 30)).astype(np.int32))
    mask, gid = torch.ones(30), torch.zeros(10, dtype=torch.int32)
    h0 = t(rng.normal(size=(10, 6)).astype(np.float32))
    cfg = gnn.EGNNConfig(n_layers=2, d_hidden=16, d_in=6, d_out=1)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = gnn.init_egnn(gen, cfg, "cpu")
    Q = random_rotation(rng).astype(np.float32)
    with torch.no_grad():
        o1, x1 = gnn.egnn_forward(params, h0, t(pos), edges, mask, cfg,
                                  gid, 1)
        o2, x2 = gnn.egnn_forward(params, h0, t(pos @ Q.T), edges, mask,
                                  cfg, gid, 1)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(x1.numpy() @ Q.T, x2.numpy(), rtol=1e-3,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the launcher and the example twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gin-tu", "meshgraphnet", "egnn"])
def test_train_launcher_crash_then_resume_equals_uninterrupted(arch,
                                                               tmp_path):
    base = ["--arch", arch, "--steps", "5", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert train.main(base + ["--ckpt-dir", a]) == 0
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        train.main(base + ["--ckpt-dir", b, "--ckpt-every", "2",
                           "--fail-at", "3"])
    assert restore_checkpoint(b)["step"] == 2
    assert train.main(base + ["--ckpt-dir", b, "--ckpt-every", "2"]) == 0
    want, got = restore_checkpoint(a), restore_checkpoint(b)
    assert want["step"] == got["step"] == 5
    assert want["pipeline"] == got["pipeline"] == {"step": 5}
    assert set(want["tree"]) == set(got["tree"])
    for k, v in want["tree"].items():
        np.testing.assert_array_equal(got["tree"][k], v)


def test_drawn_params_follow_the_reference_rule():
    """Every float leaf normal x 0.02 on the reference's tree shapes."""
    for arch in ("gin-tu", "meshgraphnet", "egnn", "nequip"):
        spec = configs.get(arch)
        shape = next(iter(spec.cells))
        mc = steps.gnn_train_cell(spec, spec.cells[shape], reduced=True)
        gen = torch.Generator()
        gen.manual_seed(1)
        got = train.drawn_params(mc.init, gen, "cpu")
        jcell = jsteps.build_cell(jconfigs.get(arch), shape, None,
                                  reduced=True)
        want = jax.tree.leaves(jcell.abstract_args[0])
        leaves = tree_leaves(got)
        assert [tuple(x.shape) for x in leaves] == [w.shape for w in want]
        flat = torch.cat([x.reshape(-1) for x in leaves])
        assert abs(float(flat.std()) - 0.02) < 0.002


def load_twin():
    spec = importlib.util.spec_from_file_location(
        "gnn_clique_features_torch",
        ROOT / "examples" / "gnn_clique_features_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gnn_example_twin_runs_on_cpu(capsys):
    """The twin reaches the reference's accuracy bar; its clique
    features (the list kernel's plain version) equal the host
    recursion's."""
    from repro_torch.data import planted_cliques
    mod = load_twin()
    out = mod.main(["--device", "cpu", "--steps", "120"])
    assert out["acc"] > 0.9
    g = planted_cliques(300, 6, 9, p_noise=0.02, seed=3)
    np.testing.assert_array_equal(
        out["features"], mod.clique_features(g, backend="host"))
    assert out["labels"].sum() > 0
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "final accuracy: ")


def test_gnn_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("gin-tu", "dcn-v2"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", arch, "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_twin().main(["--steps", "1"])

