"""The port's GNN and recsys data held against the reference's on the
CPU: ``GraphBatcher``, ``NeighborSampler`` / ``sampled_block_shapes``,
``RecsysPipeline`` and the launcher's GNN batches (the reference
launcher's ``_GnnPipe``), each byte-identical for a seed and resumable
from its state."""
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.data import GraphBatcher as JGraphBatcher
from repro.data import NeighborSampler as JNeighborSampler
from repro.data import RecsysPipeline as JRecsysPipeline
from repro.data.sampler import sampled_block_shapes as j_block_shapes
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro_torch import configs
from repro_torch.data import (GraphBatcher, NeighborSampler, RecsysPipeline,
                              erdos_renyi, sampled_block_shapes)
from repro_torch.launch import steps, train
from test_torch_gnn import one_thread  # noqa: F401


def assert_same(a, b):
    """Nested dicts / lists of arrays, equal in dtype and bytes."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def check_resumable(make, n=3, at=2):
    """``make()`` pipelines: n batches equal; a pipeline restored from
    the state after ``at`` batches replays the rest."""
    p = make()
    batches = [p.next_batch() for _ in range(n)]
    q = make()
    for _ in range(at):
        q.next_batch()
    r = make()
    r.restore(q.state())
    for b in batches[at:]:
        assert_same(r.next_batch(), b)
    return batches


@pytest.mark.parametrize("kw", [dict(batch=4, seed=5),
                                dict(n_nodes=7, n_edges=9, batch=3,
                                     d_feat=2, seed=11)])
def test_graph_batcher_byte_identical_and_resumable(kw):
    mine = check_resumable(lambda: GraphBatcher(**kw))
    ref = JGraphBatcher(**kw)
    for b in mine:
        assert_same(b, ref.next_batch())


def test_neighbor_sampler_byte_identical_and_resumable():
    g = erdos_renyi(200, 0.1, seed=3)
    mine = check_resumable(
        lambda: NeighborSampler(g, batch_nodes=16, fanouts=(5, 3), seed=1))
    from repro.data import erdos_renyi as jer
    ref = JNeighborSampler(jer(200, 0.1, seed=3), batch_nodes=16,
                           fanouts=(5, 3), seed=1)
    for b in mine:
        assert_same(b, ref.next_batch())
    assert sampled_block_shapes(1024, (15, 10), 602) == \
        j_block_shapes(1024, (15, 10), 602)


@pytest.mark.parametrize("kw", [dict(batch=64, vocab=50, seed=1),
                                dict(batch=9, vocab=1000, bag=3, seed=4)])
def test_recsys_pipeline_byte_identical_and_resumable(kw):
    mine = check_resumable(lambda: RecsysPipeline(**kw))
    ref = JRecsysPipeline(**kw)
    for b in mine:
        assert_same(b, ref.next_batch())
    assert 0.05 < mine[0]["labels"].mean() < 0.95


@pytest.mark.parametrize("arch,shape", [
    ("gin-tu", "full_graph_sm"), ("meshgraphnet", "minibatch_lg"),
    ("egnn", "molecule"), ("nequip", "molecule")])
def test_gnn_launcher_batches_byte_identical_and_resumable(arch, shape):
    """The launcher's pipeline walks the cell's inputs in the reference's
    order and draws edge_mask before setting it to ones, so later inputs
    see the same generator state."""
    spec = configs.get(arch)
    mc = steps.gnn_train_cell(spec, spec.cells[shape], reduced=True)
    mine = check_resumable(
        lambda: train.GnnPipeline(mc.batch_shapes, mc.meta["n_nodes"]))
    jspec = jconfigs.get(arch)
    jcell = jsteps.build_cell(jspec, shape, None, reduced=True)
    ref = jtrain.make_pipeline(jspec, jspec.cells[shape], jcell, True)
    for b in mine:
        assert_same(b, ref.next_batch())
    assert (mine[0]["edge_mask"] == 1).all()
