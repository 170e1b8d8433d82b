"""Port engine vs the JAX engine: ``count_packed`` outputs are array-equal,
and whole-graph counts equal ``engine_jax.count(..., backend="lax")`` and
the golden fixtures, on the CPU (``device="cpu"``).

Every comparison is exact (tolerance 0).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine_jax, pipeline as jpipe
from repro.data import graphs as jgraphs
from repro_torch.convert import batch_to_torch
from repro_torch.core import ebbkc, engine_torch
from repro_torch.core.graph import from_edges
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import ops
from repro_torch.launch import clique

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "golden_graphs.json")


def _golden():
    with open(_FIXTURE) as f:
        raw = json.load(f)
    return {name: (from_edges(spec["n"], np.asarray(spec["edges"], np.int64)),
                   {int(k): v for k, v in spec["counts"].items()})
            for name, spec in raw.items()}


GOLDEN = _golden()
KS = range(3, 9)


@pytest.fixture(scope="module")
def lax_counts():
    """engine_jax lax counts per (graph, k): one order is enough, the
    count does not depend on it."""
    return {(name, k): engine_jax.count(g, k, backend="lax").count
            for name, (g, _) in GOLDEN.items() for k in KS}


@pytest.mark.parametrize("name", sorted(GOLDEN))
@pytest.mark.parametrize("order", ["truss", "hybrid", "color"])
def test_count_matches_lax_and_golden(lax_counts, name, order):
    g, golden = GOLDEN[name]
    for k in KS:
        for et_route in (True, False):
            got = ebbkc.count(g, k, order=order, backend="torch",
                              device="cpu",
                              engine_kwargs={"et_route": et_route}).count
            assert got == lax_counts[(name, k)], (name, order, k, et_route)
            if k in golden:
                assert got == golden[k], (name, order, k)


@pytest.mark.parametrize("order", ["truss", "hybrid", "color"])
def test_spill_path_matches_lax(order):
    """bins=(32,) sends the 40-vertex planted tiles to the host recursion
    (count_rec_T for truss order, count_rec_C otherwise)."""
    jg = jgraphs.planted_cliques(140, 2, 40, p_noise=0.02, seed=3)
    tg = tgraphs.planted_cliques(140, 2, 40, p_noise=0.02, seed=3)
    for k in (4, 5):
        want = engine_jax.count(jg, k, order=order, backend="lax",
                                bins=(32,)).count
        res = engine_torch.count(tg, k, order=order, bins=(32,),
                                 device="cpu")
        assert res.count == want, (order, k)
        assert res.stats.spilled_tiles > 0
        assert len(res.stats.spill_sizes) == res.stats.spilled_tiles
        assert res.count == ebbkc.count(tg, k, order=order,
                                        backend="host").count


@pytest.mark.parametrize("l", [1, 2, 3, 4, 5, 6])
def test_count_packed_matches_jax(l):
    g = jgraphs.planted_cliques(120, 4, 11, p_noise=0.04, seed=9)
    batches = [b for b in jpipe.stream_batches(g, 3, batch_size=64)
               if hasattr(b, "A")]
    assert batches
    for b in batches:
        ref = engine_jax.count_packed(jnp.asarray(b.A), jnp.asarray(b.cand),
                                      l, backend="lax")
        got = engine_torch.count_packed(*batch_to_torch(b.A, b.cand, "cpu"),
                                        l)
        for r, t in zip(ref, got):
            np.testing.assert_array_equal(
                t.numpy().astype(np.int64), np.asarray(r).astype(np.int64))
        assert engine_torch.combine_counts(*got, l, True) == \
            engine_jax.combine_counts(*ref, l, True)


def test_plex_stats_and_closed_form_match_jax():
    g = jgraphs.erdos_renyi(60, 0.5, seed=4)
    b = next(x for x in jpipe.stream_batches(g, 4) if hasattr(x, "A"))
    ref = engine_jax.plex_stats(jnp.asarray(b.A), jnp.asarray(b.cand))
    got = engine_torch.plex_stats(*batch_to_torch(b.A, b.cand, "cpu"))
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    nv, t, f = (np.asarray(x) for x in ref)
    for l in (2, 3, 5):
        np.testing.assert_array_equal(
            engine_torch.count_2plex_closed_np(nv, f, l),
            engine_jax.count_2plex_closed_np(nv, f, l))


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = GOLDEN["karate"][0]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        engine_torch.count(g, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ebbkc.count(g, 4, backend="torch")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ebbkc.count(g, 4)  # the default backend is the device engine
    with pytest.raises(RuntimeError, match='device="cpu"'):
        clique.main(["--graph", "er:20,0.3", "--k", "4"])
    # the host engine, asked for by name, needs no device
    assert ebbkc.count(g, 4, backend="host").count == GOLDEN["karate"][1][4]


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        ebbkc.count(GOLDEN["karate"][0], 4, backend="jax")


def test_batch_to_torch_is_a_zero_copy_view():
    A = np.arange(2 * 32, dtype=np.uint32).reshape(2, 32, 1)
    A[0, 0, 0] = 0xFFFFFFFF
    cand = np.full((2, 1), 0x80000001, dtype=np.uint32)
    tA, tc = batch_to_torch(A, cand, "cpu")
    assert tA.dtype == torch.int32 and tc.dtype == torch.int32
    assert tA.data_ptr() == A.ctypes.data
    assert int(tA[0, 0, 0]) == -1 and int(tc[0, 0]) == -(1 << 31) + 1
    with pytest.raises(TypeError):
        batch_to_torch(A.astype(np.int64), cand, "cpu")


def test_engine_on_cpu_runs_no_kernel():
    ops.reset_counts()
    g = GOLDEN["karate"][0]
    assert engine_torch.count(g, 5, device="cpu").count == 2
    assert sum(ops.launch_counts().values()) == 0
    ops.reset_counts()


def test_cli_verifies_on_cpu(capsys):
    rc = clique.main(["--graph", "er:60,0.3", "--k", "5", "--device", "cpu",
                      "--verify"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "match=True" in out
    want = engine_jax.count(jgraphs.erdos_renyi(60, 0.3, seed=7), 5,
                            backend="lax").count
    assert f"k=5: {want} cliques" in out
