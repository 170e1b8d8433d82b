"""The port's on-device truss decomposition held against the reference.

``repro_torch.core.truss_torch.truss_decomposition_torch`` (round-based
peeling in torch ops, run here with ``device="cpu"``) against the
reference's ``truss_jax`` and the port's host peeler, on the graphs and
seeds of ``tests/test_truss_jax.py``.  Trussness and tau are integers, so
every comparison is exact (tolerance 0).  The card runs it in
``test_torch_gpu.py`` and ``chip_smoke.py [truss]``.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core.truss import truss_decomposition as jtruss_decomposition
from repro.core.truss_jax import truss_decomposition_jax
from repro.data import powerlaw_graph as jpowerlaw_graph
from repro_torch.core.graph import from_edges
from repro_torch.core.truss import truss_decomposition
from repro_torch.core import truss_torch
from repro_torch.core.truss_torch import truss_decomposition_torch
from repro_torch.data import powerlaw_graph, rmat_graph

from conftest import random_graph


def port_graph(jg):
    return from_edges(jg.n, jg.edges)


@given(st.integers(0, 2000))
@settings(max_examples=15, deadline=None)
def test_torch_truss_matches_jax_and_host(seed):
    rng = np.random.default_rng(seed)
    jg = random_graph(rng, n_lo=5, n_hi=24)
    if jg.m == 0:
        return
    g = port_graph(jg)
    truss_t, tau_t = truss_decomposition_torch(g, device="cpu")
    truss_j, tau_j = truss_decomposition_jax(jg)
    td = truss_decomposition(g)
    assert tau_t == tau_j == td.tau
    np.testing.assert_array_equal(truss_t, np.asarray(truss_j))
    np.testing.assert_array_equal(truss_t, td.trussness)
    assert truss_t.dtype == np.int64


def test_torch_truss_medium_graph():
    g = powerlaw_graph(400, 8, seed=2)
    jg = jpowerlaw_graph(400, 8, seed=2)
    truss_t, tau_t = truss_decomposition_torch(g, device="cpu")
    truss_j, tau_j = truss_decomposition_jax(jg)
    assert tau_t == tau_j == jtruss_decomposition(jg).tau
    np.testing.assert_array_equal(truss_t, truss_j)
    np.testing.assert_array_equal(truss_t, truss_decomposition(g).trussness)


@pytest.mark.parametrize("chunk_bytes", [1, 256 * 100, 1 << 30])
def test_torch_truss_chunked_support_is_unchanged(monkeypatch, chunk_bytes):
    """Support computed in chunks of edges (one edge a chunk up to all of
    them) gives the same trussness."""
    monkeypatch.setattr(truss_torch, "SUPPORT_CHUNK_BYTES", chunk_bytes)
    g = rmat_graph(8, 8, seed=7)
    truss_t, tau_t = truss_decomposition_torch(g, device="cpu")
    td = truss_decomposition(g)
    assert tau_t == td.tau
    np.testing.assert_array_equal(truss_t, td.trussness)


def test_torch_truss_empty_graph():
    g = from_edges(5, np.zeros((0, 2), np.int64))
    truss_t, tau_t = truss_decomposition_torch(g, device="cpu")
    assert truss_t.shape == (0,) and tau_t == 0

