"""The port's paper baseline held against the reference on the CPU.

``repro_torch.core.vbbkc`` (VBBkC: Degen, DDegCol, DDegCol+), its vertex
tiles, ``max_clique_size``, ``tau_delta_gap`` and the brute-force oracles
are the reference's host code copied unchanged, so every comparison is
exact (tolerance 0): counts and ``Stats`` fields are integers, tiles are
compared vertex for vertex, row for row and color for color.  The baseline
runs on the host in both packages, as in the paper.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.core import oracle as joracle
from repro.core import tiles as jtiles
from repro.core import truss as jtruss
from repro.core import vbbkc as jvbbkc
from repro.data import graphs as jgraphs
from repro_torch.core import ebbkc, oracle, tiles, vbbkc
from repro_torch.core.graph import max_clique_size
from repro_torch.core.truss import tau_delta_gap
from repro_torch.data import graphs

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("degen", "ddegcol", "ddegcol+")
STATS_FIELDS = ("branches", "pruned_size", "pruned_color", "peak_graph",
                "et_hits")

# (name, generator args): the same seeded graph from both packages
GRAPHS = {
    "er": ("erdos_renyi", (60, 0.4), dict(seed=1)),
    "planted": ("planted_cliques", (120, 3, 9), dict(p_noise=0.03, seed=2)),
    "rmat": ("rmat_graph", (8, 8), dict(seed=7)),
}


def both(name):
    fn, args, kw = GRAPHS[name]
    g = getattr(graphs, fn)(*args, **kw)
    jg = getattr(jgraphs, fn)(*args, **kw)
    np.testing.assert_array_equal(g.edges, jg.edges)
    return g, jg


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_vbbkc_counts_and_stats_equal_reference(name, variant):
    g, jg = both(name)
    for k in range(3, 8):
        got = vbbkc.count(g, k, variant=variant)
        want = jvbbkc.count(jg, k, variant=variant)
        assert got.count == want.count, (k, got.count, want.count)
        assert (got.tiles, got.max_tile) == (want.tiles, want.max_tile)
        for f in STATS_FIELDS:
            assert getattr(got.stats, f) == getattr(want.stats, f), (k, f)


@pytest.mark.parametrize("variant", VARIANTS)
def test_vbbkc_with_early_termination_equals_reference(variant):
    g, jg = both("planted")
    for k in (4, 6):
        got = vbbkc.count(g, k, variant=variant, et_t=3)
        want = jvbbkc.count(jg, k, variant=variant, et_t=3)
        assert got.count == want.count
        for f in STATS_FIELDS:
            assert getattr(got.stats, f) == getattr(want.stats, f), (k, f)


@pytest.mark.parametrize("k", (1, 2))
def test_vbbkc_small_k(k):
    g, jg = both("er")
    assert vbbkc.count(g, k).count == jvbbkc.count(jg, k).count


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_vbbkc_agrees_with_edge_engine(name):
    g, _ = both(name)
    for k in (4, 5):
        host = ebbkc.count(g, k, backend="host").count
        assert vbbkc.count(g, k, variant="ddegcol+").count == host


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("colored", (False, True))
def test_vertex_tiles_match_reference(name, colored):
    g, jg = both(name)
    for k in (3, 5):
        got = list(tiles.vertex_tiles(g, k, colored=colored))
        want = list(jtiles.vertex_tiles(jg, k, colored=colored))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.anchor == b.anchor
            np.testing.assert_array_equal(a.verts, b.verts)
            assert list(a.rows) == list(b.rows)
            assert a.nedges == b.nedges
            assert (None if a.colors is None else list(a.colors)) == (
                None if b.colors is None else list(b.colors))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_max_clique_size_and_tau_delta_gap_match_reference(name):
    g, jg = both(name)
    omega = max_clique_size(g)
    assert omega == jgraph.max_clique_size(jg)
    assert max_clique_size(g, ub=3) == jgraph.max_clique_size(jg, ub=3)
    tau, delta = tau_delta_gap(g)
    assert (tau, delta) == jtruss.tau_delta_gap(jg)
    assert tau < delta  # Lemma 4.1
    # omega-cliques exist, (omega + 1)-cliques do not
    assert vbbkc.count(g, omega).count > 0
    assert vbbkc.count(g, omega + 1).count == 0


@pytest.mark.parametrize("seed", range(4))
def test_brute_oracles_match_reference(seed):
    g = graphs.erdos_renyi(14, 0.5, seed=seed)
    jg = jgraphs.erdos_renyi(14, 0.5, seed=seed)
    for k in (1, 2, 3, 4, 5):
        rows = oracle.list_kcliques_brute(g, k)
        assert rows == joracle.list_kcliques_brute(jg, k)
        assert oracle.count_kcliques_brute(g, k) == len(rows)
        assert len(rows) == vbbkc.count(g, k).count


def test_nx_oracle_matches_reference():
    pytest.importorskip("networkx")
    g, jg = both("rmat")
    for k in (3, 4, 5):
        got = oracle.count_kcliques_nx(g, k)
        assert got == joracle.count_kcliques_nx(jg, k)
        assert got == vbbkc.count(g, k).count


def _run_example(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_quickstart_twin_runs_on_cpu():
    out = _run_example("quickstart_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "Lemma 4.1: tau < delta -> True" in out.stdout
    assert out.stdout.strip().splitlines()[-1].startswith(
        "device engine agrees: True")


def test_service_twin_runs_on_cpu():
    out = _run_example("clique_service_torch.py", "--device", "cpu",
                       "--snapshots", "2", "--k", "4")
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("served 6 requests"), out.stdout
    assert "deadline misses" in last


def test_examples_default_to_cuda_and_raise_without_it():
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = [sys.argv[1]]\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for script in ("quickstart_torch.py", "clique_service_torch.py"):
        out = subprocess.run(
            [sys.executable, "-c", code, str(ROOT / "examples" / script)],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert "CUDA" in out.stderr, out.stderr
