"""The benchmark's plain reference against closed forms and brute force."""
from __future__ import annotations

import itertools
import math

import numpy as np
import pytest
import torch

from bench import control, graph500, harness
from bench.reference import kclique


def _complete(n: int) -> np.ndarray:
    return np.array(list(itertools.combinations(range(n), 2)), dtype=np.int64)


def _brute_rows(n: int, edges: np.ndarray, k: int) -> list:
    adj = [set() for _ in range(n)]
    for u, v in edges.tolist():
        adj[u].add(v)
        adj[v].add(u)
    out = []

    def rec(clique, cands, r):
        if r == 0:
            out.append(tuple(clique))
            return
        for v in sorted(w for w in cands if w > clique[-1]):
            rec(clique + [v], cands & adj[v], r - 1)

    for v in range(n):
        rec([v], adj[v], k - 1)
    return sorted(out)


SMALL = {"generator": "graph500-kronecker", "scale": 7, "edge_factor": 16,
         "initiator": [0.57, 0.19, 0.19, 0.05], "kronecker_seed": 7}


@pytest.mark.parametrize("n,k", [(5, 3), (12, 4), (20, 5), (33, 6), (24, 7),
                                 (65, 3), (129, 4)])
def test_complete_graph_counts_are_binomials(n, k):
    # 65 and 129 vertices put out-degrees across a 64-bit word boundary
    assert kclique.count_kcliques(n, _complete(n), k, budget=1000) \
        == math.comb(n, k)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_bipartite_graph_has_no_cliques_above_two(k):
    a, b = np.meshgrid(np.arange(30), np.arange(30, 70))
    edges = kclique.canonical_edges(70, np.stack([a.ravel(), b.ravel()], 1))
    assert kclique.count_kcliques(70, edges, k) == 0
    assert kclique.count_kcliques(70, edges, 2) == 30 * 40


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangles_are_a_sixth_of_the_trace_of_a_cubed(seed):
    rng = np.random.default_rng(seed)
    n = 90
    pairs = rng.integers(0, n, size=(900, 2))
    edges = kclique.canonical_edges(n, pairs)
    A = np.zeros((n, n), dtype=np.int64)
    A[edges[:, 0], edges[:, 1]] = A[edges[:, 1], edges[:, 0]] = 1
    assert kclique.count_kcliques(n, edges, 3) == np.trace(A @ A @ A) // 6


@pytest.mark.parametrize("k", [3, 4, 5, 6])
def test_kronecker_counts_and_rows_match_brute_force(k):
    n, edges = graph500.graph_for(SMALL, 2**31 + 5)
    want = _brute_rows(n, edges, k)
    assert kclique.count_kcliques(n, edges, k, budget=257) == len(want)
    rows = kclique.list_kcliques(n, edges, k, budget=257)
    assert sorted(map(tuple, rows.tolist())) == want


def test_labels_permute_but_the_count_stays():
    counts = {kclique.count_kcliques(*graph500.graph_for(SMALL, s), 5)
              for s in (1, 2**31 + 3, 2**33)}
    assert len(counts) == 1


def test_check_rows_finds_each_fault():
    n, edges = graph500.graph_for(SMALL, 11)
    keys = kclique.edge_keys(n, edges, "cpu")
    rows = kclique.list_kcliques(n, edges, 4)
    assert kclique.check_rows(n, keys, rows, block=7) == {
        "rows": len(rows), "invalid": 0, "duplicates": 0}
    bad = rows.copy()
    bad[0, 1] = bad[0, 0]  # not increasing
    bad[1, 3] = n  # out of range
    present = set(map(tuple, edges.tolist()))
    bad[2, 3] = next(x for x in range(bad[2, 2] + 1, n)
                     if (bad[2, 0], x) not in present)  # not a clique
    assert kclique.check_rows(n, keys, bad)["invalid"] == 3
    dup = np.concatenate([rows, rows[5:8]])
    assert kclique.check_rows(n, keys, dup)["duplicates"] == 3


def test_float32_control_loses_the_exact_count():
    # C(200, 4) = 64,684,950: past 2**24 float32 spaces its values 4 apart,
    # so a running float32 sum of the partial counts drifts off the integer
    edges = _complete(200)
    assert kclique.count_kcliques(200, edges, 4, budget=1000) \
        == math.comb(200, 4)
    assert kclique.count_kcliques(200, edges, 4, accumulate="float32",
                                  budget=1000) != math.comb(200, 4)


def test_list_control_is_not_correct(monkeypatch):
    monkeypatch.setattr(control, "CONTROL_CAP", 3)
    got = control.control_checks("s13-list-k5", 2**31 + 9, "cpu",
                                 config=dict(SMALL, scale=8))
    assert not got["correct"] and got["checks"]["rows_gap"] > 0


def test_count_control_is_not_correct():
    # the count cells' control on a graph whose count lies past 2**24
    q = harness.Query(0.0, count=kclique.count_kcliques(
        200, _complete(200), 4, accumulate="float32", budget=1000))
    checks, failed = harness.verdict({"query": "count", "k": 4}, 200,
                                     _complete(200), [q], "cpu")
    assert not harness.passed(checks) and failed == 1


def test_popcount_matches_python():
    rng = np.random.default_rng(3)
    x = rng.integers(-2**63, 2**63 - 1, size=(500, 3), dtype=np.int64)
    want = [sum(bin(int(v) & (2**64 - 1)).count("1") for v in row) for row in x]
    assert kclique.popcount(torch.as_tensor(x)).tolist() == want
