"""The harness on the CPU: files found by name, the result line's shape,
and the verdict failing runs whose timed path is broken underneath.

The runs here skip the harness's look for a chip: they drive
``harness.run_cell`` with CPU lanes (the program's plain versions) on a
small Graph500 graph in place of the cell's configuration.
"""
from __future__ import annotations

import json
import re

import numpy as np
import pytest

from bench import harness

SPEC = harness.load_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
TINY = {"generator": "graph500-kronecker", "scale": 8, "edge_factor": 16,
        "initiator": [0.57, 0.19, 0.19, 0.05], "kronecker_seed": 7,
        "order": "hybrid"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_by_name(cell):
    spec = harness.find_cell(SPEC, cell)
    config = harness.load_json("configs", spec["config"])
    traffic = harness.load_json("traffic", spec["traffic"])
    assert config["name"] == spec["config"]
    assert traffic["query"] in ("count", "list") and traffic["k"] >= 3
    files = {c["name"]: c["file"] for c in SPEC["configs"]}
    assert files[spec["config"]] == f"bench/configs/{spec['config']}.json"
    reported = [m for traced in (False, True)
                for m in harness.cell_metrics(SPEC, cell, traced)]
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names & {"count_s", "list_rows_per_s"}) == 1
    assert any(m in SPEC["per_layer"] for m in reported)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_has_a_reader(metric):
    assert callable(harness.load_reader(metric))
    assert NAME.match(metric)


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", CELLS):
            # the metric's cells report the end-to-end metric it moves
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    names = [c["name"] for c in SPEC["workloads"]]
    assert len(set(names)) == len(names)
    assert all(c["chips"] in (1, 4) and len(c["why"]) <= 200
               for c in SPEC["workloads"])


def _run(cell, traced=False, seed=2**31 + 17):
    return harness.run_cell(SPEC, cell, seed, 0.0, traced, "cpu",
                            config=TINY, log=lambda msg: None)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_shape(cell, traced):
    res = _run(cell, traced)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    want = {m["name"] for m in harness.cell_metrics(SPEC, cell, traced)}
    assert set(line["metrics"]) <= want
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        bd = line["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in bd.values())
    else:
        assert "breakdown" not in line and "setup_s" in line["metrics"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("structure", [1, 2, 3])
def test_verdict_holds_on_other_structures(cell, structure):
    # the timed runs draw one structure (the configuration's
    # kronecker_seed) in another labelling a seed; the program and the
    # verdict agree on other structures too
    config = dict(TINY, kronecker_seed=structure)
    res = harness.run_cell(SPEC, cell, 2**31 + 100 + structure, 0.0, False,
                           "cpu", config=config, log=lambda msg: None)
    assert res["correct"] is True and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())


def _drop_all(orig):
    def stream(*a, **kw):
        yield from ()
    return stream


def _drop_half(orig):
    def stream(*a, **kw):
        for i, item in enumerate(orig(*a, **kw)):
            if i % 2 == 0:
                yield item
    return stream


def _count_plus_one(orig):
    def combine(*a, **kw):
        return orig(*a, **kw) + 1
    return combine


def _row_altered(orig):
    def decode(*a, **kw):
        arr = orig(*a, **kw)
        if len(arr):
            arr = arr.copy()
            arr[0, -1] = (arr[0, -1] + 1) % 256
        return arr
    return decode


# each fault a cell can have: the query returns its state unchanged (no
# batch reaches the engine), half of the batches are left out, an answer
# is altered where it is produced; one card has no exchange between chips
FAULTS = {
    "unchanged": ("repro_torch.core.pipeline", "stream_batches", _drop_all),
    "half_left_out": ("repro_torch.core.pipeline", "stream_batches",
                      _drop_half),
    "count_altered": ("repro_torch.core.engine_torch", "combine_counts",
                      _count_plus_one),
    "row_altered": ("repro_torch.core.listing", "decode_batch", _row_altered),
}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in FAULTS
    if not (f == "count_altered" and "list" in c)
    and not (f == "row_altered" and "count" in c)])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    import importlib
    mod_name, attr, wrap = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    res = _run(cell)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types
    # other tests in this process may have loaded the JAX package already
    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    found = harness.forbidden_modules()
    assert "repro.core" in found and "repro_torch_extra" not in found
    assert not any(m.startswith("repro_torch") for m in found)
    assert {m.partition(".")[0] for m in found} <= set(harness.FORBIDDEN)


def test_profile_union_and_gap_billing():
    from bench import profiling
    iv = np.array([[0, 2], [1, 3], [5, 6], [5.5, 5.7]], dtype=float)
    assert profiling.union(iv).tolist() == [[0, 3], [5, 6]]
    spans = [{"name": "outer", "ts": 0, "dur": 100, "tid": 1},
             {"name": "pack/wait", "ts": 10, "dur": 20, "tid": 1},
             {"name": "pack", "ts": 0, "dur": 100, "tid": 2}]
    gaps = np.array([[12, 18], [40, 60], [200, 210]], dtype=float)
    got = profiling.bill_gaps(gaps, spans, main_tid=1)
    assert got == pytest.approx({"pack/wait": 6e-9, "outer": 20e-9,
                                 "(no span)": 10e-9})
    assert profiling.op_name("void branch_kernel<3, 5>(unsigned const*, int)") \
        == "branch_kernel"
    assert profiling.op_name("void repro_torch::(anonymous namespace)::"
                             "item_kernel<5, 2>(unsigned int const*)") \
        == "item_kernel"
    assert profiling.op_name("Memcpy DtoH (Device -> Pageable)") \
        == "Memcpy DtoH"
