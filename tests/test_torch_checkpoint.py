"""The port's checkpoint store and plan persistence against the reference.

Mirrors ``tests/test_checkpoint.py`` (atomic commit, resume, GC, restore
placed on a device) for ``repro_torch.checkpoint``, then holds the plan
stores of the two packages against each other: a store that either
package's ``save_plan`` wrote loads in the other with equal flat arrays
and metadata.  ``cached_plan(cache_dir=)`` hits the disk in a second
process, and a corrupt store (the ``plan.load`` fault site's ``corrupt``
rule) is quarantined and rebuilt to the same count.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core import pipeline as jpipeline
from repro.data import graphs as jgraphs
from repro_torch.checkpoint import (gc_checkpoints, latest_step,
                                    read_metadata, restore_checkpoint,
                                    restore_checkpoint_safe, save_checkpoint)
from repro_torch.checkpoint import store
from repro_torch.core import engine_torch, listing, pipeline
from repro_torch.data import graphs
from repro_torch.launch import clique
from repro_torch.obs import trace
from repro_torch.resilience import inject

ROOT = Path(__file__).resolve().parents[1]


def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "layers": [np.ones((2,)), torch.zeros((3,))]},
            "count": np.int32(7)}


def leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in leaves(v)]
    return [t]


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    t = tree()
    save_checkpoint(d, 5, t, pipeline_state={"step": 5},
                    metadata={"note": "x"})
    got = restore_checkpoint(d, t)
    assert got["step"] == 5
    assert got["pipeline"] == {"step": 5}
    assert got["metadata"] == {"note": "x"}
    for a, b in zip(leaves(t), leaves(got["tree"])):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(host(a), b)
    assert read_metadata(d) == {"note": "x"}


def test_latest_and_gc(tmp_path):
    d = str(tmp_path)
    t = tree()
    for s in (1, 3, 7, 9):
        save_checkpoint(d, s, t)
    assert latest_step(d) == 9
    gc_checkpoints(d, keep=2)
    assert latest_step(d) == 9
    assert restore_checkpoint(d, t, step=7) is not None \
        and os.path.isdir(os.path.join(d, "step_0000000007"))
    assert not os.path.isdir(os.path.join(d, "step_0000000001"))


def test_uncommitted_ignored(tmp_path):
    d = str(tmp_path)
    t = tree()
    save_checkpoint(d, 2, t)
    # simulate a crash mid-write at step 4: directory without COMMITTED
    os.makedirs(os.path.join(d, "step_0000000004"))
    assert latest_step(d) == 2
    got = restore_checkpoint(d, t)
    assert got["step"] == 2


def test_restore_placed_on_a_device(tmp_path):
    """``device=`` takes the place of the reference's ``shardings=``: the
    leaves come back as torch tensors there, whatever wrote them."""
    d = str(tmp_path)
    t = {"w": np.arange(16.0).reshape(4, 4), "n": np.int64(3)}
    jstore.save_checkpoint(d, 1, t)          # written by the reference
    got = restore_checkpoint(d, t, device="cpu")
    assert isinstance(got["tree"]["w"], torch.Tensor)
    assert got["tree"]["w"].device.type == "cpu"
    np.testing.assert_array_equal(got["tree"]["w"].numpy(), t["w"])
    assert int(got["tree"]["n"]) == 3
    # and the reference reads what the port wrote from torch tensors
    save_checkpoint(d, 2, {"w": torch.from_numpy(t["w"]), "n": t["n"]})
    back = jstore.restore_checkpoint(d, t)
    np.testing.assert_array_equal(np.asarray(back["tree"]["w"]), t["w"])


def test_corrupt_store_raises_typed_and_quarantines(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, {"a": np.arange(10)})
    path = Path(d) / "step_0000000000" / "arrays.npz"
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    with pytest.raises(store.CorruptCheckpointError):
        restore_checkpoint(d)
    assert restore_checkpoint_safe(d) is None
    assert latest_step(d) is None
    assert len(os.listdir(Path(d) / "quarantine")) == 1


GRAPH = dict(scale=7, edge_factor=8, seed=3)


def flat_plan(directory, reader):
    got = reader.restore_checkpoint(directory)
    return {k: np.asarray(v) for k, v in got["tree"].items()}, \
        got["metadata"]


@pytest.mark.parametrize("order", ["hybrid", "color"])
def test_plan_stores_cross_read_both_ways(tmp_path, order):
    g, jg = graphs.rmat_graph(**GRAPH), jgraphs.rmat_graph(**GRAPH)
    jplan = jpipeline.build_plan(jg, order=order)
    tplan = pipeline.build_plan(g, order=order)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jpipeline.save_plan(jplan, jdir, lineage={"by": "reference"})
    pipeline.save_plan(tplan, tdir, lineage={"by": "reference"})
    # the two stores hold the same arrays under the same names and the
    # same metadata (the npz members' timestamps are the only difference)
    jflat, jmeta = flat_plan(jdir, jstore)
    tflat, tmeta = flat_plan(tdir, store)
    assert sorted(jflat) == sorted(tflat) and jmeta == tmeta
    for name in jflat:
        np.testing.assert_array_equal(jflat[name], tflat[name])
        assert jflat[name].dtype == tflat[name].dtype, name
    meta = json.loads((Path(tdir) / "step_0000000000" / "meta.json")
                      .read_text())
    assert sorted(meta) == ["integrity", "metadata", "pipeline", "step"]
    # the port loads the reference's store, and the reference the port's
    loaded = pipeline.load_plan(jdir)
    jloaded = jpipeline.load_plan(tdir)
    family = "color" if order == "color" else "truss"
    assert family in loaded._tables and family in jloaded._tables
    k = 5
    got = [b.A for b in pipeline.stream_batches(loaded, k, order=order)
           if isinstance(b, pipeline.TileBatch)]
    want = [b.A for b in jpipeline.stream_batches(jloaded, k, order=order)
            if isinstance(b, jpipeline.TileBatch)]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert store.read_metadata(jdir)["lineage"] == {"by": "reference"}


def test_cached_plan_hits_disk_in_a_second_process(tmp_path):
    g = graphs.rmat_graph(**GRAPH)
    d = str(tmp_path / "plans")
    pipeline.clear_plan_cache()
    res = engine_torch.count(g, 5, device="cpu", plan_cache_dir=d)
    assert not res.stats.plan_cache_hit and res.stats.plan_build_s > 0
    assert len(os.listdir(d)) == 1
    code = (
        "from repro_torch.core import engine_torch\n"
        "from repro_torch.data import graphs\n"
        f"g = graphs.rmat_graph(**{GRAPH!r})\n"
        f"r = engine_torch.count(g, 5, device='cpu', plan_cache_dir={d!r})\n"
        "print(r.count, r.stats.plan_cache_hit, r.stats.plan_build_s)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_TORCH_FAULT_PLAN", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, hit, build_s = out.stdout.split()
    assert (int(count), hit, float(build_s)) == (res.count, "True", 0.0)
    # in this process too: the plan/load span and a disk cache-hit instant
    pipeline.clear_plan_cache()
    trace.configure(enabled=True)
    trace.reset()
    try:
        sink = listing.ArraySink(5)
        st = listing.stream_cliques(g, 5, sink, device="cpu",
                                    plan_cache_dir=d).stats
        events = trace.events()
    finally:
        trace.configure(enabled=False)
        trace.reset()
    assert st.plan_cache_hit and sink.result().shape[0] == res.count
    assert any(e["name"] == "plan/load" and e.get("ph") == "X"
               for e in events)
    assert any(e["name"] == "plan/cache_hit"
               and e.get("args", {}).get("source") == "disk" for e in events)
    pipeline.clear_plan_cache()


def test_corrupt_plan_store_is_quarantined_and_rebuilt(tmp_path):
    g = graphs.rmat_graph(**GRAPH)
    d = str(tmp_path / "plans")
    pipeline.clear_plan_cache()
    want = engine_torch.count(g, 6, device="cpu", plan_cache_dir=d).count
    pipeline.clear_plan_cache()
    inject.configure("plan.load=1.0:corrupt")
    try:
        res = engine_torch.count(g, 6, device="cpu", plan_cache_dir=d)
    finally:
        inject.configure(None)
    assert res.count == want
    assert not res.stats.plan_cache_hit and res.stats.plan_build_s > 0
    (key,) = [p for p in os.listdir(d)]
    assert len(os.listdir(Path(d) / key / "quarantine")) == 1
    # the rebuilt plan was saved again, and the next process-level miss
    # loads it
    pipeline.clear_plan_cache()
    again = engine_torch.count(g, 6, device="cpu", plan_cache_dir=d)
    assert again.stats.plan_cache_hit and again.count == want
    # an injected raise at the site is a miss too, never an error
    pipeline.clear_plan_cache()
    inject.configure("plan.load=1.0")
    try:
        raised = engine_torch.count(g, 6, device="cpu", plan_cache_dir=d)
    finally:
        inject.configure(None)
    assert raised.count == want and not raised.stats.plan_cache_hit
    # plan_cache=False builds without touching either cache
    pipeline.clear_plan_cache()
    off = engine_torch.count(g, 6, device="cpu", plan_cache=False)
    assert off.count == want and not off.stats.plan_cache_hit
    assert off.stats.plan_build_s == 0.0
    pipeline.clear_plan_cache()


def test_cli_plan_cache(tmp_path, capsys):
    d = str(tmp_path / "plans")
    argv = ["--graph", "er:150,0.1", "--k", "4", "--device", "cpu",
            "--verify", "--plan-cache", d]
    pipeline.clear_plan_cache()
    assert clique.main(argv) == 0
    first = capsys.readouterr().out
    pipeline.clear_plan_cache()
    assert clique.main(argv) == 0
    second = capsys.readouterr().out
    pipeline.clear_plan_cache()
    assert f"plan cache [{d}]: cold" in first and "match=True" in first
    assert f"plan cache [{d}]: warm" in second and "match=True" in second
