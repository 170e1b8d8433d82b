"""The port's persistent autotuner (repro_torch.tune) and backend registry.

Mirrors ``tests/test_tune.py``: corrupt / stale-format records read as
absent (never crash), ``REPRO_TORCH_BACKEND`` beats a persisted record, a
persisted record beats a live microbenchmark (warm processes never
re-measure or re-search), concurrent same-directory writers stay atomic,
and geometry resolution follows the argument > record > default ladder --
knob by knob the reference's ladder for the same record data and
arguments.  The registry's CUDA side (``torch`` and ``ref`` raise on a
CUDA tensor, ``autotune`` runs the kernel) is tested on the card by
``test_torch_gpu.py``.
"""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro import tune as jtune
from repro.tune import search as jsearch
from repro.tune.records import TuningRecord as JRecord
from repro_torch import tune
from repro_torch.core import engine_torch, pipeline
from repro_torch.core.bitops import pack_bits
from repro_torch.core.engine_np import Stats
from repro_torch.data import graphs
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.launch import clique
from repro_torch.tune import cache as tcache
from repro_torch.tune import search as tsearch
from repro_torch.tune.records import TuningRecord


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    """Isolated tuning cache: fresh dir, no env leakage, clean globals."""
    monkeypatch.delenv(tcache.ENV_TUNE_CACHE, raising=False)
    monkeypatch.delenv(ops.BACKEND_ENV, raising=False)
    d = str(tmp_path / "tc")
    tune.configure(d, build_cache=False)  # the kernel build dir stays put
    tune.clear_memory()
    tune.consume_events()
    ops.clear_autotune_cache()
    yield d
    tune.configure(None)
    tune.clear_memory()
    tune.consume_events()
    ops.clear_autotune_cache()


def _backend_rec(winner="cuda", mode="count", l=2, T=32, capacity=None):
    return TuningRecord(
        "backend", tune.device_kind(), tune.torch_version(), mode, l,
        T=T, W=T // 32, cap_bucket=tune.capacity_bucket(capacity),
        data={"winner": winner})


def _record_meta_path(tune_dir):
    [digest] = os.listdir(os.path.join(tune_dir, "records"))
    return os.path.join(tune_dir, "records", digest,
                        "step_0000000000", "meta.json")


def test_record_roundtrip_across_processes(tune_dir):
    rec = _backend_rec("torch")
    tune.put(rec)
    tune.clear_memory()  # "new process": only the directory survives
    got = tune.get(rec.key())
    assert got is not None
    assert got.data["winner"] == "torch"
    assert got.key() == rec.key()
    assert tune.device_kind() == ("cpu" if not torch.cuda.is_available()
                                  else torch.cuda.get_device_name())
    assert got.torch_version == f"{torch.__version__}/cuda-" \
        f"{torch.version.cuda}"


def test_corrupt_record_reads_as_absent(tune_dir):
    rec = _backend_rec("torch")
    tune.put(rec)
    with open(_record_meta_path(tune_dir), "w") as f:
        f.write("{ not json")
    tune.clear_memory()
    assert tune.get(rec.key()) is None
    # ...and backend="autotune" falls back to a live measurement, no crash
    assert ops.autotune_backend("count", 2, 32) in ("cuda", "torch")


def test_stale_format_record_reads_as_absent(tune_dir):
    rec = _backend_rec("cuda")
    tune.put(rec)
    p = _record_meta_path(tune_dir)
    with open(p) as f:
        meta = json.load(f)
    meta["metadata"]["format"] = 0  # an older layout
    with open(p, "w") as f:
        json.dump(meta, f)
    tune.clear_memory()
    assert tune.get(rec.key()) is None


def test_env_backend_overrides_persisted_record(tune_dir, monkeypatch):
    tune.put(_backend_rec("cuda"))
    monkeypatch.setenv(ops.BACKEND_ENV, "torch")
    assert ops.autotune_backend("count", 2, 32) == "torch"
    # the env short-circuit consults no cache layer: no events at all
    assert tune.consume_events() == (0.0, 0, 0)


def test_persisted_record_skips_microbench(tune_dir, monkeypatch):
    tune.put(_backend_rec("torch"))
    monkeypatch.setattr(
        tsearch, "microbench_backend",
        lambda *a, **k: pytest.fail("microbenchmark re-ran on a warm key"))
    assert ops.autotune_backend("count", 2, 32) == "torch"
    tune_s, lookups, misses = tune.consume_events()
    assert lookups == 1 and misses == 0
    # second call answers from the in-process layer, same verdict
    assert ops.autotune_backend("count", 2, 32) == "torch"
    _, lookups, misses = tune.consume_events()
    assert lookups == 1 and misses == 0


def test_concurrent_writers_stay_atomic(tune_dir):
    """Same-key writers race benignly: no exceptions escape, and a reader
    only ever sees a fully committed record (or none), never garbage."""
    rec = _backend_rec("torch")
    errors = []

    def write(winner):
        try:
            for _ in range(5):
                tune.put(_backend_rec(winner))
        except Exception as e:  # pragma: no cover - the bug being tested
            errors.append(e)

    threads = [threading.Thread(target=write, args=(w,))
               for w in ("torch", "cuda") * 3]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    tune.clear_memory()
    got = tune.get(rec.key())
    assert got is None or got.data["winner"] in ("torch", "cuda")
    # the cache recovers: one clean write-after-the-race round-trips
    tune.put(_backend_rec("torch"))
    tune.clear_memory()
    assert tune.get(rec.key()).data["winner"] == "torch"


def test_geometry_precedence_ladder(tune_dir):
    # no record anywhere: the hardcoded defaults
    g0 = tsearch.resolve_geometry("list", 3)
    assert (g0.batch_size, g0.t_policy, g0.cap_policy) == \
        (256, "pow2", "pow2")
    assert tune.consume_events() == (0.0, 0, 0)  # untuned != cache miss
    # a persisted record becomes the default...
    tune.put(TuningRecord(
        "geometry", tune.device_kind(), tune.torch_version(), "list", 3,
        data={"batch_size": 64, "t_policy": "mult32",
              "cap_policy": "mult64"}))
    tune.clear_memory()
    g1 = tsearch.resolve_geometry("list", 3)
    assert g1.batch_size == 64
    assert g1.bins == tsearch.bins_for("mult32")
    assert g1.cap_policy == "mult64"
    _, lookups, misses = tune.consume_events()
    assert lookups == 1 and misses == 0
    # ...but an explicit argument still wins, per knob
    g2 = tsearch.resolve_geometry("list", 3, batch_size=128,
                                  cap_policy="pow2")
    assert g2.batch_size == 128
    assert g2.cap_policy == "pow2"
    assert g2.bins == tsearch.bins_for("mult32")  # inherited from record
    # an explicit ladder wins even when it matches no named policy
    g3 = tsearch.resolve_geometry("list", 3, bins=(32,))
    assert g3.bins == (32,)
    g4 = tsearch.resolve_geometry("list", 3, bins=(32, 64, 128, 256))
    assert g4.bins == tsearch.bins_for("pow2")
    assert g4.t_policy == "pow2"  # a policy-shaped ladder maps back


_LADDER_CASES = [
    ({}, {}),
    ({"batch_size": 64, "t_policy": "mult32", "cap_policy": "mult64",
      "max_capacity": 4096, "pack_workers": 2, "prefetch": 3}, {}),
    ({"batch_size": 64, "t_policy": "mult32"},
     {"batch_size": 512, "bins": (32, 64, 128, 256)}),
    ({"cap_policy": "mult64", "pack_workers": 0},
     {"bins": (96, 256), "max_capacity": 1024, "prefetch": 1}),
    ({"t_policy": "mult32", "bins_override": None},
     {"bins": (256, 224, 192, 160, 128, 96, 64, 32), "pack_workers": 4}),
]


@pytest.fixture
def ref_tune_dir(tmp_path, monkeypatch):
    monkeypatch.delenv(jtune.ENV_TUNE_CACHE, raising=False)
    d = str(tmp_path / "ref_tc")
    jtune.configure(d, xla_cache=False)
    jtune.clear_memory()
    yield d
    jtune.configure(None)
    jtune.clear_memory()
    jtune.consume_events()


@pytest.mark.parametrize("case", range(len(_LADDER_CASES)))
def test_resolve_geometry_matches_reference_knob_by_knob(tune_dir,
                                                         ref_tune_dir, case):
    data, kwargs = _LADDER_CASES[case]
    for mode, l in (("count", 5), ("list", 3)):
        if data:
            tune.put(TuningRecord("geometry", tune.device_kind(),
                                  tune.torch_version(), mode, l, data=data))
            jtune.put(JRecord("geometry", jtune.device_kind(),
                              jtune.jax_version(), mode, l, data=data))
        tune.clear_memory()
        jtune.clear_memory()
        got = tsearch.resolve_geometry(mode, l, **kwargs)
        want = jsearch.resolve_geometry(mode, l, **kwargs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.bins == want.bins
        assert tune.consume_events()[1:] == jtune.consume_events()[1:]
    assert tsearch.bins_for("mult32") == jsearch.bins_for("mult32")
    assert tsearch.MIN_GAIN == jsearch.MIN_GAIN


def test_warm_process_reuses_tuned_geometry_without_search(tune_dir,
                                                          monkeypatch):
    rec = tsearch.tune_geometry("count", 1, budget_s=2.0,
                                graph=graphs.rmat_graph(7, 6, seed=1),
                                device="cpu")
    tuned = tsearch.geometry_from_record(rec)
    # "second process": in-memory layers gone, only the record dir remains
    tune.clear_memory()
    ops.clear_autotune_cache()
    monkeypatch.setattr(
        tsearch, "_eval_geometry",
        lambda *a, **k: pytest.fail("geometry re-searched on a warm key"))
    got = tsearch.resolve_geometry("count", 1)
    assert dataclasses.asdict(got) == dataclasses.asdict(tuned)
    assert rec.data["searched"] and rec.data["evals"] >= 1
    assert rec.torch_version == tune.torch_version()
    # and a query that reads it is a tuning-cache hit
    pipeline.clear_plan_cache()
    res = engine_torch.count(graphs.rmat_graph(7, 6, seed=1), 3,
                             device="cpu")
    assert res.stats.tune_cache_hit and res.stats.tune_s == 0.0
    pipeline.clear_plan_cache()


def _packed(rng, B, T):
    dense = rng.random((B, T, T)) < 0.4
    dense = np.triu(dense, 1)
    dense = dense | dense.transpose(0, 2, 1)
    return (torch.from_numpy(pack_bits(dense)).view(torch.int32),
            torch.from_numpy(pack_bits(np.ones((B, T), bool))).view(
                torch.int32))


def test_zero_cand_padding_is_neutral():
    """The port stages batches unpadded (no ``bucket_rows``), but the
    row-sharded dispatch pads with zero-cand lanes; the pads must
    contribute nothing to counts or rows, under every backend that runs
    on the CPU."""
    rng = np.random.default_rng(5)
    A, cand = _packed(rng, 5, 32)
    Ap = torch.cat([A, torch.zeros((3, 32, 1), dtype=torch.int32)])
    cp = torch.cat([cand, torch.zeros((3, 1), dtype=torch.int32)])
    for backend in ("torch", "ref", "auto"):
        base = ops.count_tiles(A, cand, 2, backend=backend)
        padded = ops.count_tiles(Ap, cp, 2, backend=backend)
        assert torch.equal(padded[:5], base) and not padded[5:].any()
    buf, cnts, ovf = ops.list_tiles(Ap, cp, 2, 64, backend="torch")
    assert torch.equal(cnts[:5], ops.count_tiles(A, cand, 2))
    assert not cnts[5:].any() and not ovf[5:].any()


def test_drain_tune_events_never_clobbers_verdict(tune_dir):
    st = Stats()
    tune.note_event(seconds=0.5, lookup=True, miss=True)
    ops.drain_tune_events(st)
    assert st.tune_s == 0.5 and st.tune_cache_hit is False
    tune.note_event(lookup=True)
    ops.drain_tune_events(st)
    assert st.tune_cache_hit is True
    # an empty drain (engines and dispatchers share one Stats and both
    # drain) must leave the verdict and the seconds untouched
    ops.drain_tune_events(st)
    assert st.tune_cache_hit is True and st.tune_s == 0.5


def test_backend_registry_on_cpu(tune_dir, monkeypatch):
    assert ops.BACKENDS == ("auto", "cuda", "torch", "ref", "autotune")
    cpu = torch.device("cpu")
    assert ops.resolve_backend(None, cpu) == "torch"
    assert ops.resolve_backend("auto", cpu) == "torch"
    assert ops.resolve_backend("autotune", cpu) == "autotune"
    assert ops.resolve_backend(None, "cuda") == "cuda"
    with pytest.raises(ValueError):
        ops.resolve_backend("pallas")
    monkeypatch.setenv(ops.BACKEND_ENV, "ref")
    assert ops.resolve_backend(None, cpu) == "ref"
    assert ops.resolve_backend("auto", cpu) == "torch"  # explicit wins
    monkeypatch.delenv(ops.BACKEND_ENV)
    rng = np.random.default_rng(2)
    A, cand = _packed(rng, 3, 64)
    want = ops.count_tiles(A, cand, 4)
    for backend in ("torch", "ref"):
        assert torch.equal(ops.count_tiles(A, cand, 4, backend=backend),
                           want)
    with pytest.raises(ValueError):      # the kernels need CUDA tensors
        ops.count_tiles(A, cand, 4, backend="cuda")
    with pytest.raises(ValueError):
        ops.list_tiles(A, cand, 3, 8, backend="cuda")
    with pytest.raises(ValueError):      # ref counts only
        ops.list_tiles(A, cand, 3, 8, backend="ref")
    # autotune on a CPU tensor: a live measurement of the one candidate
    # the CPU has, persisted with its time, then the plain version runs
    ops.reset_counts()
    assert torch.equal(ops.count_tiles(A, cand, 4, backend="autotune"), want)
    assert ops.plain_counts()["clique_count_tiles"] == 1 + 3  # 1 + warm-up + 2
    rec = tune.get(tune.backend_key("count", 4, 64))
    assert rec.data["winner"] == "torch" and set(rec.data["times"]) == \
        {"torch"}
    tune_s, lookups, misses = tune.consume_events()
    assert tune_s > 0 and (lookups, misses) == (1, 1)


def test_engines_drain_autotune_events(tune_dir):
    g = graphs.erdos_renyi(60, 0.3, seed=2)
    pipeline.clear_plan_cache()
    first = engine_torch.count(g, 5, device="cpu", backend="autotune")
    second = engine_torch.count(g, 5, device="cpu", backend="autotune")
    assert first.count == second.count == engine_torch.count(
        g, 5, device="cpu").count
    assert first.stats.tune_s > 0 and first.stats.tune_cache_hit is False
    assert second.stats.tune_s == 0 and second.stats.tune_cache_hit is True
    pipeline.clear_plan_cache()


def test_cli_tune_cache_and_backend(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv(tcache.ENV_TUNE_CACHE, raising=False)
    d = str(tmp_path / "tc")
    build_dir = _build.BUILD_DIR
    tune.configure(d, build_cache=False)
    tune.put(TuningRecord("geometry", tune.device_kind(),
                          tune.torch_version(), "count", 3,
                          data={"t_policy": "mult32", "batch_size": 64}))
    tune.configure(None)
    tune.clear_memory()
    rc = clique.main(["--graph", "rmat:9,16", "--k", "5", "--device", "cpu",
                      "--verify", "--tune-cache", d, "--backend", "torch"])
    out = capsys.readouterr().out
    assert rc == 0 and "match=True" in out
    assert "geometry: bins=32,64,96,128,160,192,224,256 batch_size=64" in out
    assert "tune_hit=True" in out
    # the run kept the kernel library under the tune cache, then put the
    # build directory back (and left no tune cache configured)
    assert _build.BUILD_DIR == build_dir and tune.active_dir() is None
    assert os.path.isdir(os.path.join(d, "kernels"))
    tune.clear_memory()
