"""The port's resilience layer (``repro_torch.resilience``) on the CPU.

The port's copies of the reference's unit tests (``tests/test_resilience.py``:
fault-plan parsing, the deterministic schedule, the disabled-injection
overhead budget, backoff, retry, the demotion ladders), plus what ties the
port to the reference: one plan string fires at the same calls and backs
off by the same delays in both packages; under a seeded chaos plan the
port's counts and rows (order included) are the reference's; on CPU lanes
a plan that fails every launch demotes each batch through both rungs (on
a CPU lane both run the plain version) to the exact host result, while
the policy of a CUDA lane retries and then raises; unlike the reference, a
real (not injected) exception is neither retried nor demoted but
propagates; and the reference's environment variable does not arm the
port.
"""
import os
import subprocess
import sys
import time

from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import ebbkc as jebbkc
from repro.data import graphs as jgraphs
from repro.resilience import inject as jinject
from repro.resilience import retry as jretry
from repro_torch.core import ebbkc, engine_torch, listing, pipeline
from repro_torch.core.engine_np import Stats
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import ops as kops
from repro_torch.launch import clique
from repro_torch.resilience import inject, retry
from repro_torch.runtime import dispatch

#: every site armed at 0.3
CHAOS_PLAN = ("seed=11;plan.load=0.3;extract=0.3;pack=0.3;device.stage=0.3;"
              "kernel.launch=0.3;device.harvest=0.3;decode=0.3;"
              "sink.write=0.3;tune.read=0.3")


@pytest.fixture(autouse=True)
def _clean_injection():
    inject.configure(None)
    jinject.configure(None)
    yield
    inject.configure(None)
    jinject.configure(None)


@pytest.fixture(scope="module")
def graphs():
    """The same graph from both packages: tiles in the 32 and 64 bins."""
    args = (70, 0.3)
    return (tgraphs.erdos_renyi(*args, seed=5),
            jgraphs.erdos_renyi(*args, seed=5))


# ---------------------------------------------------------------------------
# fault-plan parsing + deterministic schedule
# ---------------------------------------------------------------------------


def test_fault_plan_parse():
    plan = inject.FaultPlan.parse("seed=9;*=0.1;kernel.launch=0.5:delay:0.01")
    assert plan.seed == 9
    assert plan.rules["decode"].rate == 0.1
    assert plan.rules["decode"].kind == "raise"
    assert plan.rules["kernel.launch"].rate == 0.5
    assert plan.rules["kernel.launch"].kind == "delay"
    assert plan.rules["kernel.launch"].param == 0.01
    with pytest.raises(ValueError):
        inject.FaultPlan.parse("nonsense.site=0.5")
    with pytest.raises(ValueError):
        inject.FaultPlan.parse("decode=0.5:explode")


def _schedule(mod, site, n=64):
    fired = []
    for _ in range(n):
        try:
            mod.fire(site)
            fired.append(False)
        except mod.FaultInjected:
            fired.append(True)
    return fired


def test_fault_schedule_is_deterministic():
    inject.configure("seed=4;decode=0.5")
    first = _schedule(inject, "decode")
    assert any(first) and not all(first)
    # same plan, reset counters -> identical schedule, call for call
    inject.reset_counts()
    assert _schedule(inject, "decode") == first
    # a different seed produces a different schedule
    inject.configure("seed=5;decode=0.5")
    assert _schedule(inject, "decode") != first


def test_disabled_injection_is_noop_and_cheap(graphs):
    # off by default: fire() at any site is a no-op...
    inject.configure(None)
    for site in inject.SITES:
        inject.fire(site)
    # ...and cheap enough that the sites cost <= 1% of engine work
    g = graphs[0]
    kw = dict(devices=["cpu"], batch_size=64)

    def workload():
        t0 = time.perf_counter()
        engine_torch.count(g, 4, **kw)
        return time.perf_counter() - t0

    workload()  # warm the plan cache
    work_s = min(workload() for _ in range(3))

    # count the site calls that workload makes (an epsilon-rate plan:
    # every call advances the schedule, none of them fires at 1e-12)
    inject.configure("seed=1;*=0.000000000001")
    engine_torch.count(g, 4, **kw)
    n_calls = sum(inject.calls().values())
    assert sum(inject.fired().values()) == 0
    inject.configure(None)
    assert n_calls > 0

    n_iter = 50_000
    t0 = time.perf_counter()
    for _ in range(n_iter):
        inject.fire("kernel.launch")
    per_call = (time.perf_counter() - t0) / n_iter
    overhead = per_call * n_calls
    assert overhead <= 0.01 * work_s, (
        f"disabled injection costs {overhead * 1e3:.3f}ms over {n_calls} "
        f"site calls vs {work_s * 1e3:.1f}ms of work")


# ---------------------------------------------------------------------------
# retry / backoff / demotion units
# ---------------------------------------------------------------------------


def test_backoff_delay_capped_and_deterministic():
    pol = retry.RetryPolicy(max_attempts=8, base_delay_s=0.001,
                            max_delay_s=0.004, jitter=0.5, seed=2)
    delays = [retry.backoff_delay(pol, a, token="t") for a in range(1, 8)]
    assert all(0 < d <= 0.004 for d in delays)
    assert delays == [retry.backoff_delay(pol, a, token="t")
                      for a in range(1, 8)]
    # exponential growth up to the cap (jitter only ever shrinks)
    assert retry.backoff_delay(
        retry.RetryPolicy(jitter=0.0), 2) == 2 * retry.backoff_delay(
        retry.RetryPolicy(jitter=0.0), 1)


def test_retry_call_retries_then_raises():
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("transient")
        return "ok"

    pol = retry.RetryPolicy(max_attempts=3, base_delay_s=0.0)
    assert retry.call(flaky, policy=pol, retry_on=(RuntimeError,)) == "ok"
    assert len(attempts) == 3

    with pytest.raises(RuntimeError):
        retry.call(lambda: (_ for _ in ()).throw(RuntimeError("always")),
                   policy=pol, retry_on=(RuntimeError,))
    # by default only injected faults are retried: a real error raises at
    # the first attempt
    attempts.clear()
    with pytest.raises(RuntimeError):
        retry.call(flaky, policy=pol)
    assert len(attempts) == 1


def test_demotion_ladders():
    assert retry.COUNT_LADDER == retry.LIST_LADDER == ("cuda", "torch")
    assert retry.demote("count", "cuda") == "torch"
    assert retry.demote("count", "torch") is None
    assert retry.demote("list", "cuda") == "torch"
    assert retry.demote("list", "torch") is None
    # an off-ladder backend (None = unresolved, host, ...) has no rung
    # below it: the caller falls straight back to the host recursion
    assert retry.demote("count", None) is None
    assert retry.demote("count", "host") is None


# ---------------------------------------------------------------------------
# parity with the reference's injector and backoff
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", [
    "seed=7;*=0.1",
    "seed=3;kernel.launch=0.5;decode=0.25:delay:0.0",
    CHAOS_PLAN,
])
def test_one_plan_fires_the_same_schedule_in_both_packages(plan):
    inject.configure(plan)
    jinject.configure(plan)
    assert inject.FaultPlan.parse(plan).rules.keys() == \
        jinject.FaultPlan.parse(plan).rules.keys()
    for site in inject.SITES:
        assert _schedule(inject, site, 96) == _schedule(jinject, site, 96)
    assert inject.fired() == jinject.fired()
    assert inject.calls() == jinject.calls()


def test_backoff_delays_match_reference():
    for kw in (dict(), dict(seed=9, jitter=0.25, max_delay_s=0.01)):
        pol, jpol = retry.RetryPolicy(**kw), jretry.RetryPolicy(**kw)
        for token in ("", "count.launch", "decode"):
            assert [retry.backoff_delay(pol, a, token) for a in range(1, 9)] \
                == [jretry.backoff_delay(jpol, a, token)
                    for a in range(1, 9)]
    assert retry.CONSUME_POLICY == retry.RetryPolicy(
        **{f: getattr(jretry.CONSUME_POLICY, f)
           for f in ("max_attempts", "base_delay_s", "max_delay_s",
                     "jitter", "seed")})


# ---------------------------------------------------------------------------
# chaos: exact counts and rows under a seeded plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [["cpu"], ["cpu", "cpu"]])
@pytest.mark.parametrize("k", [4, 5])
def test_chaos_counts_equal_reference(graphs, k, lanes):
    g, jg = graphs
    want = jebbkc.count(jg, k).count
    inject.configure(CHAOS_PLAN)
    res = ebbkc.count(g, k, engine_kwargs=dict(devices=lanes, batch_size=16,
                                               pack_workers=2))
    fired, calls = inject.fired(), inject.calls()
    inject.configure(None)
    assert res.count == want
    assert res.stats.retries > 0
    assert fired.get("kernel.launch", 0) > 0 and fired.get("pack", 0) > 0
    assert calls["extract"] >= 1


def test_chaos_row_sharded_and_offline_counts_are_exact(graphs):
    g, jg = graphs
    want = jebbkc.count(jg, 5).count
    plan = pipeline.cached_plan(g)
    inject.configure(CHAOS_PLAN)
    items = list(pipeline.stream_batches(plan, 5, batch_size=16,
                                         pack_workers=0))
    batches = [b for b in items if isinstance(b, pipeline.TileBatch)]
    assert len(batches) == len(items)
    stats = Stats()
    got, _ = dispatch.dispatch_scheduled(batches, 3, ["cpu", "cpu"],
                                         stats=stats)
    mesh = dispatch.Dispatcher(3, mesh=["cpu", "cpu"])
    for b in batches:
        mesh.submit(b)
    got_mesh = mesh.finish()
    inject.configure(None)
    assert got == got_mesh == want
    assert stats.retries > 0 and mesh.stats.retries > 0


@pytest.mark.parametrize("capacity", [None, "speculative", 1])
@pytest.mark.parametrize("lanes", [None, ["cpu", "cpu"]])
def test_chaos_rows_equal_reference(graphs, capacity, lanes):
    """Rows, in content and order, under the chaos plan: the reference's
    fault-free rows, on the inline path and through the ListDispatcher
    (sized, speculative, and a pinned capacity that overflows; the inline
    path sizes "speculative" exactly)."""
    g, jg = graphs
    k = 5
    kw = dict(capacity=capacity, batch_size=16, pack_workers=2)
    want, _ = jebbkc.list_cliques(
        jg, k, backend="jax",
        engine_kwargs=dict(backend="lax", capacity=capacity
                           if isinstance(capacity, int) else None,
                           batch_size=16))
    inject.configure(CHAOS_PLAN)
    got, st = ebbkc.list_cliques(g, k, device="cpu", engine_kwargs=dict(
        kw, **({} if lanes is None else dict(devices=lanes))))
    fired = inject.fired()
    inject.configure(None)
    np.testing.assert_array_equal(got, want)
    assert st.emitted_cliques == want.shape[0] > 0
    assert fired.get("sink.write", 0) > 0 and fired.get("decode", 0) > 0
    if lanes is not None:
        assert st.retries > 0
    if capacity == 1:
        assert st.overflowed_tiles > 0


# ---------------------------------------------------------------------------
# every launch failing: demotion through both rungs to the host
# ---------------------------------------------------------------------------


def _n_batches(g, k, batch_size):
    plan = pipeline.cached_plan(g)
    return sum(isinstance(b, pipeline.TileBatch) for b in
               pipeline.stream_batches(plan, k, batch_size=batch_size,
                                       pack_workers=0))


@pytest.mark.parametrize("k", [4, 5, 6])
def test_every_launch_failing_counts_on_the_host(graphs, k):
    g, jg = graphs
    n = _n_batches(g, k, 16)
    kops.reset_counts()
    inject.configure("kernel.launch=1.0")
    res = ebbkc.count(g, k, engine_kwargs=dict(devices=["cpu"],
                                               batch_size=16))
    inject.configure(None)
    assert res.count == jebbkc.count(jg, k).count
    # each batch: both rungs tried DEFAULT_POLICY.max_attempts times
    attempts = retry.DEFAULT_POLICY.max_attempts
    assert res.stats.demotions == 2 * n
    assert res.stats.retries == 2 * (attempts - 1) * n
    assert sum(kops.plain_counts().values()) == 0  # no rung ran
    kops.reset_counts()


@pytest.mark.parametrize("capacity", [None, "speculative", 8])
def test_every_launch_failing_lists_on_the_host(graphs, capacity):
    g, jg = graphs
    k = 5
    n = _n_batches(g, k, 16)
    want, _ = ebbkc.list_cliques(g, k, device="cpu",
                                 engine_kwargs=dict(batch_size=16))
    inject.configure("kernel.launch=1.0")
    got, st = ebbkc.list_cliques(g, k, engine_kwargs=dict(
        devices=["cpu", "cpu"], batch_size=16, capacity=capacity))
    inject.configure(None)
    np.testing.assert_array_equal(got, want)
    # sized: the count pass gives up both rungs, then the host lists the
    # batch; a pinned or speculative capacity: the list kernel does
    assert st.demotions == 2 * n
    assert st.overflowed_tiles == 0  # the host triple never overflows


@pytest.mark.parametrize("mode", ["count", "list"])
def test_card_lane_retries_then_raises_without_demotion(mode):
    """The policy of a CUDA lane, run here without a card: an injected
    fault is retried on the kernel under DEFAULT_POLICY, then raises; no
    rung below it and no host rung run."""
    stats = Stats()
    lanes = dispatch._Lanes(3, [torch.device("cpu")], stats)
    tries, host = [], []

    def launch():
        tries.append(1)
        inject.fire("kernel.launch")

    inject.configure("kernel.launch=1.0")
    with pytest.raises(inject.FaultInjected):
        lanes._run(True, mode, launch, lambda: host.append(1), "t")
    inject.configure(None)
    attempts = retry.DEFAULT_POLICY.max_attempts
    assert len(tries) == attempts and not host
    assert stats.retries == attempts - 1 and stats.demotions == 0
    # the same launch on a CPU lane: both rungs, then the host
    inject.configure("kernel.launch=1.0")
    lanes._run(False, mode, launch, lambda: host.append(1), "t")
    inject.configure(None)
    assert len(tries) == 3 * attempts and host == [1]
    assert stats.demotions == 2


def test_only_the_ports_own_variable_arms_a_plan():
    """``REPRO_FAULT_PLAN`` arms the reference; the port reads
    ``REPRO_TORCH_FAULT_PLAN`` only."""
    root = Path(__file__).resolve().parents[1]
    code = ("from repro_torch.resilience import inject; "
            "print(inject.enabled())")
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_FAULT_PLAN", inject.ENV_FAULT_PLAN)}
    env["PYTHONPATH"] = str(root / "src")
    for var, want in (("REPRO_FAULT_PLAN", "False"),
                      (inject.ENV_FAULT_PLAN, "True")):
        out = subprocess.run([sys.executable, "-c", code],
                             env=dict(env, **{var: "seed=7;*=0.1"}), cwd=root,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == want, var


# ---------------------------------------------------------------------------
# a real failure is not a fault: it propagates, undemoted
# ---------------------------------------------------------------------------


def test_real_count_error_propagates_undemoted(graphs, monkeypatch):
    g = graphs[0]
    calls = []

    def broken(*args, **kwargs):
        calls.append(args)
        raise RuntimeError("launch failed: CUDA error 700")

    monkeypatch.setattr(dispatch.engine_torch, "count_packed", broken)
    stats = Stats()
    disp = dispatch.Dispatcher(3, ["cpu"], stats=stats)
    batch = next(b for b in pipeline.stream_batches(
        pipeline.cached_plan(g), 5, pack_workers=0)
        if isinstance(b, pipeline.TileBatch))
    inject.configure("seed=7;*=0.1")  # armed, and still no retry
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        disp.submit(batch)
    inject.configure(None)
    assert len(calls) == 1
    assert stats.retries == stats.demotions == 0


def test_real_list_error_propagates_undemoted(graphs, monkeypatch):
    g = graphs[0]

    def broken(*args, **kwargs):
        raise RuntimeError("launch failed: CUDA error 700")

    monkeypatch.setattr(dispatch.kops, "list_tiles", broken)
    for capacity in ("speculative", None):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            listing.stream_cliques(g, 5, listing.ArraySink(5),
                                   devices=["cpu"], capacity=capacity)


def test_cli_fault_plan_is_exact_and_disarmed_after(capsys):
    rc = clique.main(["--graph", "er:150,0.1", "--k", "4", "--device", "cpu",
                      "--devices", "2", "--verify", "--fault-plan",
                      "seed=7;*=0.2"])
    out = capsys.readouterr().out
    assert rc == 0 and "match=True" in out
    assert "fault injection: seed=7;*=0.2" in out
    assert not inject.enabled()
    rc = clique.main(["--graph", "er:150,0.1", "--k", "4", "--device", "cpu",
                      "--list", "--verify", "--fault-plan",
                      "kernel.launch=1.0"])
    out = capsys.readouterr().out
    assert rc == 0 and "match=True" in out and "demotions=0" not in out
    assert not inject.enabled()
