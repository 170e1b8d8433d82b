"""Row order of the port's ListDispatcher vs the JAX reference, on the CPU.

``listing.stream_cliques(devices=["cpu"] * n)`` must give the reference's
``stream_cliques(devices=[jax.devices()[0]] * n, backend="lax")`` rows
array-equal, order included, in every capacity mode (sized, speculative,
a pinned int), with forced overflow and forced spill.  Then, as the
reference's ``tests/test_determinism.py`` and ``tests/test_dispatch.py``
do, the adversarial schedules: the readiness probe ``dispatch._is_ready``
is monkeypatched (always, never, seeded flaky) and swept with pack-worker
counts, synchronous staging and a one-batch in-flight window; the rows
must not change.  Exact comparison (tolerance 0): rows are integers.
"""
import jax
import numpy as np
import pytest

from repro.core import listing as jlisting
from repro.data import graphs as jgraphs
from repro_torch.core import listing, pipeline
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import ops
from repro_torch.runtime import dispatch as dsp

JDEV = jax.devices()[0]
_REAL_IS_READY = dsp._is_ready
CAPACITIES = (None, "sized", "speculative", 8)


def _flaky_probe(seed: int):
    rnd = np.random.default_rng(seed)
    return lambda event: bool(rnd.random() < 0.5) and _REAL_IS_READY(event)


def _rows(k, graph="rmat", **kwargs):
    g = (tgraphs.rmat_graph(8, 4, seed=7) if graph == "rmat" else
         tgraphs.planted_cliques(140, 2, 40, p_noise=0.02, seed=3))
    sink = listing.ArraySink(k, max_out=kwargs.pop("max_out", None))
    res = listing.stream_cliques(g, k, sink, **kwargs)
    return sink.result(), res.stats


def _jax_rows(k, graph="rmat", n=2, **kwargs):
    g = (jgraphs.rmat_graph(8, 4, seed=7) if graph == "rmat" else
         jgraphs.planted_cliques(140, 2, 40, p_noise=0.02, seed=3))
    sink = jlisting.ArraySink(k)
    jlisting.stream_cliques(g, k, sink, devices=[JDEV] * n, backend="lax",
                            **kwargs)
    return sink.result()


@pytest.fixture(scope="module")
def want():
    """The reference's rows at batch_size=16, two lanes, exact sizing."""
    return {k: _jax_rows(k, batch_size=16) for k in (4, 5)}


@pytest.mark.parametrize("k", [4, 5])
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_rows_match_reference_in_every_capacity_mode(want, k, capacity):
    ref = _jax_rows(k, batch_size=16, capacity=capacity)
    np.testing.assert_array_equal(ref, want[k])
    for n in (1, 2, 4):
        got, stats = _rows(k, devices=["cpu"] * n, batch_size=16,
                           capacity=capacity)
        np.testing.assert_array_equal(got, ref)
        assert stats.emitted_cliques == ref.shape[0]
        assert sum(stats.device_tiles.values()) > 0


@pytest.mark.parametrize("capacity", [2, "speculative"])
def test_forced_overflow_matches_reference(capacity):
    """capacity=2, or a speculative ratchet capped at max_capacity=4:
    tiles overflow and are relisted on the host, spliced back in order."""
    ref = _jax_rows(4, batch_size=16, capacity=capacity, max_capacity=4)
    got, stats = _rows(4, devices=["cpu"] * 2, batch_size=16,
                       capacity=capacity, max_capacity=4)
    np.testing.assert_array_equal(got, ref)
    assert stats.overflowed_tiles > 0


def test_forced_spill_matches_reference():
    """bins=(32,) spills the planted 40-cliques' tiles to the host; their
    rows go through the decode worker in stream order."""
    ref = _jax_rows(4, graph="planted", bins=(32,))
    got, stats = _rows(4, graph="planted", devices=["cpu"] * 2, bins=(32,))
    np.testing.assert_array_equal(got, ref)
    assert stats.spilled_tiles > 0


@pytest.mark.parametrize("probe", ["never", "always", "flaky3", "flaky11"])
def test_rows_do_not_depend_on_readiness(monkeypatch, want, probe):
    """Sweep readiness schedules x pack workers x staging x window size x
    capacity mode: identical arrays, not merely identical sets."""
    monkeypatch.setattr(dsp, "_is_ready", {
        "never": lambda event: False, "always": lambda event: True,
        "flaky3": _flaky_probe(3), "flaky11": _flaky_probe(11)}[probe])
    configs = [
        dict(devices=["cpu"] * 2, pack_workers=0),
        dict(devices=["cpu"] * 4, pack_workers=2),
        dict(devices=["cpu"] * 2, pack_workers=3, async_staging=False),
        dict(devices=["cpu"], pack_workers=3, max_inflight=1),
        dict(devices=["cpu"] * 2, pack_workers=2, capacity="sized"),
        dict(devices=["cpu"] * 2, pack_workers=2, capacity="speculative",
             max_inflight=1),
    ]
    for cfg in configs:
        got, stats = _rows(4, batch_size=16, **cfg)
        np.testing.assert_array_equal(got, want[4], err_msg=str(cfg))
        assert stats.emitted_cliques == want[4].shape[0]


def test_speculative_retries_are_invisible(monkeypatch, want):
    """A one-row first guess forces device retries: rows unchanged, the
    retries counted, and the ratchet keeps them below the batch count."""
    monkeypatch.setattr(dsp, "SPECULATIVE_CAP0", 1)
    got, stats = _rows(4, devices=["cpu"] * 2, pack_workers=2,
                       batch_size=16, capacity="speculative")
    np.testing.assert_array_equal(got, want[4])
    assert stats.emit_retries > 0
    assert stats.overflowed_tiles == 0  # retried on the lane, not the host
    n_batches = sum(isinstance(b, pipeline.TileBatch)
                    for b in pipeline.stream_batches(
                        tgraphs.rmat_graph(8, 4, seed=7), 4, batch_size=16))
    assert stats.emit_retries < n_batches


def test_bounded_sink_stops_early(want):
    got, stats = _rows(4, devices=["cpu"] * 2, pack_workers=2,
                       batch_size=16, max_out=5)
    np.testing.assert_array_equal(got, want[4][:5])


def test_failures_raise_out_of_stream_cliques(monkeypatch):
    """A failing sink write (on the decode worker) and a failing kernel
    launch both raise out of stream_cliques: close() in its finally stops
    the worker without swallowing the error, and nothing falls back."""

    class Broken(listing.CliqueSink):
        def emit(self, cliques):
            raise OSError("sink failed")

    g = tgraphs.rmat_graph(8, 4, seed=7)
    with pytest.raises(OSError, match="sink failed"):
        listing.stream_cliques(g, 4, Broken(), devices=["cpu"] * 2,
                               batch_size=16)

    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ops, "list_tiles", broken)
    for capacity in (None, "speculative"):
        with pytest.raises(RuntimeError, match="launch failed"):
            listing.stream_cliques(g, 4, listing.ArraySink(4),
                                   devices=["cpu"] * 2, batch_size=16,
                                   capacity=capacity)
