"""The port's training path held against the reference on the CPU.

``loss_fn`` and its grads, AdamW, the schedules, the LM data pipeline,
the gradient-accumulated train step of ``launch.steps`` and the
fault-tolerant ``TrainLoop``, on the reduced granite-3-8b (dense),
deepseek-moe-16b and dbrx-132b (MoE) configs with the reference's params
carried across (``repro_torch.convert.lm_params_to_torch``).

Tolerances (f32 on both sides):

* loss: rtol 1e-5 (observed equal to the last bit); grads: rtol 1e-4 /
  atol 1e-5 (summation order; observed below 2e-6 against grads of
  magnitude up to 1);
* AdamW on identical grads: rtol 1e-5 / atol 1e-7 on params and moments
  over three steps, ``count`` exact (observed below 2e-7);
* the train step against the reference's: the grads differ by summation
  order, and Adam's first steps move a param by about ``lr`` whatever
  the grad's size, so a grad near 0 may step the other way: params
  within atol 2 x the summed ``lr`` (6.0e-6 after two steps), moments
  within the grads' tolerance, loss and grad norm within rtol 1e-5.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ArchSpec as JArchSpec
from repro.data import LMDataPipeline as JPipeline
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch import configs
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs.base import ArchSpec
from repro_torch.convert import lm_params_to_torch
from repro_torch.data import LMDataPipeline
from repro_torch.launch import steps, train
from repro_torch.models import transformer as tr
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               global_norm, linear_schedule, tree_leaves,
                               tree_unflatten)
from repro_torch.runtime import TrainLoop, TrainLoopConfig

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-3-8b", "deepseek-moe-16b", "dbrx-132b")
GRAD = dict(rtol=1e-4, atol=1e-5)


def pair(arch, seed=0, **kw):
    """(reference cfg, port cfg, reference params, port params), f32."""
    jc = dataclasses.replace(jconfigs.get(arch).reduced, dtype=jnp.float32,
                             **kw)
    pc = dataclasses.replace(configs.get(arch).reduced, dtype=torch.float32,
                             **kw)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jc)
    return jc, pc, jp, to_torch(jp)


def to_torch(tree):
    return lm_params_to_torch(jax.tree.map(np.asarray, tree), "cpu")


def lm_batch(vocab, B=2, S=40, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return {"tokens": toks, "labels": labels}


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def close_trees(got, want, **tol):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        close(a.detach(), b, **tol)


# ---------------------------------------------------------------------------
# loss and grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    """A 40-token sequence in chunks of 16 (the last padded with masked
    labels), three labels masked: the loss and every grad."""
    jc, pc, jp, pp = pair(arch, remat=remat)
    batch = lm_batch(jc.vocab)
    jl, jg = jax.value_and_grad(lambda p: jtr.loss_fn(
        p, jax.tree.map(jnp.asarray, batch), jc, loss_chunk=16))(jp)
    leaves = tree_leaves(pp)
    for p in leaves:
        p.requires_grad_(True)
    pl = tr.loss_fn(pp, {k: torch.from_numpy(v) for k, v in batch.items()},
                    pc, loss_chunk=16)
    assert pl.dtype == torch.float32 and pl.shape == ()
    close(pl.detach(), jl, rtol=1e-5)
    close_trees(torch.autograd.grad(pl, leaves), jg, **GRAD)


def test_remat_recomputes_the_same_grads():
    """Checkpointed layers (and loss chunks) give the bits of the plain
    backward; without grad the loss needs no checkpoint."""
    _, pc, _, pp = pair("deepseek-moe-16b")
    batch = {k: torch.from_numpy(v)
             for k, v in lm_batch(pc.vocab, S=24).items()}
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(pc, remat=remat)
        leaves = [p.detach().clone().requires_grad_(True)
                  for p in tree_leaves(pp)]
        params = tree_unflatten(pp, leaves)
        loss = tr.loss_fn(params, batch, cfg, loss_chunk=8)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(tr.loss_fn(pp, batch, pc, loss_chunk=8),
                           loss.detach())


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_three_steps_match_reference(clip):
    """Three updates on identical grads (one clipped, with ``clip``), a
    cosine schedule, weight decay on the 2-d leaves only: params, mu, nu,
    count, grad norm and lr."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "deep": {"k": rng.standard_normal((3, 4, 2)).astype(
                  np.float32)}}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * s
                                     ).astype(np.float32), params)
             for s in (0.3, 2.0, 0.05)]
    jcfg = jadamw.AdamWConfig(lr=1e-2, clip_norm=clip,
                              schedule=jschedule.cosine_schedule(2, 10))
    pcfg = AdamWConfig(lr=1e-2, clip_norm=clip,
                       schedule=cosine_schedule(2, 10))
    jp = jax.tree.map(jnp.asarray, params)
    jo = jadamw.adamw_init(jp)
    pp = to_torch(params)
    po = adamw_init(pp)
    assert po["count"].dtype == torch.int32 and po["count"].shape == ()
    for g in grads:
        jp, jo, jm = jadamw.adamw_update(jax.tree.map(jnp.asarray, g), jo,
                                         jp, jcfg)
        pp, po, pm = adamw_update(to_torch(g), po, pp, pcfg)
        close_trees(pp, jp, rtol=1e-5, atol=1e-7)
        for k in ("mu", "nu"):
            close_trees(po[k], jo[k], rtol=1e-5, atol=1e-7)
        assert int(po["count"]) == int(jo["count"])
        close(pm["grad_norm"], jm["grad_norm"], rtol=1e-6)
        close(pm["lr"], jm["lr"], rtol=1e-6)


def test_global_norm_and_clip_match_reference():
    g = {"a": np.full((4,), 10.0, np.float32),
         "b": [np.arange(6, dtype=np.float32).reshape(2, 3)]}
    jc, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    pc, pn = clip_by_global_norm(to_torch(g), 1.0)
    close(pn, jn, rtol=1e-6)
    close(global_norm(to_torch(g)), jadamw.global_norm(g), rtol=1e-6)
    close_trees(pc, jc, rtol=1e-6)
    assert abs(float(global_norm(pc)) - 1.0) < 1e-5
    small, n = clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(small["a"], torch.full((4,), 0.1))


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    cfg = AdamWConfig(lr=0.3, weight_decay=0.0, clip_norm=None)
    opt = adamw_init(params)
    for _ in range(200):
        params, opt, _ = adamw_update({"w": 2 * params["w"]}, opt, params,
                                      cfg)
    assert float(params["w"].abs().max()) < 1e-2


@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_schedules_match_reference(name):
    args = (10, 100)
    jfn = getattr(jschedule, f"{name}_schedule")(*args)
    pfn = (cosine_schedule if name == "cosine" else linear_schedule)(*args)
    steps_ = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(steps_)))
    got = pfn(torch.from_numpy(steps_))
    close(got, want, rtol=1e-6, atol=1e-7)
    assert float(pfn(torch.tensor(0, dtype=torch.int32))) == 0.0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shard", [(0, 0), (7, 3)])
def test_lm_pipeline_byte_identical(seed, shard):
    """The port's pipeline gives the reference's bytes, step for step,
    and after a restore mid-stream."""
    kw = dict(vocab=300, batch=3, seq_len=17, seed=seed, shard_id=shard,
              num_shards=4)
    j, p = JPipeline(**kw), LMDataPipeline(**kw)
    for _ in range(3):
        a, b = j.next_batch(), p.next_batch()
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
    assert p.state() == j.state()
    p2, j2 = LMDataPipeline(**dict(kw, seed=99)), JPipeline(**kw)
    p2.restore(j.state())
    j2.restore(j.state())
    assert p2.next_batch()["tokens"].tobytes() == \
        j2.next_batch()["tokens"].tobytes()


# ---------------------------------------------------------------------------
# the train step, the loop, the launcher
# ---------------------------------------------------------------------------

def two_micro_cells(arch):
    """The reduced config as the 'full' one of a spec, and a train shape
    of B = 4, S = 32, so both packages run M = 2 microbatches."""
    jr = dataclasses.replace(jconfigs.get(arch).reduced, dtype=jnp.float32)
    pr = dataclasses.replace(configs.get(arch).reduced, dtype=torch.float32)
    jcell = dataclasses.replace(jconfigs.get(arch).cells["train_4k"],
                                dims=dict(seq_len=32, global_batch=4))
    pcell = dataclasses.replace(configs.get(arch).cells["train_4k"],
                                dims=dict(seq_len=32, global_batch=4))
    jspec = JArchSpec(arch, "lm", jr, jr, {"train_4k": jcell})
    pspec = ArchSpec(arch, "lm", pr, pr, {"train_4k": pcell})
    return (jsteps.lm_train_cell(jspec, jcell, None, microbatches=2),
            steps.lm_train_cell(pspec, pcell, microbatches=2), jr)


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-moe-16b"])
def test_train_step_with_two_microbatches_matches_reference(arch):
    jcell, ts, jr = two_micro_cells(arch)
    assert ts.microbatches == 2 and (ts.batch, ts.seq_len) == (4, 32)
    assert ts.meta == jcell.meta
    jp = jtr.init_params(jax.random.PRNGKey(0), jr)
    jo = jadamw.adamw_init(jp)
    pp, po = to_torch(jp), adamw_init(to_torch(jp))
    jstep = jax.jit(jcell.step_fn)
    pipe = JPipeline(vocab=jr.vocab, batch=4, seq_len=32, seed=3)
    lr_sum = 0.0
    for _ in range(2):
        batch = pipe.next_batch()
        jp, jo, jm = jstep(jp, jo, batch)
        pp, po, pm = ts.step_fn(pp, po, batch)
        close(pm["loss"], jm["loss"], rtol=1e-5)
        close(pm["grad_norm"], jm["grad_norm"], rtol=1e-5)
        close(pm["lr"], jm["lr"], rtol=1e-6)
        lr_sum += float(jm["lr"])
        for k in ("mu", "nu"):
            close_trees(po[k], jo[k], **GRAD)
        assert int(po["count"]) == int(jo["count"])
    close_trees(pp, jp, rtol=0, atol=2 * lr_sum)


def make_training(ckpt_dir):
    """The twin of ``tests/test_runtime.py``'s ``make_training``."""
    cfg = configs.get("granite-3-8b").reduced
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tr.init_params(gen, cfg, "cpu")
    ocfg = AdamWConfig(lr=1e-3)

    def step(params, opt, batch):
        loss, grads = steps.loss_and_grads(params, batch, cfg, 1)
        params, opt, m = adamw_update(grads, opt, params, ocfg)
        return params, opt, {"loss": loss, **m}

    pipe = LMDataPipeline(vocab=cfg.vocab, batch=2, seq_len=16)
    return step, params, adamw_init(params), pipe


def test_crash_resume_bitwise(tmp_path):
    """Kill at step 7, restart, final params match an uninterrupted run;
    the restored ``count`` is a 0-d int32 tensor."""
    d = str(tmp_path / "ck")
    loop = TrainLoop(TrainLoopConfig(total_steps=10, checkpoint_dir=None),
                     *make_training(None))
    loop.run()
    ref = loop.params
    loop2 = TrainLoop(
        TrainLoopConfig(total_steps=10, checkpoint_dir=d,
                        checkpoint_every=2, fail_at_step=7),
        *make_training(d))
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        loop2.run()
    loop3 = TrainLoop(TrainLoopConfig(total_steps=10, checkpoint_dir=d,
                                      checkpoint_every=2),
                      *make_training(d))
    assert loop3.step == 6
    count = loop3.opt_state["count"]
    assert count.dtype == torch.int32 and count.shape == () \
        and int(count) == 6
    loop3.run()
    for a, b in zip(tree_leaves(ref), tree_leaves(loop3.params)):
        assert torch.equal(a, b)
    assert int(loop3.opt_state["count"]) == 10


def launcher_env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-moe-16b"])
def test_train_launcher_runs_on_cpu(arch, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--steps", "3", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ck")],
        env=launcher_env(), cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("done at step 3 on cpu: {'loss': ")
    got = restore_checkpoint(str(tmp_path / "ck"))
    assert got["step"] == 3 and got["pipeline"]["step"] == 3
    assert int(got["tree"]["opt/count"]) == 3


def test_train_launcher_crash_then_resume_equals_uninterrupted(tmp_path):
    """``--fail-at 5 --ckpt-every 2`` raises; the same command without
    ``--fail-at`` resumes from step 4 and ends on an uninterrupted run's
    bits."""
    base = ["--arch", "deepseek-moe-16b", "--steps", "7", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert train.main(base + ["--ckpt-dir", a]) == 0
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        train.main(base + ["--ckpt-dir", b, "--ckpt-every", "2",
                           "--fail-at", "5"])
    assert restore_checkpoint(b)["step"] == 4
    assert train.main(base + ["--ckpt-dir", b, "--ckpt-every", "2"]) == 0
    want, got = restore_checkpoint(a), restore_checkpoint(b)
    assert want["step"] == got["step"] == 7
    assert set(want["tree"]) == set(got["tree"])
    for k, v in want["tree"].items():
        np.testing.assert_array_equal(got["tree"][k], v)


def test_train_launcher_rejects_ebbkc():
    """The clique engine's arch has no train step: the launcher exits."""
    with pytest.raises(SystemExit, match="'ebbkc' is 'clique'"):
        train.main(["--arch", "ebbkc", "--device", "cpu"])


def test_train_entry_points_raise_without_cuda(monkeypatch):
    """With CUDA reported absent, the launcher and the example twin raise
    instead of moving to the CPU."""
    import importlib.util
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "granite-3-8b", "--steps", "1"])
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--steps", "1"])


def test_train_lm_example_twin_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--steps", "25", "--device", "cpu"],
        env=launcher_env(), cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("model: ") and lines[0].endswith("on cpu")
    first = float(lines[-1].split("first loss ")[1].split(";")[0])
    final = float(lines[-1].split("loss=")[1].split(" ")[0])
    assert "finished at step 25" in lines[-1]
    assert final < first
