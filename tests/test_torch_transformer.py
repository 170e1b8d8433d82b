"""The port's dense-LM serving path held against the reference on the CPU.

The reduced granite-3-8b, nemotron-4-15b and gemma3-27b configs (the
last with 5:1 local:global layers and a 16-token window) run in both
packages on the same weights: the reference's ``init_params`` draws them
and ``repro_torch.convert.lm_params_to_torch`` carries them across.

Tolerances:

* f32 on both sides (``dtype`` replaced by float32): logits and KV caches
  within rtol 1e-4 / atol 1e-5.  Both packages compute the same f32
  formulas; what is left is summation order (observed below 6e-6 on
  logits of magnitude up to 4.7).  Greedy tokens must be identical.
* bf16 (the configs' own dtype): atol 5e-2 for nemotron (squared ReLU,
  exact elementwise in both packages, so only matmul / attention / norm
  rounding is left; observed 0.049).  granite (silu) and gemma3 (tanh
  gelu) get atol 1e-1: the reference's CPU backend rounds every step of
  the logistic (1 / (1 + exp(-x))) and of the tanh approximation to bf16,
  where torch rounds each activation once, so 30-40 % of the activations
  differ by one bf16 ulp and the logits by up to 0.078 (observed).
  Computing anything in a lower precision than bf16 (fp8: 3 mantissa
  bits) moves the logits by far more than either bound.
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
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.convert import lm_params_to_torch
from repro_torch.launch import serve
from repro_torch.models import common
from repro_torch.models import transformer as tr

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-3-8b", "nemotron-4-15b", "gemma3-27b")
F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = {"nemotron-4-15b": 5e-2, "granite-3-8b": 1e-1,
             "gemma3-27b": 1e-1}


def pair(arch, f32=True, seed=0):
    """(reference cfg, port cfg, reference params, port params)."""
    jc = jconfigs.get(arch).reduced
    pc = configs.get(arch).reduced
    if f32:
        jc = dataclasses.replace(jc, dtype=jnp.float32)
        pc = dataclasses.replace(pc, dtype=torch.float32)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jc)
    pp = lm_params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jc, pc, jp, pp


def prompts(cfg, B=2, S=40, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def cells(spec):
    return {name: dataclasses.asdict(c) for name, c in spec.cells.items()}


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_f32(arch):
    jc, pc, jp, pp = pair(arch)
    toks = prompts(jc)
    want = jtr.forward(jp, jnp.asarray(toks), jc)
    got = tr.forward(pp, torch.from_numpy(toks), pc)
    assert got.shape == (2, 40, pc.padded_vocab)
    assert got.dtype == torch.float32
    close(got, want, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_cache_match_reference_f32(arch):
    jc, pc, jp, pp = pair(arch)
    toks = prompts(jc)
    jlast, jcache = jtr.prefill(jp, jnp.asarray(toks), jc, max_len=48)
    plast, pcache = tr.prefill(pp, torch.from_numpy(toks), pc, max_len=48)
    close(plast, jlast, **F32)
    assert set(pcache) == set(jcache)
    for kind in jcache:
        for kv in ("k", "v"):
            assert tuple(pcache[kind][kv].shape) == jcache[kind][kv].shape
            close(pcache[kind][kv], jcache[kind][kv], **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_reference_f32(arch):
    """Four greedy steps: identical tokens, logits and caches within the
    f32 tolerance (gemma3's 16-slot local buffers roll over)."""
    jc, pc, jp, pp = pair(arch)
    toks = prompts(jc)
    jlast, jcache = jtr.prefill(jp, jnp.asarray(toks), jc, max_len=48)
    plast, pcache = tr.prefill(pp, torch.from_numpy(toks), pc, max_len=48)
    jlen = jnp.full((2,), 40, jnp.int32)
    plen = torch.full((2,), 40)
    for _ in range(4):
        jn = jnp.argmax(jlast, -1)[:, None]
        pn = torch.argmax(plast, -1)[:, None]
        np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
        jlast, jcache = jtr.decode_step(jp, jcache, jn, jlen, jc)
        plast, pcache = tr.decode_step(pp, pcache, pn, plen, pc)
        jlen, plen = jlen + 1, plen + 1
        close(plast, jlast, **F32)
    for kind in jcache:
        close(pcache[kind]["k"], jcache[kind]["k"], **F32)
        close(pcache[kind]["v"], jcache[kind]["v"], **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_bf16(arch):
    jc, pc, jp, pp = pair(arch, f32=False)
    assert pc.dtype == torch.bfloat16
    toks = prompts(jc)
    want = jtr.forward(jp, jnp.asarray(toks), jc)
    got = tr.forward(pp, torch.from_numpy(toks), pc)
    close(got, want, rtol=0, atol=BF16_ATOL[arch])


def test_serve_generate_matches_reference_loop():
    """``launch.serve.generate`` on the reference's weights gives the
    reference serve loop's tokens (f32)."""
    jc, pc, jp, pp = pair("gemma3-27b")
    toks = prompts(jc, B=3, S=20)
    n = 6
    logits, cache = jtr.prefill(jp, jnp.asarray(toks), jc, max_len=20 + n)
    nxt = jnp.argmax(logits, -1)[:, None]
    lengths = jnp.full((3,), 20, jnp.int32)
    want = [nxt]
    for _ in range(n - 1):
        logits, cache = jtr.decode_step(jp, cache, nxt, lengths, jc)
        nxt = jnp.argmax(logits, -1)[:, None]
        lengths = lengths + 1
        want.append(nxt)
    out = serve.generate(pp, torch.from_numpy(toks), pc, n)
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.asarray(jnp.concatenate(want, 1)))
    assert out.prefill_s > 0 and out.decode_s > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_vocab_logits_and_loss_match_reference(arch):
    """Logits span the padded vocab; the port's cross-entropy over them
    equals the reference's sequence-chunked ``loss_fn`` (f32)."""
    jc, pc, jp, pp = pair(arch)
    assert pc.padded_vocab == jc.padded_vocab
    assert pc.padded_vocab % 512 == 0 and pc.padded_vocab >= pc.vocab
    toks = prompts(jc, S=16)
    labels = toks.copy()
    labels[:, :3] = -100
    want = jtr.loss_fn(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)}, jc)
    logits = tr.forward(pp, torch.from_numpy(toks), pc)
    got = common.cross_entropy_loss(logits, torch.from_numpy(labels))
    assert torch.isfinite(got)
    close(got, want, rtol=1e-5, atol=1e-5)


def test_full_configs_and_param_counts_match_reference():
    for arch in ARCHS:
        jf, pf = jconfigs.get(arch).full, configs.get(arch).full
        for f in dataclasses.fields(jf):
            if f.name != "dtype":
                assert getattr(pf, f.name) == getattr(jf, f.name), f.name
        assert pf.dtype == torch.bfloat16
        assert pf.padded_vocab == jf.padded_vocab
        assert pf.layer_groups == jf.layer_groups
        assert pf.num_params() == jf.num_params()
        assert pf.active_params() == jf.active_params()
        assert cells(configs.get(arch)) == cells(jconfigs.get(arch))
    assert configs.get("granite-3-8b").full.padded_vocab == 49_664


def test_common_blocks_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    bias = rng.standard_normal(16).astype(np.float32) * 0.1
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    close(common.rms_norm(tx, ts), jcommon.rms_norm(x, scale), **F32)
    close(common.layer_norm(tx, ts, tb),
          jcommon.layer_norm(x, scale, bias), **F32)
    for name in ("silu", "gelu", "relu", "squared_relu"):
        close(common.act_fn(name)(tx), jcommon.act_fn(name)(x), **F32)
    with pytest.raises(ValueError):
        common.act_fn("swish")
    pos = np.arange(5)[None, :]
    close(common.rope_frequencies(16), jcommon.rope_frequencies(16), **F32)
    close(common.apply_rope(tx, torch.from_numpy(pos), 500.0),
          jcommon.apply_rope(x, pos, 500.0), **F32)
    mlp = jcommon.init_mlp(jax.random.PRNGKey(0), (16, 8, 4))
    pm = lm_params_to_torch(jax.tree.map(np.asarray, mlp), "cpu")
    assert isinstance(pm, list) and set(pm[0]) == {"w", "b"}
    close(common.apply_mlp(pm, tx, act="gelu", final_act=True),
          jcommon.apply_mlp(mlp, x, act="gelu", final_act=True), **F32)
    logits = rng.standard_normal((2, 6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (2, 6))
    labels[0, 0] = -100
    close(common.cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels), z_loss=1e-3),
          jcommon.cross_entropy_loss(logits, labels, z_loss=1e-3), **F32)


def test_initialisers_are_seeded_and_shaped():
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    a = common.normal_init(g1, (300, 200), 0.5, "cpu")
    b = common.normal_init(g2, (300, 200), 0.5, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert abs(float(a.std()) - 0.5) < 0.01
    u = common.uniform_init(g1, (1000,), 0.2, "cpu")
    assert float(u.abs().max()) <= 0.2
    w = common.dense_init(g1, 64, 8, "cpu")
    assert w.shape == (64, 8)
    mlp = common.init_mlp(g1, (4, 6, 2), "cpu")
    assert [p["w"].shape for p in mlp] == [(4, 6), (6, 2)]
    cfg = configs.get("gemma3-27b").reduced
    params = tr.init_params(g1, cfg, "cpu")
    jparams = jtr.init_params(jax.random.PRNGKey(0),
                              jconfigs.get("gemma3-27b").reduced)
    for kind, stack in jparams["groups"].items():
        assert set(params["groups"][kind]) == set(stack)
        for name, w in stack.items():
            assert tuple(params["groups"][kind][name].shape) == w.shape
            assert params["groups"][kind][name].dtype == torch.float32
    for name in ("embed", "final_ln", "head"):
        assert tuple(params[name].shape) == jparams[name].shape


# ---------------------------------------------------------------------------
# the port's own checks (mirroring tests/test_transformer.py)
# ---------------------------------------------------------------------------

def tiny_cfg(**kw):
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_head=8, d_ff=64, vocab=64, q_block=8)
    base.update(kw)
    return tr.TransformerConfig(**base)


def tiny_params(cfg, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return tr.init_params(gen, cfg, "cpu")


def tiny_tokens(shape, vocab, seed=1):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen)


def test_chunked_equals_full_attention():
    cfg_c, cfg_f = tiny_cfg(q_block=8), tiny_cfg(q_block=64)
    p = tiny_params(cfg_c)
    t = tiny_tokens((2, 24), 64)
    close(tr.forward(p, t, cfg_c), tr.forward(p, t, cfg_f),
          rtol=2e-5, atol=2e-5)


def test_chunked_local_window_equals_full_attention():
    """A padded last block and clipped window starts give the unblocked
    local attention (f32)."""
    kw = dict(local_window=5, local_per_global=100, n_layers=2,
              dtype=torch.float32)
    cfg_c, cfg_f = tiny_cfg(q_block=7, **kw), tiny_cfg(q_block=64, **kw)
    p = tiny_params(cfg_c)
    t = tiny_tokens((2, 30), 64)
    close(tr.forward(p, t, cfg_c), tr.forward(p, t, cfg_f),
          rtol=1e-5, atol=1e-5)


def test_sliding_window_masks_far_tokens():
    """A local layer's output at position i must not depend on tokens
    further back than the window."""
    cfg = tiny_cfg(local_window=4, local_per_global=100, n_layers=1,
                   q_block=8)
    p = tiny_params(cfg, seed=2)
    t1 = tiny_tokens((1, 16), 64, seed=3)
    t2 = t1.clone()
    t2[0, 0] = (t1[0, 0] + 7) % 64  # mutate a far-away token
    o1, o2 = tr.forward(p, t1, cfg), tr.forward(p, t2, cfg)
    close(o1[0, -1], o2[0, -1], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(o1[0, 0], o2[0, 0])


@pytest.mark.parametrize("local", [False, True])
def test_prefill_decode_match_forward(local):
    kw = dict(local_window=8, local_per_global=1) if local else {}
    cfg = tiny_cfg(n_layers=4, q_block=64, **kw)
    p = tiny_params(cfg)
    t = tiny_tokens((2, 12), 64)
    last, cache = tr.prefill(p, t, cfg, max_len=20)
    full = tr.forward(p, t, cfg)
    close(last, full[:, -1], rtol=2e-5, atol=2e-5)
    # three greedy decode steps must match teacher forcing
    lengths = torch.full((2,), 12)
    toks = t
    for _ in range(3):
        nxt = torch.argmax(last, -1)[:, None]
        last, cache = tr.decode_step(p, cache, nxt, lengths, cfg)
        toks = torch.cat([toks, nxt], dim=1)
        lengths = lengths + 1
        close(last, tr.forward(p, toks, cfg)[:, -1], rtol=3e-4, atol=3e-4)


def test_layer_groups_put_local_before_global():
    cfg = configs.get("gemma3-27b").full
    assert cfg.layer_groups == [("local", 52), ("global", 10)]
    assert tiny_cfg(groups_override=(("global", 1), ("local", 1)),
                    local_window=4).layer_groups == [("global", 1),
                                                     ("local", 1)]


def test_moe_config_raises_not_implemented():
    """An MoE config, which raised before its FFN was ported, now draws
    the MoE keys in place of the dense FFN's and runs: prefill equals
    forward's last position, and a dropless decode step equals forward on
    the prompt plus that token (f32)."""
    moe = tr.MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=16,
                       capacity_factor=2.0)     # E / K: nothing drops
    cfg = tiny_cfg(moe=moe, dtype=torch.float32, q_block=64)
    assert cfg.active_params() < cfg.num_params()
    p = tiny_params(cfg)
    stack = p["groups"]["global"]
    assert {"router", "we1", "we3", "we2", "ws1", "ws3", "ws2"} <= set(stack)
    assert not {"w1", "w2", "w3"} & set(stack)
    t = tiny_tokens((2, 12), 64)
    last, cache = tr.prefill(p, t, cfg, max_len=16)
    close(last, tr.forward(p, t, cfg)[:, -1], rtol=1e-5, atol=1e-5)
    nxt = torch.argmax(last, -1)[:, None]
    step, _ = tr.decode_step(p, cache, nxt, torch.full((2,), 12), cfg)
    close(step, tr.forward(p, torch.cat([t, nxt], 1), cfg)[:, -1],
          rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# registry and launcher
# ---------------------------------------------------------------------------

A13D_ARCHS = ["dcn-v2", "egnn", "gin-tu", "meshgraphnet", "nequip"]


@pytest.mark.parametrize("arch", A13D_ARCHS)
def test_registry_resolves_gnn_and_recsys_arch_as_reference(arch):
    """Family, cells and every field of the full and reduced configs
    equal the reference's (the port's config classes keep its fields)."""
    spec, jspec = configs.get(arch), jconfigs.get(arch)
    assert (spec.name, spec.family) == (jspec.name, jspec.family)
    assert spec.family == ("recsys" if arch == "dcn-v2" else "gnn")
    assert cells(spec) == cells(jspec)
    for which in ("full", "reduced"):
        mine, ref = getattr(spec, which), getattr(jspec, which)
        assert type(mine).__name__ == type(ref).__name__
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    if arch == "dcn-v2":
        assert spec.full.d_x0 == jspec.full.d_x0 == 429


def test_registry_resolves_ported_archs():
    assert set(configs._MODULES) == set(jconfigs._MODULES)
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert configs.UNPORTED == {}
    specs = configs.all_specs()
    assert set(specs) == set(jconfigs._MODULES)
    assert {specs[a].full.moe.n_experts for a in
            ("deepseek-moe-16b", "dbrx-132b")} == {64, 16}
    assert sorted(a for a in specs if specs[a].family in
                  ("gnn", "recsys")) == A13D_ARCHS
    assert specs["ebbkc"].family == "clique"
    assert cells(specs["ebbkc"]) == cells(jconfigs.get("ebbkc"))
    with pytest.raises(KeyError):
        configs.get("llama-7b")


def test_ebbkc_config_imports_no_model():
    code = ("import sys\nfrom repro_torch import configs\n"
            "configs.get('ebbkc')\n"
            "print(any(m.startswith('repro_torch.models') "
            "for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma3-27b",
                                  "deepseek-moe-16b"])
def test_serve_launcher_runs_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--requests", "3", "--prompt-len", "20", "--tokens", "5",
         "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("served 3 requests x 5 tokens in ")
    assert "tok/s) on cpu" in lines[0]
    assert lines[1].startswith("sample:")


def test_serve_launcher_rejects_non_lm_arch():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "ebbkc", "--device", "cpu"])
