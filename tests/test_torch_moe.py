"""The port's MoE FFN held against the reference on the CPU.

The reduced deepseek-moe-16b (8 routed experts, top-2, 2 shared) and
dbrx-132b (4 experts, top-2, no shared) configs run in both packages on
the same weights: the reference's ``init_params`` draws them and
``repro_torch.convert.lm_params_to_torch`` carries them across.

Tolerances:

* f32 on both sides: rtol 1e-4 / atol 1e-5, identical greedy tokens.
  Both compute the same routing (stable top-k and sort), the same
  capacity drops and the same expert GEMMs; what is left is summation
  order (observed below 4e-6 on logits of magnitude up to 4.5).
* ``moe_ffn`` alone in bf16 on the same bf16 inputs: atol 0.0625, four
  bf16 ulps at the outputs' magnitude (below 4); the experts chosen are
  the same, and what differs is the reference's CPU backend rounding each
  step of the logistic in the silu to bf16 where torch rounds once (two
  ulps, 0.03125, observed).  The whole bf16 model is not compared:
  a one-ulp change of a router logit flips an expert choice.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.convert import lm_params_to_torch
from repro_torch.launch import serve
from repro_torch.models import transformer as tr

ARCHS = ("deepseek-moe-16b", "dbrx-132b")
F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 0.0625


def pair(arch, f32=True, seed=0, **moe):
    """(reference cfg, port cfg, reference params, port params); ``moe``
    replaces fields of both configs' ``MoEConfig``."""
    jc = jconfigs.get(arch).reduced
    pc = configs.get(arch).reduced
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        pc = dataclasses.replace(pc, moe=dataclasses.replace(pc.moe, **moe))
    if f32:
        jc = dataclasses.replace(jc, dtype=jnp.float32)
        pc = dataclasses.replace(pc, dtype=torch.float32)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jc)
    pp = lm_params_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jc, pc, jp, pp


def layer0(jp, pp):
    return (jax.tree.map(lambda a: a[0], jp["groups"]["global"]),
            {k: v[0] for k, v in pp["groups"]["global"].items()})


def hidden(cfg, T, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (T, cfg.d_model)).astype(np.float32)


def prompts(cfg, B=2, S=40, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def dispatch(jc, pc, jlp, plp, x):
    want = jtr._moe_dispatch_local(jnp.asarray(x), jlp, jc,
                                   jc.moe.n_experts, 0, None)
    got = tr._moe_dispatch_local(torch.from_numpy(x), plp, pc)
    return got, want


# ---------------------------------------------------------------------------
# f32 against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dispatch_matches_reference_f32(arch):
    jc, pc, jp, pp = pair(arch)
    got, want = dispatch(jc, pc, *layer0(jp, pp), hidden(jc, 48))
    close(got, want, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference_f32(arch):
    jc, pc, jp, pp = pair(arch)
    jlp, plp = layer0(jp, pp)
    x = hidden(jc, 2 * 24).reshape(2, 24, -1)
    want = jtr.moe_ffn(jnp.asarray(x), jlp, jc, jtr.ShardCtx())
    got = tr.moe_ffn(torch.from_numpy(x), plp, pc)
    assert got.shape == (2, 24, pc.d_model)
    close(got, want, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_f32(arch):
    jc, pc, jp, pp = pair(arch)
    toks = prompts(jc)
    want = jtr.forward(jp, jnp.asarray(toks), jc)
    got = tr.forward(pp, torch.from_numpy(toks), pc)
    assert got.shape == (2, 40, pc.padded_vocab)
    close(got, want, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_cache_match_reference_f32(arch):
    jc, pc, jp, pp = pair(arch)
    toks = prompts(jc)
    jlast, jcache = jtr.prefill(jp, jnp.asarray(toks), jc, max_len=48)
    plast, pcache = tr.prefill(pp, torch.from_numpy(toks), pc, max_len=48)
    close(plast, jlast, **F32)
    for kv in ("k", "v"):
        close(pcache["global"][kv], jcache["global"][kv], **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_reference_f32(arch):
    """Four greedy steps at T = B = 2 tokens a step: capacity 1 (deepseek)
    or 2 (dbrx) slots an expert, so decode drops assignments as the
    reference does; identical tokens, logits and caches within f32."""
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
    close(pcache["global"]["k"], jcache["global"]["k"], **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_generate_matches_reference_loop(arch):
    jc, pc, jp, pp = pair(arch)
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


# ---------------------------------------------------------------------------
# routing, capacity, bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference_bf16(arch):
    """bf16 on both sides from the same bf16 inputs: the same experts,
    outputs within :data:`BF16_ATOL`."""
    jc, pc, jp, pp = pair(arch, f32=False)
    assert pc.dtype == torch.bfloat16
    jlp, plp = layer0(jp, pp)
    x = hidden(jc, 48)
    jx = jnp.asarray(x, jnp.bfloat16)
    px = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    K = jc.moe.top_k
    jprobs = jax.nn.softmax(
        (jx @ jlp["router"].astype(jnp.bfloat16)).astype(jnp.float32), -1)
    _, ji = jax.lax.top_k(jprobs, K)
    _, pi = tr._route(px, plp["router"], K)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    want = jtr.moe_ffn(jx[None], jlp, jc, jtr.ShardCtx())
    got = tr.moe_ffn(px[None], plp, pc)
    assert got.dtype == torch.bfloat16
    close(got.float(), want, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_logits_pick_lax_top_k_experts(arch):
    """Router columns planted equal in pairs (and in the top pair): every
    token's logits tie exactly, and the port chooses ``lax.top_k``'s
    experts (the lower id first), so the dispatch output agrees too."""
    jc, pc, jp, pp = pair(arch)
    jlp, plp = layer0(jp, pp)
    E, K = jc.moe.n_experts, jc.moe.top_k
    router = np.array(jlp["router"])
    router[:, 1::2] = router[:, 0::2]           # experts 2i, 2i+1 tie
    jlp = dict(jlp, router=jnp.asarray(router))
    plp = dict(plp, router=torch.from_numpy(router))
    x = hidden(jc, 32, seed=5)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1)
    jw, ji = jax.lax.top_k(probs, K)
    pw, pi = tr._route(torch.from_numpy(x), plp["router"], K)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert (pi[:, 0] % 2 == 0).all() and (pi[:, 1] == pi[:, 0] + 1).all()
    close(pw, jw / jw.sum(-1, keepdims=True), **F32)
    # torch.topk gives no order for ties; the stable sort does
    got, want = dispatch(jc, pc, jlp, plp, x)
    close(got, want, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_tight_capacity_drops_match_reference(arch):
    """``capacity_factor=0.5``: half the slots an even split needs, so
    assignments drop; the port drops the same ones (the outputs agree,
    and the tokens that lost every routed assignment agree)."""
    jc, pc, jp, pp = pair(arch, capacity_factor=0.5)
    jlp, plp = layer0(jp, pp)
    x = hidden(jc, 40, seed=2)
    got, want = dispatch(jc, pc, jlp, plp, x)
    close(got, want, **F32)
    lost = np.asarray(want == 0).all(-1)
    np.testing.assert_array_equal((got == 0).all(-1).numpy(), lost)
    assert lost.any()
    T, K, E = 40, jc.moe.top_k, jc.moe.n_experts
    assert tr.capacity(pc.moe, T) == int(max(1, -(-T * K * 0.5 // E)))
    # the model on top agrees as well
    toks = prompts(jc, S=24)
    close(tr.forward(pp, torch.from_numpy(toks), pc),
          jtr.forward(jp, jnp.asarray(toks), jc), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_routed_output_equals_dense_expert_sum(arch):
    """``top_k == n_experts`` and ample capacity: the routed output is
    the softmax-weighted sum of every expert's FFN."""
    E = configs.get(arch).reduced.moe.n_experts
    _, pc, jp, pp = pair(arch, top_k=E, capacity_factor=float(E))
    _, plp = layer0(jp, pp)
    x = torch.from_numpy(hidden(pc, 12, seed=3))
    got = tr._moe_dispatch_local(x, plp, pc)
    w = torch.softmax(x @ plp["router"], -1)
    ref = torch.zeros_like(x)
    for e in range(E):
        h = torch.nn.functional.silu(x @ plp["we1"][e]) * (x @ plp["we3"][e])
        ref += w[:, e:e + 1] * (h @ plp["we2"][e])
    close(got, ref, rtol=1e-4, atol=1e-5)


def test_capacity_follows_the_reference_formula():
    """C = int(max(1, -(-T * K * cf // E))): at deepseek-moe-16b's full
    width 30 slots at a 8 x 32 prefill, 31 for forward on prompt + 1
    token, 1 at a decode step of 8 requests; dropless when cf = E / K."""
    moe = configs.get("deepseek-moe-16b").full.moe
    assert [tr.capacity(moe, T) for T in (256, 264, 8)] == [30, 31, 1]
    dropless = dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k)
    assert all(tr.capacity(dropless, T) == T for T in (1, 8, 256, 264))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dispatch_is_deterministic_and_backpropagates(arch):
    """Two runs give the same bits (a fixed combine order), and grads
    reach the router, the experts and the input."""
    _, pc, _, pp = pair(arch)
    plp = {k: v[0].clone().requires_grad_(True)
           for k, v in pp["groups"]["global"].items()}
    x = torch.from_numpy(hidden(pc, 24)).requires_grad_(True)
    a = tr._moe_dispatch_local(x, plp, pc)
    b = tr._moe_dispatch_local(x, plp, pc)
    assert torch.equal(a, b)
    a.square().sum().backward()
    for name in ("router", "we1", "we2", "we3"):
        assert plp[name].grad is not None and plp[name].grad.abs().sum() > 0
    assert x.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_and_param_counts_match_reference(arch):
    for which in ("full", "reduced"):
        jf = getattr(jconfigs.get(arch), which)
        pf = getattr(configs.get(arch), which)
        for f in dataclasses.fields(jf):
            if f.name not in ("dtype", "moe"):
                assert getattr(pf, f.name) == getattr(jf, f.name), f.name
        assert dataclasses.asdict(pf.moe) == dataclasses.asdict(jf.moe)
        assert pf.num_params() == jf.num_params()
        assert pf.active_params() == jf.active_params()
    spec, jspec = configs.get(arch), jconfigs.get(arch)
    assert spec.family == "lm"
    assert {n: dataclasses.asdict(c) for n, c in spec.cells.items()} == {
        n: dataclasses.asdict(c) for n, c in jspec.cells.items()}
    if arch == "deepseek-moe-16b":     # 62.88 GiB of f32 params
        assert spec.full.num_params() == 16_879_568_896
        assert spec.full.padded_vocab == spec.full.vocab == 102_400


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_keys_and_shapes_match_reference(arch):
    gen = torch.Generator()
    gen.manual_seed(0)
    cfg = configs.get(arch).reduced
    params = tr.init_params(gen, cfg, "cpu")
    jparams = jtr.init_params(jax.random.PRNGKey(0),
                              jconfigs.get(arch).reduced)
    stack, jstack = params["groups"]["global"], jparams["groups"]["global"]
    assert set(stack) == set(jstack)
    assert not {"w1", "w2", "w3"} & set(stack)
    assert ({"ws1", "ws2", "ws3"} <= set(stack)) == bool(cfg.moe.n_shared)
    for name, w in jstack.items():
        assert tuple(stack[name].shape) == w.shape
        assert stack[name].dtype == torch.float32
    n = sum(x.numel() for x in [params["embed"], params["head"],
                                params["final_ln"], *stack.values()])
    assert n == cfg.num_params() + 2 * cfg.d_model * (
        cfg.padded_vocab - cfg.vocab)


def test_convert_carries_moe_keys_and_integer_leaves():
    """The MoE keys go across key for key; an integer leaf (AdamW's 0-d
    int32 ``count``) keeps its dtype."""
    _, pc, jp, pp = pair("deepseek-moe-16b")
    for name, w in jp["groups"]["global"].items():
        np.testing.assert_array_equal(pp["groups"]["global"][name].numpy(),
                                      np.asarray(w))
    tree = lm_params_to_torch({"count": np.int32(3),
                               "mu": {"a": np.ones((2, 2), np.float64)}},
                              "cpu")
    assert tree["count"].dtype == torch.int32 and int(tree["count"]) == 3
    assert tree["count"].shape == ()
    assert tree["mu"]["a"].dtype == torch.float32
