"""The 22 smoke cells of ``tests/test_models_smoke.py`` through the port's
``build_cell(..., mesh=None, reduced=True)`` on the CPU, each against the
reference's jitted ``build_cell(...).step_fn`` on the same inputs.

The inputs are the reference smoke test's: every leaf of the abstract
arguments drawn from a seed in numpy (integers in {0, 1}, floats
``|normal| x 0.02``; the clique cell's tiles are symmetric adjacency
words with random candidates, the engine's input contract), then handed
to both packages with the same values.  Tolerances, by family, are the
existing parity tests':

* LM cells run their configs' own dtype, bf16: the last-position
  logits within ``tests/test_torch_transformer.py``'s ``BF16_ATOL`` of
  the arch (``tests/test_torch_moe.py``'s ``BF16_ATOL`` for the MoE
  archs); train cells compare ``loss`` and ``grad_norm`` within
  ``chip_smoke.py``'s ``TRAIN_REL`` (rtol 5e-3 and 5e-2: its bf16 train
  step against f32; observed below 4e-5 and 3e-4), ``lr`` rtol 1e-6 and
  the updated params within 2 x lr, as ``tests/test_torch_train.py``
  does.
* GNN and recsys train cells: ``tests/test_torch_gnn.py`` /
  ``tests/test_torch_recsys.py``'s step check: loss and grad norm rtol
  1e-5, lr rtol 1e-6, params within 2 x lr; serve logits within their
  ``FWD`` (rtol 1e-5, atol 1e-6), retrieval indices equal.
* ``ep_*`` cells: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_cases as cases
from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.optim import tree_leaves, tree_unflatten

SMOKE_CELLS = [
    ("deepseek-moe-16b", "train_4k"),
    ("deepseek-moe-16b", "decode_32k"),
    ("dbrx-132b", "train_4k"),
    ("dbrx-132b", "prefill_32k"),
    ("gemma3-27b", "train_4k"),
    ("gemma3-27b", "long_500k"),
    ("nemotron-4-15b", "train_4k"),
    ("nemotron-4-15b", "decode_32k"),
    ("granite-3-8b", "train_4k"),
    ("granite-3-8b", "prefill_32k"),
    ("gin-tu", "full_graph_sm"),
    ("gin-tu", "molecule"),
    ("nequip", "molecule"),
    ("nequip", "minibatch_lg"),
    ("meshgraphnet", "full_graph_sm"),
    ("meshgraphnet", "molecule"),
    ("egnn", "molecule"),
    ("egnn", "ogb_products"),
    ("dcn-v2", "train_batch"),
    ("dcn-v2", "serve_p99"),
    ("dcn-v2", "retrieval_cand"),
    ("ebbkc", "ep_tri_1m"),
]

# tests/test_torch_transformer.py's BF16_ATOL, tests/test_torch_moe.py's
LM_ATOL = {"nemotron-4-15b": 5e-2, "granite-3-8b": 1e-1, "gemma3-27b": 1e-1,
           "deepseek-moe-16b": 0.0625, "dbrx-132b": 0.0625}
# chip_smoke.py's TRAIN_REL: a bf16 train step's loss and grad norm
TRAIN_REL = {"loss": 5e-3, "grad_norm": 5e-2}
# tests/test_torch_gnn.py / test_torch_recsys.py
FWD = dict(rtol=1e-5, atol=1e-6)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def materialize(jcell, pcell, seed):
    """The same numpy values as the reference's and the port's
    arguments."""
    rng = np.random.default_rng(seed)
    jl, tdef = jax.tree.flatten(jcell.abstract_args)
    pabs = list(pcell.abstract_args)
    pl = tree_leaves(pabs)
    assert len(jl) == len(pl)
    if pcell.meta.get("method"):
        vals = list(cases.clique_inputs(*jl[0].shape[:2]))
    else:
        vals = []
        for s in jl:
            if jnp.issubdtype(s.dtype, jnp.integer):
                vals.append(rng.integers(0, 2, s.shape))
            else:
                vals.append(np.abs(rng.normal(size=s.shape) * 0.02))
    jargs, pargs = [], []
    for v, s, p in zip(vals, jl, pl):
        assert tuple(s.shape) == tuple(p.shape)
        jargs.append(jnp.asarray(v).astype(s.dtype))
        if p.dtype == torch.int32 and s.dtype == jnp.uint32:
            pargs.append(torch.from_numpy(np.asarray(v, np.uint32)
                                          .view(np.int32)))
        else:
            pargs.append(torch.from_numpy(np.asarray(v, np.float64)
                                          if p.is_floating_point()
                                          else np.asarray(v)).to(p.dtype))
    return (jax.tree.unflatten(tdef, jargs),
            tree_unflatten(pabs, pargs))


def check_train(got, want, lm):
    (gp, go, gm), (wp, wo, wm) = got, want
    for k in ("loss", "grad_norm"):
        tol = dict(rtol=TRAIN_REL[k], atol=0) if lm else dict(rtol=1e-5,
                                                              atol=1e-7)
        close(gm[k], wm[k], **tol)
    close(gm["lr"], wm["lr"], rtol=1e-6)
    lr = float(wm["lr"])
    for a, b in zip(tree_leaves(gp), jax.tree.leaves(wp)):
        close(a.detach(), b, rtol=0, atol=2 * lr)
    assert int(go["count"]) == int(wo["count"])


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS,
                         ids=[f"{a}-{s}" for a, s in SMOKE_CELLS])
def test_cell_steps_like_reference(arch, shape):
    spec = configs.get(arch)
    jcell = jsteps.build_cell(jconfigs.get(arch), shape, mesh=None,
                              reduced=True)
    pcell = steps.build_cell(spec, shape, None, reduced=True, device="cpu")
    assert pcell.in_specs is None and pcell.out_specs is None
    jargs, pargs = materialize(jcell, pcell, seed=len(arch) + len(shape))
    want = jax.jit(jcell.step_fn)(*jargs)
    got = pcell.step_fn(*pargs)
    kind = spec.cells[shape].kind
    if spec.family == "clique":
        jt, *jrest = want
        pt, *prest = got
        assert float(pt) == float(jt)
        for a, b in zip(prest, jrest):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert float(pt) > 0
    elif kind == "train":
        check_train(got, want, spec.family == "lm")
    elif spec.family == "lm":
        close(got[0].float(), want[0], rtol=0, atol=LM_ATOL[arch])
    elif kind == "retrieval":
        close(got[0], want[0], **FWD)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        close(got, want, **FWD)
    for leaf in tree_leaves(got):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            assert bool(torch.isfinite(leaf).all()), (arch, shape)
