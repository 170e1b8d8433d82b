"""The port's sharding rules and spec arithmetic against the reference's
``repro.sharding.rules`` and ``repro.launch.steps._filter_spec``.

Every spec is compared part for part (a ``PartitionSpec`` as the tuple
of its parts): the transformer's param, layer and cache specs of every
LM arch, full and reduced, at model sizes 1, 2, 8 and 16.  The five
cases of ``tests/test_sharding.py`` run again on the port.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.sharding import rules, spmd
from repro_torch.sharding.rules import (LM_RULES, P, spec_for,
                                        transformer_layer_specs,
                                        transformer_param_specs)

LM_ARCHS = ("granite-3-8b", "nemotron-4-15b", "gemma3-27b",
            "deepseek-moe-16b", "dbrx-132b")
MODEL_SIZES = (1, 2, 8, 16)


def as_tuples(tree):
    """A spec tree with every spec (the reference's or the port's) as a
    plain tuple of its parts."""
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("model_size", MODEL_SIZES)
@pytest.mark.parametrize("variant", ["full", "reduced"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_transformer_specs_equal_reference(arch, variant, model_size):
    jc = getattr(jconfigs.get(arch), variant)
    pc = getattr(configs.get(arch), variant)
    for name in ("transformer_param_specs", "transformer_cache_specs"):
        want = getattr(jrules, name)(jc, model_size=model_size)
        got = getattr(rules, name)(pc, model_size=model_size)
        assert as_tuples(got) == as_tuples(want), name
    assert as_tuples(transformer_layer_specs(pc, model_size)) == as_tuples(
        jrules.transformer_layer_specs(jc, model_size))


@pytest.mark.parametrize("table", ["LM_RULES", "GNN_RULES", "RECSYS_RULES",
                                   "CLIQUE_RULES"])
def test_rule_tables_and_batch_specs_equal_reference(table):
    want, got = getattr(jrules, table), getattr(rules, table)
    assert got.table == want.table
    names = {k: (k, None) for k in want.table}
    assert as_tuples(rules.batch_specs(got, names)) == as_tuples(
        jrules.batch_specs(want, names))


# -- the five cases of tests/test_sharding.py, on the port ------------------

def test_spec_for_basic():
    s = spec_for(LM_RULES, ("batch", "seq", "heads"))
    assert s == P(("pod", "data"), None, "model")


def test_kv_replication_fallback():
    cfg = configs.get("dbrx-132b").full          # kv=8 < TP=16
    specs = transformer_param_specs(cfg, model_size=16)
    assert specs["groups"]["global"]["wk"] == P(None, "data", None, None)
    assert specs["groups"]["global"]["wq"][2] == "model"
    cfg2 = configs.get("deepseek-moe-16b").full  # kv=16 == TP
    specs2 = transformer_param_specs(cfg2, model_size=16)
    assert specs2["groups"]["global"]["wk"][2] == "model"


def test_layer_specs_are_model_only():
    cfg = configs.get("gemma3-27b").full
    ls = transformer_layer_specs(cfg, model_size=16)
    for k, s in ls.items():
        for part in s:
            assert part in (None, "model"), (k, s)


def test_vocab_padding():
    cfg = configs.get("granite-3-8b").full
    assert cfg.vocab == 49155
    assert cfg.padded_vocab % 512 == 0
    assert cfg.padded_vocab >= cfg.vocab


def test_moe_expert_divisibility():
    for name in ("deepseek-moe-16b", "dbrx-132b"):
        cfg = configs.get(name).full
        assert cfg.moe.n_experts % 16 == 0, name  # model axis = 16


# -- filter_spec, local_shape ------------------------------------------------

def all_specs():
    out = [P(), P(None), P("model", None), P(steps.DATA_AXES, None),
           P(steps.ALL_AXES, None, None), P(None, steps.ALL_AXES),
           P(("data", "model")), P("pod"), P(("pod",), "data")]
    for table in (rules.LM_RULES, rules.GNN_RULES, rules.RECSYS_RULES,
                  rules.CLIQUE_RULES):
        out += [spec_for(table, (k, None, k)) for k in table.table]
    return out


@pytest.mark.parametrize("axes", [("data", "model"),
                                  ("pod", "data", "model"), ("data",)])
def test_filter_spec_equals_reference(axes):
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape((1,) * len(axes)),
                 axes)
    pmesh = dict.fromkeys(axes, 1)
    for s in all_specs():
        want = jsteps._filter_spec(jax.sharding.PartitionSpec(*s), jmesh)
        assert tuple(spmd.filter_spec(s, pmesh)) == tuple(want), s
    assert spmd.filter_spec(P("data"), None) == P()


def test_tree_specs_filters_every_leaf():
    tree = {"a": P(steps.ALL_AXES, None), "b": [P("pod"), None],
            "c": (P(("pod", "model")),)}
    got = rules.tree_specs({"data": 2, "model": 2}, tree)
    assert got == {"a": P(("data", "model"), None), "b": [P(None), None],
                   "c": (P("model"),)}


def test_local_shape_arithmetic():
    mesh = {"pod": 2, "data": 4, "model": 8}
    assert spmd.local_shape((64, 3), P(("pod", "data"), None), mesh) == \
        (8, 3)
    assert spmd.local_shape((64, 16, 2), P(steps.ALL_AXES), mesh) == \
        (1, 16, 2)
    assert spmd.local_shape((5, 16), P(None, "model"), mesh) == (5, 2)
    assert spmd.local_shape((5,), P(), mesh) == (5,)
    with pytest.raises(ValueError):
        spmd.local_shape((6, 3), P("data", None), mesh)
