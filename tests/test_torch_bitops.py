"""Port bit helpers vs ``repro.core.bitops`` / ``repro.kernels.common``,
and the rule that the port imports neither jax nor ``repro``.

Inputs are made with numpy from a seed, include words with bit 31 set, and
go to both packages; every comparison is exact.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jb
from repro.kernels import common as jc
from repro_torch.core import bitops as tb
from repro_torch.kernels import common as tc

BINS = (32, 64, 128, 256)
ROOT = Path(__file__).resolve().parents[1]
# the port's twins of the reference's examples
EXAMPLE_TWINS = [ROOT / "examples" / "quickstart_torch.py",
                 ROOT / "examples" / "clique_service_torch.py",
                 ROOT / "examples" / "train_lm_torch.py",
                 ROOT / "examples" / "gnn_clique_features_torch.py"]


def words(seed, shape):
    """uint32 words with every 7th word forced to have bit 31 set."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[::7] |= np.uint32(1 << 31)
    return w


def t64(u32):
    return tb.widen(torch.from_numpy(u32).view(torch.int32))


@pytest.mark.parametrize("T", BINS)
def test_packed_host_helpers_match(T):
    rng = np.random.default_rng(T)
    dense = rng.random((3, T)) < 0.5
    dense[:, 31::32] = True
    np.testing.assert_array_equal(tb.pack_bits(dense), jb.pack_bits(dense))
    np.testing.assert_array_equal(tb.gt_masks_np(T), jb.gt_masks_np(T))
    assert tb.num_words(T) == jb.num_words(T)
    rows = [int(x) for x in rng.integers(0, 1 << 62, size=T)]
    rows[0] |= 1 << (T - 1)
    np.testing.assert_array_equal(tb.pack_rows(rows, T), jb.pack_rows(rows, T))
    mask = (1 << T) - 1 - (1 << 3)
    np.testing.assert_array_equal(tb.pack_mask(mask, T), jb.pack_mask(mask, T))
    assert tb.unpack_mask(tb.pack_mask(mask, T)) == jb.unpack_mask(
        jb.pack_mask(mask, T)) == mask


def test_int_bitset_helpers_match():
    for x in (0, 1, 0b1011_0000, (1 << 200) | 5):
        assert list(tb.bits(x)) == list(jb.bits(x))
        assert tb.popcount(x) == jb.popcount(x)
    for i in (0, 5, 31, 64):
        assert tb.mask_gt(i) == jb.mask_gt(i)


@pytest.mark.parametrize("T", BINS)
def test_torch_word_helpers_match(T):
    W = T // 32
    x = words(T, (5, W))
    np.testing.assert_array_equal(
        tb.popcount_words(t64(x)).numpy(),
        np.asarray(jb.popcount_words(jnp.asarray(x))).astype(np.int64))
    np.testing.assert_array_equal(
        tb.unpack_bits(t64(x), T).numpy(),
        np.asarray(jb.unpack_bits(jnp.asarray(x), T)).astype(np.int64))
    for v in (0, 31, T - 1):
        np.testing.assert_array_equal(
            tb.bit_at(t64(x), v).numpy(),
            np.asarray(jb.bit_at(jnp.asarray(x), v)).astype(np.int64))
    np.testing.assert_array_equal(tb.gt_masks(T).numpy(),
                                  jb.gt_masks_np(T).astype(np.int64))


@pytest.mark.parametrize("T", BINS)
def test_base_case_math_matches(T):
    """member_rows / edges_within / triangles_within per tile vs the
    reference's traced forms, on random sparse tiles with bit-31 words."""
    W = T // 32
    rng = np.random.default_rng(T + 1)
    upper = np.triu(rng.random((2, T, T)) < 8.0 / T, 1)
    dense = upper | upper.transpose(0, 2, 1)
    A = jb.pack_bits(dense)
    cand = words(T + 2, (2, W))
    gt_j = jnp.asarray(jb.gt_masks_np(T))
    gt_t = tb.gt_masks(T)
    for b in range(2):
        Aj, cj = jnp.asarray(A[b]), jnp.asarray(cand[b])
        At, ct = t64(A[b]), t64(cand[b])
        np.testing.assert_array_equal(
            tc.member_rows(At, ct).numpy(),
            np.asarray(jc.member_rows(Aj, cj)).astype(np.int64))
        assert int(tc.edges_within(At, ct, gt_t)) == int(
            jc.edges_within(Aj, cj, gt_j))
        assert int(tc.triangles_within(At, ct, gt_t)) == int(
            jc.triangles_within(Aj, cj, gt_j))
    # batched and chunked forms agree with the per-tile form
    At, ct = t64(A), t64(cand)
    per_tile = [int(tc.triangles_within(At[b], ct[b], gt_t)) for b in range(2)]
    assert tc.triangles_within_chunked(At, ct, gt_t,
                                       budget=1).tolist() == per_tile


def test_pascal_table_matches():
    np.testing.assert_array_equal(tc.pascal_table(60), jc.pascal_table(60))


def test_port_imports_no_jax_and_no_repro():
    """Importing every module of the port, and ``chip_smoke.py``, loads
    neither jax nor any ``repro`` module (a fresh interpreter: this one
    imported jax)."""
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    assert "repro_torch.core.listing" in mods
    # every module of the later slices is picked up too
    assert {"repro_torch.core.vbbkc", "repro_torch.core.oracle",
            "repro_torch.core.truss_torch", "repro_torch.configs.__init__",
            "repro_torch.configs.granite_3_8b", "repro_torch.models.common",
            "repro_torch.models.transformer",
            "repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.launch.steps", "repro_torch.optim.adamw",
            "repro_torch.runtime.train_loop", "repro_torch.data.lm",
            "repro_torch.configs.deepseek_moe_16b",
            "repro_torch.models.gnn", "repro_torch.models.equivariant",
            "repro_torch.models.recsys", "repro_torch.models.scatter",
            "repro_torch.data.sampler", "repro_torch.data.recsys",
            "repro_torch.configs.dcn_v2"} <= set(mods)
    examples = [str(p) for p in EXAMPLE_TWINS]
    code = ("import sys, importlib, importlib.util\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            f"for i, path in enumerate({examples!r}):\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        f'example{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_of_the_port_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files.extend(EXAMPLE_TWINS)
    assert len(files) > 10
    # the observability and resilience layers are sources like the rest
    assert {"obs", "resilience"} <= {p.parent.name for p in files}
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
