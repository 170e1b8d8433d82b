"""The port's dry run (``repro_torch.launch.dryrun``) and its H100
roofline (``repro_torch.launch.roofline``), on the CPU.

The dry run counts rank 0's step on ``meta`` tensors in a fake
process-group world, global state of its process, so each count runs
in a subprocess:

* the reduced granite-3-8b prefill on a (1, 2) mesh: the FLOP count
  equals a closed-form count of rank 0's products exactly (as integers),
  and the tally's all-reduce bytes are the two ``psum`` s of each of the
  2 layers (attention out, FFN down) and the embedding's, each a
  (B, S, d) bf16 block;
* the CLI writes a full-size granite-3-8b ``prefill_32k`` record on the
  single-pod mesh with status ``ok``.

In process: ``roofline_terms`` and ``model_flops_lm`` against the
reference's (``repro.launch.roofline`` imports no jax), the inputs
rescaled by the ratio of the two packages' hardware constants.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch import roofline as jroof
from repro_torch import configs
from repro_torch.launch import roofline

ROOT = Path(__file__).resolve().parents[1]

COUNT = r"""
import json
from repro_torch import configs
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_local_mesh
dryrun.fake_world(2)
mesh = make_local_mesh((1, 2), device="cpu")
cell = steps.build_cell(configs.get("granite-3-8b"), "prefill_32k", mesh,
                        reduced=True)
got = dryrun.count_cell(cell, mesh)
print(json.dumps({"flops": got["flops"], "bytes": got["bytes"],
                  "collectives": got["tally"].kinds}))
"""


def run(args, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, *args], env=env, cwd=str(cwd),
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def prefill_count(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("dryrun_count")
    return json.loads(run(["-c", COUNT], cwd).strip().splitlines()[-1])


def rank0_prefill_flops(cfg, B, S, m):
    """2 x the multiply-adds of rank 0's matmuls in a prefill over a
    (1, m) mesh: its q heads, kv heads, ff columns and vocab block."""
    d, dh = cfg.d_model, cfg.d_head
    hq, hk = cfg.n_heads // m, cfg.n_kv_heads // m
    f, v = cfg.d_ff // m, cfg.padded_vocab // m
    qb = min(cfg.q_block, S)
    nblk = -(-S // qb)
    proj = 2 * B * S * d * dh * (hq + 2 * hk) + 2 * B * S * hq * dh * d
    attn = nblk * 2 * (2 * B * hq * qb * S * dh)      # scores, probs @ v
    ffn = 3 * 2 * B * S * d * f
    return cfg.n_layers * (proj + attn + ffn) + 2 * B * d * v


def test_prefill_flops_equal_closed_form(prefill_count):
    cfg = configs.get("granite-3-8b").reduced
    assert int(prefill_count["flops"]) == rank0_prefill_flops(cfg, 2, 64, 2)


def test_prefill_all_reduce_bytes_are_the_psums(prefill_count):
    cfg = configs.get("granite-3-8b").reduced
    block = 2 * 64 * cfg.d_model * 2                  # (B, S, d) bf16
    ar = prefill_count["collectives"]["all-reduce"]
    assert ar["operand_bytes"] == ar["result_bytes"] \
        == (cfg.n_layers * 2 + 1) * block
    assert ar["count"] == cfg.n_layers * 2 + 1
    assert prefill_count["bytes"] > 0


@pytest.mark.parametrize("flops,nbytes,coll", [
    (1.2e15, 3.4e12, 5.6e9), (1.0, 1e12, 0.0), (0.0, 0.0, 0.0),
    (7.7e13, 2.0e9, 9.9e11)])
def test_roofline_terms_equal_reference_rescaled(flops, nbytes, coll):
    got = roofline.roofline_terms(flops, nbytes, coll)
    want = jroof.roofline_terms(
        flops * jroof.PEAK_FLOPS / roofline.PEAK_FLOPS,
        nbytes * jroof.HBM_BW / roofline.HBM_BW,
        coll * jroof.ICI_BW / roofline.NVLINK_BW)
    assert got["dominant"] == want["dominant"]
    for k, v in want.items():
        if k != "dominant":
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0)


def test_model_flops_equal_reference():
    for arch in ("granite-3-8b", "deepseek-moe-16b"):
        cfg = configs.get(arch).full
        meta = {"tokens_per_step": 4096, "model_params": cfg.num_params(),
                "active_params": cfg.active_params()}
        for kind in ("train", "prefill", "decode"):
            assert roofline.model_flops_lm(meta, kind) \
                == jroof.model_flops_lm(meta, kind)


def test_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW) \
        == (989e12, 3.35e12, 450e9)


def test_cli_writes_a_full_size_record(tmp_path):
    stdout = run(["-m", "repro_torch.launch.dryrun", "--arch",
                  "granite-3-8b", "--shape", "prefill_32k", "--mesh",
                  "single", "--out", str(tmp_path / "dry")], tmp_path,
                 timeout=600)
    assert "dry-run done: ok=1 skipped=0 errors=0" in stdout
    rec = json.loads((tmp_path / "dry" / "single"
                      / "granite-3-8b__prefill_32k.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert set(rec["collectives"]) == {"all-reduce", "all-gather",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute"}
    assert rec["collective_operand_bytes"] == sum(
        v["operand_bytes"] for v in rec["collectives"].values())
    assert rec["roofline"]["bound_s"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert 0 < rec["model_over_hlo_flops"] < 1
