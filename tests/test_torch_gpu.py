"""The port's CUDA kernels on the card (marker ``gpu``; each test skips
without a CUDA device, since a CUDA kernel has no CPU mode).

This file imports neither jax nor ``repro``, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain torch version on the same inputs,
with exact equality (tolerance 0): the counts are integers.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ebbkc, engine_torch
from repro_torch.core.bitops import pack_bits
from repro_torch.data import graphs
from repro_torch.kernels import clique_count, ops, triangle_mm

pytestmark = pytest.mark.gpu

BINS = (32, 64, 128, 256)
_DENSITY = {32: 0.35, 64: 0.2, 128: 0.12, 256: 0.06}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def random_tiles(seed, B, T, p):
    """Symmetric tiles; lane 0 has an empty cand over a non-empty A (as
    the 2-plex router leaves it), lane 1 a full cand (bit 31 set in every
    word), odd lanes cands with holes."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((B, T, T)) < p, 1)
    dense = upper | upper.transpose(0, 2, 1)
    cmask = np.arange(T)[None, :] < rng.integers(0, 49, B)[:, None]
    cmask &= ~((rng.random((B, T)) < 0.2) & (np.arange(B)[:, None] % 2 == 1))
    cmask[0] = False
    cmask[1] = True
    keep = np.arange(T) % 3 == 0
    dense[1] &= keep[:, None] & keep[None, :]
    return (torch.from_numpy(pack_bits(dense)).view(torch.int32),
            torch.from_numpy(pack_bits(cmask)).view(torch.int32))


@pytest.mark.parametrize("T", BINS)
def test_kernels_match_plain_on_card(cuda, T):
    A, cand = (x.to(cuda) for x in random_tiles(T + 5, 64, T, _DENSITY[T]))
    before = ops.launch_counts()
    got = triangle_mm.triangle_count_tiles(A, cand)
    assert torch.equal(got, triangle_mm.triangle_count_tiles_torch(A, cand))
    for l in (1, 2, 3, 4, 5, 6):
        got = clique_count.clique_count_tiles(A, cand, l)
        assert torch.equal(got,
                           clique_count.clique_count_tiles_torch(A, cand, l))
    after = ops.launch_counts()
    assert after["triangle_count_tiles"] == before["triangle_count_tiles"] + 1
    assert after["clique_count_tiles"] == before["clique_count_tiles"] + 6


def test_kernel_wrappers_reject_bad_input_on_card(cuda):
    A, cand = (x.to(cuda) for x in random_tiles(1, 4, 32, 0.3))
    with pytest.raises(TypeError):
        triangle_mm.triangle_count_tiles(A.to(torch.int64), cand)
    with pytest.raises(ValueError):
        clique_count.clique_count_tiles(A, cand.cpu(), 4)
    with pytest.raises(ValueError):
        clique_count.clique_count_tiles(A, cand, clique_count.L_MAX + 1)
    empty = clique_count.clique_count_tiles(A[:0], cand[:0], 4)
    assert empty.shape == (0,) and empty.device.type == "cuda"


@pytest.mark.parametrize("k", [3, 4, 5, 6, 7])
def test_engine_on_card_matches_cpu_and_host(cuda, k):
    g = graphs.planted_cliques(300, 6, 14, p_noise=0.03, seed=11)
    ops.reset_counts()
    got = engine_torch.count(g, k, device=cuda).count
    assert got == engine_torch.count(g, k, device="cpu").count
    assert got == ebbkc.count(g, k, backend="host").count
    if k >= 5:
        assert sum(ops.launch_counts().values()) > 0
