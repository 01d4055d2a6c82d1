"""The port on a CUDA card: the hand-written intersect_count kernel
against its plain PyTorch version, and a portfolio mine on the card
against the same mine on the CPU.  Every test skips itself where there
is no card.  The file imports neither jax nor ``repro``, so it also runs
on a machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import MiningSession
from repro_torch.core.patterns import feature_pattern_set
from repro_torch.graph.csr import build_temporal_graph
from repro_torch.kernels.intersect_count import intersect_count, intersect_count_ref
from repro_torch.kernels.intersect_count import ops as ic_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(b, da, db, seed):
    g = torch.Generator().manual_seed(seed)
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)
    a_lo, b_lo = ri(-4, 32, (b,)), ri(-4, 32, (b,))
    return (
        ri(-1, 8, (b, da)),
        ri(0, 64, (b, da)),
        ri(-1, 8, (b, db)),
        ri(0, 64, (b, db)),
        a_lo,
        a_lo + ri(-8, 64, (b,)),
        b_lo,
        b_lo + ri(-8, 64, (b,)),
    )


@pytest.mark.parametrize("da,db", [(1, 4), (1, 1024), (4, 16), (16, 64), (1024, 1024)])
@pytest.mark.parametrize("ordered", [False, True])
def test_kernel_matches_plain(cuda, da, db, ordered):
    for b in (1, 33, 257):
        args = _case(b, da, db, b + da + db)
        before = ic_ops.launches
        got = intersect_count(*(a.to(cuda) for a in args), ordered=ordered)
        assert ic_ops.launches == before + 1
        assert torch.equal(got.cpu(), intersect_count_ref(*args, ordered=ordered))


def test_mine_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(11)
    src = rng.integers(0, 18, 140).astype(np.int32)
    dst = rng.integers(0, 18, 140).astype(np.int32)
    dst[src == dst] = (dst[src == dst] + 1) % 18
    g = build_temporal_graph(src, dst, rng.integers(0, 256, 140), n_nodes=18)
    pats = feature_pattern_set("full_deep")
    before = ic_ops.launches
    on_card = MiningSession(g, window=96).register(*pats).mine()
    assert ic_ops.launches > before
    on_cpu = MiningSession(g, window=96, device="cpu").register(*pats).mine()
    np.testing.assert_array_equal(on_card.counts, on_cpu.counts)
    assert on_card.stats == on_cpu.stats
