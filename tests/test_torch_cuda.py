"""The port on a CUDA card: the hand-written kernels (intersect_count,
hist_update's two entries, window_degree, flash_attention) against their
plain PyTorch versions (hist_update also bit for bit against its plain
fixed-point replay, at every cluster size), a portfolio mine on the card
against the same mine on the CPU, a GBDT fit on the card against the same
fit on the CPU, and FraudGT's logits on the card against the CPU port's.
Every test skips itself where there is no card.  The file imports neither jax nor ``repro``, so it also runs
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
from repro_torch.kernels.hist_update import (
    error_bound,
    error_bound_rows,
    fixed_point_ref,
    hist_update,
    hist_update_ref,
    hist_update_rows,
    hist_update_rows_ref,
)
from repro_torch.kernels.hist_update import ops as hu_ops
from repro_torch.kernels.hist_update.ref import row_keys
from repro_torch.kernels.window_degree import PAD_T, window_degree, window_degree_ref
from repro_torch.kernels.window_degree import ops as wd_ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.ml.fraudgt import FraudGT, FraudGTParams
from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams, first_split_difference

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


# the smoke shapes of tests/test_kernels.py, the edge cases, both sides of
# the kernel's shared-memory limit (14,336 keys) and a GBDT level-5 shape
@pytest.mark.parametrize(
    "n,s",
    [(16, 8), (1000, 97), (4096, 512), (513, 2048), (1, 1), (0, 64),
     (100_000, 14_336), (100_000, 14_337), (1 << 20, 98_304)],
)
def test_hist_update_within_bound_and_deterministic(cuda, n, s):
    rng = np.random.default_rng(n + s)
    keys = torch.from_numpy(rng.integers(-2, s + 2, n).astype(np.int32))
    gh = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
    before = hu_ops.launches
    a = hist_update(keys.to(cuda), gh.to(cuda), s)
    b = hist_update(keys.to(cuda), gh.to(cuda), s)
    assert hu_ops.launches == before + (2 if n else 0)
    assert a.dtype == torch.float32 and a.shape == (s, 2)
    assert torch.equal(a, b)  # the same bits on every launch
    exact = hist_update_ref(keys, gh.double(), s)
    assert torch.all((a.cpu().double() - exact).abs() <= error_bound(keys, gh, s))


# the kernel holds 14,528 keys a block in clusters of 1, 2, 4, 8 or 16
# blocks; 232,449 keys go to device memory
CLUSTER_S = [14_528, 14_529, 29_057, 58_113, 116_225, 232_449]


@pytest.mark.parametrize("s", CLUSTER_S)
@pytest.mark.parametrize("kind", ["uniform", "one key"])
def test_hist_update_equals_fixed_point_replay(cuda, s, kind):
    rng = np.random.default_rng(s)
    n = 1 << 18
    keys = rng.integers(-2, s + 2, n) if kind == "uniform" else np.full(n, s - 1)
    keys = torch.from_numpy(keys.astype(np.int32))
    gh = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
    before = hu_ops.launches
    a = hist_update(keys.to(cuda), gh.to(cuda), s).cpu()
    b = hist_update(keys.to(cuda), gh.to(cuda), s).cpu()
    assert hu_ops.launches == before + 2
    assert torch.equal(a, b)
    assert torch.equal(a, fixed_point_ref(keys, gh, s, n))  # replayed on the CPU
    exact = hist_update_ref(keys, gh.double(), s)
    assert torch.all((a.double() - exact).abs() <= error_bound(keys, gh, s))


# n_nodes at F = 12, B = 256: clusters of 1, 2, 4, 8 and 16 blocks, then
# device memory (393,216 keys)
@pytest.mark.parametrize("n_nodes", [1, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["uniform", "one key"])
def test_hist_update_rows_equals_fixed_point_replay(cuda, n_nodes, kind):
    rng = np.random.default_rng(n_nodes)
    n, f, n_bins = 1 << 16, 12, 256
    if kind == "uniform":
        xb = rng.integers(0, n_bins, (n, f)).astype(np.uint8)
        node = rng.integers(0, n_nodes, n).astype(np.int32)
    else:
        xb = np.zeros((n, f), dtype=np.uint8)
        node = np.full(n, n_nodes - 1, dtype=np.int32)
    xb, node = torch.from_numpy(xb), torch.from_numpy(node)
    gh = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
    before, rows_before = hu_ops.launches, hu_ops.rows_launches
    a = hist_update_rows(xb.to(cuda), node.to(cuda), gh.to(cuda), n_nodes, n_bins).cpu()
    b = hist_update_rows(xb.to(cuda), node.to(cuda), gh.to(cuda), n_nodes, n_bins).cpu()
    assert hu_ops.launches == before + 2 and hu_ops.rows_launches == rows_before + 2
    assert a.shape == (n_nodes, f, n_bins, 2) and torch.equal(a, b)
    s = n_nodes * f * n_bins
    replay = fixed_point_ref(row_keys(xb, node, n_bins), gh[:, None, :].expand(n, f, 2).reshape(-1, 2), s, n)
    assert torch.equal(a, replay.reshape(a.shape))
    exact = hist_update_rows_ref(xb, node, gh.double(), n_nodes, n_bins)
    assert torch.all((a.double() - exact).abs() <= error_bound_rows(xb, node, gh, n_nodes, n_bins))


@pytest.mark.parametrize("b,d", [(1, 1), (7, 16), (64, 128), (100, 33), (16384, 128)])
def test_window_degree_matches_plain(cuda, b, d):
    rng = np.random.default_rng(b + d)
    t = rng.integers(0, 128, (b, d)).astype(np.int32)
    t[rng.random((b, d)) < 0.25] = PAD_T
    lo = rng.integers(0, 64, b).astype(np.int32)
    hi = lo + rng.integers(0, 64, b).astype(np.int32)
    args = tuple(torch.from_numpy(a) for a in (t, lo, hi))
    before = wd_ops.launches
    got = window_degree(*(a.to(cuda) for a in args))
    assert wd_ops.launches == before + 1
    assert torch.equal(got.cpu(), window_degree_ref(*args))


def test_fit_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(12)
    n = 65_536
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x[:, 5] = np.round(x[:, 5] * 2)  # a coarse feature, as mined counts are
    y = (((x[:, 0] * x[:, 1] > 0) & (x[:, 2] > -0.3)) | (rng.random(n) < 0.01)).astype(np.float32)
    params = GBDTParams(n_trees=10)
    before = hu_ops.launches
    on_card = GBDTClassifier(params).fit(x, y)
    assert hu_ops.launches == before + 10 * (6 + 1)
    on_cpu = GBDTClassifier(params, device="cpu").fit(x, y)
    diff = first_split_difference(on_card, on_cpu, n)
    # the card sums exactly to float32 rounding, the CPU in sequential
    # float32: a split may differ only where the two gains are a near tie
    assert diff is None or diff["near_tie"], diff
    if diff is None:
        np.testing.assert_allclose(
            on_card.predict_proba(x), on_cpu.predict_proba(x), rtol=1e-4, atol=1e-4
        )


# (B, T, S, H, K, hd, causal, dtype): the cases of
# tests/test_flash_attention.py, causal T > S with S unaligned, every head
# size the kernel takes, FraudGT's shape, and cases that reach each path
# of the kernel (ops.plan) at its edges
@pytest.mark.parametrize(
    "b,t,s,h,kvh,hd,causal,dtype",
    [(2, t, t, 4, 4, 32, c, "float32") for t in (64, 128, 256) for c in (True, False)]
    + [
        (1, 128, 128, 8, 2, 64, True, "float32"),
        (1, 128, 128, 4, 4, 64, True, "bfloat16"),
        (1, 96, 96, 2, 2, 32, True, "float32"),
        (1, 256, 256, 1, 1, 32, True, "float32"),
        (2, 80, 50, 4, 2, 16, True, "float32"),
        (3, 5, 5, 4, 1, 128, True, "float32"),
        (1, 192, 192, 2, 2, 128, False, "bfloat16"),
        (1024, 17, 17, 8, 8, 16, True, "float32"),
        # short path: GQA, T > S, non-causal, bf16, B past and not a multiple
        # of the persistent grid, the 32/32 edge, one key visible to row 0
        (1000, 20, 12, 8, 2, 16, True, "float32"),
        (1001, 17, 17, 8, 2, 32, False, "bfloat16"),
        (5003, 17, 17, 8, 8, 16, True, "float32"),
        (37, 32, 32, 2, 2, 128, True, "float32"),
        (9, 32, 32, 2, 1, 64, False, "bfloat16"),
        (3, 1, 1, 8, 8, 16, True, "float32"),
        # wgmma path: long, ragged tiles (1,000 = 7 x 128 + 104), hd 64 and
        # 128, GQA 4:1, causal and not, causal T > S, just past the short path
        (1, 4096, 4096, 8, 2, 128, True, "bfloat16"),
        (1, 4096, 4096, 4, 1, 64, False, "bfloat16"),
        (1, 1000, 1000, 8, 2, 128, False, "bfloat16"),
        (2, 1000, 1000, 4, 1, 64, True, "bfloat16"),
        (1, 300, 200, 8, 2, 128, True, "bfloat16"),
        (3, 33, 33, 4, 2, 64, True, "bfloat16"),
        (2, 32, 32, 16, 16, 128, True, "bfloat16"),
    ],
)
def test_flash_attention_matches_plain(cuda, b, t, s, h, kvh, hd, causal, dtype):
    rng = np.random.default_rng(b + t + s + hd)
    dt = getattr(torch, dtype)
    q, k, v = (
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dt)
        for shape in ((b, t, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))
    )
    before = fa_ops.launches
    got = flash_attention(*(x.to(cuda) for x in (q, k, v)), causal=causal, block_k=s)
    assert fa_ops.launches == before + 1
    assert got.dtype == dt and got.shape == (b, t, h, hd)
    want = flash_attention(q, k, v, causal=causal, block_k=s)  # the plain version, on the CPU
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_plan_matches_kernel(cuda, dtype):
    """The .cu entry picks the path that ops.plan names, at every shape of
    a grid across the path boundaries."""
    for t in (1, 17, 32, 33, 1000):
        for s in (1, 17, 32, 33, 4096):
            for h, kvh in ((8, 8), (8, 2), (32, 8)):
                for hd in fa_ops.HEAD_DIMS:
                    for causal in (True, False):
                        args = (3, t, s, h, kvh, hd, dtype, causal)
                        assert fa_ops.kernel_plan(*args) == fa_ops.plan(*args), args


def test_fraudgt_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(13)
    src = rng.integers(0, 40, 3000).astype(np.int32)
    dst = rng.integers(0, 40, 3000).astype(np.int32)
    dst[src == dst] = (dst[src == dst] + 1) % 40
    g = build_temporal_graph(src, dst, rng.integers(0, 4096, 3000), rng.lognormal(5, 1, 3000), n_nodes=40)
    eids = rng.permutation(3000)[:2500]
    on_card = FraudGT(FraudGTParams(), seed=1)
    before = fa_ops.launches
    proba = on_card.predict_proba(g, eids)
    assert fa_ops.launches == before + 3 * 3  # 3 layers x 3 chunks of up to 1,024 edges
    on_cpu = FraudGT(FraudGTParams(), seed=1, device="cpu")
    toks = on_cpu.tokenize(g, eids)
    for a, b in zip(on_card.tokenize(g, eids), toks):
        np.testing.assert_array_equal(a, b)
    torch.testing.assert_close(on_card.logits(*toks).cpu(), on_cpu.logits(*toks), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(proba, torch.sigmoid(on_cpu.logits(*toks)).numpy(), rtol=1e-4, atol=1e-4)
    torch_attn = FraudGT(FraudGTParams(), seed=1, attn_backend="torch")
    torch.testing.assert_close(on_card.logits(*toks), torch_attn.logits(*toks), rtol=1e-5, atol=1e-5)
