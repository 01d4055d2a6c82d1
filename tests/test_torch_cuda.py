"""The port on a CUDA card: the hand-written kernels (intersect_count,
hist_update's two entries, window_degree, window_search's four entries,
flash_attention) against their
plain PyTorch versions (hist_update also bit for bit against its plain
fixed-point replay, at every cluster size), a portfolio mine on the card
against the same mine on the CPU, a GBDT fit on the card against the same
fit on the CPU, FraudGT's logits on the card against the CPU port's,
witness extraction and evidence-carrying alerts on the card against the
CPU port's, the attention backward (short and long paths) against its
plain version,
a sharded mine on the card against the compiled mine, a FraudGT fit
on the card that makes no host sync, and the LM scaffold: one smoke
forward and decode per block type on the card against the CPU port, and
qwen2-1.5b's widths at two layers through the wgmma path, and a short
train of the qwen2-1.5b smoke config on the card against the CPU port.
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
from repro_torch.kernels import window_search as WS
from repro_torch.kernels.window_search import ops as ws_ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.ml.fraudgt import FraudGT, FraudGTParams
from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams, first_split_difference
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import model as LMM

import chip_smoke as cs

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


def _forms(bf, rep, da, db, seed, a_time=True, windows="mixed"):
    """Operands in the compiler's broadcast forms: B = bf * rep rows, a
    fixed side of bf rows, windows as ints, (B,) or (B_fixed,) tensors."""
    g = torch.Generator().manual_seed(seed)
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)
    b = bf * rep
    b_lo, a_lo = ri(-4, 32, (bf,)), ri(-4, 32, (b,))
    forms = {
        "mixed": (a_lo, a_lo + ri(-8, 64, (b,)), b_lo, b_lo + ri(-8, 64, (bf,))),
        "scalar": (5, 40, -3, 50),
        "fixed": (ri(-4, 8, (bf,)), ri(30, 64, (bf,)), b_lo, b_lo + ri(-8, 64, (bf,))),
    }
    bounds = forms[windows] if a_time else (-(2**31), 2**31 - 1) + forms[windows][2:]
    return (ri(-1, 8, (b, da)), ri(0, 64, (b, da)) if a_time else None, ri(-1, 8, (bf, db)),
            ri(0, 64, (bf, db)), *bounds)


def _offset_view(x):
    """A contiguous copy of x that starts one word into its storage."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def _on(args, device):
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)


# both sides of the plan's crossover (4,096 pairs; 32 KB of operands a
# row), the ladder's narrow and wide corners, and the widest tiles
@pytest.mark.parametrize(
    "da,db",
    [(1, 4), (1, 1024), (4, 16), (16, 64), (1024, 1024), (63, 65), (64, 64), (1, 4093), (1, 4094), (3, 5)],
)
@pytest.mark.parametrize("ordered", [False, True])
def test_kernel_matches_plain(cuda, da, db, ordered):
    wide = da * db > 1 << 16
    for b in (1, 33, 257) if wide else (1, 33, 257, 4097):
        args = _case(b, da, db, b + da + db)
        before = ic_ops.launches
        got = intersect_count(*(a.to(cuda) for a in args), ordered=ordered)
        assert ic_ops.launches == before + 1
        assert torch.equal(got.cpu(), intersect_count_ref(*args, ordered=ordered))
        # the same operands one word into their storage (16-byte copies
        # then start at an unaligned head)
        got = intersect_count(*(_offset_view(a.to(cuda)) for a in args), ordered=ordered)
        assert torch.equal(got.cpu(), intersect_count_ref(*args, ordered=ordered))
        # the broadcast forms: fixed rows shared by rep rows, each window
        # form, and (unordered) no a-side time; the CPU wrapper expands
        # them for the plain version
        for rep in (1, 3, 64):
            bf = max(1, b // rep) if not wide else max(1, b // 64)
            for windows in ("mixed", "scalar", "fixed"):
                for a_time in (True, False) if not ordered else (True,):
                    fargs = _forms(bf, rep, da, db, b + rep, a_time, windows)
                    before = ic_ops.launches
                    got = intersect_count(*_on(fargs, cuda), ordered=ordered)
                    assert ic_ops.launches == before + 1
                    assert torch.equal(got.cpu(), intersect_count(*fargs, ordered=ordered)), (b, rep, windows, a_time)


def test_kernel_plan_equals_ops_plan(cuda):
    for da in (1, 4, 32, 63, 64, 256, 1024, 4093):
        for db in (1, 4, 32, 64, 65, 256, 1024, 4094):
            if da + db <= ic_ops.MAX_TILE_SUM:
                assert ic_ops.kernel_plan(1 << 20, da, db) == ic_ops.plan(1 << 20, da, db), (da, db)


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


# window_search's cases are chip_smoke.py's phase-2 cases: the compiler's
# operand forms at halvings that cover every row and at fewer, and a hub
# row of HI-Small's largest degree (340,391) beside short rows
@pytest.mark.parametrize("form", cs.WS_FORMS)
@pytest.mark.parametrize("entry", cs.WS_ENTRIES)
def test_window_search_matches_plain(cuda, entry, form):
    """Bit for bit against the plain searches on the same operands, one
    launch a call under set_sync_debug_mode("error")."""
    fi = cs.WS_FORMS.index(form)
    flats = cs.ws_csr(fi, np.random.default_rng(fi).integers(0, 41, 64), 6, 64, cuda)
    ops_ = cs.ws_operands(form, fi, 64, 6, 64, cuda)
    for n_iters in (6, 2):
        cs.ws_hold(entry, cs.ws_args(entry, flats, ops_, n_iters), f"{form}, {n_iters} halvings")
        # and against the plain version on the CPU
        args = cs.ws_args(entry, flats, ops_, n_iters)
        got = getattr(WS, entry)(*args)
        want = getattr(WS, entry)(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        for g_, w_ in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g_.cpu(), w_)


@pytest.mark.parametrize("entry", cs.WS_ENTRIES)
def test_window_search_at_hub_row_length(cuda, entry):
    lens = np.array([cs.WS_HUB, 5, 0, 17, 1 << 12, 3])
    flats = cs.ws_csr(5, lens, 4_000, 1 << 20, cuda)
    g = torch.Generator().manual_seed(3)
    b = 4096
    node = torch.randint(-1, 6, (b, 1), generator=g, dtype=torch.int32)
    node[: b // 2] = 0  # half the queries on the hub
    x = torch.randint(-1, 4_000, (b, 8), generator=g, dtype=torch.int32)
    after = torch.randint(0, 1 << 20, (b, 1), generator=g, dtype=torch.int32)
    until = after + torch.randint(-100, 1 << 18, (b, 8), generator=g, dtype=torch.int32)
    ops_ = tuple(v.to(cuda) for v in (node, x, after, until))
    for n_iters in (19, 8):  # the hub's halvings, and fewer
        cs.ws_hold(entry, cs.ws_args(entry, flats, ops_, n_iters), f"hub row, {n_iters} halvings")


# the intersect_step entry: chip_smoke.py's phase-2 forms in both
# strategies, and the hub row swept at D = 1,024 in 512 steps
@pytest.mark.parametrize("form", cs.WS_STEP_FORMS)
@pytest.mark.parametrize("strategy", ["bs1", "bs2"])
def test_window_search_step_matches_plain(cuda, strategy, form):
    """Bit for bit against the eager intersect sequence on the same
    operands, one launch under set_sync_debug_mode("error"), and equal to
    the plain version run on the CPU."""
    args, kw = cs.ws_step_case(form, strategy, 20 + cs.WS_STEP_FORMS.index(form), cuda)
    cs.ws_step_hold(args, kw, f"{form}, {strategy}")
    on_cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else tuple(map(on_cpu, v)) if isinstance(v, tuple) else v  # noqa: E731
    got = WS.intersect_step(*args, **kw)
    assert torch.equal(got.cpu(), WS.intersect_step(*on_cpu(args), **kw))


@pytest.mark.parametrize("strategy", ["bs1", "bs2"])
def test_window_search_step_at_hub_row_length(cuda, strategy):
    for n_iters in (19, 8):  # the hub's halvings, and fewer
        args, kw = cs.ws_step_hub_case(strategy, cuda, b=256, n_iters=n_iters)
        cs.ws_step_hold(args, kw, f"{strategy} at a hub row, {n_iters} halvings")


def test_window_search_step_on_the_mining_path(cuda):
    """Swept bs1 and bs2 mines on the card launch intersect_step and equal
    the CPU port."""
    from repro_torch.core.compiler import CompiledPattern
    from repro_torch.core.patterns import build_pattern

    rng = np.random.default_rng(11)
    src = rng.integers(0, 18, 140).astype(np.int32)
    dst = rng.integers(0, 18, 140).astype(np.int32)
    dst[src == dst] = (dst[src == dst] + 1) % 18
    g = build_temporal_graph(src, dst, rng.integers(0, 256, 140), n_nodes=18)
    for name in ("cycle4", "scatter_gather"):
        for strategy in ("bs1", "bs2"):
            kw = dict(ladder=(1, 2), force_strategy=strategy)
            want = CompiledPattern(build_pattern(name, 96), g, device="cpu", **kw).mine()
            before = ws_ops.step_launches
            got = CompiledPattern(build_pattern(name, 96), g, **kw).mine()
            assert ws_ops.step_launches > before, (name, strategy)
            np.testing.assert_array_equal(got, want)


def test_window_search_on_the_mining_paths(cuda):
    """A compiled, fused and witness mine on the card launch window_search
    under the kernel backend, equal to the CPU port; the torch backend's
    compiled and fused plans launch it no time."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, 18, 140).astype(np.int32)
    dst = rng.integers(0, 18, 140).astype(np.int32)
    dst[src == dst] = (dst[src == dst] + 1) % 18
    g = build_temporal_graph(src, dst, rng.integers(0, 256, 140), n_nodes=18)
    pats = feature_pattern_set("full_deep") + ("new_counterparty",)
    on_cpu = MiningSession(g, window=96, device="cpu").register(*pats).mine()
    before = ws_ops.launches
    on_card = MiningSession(g, window=96).register(*pats).mine()
    assert ws_ops.launches > before
    np.testing.assert_array_equal(on_card.counts, on_cpu.counts)
    before = ws_ops.launches
    torch_b = MiningSession(g, window=96, kernel_backend="torch").register(*pats).mine()
    assert ws_ops.launches == before
    np.testing.assert_array_equal(torch_b.counts, on_cpu.counts)
    names = ["fan_in", "cycle2", "cycle3", "new_counterparty"]
    seeds = np.arange(g.n_edges, dtype=np.int32)
    wit_cpu = MiningSession(g, window=96, device="cpu").register(*names).mine(names, seeds, witnesses=2)
    before = ws_ops.launches
    wit = MiningSession(g, window=96, kernel_backend="torch").register(*names).mine(names, seeds, witnesses=2)
    assert ws_ops.launches > before  # the extraction has no backend knob
    for n in names:
        np.testing.assert_array_equal(wit.witnesses[n].eids, wit_cpu.witnesses[n].eids, err_msg=n)


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


# D = 1, 3 and 33 take single-word loads, 32 and 128 16-byte vectors;
# large B runs the persistent grid's row loop many times
@pytest.mark.parametrize(
    "b,d",
    [(1, 1), (7, 16), (64, 128), (100, 33), (16384, 128), (4097, 1), (4097, 3), (4097, 32), (4097, 33),
     (1 << 20, 32), (1 << 18, 128), (3, 0)],
)
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
        # wgmma path at qwen2-1.5b's heads: 12 query heads over 2 kv heads
        # (a group of 6), its prefill launch and ragged tiles
        (1, 2048, 2048, 12, 2, 128, True, "bfloat16"),
        (2, 1000, 1000, 12, 2, 128, False, "bfloat16"),
        # wgmma path at the other published widths' heads: a GQA group of 7
        # (deepseek-coder-33b's 56 / 8), of 8 (chameleon-34b's 64 / 8), and
        # musicgen-medium's 24 heads of 64
        (1, 1000, 1000, 7, 1, 128, True, "bfloat16"),
        (1, 1000, 1000, 8, 1, 128, True, "bfloat16"),
        (2, 1000, 1000, 24, 24, 64, True, "bfloat16"),
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


def _feed(seed, n_nodes=150, n_edges=1600, t_span=12_000, n_batches=12):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    fix = src == dst
    dst[fix] = (dst[fix] + 1) % n_nodes
    t = np.sort(rng.integers(0, t_span // 4, n_edges)).astype(np.int64) * 4
    t = np.maximum(0, t + rng.integers(-8, 9, n_edges))
    amt = rng.uniform(1, 500, n_edges).astype(np.float32)
    return [(src[c], dst[c], t[c], amt[c]) for c in np.array_split(np.arange(n_edges), n_batches)]


@pytest.mark.parametrize("pipeline", [False, True])
def test_service_on_card_equals_cpu(cuda, pipeline):
    """A small feed's DetectionService on the card: the same alerts,
    counts, stats and batch recompute as on the CPU, intersect_count
    launched, one host sync per tick."""
    from repro_torch.stream import DetectionService

    names = list(feature_pattern_set("full"))
    kw = dict(thresholds={"cycle3": 1, "scatter_gather": 1, "fan_in": 6}, retain="auto", lateness=2000,
              pipeline=pipeline)
    on_card = DetectionService(names, window=64, **kw)
    on_cpu = DetectionService(names, window=64, device="cpu", **kw)
    ic_ops.launches = 0
    got, want = [], []
    for b in _feed(3):
        got.append(on_card.submit(*b))
        want.append(on_cpu.submit(*b))
    got += on_card.flush()
    want += on_cpu.flush()
    assert ic_ops.launches > 0
    got, want = [b for b in got if b is not None], [b for b in want if b is not None]
    for a, b in zip(got, want):
        for f in ("eids", "counts", "score", "triggered"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert a.report.stats == b.report.stats and not a.report.degraded
    assert on_card.stats["host_syncs"] == on_card.tick == len(_feed(3))
    for n in names:
        np.testing.assert_array_equal(on_card.pattern_counts(n), on_cpu.pattern_counts(n), err_msg=n)
        np.testing.assert_array_equal(on_card.recompute_counts(n), on_cpu.recompute_counts(n), err_msg=n)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_oracle_equals_compiled_on_card(cuda, backend):
    rng = np.random.default_rng(5)
    n, e = 40, 400
    src = rng.integers(0, n, e).astype(np.int32)
    dst = (src + rng.integers(1, n, e).astype(np.int32)) % n
    g = build_temporal_graph(src, dst, rng.integers(0, 600, e).astype(np.int64), n_nodes=n)
    pats = feature_pattern_set("full_deep")
    session = MiningSession(g, window=128, kernel_backend=backend).register(*pats)
    comp = session.mine()
    orc = session.mine(backend="oracle")
    np.testing.assert_array_equal(comp.counts, orc.counts)
    assert (orc.counts != 0).any()
    part = session.mine(backend="partitioned", n_parts=3)
    np.testing.assert_array_equal(part.counts, comp.counts)


def test_recovery_on_card_replays_through_the_kernel(cuda, tmp_path):
    """A resilient service on the card retries a transient fault and
    replays its WAL tail through intersect_count, never through the plain
    version: launches rise in the retried tick and in recover(), and the
    recovered store and counts equal the live ones."""
    from repro_torch.stream import (FaultInjector, ResilienceConfig, ResilientDetectionService,
                                    TransientFault, store_states_equal)

    names = list(feature_pattern_set("full"))
    kw = dict(window=64, thresholds={"cycle3": 1, "scatter_gather": 1, "fan_in": 6}, retain="auto",
              lateness=2000)
    cfg = ResilienceConfig(wal_dir=str(tmp_path / "wal"), checkpoint_dir=str(tmp_path / "ckpt"),
                           checkpoint_every=5, backoff_s=0.0)
    chaos = FaultInjector()
    chaos.arm("mine", tick=3, times=2, exc=TransientFault)
    svc = ResilientDetectionService(names, resilience=cfg, chaos=chaos, **kw)
    feed = _feed(4)
    for i, b in enumerate(feed):
        before = ic_ops.launches
        rep = svc.submit(*b).report
        assert svc.backend == "kernel" and ic_ops.launches > before, i
        if i == 2:
            assert rep.retries == 2 and rep.degraded == ("witnesses_off", "single_device")
    assert svc.wal.ticks() == [11, 12]
    ic_ops.launches = 0
    rec = ResilientDetectionService.recover(names, resilience=cfg, **kw)
    assert rec.backend == "kernel" and ic_ops.launches > 0
    assert rec.tick == svc.tick and store_states_equal(rec.store.state_dict(), svc.store.state_dict())
    for n in names:
        np.testing.assert_array_equal(rec.pattern_counts(n), svc.pattern_counts(n), err_msg=n)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_witnesses_on_card_equal_cpu(cuda, backend):
    """Witness extraction on the card: the same counts, witness eids and
    stats as the CPU port on a dense random graph (sweeps forced by a
    tiny ladder), and exactly one host sync a mine under sync-debug
    "error"."""
    from repro_torch.core.compiler import CompiledPattern
    from repro_torch.core.patterns import PATTERN_NAMES, build_pattern

    rng = np.random.default_rng(13)
    n, e = 24, 240
    src = rng.integers(0, n, e).astype(np.int32)
    dst = (src + rng.integers(1, n, e).astype(np.int32)) % n
    g = build_temporal_graph(src, dst, rng.integers(0, 300, e).astype(np.int64), n_nodes=n)
    seeds = np.arange(0, e, 2, dtype=np.int32)
    tiny = [(n, {"ladder": (2, 4)}) for n in ("cycle5", "peel_chain", "scatter_gather")]
    for name, kw in [(n, {}) for n in PATTERN_NAMES] + tiny:
        spec = build_pattern(name, 96)
        on_card = CompiledPattern(spec, g, backend=backend, **kw)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = on_card.mine(seeds, witnesses=3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        on_cpu = CompiledPattern(spec, g, backend=backend, device="cpu", **kw)
        want = on_cpu.mine(seeds, witnesses=3)
        np.testing.assert_array_equal(got.counts, want.counts, err_msg=name)
        np.testing.assert_array_equal(got.eids, want.eids, err_msg=name)
        assert on_card.stats == on_cpu.stats and on_card.stats["host_syncs"] == 1, name


def test_evidence_service_on_card_equals_cpu(cuda):
    """A DetectionService(witnesses=2) on the card: the same alerts and
    evidence as on the CPU over a small feed, intersect_count launched,
    host syncs == ticks + witness mines (as the CPU counts them)."""
    from repro_torch.stream import DetectionService

    names = ["fan_in", "fan_out", "cycle2", "cycle3", "scatter_gather"]
    kw = dict(thresholds={"fan_in": 4, "fan_out": 4, "cycle2": 1, "cycle3": 1, "scatter_gather": 2},
              witnesses=2)
    on_card = DetectionService(names, window=64, **kw)
    on_cpu = DetectionService(names, window=64, device="cpu", **kw)
    ic_ops.launches = 0
    n_evidence = 0
    for b in _feed(5):
        got, want = on_card.submit(*b), on_cpu.submit(*b)
        assert got.evidence == want.evidence and got.to_rows() == want.to_rows()
        assert got.report.stats == want.report.stats and not got.report.degraded
        n_evidence += sum(len(ev) for ev in got.evidence)
    assert ic_ops.launches > 0 and n_evidence > 0
    assert on_card.stats == on_cpu.stats and on_card.stats["host_syncs"] > on_card.tick


# (B, T, S, H, K, hd, causal, dtype): every short shape of the forward's
# cases above, FraudGT's training shape (B = 256), the whole rows of one
# element at exactly the block's shared-memory limit (T = S = 32, H = 12,
# K = 1, hd 64), whole kv groups taken in chunks (bf16, H = K = 4,
# hd 128) and one group taken in parts whose dK and dV sums carry over
# (bf16, H = 16, K = 1, hd 64); then the ring route's edges: causal T < S
# (keys no row sees), GQA 4:1 at hd 16 in bf16 and hd 32 in float32, an
# lse the stage cannot bulk-copy (H * T = 34, not a multiple of 4), the
# last head count whose two stages fit (T = S = 32, H = K = 7, hd 16) and
# the first that takes the chunked route (8), and a chunked shape in full
# attention (H = K = 3, hd 64)
BWD_CASES = [
    (1024, 17, 17, 8, 8, 16, True, "float32"),
    (1000, 20, 12, 8, 2, 16, True, "float32"),
    (1001, 17, 17, 8, 2, 32, False, "bfloat16"),
    (5003, 17, 17, 8, 8, 16, True, "float32"),
    (37, 32, 32, 2, 2, 128, True, "float32"),
    (9, 32, 32, 2, 1, 64, False, "bfloat16"),
    (3, 1, 1, 8, 8, 16, True, "float32"),
    (256, 17, 17, 8, 8, 16, True, "float32"),
    (2, 32, 32, 12, 1, 64, True, "float32"),
    (5, 32, 32, 4, 4, 128, True, "bfloat16"),
    (3, 32, 32, 16, 1, 64, True, "bfloat16"),
    (300, 12, 20, 8, 2, 16, True, "float32"),
    (700, 17, 17, 8, 2, 16, True, "bfloat16"),
    (700, 17, 17, 8, 2, 32, True, "float32"),
    (333, 17, 17, 2, 1, 16, True, "float32"),
    (40, 32, 32, 7, 7, 16, True, "float32"),
    (20, 32, 32, 8, 8, 16, True, "float32"),
    (6, 32, 32, 3, 3, 64, False, "float32"),
]


def _bwd_case(b, t, s, h, kvh, hd, dtype, seed, device):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return [
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dt).to(device)
        for shape in ((b, t, h, hd), (b, s, kvh, hd), (b, s, kvh, hd), (b, t, h, hd))
    ]


@pytest.mark.parametrize("b,t,s,h,kvh,hd,causal,dtype", BWD_CASES)
def test_flash_attention_bwd_matches_plain(cuda, b, t, s, h, kvh, hd, causal, dtype):
    """The backward kernel against its plain version on the same inputs
    (the forward kernel's o and lse), within 1e-5 in float32 (2e-2
    relative and absolute in bfloat16, the forward's bound: one rounding
    of the output), and bit-identical across two launches (no atomics);
    the .cu takes the route ``short_bwd_route`` names."""
    _check_short_bwd(cuda, b, t, s, h, kvh, hd, causal, dtype)


# the ring route's batch edges at FraudGT's training shape and a bf16 GQA
# shape: B below the persistent grid, equal to it, one past a whole turn
# of the ring (grid x stages elements), and a B that no multiple of the
# grid reaches; B is read from the card's grid at run time
RING_EDGES = ("below", "equal", "turn_plus_one", "ragged")


def ring_edge_batch(edge: str, grid: int, stages: int) -> int:
    return {"below": grid // 2, "equal": grid, "turn_plus_one": grid * stages + 1,
            "ragged": 3 * grid + grid // 3 + 1}[edge]


@pytest.mark.parametrize("edge", RING_EDGES)
@pytest.mark.parametrize("t,s,h,kvh,hd,causal,dtype", [
    (17, 17, 8, 8, 16, True, "float32"),
    (17, 17, 8, 2, 32, False, "bfloat16"),
])
def test_flash_attention_bwd_ring_batch_edges(cuda, edge, t, s, h, kvh, hd, causal, dtype):
    """The ring route at a batch below, at and past its persistent grid:
    the elements each block walks (a stride of the grid, the ring's
    stages reused) all get their gradients, as ``_check_short_bwd``
    holds them."""
    dt = getattr(torch, dtype)
    route, stages = fa_ops.short_bwd_route(1, t, s, h, kvh, hd, dt, causal)
    grid = fa_ops.kernel_short_bwd_grid(1 << 30, t, s, h, kvh, hd, dt)
    assert route == "ring" and grid >= fa_ops.kernel_short_bwd_grid(1, t, s, h, kvh, hd, dt) == 1
    b = ring_edge_batch(edge, grid, stages)
    assert fa_ops.kernel_short_bwd_grid(b, t, s, h, kvh, hd, dt) == min(b, grid)
    _check_short_bwd(cuda, b, t, s, h, kvh, hd, causal, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_bwd_route_matches_kernel(cuda, dtype):
    """The .cu's short-backward route and stage count
    (``flash_attention_bwd_route``) equal ``ops.short_bwd_route`` over a
    grid of short-path shapes: lengths 1 to 32, T > S and T < S, head
    sizes 16 to 128, GQA, both sides of the ring's limit."""
    dt = getattr(torch, dtype)
    seen = set()
    for t, s in ((1, 1), (17, 17), (20, 12), (12, 20), (32, 32), (32, 1), (1, 32)):
        for hd in fa_ops.HEAD_DIMS:
            for h, kvh in ((1, 1), (2, 1), (3, 3), (7, 7), (8, 8), (8, 2), (12, 1), (16, 1), (18, 18), (32, 4)):
                if fa_ops.plan(1, t, s, h, kvh, hd, dt, True) != "short":
                    continue
                want = fa_ops.short_bwd_route(1, t, s, h, kvh, hd, dt, True)
                assert fa_ops.kernel_short_bwd_route(1, t, s, h, kvh, hd, dt, True) == want, (t, s, h, kvh, hd)
                seen.add(want[0])
    assert seen == set(fa_ops.SHORT_BWD_ROUTES)


def _check_short_bwd(cuda, b, t, s, h, kvh, hd, causal, dtype):
    q, k, v, do = _bwd_case(b, t, s, h, kvh, hd, dtype, b + t + s + hd, cuda)
    assert fa_ops.kernel_short_bwd_route(b, t, s, h, kvh, hd, q.dtype, causal) == fa_ops.short_bwd_route(
        b, t, s, h, kvh, hd, q.dtype, causal)
    before = (fa_ops.launches, fa_ops.lse_launches, fa_ops.bwd_launches)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert (fa_ops.launches, fa_ops.lse_launches, fa_ops.bwd_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    # the plain version in float32 on the same (upcast) values, dk and dv
    # summed over each group before the one rounding to the output type
    g = h // kvh
    flat = lambda x, n: x.float().transpose(1, 2).reshape(-1, n, hd)
    want = flash_attention_bwd_ref(
        flat(q, t), flat(k.repeat_interleave(g, 2), s), flat(v.repeat_interleave(g, 2), s), flat(o, t),
        flat(do, t), lse.reshape(-1, t), causal=causal)
    fold = lambda x: x.reshape(b, kvh, g, s, hd).sum(2).transpose(1, 2)
    want = (want[0].reshape(b, h, t, hd).transpose(1, 2), fold(want[1]), fold(want[2]))
    rtol, atol = (2e-2, 2e-2) if dtype == "bfloat16" else (0.0, 1e-5)
    for name, x, y, z in zip("qkv", got, again, want):
        assert x.dtype == q.dtype and torch.equal(x, y), name
        torch.testing.assert_close(x.float(), z, rtol=rtol, atol=atol, msg=name)
    assert fa_ops.bwd_chunk_heads(b, t, s, h, kvh, hd, q.dtype) >= 1


def test_flash_attention_bwd_off_the_short_path_raises(cuda):
    """The shape that raised before the long backward existed (T = S = 40)
    now runs it: the simt route, as the .cu entry plans it, no short-path
    chunk, and zero gradients from a zero output gradient."""
    q = torch.zeros(1, 40, 2, 16, device=cuda)
    assert fa_ops.bwd_chunk_heads(1, 40, 40, 2, 2, 16, torch.float32) == 0
    assert fa_ops.bwd_plan(1, 40, 40, 2, 2, 16, torch.float32, True) == "simt"
    assert fa_ops.kernel_bwd_plan(1, 40, 40, 2, 2, 16, torch.float32, True) == "simt"
    before = (fa_ops.bwd_launches, fa_ops.long_bwd_launches)
    got = fa_ops.flash_attention_bwd(q, q, q, q, q, torch.zeros(1, 2, 40, device=cuda))
    assert (fa_ops.bwd_launches, fa_ops.long_bwd_launches) == (before[0] + 1, before[1] + 1)
    assert all(x.shape == q.shape and not bool(x.any()) for x in got)


# the long backward (T or S above 32): qwen2-1.5b's layer at 512 rows,
# full bf16 at hd 64, ragged tiles (1,000), causal T > S and T < S, float32
# at hd 16 and 128 with GQA (simt), bf16 at hd 32 (simt), one key; then
# the wgmma route's tile edges (64-row stages, 128-row and 128-key
# blocks): T = S = 127, 129 and 257 at hd 64 and 128, causal and full,
# and a group of 8 query heads over one kv head; each (B, T, S, H, K, hd,
# causal, dtype) with the path bwd_plan names
LONG_BWD_CASES = [
    (1, 512, 512, 12, 2, 128, True, "bfloat16", "wgmma"),
    (2, 256, 256, 4, 4, 64, False, "bfloat16", "wgmma"),
    (1, 1000, 1000, 4, 2, 128, True, "bfloat16", "wgmma"),
    (2, 200, 90, 4, 2, 64, True, "bfloat16", "wgmma"),
    (1, 90, 200, 4, 1, 128, True, "bfloat16", "wgmma"),
    (2, 300, 300, 8, 2, 16, True, "float32", "simt"),
    (1, 200, 200, 6, 2, 128, True, "float32", "simt"),
    (2, 150, 150, 4, 2, 32, False, "bfloat16", "simt"),
    (3, 70, 1, 4, 4, 64, True, "bfloat16", "wgmma"),
    (2, 127, 127, 4, 2, 64, True, "bfloat16", "wgmma"),
    (1, 127, 127, 8, 1, 128, False, "bfloat16", "wgmma"),
    (1, 129, 129, 4, 2, 128, True, "bfloat16", "wgmma"),
    (2, 129, 129, 8, 1, 64, False, "bfloat16", "wgmma"),
    (1, 257, 257, 8, 1, 128, True, "bfloat16", "wgmma"),
    (1, 257, 257, 4, 4, 64, True, "bfloat16", "wgmma"),
]


@pytest.mark.parametrize("b,t,s,h,kvh,hd,causal,dtype,path", LONG_BWD_CASES)
def test_flash_attention_long_bwd_matches_plain(cuda, b, t, s, h, kvh, hd, causal, dtype, path):
    """The long backward against its plain version on the forward kernel's
    o and lse (the forward's lse first against the plain logsumexp), within
    1e-5 in float32 and 2e-2 relative and absolute in bf16, bit-identical
    across two launches; ``bwd_plan`` equals the .cu entry's choice."""
    q, k, v, do = _bwd_case(b, t, s, h, kvh, hd, dtype, b + t + s + hd, cuda)
    assert fa_ops.bwd_plan(b, t, s, h, kvh, hd, q.dtype, causal) == path
    assert fa_ops.kernel_bwd_plan(b, t, s, h, kvh, hd, q.dtype, causal) == path
    before = (fa_ops.lse_launches, fa_ops.bwd_launches, fa_ops.long_bwd_launches)
    o, lse = flash_attention(q, k, v, causal=causal, block_k=s, return_lse=True)
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert (fa_ops.lse_launches, fa_ops.bwd_launches, fa_ops.long_bwd_launches) == (
        before[0] + 1, before[1] + 2, before[2] + 2)
    g = h // kvh
    flat = lambda x, n: x.float().transpose(1, 2).reshape(-1, n, hd)
    kk, vv = flat(k.repeat_interleave(g, 2), s), flat(v.repeat_interleave(g, 2), s)
    _, want_lse = fa_ops.flash_attention_ref(flat(q, t), kk, vv, causal=causal, return_lse=True)
    torch.testing.assert_close(lse.reshape(-1, t), want_lse, rtol=0, atol=1e-4 if dtype == "bfloat16" else 1e-5)
    want = flash_attention_bwd_ref(flat(q, t), kk, vv, flat(o, t), flat(do, t), lse.reshape(-1, t), causal=causal)
    fold = lambda x: x.reshape(b, kvh, g, s, hd).sum(2).transpose(1, 2)
    want = (want[0].reshape(b, h, t, hd).transpose(1, 2), fold(want[1]), fold(want[2]))
    rtol, atol = (2e-2, 2e-2) if dtype == "bfloat16" else (0.0, 1e-5)
    for name, x, y, z in zip("qkv", got, again, want):
        assert x.dtype == q.dtype and torch.equal(x, y), name
        torch.testing.assert_close(x.float(), z, rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_tiles_match_kernel(cuda, causal):
    """The wgmma route's tile loops as the built .cu computes them
    (``flash_attention_bwd_tiles``) equal ``ops.bwd_tiles`` at ragged T and
    S around the tiles, T > S and T < S, and the training launch's 4,096."""
    lengths = (1, 63, 64, 65, 127, 128, 129, 257, 1000, 4096)
    for t in lengths:
        for s in lengths:
            assert fa_ops.kernel_bwd_tiles(t, s, causal) == fa_ops.bwd_tiles(t, s, causal), (t, s)


def test_lm_train_on_card_equals_cpu(cuda, tmp_path):
    """Four steps of ``launch.train.train_loop`` on the qwen2-1.5b smoke
    config in float32 at T = 64 (the long backward's simt route), on the
    card and on the CPU port, from one step-0 checkpoint: losses within
    1e-4 relative, parameters within 1e-4 (the embedding gradient's
    atomics sum in another order on the card)."""
    import dataclasses
    import shutil

    from repro_torch.distributed.checkpoint import save_checkpoint
    from repro_torch.distributed.optimizer import adamw_init
    from repro_torch.launch import train as T

    cfg = dataclasses.replace(smoke_config("qwen2-1.5b"), dtype="float32")
    p = LMM.init_params(cfg, 0, device="cpu")
    as_np = lambda tree: LMM.tree_map(lambda a: a.numpy(), tree)
    save_checkpoint(str(tmp_path / "card"), 0, (as_np(p), as_np(adamw_init(p))))
    shutil.copytree(tmp_path / "card", tmp_path / "cpu")
    before = (fa_ops.launches, fa_ops.long_bwd_launches)
    pd, ld = T.train_loop(cfg, 4, 2, 64, ckpt_dir=str(tmp_path / "card"), verbose=False)
    n_attn = sum(bt in ("attn", "moe_attn", "shared_attn") for bt in cfg.unit) * cfg.n_units
    assert fa_ops.long_bwd_launches == before[1] + 4 * n_attn
    pc, lc = T.train_loop(cfg, 4, 2, 64, ckpt_dir=str(tmp_path / "cpu"), verbose=False, device="cpu")
    np.testing.assert_allclose(ld, lc, rtol=1e-4)
    for a, c in zip(LMM.tree_leaves(pd), LMM.tree_leaves(pc)):
        torch.testing.assert_close(a.cpu(), c, rtol=0, atol=1e-4)


def test_lm_mesh_train_on_card_equals_plain(cuda, tmp_path):
    """The sharded train step on a (1, 1) NCCL mesh (world size 1, a
    ``FileStore`` under the test's directory) at the qwen2-1.5b smoke
    width in float32, T = 64: two steps from the plain step's init and
    batches give losses within 1e-4 and parameters within 5e-3 of the
    plain step's, keep every leaf's placements, make no host sync, and
    launch the forward (with the logsumexp) twice and the long backward
    once per attention layer a step, on the kernels."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.distributed.optimizer import AdamWConfig, _leaves, adamw_init
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_local_mesh

    cfg = dataclasses.replace(smoke_config("qwen2-1.5b"), dtype="float32")
    ocfg = AdamWConfig(lr=1e-3)
    batches = [T.synthetic_batch(cfg, 2, 64, i, cuda) for i in range(2)]
    params = LMM.init_params(cfg, 0, device=cuda)
    p, o = params, adamw_init(params)
    step = T.make_train_step(cfg, ocfg)
    plain = []
    for b in batches:
        p, o, loss, _ = step(p, o, b)
        plain.append(float(loss))
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_local_mesh(1, 1)
        ps, os_ = T.place_state(mesh, params, adamw_init(params))
        pl_in = [a.placements for a in _leaves(ps)]
        sstep = T.make_sharded_train_step(cfg, ocfg, mesh)
        n_attn = sum(bt in ("attn", "moe_attn", "shared_attn") for bt in cfg.unit) * cfg.n_units
        for b, want in zip(batches, plain):
            bs = T.place_batch(mesh, b)
            torch.cuda.synchronize()
            before = (fa_ops.lse_launches, fa_ops.long_bwd_launches)
            torch.cuda.set_sync_debug_mode("error")
            try:
                ps, os_, loss, _ = sstep(ps, os_, bs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert (fa_ops.lse_launches - before[0], fa_ops.long_bwd_launches - before[1]) == (2 * n_attn, n_attn)
            assert abs(float(loss) - want) < 1e-4
        assert [a.placements for a in _leaves(ps)] == pl_in
        for a, c in zip(_leaves(ps), _leaves(p)):
            assert float((a.full_tensor() - c).abs().max()) < 5e-3
    finally:
        dist.destroy_process_group()


def _small_graph(seed=11, n_nodes=18, n_edges=140, t_max=256):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst[src == dst] = (dst[src == dst] + 1) % n_nodes
    return build_temporal_graph(src, dst, rng.integers(0, t_max, n_edges), n_nodes=n_nodes)


@pytest.mark.parametrize("n_parts,mode", [(1, "collective"), (3, "host")])
def test_sharded_mine_on_card_equals_compiled(cuda, n_parts, mode):
    """One card: partitions time-share it (host gather) or map onto it one
    to one (the device-side sum), one host sync either way, counts equal
    to the compiled mine, the per-shard stats summing to the totals."""
    g = _small_graph()
    session = MiningSession(g, window=96).register(*feature_pattern_set("full"))
    base = session.mine()
    seeds = np.array([5, 5, 7, 11, 2, 9, 0, 130], dtype=np.int32)
    base_seeds = session.mine(seeds=seeds)
    before = ic_ops.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = session.mine(backend="sharded", n_parts=n_parts)
        dup = session.mine(seeds=seeds, backend="sharded", n_parts=n_parts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ic_ops.launches > before
    np.testing.assert_array_equal(res.counts, base.counts)
    np.testing.assert_array_equal(dup.counts, base_seeds.counts)
    for r in (res, dup):
        assert r.gather_mode == mode and r.stats["host_syncs"] == 1
        assert set(r.shard_devices) == {"cuda:0"}
        for key in ("kernel_calls", "padded_elements", "bytes_h2d"):
            assert r.stats[key] == sum(st[key] for st in r.shard_stats), key


def test_fraudgt_fit_on_card_makes_no_host_sync(cuda):
    """A fit on the card under set_sync_debug_mode("error"): every step's
    attention runs through the forward (with lse) and backward kernels,
    and the losses, read after, are finite."""
    rng = np.random.default_rng(3)
    n = 1200
    src = rng.integers(0, 60, n).astype(np.int32)
    dst = rng.integers(0, 60, n).astype(np.int32)
    dst[src == dst] = (dst[src == dst] + 1) % 60
    g = build_temporal_graph(src, dst, rng.integers(0, 4096, n), rng.lognormal(5, 1, n), n_nodes=60)
    labels = (rng.random(n) < 0.1).astype(np.float32)
    p = FraudGTParams(d_model=64, n_layers=2, n_heads=4, batch=64, epochs=2)
    ft = FraudGT(p, seed=2)
    ids = np.arange(1000)
    before = (fa_ops.lse_launches, fa_ops.bwd_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ft.fit(g, labels, ids)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    steps = p.epochs * (len(ids) // p.batch)
    assert ft.fit_seconds["steps"] == steps
    assert (fa_ops.lse_launches - before[0], fa_ops.bwd_launches - before[1]) == (
        p.n_layers * steps, p.n_layers * steps)
    losses = ft.losses.cpu().numpy()
    assert losses.shape == (steps,) and np.isfinite(losses).all()
    proba = ft.predict_proba(g, np.arange(1000, n))
    assert np.isfinite(proba).all() and proba.std() > 0


@pytest.mark.parametrize(
    "name",  # a smoke config per block type: attn (qkv bias), moe_attn, mamba2 + shared_attn,
    # mlstm + slstm, the audio stub, qk-norm
    ["qwen2-1.5b", "mixtral-8x7b", "zamba2-2.7b", "xlstm-125m", "musicgen-medium", "chameleon-34b"],
)
def test_lm_smoke_on_card_equals_cpu(cuda, name):
    """Forward logits, aux and loss in float32 within 1e-4 of the CPU port
    with the same weights, every attention block through the kernel; and
    (token models) decode steps within 1e-4 of the CPU's."""
    import dataclasses

    cfg = dataclasses.replace(smoke_config(name), dtype="float32")
    p = LMM.init_params(cfg, 0, device="cpu")
    pd = LMM.tree_map(lambda a: a.to(cuda), p)
    rng = np.random.default_rng(7)
    b, t = 2, 16
    if cfg.precomputed_embeddings:
        batch = {"embeds": torch.from_numpy(rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)),
                 "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (b, t, cfg.n_codebooks)))}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, t))),
                 "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (b, t)))}
    on = {k: v.to(cuda) for k, v in batch.items()}
    n_attn = sum(bt in ("attn", "moe_attn", "shared_attn") for bt in cfg.unit) * cfg.n_units
    before = fa_ops.launches
    with torch.inference_mode():
        lg, aux = LMM.forward(pd, on, cfg)
        loss = LMM.loss_fn(pd, on, cfg)
        assert fa_ops.launches == before + 2 * n_attn
        lg_c, aux_c = LMM.forward(p, batch, cfg)
        loss_c = LMM.loss_fn(p, batch, cfg)
    torch.testing.assert_close(lg.cpu(), lg_c, rtol=1e-4, atol=1e-4)
    assert abs(float(aux) - float(aux_c)) <= 1e-4 and abs(float(loss) - float(loss_c)) <= 1e-4 * float(loss_c)
    if cfg.precomputed_embeddings:
        return
    with torch.inference_mode():
        caches = [LMM.cache_init(cfg, b, 6, device=d) for d in (cuda, "cpu")]
        for i in range(6):
            got, _ = LMM.decode_step(pd, caches[0], {"tokens": on["tokens"][:, i : i + 1]}, cfg)
            want, _ = LMM.decode_step(p, caches[1], {"tokens": batch["tokens"][:, i : i + 1]}, cfg)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_lm_prefill_at_qwen2_widths_runs_the_wgmma_path(cuda):
    """qwen2-1.5b's widths (d_model 1,536, 12/2 heads of 128, vocab 151,936)
    at two layers, bf16, T = 256: one wgmma-path launch a layer, finite
    logits, close to the torch backend."""
    import dataclasses

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    p = LMM.init_params(cfg, 0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (2, 256))).to(cuda)
    assert fa_ops.plan(2, 256, 256, 12, 2, 128, torch.bfloat16, True) == "wgmma"
    before = fa_ops.launches
    with torch.inference_mode():
        lg, _ = LMM.forward(p, {"tokens": toks}, cfg)
        assert fa_ops.launches == before + cfg.n_layers
        lt, _ = LMM.forward(p, {"tokens": toks}, cfg, attn_backend="torch")
    assert lg.dtype == torch.bfloat16 and lg.shape == (2, 256, cfg.vocab) and bool(torch.isfinite(lg).all())
    # bf16 logits (an ulp is 2^-7 near 1) after two layers rounded apart:
    # close, and mostly the same next token
    assert float((lg.float() - lt.float()).abs().max()) < 0.5
    assert float((lg.argmax(-1) == lt.argmax(-1)).float().mean()) > 0.5


# A sliding window on every path and route, forward and backward, and head
# size 80 (zamba2-2.7b's) in bf16 (wgmma) and float32 (simt); each (B, T,
# S, H, K, hd, window, dtype, path) with the path plan names.  Windows
# below T, at T and above T; the short path on its ring and chunked
# routes; T > S where every row still sees a key; GQA.
WINDOW_CASES = [
    (64, 17, 17, 8, 2, 16, 5, "float32", "short"),
    (64, 32, 32, 4, 4, 64, 32, "bfloat16", "short"),
    (64, 20, 12, 8, 2, 32, 40, "float32", "short"),
    (20, 32, 32, 8, 8, 16, 9, "float32", "short"),  # the short backward's chunked route
    (2, 300, 300, 4, 2, 32, 64, "float32", "simt"),
    (1, 257, 257, 4, 1, 16, 257, "bfloat16", "simt"),
    (1, 300, 200, 4, 2, 64, 500, "float32", "simt"),
    (1, 1000, 1000, 8, 2, 128, 200, "bfloat16", "wgmma"),
    (2, 600, 600, 4, 4, 64, 129, "bfloat16", "wgmma"),
    (1, 4096, 4096, 4, 1, 128, 4096, "bfloat16", "wgmma"),
    (1, 700, 500, 4, 2, 64, 1000, "bfloat16", "wgmma"),
    (1, 2048, 2048, 4, 4, 80, 333, "bfloat16", "wgmma"),
    (1, 200, 200, 4, 2, 80, 50, "float32", "simt"),
    (1, 1000, 1000, 2, 2, 80, None, "bfloat16", "wgmma"),
    (1, 300, 300, 2, 1, 80, None, "float32", "simt"),
    (3, 33, 33, 2, 2, 80, None, "float32", "simt"),
    (5, 17, 17, 4, 4, 80, 8, "bfloat16", "wgmma"),
]


@pytest.mark.parametrize("b,t,s,h,kvh,hd,window,dtype,path", WINDOW_CASES)
def test_flash_attention_window_and_hd80_match_plain(cuda, b, t, s, h, kvh, hd, window, dtype, path):
    """The forward kernel within the dtype's tolerance of its plain version
    (its logsumexp within 1e-5, 1e-4 in bf16), and the backward kernel on
    the forward's o and lse within 1e-5 (float32) or 2e-2 relative and
    absolute (bf16) of its plain version, bit-identical across two
    launches; plan and bwd_plan equal the .cu's choices."""
    q, k, v, do = _bwd_case(b, t, s, h, kvh, hd, dtype, b + t + s + hd, cuda)
    assert fa_ops.plan(b, t, s, h, kvh, hd, q.dtype, True) == path
    assert fa_ops.kernel_plan(b, t, s, h, kvh, hd, q.dtype, True) == path
    assert fa_ops.kernel_bwd_plan(b, t, s, h, kvh, hd, q.dtype, True) == fa_ops.bwd_plan(
        b, t, s, h, kvh, hd, q.dtype, True)
    before = (fa_ops.launches, fa_ops.bwd_launches)
    o, lse = flash_attention(q, k, v, window=window, return_lse=True)
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    assert (fa_ops.launches, fa_ops.bwd_launches) == (before[0] + 1, before[1] + 2)
    g = h // kvh
    flat = lambda x, n: x.float().cpu().transpose(1, 2).reshape(-1, n, hd)
    kk, vv = flat(k.repeat_interleave(g, 2), s), flat(v.repeat_interleave(g, 2), s)
    want_o, want_lse = fa_ops.flash_attention_ref(flat(q, t), kk, vv, return_lse=True, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(flat(o, t), want_o, rtol=tol, atol=tol)
    torch.testing.assert_close(lse.cpu().reshape(-1, t), want_lse, rtol=0,
                               atol=1e-4 if dtype == "bfloat16" else 1e-5)
    want = flash_attention_bwd_ref(flat(q, t), kk, vv, flat(o, t), flat(do, t), lse.cpu().reshape(-1, t),
                                   window=window)
    fold = lambda x: x.reshape(b, kvh, g, s, hd).sum(2).transpose(1, 2)
    want = (want[0].reshape(b, h, t, hd).transpose(1, 2), fold(want[1]), fold(want[2]))
    rtol, atol = (2e-2, 2e-2) if dtype == "bfloat16" else (0.0, 1e-5)
    for name, x, y, z in zip("qkv", got, again, want):
        assert x.dtype == q.dtype and torch.equal(x, y), name
        torch.testing.assert_close(x.float().cpu(), z, rtol=rtol, atol=atol, msg=name)


def test_flash_attention_window_tiles_match_kernel(cuda):
    """The wgmma forward's and the long backward's tile loops as the built
    .cu computes them (``flash_attention_fwd_tiles``,
    ``flash_attention_bwd_tiles``) equal ``ops.fwd_tiles`` and
    ``ops.bwd_tiles`` under windows below, at and above T, T > S and T < S,
    and zamba2's and mixtral's prefill (T = S = 32,768, window 4,096)."""
    lengths = (1, 63, 64, 127, 129, 257, 1000, 4096)
    for t in lengths:
        for s in lengths:
            for window in (None, 1, 64, 100, 128, 129, 1000, 5000):
                if window is not None and t > s + window - 1:
                    continue
                assert fa_ops.kernel_fwd_tiles(t, s, True, window) == fa_ops.fwd_tiles(t, s, True, window)
                assert fa_ops.kernel_bwd_tiles(t, s, True, window) == fa_ops.bwd_tiles(t, s, True, window)
    assert fa_ops.kernel_fwd_tiles(32768, 32768, True, 4096) == fa_ops.fwd_tiles(32768, 32768, True, 4096)
    assert fa_ops.kernel_bwd_tiles(32768, 32768, True, 4096) == fa_ops.bwd_tiles(32768, 32768, True, 4096)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "zamba2-2.7b"])
def test_lm_windowed_gradient_on_card_equals_cpu(cuda, name):
    """``loss_fn``'s gradient in float32 at T = 64 > the smoke configs'
    window of 32, every attention block through the windowed kernels both
    ways on the card, within 1e-4 of each leaf's largest |g| of the CPU
    port's (the plain versions)."""
    import dataclasses

    cfg = dataclasses.replace(smoke_config(name), dtype="float32")
    if cfg.moe is not None:  # room in the experts: no drop in either dispatch
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    assert cfg.attn_window == 32
    p = LMM.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(9)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))}
    n_attn = sum(bt in ("attn", "moe_attn", "shared_attn") for bt in cfg.unit) * cfg.n_units

    def grads(params, b):
        leaves = [a.detach().requires_grad_() for a in LMM.tree_leaves(params)]
        it = iter(leaves)
        loss = LMM.loss_fn(LMM.tree_map(lambda _: next(it), params), b, cfg)
        return float(loss), torch.autograd.grad(loss, leaves, allow_unused=True)

    before = (fa_ops.lse_launches, fa_ops.long_bwd_launches)
    loss_d, g_d = grads(LMM.tree_map(lambda a: a.to(cuda), p), {k: v.to(cuda) for k, v in batch.items()})
    assert (fa_ops.lse_launches, fa_ops.long_bwd_launches) == (before[0] + 2 * n_attn, before[1] + n_attn)
    loss_c, g_c = grads(p, batch)
    assert abs(loss_d - loss_c) <= 1e-5 * abs(loss_c)
    for gd, gc in zip(g_d, g_c):
        if gc is None:
            assert gd is None or not bool(gd.any())
            continue
        scale = max(float(gc.abs().max()), 1e-30)
        assert float((gd.cpu() - gc).abs().max()) <= 1e-4 * scale


def test_moe_apply_on_card_is_deterministic(cuda):
    """The MoE layer at moonshot-v1-16b-a3b's routing (64 experts, top-6,
    capacity 1.25, where tokens drop) in bf16 on the card: two calls on one
    input give the same bits (the combine adds each token's choices in
    order, without atomics), and the float32 layer is within 1e-5 of the
    output's scale of the CPU port's."""
    import dataclasses

    from repro_torch.models import layers as LML

    cfg = smoke_config("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=64, top_k=6, d_expert_ff=64))
    p = LML.moe_init(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4096, cfg.d_model)).astype(np.float32))
    pd = {k: v.to(cuda) for k, v in p.items()}
    with torch.inference_mode():
        _, _, _, _, _, keep, _ = LML._moe_route(pd, x.to(cuda), cfg)
        assert not bool(keep.all())
        xb = x.to(cuda, torch.bfloat16)
        first, _ = LML.moe_apply(pd, xb, cfg)
        for _ in range(3):
            assert torch.equal(LML.moe_apply(pd, xb, cfg)[0], first)
        y32, _ = LML.moe_apply(pd, x.to(cuda), cfg)
        y_cpu, _ = LML.moe_apply(p, x, cfg)
    assert float((y32.cpu() - y_cpu).abs().max()) <= 1e-5 * float(y_cpu.abs().max())


EXAMPLE_FLAGS = {
    "quickstart": ["--scale", "0.05", "--trees", "2"],
    "streaming_detection": ["--scale", "0.05", "--batches", "2"],
    "train_aml_pipeline": ["--scale", "0.05", "--trees", "2", "--epochs", "1"],
    "serve_lm": ["--batch", "2", "--prompt", "3", "--gen", "2", "--cache", "6"],
    "trace_capture": ["--scale", "0.05"],
}


@pytest.mark.parametrize("name", list(EXAMPLE_FLAGS))
def test_example_on_card_reaches_its_kernels(cuda, name, tmp_path):
    """Each of the JAX package's examples, as the port's entry point, on
    the card at its smallest flags (no ``--device``: the card is the
    default): the mining examples launch ``intersect_count``, the
    pipelines both ``hist_update`` entries, FraudGT's fit the attention
    forward with the logsumexp and its backward, and serving no
    attention kernel (``generate`` decodes through torch ops)."""
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    flags = EXAMPLE_FLAGS[name] + (["--out-dir", str(tmp_path)] if name == "trace_capture" else [])
    ic_ops.launches = hu_ops.launches = hu_ops.rows_launches = 0
    fa_ops.launches = fa_ops.lse_launches = fa_ops.bwd_launches = 0
    out = mod.main(flags)
    got = {"ic": ic_ops.launches, "hu": hu_ops.launches, "hu_rows": hu_ops.rows_launches,
           "fa": fa_ops.launches, "fa_lse": fa_ops.lse_launches, "fa_bwd": fa_ops.bwd_launches}
    if name in ("quickstart", "streaming_detection", "trace_capture", "train_aml_pipeline"):
        assert got["ic"] > 0, got
    if name in ("quickstart", "train_aml_pipeline"):
        assert got["hu"] > got["hu_rows"] > 0, got
    if name == "train_aml_pipeline":
        assert got["fa"] > 0 and got["fa_lse"] > 0 and got["fa_bwd"] > 0, got
        assert np.isfinite(out["fraudgt_proba"]).all()
    else:
        assert got["fa"] == 0, got
    if name == "trace_capture":
        assert {f"dispatch:shard{k}" for k in range(8)} <= set(out["span_names"]["sharded_mine"])
    if name == "serve_lm":
        assert all(r["shape"] == (2, 5) for r in out.values())
