"""Swept buckets under the port's ``backend="kernel"`` against the JAX
package: a tiny ladder makes the frontier dims and the intersect dims both
sweep, and every bs1 / bs2 intersect step goes through the
``window_search`` wrapper's ``intersect_step`` (on the CPU its plain
version), every pairwise (``pw``) intersect and pairwise ``count_edges``
through the ``intersect_count`` wrapper's ``pair_step``, one call per
frontier-dim combo of a swept bucket, the intersect dims' offsets inside
the call.  Counts and ``stats`` must equal the JAX package's (``_pair``),
forced ``pw`` mines on both port backends against both of its."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.compiler as JC
import repro_torch.core.compiler as TC
from repro.core.patterns import PATTERN_NAMES, build_pattern
from repro_torch.kernels.intersect_count import ops as ic_ops
from repro_torch.kernels.window_search import ops as ws_ops
from tests.test_torch_compiler import BACKENDS, W, _pair, dense  # noqa: F401  (a fixture)

LADDER = (2, 4)


@pytest.mark.parametrize("name", PATTERN_NAMES)
def test_every_library_pattern_with_sweeps_on_the_kernel_backend(dense, name):  # noqa: F811
    _pair(build_pattern(name, W), dense, *BACKENDS[0], ladder=LADDER)


INTERSECT_PATTERNS = ("cycle4", "scatter_gather", "cycle5")


@pytest.fixture
def step_calls(monkeypatch):
    """Each call of a compiled callable with the intersect_step calls it
    made: (strategy, dims, sweeps, k, [the n_sweep of each call])."""
    rounds = []
    orig_kernel = TC.CompiledPattern._kernel
    orig_step = ws_ops.intersect_step

    def kernel(self, strat, dims, sweeps, branch=False):
        fn = orig_kernel(self, strat, dims, sweeps, branch)
        k = len(self.ir.frontiers)

        def run(*a):
            rounds.append((strat, dims, tuple(sweeps) or (1,) * len(dims), k, []))
            return fn(*a)

        return run

    def step(*a, **kw):
        rounds[-1][-1].append(kw["n_sweep"])
        return orig_step(*a, **kw)

    monkeypatch.setattr(TC.CompiledPattern, "_kernel", kernel)
    monkeypatch.setattr(ws_ops, "intersect_step", step)
    return rounds


@pytest.mark.parametrize("strategy", ["bs1", "bs2"])
@pytest.mark.parametrize("name", INTERSECT_PATTERNS)
def test_one_intersect_step_call_per_frontier_combo(dense, step_calls, name, strategy, monkeypatch):  # noqa: F811
    # every seed down the bulk path, where the first frontier level sweeps
    # too (the hub branch decomposition makes that level one wide)
    monkeypatch.setattr(JC, "BRANCH_DECOMP_COST", float("inf"))
    monkeypatch.setattr(TC, "BRANCH_DECOMP_COST", float("inf"))
    _pair(build_pattern(name, W), dense, *BACKENDS[0], ladder=(1, 2), force_strategy=strategy)
    swept_frontier = swept_intersect = 0
    for strat, dims, sweeps, k, calls in step_calls:
        if strat not in (0, 1):
            assert calls == []  # pw: intersect_count's pair_step
            continue
        j = k + strat
        frontier_combos = math.prod(sweeps[:k])
        assert calls == [sweeps[j]] * frontier_combos, (dims, sweeps, calls)
        swept_frontier += frontier_combos > 1
        swept_intersect += sweeps[j] > 1
    # the ladder made both the intersect dim and the frontier dims sweep
    assert swept_intersect > 0 and swept_frontier > 0


def test_torch_backend_runs_no_intersect_step(dense, step_calls):  # noqa: F811
    _pair(build_pattern("cycle4", W), dense, *BACKENDS[1], ladder=LADDER, force_strategy="bs1")
    assert step_calls and all(calls == [] for *_, calls in step_calls)


PW_PATTERNS = ("cycle3", "cycle4", "scatter_gather", "cycle5")


@pytest.mark.parametrize("ladder", [None, LADDER], ids=["unswept", "swept"])
@pytest.mark.parametrize("jax_backend", ["pallas", "xla"])
@pytest.mark.parametrize("port_backend", ["kernel", "torch"])
@pytest.mark.parametrize("name", PW_PATTERNS)
def test_forced_pw_mines_equal_jax(dense, name, port_backend, jax_backend, ladder):  # noqa: F811
    """Every seed on the pw strategy (cycle3's pairwise count_edges, the
    intersect of the others), at the default ladder and swept: counts and
    stats equal to the JAX package's under either of its backends."""
    kw = {"ladder": ladder} if ladder else {}
    _pair(build_pattern(name, W), dense, jax_backend, port_backend, force_strategy="pw", **kw)


@pytest.fixture
def pair_calls(monkeypatch):
    """Each call of a compiled callable with the pair_step calls it made:
    (strategy, dims, sweeps, k, [(n_sweep_a, n_sweep_b) of each call])."""
    rounds = []
    orig_kernel = TC.CompiledPattern._kernel
    orig_step = ic_ops.pair_step

    def kernel(self, strat, dims, sweeps, branch=False):
        fn = orig_kernel(self, strat, dims, sweeps, branch)
        k = len(self.ir.frontiers)

        def run(*a):
            rounds.append((strat, dims, tuple(sweeps) or (1,) * len(dims), k, []))
            return fn(*a)

        return run

    def step(*a, **kw):
        rounds[-1][-1].append((kw.get("n_sweep_a", 1), kw["n_sweep_b"]))
        return orig_step(*a, **kw)

    monkeypatch.setattr(TC.CompiledPattern, "_kernel", kernel)
    monkeypatch.setattr(ic_ops, "pair_step", step)
    return rounds


@pytest.mark.parametrize("name", PW_PATTERNS)
def test_one_pair_step_call_per_frontier_combo(dense, pair_calls, name, monkeypatch):  # noqa: F811
    # every seed down the bulk path, where the first frontier level sweeps
    # too (the hub branch decomposition makes that level one wide)
    monkeypatch.setattr(JC, "BRANCH_DECOMP_COST", float("inf"))
    monkeypatch.setattr(TC, "BRANCH_DECOMP_COST", float("inf"))
    _pair(build_pattern(name, W), dense, *BACKENDS[0], ladder=LADDER, force_strategy="pw")
    swept_frontier = swept_intersect = 0
    for strat, dims, sweeps, k, calls in pair_calls:
        assert strat == 2
        frontier_combos = math.prod(sweeps[:k])
        # cycle3's count_edges expands no frontier row: one a step
        inner = (1 if name == "cycle3" else sweeps[k], sweeps[k + 1])
        assert calls == [inner] * frontier_combos, (dims, sweeps, calls)
        swept_frontier += frontier_combos > 1
        swept_intersect += math.prod(inner) > 1
    # the ladder made both the intersect dims and the frontier dims sweep
    assert swept_intersect > 0 and swept_frontier > 0


def test_torch_backend_runs_no_pair_step(dense, pair_calls):  # noqa: F811
    _pair(build_pattern("cycle4", W), dense, *BACKENDS[1], ladder=LADDER, force_strategy="pw")
    assert pair_calls and all(calls == [] for *_, calls in pair_calls)


def _ir(**stages):
    """A stand-in IR: each stage a product of factors, or a count (None)."""
    op = lambda f: SimpleNamespace(op="product", factors=f) if f else SimpleNamespace(op="count")  # noqa: E731
    return SimpleNamespace(nodes={n: SimpleNamespace(stage=op(f)) for n, f in stages.items()})


def test_which_emits_are_linear_in_the_intersect():
    """The sum over the intersect's offsets may be taken before the emit
    only where the emit is linear in the intersect's count; otherwise (a
    square) the grid stays the callable's loop, one call a combo."""
    ir = _ir(close=None, c=None, p=("close", "c"), pp=("p", "c"), sq=("close", "close"), sq2=("p", "close"))
    assert TC._linear_in(ir, "close", "close")
    assert TC._linear_in(ir, "p", "close") and TC._linear_in(ir, "pp", "close")
    assert not TC._linear_in(ir, "sq", "close") and not TC._linear_in(ir, "sq2", "close")
    assert not TC._linear_in(ir, "c", "close")  # an emit that never reads it
