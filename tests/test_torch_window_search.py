"""The port's window_search wrapper on the CPU: each entry (``count_window``,
``count_window_pos``, ``count_id_in_window``, ``count_id_in_window_pos``)
against the JAX package's ``repro.core.ops`` on the same numpy inputs, in
the operand forms the mining compiler passes (lifted and broadcast views
of ranks 1-4, Python-int bounds, inverted windows, ids of -1, rows longer
than 2^n_iters, the NEG_INF / POS_INF bounds, int32 wrap); the pure
operand description (:func:`describe`) read back element by element
against ``torch.broadcast_tensors``; the dispatch rules; and mines that
reach the searches through both kernel backends (compiled bs1, bs2 and pw
plans, a difference frontier, ``count_edges``, the fused seed-local plan,
and witness extraction) against the JAX package.  The CUDA kernel itself
is checked on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core.compiler as JC
import repro.core.ops as JO
import repro_torch.core.compiler as TC
from repro.api.session import MiningSession as JaxSession
from repro.core.patterns import build_pattern as jax_build
from repro_torch.api import MiningSession
from repro_torch.convert import graph_from_reference, spec_from_reference
from repro_torch.core.spec import NEG_INF, POS_INF
from repro_torch.kernels import window_search as WS
from repro_torch.kernels import operands as lead_ops
from repro_torch.kernels.intersect_count import ops as ic_ops
from repro_torch.kernels.window_search import ops as ws_ops
from tests.conftest import random_temporal_graph

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
ENTRIES = ("count_window", "count_window_pos", "count_id_in_window", "count_id_in_window_pos")


def _csr(seed, n_nodes=12, max_len=20, n_ids=6, t_max=40):
    """A CSR of random rows, each sorted by (id, t), and the time-sorted
    copy: (ids, t, t_sorted, indptr) as int32 numpy arrays."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, n_nodes)
    lens[0] = max_len  # one row of the longest length
    ids, ts, tsorted = [], [], []
    for n in lens:
        i = rng.integers(0, n_ids, n)
        t = rng.integers(0, t_max, n)
        o = np.lexsort((t, i))
        ids.append(i[o])
        ts.append(t[o])
        tsorted.append(np.sort(t))
    indptr = np.concatenate([[0], np.cumsum(lens)])
    cat = lambda xs: np.concatenate(xs).astype(np.int32)  # noqa: E731
    return cat(ids), cat(ts), cat(tsorted), indptr.astype(np.int32)


def _ops_case(form, rng, n_nodes, n_ids, t_max):
    """(node, x, after, until): numpy arrays (or Python ints) in one of the
    compiler's forms, plus the torch views the wrapper gets."""
    def nodes(shape):
        return rng.integers(-1, n_nodes, shape).astype(np.int32)

    def ids(shape):
        return rng.integers(-1, n_ids + 1, shape).astype(np.int32)

    def times(shape):
        return rng.integers(-2, t_max + 2, shape).astype(np.int32)

    b, w, d = 5, 3, 4
    if form == "rank1":
        return nodes(b), ids(b), times(b), times(b)
    if form == "lifted":  # node (B,1,1), x (B,W,D), after an int, until (B,W,1)
        return nodes((b, 1, 1)), ids((b, w, d)), 3, times((b, w, 1))
    if form == "mid_lift":  # bs2: node (B,W,1), x (B,1,D), bounds (B,W,1) and (B,1,D)
        return nodes((b, w, 1)), ids((b, 1, d)), times((b, w, 1)), times((b, 1, d))
    if form == "rank4":
        return nodes((b, 1, 1, 1)), ids((b, w, 2, d)), times((b, w, 1, 1)), t_max // 2
    if form == "ints":  # Python-int bounds: the difference frontier's
        return nodes((b, w)), ids((b, w)), NEG_INF, POS_INF
    if form == "inverted":  # until < after: the ordered intersects' clamps
        a = times((b, w))
        return nodes((b, 1)), ids((b, w)), a, a - rng.integers(1, 10, (b, w)).astype(np.int32)
    if form == "wrap":  # after + 1 and until + 1 wrap in int32
        return nodes(b), ids(b), I32_MAX, I32_MAX
    if form == "neg_wrap":
        return nodes(b), ids(b), I32_MIN, times(b)
    if form == "scalar_node":  # a 0-d node and x against a (B,) window
        return np.array(0, np.int32), np.array(2, np.int32), times(b), times(b)
    raise AssertionError(form)


def _torch_operand(v, form):
    if not isinstance(v, np.ndarray):
        return int(v)
    t = torch.from_numpy(v)
    if form == "lifted" and t.dim() == 3 and t.shape[1] == 1:
        # a broadcast view: stride 0 along W, as lift(...).expand gives
        return t.expand(t.shape[0], 3, t.shape[2])
    return t


FORMS = ("rank1", "lifted", "mid_lift", "rank4", "ints", "inverted", "wrap", "neg_wrap", "scalar_node")


def _run_both(entry, flats, node, x, after, until, n_iters, form):
    ids, t, tsorted, indptr = flats
    targs = [_torch_operand(v, form) for v in (node, x, after, until)]
    jargs = [jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v for v in targs]
    if entry.startswith("count_window"):
        ref = getattr(JO, entry)(jnp.asarray(tsorted), jnp.asarray(indptr), jargs[0], jargs[2], jargs[3], n_iters)
        got = getattr(WS, entry)(torch.from_numpy(tsorted), torch.from_numpy(indptr), targs[0], targs[2], targs[3],
                                 n_iters)
    else:
        ref = getattr(JO, entry)(jnp.asarray(ids), jnp.asarray(t), jnp.asarray(indptr), *jargs, n_iters)
        got = getattr(WS, entry)(torch.from_numpy(ids), torch.from_numpy(t), torch.from_numpy(indptr), *targs,
                                 n_iters)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert tuple(g.shape) == tuple(np.asarray(r).shape)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_matches_jax_op(entry, form):
    flats = _csr(FORMS.index(form))
    rng = np.random.default_rng(100 + FORMS.index(form))
    node, x, after, until = _ops_case(form, rng, n_nodes=12, n_ids=6, t_max=40)
    _run_both(entry, flats, node, x, after, until, n_iters=5, form=form)  # 2^5 > every row


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_rows_longer_than_the_halvings(entry, n_iters):
    """Fewer halvings than a row needs: the partial ranks of the plain
    loop, exactly (rows of 20 entries against 2^n_iters <= 8)."""
    flats = _csr(7, n_nodes=6, max_len=20, n_ids=3)
    rng = np.random.default_rng(n_iters)
    node, x, after, until = _ops_case("lifted", rng, n_nodes=6, n_ids=3, t_max=40)
    _run_both(entry, flats, node, x, after, until, n_iters=n_iters, form="lifted")


@pytest.mark.parametrize("entry", ENTRIES)
def test_invalid_nodes_and_ids_count_zero(entry):
    flats = _csr(3)
    node = np.array([-1, 0, -5, 2, 0], np.int32)
    x = np.array([0, -1, 1, -2, 2], np.int32)
    _run_both(entry, flats, node, x, NEG_INF, POS_INF, 5, "rank1")
    got = getattr(WS, entry)(
        *([] if entry.startswith("count_window") else [torch.from_numpy(flats[0])]),
        torch.from_numpy(flats[2] if entry.startswith("count_window") else flats[1]),
        torch.from_numpy(flats[3]),
        torch.from_numpy(node),
        *([] if entry.startswith("count_window") else [torch.from_numpy(x)]),
        NEG_INF,
        POS_INF,
        5,
    )
    cnt = got[0] if isinstance(got, tuple) else got
    assert cnt[0] == 0 and cnt[2] == 0
    if not entry.startswith("count_window"):
        assert cnt[1] == 0 and cnt[3] == 0


# ---------------------------------------------------------------------------
# intersect_step: the compiled plans' bs1 / bs2 step in one call
# ---------------------------------------------------------------------------
_jexpand = jax.jit(JO.expand, static_argnums=(3,))
_jcount = jax.jit(JO.count_id_in_window, static_argnums=(7,))


def _jax_step(strategy, csr_a, csr_b, frontier, fixed, w1, w2, skip, ordered, d, n_sweep, n_iters):
    """The JAX package's eager bs1 / bs2 sequence (``repro.core.compiler``'s
    bs1 and bs2 branches) over the sweep offsets i * d, summed in int32; the
    operands lead-shaped, placed against the expansion axis as the
    compiler's lifts place them."""
    along = lambda v: jnp.asarray(v)[..., None] if isinstance(v, np.ndarray) else v  # noqa: E731
    (ia, na, ta), (ib, nb, tb) = [tuple(map(jnp.asarray, c)) for c in (csr_a, csr_b)]
    a1, u1 = map(along, w1)
    a2, u2 = map(along, w2)
    refs = [along(r) for r in skip]
    total = 0
    for i in range(n_sweep):
        if strategy == "bs1":
            m, x_ids, x_t = _jexpand(ia, (na, ta), jnp.asarray(frontier), d, offset=i * d)
            m = m & (x_t > a1) & (x_t <= u1)
            for r in refs:
                m = m & (x_ids != r)
            lo = jnp.maximum(a2, x_t) if ordered else a2
            cnt = _jcount(nb, tb, ib, along(fixed), jnp.where(m, x_ids, -1), lo, u2, n_iters)
        else:
            m, y_ids, y_t = _jexpand(ib, (nb, tb), jnp.asarray(fixed), d, offset=i * d)
            m = m & (y_t > a2) & (y_t <= u2)
            for r in refs:
                m = m & (y_ids != r)
            hi = jnp.minimum(u1, y_t - 1) if ordered else u1
            cnt = _jcount(na, ta, ia, along(frontier), jnp.where(m, y_ids, -1), a1, hi, n_iters)
        total = total + jnp.sum(jnp.where(m, cnt, 0), axis=-1)
    return np.asarray(total).astype(np.int32)


def _graph_csrs(seed, wrap_times=False):
    """The out and in CSRs of a ``tests/conftest.py`` random graph as
    (indptr, ids, t) int32 arrays; ``wrap_times`` moves some edge times to
    INT32_MIN and INT32_MAX (rows stay sorted by (id, t))."""
    g = random_temporal_graph(np.random.default_rng(seed), n_nodes=14, n_edges=150, t_max=64)
    out = []
    for indptr, nbr, t in ((g.out_indptr, g.out_nbr, g.out_t), (g.in_indptr, g.in_nbr, g.in_t)):
        t = t.astype(np.int64)
        if wrap_times:
            t = np.where(t < 6, I32_MIN, np.where(t > 58, I32_MAX, t))
        out.append((indptr.astype(np.int32), nbr.astype(np.int32), t.astype(np.int32)))
    return out


def _step_operands(rng, n_skip, form):
    """(frontier, fixed, window1, window2, skip) in the compiler's lead
    forms at (B, W) = (6, 3): frontier (B, W), fixed (B, 1), bounds (B, 1),
    (B, W) or ints; -1 nodes among them."""
    b, w = 6, 3
    nodes = lambda shape: rng.integers(-1, 14, shape).astype(np.int32)  # noqa: E731
    times = lambda shape: rng.integers(-4, 70, shape).astype(np.int32)  # noqa: E731
    frontier, fixed = nodes((b, w)), nodes((b, 1))
    frontier[0, 0], fixed[1, 0] = -1, -1
    if form == "wrap":  # after + 1 wraps; the windows reach both ends of int32
        w1, w2 = (I32_MIN, I32_MAX), (times((b, 1)), I32_MAX)
    else:
        st = times((b, 1))
        w1 = (st, st + 40) if form != "ints" else (NEG_INF, POS_INF)
        w2 = (times((b, w)), st + 50)
    skip = [nodes((b, 1)) if i % 2 == 0 else nodes((b, w)) for i in range(n_skip)]
    return frontier, fixed, w1, w2, skip


def _run_step(strategy, csrs, ops_, ordered, d, n_sweep, n_iters):
    frontier, fixed, w1, w2, skip = ops_
    tt = lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) else v  # noqa: E731
    tcsr = [tuple(map(torch.from_numpy, c)) for c in csrs]
    targs = (strategy, *tcsr, tt(frontier), tt(fixed), tuple(map(tt, w1)), tuple(map(tt, w2)), tuple(map(tt, skip)))
    kw = dict(ordered=ordered, d=d, n_sweep=n_sweep, n_iters=n_iters)
    want = _jax_step(strategy, *csrs, frontier, fixed, w1, w2, skip, ordered, d, n_sweep, n_iters)
    before = ws_ops.launches
    got = WS.intersect_step(*targs, **kw)
    assert ws_ops.launches == before  # on the CPU: the plain version
    plain = WS.intersect_step_ref(*targs, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, plain)
    # the offsets one call at a time add up to the swept call
    split = sum(WS.intersect_step_ref(*targs, **{**kw, "n_sweep": 1, "offset": i * d}) for i in range(n_sweep))
    assert torch.equal(split.to(torch.int32), got)
    return got


@pytest.mark.parametrize("n_skip", [0, 1, 2, 3])
@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("strategy", ["bs1", "bs2"])
def test_intersect_step_equals_eager_sequence(strategy, ordered, n_skip):
    """bs1 and bs2, ordered and unordered, 0-3 skip nodes, at intersect-dim
    sweeps of 1, 2 and 8 (d = 2: rows up to 16 entries swept), with -1
    frontier and fixed nodes: the JAX package's eager sequence."""
    csrs = _graph_csrs(n_skip)
    rng = np.random.default_rng(10 * n_skip + ordered)
    nonzero = 0
    for n_sweep in (1, 2, 8):
        got = _run_step(strategy, csrs, _step_operands(rng, n_skip, "bounds"), ordered, 2, n_sweep, n_iters=6)
        nonzero += int((got != 0).sum())
    assert nonzero > 0


@pytest.mark.parametrize("form", ["partial", "wrap", "ints"])
@pytest.mark.parametrize("strategy", ["bs1", "bs2"])
def test_intersect_step_edge_forms(strategy, form):
    """Rows longer than 2^n_iters (partial ranks, 2 halvings against rows
    of up to 25 entries), bounds and edge times at INT32_MIN / INT32_MAX
    (y_t - 1 and after + 1 wrap), and Python-int windows."""
    csrs = _graph_csrs(20 + len(form), wrap_times=form == "wrap")
    rng = np.random.default_rng(len(form))
    for ordered in (True, False):
        _run_step(strategy, csrs, _step_operands(rng, 2, form), ordered, 4, 2, n_iters=2 if form == "partial" else 6)


def test_intersect_step_rejects_what_it_cannot_take():
    (ia, na, ta), csr_b = [tuple(map(torch.from_numpy, c)) for c in _graph_csrs(0)]
    fr = torch.zeros((2, 3), dtype=torch.int32)
    fx = torch.zeros((2, 1), dtype=torch.int32)
    kw = dict(ordered=True, d=2, n_iters=4)
    ok = ("bs1", (ia, na, ta), csr_b, fr, fx, (0, 9), (0, 9))
    assert WS.intersect_step(*ok, **kw).shape == (2, 3)
    with pytest.raises(ValueError):
        WS.intersect_step("pw", *ok[1:], **kw)
    with pytest.raises(TypeError):
        WS.intersect_step(*ok[:3], fr.long(), fx, (0, 9), (0, 9), **kw)  # int64 operand
    with pytest.raises(TypeError):
        WS.intersect_step("bs1", (ia.long(), na, ta), *ok[2:], **kw)  # int64 CSR
    with pytest.raises(TypeError):
        WS.intersect_step(*ok, **{**kw, "d": 0})
    with pytest.raises(ValueError):
        WS.intersect_step(*ok, (fx,) * (ws_ops.MAX_SKIP + 1), **kw)  # more skip nodes than the kernel takes
    with pytest.raises(ValueError):
        WS.intersect_step(*ok[:3], fr.to("meta"), fx, (0, 9), (0, 9), **kw)  # devices differ


def test_step_group_sizes():
    assert [ws_ops.step_group(w) for w in (1, 32, 33, 64, 65, 128, 129, 1 << 20)] == [32, 32, 64, 64, 128, 128,
                                                                                       256, 256]


# ---------------------------------------------------------------------------
# the operand description
# ---------------------------------------------------------------------------
def _read_through(x, shape, sizes, strides):
    """Every element of the output, in C order, read from x's storage at the
    offsets describe() gives (coordinates over the merged sizes)."""
    numel = int(np.prod(shape)) if len(shape) else 1
    offs = np.zeros(numel, np.int64)
    rem = np.arange(numel, dtype=np.int64)
    for n, s in zip(reversed(sizes), reversed(strides)):
        offs += (rem % n) * s
        rem //= n
    if not isinstance(x, torch.Tensor):
        return np.full(numel, x, np.int64)
    span = int(offs.max()) + 1 if numel else 1
    flat = x.as_strided((span,), (1,))  # from x's own storage offset
    return flat.numpy()[offs].astype(np.int64)


MARSHAL_CASES = [
    # operand shapes (a Python int as None) and how each is viewed
    ((7,), (7,), None, (7,)),
    ((4, 1, 1), (4, 3, 5), None, (4, 3, 1)),
    ((4, 3, 1), (4, 1, 5), (4, 3, 1), (4, 1, 5)),
    ((2, 1, 1, 1), (2, 3, 4, 5), (2, 3, 1, 1), None),
    ((1,), (6, 2), (6, 1), (1, 2)),
    ((), (), None, None),
    ((3, 1, 1, 1, 1), (3, 2, 1, 2, 4), (1, 1, 1, 1, 4), (3, 2, 1, 1, 1)),
]


@pytest.mark.parametrize("case", range(len(MARSHAL_CASES)))
@pytest.mark.parametrize("views", ["contiguous", "expanded", "sliced"])
def test_describe_reads_every_element(case, views):
    rng = np.random.default_rng(case)
    ops = []
    for shp in MARSHAL_CASES[case]:
        if shp is None:
            ops.append(int(rng.integers(-100, 100)))
            continue
        base = torch.from_numpy(rng.integers(-1000, 1000, (2,) + shp).astype(np.int32))
        x = base[1]  # one storage offset into its storage
        if views == "sliced" and x.dim() and x.shape[-1] > 1:
            wide = torch.from_numpy(rng.integers(-1000, 1000, shp[:-1] + (2 * shp[-1],)).astype(np.int32))
            x = wide[..., ::2]  # a strided view
        ops.append(x)
    shape = torch.broadcast_shapes(*(tuple(o.shape) if isinstance(o, torch.Tensor) else () for o in ops))
    if views == "expanded":  # the compiler's lifted operands, expanded to the full shape
        ops = [o.expand(shape) if isinstance(o, torch.Tensor) else o for o in ops]
    strides = [o.expand(shape).stride() if isinstance(o, torch.Tensor) else (0,) * len(shape) for o in ops]
    sizes, merged = ws_ops.describe(shape, strides)
    # the wrappers' own shape and stride helpers (no torch.broadcast_shapes
    # on the launch path) describe the launch the same way
    assert lead_ops.broadcast([tuple(o.shape) if isinstance(o, torch.Tensor) else () for o in ops]) == tuple(shape)
    assert ws_ops.describe(shape, [lead_ops.strides_over(o, shape) for o in ops]) == (sizes, merged)
    assert int(np.prod(sizes)) == int(np.prod(shape)) and len(sizes) <= len(shape)
    assert all(n > 1 for n in sizes)
    tensors = [o for o in ops if isinstance(o, torch.Tensor)]
    full = torch.broadcast_tensors(*tensors) if tensors else []
    it = iter(full)
    for o, st in zip(ops, merged):
        want = next(it).reshape(-1).numpy() if isinstance(o, torch.Tensor) else np.full(int(np.prod(shape)), o)
        np.testing.assert_array_equal(_read_through(o, shape, sizes, st), want)


def test_broadcast_refuses_what_torch_refuses():
    assert lead_ops.broadcast([(4, 1, 5), (3, 1), ()]) == (4, 3, 5)
    assert lead_ops.broadcast([(0, 3), (1, 3)]) == (0, 3)
    for shapes in ([(4, 3), (2, 3)], [(0,), (3,)]):
        with pytest.raises(ValueError, match="broadcast"):
            lead_ops.broadcast(shapes)
        with pytest.raises(RuntimeError):
            torch.broadcast_shapes(*shapes)


def test_describe_merges_contiguous_axes():
    # a (4, 3, 5) contiguous operand beside a scalar: one axis of 60
    assert ws_ops.describe((4, 3, 5), [(15, 5, 1), (0, 0, 0)]) == ((60,), ((1,), (0,)))
    # a node lifted along the last two axes keeps them apart from the first
    assert ws_ops.describe((4, 3, 5), [(1, 0, 0), (15, 5, 1)]) == ((4, 15), ((1, 0), (15, 1)))
    # size-1 axes vanish
    assert ws_ops.describe((1, 6, 1), [(6, 1, 1)]) == ((6,), ((1,),))
    assert ws_ops.describe((), [()]) == ((), ((),))


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------
def _flats_t():
    ids, t, tsorted, indptr = _csr(0)
    return torch.from_numpy(ids), torch.from_numpy(t), torch.from_numpy(tsorted), torch.from_numpy(indptr)


def test_cpu_tensors_take_the_plain_version():
    ids, t, tsorted, indptr = _flats_t()
    node = torch.tensor([0, 1, -1, 3], dtype=torch.int32)
    x = torch.tensor([1, 2, 3, -1], dtype=torch.int32)
    before = ws_ops.launches
    got = WS.count_id_in_window(ids, t, indptr, node, x, 3, 30, 5)
    assert torch.equal(got, WS.count_id_in_window_ref(ids, t, indptr, node, x, 3, 30, 5))
    cnt, pos = WS.count_window_pos(tsorted, indptr, node, 3, 30, 5)
    rc, rp = WS.count_window_pos_ref(tsorted, indptr, node, 3, 30, 5)
    assert torch.equal(cnt, rc) and torch.equal(pos, rp)
    assert ws_ops.launches == before  # the plain version is not a launch


def test_what_neither_version_takes_raises():
    ids, t, tsorted, indptr = _flats_t()
    node = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(TypeError):
        WS.count_window(tsorted, indptr, node.long(), 0, 9, 5)  # int64 operand
    with pytest.raises(TypeError):
        WS.count_window(tsorted.long(), indptr, node, 0, 9, 5)  # int64 flat array
    with pytest.raises(TypeError):
        WS.count_window(tsorted, indptr, node, 2**31, 9, 5)  # a bound past int32
    with pytest.raises(TypeError):
        WS.count_window(tsorted, indptr, node, 0, 9, 5.0)  # n_iters
    with pytest.raises(TypeError):
        WS.count_id_in_window(ids, t, indptr[::2], node, node, 0, 9, 5)  # not contiguous
    with pytest.raises(ValueError):
        WS.count_window(tsorted.to("meta"), indptr.to("meta"), node.to("meta"), 0, 9, 5)  # no such route
    with pytest.raises(ValueError):
        WS.count_window(tsorted, indptr, node.to("meta"), 0, 9, 5)  # devices differ


# ---------------------------------------------------------------------------
# mines through both kernel backends
# ---------------------------------------------------------------------------
W = 96
PORT_TO_JAX = {"kernel": "pallas", "torch": "xla"}


@pytest.fixture(scope="module")
def dense():
    g = random_temporal_graph(np.random.default_rng(11), n_nodes=18, n_edges=140, t_max=256)
    return g, graph_from_reference(g)


@pytest.fixture
def calls(monkeypatch):
    """Counts the wrappers' calls by entry: window_search's, and
    intersect_count's ``pair_step`` (they route by device, so on the CPU
    the counts say which calls the kernel backend sent to them)."""
    n = {e: 0 for e in ENTRIES + ("intersect_step", "pair_step")}
    for e in n:
        mod = ic_ops if e == "pair_step" else ws_ops
        fn = getattr(mod, e)

        def counted(*a, _e=e, _fn=fn, **kw):
            n[_e] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, e, counted)
    return n


# (pattern, forced strategy, entry the plan must reach through the wrapper)
MINE_CASES = [
    ("cycle3", "bs1", "count_id_in_window"),
    ("cycle3", "bs2", "count_id_in_window"),
    ("cycle4", "bs2", "intersect_step"),  # the whole intersect step, one call
    ("scatter_gather", "bs1", "intersect_step"),
    ("cycle3", "pw", "pair_step"),  # the pairwise count_edges: intersect_count's pw step entry
    ("cycle4", "pw", "pair_step"),  # the whole pw intersect step, one call
    ("scatter_gather", "pw", "pair_step"),
    ("new_counterparty", None, "count_id_in_window"),  # the difference frontier
    ("cycle2", None, "count_id_in_window"),  # count_edges
    ("fan_in", None, "count_window"),
]


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("name,strategy,entry", MINE_CASES)
def test_compiled_mine_matches_jax_on_both_backends(dense, calls, name, strategy, entry, backend):
    g, tg = dense
    spec = jax_build(name, W)
    kw = {"force_strategy": strategy} if strategy else {}
    jcp = JC.CompiledPattern(spec, g, backend=PORT_TO_JAX[backend], **kw)
    tcp = TC.CompiledPattern(spec_from_reference(spec), tg, backend=backend, device="cpu", **kw)
    seeds = np.arange(g.n_edges, dtype=np.int32)
    want = jcp.mine(seeds)
    got = tcp.mine(seeds)
    np.testing.assert_array_equal(got, want)
    assert tcp.stats == jcp.stats
    reached = calls[entry]
    assert (reached > 0) if backend == "kernel" else (reached == 0), (backend, calls)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_fused_plan_matches_jax_on_both_backends(dense, calls, backend):
    g, tg = dense
    names = ["fan_in", "fan_out", "deg_in", "cycle2", "stack"]  # every one seed-local
    sess = MiningSession(tg, window=W, device="cpu", kernel_backend=backend).register(*names)
    ref = JaxSession(g, window=W, kernel_backend=PORT_TO_JAX[backend]).register(*names)
    seeds = np.arange(g.n_edges, dtype=np.int32)
    got, want = sess.mine(names, seeds), ref.mine(names, seeds)
    assert set(got.fused) == set(names)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.stats == want.stats
    assert sess._fused.backend == backend
    n = calls["count_window"] + calls["count_id_in_window"]
    assert (calls["count_window"] > 0 and calls["count_id_in_window"] > 0) if backend == "kernel" else n == 0


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_witness_mine_reaches_the_pos_entries(dense, calls, backend):
    """The witness extraction has no backend knob: it always goes through
    the wrapper (on the CPU its plain version), on either kernel backend."""
    g, tg = dense
    names = ["fan_in", "cycle2", "cycle3", "new_counterparty"]
    sess = MiningSession(tg, window=W, device="cpu", kernel_backend=backend)
    ref = JaxSession(g, window=W, kernel_backend=PORT_TO_JAX[backend])
    for n in names:
        sess.register(n)
        ref.register(n)
    seeds = np.arange(0, g.n_edges, 2, dtype=np.int32)
    got, want = sess.mine(names, seeds, witnesses=2), ref.mine(names, seeds, witnesses=2)
    np.testing.assert_array_equal(got.counts, want.counts)
    for n in names:
        np.testing.assert_array_equal(got.witnesses[n].eids, want.witnesses[n].eids, err_msg=n)
    assert calls["count_window_pos"] > 0 and calls["count_id_in_window_pos"] > 0
    assert calls["count_id_in_window"] > 0  # new_counterparty's difference frontier
