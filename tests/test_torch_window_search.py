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
    assert int(np.prod(sizes)) == int(np.prod(shape)) and len(sizes) <= len(shape)
    assert all(n > 1 for n in sizes)
    tensors = [o for o in ops if isinstance(o, torch.Tensor)]
    full = torch.broadcast_tensors(*tensors) if tensors else []
    it = iter(full)
    for o, st in zip(ops, merged):
        want = next(it).reshape(-1).numpy() if isinstance(o, torch.Tensor) else np.full(int(np.prod(shape)), o)
        np.testing.assert_array_equal(_read_through(o, shape, sizes, st), want)


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
    """Counts the wrapper's calls by entry (they route by device, so on the
    CPU the counts say which calls the kernel backend sent to it)."""
    n = {e: 0 for e in ENTRIES}
    for e in ENTRIES:
        fn = getattr(ws_ops, e)

        def counted(*a, _e=e, _fn=fn):
            n[_e] += 1
            return _fn(*a)

        monkeypatch.setattr(ws_ops, e, counted)
    return n


# (pattern, forced strategy, entry the plan must reach through the wrapper)
MINE_CASES = [
    ("cycle3", "bs1", "count_id_in_window"),
    ("cycle3", "bs2", "count_id_in_window"),
    ("cycle4", "bs2", "count_id_in_window"),
    ("scatter_gather", "bs1", "count_id_in_window"),
    ("cycle3", "pw", "count_id_in_window"),  # the cube is intersect_count's; count_edges is not on pw
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
    if strategy == "pw" and name == "cycle3":
        return  # the pw cube runs no windowed search
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
