"""The port's intersect_count: its plain PyTorch version against the JAX
package's op (the Pallas kernel in interpret mode) on the reference
test cases and small bucket-ladder shapes; its second entry, the whole
pairwise (``pw``) step ``pair_step``, against the JAX package's eager pw
sequence (``repro.core.ops.expand``, the masks and the Pallas cube through
``repro.core.compiler._pallas_pair_count``); and the wrapper's dispatch
rules.  The CUDA kernel itself is checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core.compiler as JC
import repro.core.ops as JO
from repro.kernels import intersect_count as jax_intersect_count
from repro_torch.kernels import build
from repro_torch.kernels import intersect_count as IC
from repro_torch.kernels.intersect_count import intersect_count, intersect_count_ref
from repro_torch.kernels.intersect_count import ops as ic_ops
from tests.conftest import random_temporal_graph

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _case(b, da, db, seed):
    rng = np.random.default_rng(seed)
    a_ids = rng.integers(-1, 8, (b, da)).astype(np.int32)
    b_ids = rng.integers(-1, 8, (b, db)).astype(np.int32)
    a_t = rng.integers(0, 64, (b, da)).astype(np.int32)
    b_t = rng.integers(0, 64, (b, db)).astype(np.int32)
    a_lo = rng.integers(-4, 32, b).astype(np.int32)
    a_hi = (a_lo + rng.integers(-8, 64, b)).astype(np.int32)
    b_lo = rng.integers(-4, 32, b).astype(np.int32)
    b_hi = (b_lo + rng.integers(-8, 64, b)).astype(np.int32)
    return (a_ids, a_t, b_ids, b_t, a_lo, a_hi, b_lo, b_hi)


def _hard_case():
    """tests/test_kernels.py's ragged/duplicate/inverted/ordered-tie rows."""
    return tuple(
        np.array(x, np.int32)
        for x in (
            [[3, 3, 3, -1], [-1, -1, -1, -1], [0, 1, 2, 3], [5, 5, -1, -1], [7, 7, 7, 7]],
            [[10, 20, 30, 99], [0, 0, 0, 0], [5, 6, 7, 8], [50, 60, 0, 0], [10, 10, 10, 10]],
            [[3, 3, -1], [1, 2, 3], [-1, -1, -1], [5, 5, 5], [7, 7, 7]],
            [[15, 25, 0], [1, 2, 3], [0, 0, 0], [55, 65, 75], [10, 11, 9]],
            [0, 0, 4, 40, 0],
            [25, 10, 9, 70, 99],
            [0, 0, 0, 60, 0],
            [30, 10, 9, 50, 99],
        )
    )


def _both(args, ordered):
    ref = np.asarray(jax_intersect_count(*map(jnp.asarray, args), ordered=ordered))
    got = intersect_count(*(torch.from_numpy(a) for a in args), ordered=ordered)
    assert got.dtype == torch.int32
    return got.numpy(), ref


@pytest.mark.parametrize(
    "b,da,db",
    [(1, 1, 1), (5, 8, 3), (16, 32, 32), (33, 7, 65), (9, 1, 4), (4, 1, 16), (3, 4, 16), (2, 16, 64)],
)
@pytest.mark.parametrize("ordered", [False, True])
def test_plain_matches_jax_op(b, da, db, ordered):
    got, ref = _both(_case(b, da, db, b * 100 + da + db), ordered)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ordered", [False, True])
def test_hard_cases_match_jax_op(ordered):
    got, ref = _both(_hard_case(), ordered)
    np.testing.assert_array_equal(got, ref)
    if not ordered:
        assert got[0] == 4 and got[3] == 0  # 2x2 in-window pairs; inverted window
    else:
        assert got[4] == 4  # only b_t=11 > every a_t=10: ties never count


def test_cpu_tensors_take_the_plain_version():
    args = tuple(torch.from_numpy(a) for a in _case(7, 4, 16, 3))
    before = ic_ops.launches
    got = intersect_count(*args, ordered=True)
    assert torch.equal(got, intersect_count_ref(*args, ordered=True))
    assert ic_ops.launches == before  # the plain version is not a launch
    empty = tuple(a[:0] for a in args)
    assert intersect_count(*empty).shape == (0,)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    args = [torch.from_numpy(a) for a in _case(4, 2, 3, 1)]
    with pytest.raises(TypeError, match="int32"):
        intersect_count(*([args[0].long()] + args[1:]))
    with pytest.raises(ValueError, match="bounds"):
        intersect_count(*(args[:4] + [args[4][:2]] + args[5:]))
    with pytest.raises(ValueError, match="shapes"):
        intersect_count(*([args[0], args[1][:, :1]] + args[2:]))
    with pytest.raises(ValueError, match="a_ids/b_ids"):
        intersect_count(*([args[0][0]] + args[1:]))


def test_missing_nvcc_raises_clearly(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()



# ---- ops.plan: the path a CUDA launch takes, a pure function of the shape

LADDER = (1, 4, 32, 64, 256, 1024)  # the mining and streaming bucket widths


@pytest.mark.parametrize("b", [1, 33, 1 << 10, 1 << 17, 1 << 22])
@pytest.mark.parametrize("da", LADDER)
@pytest.mark.parametrize("db", LADDER)
def test_plan_at_the_ladder_corners(b, da, db):
    # at the ladder's widths a row's operands always fit a rows-path
    # stage, so the pair count alone decides, whatever B is
    assert ic_ops.plan(b, da, db) == ("block" if da * db >= 4096 else "rows")


@pytest.mark.parametrize(
    "da,db,path",
    [(63, 65, "rows"), (64, 64, "block"), (65, 63, "rows"), (1, 4093, "rows"), (1, 4094, "block"),
     (4093, 1, "rows"), (1, 6143, "block"), (3072, 3072, "block")],
)
def test_plan_at_its_crossover(da, db, path):
    # 4,096 pairs, or a row of more than 32 KB of operands (8 * (Da + Db) + 16)
    assert ic_ops.plan(1 << 20, da, db) == path


# ---- the broadcast forms the compiler passes, on the CPU


def _forms(bf, rep, da, db, seed, a_time=True, windows="mixed"):
    """Operands with B = bf * rep rows and a fixed side of bf rows; the
    windows as ints, (B,) or (B_fixed,) arrays by ``windows``."""
    rng = np.random.default_rng(seed)
    b = bf * rep
    ri = lambda lo, hi, shape: rng.integers(lo, hi, shape).astype(np.int32)
    b_lo = ri(-4, 32, bf)
    a_lo = ri(-4, 32, b)
    forms = {
        "mixed": (a_lo, a_lo + ri(-8, 64, b), b_lo, b_lo + ri(-8, 64, bf)),
        "scalar": (5, 40, -3, 50),
        "fixed": (ri(-4, 8, bf), ri(30, 64, bf), b_lo, b_lo + ri(-8, 64, bf)),
    }
    bounds = forms[windows] if a_time else (-(2**31), 2**31 - 1) + forms[windows][2:]
    return (ri(-1, 8, (b, da)), ri(0, 64, (b, da)) if a_time else None, ri(-1, 8, (bf, db)), ri(0, 64, (bf, db)),
            *bounds)


def _materialised(args, b, bf):
    rep = b // bf
    rows = lambda w: np.full(b, w, np.int32) if isinstance(w, int) else (w if len(w) == b else np.repeat(w, rep))
    a_ids, a_t, b_ids, b_t = args[:4]
    return (a_ids, np.zeros_like(a_ids) if a_t is None else a_t, np.repeat(b_ids, rep, 0), np.repeat(b_t, rep, 0),
            *map(rows, args[4:]))


def _torch_args(args):
    return tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)


@pytest.mark.parametrize("rep", [1, 3, 64])
@pytest.mark.parametrize("da,db", [(1, 4), (1, 32), (4, 4), (7, 65)])
@pytest.mark.parametrize("windows", ["mixed", "scalar", "fixed"])
@pytest.mark.parametrize("ordered", [False, True])
def test_broadcast_forms_equal_the_materialised_plain_and_jax(rep, da, db, windows, ordered):
    bf = 5
    args = _forms(bf, rep, da, db, rep * 1000 + da + db, windows=windows)
    full = _materialised(args, bf * rep, bf)
    got = intersect_count(*_torch_args(args), ordered=ordered)
    assert got.dtype == torch.int32 and got.shape == (bf * rep,)
    want = intersect_count_ref(*map(torch.from_numpy, full), ordered=ordered)
    jax_ref = np.asarray(jax_intersect_count(*map(jnp.asarray, full), ordered=ordered))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), jax_ref)


@pytest.mark.parametrize("rep", [1, 3, 64])
@pytest.mark.parametrize("windows", ["mixed", "scalar", "fixed"])
def test_missing_a_time_passes_every_a_slot(rep, windows):
    # count_edges' form: the frontier ids alone, the a window unbounded
    bf = 4
    args = _forms(bf, rep, 1, 16, rep + 7, a_time=False, windows=windows)
    got = intersect_count(*_torch_args(args), ordered=False)
    full = _materialised(args, bf * rep, bf)
    np.testing.assert_array_equal(got.numpy(), intersect_count_ref(*map(torch.from_numpy, full)).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_intersect_count(*map(jnp.asarray, full))))


def test_broadcast_forms_that_do_not_fit_raise():
    args = list(_torch_args(_forms(3, 4, 2, 5, 1)))
    with pytest.raises(ValueError, match="multiple"):
        intersect_count(args[0][:11], args[1][:11], *args[2:4], 0, 9, 0, 9)  # 11 rows over 3 fixed
    with pytest.raises(ValueError, match="bounds"):
        intersect_count(*args[:4], args[4][:6], *args[5:])  # neither B nor B_fixed long
    no_t = list(_torch_args(_forms(3, 4, 2, 5, 1, a_time=False)))
    with pytest.raises(ValueError, match="a_t may be None"):
        intersect_count(*no_t, ordered=True)
    with pytest.raises(ValueError, match="a_t may be None"):
        intersect_count(no_t[0], None, *no_t[2:4], 0, 2**31 - 1, *no_t[6:])
    with pytest.raises(TypeError, match="window bounds"):
        intersect_count(*args[:4], 2**31, *args[5:])


# ---- pair_step: the compiled plans' pw step in one call, on the CPU

_jexpand = jax.jit(JO.expand, static_argnums=(3,))
_jpair = jax.jit(JC._pallas_pair_count, static_argnums=(0, 1, 2, 11))


def _graph_csrs(seed):
    """The out and in CSRs of a ``tests/conftest.py`` random graph (rows of
    about 13 entries over 12 nodes) as (indptr, ids, t) int32 arrays."""
    g = random_temporal_graph(np.random.default_rng(seed), n_nodes=12, n_edges=160, t_max=64)
    return [tuple(x.astype(np.int32) for x in c)
            for c in ((g.out_indptr, g.out_nbr, g.out_t), (g.in_indptr, g.in_nbr, g.in_t))]


def _jax_pw(form, csr_a, csr_b, frontier, fixed, w1, w2, skip, ordered, d_a, d_b, sweeps, offsets=(0, 0)):
    """The JAX package's pw step under ``backend="pallas"``
    (``repro.core.compiler``: both ``ops.expand`` calls, the window-1 and
    skip masks folded into -1 sentinels, window 2 and the order inside the
    Pallas cube) over the sweep offsets, summed in int32.  The ``"edges"``
    form is its pairwise ``count_edges``: the frontier id as a tile of one,
    with zero times and an unbounded window."""
    along = lambda v: jnp.asarray(v)[..., None] if isinstance(v, np.ndarray) else v  # noqa: E731
    lead = np.broadcast_shapes(*(np.shape(v) for v in (frontier, fixed, *w2, *(w1 or ()), *skip)))
    (ib, nb, tb) = map(jnp.asarray, csr_b)
    total = jnp.zeros(lead, jnp.int32)
    for i in range(sweeps[0]):
        if form == "intersect":
            ia, na, ta = map(jnp.asarray, csr_a)
            m, x_ids, x_t = _jexpand(ia, (na, ta), jnp.asarray(frontier), d_a, offset=offsets[0] + i * d_a)
            m = m & (x_t > along(w1[0])) & (x_t <= along(w1[1]))
            for r in skip:
                m = m & (x_ids != along(r))
            x, xt, da = jnp.where(m, x_ids, -1), x_t, d_a
        else:
            x, xt, da = along(frontier), jnp.zeros_like(along(frontier)), 1
        for j in range(sweeps[1]):
            m3, y_ids, y_t = _jexpand(ib, (nb, tb), jnp.asarray(fixed), d_b, offset=offsets[1] + j * d_b)
            total = total + _jpair(lead, da, d_b, x, xt, jnp.where(m3, y_ids, -1), y_t, I32_MIN, I32_MAX,
                                   along(w2[0]), along(w2[1]), ordered)
    return np.asarray(total).astype(np.int32)


def _pw_operands(rng, bounds, n_skip, form="intersect"):
    """(frontier, fixed, window1, window2, skip) at the lead shape (B, W) =
    (6, 3): a -1 frontier slot, a -1 fixed node, a pad row (every frontier
    slot -1); the bounds ints (``scalar``), one per seed (``seed``: (B, 1))
    or one per lead element (``lead``: (B, W))."""
    b, w = 6, 3
    nodes = lambda shape: rng.integers(-1, 12, shape).astype(np.int32)  # noqa: E731
    times = lambda shape: rng.integers(-4, 40, shape).astype(np.int32)  # noqa: E731
    frontier, fixed = nodes((b, w)), nodes((b, 1))
    frontier[0, 0], fixed[1, 0], frontier[2] = -1, -1, -1
    st = times((b, 1))
    if bounds == "scalar":
        w1, w2 = (3, 50), (-1, 60)
    elif bounds == "seed":
        w1, w2 = (st, st + 40), (st - 5, st + 50)
    else:
        w1, w2 = (times((b, w)), st + 40), (times((b, w)), st + 50)
    skip = [nodes((b, 1)) if i % 2 == 0 else nodes((b, w)) for i in range(n_skip)]
    if form == "edges":
        return frontier, fixed, None, w2, []
    return frontier, fixed, w1, w2, skip


def _torch(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v)
    return tuple(map(_torch, v)) if isinstance(v, (tuple, list)) else v


def _run_pw(form, csrs, ops_, ordered, d_a, d_b, sweeps, offsets=(0, 0)):
    frontier, fixed, w1, w2, skip = ops_
    targs = (form, None if form == "edges" else _torch(csrs[0]), _torch(csrs[1]), _torch(frontier), _torch(fixed),
             _torch(w1), _torch(w2), _torch(skip))
    kw = dict(ordered=ordered, d_b=d_b, offset_b=offsets[1], n_sweep_b=sweeps[1])
    if form == "intersect":
        kw.update(d_a=d_a, offset_a=offsets[0], n_sweep_a=sweeps[0])
    want = _jax_pw(form, *csrs, frontier, fixed, w1, w2, skip, ordered, d_a, d_b, sweeps, offsets)
    before, step_before = ic_ops.launches, ic_ops.step_launches
    got = IC.pair_step(*targs, **kw)
    assert (ic_ops.launches, ic_ops.step_launches) == (before, step_before)  # on the CPU: the plain version
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, IC.pair_step_ref(*targs, **kw))
    # the sweep offsets one call at a time add up to the swept call
    split = sum(IC.pair_step_ref(*targs, **{**kw, "n_sweep_b": 1, "offset_b": offsets[1] + j * d_b,
                                            **({"n_sweep_a": 1, "offset_a": offsets[0] + i * d_a}
                                               if form == "intersect" else {})})
                for i in range(sweeps[0]) for j in range(sweeps[1]))
    assert torch.equal(split.to(torch.int32), got)
    return got


@pytest.mark.parametrize("sweeps", [(1, 1), (2, 1), (1, 3), (2, 2)])
@pytest.mark.parametrize("bounds,n_skip", [("scalar", 0), ("seed", 1), ("lead", 3)])
@pytest.mark.parametrize("ordered", [False, True])
def test_pair_step_equals_the_reference_pw_sequence(ordered, bounds, n_skip, sweeps):
    """The intersect form, ordered and not, bounds as ints, per seed and
    per lead element, 0-3 skip nodes, sweep steps on a, b and both (d = 8
    and 6 against rows of about 13 entries: rows shorter than d and rows the
    sweep covers), -1 frontier and fixed nodes and a pad row: bit for bit
    the JAX package's Pallas pw step."""
    csrs = _graph_csrs(len(bounds) + n_skip)
    rng = np.random.default_rng(10 * n_skip + ordered)
    got = _run_pw("intersect", csrs, _pw_operands(rng, bounds, n_skip), ordered, 8, 6, sweeps)
    assert int((got != 0).sum()) > 0
    assert (got[2] == 0).all()  # the pad row


@pytest.mark.parametrize("n_sweep_b", [1, 3])
@pytest.mark.parametrize("bounds", ["scalar", "seed", "lead"])
def test_pair_step_edges_form_equals_the_reference_count_edges(bounds, n_sweep_b):
    """The pairwise count_edges: the frontier id against the fixed node's
    expanded in-row, window 2 as ints, per seed or per lead element."""
    csrs = _graph_csrs(7)[::-1]  # the fixed side's in-row: its in-neighbours
    rng = np.random.default_rng(len(bounds) + n_sweep_b)
    got = _run_pw("edges", csrs, _pw_operands(rng, bounds, 0, "edges"), False, 1, 4, (1, n_sweep_b))
    assert int((got != 0).sum()) > 0


@pytest.mark.parametrize("ordered", [False, True])
def test_pair_step_start_plus_offset_wraps_as_the_reference(ordered):
    """An offset near INT32_MAX: start + offset wraps negative, the row-end
    mask keeps those entries and the gather clamps them to entry 0, as
    ``expand`` does in both packages."""
    csrs = _graph_csrs(3)
    rng = np.random.default_rng(5)
    _run_pw("intersect", csrs, _pw_operands(rng, "seed", 1), ordered, 4, 3, (1, 2), offsets=(I32_MAX - 8, 0))
    _run_pw("intersect", csrs, _pw_operands(rng, "lead", 0), ordered, 2, 4, (2, 1), offsets=(0, I32_MAX - 12))


def test_pair_step_rejects_what_it_cannot_take():
    csr_a, csr_b = [_torch(c) for c in _graph_csrs(0)]
    fr = torch.zeros((2, 3), dtype=torch.int32)
    fx = torch.zeros((2, 1), dtype=torch.int32)
    ok = ("intersect", csr_a, csr_b, fr, fx, (0, 9), (0, 9))
    kw = dict(ordered=True, d_a=2, d_b=2)
    assert IC.pair_step(*ok, **kw).shape == (2, 3)
    assert IC.pair_step("edges", None, csr_b, fr, fx, None, (0, 9), ordered=False, d_b=2).shape == (2, 3)
    with pytest.raises(ValueError, match="form"):
        IC.pair_step("pw", *ok[1:], **kw)
    with pytest.raises(ValueError, match="edges form"):
        IC.pair_step("edges", *ok[1:], **kw)  # a CSR, a window 1 and ordered
    with pytest.raises(TypeError):
        IC.pair_step(*ok[:3], fr.long(), fx, (0, 9), (0, 9), **kw)  # int64 operand
    with pytest.raises(TypeError):
        IC.pair_step("intersect", (csr_a[0].long(), *csr_a[1:]), *ok[2:], **kw)  # int64 CSR
    with pytest.raises(TypeError):
        IC.pair_step(*ok, **{**kw, "d_b": 0})
    with pytest.raises(ValueError, match="int32"):
        IC.pair_step(*ok, **{**kw, "offset_a": I32_MAX - 1})  # the sweep steps pass int32
    with pytest.raises(ValueError):
        IC.pair_step(*ok, (fx,) * (ic_ops.MAX_SKIP + 1), **kw)  # more skip nodes than the kernel takes
    with pytest.raises(ValueError):
        IC.pair_step(*ok[:3], fr.to("meta"), fx, (0, 9), (0, 9), **kw)  # devices differ


@pytest.mark.parametrize("run", [1, 2, 3, 4, 16, 17, 64, 1 << 20])
@pytest.mark.parametrize("width_a,width_b", [(1, 1), (1, 4), (1, 64), (16, 4), (4, 16), (64, 4), (256, 256),
                                             (1024, 1 << 19), (1, 1 << 20)])
def test_step_plan_fits_every_tile(width_a, width_b, run):
    """The launch plan: lanes a power of two up to 32 (a lead element's
    pairs at least 8 a lane beyond one), the a lanes dividing them, the
    slices every tile of consecutive lead elements spans (counted here for
    every tile start) and the staged chunks within the shared memory the
    .cu takes."""
    group, group_a, chunk, max_slices = ic_ops.step_plan(width_a, width_b, run)
    assert group in (1, 2, 4, 8, 16, 32) and group_a in (1, 2, 4, 8, 16, 32) and group % group_a == 0
    assert group == 1 or 8 * group <= width_a * width_b
    assert group_a <= max(1, width_a) or group_a == 1
    rows = ic_ops.STEP_THREADS // group
    spanned = max((r0 + rows - 1) // run - r0 // run + 1 for r0 in range(0, min(run, 4096) + rows))
    assert spanned <= max_slices <= rows
    assert 1 <= chunk <= width_b
    assert max_slices * (8 * chunk + 24) <= ic_ops.STEP_SMEM
