"""The port's intersect_count: its plain PyTorch version against the JAX
package's op (the Pallas kernel in interpret mode) on the reference
test cases and small bucket-ladder shapes; and the wrapper's dispatch
rules.  The CUDA kernel itself is checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import intersect_count as jax_intersect_count
from repro_torch.kernels import build
from repro_torch.kernels.intersect_count import intersect_count, intersect_count_ref
from repro_torch.kernels.intersect_count import ops as ic_ops


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
