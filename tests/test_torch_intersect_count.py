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

