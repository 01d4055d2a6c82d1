"""The port's window_degree (its plain version, which the wrapper takes
on the CPU) against the JAX package's op (the Pallas kernel in interpret
mode) and its reference, bit for bit, at the cases of
``tests/test_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.window_degree import window_degree as jax_window_degree
from repro.kernels.window_degree.kernel import PAD_T as JAX_PAD_T
from repro.kernels.window_degree.ref import window_degree_ref as jax_window_degree_ref
from repro_torch.kernels.window_degree import PAD_T, window_degree, window_degree_ref
from repro_torch.kernels.window_degree import ops as wd_ops


@pytest.mark.parametrize("b,d", [(1, 1), (7, 16), (64, 128), (100, 33), (5, 3), (40, 32)])
def test_matches_jax(b, d):
    rng = np.random.default_rng(b + d)
    t = rng.integers(0, 128, (b, d)).astype(np.int32)
    t[rng.random((b, d)) < 0.25] = PAD_T
    lo = rng.integers(0, 64, b).astype(np.int32)
    hi = lo + rng.integers(0, 64, b).astype(np.int32)
    before = wd_ops.launches
    got = window_degree(*(torch.from_numpy(a) for a in (t, lo, hi)))
    assert wd_ops.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.int32 and got.shape == (b,)
    args = tuple(jnp.asarray(a) for a in (t, lo, hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_window_degree(*args)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_window_degree_ref(*args)))


def test_padding_and_edges():
    assert PAD_T == JAX_PAD_T
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    # PAD_T never counts, even under the widest window; (lo, hi] is half open
    t = i32([[PAD_T, 5, 6, 7], [1, 2, 3, PAD_T]])
    got = window_degree(t, i32([PAD_T, 1]), i32([2**31 - 1, 3]))
    assert got.tolist() == [3, 2]
    assert torch.equal(got, window_degree_ref(t, i32([PAD_T, 1]), i32([2**31 - 1, 3])))
    assert window_degree(t[:0], i32([]), i32([])).shape == (0,)
    with pytest.raises(TypeError):
        window_degree(t.long(), i32([0, 0]), i32([1, 1]))
    with pytest.raises(ValueError):
        window_degree(t, i32([0]), i32([1]))
