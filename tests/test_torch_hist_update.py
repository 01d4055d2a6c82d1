"""The port's hist_update (its plain version, which the wrapper takes on
the CPU) against the JAX package's op (the Pallas kernel in interpret
mode) and its reference, at the cases of ``tests/test_kernels.py``; and
the fixed-point arithmetic of the CUDA kernel, replayed in numpy, against
its stated error bound."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hist_update import hist_update as jax_hist_update
from repro.kernels.hist_update.ref import hist_update_ref as jax_hist_update_ref
from repro_torch.kernels.hist_update import error_bound, hist_update, hist_update_ref
from repro_torch.kernels.hist_update import ops as hu_ops


def _case(n, s, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2, s + 2, n).astype(np.int32)
    gh = rng.normal(size=(n, 2)).astype(np.float32)
    return keys, gh


@pytest.mark.parametrize("n,s", [(16, 8), (1000, 97), (4096, 512), (513, 2048)])
def test_matches_jax(n, s):
    keys, gh = _case(n, s, n + s)
    before = hu_ops.launches
    got = hist_update(torch.from_numpy(keys), torch.from_numpy(gh), s)
    assert hu_ops.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (s, 2)
    # the Pallas kernel sums by a one-hot matmul: another order, so the
    # reference's own tolerance
    pallas = np.asarray(jax_hist_update(jnp.asarray(keys), jnp.asarray(gh), s))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
    ref = np.asarray(jax_hist_update_ref(jnp.asarray(keys), jnp.asarray(gh), s))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_f32_accumulation():
    # every row on one key: the sum's order differs from the Pallas
    # kernel's matmul, so the reference's tolerance for this case
    rng = np.random.default_rng(0)
    keys = np.zeros(2048, dtype=np.int32)
    gh = rng.normal(size=(2048, 2)).astype(np.float32)
    got = hist_update(torch.from_numpy(keys), torch.from_numpy(gh), 4).numpy()
    np.testing.assert_allclose(got[0], gh.sum(axis=0), rtol=1e-4, atol=1e-4)
    pallas = np.asarray(jax_hist_update(jnp.asarray(keys), jnp.asarray(gh), 4))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    assert np.all(got[1:] == 0)


def test_edges_and_checks():
    keys = torch.tensor([-1, 3, 0, 5, 3], dtype=torch.int32)
    gh = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    got = hist_update(keys, gh, 4)
    assert torch.equal(got, torch.tensor([[4.0, 5.0], [0, 0], [0, 0], [10.0, 12.0]]))
    assert torch.equal(hist_update(keys[:0], gh[:0], 3), torch.zeros(3, 2))
    assert torch.equal(hist_update_ref(keys, gh.double(), 4), got.double())
    with pytest.raises(TypeError):
        hist_update(keys.long(), gh, 4)
    with pytest.raises(TypeError):
        hist_update(keys, gh.double(), 4)
    with pytest.raises(ValueError):
        hist_update(keys, gh[:, :1], 4)
    with pytest.raises(ValueError):
        hist_update(keys, gh, -1)


def _kernel_model(keys, gh, s):
    """The CUDA kernel's arithmetic in numpy: rint(x * 2^k) summed as
    int64 per key, then Q * 2^-k rounded to float32."""
    n = len(keys)
    out = np.zeros((s, 2), dtype=np.float32)
    valid = (keys >= 0) & (keys < s)
    for c in range(2):
        k = hu_ops.scale_exponent(float(np.abs(gh[:, c]).max()), n)
        q = np.rint(gh[:, c].astype(np.float64) * 2.0**k).astype(np.int64)
        # the kernel's no-overflow promise for these rows
        assert np.abs(q).sum(dtype=object) < 2**62
        acc = np.zeros(s, dtype=np.int64)
        np.add.at(acc, keys[valid], q[valid])
        out[:, c] = (acc.astype(np.float64) * 2.0**-k).astype(np.float32)
    return out


@pytest.mark.parametrize("n,s", [(16, 8), (1000, 97), (4096, 512), (513, 2048), (1, 1)])
@pytest.mark.parametrize("spread", [1.0, 1e-30, 1e30])
def test_fixed_point_within_bound(n, s, spread):
    keys, gh = _case(n, s, n * s)
    gh = (gh * spread).astype(np.float32)
    model = _kernel_model(keys, gh, s)
    exact = hist_update_ref(torch.from_numpy(keys), torch.from_numpy(gh).double(), s).numpy()
    bound = error_bound(torch.from_numpy(keys), torch.from_numpy(gh), s).numpy()
    assert np.all(np.abs(model - exact) <= bound)
    # the bound means something: the quantum part is a tiny fraction of
    # the largest value, the rest is float32 rounding of the sums
    abs_sum = hist_update_ref(torch.from_numpy(keys), torch.from_numpy(np.abs(gh)).double(), s).numpy()
    assert np.all(bound <= 1e-9 * np.abs(gh).max() * n + 2.0**-22 * abs_sum)


def test_scale_exponent_leaves_headroom():
    for n in (1, 2, 3, 1 << 20, (1 << 26) + 1, 49_316_544):
        for max_abs in (1e-38, 0.25, 1.0, 3.99, 1e30):
            k = hu_ops.scale_exponent(max_abs, n)
            # n rows of |x| <= max_abs, each rounded up by at most 1/2
            assert n * (max_abs * 2.0**k + 0.5) < 2.0**62
            assert n * max_abs * 2.0**k >= 2.0**59  # no more than 3 bits idle
    assert hu_ops.scale_exponent(0.0, 5) == 0
    assert hu_ops.scale_exponent(math.nan, 5) == 0
