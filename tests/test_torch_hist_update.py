"""The port's hist_update (its plain version, which the wrapper takes on
the CPU) against the JAX package's op (the Pallas kernel in interpret
mode) and its reference, at the cases of ``tests/test_kernels.py``; its
``rows`` entry against the JAX package's ``gbdt._histograms``; and the
fixed-point arithmetic of both entries of the CUDA kernel, replayed in
numpy, against their stated error bounds and the plain torch replay
(``ref.fixed_point_ref``) that the card is held to."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hist_update import hist_update as jax_hist_update
from repro.kernels.hist_update.ref import hist_update_ref as jax_hist_update_ref
from repro.ml import gbdt as jax_gbdt
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


def _kernel_model(keys, gh, s, n=None):
    """The CUDA kernel's arithmetic in numpy: rint(x * 2^k) summed as
    int64 per key, then Q * 2^-k rounded to float32; k is set by ``n``
    rows (the number of keys unless given)."""
    per_key = n is not None
    n = len(keys) if n is None else n
    out = np.zeros((s, 2), dtype=np.float32)
    valid = (keys >= 0) & (keys < s)
    for c in range(2):
        k = hu_ops.scale_exponent(float(np.abs(gh[:, c]).max()) if len(gh) else 0.0, n)
        q = np.rint(gh[:, c].astype(np.float64) * 2.0**k).astype(np.int64)
        # the kernel's no-overflow promise for these rows: over all of
        # them for the keys entry, into any one key for the rows entry
        # (whose scale is set by fewer rows than items)
        if per_key:
            abs_acc = np.zeros(s, dtype=object)
            np.add.at(abs_acc, keys[valid], np.abs(q[valid]).astype(object))
            assert all(a < 2**62 for a in abs_acc)
        else:
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


@pytest.mark.parametrize("n,s", [(16, 8), (1000, 97), (4096, 512), (513, 2048), (1, 1), (0, 4)])
@pytest.mark.parametrize("spread", [1.0, 1e-30, 1e30])
def test_fixed_point_ref_replays_the_kernel(n, s, spread):
    keys, gh = _case(n, s, n + 7 * s)
    gh = (gh * spread).astype(np.float32)
    got = fixed_point_ref(torch.from_numpy(keys), torch.from_numpy(gh), s, n)
    assert got.dtype == torch.float32 and got.shape == (s, 2)
    np.testing.assert_array_equal(got.numpy(), _kernel_model(keys, gh, s))


def _rows_case(n, f, n_bins, n_nodes, seed):
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, n_bins, (n, f)).astype(np.uint8)
    gh = rng.normal(size=(n, 2)).astype(np.float32)
    node = rng.integers(0, n_nodes, n).astype(np.int32)
    return xb, node, gh


# nodes as at GBDT levels 0, 1 and 5; one feature and the path's 12;
# bins up to 255; zero rows
ROWS_CASES = [
    (600, f, n_bins, n_nodes) for n_nodes in (1, 2, 32) for f in (1, 12) for n_bins in (16, 256)
] + [(0, 12, 256, 2), (0, 1, 16, 1), (1, 3, 255, 1)]


@pytest.mark.parametrize("n,f,n_bins,n_nodes", ROWS_CASES)
def test_rows_matches_jax_histograms(n, f, n_bins, n_nodes):
    xb, node, gh = _rows_case(n, f, n_bins, n_nodes, n + f + n_bins + n_nodes)
    before = hu_ops.launches
    got = hist_update_rows(torch.from_numpy(xb), torch.from_numpy(node), torch.from_numpy(gh), n_nodes, n_bins)
    assert hu_ops.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (n_nodes, f, n_bins, 2)
    want = np.asarray(jax_gbdt._histograms(jnp.asarray(xb), jnp.asarray(gh), jnp.asarray(node), n_nodes, n_bins))
    # the same keys, the same repeat, a segment sum in row order on both
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,f,n_bins,n_nodes", [(600, 12, 256, 32), (513, 1, 16, 2), (1, 12, 256, 1), (4096, 3, 7, 4)])
@pytest.mark.parametrize("spread", [1.0, 1e-30, 1e30])
def test_rows_fixed_point_within_bound(n, f, n_bins, n_nodes, spread):
    xb, node, gh = _rows_case(n, f, n_bins, n_nodes, n * f + n_nodes)
    gh = (gh * spread).astype(np.float32)
    txb, tnode, tgh = torch.from_numpy(xb), torch.from_numpy(node), torch.from_numpy(gh)
    s = n_nodes * f * n_bins
    keys = row_keys(txb, tnode, n_bins).numpy()
    gh_rep = np.repeat(gh, f, axis=0)
    # the rows entry quantises at the scale of its n rows, not its n * f
    # items: a key takes at most one item of a row
    model = _kernel_model(keys, gh_rep, s, n).reshape(n_nodes, f, n_bins, 2)
    replay = fixed_point_ref(torch.from_numpy(keys), torch.from_numpy(gh_rep), s, n)
    np.testing.assert_array_equal(replay.numpy().reshape(model.shape), model)
    exact = hist_update_rows_ref(txb, tnode, tgh.double(), n_nodes, n_bins).numpy()
    bound = error_bound_rows(txb, tnode, tgh, n_nodes, n_bins).numpy()
    assert bound.shape == (n_nodes, f, n_bins, 2)
    assert np.all(np.abs(model - exact) <= bound)
    # no looser than the keys entry's bound on the same items
    keys_bound = error_bound(torch.from_numpy(keys), torch.from_numpy(gh_rep), s).numpy()
    assert np.all(bound <= keys_bound.reshape(bound.shape))


def test_rows_checks():
    xb = torch.zeros((5, 3), dtype=torch.uint8)
    node = torch.zeros(5, dtype=torch.int32)
    gh = torch.ones((5, 2))
    got = hist_update_rows(xb, node, gh, 2, 4)
    assert torch.equal(got[0, :, 0], torch.full((3, 2), 5.0)) and float(got.sum()) == 30.0
    assert torch.equal(hist_update_rows(xb[:0], node[:0], gh[:0], 2, 4), torch.zeros(2, 3, 4, 2))
    with pytest.raises(TypeError):
        hist_update_rows(xb.int(), node, gh, 2, 4)
    with pytest.raises(TypeError):
        hist_update_rows(xb, node.long(), gh, 2, 4)
    with pytest.raises(TypeError):
        hist_update_rows(xb, node, gh.double(), 2, 4)
    with pytest.raises(ValueError):
        hist_update_rows(xb, node[:4], gh, 2, 4)
    with pytest.raises(ValueError):
        hist_update_rows(xb, node, gh[:, :1], 2, 4)
    with pytest.raises(ValueError):
        hist_update_rows(xb, node, gh, 1 << 20, 1 << 10)
