"""The port's recurrent mixers (``repro_torch.models.ssm``: Mamba2/SSD,
mLSTM, sLSTM) against the JAX package's ``repro.models.ssm`` on the CPU:
each mixer's full-sequence apply, every decode step's output and state,
the chunk scans over several chunks, and the causal convolution with a
carried state.  Weights are the reference's inits with numpy noise on the
constant leaves, inputs numpy draws; tolerance 1e-5 (float32, the
frameworks' ``exp``, ``softplus`` and sums a few ulps apart)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import ssm as JS
from repro_torch.configs.registry import smoke_config
from repro_torch.models import ssm as S

TOL = dict(rtol=1e-5, atol=1e-5)
MIXERS = {  # mixer -> an architecture whose smoke config has it
    "mamba2": "zamba2-2.7b",
    "mlstm": "xlstm-125m",
    "slstm": "xlstm-125m",
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(mixer):
    name = MIXERS[mixer]
    return (dataclasses.replace(jax_smoke_config(name), dtype="float32"),
            dataclasses.replace(smoke_config(name), dtype="float32"))


def _weights(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.array(a, dtype=np.float32)
        if np.all(a == a.flat[0]):  # a constant init: norm scale, A_log, D, dt_bias
            a = a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map(leaf, tree)


def _pair(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


@pytest.mark.parametrize("t", [16, 32])
@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_apply_matches_reference(mixer, t):
    cfg_j, cfg = _cfgs(mixer)
    pj, p = _pair(_weights(getattr(JS, f"{mixer}_init")(jax.random.key(1), cfg_j), 1))
    x = np.random.default_rng(t).normal(size=(3, t, cfg.d_model)).astype(np.float32)
    want = getattr(JS, f"{mixer}_apply")(pj, jnp.asarray(x), cfg_j)
    got = getattr(S, f"{mixer}_apply")(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_decode_steps_match_reference(mixer):
    """Each decode step's output and the whole state after it; and the
    steps together equal the full-sequence apply."""
    cfg_j, cfg = _cfgs(mixer)
    pj, p = _pair(_weights(getattr(JS, f"{mixer}_init")(jax.random.key(2), cfg_j), 2))
    b, t = 2, 8
    x = np.random.default_rng(2).normal(size=(b, t, cfg.d_model)).astype(np.float32)
    cache_j = getattr(JS, f"{mixer}_cache_init")(cfg_j, b, jnp.float32)
    cache = getattr(S, f"{mixer}_cache_init")(cfg, b, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in cache_j.items()}
    decode_j, decode = getattr(JS, f"{mixer}_decode"), getattr(S, f"{mixer}_decode")
    outs = []
    for i in range(t):
        y_j, cache_j = decode_j(pj, jnp.asarray(x[:, i : i + 1]), cfg_j, cache_j)
        y, cache = decode(p, torch.from_numpy(x[:, i : i + 1]), cfg, cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
        assert set(cache) == set(cache_j)
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(cache_j[k]), **TOL)
        outs.append(y)
    full = getattr(S, f"{mixer}_apply")(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_ssd_scan_over_chunks():
    """The chunk loop carries the state: several chunks of 4 equal the
    reference's scan, and the whole sequence as one chunk."""
    rng = np.random.default_rng(3)
    b, t, h, hd, n = 2, 16, 3, 8, 5
    x, bb, cc = (rng.normal(size=s).astype(np.float32) for s in ((b, t, h, hd), (b, t, n), (b, t, n)))
    dt = np.log1p(np.exp(rng.normal(size=(b, t, h)))).astype(np.float32)
    a_neg = -np.exp(rng.normal(size=h)).astype(np.float32)
    args = (x, bb, cc, dt, a_neg)
    want = JS._ssd_scan(*map(jnp.asarray, args), chunk=4)
    got = S._ssd_scan(*map(torch.from_numpy, args), chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    one = S._ssd_scan(*map(torch.from_numpy, args), chunk=16)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(AssertionError, match="chunk"):
        S._ssd_scan(*(torch.from_numpy(a[:, :14]) for a in args[:4]), torch.from_numpy(a_neg), chunk=4)


def test_mlstm_chunk_over_chunks():
    rng = np.random.default_rng(4)
    b, t, h, hd = 2, 16, 2, 8
    q, k = (rng.normal(size=(b, t, h, hd)).astype(np.float32) for _ in range(2))
    v1 = np.concatenate([rng.normal(size=(b, t, h, hd)), np.ones((b, t, h, 1))], -1).astype(np.float32)
    logf, logi = (-np.log1p(np.exp(-rng.normal(size=(b, t, h)))).astype(np.float32) for _ in range(2))
    args = (q, k, v1, logf, logi)
    want = JS._mlstm_chunk(*map(jnp.asarray, args), chunk=4)
    got = S._mlstm_chunk(*map(torch.from_numpy, args), chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_causal_conv_with_state():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 7)).astype(np.float32)
    w = rng.normal(size=(4, 7)).astype(np.float32)
    state = rng.normal(size=(2, 3, 7)).astype(np.float32)
    for st in (None, state):
        want = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), None if st is None else jnp.asarray(st))
        got = S._causal_conv(torch.from_numpy(x), torch.from_numpy(w), None if st is None else torch.from_numpy(st))
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)


def test_init_shapes_and_meta():
    for mixer in sorted(MIXERS):
        cfg_j, cfg = _cfgs(mixer)
        want = jax.tree_util.tree_map(lambda a: a.shape, getattr(JS, f"{mixer}_init")(jax.random.key(0), cfg_j))
        drawn = getattr(S, f"{mixer}_init")(torch.Generator().manual_seed(0), cfg)
        meta = getattr(S, f"{mixer}_init")(None, cfg)
        for tree in (drawn, meta):
            assert jax.tree_util.tree_map(lambda a: tuple(a.shape), tree) == want
        assert all(a.device.type == "meta" for a in jax.tree_util.tree_leaves(meta))
