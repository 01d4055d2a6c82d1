"""The port's AdamW and int8 error-feedback compression
(``repro_torch.distributed.optimizer``) against the JAX package's over
seeded nested dicts: five steps with the global-norm clip inactive and
active give the same params, moments and norms within 1e-6 in float32,
and the compressed gradients are the same int8 codes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import optimizer as ref
from repro_torch.distributed import optimizer as port

SHAPES = {"w": (6, 5), "b": (7,), "blk": {"scale": (5,), "wq": (3, 2, 4), "bias": ()}}


def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} if isinstance(t, dict) else fn(t)


def _draw(rng, scale):
    return _tree(lambda sh: np.asarray(rng.standard_normal(sh) * scale, dtype=np.float32).reshape(sh), SHAPES)


def _flat(t):
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in jax.tree_util.tree_leaves(t)])


def _port_flat(t):
    return np.concatenate([x.numpy().ravel() for x in port._leaves(t)])


@pytest.mark.parametrize("grad_scale, clipped", [(0.01, False), (10.0, True)])
@pytest.mark.parametrize("wd", [0.1, 0.0])
def test_adamw_equals_reference(grad_scale, clipped, wd):
    rng = np.random.default_rng(0)
    params = _draw(rng, 1.0)
    rcfg, pcfg = ref.AdamWConfig(lr=1e-2, weight_decay=wd), port.AdamWConfig(lr=1e-2, weight_decay=wd)
    rp, tp = _tree(jnp.asarray, params), _tree(torch.from_numpy, params)
    ro, to = ref.adamw_init(rp), port.adamw_init(tp)
    for _ in range(5):
        g = _draw(rng, grad_scale)
        rp, ro, rgn = ref.adamw_update(rp, _tree(jnp.asarray, g), ro, rcfg)
        tp, to, tgn = port.adamw_update(tp, _tree(torch.from_numpy, g), to, pcfg)
        assert (float(rgn) > pcfg.grad_clip) == clipped
        np.testing.assert_allclose(float(tgn), float(rgn), rtol=1e-6)
        np.testing.assert_allclose(_port_flat(tp), _flat(rp), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_port_flat(to["m"]), _flat(ro["m"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_port_flat(to["v"]), _flat(ro["v"]), rtol=0, atol=1e-6)
        assert int(to["step"]) == int(ro["step"]) and to["step"].dtype == torch.int32
    assert set(tp) == set(SHAPES) and tp["blk"]["bias"].shape == ()


def test_ef_compress_equals_reference():
    rng = np.random.default_rng(1)
    g0 = _draw(rng, 1.0)
    rr, tr = ref.ef_init(_tree(jnp.asarray, g0)), port.ef_init(_tree(torch.from_numpy, g0))
    for _ in range(5):
        g = _draw(rng, 3.0)
        rd, rr = ref.ef_compress_grads(_tree(jnp.asarray, g), rr)
        td, tr = port.ef_compress_grads(_tree(torch.from_numpy, g), tr)
        np.testing.assert_allclose(_port_flat(td), _flat(rd), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_port_flat(tr), _flat(rr), rtol=0, atol=1e-6)
    for leaf in port._leaves(g0):
        q1, s1 = ref.compress_int8(jnp.asarray(leaf))
        q2, s2 = port.compress_int8(torch.from_numpy(leaf))
        assert q2.dtype == torch.int8
        np.testing.assert_array_equal(q2.numpy(), np.asarray(q1))
        assert float(s2) == float(s1)
        np.testing.assert_array_equal(port.decompress_int8(q2, s2).numpy(), np.asarray(ref.decompress_int8(q1, s1)))


def test_update_stays_on_the_device_without_a_sync():
    """The clip, the bias corrections and the step are 0-d tensors: nothing
    of an update is a Python number (no .item())."""
    p = {"a": torch.ones(3)}
    new, st, gn = port.adamw_update(p, {"a": torch.full((3,), 5.0)}, port.adamw_init(p), port.AdamWConfig())
    assert isinstance(gn, torch.Tensor) and gn.dim() == 0
    assert isinstance(st["step"], torch.Tensor) and int(st["step"]) == 1
    assert new["a"].dtype == torch.float32 and torch.all(new["a"] < 1)
