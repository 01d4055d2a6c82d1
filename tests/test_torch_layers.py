"""The port's transformer layers (``repro_torch.models.layers``) against
the JAX package's ``repro.models.layers`` with the same weights, on the
CPU: RMS norm, RoPE, causal attention under both backends (the
flash_attention wrapper's plain version, and the explicit-op ``_sdpa``)
and the SwiGLU MLP.  Weights and inputs are drawn with numpy and handed
to both.  Tolerance 2e-5: the two frameworks round sums and the
transcendentals (rsqrt, cos, sin, exp, sigmoid) by a few ulps apart."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L

TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(**kw):
    kw = {"d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_head": 16, "dtype": "float32", **kw}
    return (
        dataclasses.replace(jax_get_config("fraudgt-small"), **kw),
        dataclasses.replace(get_config("fraudgt-small"), **kw),
    )


def _weights(tree, rng):
    """numpy weights of ``tree``'s shapes (scales like the inits, plus
    noise on the norm scales and biases so that they matter)."""
    if isinstance(tree, dict):
        return {k: _weights(v, rng) for k, v in tree.items()}
    shape = tuple(tree.shape)
    w = rng.normal(size=shape) / np.sqrt(shape[0]) if len(shape) == 2 else 1.0 + 0.1 * rng.normal(size=shape)
    return w.astype(np.float32)


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17, 64)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    want = np.asarray(JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    got = L.rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert L.RMSNorm({"scale": scale})(torch.from_numpy(x)).detach().numpy().tolist() == got.tolist()


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 33, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(33, dtype=np.int32), (2, 1))
    want = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"n_kv_heads": 2},  # GQA
        {"n_kv_heads": 1, "qkv_bias": True},
        {"n_kv_heads": 2, "qk_norm": True, "rope_theta": 1_000_000.0},
        {"d_model": 128, "n_heads": 8, "n_kv_heads": 8, "d_head": None},  # FraudGT's widths
    ],
)
def test_attn_apply(backend, kw):
    cfg_j, cfg = _cfgs(**kw)
    rng = np.random.default_rng(len(kw))
    p = _weights(JL.attn_init(jax.random.key(0), cfg_j), rng)
    x = rng.normal(size=(3, 17, cfg.d_model)).astype(np.float32)
    want = np.asarray(JL.attn_apply(_to(p, jnp.asarray), jnp.asarray(x), cfg_j))
    before = fa_ops.launches
    got = L.attn_apply(_to(p, torch.from_numpy), torch.from_numpy(x), cfg, backend=backend)
    assert fa_ops.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with torch.no_grad():
        mod = L.Attention(p, cfg, backend)(torch.from_numpy(x))
    np.testing.assert_array_equal(mod.numpy(), got.numpy())


def test_attn_init_shapes():
    cfg_j, cfg = _cfgs(n_kv_heads=2, qkv_bias=True, qk_norm=True)
    want = jax.tree_util.tree_map(lambda a: a.shape, JL.attn_init(jax.random.key(0), cfg_j))
    got = _to(L.attn_init(torch.Generator().manual_seed(0), cfg), lambda a: tuple(a.shape))
    assert got == want


def test_mlp_apply():
    rng = np.random.default_rng(3)
    p = _weights(JL.mlp_init(jax.random.key(0), 64, 256), rng)
    x = rng.normal(size=(4, 17, 64)).astype(np.float32)
    want = np.asarray(JL.mlp_apply(_to(p, jnp.asarray), jnp.asarray(x)))
    got = L.mlp_apply(_to(p, torch.from_numpy), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    got_init = L.mlp_init(torch.Generator().manual_seed(0), 64, 256)
    assert {k: tuple(v.shape) for k, v in got_init.items()} == {k: v.shape for k, v in p.items()}


def test_unported_raise():
    """Nothing is left unported here: a sliding window that masks
    something runs the kernel (its plain version on the CPU) and equals
    the torch backend, as does a window the sequence fits in.  The LM's
    meshes (A12b) take the CUDA card unless given the CPU, and need an
    initialised process group; neither falls back."""
    _, cfg = _cfgs(attn_window=8)
    p = L.attn_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 9, 64)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(L.attn_apply(p, x, cfg), L.attn_apply(p, x, cfg, backend="torch"),
                                   rtol=1e-5, atol=1e-5)
        assert L.attn_apply(p, x[:, :8], cfg).shape == (1, 8, 64)
    from repro_torch.launch import mesh

    for make in (mesh.make_production_mesh, mesh.make_local_mesh):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()
        with pytest.raises(RuntimeError, match="process group"):
            make(device="cpu")
    with pytest.raises(ValueError, match="backend"):
        L.attn_apply({}, x, _cfgs()[1], backend="xla")
