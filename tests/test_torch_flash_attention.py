"""The port's flash_attention (its plain version, which the wrapper takes
on the CPU) against the JAX package's reference, at every case of
``tests/test_flash_attention.py`` and its tolerances.  The JAX Pallas
kernel itself cannot run here (it calls ``pl.load``, which jax 0.9 no
longer has), so its oracle ``flash_attention_ref``, with the JAX
wrapper's repeat of the K/V heads, stands for it.  Also: causal
attention over fewer keys than queries, the launch count, what the
wrapper refuses, and the path (``ops.plan``) each shape takes on the
card.  The backward (short and long paths): its plain version
(``flash_attention_bwd_ref``, explicit math) against torch autograd of the
plain forward and against ``jax.vjp`` of the reference's XLA attention
(``repro.models.layers._sdpa``, what the JAX fit differentiates), and
``FlashAttentionFn`` against both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.hypothesis_compat import given, settings, st

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models.layers import _sdpa as jax_sdpa
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops


def _inputs(b, t, s, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, t, h, hd)).astype(np.float32),
        rng.normal(size=(b, s, kvh, hd)).astype(np.float32),
        rng.normal(size=(b, s, kvh, hd)).astype(np.float32),
    )


def _jax(q, k, v, causal, dtype):
    """The JAX wrapper's contract: repeat K/V heads, flatten, oracle."""
    b, t, h, hd = q.shape
    s, g = k.shape[1], h // k.shape[2]
    kk, vv = (np.repeat(x, g, axis=2) for x in (k, v))
    flat = lambda x, n: jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, n, hd), dtype)
    out = jax_ref(flat(q, t), flat(kk, s), flat(vv, s), causal=causal)
    return np.asarray(out, np.float32).reshape(b, h, t, hd).transpose(0, 2, 1, 3)


def _case(b, t, h, kvh, hd, causal, dtype, bq=64, bk=64, seed=0):
    q, k, v = _inputs(b, t, t, h, kvh, hd, seed)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    before = fa_ops.launches
    got = flash_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=causal, block_q=bq, block_k=bk
    )
    assert fa_ops.launches == before  # the CPU takes the plain version
    assert got.shape == (b, t, h, hd) and got.dtype == tdt
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(), _jax(q, k, v, causal, dtype), rtol=tol, atol=tol)


@pytest.mark.parametrize("t", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_shapes(t, causal):
    _case(2, t, 4, 4, 32, causal, jnp.float32)


def test_gqa_heads():
    _case(1, 128, 8, 2, 64, True, jnp.float32)


def test_bf16():
    _case(1, 128, 4, 4, 64, True, jnp.bfloat16)


def test_unaligned_t_padding():
    _case(1, 96, 2, 2, 32, True, jnp.float32, bq=64, bk=32)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 1000))
def test_hypothesis_random(seed):
    rng = np.random.default_rng(seed)
    t = int(rng.choice([64, 128, 192]))
    h = int(rng.choice([1, 2, 4]))
    hd = int(rng.choice([16, 32, 64]))
    _case(1, t, h, h, hd, bool(rng.integers(0, 2)), jnp.float32, seed=seed)


def test_fully_masked_blocks_safe():
    _case(1, 256, 1, 1, 32, True, jnp.float32, bq=32, bk=128)


def test_fewer_keys_than_queries():
    """Causal, T > S, S not a block multiple: rows i >= S see exactly the
    S keys, as the plain version says (the JAX wrapper's zero padding would
    let them see padded keys too)."""
    q, k, v = _inputs(2, 80, 50, 4, 2, 16, 5)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True, block_q=32, block_k=32)
    want = _jax(q, k, v, True, jnp.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # row 79 of batch 0, head 0 (kv head 0): a softmax over all 50 keys
    sc = q[0, 79, 0] @ k[0, :, 0].T / 4.0
    w = np.exp(sc - sc.max())
    np.testing.assert_allclose(got[0, 79, 0].numpy(), w @ v[0, :, 0] / w.sum(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bq,bk", [(16, 16), (64, 128), (128, 96)])
def test_blocks_do_not_change_the_result(bq, bk):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 96, 96, 4, 2, 32, 9))
    base = flash_attention(q, k, v)
    assert torch.equal(flash_attention(q, k, v, block_q=bq, block_k=bk), base)


def test_refuses():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 40, 40, 4, 2, 16, 1))
    with pytest.raises(ValueError, match="non-causal"):
        flash_attention(q, k, v, causal=False, block_k=32)  # 40 % 32 != 0
    flash_attention(q, k, v, causal=False, block_k=128)  # one block of 40 keys
    with pytest.raises(ValueError, match="head sizes"):
        flash_attention(q[..., :8], k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="H % K"):
        flash_attention(q[:, :, :3], k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="block sizes"):
        flash_attention(q, k, v, block_q=0)
    with pytest.raises(ValueError, match="takes q"):
        flash_attention(q[0], k, v)


F32, BF16 = torch.float32, torch.bfloat16


# (T, S, H, K, hd, dtype, path) at every boundary of ops.plan: T and S at
# 32 / 33, each head size, both dtypes, GQA, T > S, and two stages of one
# batch element's slabs against the 227 KB of shared memory
@pytest.mark.parametrize(
    "t,s,h,kvh,hd,dtype,path",
    [
        (17, 17, 8, 8, 16, F32, "short"),  # FraudGT
        (32, 32, 8, 8, 16, F32, "short"),
        (33, 32, 8, 8, 16, F32, "simt"),
        (32, 33, 8, 8, 16, F32, "simt"),
        (32, 32, 8, 2, 32, F32, "short"),
        (33, 33, 8, 2, 32, BF16, "simt"),
        (32, 32, 8, 8, 64, BF16, "short"),
        (33, 32, 8, 8, 64, BF16, "wgmma"),
        (32, 33, 8, 2, 64, BF16, "wgmma"),
        (33, 33, 8, 8, 64, F32, "simt"),
        (20, 10, 8, 2, 16, F32, "short"),  # T > S
        (40, 20, 4, 1, 128, BF16, "wgmma"),
        (40, 20, 4, 1, 128, F32, "simt"),
        (32, 32, 2, 2, 128, F32, "short"),  # 2 x 98,304 bytes: two stages fit
        (32, 32, 4, 4, 128, F32, "simt"),  # 2 x 196,608 bytes do not
        (32, 32, 4, 4, 128, BF16, "short"),
        (32, 32, 16, 16, 128, BF16, "wgmma"),
        (32, 32, 16, 16, 16, BF16, "short"),
        (1, 1, 1, 1, 16, BF16, "short"),
        (4096, 4096, 32, 8, 128, BF16, "wgmma"),  # chip_smoke.py's long shape
        (4096, 4096, 32, 8, 64, BF16, "wgmma"),
        (4096, 4096, 32, 8, 32, BF16, "simt"),
        (4096, 4096, 32, 8, 16, BF16, "simt"),
        (4096, 4096, 32, 8, 128, F32, "simt"),
        # hd 80 (zamba2-2.7b's) never takes the short path: wgmma in bf16,
        # simt in float32, at every T
        (17, 17, 8, 8, 80, F32, "simt"),
        (17, 17, 8, 8, 80, BF16, "wgmma"),
        (1, 1, 1, 1, 80, BF16, "wgmma"),
        (32768, 32768, 32, 32, 80, BF16, "wgmma"),  # zamba2's prefill launch
        (4096, 4096, 32, 32, 80, F32, "simt"),
    ],
)
@pytest.mark.parametrize("causal", [True, False])
def test_plan_at_path_boundaries(t, s, h, kvh, hd, dtype, path, causal):
    for b in (1, 1024, 5003):  # the batch size never changes the path
        assert fa_ops.plan(b, t, s, h, kvh, hd, dtype, causal) == path


def test_build_hashes_the_included_headers(tmp_path, monkeypatch):
    """The flash_attention source includes its path headers; the library's
    name changes when a header does, so an edited header rebuilds."""
    assert [p.name for p in build.sources("flash_attention")] == [
        "flash_attention.cu", "flash_common.cuh", "flash_short.cuh", "flash_long_bwd.cuh", "flash_short_bwd.cuh",
        "flash_wgmma.cuh", "flash_hopper.cuh"]
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\nint k;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int b = 1;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = build.library_path("k")
    (tmp_path / "b.cuh").write_text("int b = 2;\n")
    assert build.library_path("k") != before


# (B, T, S, H, K, hd, causal): FraudGT's training shape at a few edges,
# GQA, T > S (causal rows i >= S see all S keys), one key, hd 64, and a
# grid of heads that is not a power of two, causal T < S (keys no row
# sees) and a causal GQA group of 4 at hd 32; then the long backward's
# shapes (T or S above 32): causal and full, ragged tiles, T > S and
# T < S, GQA, hd 16 to 128
BWD_SHAPES = [
    (4, 17, 17, 8, 8, 16, True),
    (3, 17, 17, 8, 2, 32, False),
    (2, 20, 12, 8, 2, 16, True),
    (2, 32, 32, 2, 1, 64, False),
    (3, 1, 1, 8, 8, 16, True),
    (2, 5, 7, 6, 3, 16, False),
    (2, 12, 20, 8, 2, 16, True),
    (2, 17, 17, 8, 2, 32, True),
]
LONG_BWD_SHAPES = [
    (1, 100, 100, 4, 2, 16, True),
    (2, 70, 70, 2, 2, 32, False),
    (2, 80, 50, 4, 2, 16, True),
    (1, 40, 90, 6, 2, 64, True),
    (1, 65, 1, 2, 1, 128, True),
    (1, 33, 48, 4, 1, 32, False),
]


def _bwd_inputs(b, t, s, h, kvh, hd, seed):
    q, k, v = _inputs(b, t, s, h, kvh, hd, seed)
    do = np.random.default_rng(seed + 1).normal(size=(b, t, h, hd)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, window=None):
    """jax.vjp of the reference's XLA attention at the cotangent do, under
    the mask the reference's ``attn_apply`` builds (``i - j < window``
    beside the causal one, ``src/repro/models/layers.py:151-152``)."""
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    j, i = np.arange(s)[None, :], np.arange(t)[:, None]
    mask = j <= i if causal else np.ones((t, s), bool)
    if window is not None:
        mask = mask & (i - j < window)
    mask = jnp.asarray(mask)

    def f(q, k, v):
        return jax_sdpa(q.reshape(b, t, kvh, h // kvh, hd), k, v, mask).reshape(b, t, h, hd)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("b,t,s,h,kvh,hd,causal", BWD_SHAPES + LONG_BWD_SHAPES)
def test_bwd_plain_equals_autograd_and_jax(b, t, s, h, kvh, hd, causal):
    q, k, v, do = _bwd_inputs(b, t, s, h, kvh, hd, seed=b + t + s + hd)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    out.backward(torch.from_numpy(do))  # autograd through the plain forward
    before = fa_ops.bwd_launches
    plain = fa_ops.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)), out.detach(), torch.from_numpy(do), lse.detach(), causal=causal
    )
    assert fa_ops.bwd_launches == before  # the CPU takes the plain version
    want = _jax_grads(q, k, v, do, causal)
    for name, got, auto, ref in zip("qkv", plain, (tq.grad, tk.grad, tv.grad), want):
        assert got.shape == auto.shape == ref.shape, name
        np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("b,t,s,h,kvh,hd,causal", BWD_SHAPES[:3] + LONG_BWD_SHAPES[:3])
def test_flash_attention_fn_gradients(b, t, s, h, kvh, hd, causal):
    q, k, v, do = _bwd_inputs(b, t, s, h, kvh, hd, seed=7)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa_ops.FlashAttentionFn.apply(*leaves, causal)
    np.testing.assert_allclose(out.detach().numpy(), _jax(q, k, v, causal, jnp.float32), rtol=2e-5, atol=2e-5)
    out.backward(torch.from_numpy(do))
    for name, leaf, ref in zip("qkv", leaves, _jax_grads(q, k, v, do, causal)):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=0, atol=1e-5, err_msg=name)


def test_bwd_off_the_short_path_raises():
    """T, S > 32 is the long backward's shape: the logsumexp, the wrapper's
    backward and the autograd Function run (the plain version on the CPU,
    no launch) and equal torch autograd of the plain forward within 1e-5.
    (Before the long backward existed, this shape raised.)"""
    q, k, v, do = (torch.from_numpy(x) for x in _bwd_inputs(1, 40, 40, 2, 2, 16, seed=3))
    assert fa_ops.bwd_plan(1, 40, 40, 2, 2, 16, torch.float32, True) == "simt"
    before = (fa_ops.launches, fa_ops.lse_launches, fa_ops.bwd_launches, fa_ops.long_bwd_launches)
    out, lse = flash_attention(q, k, v, return_lse=True)
    want_lse = torch.logsumexp(torch.where(torch.ones(40, 40, dtype=torch.bool).tril(),
                                           torch.einsum("bthd,bshd->bhts", q, k) / 4.0, -1e30), dim=-1)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    grads = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa_ops.FlashAttentionFn.apply(*leaves, True).backward(do)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    ref = fa_ops.flash_attention_ref(*(x.transpose(1, 2).reshape(2, -1, 16) for x in (tq, tk, tv)), causal=True)
    ref.backward(do.transpose(1, 2).reshape(2, 40, 16))
    for name, got, fn, auto in zip("qkv", grads, leaves, (tq, tk, tv)):
        torch.testing.assert_close(got, auto.grad, rtol=0, atol=1e-5, msg=name)
        torch.testing.assert_close(fn.grad, auto.grad, rtol=0, atol=1e-5, msg=name)
    assert (fa_ops.launches, fa_ops.lse_launches, fa_ops.bwd_launches, fa_ops.long_bwd_launches) == before


@pytest.mark.parametrize(
    "t,s,h,kvh,hd,dtype,path",
    [
        (17, 17, 8, 8, 16, F32, "short"),
        (32, 32, 4, 4, 128, BF16, "short"),
        (32, 32, 4, 4, 128, F32, "simt"),  # a short shape whose slabs do not fit
        (32, 32, 16, 16, 128, BF16, "wgmma"),
        (33, 33, 2, 2, 64, BF16, "wgmma"),
        (33, 33, 2, 2, 32, BF16, "simt"),
        (4096, 4096, 12, 2, 128, BF16, "wgmma"),  # qwen2-1.5b's training launch
        (4096, 4096, 12, 2, 128, F32, "simt"),
        (1000, 1000, 8, 2, 16, BF16, "simt"),
        (40, 1, 4, 4, 64, BF16, "wgmma"),
        (17, 17, 4, 4, 80, BF16, "wgmma"),  # hd 80: no short backward
        (17, 17, 4, 4, 80, F32, "simt"),
        (4096, 4096, 32, 32, 80, BF16, "wgmma"),  # zamba2's training launch
    ],
)
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plan_at_path_boundaries(t, s, h, kvh, hd, dtype, path, causal):
    for b in (1, 4, 5003):  # the batch size never changes the path
        assert fa_ops.bwd_plan(b, t, s, h, kvh, hd, dtype, causal) == path


@pytest.mark.parametrize(
    "t,s,h,kvh,hd,dtype,route",
    [
        (17, 17, 8, 8, 16, F32, ("ring", 2)),  # FraudGT's training launch: 2 x 44,160 + 18,560 bytes
        (17, 17, 8, 2, 32, BF16, ("ring", 2)),
        (20, 12, 8, 2, 16, F32, ("ring", 2)),  # T > S
        (12, 20, 8, 2, 16, F32, ("ring", 2)),  # T < S
        (1, 1, 1, 1, 16, BF16, ("ring", 2)),  # room for hundreds of stages; the ring keeps two
        (32, 32, 7, 7, 16, F32, ("ring", 2)),  # 2 x 72,576 + 59,136 + 128 = 204,416 bytes fit
        (32, 32, 8, 8, 16, F32, ("chunked", 0)),  # 2 x 82,944 + 67,584 + 128 = 233,600 do not
        (17, 17, 17, 17, 16, F32, ("ring", 2)),
        (17, 17, 18, 18, 16, F32, ("chunked", 0)),
        (32, 32, 2, 2, 64, F32, ("ring", 2)),
        (32, 32, 3, 3, 64, F32, ("chunked", 0)),
        (32, 32, 2, 1, 64, BF16, ("ring", 2)),
        (32, 32, 2, 2, 128, F32, ("chunked", 0)),  # the forward's two stages fit, the backward's do not
        (32, 32, 4, 4, 128, BF16, ("chunked", 0)),
        (32, 32, 12, 1, 64, F32, ("chunked", 0)),
        (32, 32, 16, 1, 64, BF16, ("chunked", 0)),
        (32, 1, 17, 17, 16, F32, ("ring", 2)),
        (32, 1, 18, 18, 16, F32, ("chunked", 0)),
    ],
)
@pytest.mark.parametrize("causal", [True, False])
def test_short_bwd_route_at_boundaries(t, s, h, kvh, hd, dtype, route, causal):
    """``short_bwd_route``: the ring where two stages of an element's slabs
    and lse fit beside its p/dS buffer, the chunked route where they do
    not, at both sides of the limit; every shape is the forward's short
    path's, and the batch size never changes the route."""
    for b in (1, 256, 5003):
        assert fa_ops.bwd_plan(b, t, s, h, kvh, hd, dtype, causal) == "short"
        assert fa_ops.short_bwd_route(b, t, s, h, kvh, hd, dtype, causal) == route
    with pytest.raises(ValueError):
        fa_ops.short_bwd_route(1, 33, 33, 2, 2, 64, BF16, causal)  # the long backward's


# ragged lengths around the wgmma route's tiles (64 and 128 rows or keys)
# and the training launch's 4,096
TILE_LENGTHS = (1, 63, 64, 127, 128, 129, 1000, 4096)


def _tiles_holding_a_pair(t, s, causal, row_tile, key_tile, window=None):
    """(row tiles, key tiles) bool: the tile pair holds a visible (row, key)
    pair, from the pairs themselves: key j < S visible to row i < T, with
    j <= i when causal and i - j < window under a window."""
    n_r, n_k = -(-t // row_tile), -(-s // key_tile)
    vis = np.zeros((n_r * row_tile, n_k * key_tile), dtype=bool)
    vis[:t, :s] = True
    j, i = np.arange(n_k * key_tile)[None, :], np.arange(n_r * row_tile)[:, None]
    if causal:
        vis &= j <= i
    if window is not None:
        vis &= i - j < window
    return vis.reshape(n_r, row_tile, n_k, key_tile).any(axis=(1, 3))


def _visited(ranges, n):
    """(len(ranges), n) bool from (first, end) ranges over n tiles."""
    return np.array([(np.arange(n) >= a) & (np.arange(n) < b) for a, b in ranges]).reshape(len(ranges), n)


# windows below the tiles, across them and past T (None: no window)
TILE_WINDOWS = (None, 1, 100, 129, 5000)


@pytest.mark.parametrize("t", TILE_LENGTHS)
@pytest.mark.parametrize("s", TILE_LENGTHS)
def test_bwd_tiles_cover_exactly_the_visible_pairs(t, s):
    """``bwd_tiles``: each dK/dV block (128 keys) visits exactly the 64-row
    query tiles that hold a visible pair with its keys, and each dQ block
    (128 rows) exactly the 128-key tiles that hold one with its rows, so
    every visible pair is summed and no tile without one is loaded; T > S,
    T < S and T = S, causal and full, and causal under windows."""
    cases = [(True, None), (False, None)] + [(True, w) for w in TILE_WINDOWS[1:] if t <= s + w - 1]
    for causal, window in cases:
        q_ranges, k_ranges = fa_ops.bwd_tiles(t, s, causal, window)
        dkv = _tiles_holding_a_pair(t, s, causal, fa_ops.BWD_ROW_STAGE, fa_ops.BWD_KEY_TILE, window)
        assert len(q_ranges) == dkv.shape[1]
        assert (_visited(q_ranges, dkv.shape[0]) == dkv.T).all(), (t, s, causal, window)
        dq = _tiles_holding_a_pair(t, s, causal, fa_ops.BWD_ROW_TILE, fa_ops.BWD_KEY_STAGE, window)
        assert len(k_ranges) == dq.shape[0]
        assert (_visited(k_ranges, dq.shape[1]) == dq).all(), (t, s, causal, window)


@pytest.mark.parametrize("t", TILE_LENGTHS)
@pytest.mark.parametrize("s", TILE_LENGTHS)
def test_fwd_tiles_cover_exactly_the_visible_pairs(t, s):
    """``fwd_tiles``: each 128-row block of the wgmma forward visits
    exactly the 128-key tiles that hold a visible pair with its rows, with
    and without a window; at zamba2's and mixtral's prefill (T = S =
    32,768, window 4,096) a block visits at most 33 of 256 tiles."""
    for causal, window in [(True, None), (False, None)] + [(True, w) for w in TILE_WINDOWS[1:] if t <= s + w - 1]:
        ranges = fa_ops.fwd_tiles(t, s, causal, window)
        want = _tiles_holding_a_pair(t, s, causal, fa_ops.FWD_ROW_TILE, fa_ops.FWD_KEY_TILE, window)
        assert (_visited(ranges, want.shape[1]) == want).all(), (t, s, causal, window)
    long = fa_ops.fwd_tiles(32768, 32768, True, 4096)
    assert max(b - a for a, b in long) == 33 and long[-1] == (223, 256)


# (B, T, S, H, K, hd, window): windows below T, at T and above T, on the
# short and long shapes, GQA, T > S where every row still sees a key
WINDOW_SHAPES = [
    (2, 17, 17, 8, 2, 16, 5),
    (1, 70, 70, 4, 1, 16, 70),
    (1, 100, 60, 2, 2, 32, 200),
    (1, 130, 130, 2, 1, 64, 33),
]


def _numpy_attention(q, k, v, window):
    """An independent float64 softmax attention under the causal mask and
    the window: o (B, T, H, hd) and the logsumexp (B, H, T)."""
    b, t, h, hd = q.shape
    s, g = k.shape[1], h // k.shape[2]
    kk, vv = np.repeat(k, g, axis=2).astype(np.float64), np.repeat(v, g, axis=2).astype(np.float64)
    sc = np.einsum("bthd,bshd->bhts", q.astype(np.float64), kk) / np.sqrt(hd)
    j, i = np.arange(s)[None, :], np.arange(t)[:, None]
    sc = np.where((j <= i) & (i - j < window), sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    w = np.exp(sc - m)
    lse = (m + np.log(w.sum(-1, keepdims=True)))[..., 0]
    return np.einsum("bhts,bshd->bthd", w / w.sum(-1, keepdims=True), vv), lse


@pytest.mark.parametrize("b,t,s,h,kvh,hd,window", WINDOW_SHAPES)
def test_window_plain_equals_numpy_and_jax(b, t, s, h, kvh, hd, window):
    """The windowed plain forward (and its logsumexp) against an
    independent numpy softmax and the reference's ``_sdpa`` under its
    windowed mask; the windowed plain backward and ``FlashAttentionFn``
    against ``jax.vjp`` of that attention, within the backward's 1e-5."""
    q, k, v, do = _bwd_inputs(b, t, s, h, kvh, hd, seed=b + t + s + hd + window)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, window=window, return_lse=True)
    want, want_lse = _numpy_attention(q, k, v, window)
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)
    j, i = np.arange(s)[None, :], np.arange(t)[:, None]
    mask = jnp.asarray((j <= i) & (i - j < window))
    ref = jax_sdpa(jnp.asarray(q).reshape(b, t, kvh, h // kvh, hd), jnp.asarray(k), jnp.asarray(v), mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(b, t, h, hd), rtol=2e-5, atol=2e-5)
    grads = fa_ops.flash_attention_bwd(tq, tk, tv, out, torch.from_numpy(do), lse, window=window)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    fa_ops.FlashAttentionFn.apply(*leaves, True, window).backward(torch.from_numpy(do))
    for name, got, leaf, r in zip("qkv", grads, leaves, _jax_grads(q, k, v, do, True, window)):
        np.testing.assert_allclose(got.numpy(), r, rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("b,t,s,h,kvh,causal", [(1, 20, 20, 4, 2, True), (2, 40, 40, 2, 2, False),
                                                 (1, 70, 50, 2, 1, True)])
def test_hd80_plain_equals_jax(b, t, s, h, kvh, causal):
    """Head size 80 (zamba2-2.7b's) on the plain versions: the forward
    against the JAX oracle (scale 1/sqrt(80)), the backward against torch
    autograd of the plain forward, within 1e-5."""
    q, k, v, do = _bwd_inputs(b, t, s, h, kvh, 80, seed=t + s)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal=causal, block_k=s, return_lse=True)
    np.testing.assert_allclose(out.detach().numpy(), _jax(q, k, v, causal, jnp.float32), rtol=2e-5, atol=2e-5)
    out.backward(torch.from_numpy(do))
    grads = fa_ops.flash_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v)), out.detach(),
                                       torch.from_numpy(do), lse.detach(), causal=causal)
    for name, got, leaf in zip("qkv", grads, (tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_window_refusals():
    """A window comes only with the causal mask, must be a positive int,
    and every row must see a key (T <= S + window - 1); the forward and
    the backward refuse the rest on either device."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 40, 40, 4, 2, 16, 1))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=False, window=8)
    for bad in (0, -3, 2.5, True):
        with pytest.raises(ValueError, match="positive int"):
            flash_attention(q, k, v, window=bad)
    with pytest.raises(ValueError, match="see no key"):
        flash_attention(q, k[:, :10], v[:, :10], window=30)  # row 39 sees keys 10.. of 10
    flash_attention(q, k[:, :10], v[:, :10], window=31)  # row 39 sees key 9
    with pytest.raises(ValueError, match="see no key"):
        fa_ops.flash_attention_bwd(q, k[:, :10], v[:, :10], q, q, torch.zeros(1, 4, 40), window=30)
