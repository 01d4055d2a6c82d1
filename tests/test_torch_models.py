"""The port's LM scaffold (``repro_torch.models``) against the JAX package's
``repro.models`` on the CPU, at the registry's smoke sizes in float32.

Weights come from the reference's ``init_params`` (its 1-D leaves —
norm scales, biases, ``A_log``, ``D``, ``dt_bias`` — moved off their
constant inits with numpy noise so that they matter) and are carried
across with ``repro_torch.convert``; inputs are drawn with numpy.  The
JAX side is jitted once per configuration.  Tolerances: logits, aux and
decode caches within 1e-4 (the frameworks round sums, ``exp``, ``rsqrt``
and the trigonometry of RoPE a few ulps apart, and that compounds over
the blocks), ``loss_fn`` within 1e-5 relative, the MoE layer within 1e-5
with its kept slots exact.  Then the reference's own checks
(``tests/test_models.py``) on the port: decode == forward, the ring
buffer past the window, chunked == direct attention, MoE sparsity, the
published configs, and parameter specs without allocation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs.registry import ARCHS, ASSIGNED, get_config, smoke_config
from repro_torch.convert import lm_cache_from_reference, lm_params_from_reference, lm_params_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import LM, build_model, cache_specs, init_params, param_specs
from repro_torch.models import layers as L
from repro_torch.models import model as M

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_ARCHS = ["qwen2-1.5b", "mixtral-8x7b", "zamba2-2.7b", "xlstm-125m", "chameleon-34b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, moe_capacity=None, moe=None, **kw):
    """The reference's and the port's float32 smoke configs of ``name``,
    with ``kw`` and the MoE fields in ``moe`` replaced."""
    moe = dict(moe or {}, **({} if moe_capacity is None else {"capacity_factor": moe_capacity}))
    out = []
    for smoke in (jax_smoke_config, smoke_config):
        cfg = dataclasses.replace(smoke(name), dtype="float32", **kw)
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        out.append(cfg)
    return out


def _noisy(tree, seed):
    """The reference's weights as numpy, the leaves of a constant init
    (norm scales, biases, ``A_log``, ``D``, ``dt_bias``) given noise."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = []
    for a in leaves:
        a = np.asarray(a, dtype=np.float32)
        if np.all(a == a.flat[0]):
            a = a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out)


def _weights(cfg_j, cfg, seed=0):
    pj = _noisy(JM.init_params(cfg_j, jax.random.key(seed)), seed)
    return jax.tree_util.tree_map(jnp.asarray, pj), lm_params_from_reference(pj, cfg, device="cpu")


def _batch(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    if cfg.precomputed_embeddings:
        return {"embeds": rng.normal(size=(b, t, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (b, t, cfg.n_codebooks)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_REFERENCE = {}


def _reference(name):
    """The reference's forward and loss at (2, 16) for ``name``, once."""
    if name not in _REFERENCE:
        cfg_j, cfg = _cfgs(name)
        pj, p = _weights(cfg_j, cfg)
        batch = _batch(cfg, 2, 16, 0)
        bj = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, aux = jax.jit(lambda p_, b_: JM.forward(p_, b_, cfg_j))(pj, bj)
        loss = jax.jit(lambda p_, b_: JM.loss_fn(p_, b_, cfg_j))(pj, bj)
        _REFERENCE[name] = (cfg, p, batch, np.asarray(logits), float(aux), float(loss))
    return _REFERENCE[name]


@pytest.mark.parametrize("backend", L.BACKENDS)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_and_loss_match_reference(name, backend):
    cfg, p, batch, logits_j, aux_j, loss_j = _reference(name)
    before = fa_ops.launches
    with torch.no_grad():
        logits, aux = M.forward(p, _torch(batch), cfg, attn_backend=backend)
        loss = M.loss_fn(p, _torch(batch), cfg, attn_backend=backend)
    assert fa_ops.launches == before  # the CPU takes the plain version
    assert logits.shape == logits_j.shape and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), logits_j, **TOL)
    np.testing.assert_allclose(float(aux), aux_j, **TOL)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)


@pytest.mark.parametrize("name", DECODE_ARCHS + ["moonshot-v1-16b-a3b"])
def test_decode_steps_match_reference(name):
    """Every decode step's logits and every cache tensor after it."""
    cfg_j, cfg = _cfgs(name)
    pj, p = _weights(cfg_j, cfg, seed=1)
    b, t = 2, 10
    toks = _batch(cfg, b, t, 1)["tokens"]
    cache_j = JM.cache_init(cfg_j, b, t)
    cache = lm_cache_from_reference(cache_j, device="cpu")
    assert jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), dict(cache_j)) == M.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), cache)
    step_j = jax.jit(lambda p_, c_, x_: JM.decode_step(p_, c_, {"tokens": x_}, cfg_j))
    for i in range(t):
        logits_j, cache_j = step_j(pj, cache_j, jnp.asarray(toks[:, i : i + 1]))
        with torch.no_grad():
            logits, same = M.decode_step(p, cache, {"tokens": torch.from_numpy(toks[:, i : i + 1])}, cfg)
        assert same is cache  # updated in place
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
        want = jax.tree_util.tree_leaves(dict(cache_j))
        got = jax.tree_util.tree_leaves(M.tree_map(lambda a: a.numpy(), cache))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("backend", L.BACKENDS)
@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_matches_forward(name, backend):
    """Token-by-token decode logits == full-sequence forward logits
    (``tests/test_models.py::test_decode_matches_forward`` on the port)."""
    _, cfg = _cfgs(name, moe_capacity=16.0 if "mixtral" in name else None)
    p = init_params(cfg, 0, device="cpu")
    b, t = 2, 12
    toks = torch.from_numpy(_batch(cfg, b, t, 1)["tokens"])
    with torch.no_grad():
        full, _ = M.forward(p, {"tokens": toks}, cfg, attn_backend=backend)
        cache = M.cache_init(cfg, b, t, device="cpu")
        dec = [M.decode_step(p, cache, {"tokens": toks[:, i : i + 1]}, cfg)[0][:, 0] for i in range(t)]
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_sliding_window_decode_ring_buffer():
    """Decoding past the window with a ring cache equals a full forward
    with the window mask; the kernel backend's windowed forward equals the
    torch backend's and the reference's."""
    cfg_j, cfg = _cfgs("mixtral-8x7b", moe_capacity=16.0, attn_window=8)
    pj, p = _weights(cfg_j, cfg, seed=2)
    b, t = 1, 20  # t > window
    toks = torch.from_numpy(_batch(cfg, b, t, 2)["tokens"])
    with torch.no_grad():
        full, _ = M.forward(p, {"tokens": toks}, cfg, attn_backend="torch")
        kernel, _ = M.forward(p, {"tokens": toks}, cfg)
        cache = M.cache_init(cfg, b, cfg.attn_window, device="cpu")  # ring capacity = window
        dec = [M.decode_step(p, cache, {"tokens": toks[:, i : i + 1]}, cfg)[0][:, 0] for i in range(t)]
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full.numpy(), rtol=2e-3, atol=2e-3)
    want, _ = JM.forward(pj, {"tokens": jnp.asarray(toks.numpy())}, cfg_j)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(kernel.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(kernel.numpy(), full.numpy(), **TOL)


def test_window_within_the_sequence_runs_the_kernel():
    """Where T <= attn_window the window masks nothing, and where T > it
    the kernel takes the window: at both the kernel backend equals the
    torch backend and the reference."""
    name = "zamba2-2.7b"  # a window of 32 in its smoke config
    cfg, p, batch, logits_j, _, _ = _reference(name)
    assert cfg.attn_window == 32
    with torch.no_grad():
        got, _ = M.forward(p, _torch(batch), cfg, attn_backend="kernel")
    np.testing.assert_allclose(got.numpy(), logits_j, **TOL)
    cfg_j, _ = _cfgs(name)
    pj, _ = _weights(cfg_j, cfg)
    longer = _batch(cfg, 1, 64, 5)  # T = 64 > 32
    want, _ = jax.jit(lambda p_, b_: JM.forward(p_, b_, cfg_j))(pj, {k: jnp.asarray(v) for k, v in longer.items()})
    with torch.no_grad():
        got, _ = M.forward(p, _torch(longer), cfg, attn_backend="kernel")
        got_t, _ = M.forward(p, _torch(longer), cfg, attn_backend="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), got_t.numpy(), **TOL)


def test_head_size_80_matches_reference():
    """zamba2's full-width head size (2,560 / 32 = 80) at smoke depth: a
    variant of its smoke config with d_model 160 over 2 heads of 80, at
    T = 64 past its window of 32; the kernel backend's forward and loss
    equal the reference's."""
    cfg_j, cfg = _cfgs("zamba2-2.7b", d_model=160, n_heads=2, n_kv_heads=2, d_head=None)
    assert cfg.head_dim == 80 and cfg.attn_window == 32
    pj, p = _weights(cfg_j, cfg, seed=4)
    batch = _batch(cfg, 2, 64, 4)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    logits_j, _ = jax.jit(lambda p_, b_: JM.forward(p_, b_, cfg_j))(pj, bj)
    loss_j = jax.jit(lambda p_, b_: JM.loss_fn(p_, b_, cfg_j))(pj, bj)
    with torch.no_grad():
        logits, _ = M.forward(p, _torch(batch), cfg)
        loss = M.loss_fn(p, _torch(batch), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)


# The published configs' features that the smoke configs drop (d_model 64, 4
# heads of 16, at most 2 kv heads, 4 experts of top-2), put back at small
# width over one unit: (smoke config overrides, MoE overrides, (B, T))
FULL_WIDTH = {
    # hd 64 over 4 codebook heads, the frames' embeddings as input
    "musicgen-medium": (dict(d_model=128, n_heads=2, n_kv_heads=2, d_head=None), None, (2, 16)),
    # a GQA group of 7 (56 / 8 at full width)
    "deepseek-coder-33b": (dict(d_model=112, n_heads=7, n_kv_heads=1, d_head=16), None, (2, 16)),
    # a group of 8 with qk_norm ahead of the attention
    "chameleon-34b": (dict(d_model=128, n_heads=8, n_kv_heads=1, d_head=16), None, (2, 16)),
    # d_head set apart from d_model / n_heads: q width 128 against d_model 64
    "mistral-nemo-12b": (dict(d_model=64, n_heads=4, n_kv_heads=1, d_head=32), None, (2, 16)),
    # a group of 4
    "granite-8b": (dict(d_model=128, n_heads=8, n_kv_heads=2, d_head=16), None, (2, 16)),
    # 64 experts, top-6, at the default capacity 1.25, where tokens drop
    "moonshot-v1-16b-a3b": ({}, dict(n_experts=64, top_k=6, d_expert_ff=16), (2, 64)),
    # head size 192 in the mLSTM's chunk math and the sLSTM's step
    "xlstm-125m": (dict(d_model=768, n_heads=4, n_kv_heads=4, d_head=None), None, (2, 128)),
}
_FULL_WIDTH = {}


def _full_width(name):
    """The reference's forward and loss on ``name``'s full-width case, once."""
    if name not in _FULL_WIDTH:
        kw, moe, (b, t) = FULL_WIDTH[name]
        cfg_j, cfg = _cfgs(name, moe=moe, **kw)
        pj, p = _weights(cfg_j, cfg, seed=7)
        batch = _batch(cfg, b, t, 7)
        bj = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, aux = jax.jit(lambda p_, b_: JM.forward(p_, b_, cfg_j))(pj, bj)
        loss = jax.jit(lambda p_, b_: JM.loss_fn(p_, b_, cfg_j))(pj, bj)
        _FULL_WIDTH[name] = (cfg_j, cfg, pj, p, batch, np.asarray(logits), float(aux), float(loss))
    return _FULL_WIDTH[name]


def _inputs(cfg, batch, i):
    """Step ``i``'s decode input: a token, or the audio stub's frame."""
    key = "embeds" if cfg.precomputed_embeddings else "tokens"
    return {key: batch[key][:, i : i + 1]}


@pytest.mark.parametrize("backend", L.BACKENDS)
@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_forward_and_loss_match_reference(name, backend):
    """``JM.forward`` and ``JM.loss_fn`` at the case's full-width features:
    logits, aux and loss within TOL on either backend; musicgen's logits
    are (B, T, 4, V); moonshot's tokens drop at capacity 1.25 (its logits
    differ from those at capacity 16)."""
    cfg_j, cfg, _, p, batch, logits_j, aux_j, loss_j = _full_width(name)
    assert cfg.head_dim == cfg_j.head_dim and (cfg.n_heads, cfg.n_kv_heads) == (cfg_j.n_heads, cfg_j.n_kv_heads)
    with torch.no_grad():
        logits, aux = M.forward(p, _torch(batch), cfg, attn_backend=backend)
        loss = M.loss_fn(p, _torch(batch), cfg, attn_backend=backend)
    b, t = next(iter(batch.values())).shape[:2]
    want_shape = (b, t, cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks else (b, t, cfg.vocab)
    assert logits.shape == logits_j.shape == want_shape
    np.testing.assert_allclose(logits.numpy(), logits_j, **TOL)
    np.testing.assert_allclose(float(aux), aux_j, **TOL)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    if cfg.moe is not None:
        roomy = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
        with torch.no_grad():
            undropped, _ = M.forward(p, _torch(batch), roomy, attn_backend=backend)
        assert not torch.allclose(logits, undropped, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_decode_steps_match_reference(name):
    """``JM.decode_step`` at the case's full-width features: every step's
    logits and every cache tensor after it, within TOL, over 10 steps."""
    cfg_j, cfg, pj, p, _, _, _, _ = _full_width(name)
    b, t = 2, 10
    batch = _batch(cfg, b, t, 8)
    cache_j = JM.cache_init(cfg_j, b, t)
    cache = lm_cache_from_reference(cache_j, device="cpu")
    step_j = jax.jit(lambda p_, c_, x_: JM.decode_step(p_, c_, x_, cfg_j))
    for i in range(t):
        x = _inputs(cfg, batch, i)
        logits_j, cache_j = step_j(pj, cache_j, {k: jnp.asarray(v) for k, v in x.items()})
        with torch.no_grad():
            logits, _ = M.decode_step(p, cache, _torch(x), cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
        want = jax.tree_util.tree_leaves(dict(cache_j))
        got = jax.tree_util.tree_leaves(M.tree_map(lambda a: a.numpy(), cache))
        assert len(want) == len(got)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_decode_matches_forward(name):
    """Token-by-token decode == the full-sequence forward on both backends
    (``tests/test_models.py::test_decode_matches_forward`` at the case's
    full-width features), within 2e-3 over 2 x 12 steps; MoE at capacity
    16, where nothing drops."""
    _, cfg, _, p, _, _, _, _ = _full_width(name)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    b, t = 2, 12
    x = _torch(_batch(cfg, b, t, 9))
    x.pop("labels")
    with torch.no_grad():
        cache = M.cache_init(cfg, b, t, device="cpu")
        dec = torch.stack([M.decode_step(p, cache, _inputs(cfg, x, i), cfg)[0][:, 0] for i in range(t)], 1)
        for backend in L.BACKENDS:
            full, _ = M.forward(p, x, cfg, attn_backend=backend)
            np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("backend", L.BACKENDS)
def test_chunked_attention_matches_direct(backend, monkeypatch):
    """T > Q_CHUNK path == direct path, and both == the reference's chunked
    path (the kernel backend takes no chunks)."""
    cfg_j, cfg = _cfgs("qwen2-1.5b")
    pj, p = _weights(cfg_j, cfg, seed=3)
    toks = _batch(cfg, 1, 32, 3)["tokens"]
    with torch.no_grad():
        direct, _ = M.forward(p, {"tokens": torch.from_numpy(toks)}, cfg, attn_backend=backend)
        monkeypatch.setattr(L, "Q_CHUNK", 8)
        chunked, _ = M.forward(p, {"tokens": torch.from_numpy(toks)}, cfg, attn_backend=backend)
        with pytest.raises(AssertionError, match="chunk"):
            M.forward(p, {"tokens": torch.from_numpy(toks[:, :30])}, cfg, attn_backend="torch")
    np.testing.assert_allclose(chunked.numpy(), direct.numpy(), rtol=2e-3, atol=2e-3)
    monkeypatch.setattr(JL, "Q_CHUNK", 8)
    want, _ = JM.forward(pj, {"tokens": jnp.asarray(toks)}, cfg_j)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **TOL)


def _numpy_slots(idx, n_experts, cap):
    """The reference's dispatch (``layers.py:411-428``) in numpy on its
    top-k ids: a stable sort by expert, each pair's place in its run, the
    slot, E * cap where the capacity is spent; (token, choice) order."""
    t, k = idx.shape
    fe = idx.reshape(-1)
    order = np.argsort(fe, kind="stable")
    se = fe[order]
    starts = np.searchsorted(se, np.arange(n_experts), side="left")
    pos = np.arange(t * k) - starts[se]
    slot_sorted = np.where(pos < cap, se * cap + pos, n_experts * cap)
    slot = np.empty_like(slot_sorted)
    slot[order] = slot_sorted
    return slot


@pytest.mark.parametrize("name", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def test_moe_apply_matches_reference(name):
    """At the default capacity factor 1.25, where tokens drop: the outputs
    and aux within 1e-5, and the kept (token, choice) slots exactly."""
    cfg_j, cfg = _cfgs(name)
    assert cfg.moe.capacity_factor == 1.25
    pj = _noisy(JL.moe_init(jax.random.key(4), cfg_j), 4)
    p = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    # inputs leaning toward expert 0's router column, so that it overflows
    lean = pj["router"][:, 0] / np.linalg.norm(pj["router"][:, 0])
    x = (np.random.default_rng(4).normal(size=(48, cfg.d_model)) + 2.0 * lean).astype(np.float32)
    y_j, aux_j = JL.moe_apply({k: jnp.asarray(v) for k, v in pj.items()}, jnp.asarray(x), cfg_j)
    y, aux = L.moe_apply(p, torch.from_numpy(x), cfg)
    # within 1e-5 of the output's scale (the experts' (E, d, f) weights are
    # drawn at 1 / sqrt(E), so outputs reach about 100)
    assert np.abs(y.numpy() - np.asarray(y_j)).max() <= 1e-5 * np.abs(np.asarray(y_j)).max()
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5, atol=1e-6)
    # the routing: the reference's top-k ids, then its dispatch in numpy
    probs_j = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(pj["router"]), axis=-1)
    _, idx_j = jax.lax.top_k(probs_j, cfg.moe.top_k)
    _, idx, cap, st, _, keep, slot = L._moe_route(p, torch.from_numpy(x), cfg)
    assert cap == int(np.ceil(48 * cfg.moe.top_k / cfg.moe.n_experts * 1.25))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    want = _numpy_slots(np.asarray(idx_j), cfg.moe.n_experts, cap)
    got = np.empty(48 * cfg.moe.top_k, dtype=np.int64)
    sorted_pairs = torch.argsort(idx.reshape(-1), stable=True).numpy()  # the port's slots are in this order
    got[sorted_pairs] = slot.numpy()
    dropped = want == cfg.moe.n_experts * cap
    assert dropped.any() and not dropped.all()  # the default capacity drops tokens
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(keep.numpy(), ~dropped[sorted_pairs])


def test_moe_combine_adds_each_token_in_sorted_order():
    """``_moe_combine`` adds each token's kept choices to zero in the sorted
    pairs' order, as a sequential ``segment_sum`` (the reference's, at
    ``src/repro/models/layers.py:458``) adds them: bit for bit against a
    numpy loop over the pairs, at 64 experts, top-6, where tokens drop."""
    _, cfg = _cfgs("moonshot-v1-16b-a3b", moe=dict(n_experts=64, top_k=6, d_expert_ff=16))
    p = L.moe_init(torch.Generator().manual_seed(5), cfg)
    t, d, e = 64, cfg.d_model, cfg.moe.n_experts
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(t, d)).astype(np.float32))
    _, _, cap, st, sg, keep, slot = L._moe_route(p, x, cfg)
    assert not keep.all()
    ybuf = torch.from_numpy(np.random.default_rng(6).normal(size=(e * cap, d)).astype(np.float32))
    contrib = torch.where(keep[:, None], ybuf[torch.clamp(slot, max=e * cap - 1)] * sg[:, None], 0.0).numpy()
    want = np.zeros((t, d), dtype=np.float32)
    for i, tok in enumerate(st.numpy()):
        want[tok] += contrib[i]
    np.testing.assert_array_equal(L._moe_combine(ybuf, st, sg, keep, slot, t).numpy(), want)


def test_moe_routing_is_sparse():
    """Zeroing one expert's output weights only changes tokens routed to it."""
    _, cfg = _cfgs("mixtral-8x7b")
    p = L.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(32, cfg.d_model)).astype(np.float32))
    y0, aux = L.moe_apply(p, x, cfg)
    assert np.isfinite(float(aux))
    p2 = dict(p, w2=p["w2"].clone())
    p2["w2"][0] = 0.0
    y1, _ = L.moe_apply(p2, x, cfg)
    changed = (y0 != y1).any(dim=1)
    assert changed.any() and not changed.all()
    # exactly the tokens with a kept slot in expert 0
    _, _, cap, st, _, keep, slot = L._moe_route(p, x, cfg)
    routed = set(st[keep & (slot // cap == 0)].tolist())
    assert set(changed.nonzero()[:, 0].tolist()) == routed


def test_all_assigned_configs_exact():
    """The port's registry carries the exact published configurations."""
    c = get_config("mixtral-8x7b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads) == (32, 4096, 32, 8)
    assert c.moe.n_experts == 8 and c.moe.top_k == 2
    c = get_config("deepseek-coder-33b")
    assert (c.n_layers, c.d_model, c.n_heads, c.d_ff, c.vocab) == (62, 7168, 56, 19200, 32256)
    c = get_config("zamba2-2.7b")
    assert c.ssm_state == 64 and c.n_layers == 54 and "shared_attn" in c.unit
    c = get_config("moonshot-v1-16b-a3b")
    assert c.moe.n_experts == 64 and c.moe.top_k == 6 and c.vocab == 163840
    c = get_config("xlstm-125m")
    assert set(c.unit) == {"mlstm", "slstm"} and c.d_ff == 0
    c = get_config("qwen2-1.5b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.d_ff, c.vocab) == (
        28, 1536, 12, 2, 128, 8960, 151936)
    assert c.qkv_bias and c.tie_embeddings and c.rope_theta == 1e6 and c.dtype == "bfloat16"
    assert len(ASSIGNED) == 10
    assert {n: dataclasses.asdict(c) for n, c in ARCHS.items()} == {
        n: dataclasses.asdict(c) for n, c in JARCHS.items()}


def test_param_specs_no_allocation():
    cfg = get_config("deepseek-coder-33b")  # 33B params — must not allocate
    specs = param_specs(cfg)
    leaves = M.tree_leaves(specs)
    assert all(a.device.type == "meta" for a in leaves)
    n = sum(a.numel() for a in leaves)
    assert 30e9 < n < 40e9, n
    jspecs = JM.param_specs(jax_get_config("deepseek-coder-33b"))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jspecs)) == M.n_params(cfg)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_specs_equal_reference_at_full_width(name):
    """Parameter, cache and batch specs of every published config: the
    reference's tree, shapes and dtypes, on ``meta``."""
    cfg_j, cfg = jax_get_config(name), get_config(name)
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert M.tree_map(lambda a: tuple(a.shape), param_specs(cfg)) == shapes(JM.param_specs(cfg_j))
    cache = cache_specs(cfg, 2, 64)
    assert all(a.device.type == "meta" for a in M.tree_leaves(cache))
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), dict(JM.cache_specs(cfg_j, 2, 64)))
    assert M.tree_map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), cache) == want
    for kind in ("train", "decode"):
        got = M.batch_specs(cfg, 64, 2, kind)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in JM.batch_specs(cfg_j, 64, 2, kind).items()}


def test_out_of_range_ids_clip_as_the_reference():
    """A negative token id counts from the end of the table and ids clamp
    into it; a label outside [0, V) has gold logit 0."""
    cfg, p, batch, _, _, _ = _reference("qwen2-1.5b")
    cfg_j = _cfgs("qwen2-1.5b")[0]
    pj = jax.tree_util.tree_map(jnp.asarray, lm_params_numpy(p))
    toks = batch["tokens"].copy()
    toks[0, :4] = [-1, -cfg.vocab - 3, cfg.vocab, cfg.vocab + 7]
    labels = batch["labels"].copy()
    labels[1, :3] = [-2, cfg.vocab, cfg.vocab + 100]
    bj = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want_logits, _ = JM.forward(pj, bj, cfg_j)
    want_loss = JM.loss_fn(pj, bj, cfg_j)
    with torch.no_grad():
        logits, _ = M.forward(p, _torch({"tokens": toks}), cfg)
        loss = M.loss_fn(p, _torch({"tokens": toks, "labels": labels}), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


def test_unchunked_loss_equals_chunked(monkeypatch):
    """``REPRO_OPTS=no_chunked_ce`` takes the whole-logits loss: the same
    value, as in the reference."""
    cfg, p, batch, _, _, loss_j = _reference("mixtral-8x7b")
    monkeypatch.setenv("REPRO_OPTS", "no_chunked_ce")
    with torch.no_grad():
        loss = M.loss_fn(p, _torch(batch), cfg)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)


@pytest.mark.parametrize("backend", L.BACKENDS)
@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-2.7b", "xlstm-125m", "mixtral-8x7b"])
def test_loss_gradient_with_remat(name, backend):
    """``loss_fn`` under autograd with ``remat`` (each unit and each CE
    chunk recomputed in the backward): finite and nonzero gradients, the
    same as without remat (``tests/test_models.py::test_smoke_forward_loss_grad``)."""
    cfg, p, batch, _, _, loss_j = _reference(name)
    grads = []
    for remat in (True, False):
        leaves = [a.clone().requires_grad_() for a in M.tree_leaves(p)]
        it = iter(leaves)
        tree = M.tree_map(lambda _: next(it), p)
        loss = M.loss_fn(tree, _torch(batch), cfg, remat=remat, attn_backend=backend)
        np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-5)
        # the mixers' "norm" scales are unused, as in the reference (zero gradient there)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads.append([torch.zeros_like(a) if g is None else g for a, g in zip(leaves, got)])
    gsum = sum(float(g.abs().sum()) for g in grads[0])
    assert np.isfinite(gsum) and gsum > 0
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "chameleon-34b", "moonshot-v1-16b-a3b"])
def test_kernel_backend_gradient_at_a_long_sequence(name):
    """At T = 64 (past the short path) ``FlashAttentionFn`` runs the long
    backward's plain version on the CPU: ``loss_fn``'s gradient on the
    kernel backend equals the torch backend's within 1e-5 of each leaf's
    largest |g| (plus 1e-7)."""
    cfg_j, cfg = _cfgs(name)
    _, p = _weights(cfg_j, cfg, seed=3)
    batch = _torch(_batch(cfg, 2, 64, 5))
    assert fa_ops.plan(2, 64, 64, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, torch.float32, True) != "short"
    grads = []
    for backend in L.BACKENDS:
        leaves = [a.clone().requires_grad_() for a in M.tree_leaves(p)]
        it = iter(leaves)
        loss = M.loss_fn(M.tree_map(lambda _: next(it), p), batch, cfg, attn_backend=backend)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads.append([torch.zeros_like(a) if g is None else g for a, g in zip(leaves, got)])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-7


def test_lm_module_and_entry_points():
    """``LM`` holds the tree as parameters and runs the functional core;
    ``build_model`` is ``LM``; the entry points default to the card."""
    cfg, p, batch, logits_j, aux_j, loss_j = _reference("chameleon-34b")
    lm = build_model(cfg, params=p, device="cpu", attn_backend="torch")
    assert isinstance(lm, LM) and isinstance(lm, torch.nn.Module)
    assert sum(x.numel() for x in lm.parameters()) == M.n_params(cfg)
    assert M.tree_map(lambda a: a.data_ptr(), lm.tree()) == M.tree_map(lambda a: a.data_ptr(), p)
    with torch.no_grad():
        logits, _ = lm(_torch(batch))
        np.testing.assert_allclose(logits.numpy(), logits_j, **TOL)
        np.testing.assert_allclose(float(lm.loss(_torch(batch))), loss_j, rtol=1e-5)
        cache = lm.cache(2, 16)
        step, _ = lm.decode(cache, {"tokens": torch.from_numpy(batch["tokens"][:, :1])})
    np.testing.assert_allclose(step[:, 0].numpy(), logits_j[:, 0], rtol=2e-3, atol=2e-3)
    drawn = LM(cfg, seed=5, device="cpu")
    again = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    for a, b in zip(M.tree_leaves(drawn.tree()), M.tree_leaves(again)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="backend"):
        LM(cfg, params=p, device="cpu", attn_backend="xla")
    if not torch.cuda.is_available():
        for fn in (lambda: LM(cfg, params=p), lambda: init_params(cfg, 0), lambda: M.cache_init(cfg, 1, 4)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn()


def test_bf16_cache_and_weights_convert():
    """A bf16 config's reference cache comes across bit for bit in bf16
    (numpy's ``ml_dtypes`` bfloat16), its float32 weights as float32, and
    the weights go back to numpy unchanged."""
    cfg_j, cfg = jax_smoke_config("qwen2-1.5b"), smoke_config("qwen2-1.5b")
    assert cfg.dtype == "bfloat16"
    pj = JM.init_params(cfg_j, jax.random.key(6))
    cache_j = JM.cache_init(cfg_j, 2, 8)
    cache_j = jax.tree_util.tree_map(lambda a: a + jnp.asarray(1.5, a.dtype) if a.dtype == jnp.bfloat16 else a, cache_j)
    cache = lm_cache_from_reference(cache_j, device="cpu")
    assert cache["b0"]["k"].dtype == torch.bfloat16 and cache["b0"]["pos"].dtype == torch.int32
    assert bool((cache["b0"]["k"] == 1.5).all())
    p = lm_params_from_reference(pj, cfg, device="cpu")
    assert all(a.dtype == torch.float32 for a in M.tree_leaves(p))
    back = lm_params_numpy(p)
    for a, b in zip(jax.tree_util.tree_leaves(pj), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_reference({"embed": np.zeros((1, 1))}, cfg, device="cpu")
