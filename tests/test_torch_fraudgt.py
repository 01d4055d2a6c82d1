"""The port's FraudGT (``repro_torch.ml.fraudgt``) against the JAX
package's ``repro.ml.fraudgt`` on the CPU: tokens bit-identical to the
reference's ``tokenize`` (on tie-heavy random graphs and on a small
HI-Small, its largest hub included), and logits within 1e-4 of the
reference model's with its weights carried across by
``fraudgt_from_reference``, under both attention backends."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synth_aml import generate_aml_dataset
from repro.ml.fraudgt import FraudGT as JaxFraudGT
from repro.ml.fraudgt import FraudGTParams as JaxParams
from repro_torch.convert import fraudgt_from_reference, graph_from_reference
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.ml import FraudGT, FraudGTParams
from repro_torch.ml import fraudgt as port_fraudgt
from tests.conftest import random_temporal_graph


def _same_tokens(g, eids, ctx=17):
    want = JaxFraudGT(JaxParams(ctx=ctx)).tokenize(g, eids)
    got = FraudGT(FraudGTParams(ctx=ctx), device="cpu").tokenize(graph_from_reference(g), eids)
    for w, x in zip(want, got):
        assert x.dtype == np.int32 and x.shape == (len(eids), ctx)
        np.testing.assert_array_equal(x, w)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ctx", [17, 16, 5])
def test_tokens_random_graph(seed, ctx):
    # t_max 4..512 over few nodes: most context entries tie on |Δt|
    rng = np.random.default_rng(seed)
    g = random_temporal_graph(rng, n_nodes=int(rng.integers(3, 30)), n_edges=int(rng.integers(20, 300)),
                              t_max=int(rng.choice([4, 64, 512])))
    _same_tokens(g, rng.permutation(g.n_edges), ctx)


def test_tokens_wide_timestamps():
    # timestamps near 2^50: the candidate sort keys no longer fit one
    # int64, so the tokenizer sorts them with a three-key lexsort
    rng = np.random.default_rng(11)
    g = random_temporal_graph(rng, n_nodes=20, n_edges=300, t_max=1 << 50)
    _same_tokens(g, np.arange(g.n_edges))


def test_tokens_candidate_groups(monkeypatch):
    # the candidates of a pass split into many groups give the same tokens
    monkeypatch.setattr(port_fraudgt, "CANDIDATE_CAP", 7)
    monkeypatch.setattr(port_fraudgt, "TOKENIZE_EDGES", 33)
    g = random_temporal_graph(np.random.default_rng(7), n_nodes=12, n_edges=240, t_max=16)
    _same_tokens(g, np.arange(g.n_edges))


@pytest.fixture(scope="module")
def hi_small():
    return generate_aml_dataset("HI-Small", seed=0, scale=0.5).graph


def test_tokens_hi_small_with_hub(hi_small):
    g = hi_small
    deg = np.diff(g.out_indptr) + np.diff(g.in_indptr)
    hub = int(np.argmax(deg))
    rng = np.random.default_rng(0)
    at_hub = np.nonzero((g.src == hub) | (g.dst == hub))[0]
    eids = np.concatenate([rng.choice(at_hub, 64, replace=False), rng.choice(g.n_edges, 192, replace=False)])
    _same_tokens(g, eids)


@pytest.mark.parametrize(
    "p", [JaxParams(d_model=32, n_layers=2, n_heads=2), JaxParams()], ids=["d32-l2", "default"]
)
def test_logits_match_reference(hi_small, p):
    g = hi_small
    eids = np.random.default_rng(1).choice(g.n_edges, 256, replace=False)
    ref = JaxFraudGT(p, seed=3)
    ref._init()
    am, dt, ro = ref.tokenize(g, eids)
    want = np.asarray(ref._logits(ref.params, jnp.asarray(am), jnp.asarray(dt), jnp.asarray(ro)))
    want_p = ref.predict_proba(g, eids)
    pg = graph_from_reference(g)
    port = fraudgt_from_reference(ref, device="cpu")
    np.testing.assert_array_equal(port.amount_edges, ref.amount_edges)
    torch_attn = FraudGT(port.p, device="cpu", attn_backend="torch").load_params(
        jax.tree_util.tree_map(np.asarray, ref.params))
    torch_attn.amount_edges = port.amount_edges
    for port in (port, torch_attn):
        before = fa_ops.launches
        got = port.logits(am, dt, ro)
        assert fa_ops.launches == before
        assert got.dtype == torch.float32 and got.shape == (len(eids),)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        proba = port.predict_proba(pg, eids)
        np.testing.assert_allclose(proba, want_p, rtol=1e-4, atol=1e-4)
        assert set(port.seconds) == {"tokenize", "forward"}


def test_seeded_init_and_fit_raises(hi_small):
    g = graph_from_reference(hi_small)
    eids = np.arange(40)
    a = FraudGT(FraudGTParams(d_model=32, n_layers=1, n_heads=2), seed=5, device="cpu")
    b = FraudGT(FraudGTParams(d_model=32, n_layers=1, n_heads=2), seed=5, device="cpu", attn_backend="torch")
    pa, pb = a.predict_proba(g, eids), b.predict_proba(g, eids)
    assert pa.shape == (40,) and np.all((pa > 0) & (pa < 1))
    np.testing.assert_allclose(pa, pb, rtol=1e-5, atol=1e-5)
    # the seeded init has the reference's shapes
    ref = JaxFraudGT(JaxParams(d_model=32, n_layers=1, n_heads=2))
    ref._init()
    want = sorted(tuple(x.shape) for x in jax.tree_util.tree_leaves(ref.params))
    assert sorted(tuple(x.shape) for x in a.net.parameters()) == want
    # fit is ported (A10): 40 edges make no full batch of 256, so no step
    # runs and the seeded weights stay
    before = [x.detach().clone() for x in a.net.parameters()]
    a.fit(g, np.zeros(g.n_edges), eids)
    assert a.fit_seconds["steps"] == 0
    assert all(torch.equal(x, y) for x, y in zip(before, a.net.parameters()))
    with pytest.raises(ValueError, match="no weights"):
        fraudgt_from_reference(JaxFraudGT(JaxParams(d_model=32, n_layers=1, n_heads=2)), device="cpu")
