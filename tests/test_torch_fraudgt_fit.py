"""The port's ``FraudGT.fit`` against the JAX package's: the same weights
(a JAX model's init carried across), the same few hundred training edges
and the same rules (pos_weight, weighted BCE, seeded permutations, the
trailing partial batch dropped, AdamW) give trained weights within 1e-4
of the JAX fit's and probabilities within 1e-4, under both attention
backends: ``"kernel"`` (the autograd Function over the kernels' plain
versions on the CPU: the forward with its logsumexp and the short-path
backward) and ``"torch"`` (autograd through the explicit-op attention, as
the reference differentiates its XLA attention)."""
import jax
import numpy as np
import pytest
import torch

from repro.data.synth_aml import generate_aml_dataset
from repro.ml.fraudgt import FraudGT as JaxFraudGT
from repro.ml.fraudgt import FraudGTParams as JaxParams
from repro_torch.convert import fraudgt_from_reference, fraudgt_params_numpy, graph_from_reference
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.ml.fraudgt import FraudGT, FraudGTParams

# AdamW's first steps move each weight by about lr * sign(gradient), so a
# gradient that is zero up to rounding could flip a weight by 2 * lr
# (6e-4) between the frameworks; none does at these inputs, so no looser
# bound is needed than 1e-4
WEIGHT_TOL = 1e-4
PROBA_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    ds = generate_aml_dataset("HI-Small", seed=0, scale=0.5)
    labels = ds.labels.astype(np.float32)
    rng = np.random.default_rng(1)
    pos, neg = np.flatnonzero(labels > 0), np.flatnonzero(labels == 0)
    train = np.sort(np.concatenate([rng.choice(pos, 24, replace=False), rng.choice(neg, 276, replace=False)]))
    test = rng.choice(neg, 150, replace=False)
    return ds.graph, labels, train.astype(np.int64), np.concatenate([pos[:50], test])


@pytest.fixture(scope="module", params=[None, 3.0], ids=["pos_weight_rule", "pos_weight_3"])
def jax_fit(request, data):
    g, labels, train, test = data
    p = JaxParams(d_model=64, n_layers=2, n_heads=4, batch=64, epochs=2, pos_weight=request.param)
    jf = JaxFraudGT(p, seed=0)
    jf._init()
    init = jax.tree_util.tree_map(np.asarray, jf.params)
    start = fraudgt_from_reference(jf, device="cpu")  # the init, before the JAX fit moves it
    jf.fit(g, labels, train)
    return start, init, jax.tree_util.tree_map(np.asarray, jf.params), np.asarray(jf.predict_proba(g, test))


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_fit_equals_reference(data, jax_fit, backend):
    g, labels, train, test = data
    start, init, want, want_proba = jax_fit
    ft = FraudGT(start.p, device="cpu", attn_backend=backend).load_params(fraudgt_params_numpy(start))
    ft.amount_edges = start.amount_edges
    before = (fa_ops.launches, fa_ops.bwd_launches)
    ft.fit(graph_from_reference(g), labels, train)
    assert (fa_ops.launches, fa_ops.bwd_launches) == before  # the CPU runs the plain versions
    steps = start.p.epochs * (len(train) // start.p.batch)  # the trailing partial batch dropped
    assert ft.fit_seconds["steps"] == steps and ft.losses.shape == (steps,)
    assert torch.isfinite(ft.losses).all()
    got = fraudgt_params_numpy(ft)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    moved = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a, b: float(np.abs(a - b).max()), init, want)))
    assert moved > 10 * WEIGHT_TOL  # the fit did move the weights
    diffs = jax.tree_util.tree_map(lambda a, b: float(np.abs(a - b).max()), got, want)
    assert max(jax.tree_util.tree_leaves(diffs)) <= WEIGHT_TOL, diffs
    proba = ft.predict_proba(graph_from_reference(g), test)
    np.testing.assert_allclose(proba, want_proba, rtol=0, atol=PROBA_TOL)


def test_kernel_and_torch_backends_train_alike(data):
    """The port's two attention backends from one seeded init: the same
    losses and weights within float32 rounding."""
    g, labels, train, _ = data
    g = graph_from_reference(g)
    p = FraudGTParams(d_model=64, n_layers=2, n_heads=4, batch=64, epochs=1)
    fits = {b: FraudGT(p, seed=4, device="cpu", attn_backend=b).fit(g, labels, train) for b in ("kernel", "torch")}
    torch.testing.assert_close(fits["kernel"].losses, fits["torch"].losses, rtol=1e-5, atol=1e-6)
    a, b = (fraudgt_params_numpy(f) for f in fits.values())
    diffs = jax.tree_util.tree_map(lambda x, y: float(np.abs(x - y).max()), a, b)
    assert max(jax.tree_util.tree_leaves(diffs)) <= WEIGHT_TOL


def test_fit_of_no_full_batch_keeps_the_weights(data):
    g, labels, train, _ = data
    p = FraudGTParams(d_model=64, n_layers=2, n_heads=4, batch=512, epochs=1)
    ft = FraudGT(p, seed=4, device="cpu").init_params()
    before = fraudgt_params_numpy(ft)
    ft.fit(graph_from_reference(g), labels, train[:100])
    assert ft.fit_seconds["steps"] == 0 and ft.losses.shape == (0,)
    after = fraudgt_params_numpy(ft)
    assert all(np.array_equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(before), jax.tree_util.tree_leaves(after)))
