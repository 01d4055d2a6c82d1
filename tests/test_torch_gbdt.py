"""The port's GBDT on the CPU against the JAX package's
(``tests/test_gbdt.py``'s data and cases): histograms, trees, leaves and
probabilities; the port's own determinism; carrying a fitted reference
classifier across; and the metrics copy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ml import gbdt as jax_gbdt
from repro.ml import metrics as jax_metrics
from repro_torch.convert import gbdt_from_reference
from repro_torch.ml import gbdt, metrics
from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams, first_split_difference


def _toy(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    # nonlinear decision: XOR of two features + threshold on a third
    y = ((x[:, 0] * x[:, 1] > 0) & (x[:, 2] > -0.3)).astype(np.float32)
    return x, y


def _imbalanced():
    rng = np.random.default_rng(2)
    n = 4000
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.zeros(n, dtype=np.float32)
    pos = rng.choice(n, size=60, replace=False)
    y[pos] = 1.0
    x[pos.astype(int), 0] += 2.5  # separable-ish signal
    return x, y


def test_histograms_match_jax():
    rng = np.random.default_rng(3)
    n, f, n_bins, n_nodes = 512, 3, 16, 4
    xb = rng.integers(0, n_bins, (n, f)).astype(np.uint8)
    gh = rng.normal(size=(n, 2)).astype(np.float32)
    node = rng.integers(0, n_nodes, n).astype(np.int32)
    want = np.asarray(
        jax_gbdt._histograms(jnp.asarray(xb), jnp.asarray(gh), jnp.asarray(node), n_nodes, n_bins)
    )
    got = gbdt._histograms(torch.from_numpy(xb), torch.from_numpy(gh), torch.from_numpy(node), n_nodes, n_bins)
    assert got.shape == (n_nodes, f, n_bins, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(3, 8), (4, 12, 2, 256), (5, 255), (2, 17), (4, 1), (3, 5000)])
def test_prefix_sum_adds_in_the_reference_order(shape):
    h = np.random.default_rng(len(shape) + shape[-1]).normal(size=shape).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(h), axis=-1))
    np.testing.assert_array_equal(gbdt._prefix_sum(torch.from_numpy(h)).numpy(), want)


def test_binning_is_the_reference_copy():
    x, _ = _toy(500, 4)
    edges = gbdt._quantile_bins(x, 256)
    np.testing.assert_array_equal(edges, jax_gbdt._quantile_bins(x, 256))
    np.testing.assert_array_equal(gbdt._apply_bins(x, edges), jax_gbdt._apply_bins(x, edges))


@pytest.mark.parametrize(
    "data,kw",
    [
        ("toy", dict(n_trees=30, max_depth=4, learning_rate=0.3)),
        ("imbalanced", dict(n_trees=25, max_depth=3)),
    ],
)
def test_classifier_matches_jax(data, kw):
    x, y = _toy() if data == "toy" else _imbalanced()
    ref = jax_gbdt.GBDTClassifier(jax_gbdt.GBDTParams(**kw)).fit(x, y)
    port = GBDTClassifier(GBDTParams(**kw), device="cpu").fit(x, y)
    assert len(port.trees) == len(ref.trees) == kw["n_trees"]
    assert port.base_margin == ref.base_margin
    np.testing.assert_array_equal(port.edges, ref.edges)
    for (pf, pb, pl), (rf, rb, rl) in zip(port.trees, ref.trees):
        for level in range(kw["max_depth"]):
            np.testing.assert_array_equal(pf[level], np.asarray(rf[level]))
            np.testing.assert_array_equal(pb[level], np.asarray(rb[level]))
        # torch.sigmoid and jax.nn.sigmoid may differ by an ulp, and the
        # two cumsums add in other orders: leaves agree to rounding
        np.testing.assert_allclose(pl, np.asarray(rl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.predict_proba(x), ref.predict_proba(x), rtol=1e-5, atol=1e-5)
    # the reference's own quality bars (test_gbdt.py) hold for the port
    if data == "toy":
        assert float(np.mean(port.predict(x) == y)) > 0.9
    else:
        proba = port.predict_proba(x)
        assert metrics.f1_score(y, proba >= metrics.best_f1_threshold(y, proba)) > 0.5


def test_deterministic():
    x, y = _toy(800, 1)
    a = GBDTClassifier(GBDTParams(n_trees=8), device="cpu").fit(x, y)
    b = GBDTClassifier(GBDTParams(n_trees=8), device="cpu").fit(x, y)
    assert first_split_difference(a, b, len(y)) is None
    for ta, tb in zip(a.trees, b.trees):
        np.testing.assert_array_equal(ta[2], tb[2])
    np.testing.assert_array_equal(a.predict_proba(x), b.predict_proba(x))
    assert set(a.fit_seconds) == {"binning", "rounds"}
    assert all(len(g) == 63 for g in a.gains)


def test_first_split_difference_reports_the_node():
    x, y = _toy(600, 5)
    a = GBDTClassifier(GBDTParams(n_trees=3, max_depth=3), device="cpu").fit(x, y)
    b = GBDTClassifier(GBDTParams(n_trees=3, max_depth=3), device="cpu").fit(x, y)
    b.trees[1][1][2] = b.trees[1][1][2].copy()
    b.trees[1][1][2][3] += 1
    diff = first_split_difference(a, b, len(y))
    assert (diff["tree"], diff["level"], diff["node"]) == (1, 2, 3)
    assert diff["near_tie"]  # same gains: rounding could flip it
    b.gains[1] = b.gains[1] * 2
    assert not first_split_difference(a, b, len(y))["near_tie"]


def test_from_reference_predicts_the_same():
    x, y = _toy(1200, 6)
    ref = jax_gbdt.GBDTClassifier(jax_gbdt.GBDTParams(n_trees=6, max_depth=5)).fit(x, y)
    port = gbdt_from_reference(ref, device="cpu")
    assert port.p == GBDTParams(n_trees=6, max_depth=5)
    xt, _ = _toy(300, 7)
    np.testing.assert_allclose(port.predict_margin(xt), ref.predict_margin(xt), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.predict_proba(xt), ref.predict_proba(xt), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(port.predict(xt, 0.3), ref.predict(xt, 0.3))


def test_empty_fit_predicts_the_base_score():
    x, y = _toy(100, 8)
    clf = GBDTClassifier(GBDTParams(n_trees=0), device="cpu").fit(x, y)
    assert clf.trees == [] and np.all(clf.predict_proba(x) == np.float32(0.5))


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GBDTClassifier()


def test_metrics_copy():
    y = np.array([1, 1, 0, 0, 1])
    p = np.array([1, 0, 1, 0, 1])
    c = metrics.confusion(y, p)
    assert (c["tp"], c["fp"], c["fn"], c["tn"]) == (2, 1, 1, 1)
    prec, rec, f1 = metrics.precision_recall_f1(y, p)
    assert abs(prec - 2 / 3) < 1e-9 and abs(rec - 2 / 3) < 1e-9
    rng = np.random.default_rng(9)
    yt = (rng.random(500) < 0.1).astype(np.float32)
    proba = np.clip(yt * 0.4 + rng.random(500) * 0.6, 0, 1)
    assert metrics.best_f1_threshold(yt, proba) == jax_metrics.best_f1_threshold(yt, proba)
    assert metrics.precision_recall_f1(yt, proba > 0.5) == jax_metrics.precision_recall_f1(yt, proba > 0.5)
    assert metrics.f1_score(yt, proba > 0.5) == jax_metrics.f1_score(yt, proba > 0.5)
