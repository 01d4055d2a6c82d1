"""The port's detection path on the CPU against the JAX package's: the
temporal split, the feature matrix, and ``run_aml_pipeline`` end to end
on a small synthetic HI-Small (identical mined columns, identical trees,
equal F1)."""
import warnings

import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro.core.features import base_features as jax_base_features
from repro.data.loader import temporal_split as jax_temporal_split
from repro.data.synth_aml import generate_aml_dataset as jax_generate
from repro.ml import gbdt as jax_gbdt
from repro.ml.pipeline import FEATURE_SETS as JAX_FEATURE_SETS
from repro.ml.pipeline import run_aml_pipeline as jax_run_aml_pipeline
from repro_torch import api
from repro_torch.core import features
from repro_torch.data import generate_aml_dataset, temporal_split
from repro_torch.kernels.hist_update import ops as hu_ops
from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams
from repro_torch.ml.pipeline import FEATURE_SETS, PipelineResult, run_aml_pipeline

# about 9K transactions: both pipelines together take well under a minute
SCALE = 0.5
TREES = 10
WINDOW = 4096


@pytest.fixture(scope="module")
def datasets():
    return (
        jax_generate("HI-Small", seed=0, scale=SCALE),
        generate_aml_dataset("HI-Small", seed=0, scale=SCALE),
    )


@pytest.fixture(scope="module")
def jax_full_features(datasets):
    return jax_api.featurize(datasets[0].graph, WINDOW, JAX_FEATURE_SETS["full"])


def test_temporal_split(datasets):
    ref, port = datasets
    for got, want in zip(temporal_split(port), jax_temporal_split(ref)):
        np.testing.assert_array_equal(got, want)
    tr, te = temporal_split(port, train_frac=0.6)
    assert len(tr) + len(te) == port.graph.n_edges
    assert port.graph.t[tr].max() <= port.graph.t[te].min()


def test_feature_sets_match():
    assert set(FEATURE_SETS) == set(JAX_FEATURE_SETS)
    for name, pats in FEATURE_SETS.items():
        assert pats == JAX_FEATURE_SETS[name]


def test_featurize_matches_jax(datasets, jax_full_features):
    ref, port = datasets
    np.testing.assert_array_equal(features.base_features(port.graph), jax_base_features(ref.graph))
    want, want_cols = jax_full_features
    got, cols = api.featurize(port.graph, WINDOW, device="cpu")
    assert cols == want_cols and cols[:3] == features.BASE_COLUMNS
    np.testing.assert_array_equal(got, want)
    fan = FEATURE_SETS["fan"]
    block = api.mine_features(port.graph, WINDOW, fan, device="cpu")
    np.testing.assert_array_equal(block, want[:, [cols.index(p) for p in fan]])
    base, base_cols = api.featurize(port.graph, WINDOW, (), device="cpu")
    assert base_cols == features.BASE_COLUMNS and base.shape == (port.graph.n_edges, 3)
    with pytest.warns(DeprecationWarning):
        shim, _ = features.featurize(port.graph, WINDOW, fan, device="cpu")
    np.testing.assert_array_equal(shim, got[:, [0, 1, 2] + [cols.index(p) for p in fan]])
    with pytest.warns(DeprecationWarning):
        np.testing.assert_array_equal(features.mine_features(port.graph, WINDOW, fan, device="cpu"), block)


def test_trees_match_jax(datasets, jax_full_features):
    ref, port = datasets
    x = jax_full_features[0]
    tr, _ = temporal_split(port)
    y = port.labels.astype(np.float32)
    want = jax_gbdt.GBDTClassifier(jax_gbdt.GBDTParams(n_trees=TREES)).fit(x[tr], y[tr])
    before = hu_ops.launches
    got = GBDTClassifier(GBDTParams(n_trees=TREES), device="cpu").fit(x[tr], y[tr])
    assert hu_ops.launches == before  # the plain version on the CPU
    for (gf, gb, gl), (wf, wb, wl) in zip(got.trees, want.trees):
        for level in range(6):
            np.testing.assert_array_equal(gf[level], np.asarray(wf[level]))
            np.testing.assert_array_equal(gb[level], np.asarray(wb[level]))
        np.testing.assert_allclose(gl, np.asarray(wl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("feature_set", ["full", "xgb_only"])
def test_pipeline_matches_jax(datasets, jax_full_features, feature_set):
    ref, port = datasets
    want = jax_run_aml_pipeline(ref, feature_set, params=jax_gbdt.GBDTParams(n_trees=TREES))
    got = run_aml_pipeline(port, feature_set, params=GBDTParams(n_trees=TREES), device="cpu")
    assert isinstance(got, PipelineResult)
    assert (got.f1, got.precision, got.recall) == (want.f1, want.precision, want.recall)
    assert got.confusion == want.confusion
    assert (got.n_train, got.n_test) == (want.n_train, want.n_test)
    assert set(got.fit_seconds) == {"binning", "rounds"}
    if feature_set == "full":
        assert got.f1 > 0.3  # the mined features carry signal
        np.testing.assert_array_equal(got.mining.as_features(), jax_full_features[0][:, 3:])
        assert got.mining.columns == FEATURE_SETS["full"]
    else:
        assert got.mining is None


def test_pipeline_backends_and_device(datasets, monkeypatch):
    port = datasets[1]
    with pytest.raises(NotImplementedError, match="ROADMAP.*A8"):
        run_aml_pipeline(port, "fan", backend="sharded", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_aml_pipeline(port, "xgb_only")
