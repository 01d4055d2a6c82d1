"""``repro_torch.examples.train_aml_pipeline``'s five pipelines against
the JAX package's ``run_aml_pipeline`` at the script's feature sets,
shrunk (HI-Small at scale 0.05, 5 trees, FraudGT for 1 epoch): each
feature set's F1, precision and recall within 1e-6 of the reference's,
and the same confusion counts and split.  FraudGT's half of the example
is held in ``tests/test_torch_examples_fraudgt.py``."""
import pytest
import torch

from repro.data import generate_aml_dataset as jax_dataset
from repro.ml.gbdt import GBDTParams as JaxGBDTParams
from repro.ml.pipeline import run_aml_pipeline as jax_pipeline
from repro_torch.data import generate_aml_dataset
from repro_torch.examples import train_aml_pipeline
from repro_torch.ml.fraudgt import FraudGT, FraudGTParams

SCALE, TREES, EPOCHS = 0.05, 5, 1
METRIC_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    ds = generate_aml_dataset("HI-Small", seed=0, scale=SCALE)
    got = train_aml_pipeline.run(ds, FraudGT(FraudGTParams(epochs=EPOCHS), device="cpu"), trees=TREES, device="cpu")
    jds = jax_dataset("HI-Small", seed=0, scale=SCALE)
    want = {fs: jax_pipeline(jds, feature_set=fs, params=JaxGBDTParams(n_trees=TREES))
            for fs in train_aml_pipeline.FEATURE_SETS}
    return got, want


@pytest.mark.parametrize("fs", train_aml_pipeline.FEATURE_SETS)
def test_pipeline_metrics_equal_reference(runs, fs):
    got, want = runs
    row, ref = got["pipelines"][fs], want[fs]
    for key in ("f1", "precision", "recall"):
        assert abs(row[key] - getattr(ref, key)) <= METRIC_TOL, (key, row[key], getattr(ref, key))
    res = got["results"][fs]
    assert res.confusion == ref.confusion and (res.n_train, res.n_test) == (ref.n_train, ref.n_test)
