"""``repro_torch.examples.train_aml_pipeline``'s FraudGT stage against the
JAX package's at the script's steps, shrunk (HI-Small at scale 0.05, 1
epoch): the port's FraudGT, started from the reference's init
(``fraudgt_from_reference``), fitted on the same training split and
scored on the test split, gives probabilities within 1e-4 of the
reference's and F1 within 0.02, with the threshold picked on the trained
edges as the script does."""
import numpy as np
import pytest
import torch

from repro.data import generate_aml_dataset as jax_dataset
from repro.data import temporal_split as jax_split
from repro.ml.fraudgt import FraudGT as JaxFraudGT
from repro.ml.fraudgt import FraudGTParams as JaxParams
from repro.ml.metrics import best_f1_threshold, f1_score
from repro_torch.convert import fraudgt_from_reference
from repro_torch.data import generate_aml_dataset
from repro_torch.examples import train_aml_pipeline

SCALE, TREES, EPOCHS = 0.05, 5, 1
PROBA_TOL = 1e-4
F1_TOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    jds = jax_dataset("HI-Small", seed=0, scale=SCALE)
    jf = JaxFraudGT(JaxParams(epochs=EPOCHS), seed=0)
    jf._init()
    ft = fraudgt_from_reference(jf, device="cpu")  # the init, before the JAX fit moves it
    got = train_aml_pipeline.run(generate_aml_dataset("HI-Small", seed=0, scale=SCALE), ft, trees=TREES,
                                 device="cpu")
    train_ids, test_ids = jax_split(jds)
    y = jds.labels.astype(np.float32)
    jf.fit(jds.graph, jds.labels, train_ids)
    thr = best_f1_threshold(y[train_ids], jf.predict_proba(jds.graph, train_ids))
    proba = np.asarray(jf.predict_proba(jds.graph, test_ids))
    return got, {"proba": proba, "threshold": thr, "f1": f1_score(y[test_ids], proba >= thr)}


def test_probabilities_equal_reference(runs):
    got, ref = runs
    np.testing.assert_allclose(got["fraudgt_proba"], ref["proba"], rtol=0, atol=PROBA_TOL)


def test_f1_equals_reference(runs):
    got, ref = runs
    assert abs(got["fraudgt_f1"] - ref["f1"]) <= F1_TOL
    assert got["n_edges"] > 0 and 0 < got["n_illicit"] < got["n_edges"]
