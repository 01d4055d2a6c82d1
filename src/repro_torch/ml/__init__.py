"""The detection models of the port: the histogram GBDT, its metrics and
the end-to-end pipeline (mined features -> GBDT -> F1), and the FraudGT
graph-transformer baseline (inference)."""
from repro_torch.ml.fraudgt import FraudGT, FraudGTParams
from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams
from repro_torch.ml.metrics import confusion, f1_score, precision_recall_f1
from repro_torch.ml.pipeline import PipelineResult, run_aml_pipeline

__all__ = [
    "FraudGT",
    "FraudGTParams",
    "GBDTClassifier",
    "GBDTParams",
    "confusion",
    "f1_score",
    "precision_recall_f1",
    "run_aml_pipeline",
    "PipelineResult",
]
