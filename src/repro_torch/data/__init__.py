from repro_torch.data.loader import temporal_split
from repro_torch.data.synth_aml import (
    AMLDataset,
    DATASET_PRESETS,
    generate_aml_dataset,
    load_dataset,
    planted_instances,
)

__all__ = [
    "AMLDataset",
    "DATASET_PRESETS",
    "generate_aml_dataset",
    "load_dataset",
    "planted_instances",
    "temporal_split",
]
