from repro_torch.data.loader import temporal_split
from repro_torch.data.synth_aml import (
    AMLDataset,
    DATASET_PRESETS,
    generate_aml_dataset,
    load_dataset,
    planted_instances,
)
from repro_torch.data.trovares import TROVARES_SIZES, generate_trovares_graph

__all__ = [
    "AMLDataset",
    "DATASET_PRESETS",
    "generate_aml_dataset",
    "load_dataset",
    "planted_instances",
    "generate_trovares_graph",
    "TROVARES_SIZES",
    "temporal_split",
]
