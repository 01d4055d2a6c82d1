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
]
