"""The LM scaffold of the port (the JAX package's ``repro.models``): layers,
recurrent mixers, blocks and the model over them.  FraudGT
(:mod:`repro_torch.ml.fraudgt`) runs on :mod:`.layers`."""
from repro_torch.models.model import (
    LM,
    build_model,
    init_params,
    param_specs,
    cache_specs,
)

__all__ = ["LM", "build_model", "init_params", "param_specs", "cache_specs"]
