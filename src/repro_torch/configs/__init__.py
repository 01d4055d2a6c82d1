"""Model configurations: copies of the JAX package's framework-free
``repro.configs.base`` and ``repro.configs.registry``."""
from repro_torch.configs.base import LM_SHAPES, ModelConfig, MoEConfig, ShapeSpec
from repro_torch.configs.registry import ARCHS, get_config, smoke_config

__all__ = ["ARCHS", "LM_SHAPES", "ModelConfig", "MoEConfig", "ShapeSpec", "get_config", "smoke_config"]
