"""Model/arch configuration schema for the assigned architecture pool.

Every architecture is expressed as a repeating **unit** of block types so
the model stack lowers to a ``lax.scan`` over units (small HLO, fast
multi-cell dry-run compiles) even for hybrid stacks:

* dense transformer: unit = ("attn",)                x n_layers
* MoE transformer:   unit = ("moe_attn",)            x n_layers
* zamba2 hybrid:     unit = ("mamba2",)*5+("shared_attn",)  (shared params)
* xLSTM:             unit = ("mlstm", "slstm")       x n_layers/2

A copy of the JAX package's framework-free ``repro.configs.base``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoEConfig", "ModelConfig", "ShapeSpec", "LM_SHAPES"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    unit: Tuple[str, ...] = ("attn",)  # block types per repeating unit
    d_head: Optional[int] = None  # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    attn_window: Optional[int] = None  # sliding-window size (None = full)
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    n_codebooks: int = 0  # musicgen: EnCodec codebooks (frontend stub)
    precomputed_embeddings: bool = False  # audio stub: inputs are (B,T,d)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # lower the unit stack as an unrolled python loop instead of lax.scan —
    # used by the dry-run cost probes (CPU HloCostAnalysis counts a while
    # body once regardless of trip count, so cost variants must unroll)
    unroll_stack: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def n_units(self) -> int:
        assert self.n_layers % len(self.unit) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"unit size {len(self.unit)}"
        )
        return self.n_layers // len(self.unit)

    def sub_quadratic(self) -> bool:
        """True if the stack supports 500k-token decode (no full-attn)."""
        types = set(self.unit)
        if types & {"mamba2", "mlstm", "slstm"}:
            # hybrid attn blocks must be windowed to qualify
            attn_types = types & {"attn", "moe_attn", "shared_attn"}
            return not attn_types or self.attn_window is not None
        return self.attn_window is not None


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)
