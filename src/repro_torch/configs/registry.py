"""Assigned-architecture registry: ``--arch <id>`` resolution.

All 10 architectures from the assignment (exact published configs), plus
the paper-side FraudGT-style graph transformer and reduced smoke variants.
A copy of the JAX package's framework-free ``repro.configs.registry``.
The port's LM (:mod:`repro_torch.models`) runs every architecture here,
and ``fraudgt-small``'s widths are FraudGT's (:mod:`repro_torch.ml.fraudgt`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import LM_SHAPES, ModelConfig, MoEConfig, ShapeSpec

__all__ = ["ARCHS", "get_config", "smoke_config", "arch_names", "LM_SHAPES"]


def _zamba2_2p7b() -> ModelConfig:
    # Mamba2 backbone + shared attention block [arXiv:2411.15242]
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        unit=("mamba2",) * 5 + ("shared_attn",),
        ssm_state=64,
        attn_window=4096,  # shared global blocks run windowed at 500k ctx
    )


def _moonshot_v1_16b_a3b() -> ModelConfig:
    # Moonlight-16B-A3B: 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B]
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=163840,
        unit=("moe_attn",),
        moe=MoEConfig(n_experts=64, top_k=6, d_expert_ff=1408),
    )


def _mixtral_8x7b() -> ModelConfig:
    # 8 experts top-2, sliding-window attention [arXiv:2401.04088]
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=32000,
        unit=("moe_attn",),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=14336),
        attn_window=4096,
    )


def _musicgen_medium() -> ModelConfig:
    # decoder-only over EnCodec tokens [arXiv:2306.05284]; frontend STUB:
    # input_specs provides precomputed frame embeddings (B, T, d_model)
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab=2048,
        unit=("attn",),
        n_codebooks=4,
        precomputed_embeddings=True,
    )


def _mistral_nemo_12b() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=131072,
        unit=("attn",),
        d_head=128,
        rope_theta=1_000_000.0,
    )


def _qwen2_1p5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151936,
        unit=("attn",),
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )


def _deepseek_coder_33b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab=32256,
        unit=("attn",),
    )


def _granite_8b() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=49152,
        unit=("attn",),
    )


def _chameleon_34b() -> ModelConfig:
    # early fusion: VQ image tokens live in the unified vocab; the VQ
    # tokenizer is the STUB frontend (input_specs provides token ids)
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=65536,
        unit=("attn",),
        qk_norm=True,
    )


def _xlstm_125m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        unit=("mlstm", "slstm"),
    )


def _fraudgt_small() -> ModelConfig:
    # paper-side baseline: FraudGT-style graph transformer over transaction
    # token sequences with mined-feature embeddings (repro_torch.ml.fraudgt)
    return ModelConfig(
        name="fraudgt-small",
        family="dense",
        n_layers=4,
        d_model=256,
        n_heads=8,
        n_kv_heads=8,
        d_ff=1024,
        vocab=4096,
        unit=("attn",),
    )


ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _zamba2_2p7b(),
        _moonshot_v1_16b_a3b(),
        _mixtral_8x7b(),
        _musicgen_medium(),
        _mistral_nemo_12b(),
        _qwen2_1p5b(),
        _deepseek_coder_33b(),
        _granite_8b(),
        _chameleon_34b(),
        _xlstm_125m(),
        _fraudgt_small(),
    )
}

ASSIGNED = tuple(n for n in ARCHS if n != "fraudgt-small")


def arch_names() -> tuple:
    return ASSIGNED


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (one unit, tiny dims)."""
    c = get_config(name)
    kw = dict(
        name=c.name + "-smoke",
        n_layers=len(c.unit),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(c.n_kv_heads, 2)),
        d_ff=128 if c.d_ff else 0,
        vocab=512,
        d_head=16,
        ssm_state=16 if c.ssm_state else 0,
        attn_window=32 if c.attn_window else None,
    )
    if c.moe is not None:
        kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_expert_ff=96)
    return dataclasses.replace(c, **kw)
