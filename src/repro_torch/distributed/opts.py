"""Opt-in performance experiments, gated by REPRO_OPTS (comma list).

A copy of the JAX package's framework-free ``repro.distributed.opts``:
the port reads the same flags with the same defaults, and acts on four:
``chunked_ce`` (``models.model.loss_fn``), ``decode_hint``
(``models.layers.attn_decode`` pins the attention operands to the cache's
layout through ``ctx.hint``), ``kv_seq_model`` (the layout it pins, and
``distributed.sharding.cache_sharding``'s sequence-sharded KV caches)
and ``moe_shard_map`` (``models.blocks.block_apply`` dispatches through
``moe_apply_shard_map``).  The mesh flags change layouts on a mesh and
nothing when meshless.  ``bf16_grad_ar`` and ``bf16_scores`` were
refuted in the reference and the port does not act on them.

Keeping optimizations behind env flags lets the dry-run A/B a single cell
against the unmodified baseline (§Perf methodology): the baseline sweep
and the experiment run in separate processes with different flags.

Flags (confirmed winners are DEFAULT-ON; disable with "no_<flag>"):
  decode_hint   [ON]  — constrain decode-attention KV layouts to the cache
                  sharding (kills the involuntary-full-rematerialization
                  resharding the partitioner otherwise inserts; P1)
  kv_seq_model  [ON]  — shard decode KV caches along the SEQUENCE dim over
                  the model axis (flash-decode layout; P2: 38x step bound)
  chunked_ce    [ON]  — never materialize (B,T,V) logits (P5)
  moe_shard_map [ON]  — explicit-EP MoE via shard_map (P8: 70x collective)
  bf16_grad_ar  [off] — refuted (P3): the AR fires before the cast
  bf16_scores   [off] — refuted (P4): the f32 exp input still materializes
"""
from __future__ import annotations

import os

__all__ = ["enabled"]

DEFAULT_ON = {"decode_hint", "kv_seq_model", "chunked_ce", "moe_shard_map"}


def enabled(flag: str) -> bool:
    toks = set(os.environ.get("REPRO_OPTS", "").split(","))
    if f"no_{flag}" in toks:
        return False
    return flag in toks or flag in DEFAULT_ON
