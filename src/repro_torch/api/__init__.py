"""`repro_torch.api` — the BlazingAML front-end of the PyTorch port.

* the fluent authoring DSL (:mod:`repro_torch.api.dsl`, a copy of the JAX
  package's framework-free ``repro.api.dsl``): ``pattern(...)`` chains
  stage clauses and lowers to a validated ``PatternSpec``;
* the portfolio :class:`MiningSession` (:mod:`repro_torch.api.session`):
  register many patterns, compile ONCE against a shared device graph with
  cross-pattern plan dedup + seed-local kernel fusion, and mine
  everything through one `mine()` call into a :class:`MiningResult`;
* :func:`mine_features` / :func:`featurize`: the per-edge feature matrix
  (base transaction columns + mined counts) the detection model trains on.

Quick tour::

    from repro_torch.api import MiningSession, pattern, seed, var

    roundtrip3 = (
        pattern("roundtrip3")
        .for_all("w", seed.dst.out, after_seed=W, skip=[seed.src, seed.dst])
        .count_edges("close", "w", seed.src, after_stage="w")
        .emit("close")
    )
    session = MiningSession(graph, window=W)   # device="cpu" off the card
    session.register("fan_in", "cycle3", roundtrip3)
    res = session.mine()
    res.column("roundtrip3"), res.stats["kernel_calls"]
"""
from repro_torch.api.dsl import NodeExpr, PatternBuilder, pattern, seed, var
from repro_torch.api.session import (
    MiningResult,
    MiningSession,
    canonical_key,
    canonicalize,
    featurize,
    mine_features,
)

__all__ = [
    "pattern",
    "PatternBuilder",
    "seed",
    "var",
    "NodeExpr",
    "MiningSession",
    "MiningResult",
    "canonical_key",
    "canonicalize",
    "mine_features",
    "featurize",
]
