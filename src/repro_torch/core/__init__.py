"""BlazingAML core for the PyTorch port: pattern specs + the torch mining
compiler.

The spec and compiler layers load eagerly; the pattern library resolves
lazily via module ``__getattr__`` — it is authored in the
:mod:`repro_torch.api` fluent DSL, which itself builds on
:mod:`repro_torch.core.spec`, and the lazy hop keeps that dependency cycle
open (``import repro_torch.api`` and ``import repro_torch.core`` both work
from a cold interpreter).  :class:`GFPReference` is the numpy enumeration
oracle (a copy of the JAX package's ``repro.core.oracle``), independent of
the compiled path it checks.
"""
import importlib

from repro_torch.core.spec import (
    Neigh,
    NodeRef,
    PatternSpec,
    SEED_DST,
    SEED_SRC,
    SEED_T,
    SetExpr,
    Stage,
    StageT,
    TimeBound,
    Window,
)
from repro_torch.core.compiler import (
    CompiledPattern,
    StageGraphIR,
    analyze_stage_graph,
    compile_pattern,
)
from repro_torch.core.oracle import GFPReference

# name -> defining module, resolved on first attribute access
_LAZY = {
    "build_pattern": "repro_torch.core.patterns",
    "feature_pattern_set": "repro_torch.core.patterns",
    "PATTERN_NAMES": "repro_torch.core.patterns",
    "StreamingMiner": "repro_torch.core.streaming",
}

__all__ = [
    "Neigh",
    "NodeRef",
    "PatternSpec",
    "SEED_DST",
    "SEED_SRC",
    "SEED_T",
    "SetExpr",
    "Stage",
    "StageT",
    "TimeBound",
    "Window",
    "CompiledPattern",
    "StageGraphIR",
    "analyze_stage_graph",
    "compile_pattern",
    "GFPReference",
    *_LAZY,
]


def __getattr__(name):
    if name in _LAZY:
        val = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = val
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
