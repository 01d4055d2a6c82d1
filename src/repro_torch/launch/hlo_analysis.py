"""Roofline terms of a step (no hardware required): the port's copy of the
JAX package's ``repro.launch.hlo_analysis``, at the H100's peaks.

``collective_bytes`` and ``_shape_bytes`` are the reference's, unchanged:
they read HLO text, summing the result shapes of every all-reduce /
all-gather / reduce-scatter / all-to-all / collective-permute (async
``-start`` forms counted once, ``-done`` skipped).  The port's dry run
(:mod:`repro_torch.launch.dryrun`) has no HLO: it counts the per-rank
result bytes of the functional collectives in a trace of its sharded
step under the same kind names (``_COLL``) and hands ``roofline`` the
same per-kind dict with its ``"total"``; the parser stays for HLO that
comes from elsewhere (the tests read the reference's with it).
``roofline`` is the reference's, over :data:`HW`.

Hardware constants: one NVIDIA H100 SXM, its data sheet's peaks (dense,
at the 700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 3.35
TB/s of HBM3, 450 GB/s of NVLink each way (900 GB/s in all).
"""
from __future__ import annotations

import re
from typing import Dict, Optional

__all__ = ["collective_bytes", "roofline", "HW"]

HW = {
    "peak_flops": 989e12,  # bf16 dense / card (H100 SXM data sheet)
    "hbm_bw": 3.35e12,  # bytes/s / card (HBM3)
    "link_bw": 450e9,  # bytes/s / card, NVLink, each way
}

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4,
    "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
}

_COLL = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(tok_dtype: str, tok_dims: str) -> int:
    b = _DTYPE_BYTES.get(tok_dtype)
    if b is None:
        return 0
    n = 1
    if tok_dims.strip():
        for d in tok_dims.split(","):
            n *= int(d)
    return n * b


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-collective-type result bytes (per device) from HLO text."""
    out: Dict[str, int] = {c: 0 for c in _COLL}
    for line in hlo_text.splitlines():
        ls = line.strip()
        if "=" not in ls:
            continue
        lhs, _, rhs = ls.partition("=")
        op = None
        for c in _COLL:
            # match " <op>(" or " <op>-start(" as the instruction
            if re.search(rf"\s{c}(-start)?\(", rhs):
                if f"{c}-done" in rhs:
                    op = None
                else:
                    op = c
                break
        if op is None:
            continue
        # result shape tokens live between '=' and the op name
        head = rhs.split(op)[0]
        nbytes = sum(_shape_bytes(d, dims) for d, dims in _SHAPE_RE.findall(head))
        out[op] += nbytes
    out["total"] = sum(out[c] for c in _COLL)
    return out


def _first(d, *keys, default=0.0):
    for k in keys:
        if k in d and d[k] is not None:
            return float(d[k])
    return default


def roofline(
    cost: dict,
    coll: Dict[str, int],
    n_chips: int,
    model_flops: Optional[float] = None,
) -> dict:
    """Three roofline terms in seconds (per step), per-card basis."""
    flops = _first(cost, "flops")
    bytes_acc = _first(cost, "bytes accessed", "bytes_accessed")
    compute_t = flops / HW["peak_flops"]
    memory_t = bytes_acc / HW["hbm_bw"]
    coll_t = coll.get("total", 0) / HW["link_bw"]
    terms = {"compute_s": compute_t, "memory_s": memory_t, "collective_s": coll_t}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    out = {
        **terms,
        "dominant": dom,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": bytes_acc,
        "collective_bytes_per_chip": coll.get("total", 0),
        "collectives": {k: v for k, v in coll.items() if k != "total"},
        "n_chips": n_chips,
    }
    if model_flops is not None and flops > 0:
        out["model_flops_global"] = model_flops
        out["useful_flops_ratio"] = model_flops / (flops * n_chips)
        # fraction of roofline: useful work time vs achievable bound
        ideal_t = (model_flops / n_chips) / HW["peak_flops"]
        out["roofline_fraction"] = ideal_t / bound if bound > 0 else 0.0
    return out
