"""Carry the JAX package's host-side state across to the port.

The parity tests feed identical inputs to both packages.  These helpers
read a ``repro`` object by class and field name — they never import
``repro`` — and rebuild it from the port's own classes:

* :func:`graph_from_reference` — a ``repro.graph.csr.TemporalGraph``
  (numpy fields) becomes a :class:`repro_torch.graph.csr.TemporalGraph`;
* :func:`spec_from_reference` — a ``repro.core.spec.PatternSpec`` with its
  ``Stage`` / ``Window`` / ``TimeBound`` / ``NodeRef`` / ``Neigh`` /
  ``SetExpr`` / ``StageT`` objects becomes the port's dataclasses;
* :func:`gbdt_from_reference` — a fitted ``repro.ml.gbdt.GBDTClassifier``
  becomes the port's classifier with the same bins, trees and margin;
* :func:`fraudgt_from_reference` — a ``repro.ml.fraudgt.FraudGT`` with
  weights becomes the port's model with the same weights and amount
  buckets;
* :func:`fraudgt_params_numpy` — the way back: the port's FraudGT
  weights (after ``fit``, say) as numpy in the reference's ``params``
  layout, for comparing trained weights;
* :func:`lm_params_from_reference` — an LM parameter tree of
  ``repro.models.model.init_params`` (JAX or numpy leaves) becomes the
  port's tensors on a device, checked leaf by leaf against
  :func:`repro_torch.models.model.param_specs`; :func:`lm_params_numpy`
  is the way back;
* :func:`lm_cache_from_reference` — a decode cache of
  ``repro.models.model.cache_init`` (or one that ``decode_step``
  returned) becomes the port's tensors, dtypes kept.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import spec as S
from repro_torch.device import resolve_device
from repro_torch.graph.csr import TemporalGraph
from repro_torch.ml.fraudgt import FraudGT, FraudGTParams
from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams
from repro_torch.models.model import param_specs, tree_map

__all__ = [
    "graph_from_reference",
    "spec_from_reference",
    "gbdt_from_reference",
    "fraudgt_from_reference",
    "fraudgt_params_numpy",
    "lm_params_from_reference",
    "lm_params_numpy",
    "lm_cache_from_reference",
]

# classes rebuilt field by field, looked up by the reference's class name
_SPEC_CLASSES = {
    cls.__name__: cls
    for cls in (
        S.PatternSpec,
        S.Stage,
        S.Window,
        S.TimeBound,
        S.NodeRef,
        S.Neigh,
        S.SetExpr,
        S.StageT,
    )
}


def graph_from_reference(g) -> TemporalGraph:
    """The port's TemporalGraph with the same numpy arrays and scalars."""
    kw = {}
    for f in dataclasses.fields(TemporalGraph):
        v = getattr(g, f.name)
        kw[f.name] = np.asarray(v) if isinstance(v, np.ndarray) else v
    return TemporalGraph(**kw)


def _convert(obj):
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, tuple):
        return tuple(_convert(x) for x in obj)
    name = type(obj).__name__
    if name == "_SeedT":
        return S.SEED_T
    cls = _SPEC_CLASSES.get(name)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"cannot convert {obj!r} ({name}) to a port spec object")
    return cls(
        **{f.name: _convert(getattr(obj, f.name)) for f in dataclasses.fields(cls)}
    )


def spec_from_reference(spec) -> S.PatternSpec:
    """The port's PatternSpec equal field for field to the reference's."""
    if type(spec).__name__ != "PatternSpec":
        raise TypeError(f"expected a PatternSpec, got {type(spec).__name__}")
    return _convert(spec)


def gbdt_from_reference(clf, device=None) -> GBDTClassifier:
    """The port's classifier, on ``device``, predicting what the fitted
    reference classifier predicts: its params, bin edges, trees (feat, bin
    and leaf per level) and base margin, carried across as numpy."""
    params = GBDTParams(
        **{f.name: getattr(clf.p, f.name) for f in dataclasses.fields(GBDTParams)}
    )
    out = GBDTClassifier(params, device=device)
    out.edges = np.asarray(clf.edges, dtype=np.float32)
    out.trees = [
        (
            [np.asarray(f, dtype=np.int32) for f in feats],
            [np.asarray(b, dtype=np.int32) for b in bins],
            np.asarray(leaf, dtype=np.float32),
        )
        for feats, bins, leaf in clf.trees
    ]
    out.base_margin = float(clf.base_margin)
    return out


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.array(tree, dtype=np.float32)


def fraudgt_from_reference(ft, device=None) -> FraudGT:
    """The port's FraudGT, on ``device``, scoring as the reference model
    does: its params (``ft.p``), its weights (``ft.params``, by key, as
    numpy) and its amount buckets (``ft.amount_edges``)."""
    if ft.params is None:
        raise ValueError("the reference FraudGT has no weights yet (fit it or call its _init)")
    p = FraudGTParams(**{f.name: getattr(ft.p, f.name) for f in dataclasses.fields(FraudGTParams)})
    out = FraudGT(p, device=device).load_params(_numpy_tree(ft.params))
    if ft.amount_edges is not None:
        out.amount_edges = np.array(ft.amount_edges)
    return out


def fraudgt_params_numpy(ft: FraudGT) -> dict:
    """The port's FraudGT weights as float32 numpy arrays in the
    reference's ``params`` layout (``emb_*``, ``blocks`` of ``norm1``,
    ``attn``, ``norm2``, ``mlp``, then ``head`` and ``bias``)."""
    if ft.net is None:
        raise ValueError("the FraudGT has no weights yet (fit it or call init_params)")
    arr = lambda x: x.detach().cpu().numpy().astype(np.float32)
    net = ft.net
    return {
        "emb_amount": arr(net.emb_amount),
        "emb_dt": arr(net.emb_dt),
        "emb_role": arr(net.emb_role),
        "blocks": [
            {
                "norm1": {"scale": arr(blk.norm1.scale)},
                "attn": {
                    **{k: arr(v) for k, v in blk.attn.w.items()},
                    **{k: {"scale": arr(m.scale)} for k, m in blk.attn.norms.items()},
                },
                "norm2": {"scale": arr(blk.norm2.scale)},
                "mlp": {k: arr(v) for k, v in blk.mlp.w.items()},
            }
            for blk in net.blocks
        ],
        "head": arr(net.head),
        "bias": arr(net.bias),
    }


def _tensor(a, device) -> torch.Tensor:
    """A leaf as a torch tensor on ``device`` with its dtype; bfloat16
    (numpy's ``ml_dtypes`` type) goes across as its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_reference(params, cfg, device=None) -> dict:
    """The port's LM weights on ``device`` (the CUDA card by default):
    every leaf of the reference's tree as float32, in the same layout
    (units stacked on the leading axis).  Raises where the tree's keys or
    shapes differ from the port's for ``cfg``."""
    dev = resolve_device(device)
    specs = param_specs(cfg)
    if _keys(params) != _keys(specs):
        raise ValueError(f"the reference tree's keys differ from the port's for {cfg.name}")

    def leaf(spec, a):
        a = np.asarray(a, dtype=np.float32)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"a leaf of shape {a.shape} where {cfg.name} has {tuple(spec.shape)}")
        return torch.from_numpy(a.copy()).to(dev)

    return tree_map(leaf, specs, params)


def _keys(tree):
    return {k: _keys(v) for k, v in tree.items()} if isinstance(tree, dict) else None


def lm_params_numpy(params) -> dict:
    """The port's LM weights as float32 numpy in the reference's layout."""
    return tree_map(lambda a: a.detach().float().cpu().numpy(), params)


def lm_cache_from_reference(cache, device=None) -> dict:
    """A reference decode cache as the port's tensors on ``device`` (the
    CUDA card by default), dtypes kept (int32 ``pos``, float32 states,
    the activations' dtype for keys, values and conv states)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), dict(cache))
