"""The port's sharding rules (``repro_torch.distributed.sharding``), its
sharding-hint context (``distributed.ctx``) and mesh descriptions
(``launch.mesh``) on the CPU.

The param, ZeRO-1, batch and cache specs of every registry architecture
at full width equal the JAX package's ``PartitionSpec`` entries leaf for leaf,
on the meshes (1, 1), (2, 4), (4, 2), 16 x 16 and 2 x 16 x 16: the
reference's are computed once, in a subprocess with 512 forced host
devices (as ``launch/dryrun.py`` forces them), the port's from a
:class:`~repro_torch.launch.mesh.MeshShape` with no ranks.  Batch specs
are taken at every ``LM_SHAPES`` cell, cache specs at the decode cells
with the ``kv_seq_model`` opt on and off.  Then ``_fit``'s divisibility
fallback, spec-to-placement conversion, the meshless context, and a mesh
whose world size is wrong.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import LM_SHAPES
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.distributed import ctx
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as M

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "2x4": (("data", "model"), (2, 4)),
    "4x2": (("data", "model"), (4, 2)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
DECODE = [s for s in LM_SHAPES if s.kind == "decode"]
# (mesh, shape, spec) cases of _fit: divisible, not divisible, a zero
# dim, a tuple of axes, a spec shorter than the shape
FIT_CASES = [
    ("2x4", (8, 12), [["data"], ["model"]]),
    ("2x4", (3, 12), [["data"], ["model"]]),
    ("2x4", (8, 6), [None, ["model"]]),
    ("2x4", (0, 4), [["model"], None]),
    ("2x16x16", (64, 7), [["pod", "data"], None]),
    ("2x16x16", (48, 32), [["pod", "data"], ["model"]]),
    ("16x16", (32, 16, 5), [["data"]]),
]

REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs.base import LM_SHAPES
from repro.configs.registry import ARCHS, get_config
from repro.distributed.sharding import _fit, batch_sharding, cache_sharding, param_sharding, zero1_sharding
from repro.models.model import batch_specs, cache_specs, param_specs

meshes, fit_cases = json.loads(sys.argv[1]), json.loads(sys.argv[2])
entry = lambda e: None if e is None else ([e] if isinstance(e, str) else list(e))
spec = lambda sh: [entry(e) for e in (sh.spec if hasattr(sh, "spec") else sh)]
paths = lambda tree: {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): spec(s)
                      for p, s in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "spec"))[0]}
made = {}
for key, (names, sizes) in meshes.items():
    n = int(np.prod(sizes))
    made[key] = Mesh(np.array(jax.devices()[:n]).reshape(sizes), tuple(names))
out = {"specs": {}, "fit": []}
for arch in sorted(ARCHS):
    cfg = get_config(arch)
    ps = param_specs(cfg)
    caches = {s.name: cache_specs(cfg, s.global_batch, s.seq_len) for s in LM_SHAPES if s.kind == "decode"}
    batches = {s.name: batch_specs(cfg, s.seq_len, s.global_batch, s.kind) for s in LM_SHAPES}
    out["specs"][arch] = {}
    for key, mesh in made.items():
        psh = param_sharding(mesh, ps)
        row = {"param": paths(psh), "zero1": paths(zero1_sharding(mesh, ps, psh)),
               "batch": {k: paths(batch_sharding(mesh, b)) for k, b in batches.items()}, "cache": {}}
        for flag in ("kv_seq_model", "no_kv_seq_model"):
            os.environ["REPRO_OPTS"] = flag
            row["cache"][flag] = {k: paths(cache_sharding(mesh, c)) for k, c in caches.items()}
        os.environ.pop("REPRO_OPTS")
        out["specs"][arch][key] = row
for key, shape, sp in fit_cases:
    out["fit"].append(spec(_fit(made[key], tuple(shape), P(*[None if e is None else tuple(e) for e in sp]))))
print("RESULT " + json.dumps(out))
"""


def _norm(tree):
    """A spec tree as {path: [entry]} with entries None or lists of axes."""
    out = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, pre + (str(k),))
        else:
            out["/".join(pre)] = [None if e is None else list(e) for e in t]

    walk(tree, ())
    return out


@pytest.fixture(scope="module")
def ref_specs():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_OPTS", None)
    res = subprocess.run([sys.executable, "-c", REF, json.dumps(MESHES), json.dumps(FIT_CASES)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_reference(ref_specs, arch, mesh_key, monkeypatch):
    want = ref_specs["specs"][arch][mesh_key]
    mesh = MeshShape(*MESHES[mesh_key])
    cfg = get_config(arch)
    ps = M.param_specs(cfg)
    psh = S.param_sharding(mesh, ps)
    assert _norm(psh) == want["param"]
    assert _norm(S.zero1_sharding(mesh, ps, psh)) == want["zero1"]
    assert S.opt_sharding(mesh, psh) == psh
    for shape in LM_SHAPES:
        b = M.batch_specs(cfg, shape.seq_len, shape.global_batch, shape.kind)
        assert _norm(S.batch_sharding(mesh, b)) == want["batch"][shape.name], shape.name
    for flag in ("kv_seq_model", "no_kv_seq_model"):
        monkeypatch.setenv("REPRO_OPTS", flag)
        for shape in DECODE:
            c = M.cache_specs(cfg, shape.global_batch, shape.seq_len)
            assert _norm(S.cache_sharding(mesh, c)) == want["cache"][flag][shape.name], (flag, shape.name)


def test_fit_fallback(ref_specs):
    """A dim keeps its axes only when their size divides it (and it is not
    empty); a spec shorter than the shape is padded with None."""
    got = [[None if e is None else list(e) for e in S._fit(MeshShape(*MESHES[k]), shape,
                                                           [None if e is None else tuple(e) for e in sp])]
           for k, shape, sp in FIT_CASES]
    assert got == ref_specs["fit"]
    assert got[0] == [["data"], ["model"]]
    assert got[1] == [None, ["model"]]
    assert got[3] == [None, None]
    assert got[4] == [["pod", "data"], None]
    assert got[6] == [["data"], None, None]


def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert S.spec_placements(mesh, (("pod", "data"), ("model",))) == (Shard(0), Shard(0), Shard(1))
    assert S.spec_placements(mesh, (None, None)) == (Replicate(),) * 3
    assert S.spec_placements(mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        S.spec_placements(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="shards two"):
        S.spec_placements(mesh, (("model",), ("model",)))
    tree = S.placement_tree(MeshShape(*MESHES["2x4"]), {"a": (("data",), None), "b": {"c": ()}})
    assert tree == {"a": (Shard(0), Replicate()), "b": {"c": (Replicate(), Replicate())}}


def test_ctx_meshless_and_sizes():
    x = torch.ones(4, 8)
    ctx.clear()
    assert ctx.hint(x, ("data", "model")) is x
    assert (ctx.data_size(), ctx.model_size(), ctx.mesh_and_axes()) == (1, 1, (None, (), ()))
    mesh = MeshShape(("pod", "data", "model"), (2, 16, 16))
    ctx.set_axes(mesh, ("pod", "data"), ("model",))
    try:
        assert (ctx.data_size(), ctx.model_size()) == (32, 16)
        assert ctx.mesh_and_axes() == (mesh, ("pod", "data"), ("model",))
        assert ctx.hint(x, ("data", "model")) is x  # a plain tensor keeps its layout
        assert not ctx.is_dtensor(x) and ctx.replicate_like(x, x) is x
        assert ctx.reshape(torch.arange(6), (2, 3)).shape == (2, 3)
    finally:
        ctx.clear()
    assert ctx.mesh_and_axes() == (None, (), ())


def test_mesh_shape_and_world_size(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch import mesh as LM

    assert ctx.mesh_sizes(MeshShape(("data", "model"), (16, 16))) == {"data": 16, "model": 16}
    assert LM.PRODUCTION_MULTI_POD.size == 512
    with pytest.raises(ValueError):
        MeshShape(("data",), (1, 2))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 8 ranks; the process group has 1"):
            LM.make_local_mesh(2, 4, device="cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            LM.make_production_mesh(device="cpu")
        mesh = LM.make_local_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        assert mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()
