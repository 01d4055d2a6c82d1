"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.hlo_analysis``)
against the JAX package's ``repro.launch.dryrun`` on the CPU.

The port's copies of ``tests/test_system.py::{test_input_specs_cover_all_cells,
test_long_context_skips_documented}`` and
``tests/test_pipeline.py::test_hlo_collective_parser`` (on the port's H100
peaks); the port's input specs against the reference's ``batch_specs`` in
shape and dtype for every cell; its parameter counts against the
reference's ``_n_params`` / ``_active_params`` (in a subprocess: the
reference module forces 512 host devices when it is imported); and
``run_cell`` on ``meta`` for qwen2-1.5b's ``train_4k`` and one smoke MoE
cell: status ok, the traced FLOPs between 6 and 8 N_active D plus the
attention's products, and a roofline fraction in (0, 1].

The collectives: the counter on a fake (2, 2) mesh (each redistribution's
kind and per-rank bytes, ``_wrap_tensor_autograd`` not counted); the
meta-kernel memo changing no count; each smoke cell's collective total
nonzero where the reference's is, at a (2, 2) mesh
(``tests/dryrun_parity.py``, the reference in a subprocess); the sLSTM's
extrapolation in T against a direct trace, count for count; and the
process group left as ``run_cell`` found it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.models.model import batch_specs as jax_batch_specs
from repro.configs.registry import get_config as jax_get_config
from repro_torch.configs.base import LM_SHAPES
from repro_torch.configs.registry import ASSIGNED, get_config, smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import input_specs, skip_reason
from repro_torch.launch.hlo_analysis import HW, collective_bytes, roofline

ROOT = Path(__file__).resolve().parents[1]


def test_input_specs_cover_all_cells():
    """Every non-skipped (arch x shape) cell has well-formed input specs."""
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for shape in LM_SHAPES:
            if skip_reason(cfg, shape):
                assert shape.name == "long_500k" and not cfg.sub_quadratic()
                continue
            spec = input_specs(arch, shape.name)
            assert isinstance(spec, dict) and spec
            for v in spec.values():
                assert v.shape[0] == shape.global_batch and v.device.type == "meta"
            if shape.kind == "decode":
                leading = next(iter(spec.values())).shape
                assert leading[1] == 1  # one new token


def test_long_context_skips_documented():
    """Exactly the pure full-attention archs skip long_500k."""
    skipped = {a for a in ASSIGNED if skip_reason(get_config(a), LM_SHAPES[3]) is not None}
    assert skipped == {
        "moonshot-v1-16b-a3b",
        "musicgen-medium",
        "mistral-nemo-12b",
        "qwen2-1.5b",
        "deepseek-coder-33b",
        "granite-8b",
        "chameleon-34b",
    }


def test_hlo_collective_parser():
    text = """
  %ag = bf16[4,1024]{1,0} all-gather(%p0), replica_groups=...
  %ar.1 = f32[256]{0} all-reduce(%x), to_apply=%sum
  %ars = (f32[128]{0}, f32[128]{0}) all-reduce-start(%y, %z)
  %ard = f32[128]{0} all-reduce-done(%ars)
  %cp = u8[64]{0} collective-permute(%w), source_target_pairs=...
  %notacoll = f32[9]{0} add(%a, %b)
"""
    got = collective_bytes(text)
    assert got["all-gather"] == 4 * 1024 * 2
    assert got["all-reduce"] == 256 * 4 + 2 * 128 * 4
    assert got["collective-permute"] == 64
    assert got["total"] == got["all-gather"] + got["all-reduce"] + 64
    r = roofline({"flops": HW["peak_flops"], "bytes accessed": HW["hbm_bw"]}, got, 256,
                 model_flops=HW["peak_flops"] * 256)
    assert abs(r["compute_s"] - 1.0) < 1e-9
    assert abs(r["memory_s"] - 1.0) < 1e-9
    assert abs(r["collective_s"] - got["total"] / HW["link_bw"]) < 1e-12
    assert r["dominant"] in ("compute_s", "memory_s")
    assert abs(r["useful_flops_ratio"] - 1.0) < 1e-9
    assert HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9}  # H100 SXM data sheet


def test_input_specs_equal_reference():
    """The port's input specs equal the reference's ``batch_specs`` in
    shape and dtype, cell by cell."""
    for arch in ASSIGNED:
        for shape in LM_SHAPES:
            if skip_reason(get_config(arch), shape):
                continue
            want = jax_batch_specs(jax_get_config(arch), shape.seq_len, shape.global_batch, shape.kind)
            got = input_specs(arch, shape.name)
            assert sorted(got) == sorted(want), (arch, shape.name)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape), (arch, shape.name, k)
                assert str(got[k].dtype).replace("torch.", "") == str(np.dtype(want[k].dtype)), (arch, shape.name, k)


def test_param_counts_equal_reference():
    """``_n_params`` and ``_active_params`` of every architecture equal the
    reference's, which run in a subprocess (``repro.launch.dryrun`` sets
    512 host devices at import)."""
    code = (
        "import json\n"
        "from repro.configs.registry import ASSIGNED, get_config\n"
        "from repro.launch.dryrun import _n_params, _active_params\n"
        "from repro.models.model import param_specs\n"
        "print(json.dumps({a: [_n_params(param_specs(get_config(a))),\n"
        "                      _active_params(get_config(a), param_specs(get_config(a)))] for a in ASSIGNED}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    for arch in ASSIGNED:
        specs = dryrun.param_specs(get_config(arch))
        assert [dryrun._n_params(specs), dryrun._active_params(get_config(arch), specs)] == want[arch], arch


def _attention_flops(cfg, shape):
    """The torch backend's attention products in a remat train step: q k^T
    and p v over every (row, key) pair (masked ones too, as ``_sdpa``
    forms them), forward, the remat's recompute and the two of the
    backward."""
    return 16.0 * shape.global_batch * cfg.n_heads * shape.seq_len ** 2 * cfg.head_dim * cfg.n_layers


@pytest.mark.parametrize("arch,smoke", [("qwen2-1.5b", False), ("mixtral-8x7b", True)])
def test_run_cell_on_meta(arch, smoke, monkeypatch, tmp_path):
    """``run_cell`` traces the train step on ``meta`` with no card: status
    ok with the reference's record keys, the traced FLOPs between 6 and 8
    N_active D (the remat recompute) plus the attention, a roofline
    fraction in (0, 1], collectives modelled (a train step's gradients
    cross the mesh, so its collective term is positive), memory per card
    from the placements."""
    if smoke:  # the smoke config of an MoE architecture, at the cell's shapes
        monkeypatch.setattr(dryrun, "get_config", lambda name: smoke_config(name))
        rec = dryrun.run_cell(arch, "train_4k", False, verbose=False)
    else:  # the command line: python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k ...
        out = tmp_path / "dryrun.json"
        assert dryrun.main(["--arch", arch, "--shape", "train_4k", "--mesh", "single", "--out", str(out)]) == 0
        rec = json.loads(out.read_text())[f"{arch}|train_4k|single"]
    cfg = dryrun.get_config(arch)
    assert rec["status"] == "ok", rec.get("error")
    assert {"arch", "shape", "mesh", "kind", "n_params", "n_active_params", "lower_s", "compile_s", "memory",
            "cost_raw", "roofline", "status"} <= set(rec)
    shape = LM_SHAPES[0]
    nd = rec["n_active_params"] * shape.seq_len * shape.global_batch
    flops = rec["cost_raw"]["flops"]
    assert 6 * nd <= flops <= 8 * nd + _attention_flops(cfg, shape), flops / nd
    r = rec["roofline"]
    assert 0 < r["roofline_fraction"] <= 1
    assert r["n_chips"] == 256 and r["collective_s"] > 0 and r["extrapolated_from_units"] == []
    assert rec["collectives_modelled"] is True and r["collectives_modelled"] is True
    assert rec["cost_raw"]["collective_bytes"] == r["collective_bytes_per_chip"] == sum(r["collectives"].values())
    assert abs(r["collective_s"] - rec["cost_raw"]["collective_bytes"] / HW["link_bw"]) <= 1e-12
    assert abs(r["hlo_flops_per_chip"] * 256 - flops) <= 1e-6 * flops
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > mem["arguments"]["params"] > 0
    assert mem["arguments"]["params"] < 4 * rec["n_params"]  # sharded over the mesh


def test_main_writes_an_ok_record(tmp_path, capsys):
    """The command line on the CPU writes one record a cell, keeps an ok
    record on a second run and writes the long-context skip: qwen2-1.5b's
    decode cells."""
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--mesh", "both", "--out", str(out)]
    assert dryrun.main(argv) == 0
    recs = json.loads(out.read_text())
    assert {k: r["status"] for k, r in recs.items()} == {"qwen2-1.5b|decode_32k|single": "ok",
                                                        "qwen2-1.5b|decode_32k|multi": "ok"}
    assert "roofline" in recs["qwen2-1.5b|decode_32k|single"] and "roofline" not in recs["qwen2-1.5b|decode_32k|multi"]
    assert recs["qwen2-1.5b|decode_32k|multi"]["mesh"] == "2x16x16"
    assert dryrun.main(argv) == 0  # both kept, nothing traced again
    assert "dry-run: 2 ok, 0 skipped (documented), 0 errors" in capsys.readouterr().out
    assert dryrun.run_cell("qwen2-1.5b", "long_500k", False, verbose=False)["status"] == "skipped"


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------
def _placements(name):
    from torch.distributed.tensor import Partial, Replicate, Shard

    return {"S0": [Shard(0), Replicate()], "P": [Partial(), Replicate()], "R": [Replicate(), Replicate()]}[name]


@pytest.mark.parametrize("src,dst,kind,numel", [("S0", "R", "all-gather", 8 * 6), ("P", "R", "all-reduce", 8 * 6),
                                                ("P", "S0", "reduce-scatter", 4 * 6)])
def test_collective_counter_on_a_fake_mesh(src, dst, kind, numel):
    """A redistribution of a known ``meta`` DTensor (global (8, 6) float32
    on a (2, 2) mesh) counts its kind at the per-rank result bytes: the
    full tensor for a gather or a reduction to Replicate, one shard for a
    reduce-scatter.  ``_wrap_tensor_autograd`` is dispatched beside it
    with the same bytes and is not counted."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.mesh import MeshShape

    seen = []

    class Names(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.name())
            return func(*args, **(kwargs or {}))

    with dryrun._fake_world(MeshShape(("data", "model"), (2, 2))) as mesh:
        local = torch.empty((4, 6) if src == "S0" else (8, 6), device="meta")
        x = DTensor.from_local(local, mesh, _placements(src), run_check=False)
        count = dryrun._CollectiveBytes()
        with count, Names():
            y = x.redistribute(mesh, _placements(dst))
        assert y.shape == (8, 6) and y.to_local().is_meta
    assert count.bytes == {**dict.fromkeys(count.bytes, 0), kind: numel * 4}
    assert "_c10d_functional::_wrap_tensor_autograd" in seen


@pytest.mark.parametrize("arch,kind", [("qwen2-1.5b", "train"), ("zamba2-2.7b", "train"), ("mixtral-8x7b", "prefill"),
                                       ("xlstm-125m", "train"), ("musicgen-medium", "decode")])
def test_meta_kernel_memo_changes_no_count(arch, kind, monkeypatch):
    """The trace's FLOPs and bytes with each op's meta kernel memoised per
    signature (``_MetaMode``) equal those with every kernel run."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs.base import ShapeSpec

    shape = ShapeSpec("s", 64, 4, kind)
    cfg = smoke_config(arch)
    got = dryrun._trace_cell(cfg, shape)

    class Runs(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(dryrun, "_MetaMode", Runs)
    assert dryrun._trace_cell(cfg, shape) == got


def test_meta_kernel_memo_replays_only_meta_outputs():
    """An op is replayed from the memo only where it gave ``meta``
    tensors: a factory op on the CPU (DTensor's shard offsets) keeps its
    values on every call; a meta op's replay has the first output's shape
    and strides in fresh storage."""
    with dryrun._MetaMode():
        first, again = torch.arange(4), torch.arange(4)
        x = torch.empty((3, 5), device="meta")
        a, b = x.t().contiguous(), x.t().contiguous()
    assert first.tolist() == again.tolist() == [0, 1, 2, 3]
    assert b.is_meta and b.shape == a.shape and b.stride() == a.stride()
    assert b.untyped_storage()._cdata != a.untyped_storage()._cdata


@pytest.fixture(scope="module")
def reference_collectives():
    from dryrun_parity import reference_collectives as ref

    return ref()


@pytest.mark.parametrize("arch,kind", [(a, k) for a in ("qwen2-1.5b", "mixtral-8x7b") for k in ("train", "prefill",
                                                                                                  "decode")])
def test_collectives_nonzero_where_the_reference_has_them(reference_collectives, arch, kind):
    """At a (2, 2) mesh, smoke config, T = 64, B = 4: the port's sharded
    step moves data between ranks where the reference's partitioned HLO
    does.  The kinds need not match (XLA on the CPU all-reduces the
    gradients where the port's ZeRO-1 step reduce-scatters them); the
    tables of both sides are in PERF.md (``tests/dryrun_parity.py``)."""
    from dryrun_parity import port_collectives

    ref = reference_collectives[f"{arch}|{kind}"]["kinds"]
    got = port_collectives(arch, kind)["kinds"]
    assert ref["total"] > 0
    assert got["total"] > 0, (got, ref)
    assert set(got) == set(ref)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_slstm_extrapolation_equals_a_direct_trace(kind, monkeypatch):
    """xlstm-125m's smoke config at T = 1,024 (B 4, a (2, 2) mesh): the
    step without the sLSTM at 1,024 plus the sLSTM's share extrapolated
    from ``SLSTM_PROBE`` gives the direct trace's FLOPs, bytes and bytes
    of each collective kind exactly; ``run_cell`` records the probe."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import MeshShape

    cfg, shape = smoke_config("xlstm-125m"), ShapeSpec("s", 1024, 4, kind)
    mesh = MeshShape(("data", "model"), (2, 2))
    got, probe = dryrun._counts(cfg, shape, mesh, {})
    assert probe == list(dryrun.SLSTM_PROBE)
    want = dryrun._cell_counts(cfg, shape, mesh, {})
    assert got == want
    assert got["flops"] > 0 and got["bytes"] > 0 and sum(got[k] for k in dryrun._COLL) > 0


def test_slstm_extrapolation_refuses_where_inexact():
    """A T off the probe's step, or a unit of sLSTM blocks alone, is
    refused with the reason; decode cells are traced directly."""
    import dataclasses

    from repro_torch.configs.base import ShapeSpec

    cfg = smoke_config("xlstm-125m")
    with pytest.raises(ValueError, match="not a multiple"):
        dryrun._extrapolation(cfg, ShapeSpec("s", 1000, 4, "train"))
    with pytest.raises(ValueError, match="sLSTM blocks alone"):
        dryrun._extrapolation(dataclasses.replace(cfg, unit=("slstm",), n_layers=1), ShapeSpec("s", 1024, 4, "train"))
    assert dryrun._extrapolation(cfg, ShapeSpec("s", 1024, 4, "decode")) is None
    assert dryrun._extrapolation(smoke_config("qwen2-1.5b"), ShapeSpec("s", 1024, 4, "train")) is None


def test_run_cell_leaves_the_process_group_as_it_found_it(monkeypatch, tmp_path):
    """With no process group, ``run_cell`` makes its fake one and destroys
    it; with one initialised, the cell fails with the reason and the group
    stays."""
    import torch.distributed as dist

    monkeypatch.setattr(dryrun, "get_config", lambda name: smoke_config(name))
    assert not dist.is_initialized()
    rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", False, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["collectives_modelled"] and rec["cost_raw"]["collective_bytes"] > 0
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", False, verbose=False)
        assert rec["status"] == "error" and "process group" in rec["error"]
        assert dist.is_initialized() and dist.group.WORLD is group and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
