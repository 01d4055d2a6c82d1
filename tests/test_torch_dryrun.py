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
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

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
    fraction in (0, 1], collectives not modelled, memory per card from the
    placements."""
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
    assert r["n_chips"] == 256 and r["collective_s"] == 0 and r["extrapolated_from_units"] == []
    assert rec["collectives_modelled"] is False and r["collectives_modelled"] is False
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
