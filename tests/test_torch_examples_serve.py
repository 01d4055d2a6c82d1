"""``repro_torch.examples.serve_lm`` against the JAX package's
``generate`` at the script's batch (8), prompt (12), new tokens (24) and
cache (48), for both of its architectures, with the reference's weights
carried across (``lm_params_from_reference``) and both smoke configs in
float32, as ``tests/test_torch_decode_lm.py`` holds the launcher: the
same greedy tokens, the prompt kept.  Then all five examples' mains at
tiny flags on the CPU in a fresh interpreter, which imports neither jax
nor the JAX package."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.launch.decode_lm import generate as jax_generate
from repro.models import model as JM
from repro_torch.configs.registry import smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.examples import serve_lm
from tests.examples_parity import ROOT, TINY_FLAGS, no_jax_script

BATCH, PROMPT, GEN, CACHE = 8, 12, 24, 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", serve_lm.ARCHS)
def test_tokens_equal_reference(arch, capsys):
    cfg_j = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    pj = JM.init_params(cfg_j, jax.random.key(0))
    got = serve_lm.serve(arch, cfg, lm_params_from_reference(pj, cfg, device="cpu"), BATCH, PROMPT, GEN, CACHE)
    printed = capsys.readouterr().out
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    want = jax_generate(cfg_j, pj, prompts, gen=GEN, cache_len=CACHE)
    np.testing.assert_array_equal(got["prompts"], prompts)
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["shape"] == (BATCH, PROMPT + GEN) == want.shape
    assert printed.startswith(f"{arch:12s} served batch ({BATCH}, {PROMPT + GEN}) in ")


def test_main_serves_both_archs_at_their_dtype(capsys):
    got = serve_lm.main(["--batch", "2", "--prompt", "3", "--gen", "2", "--cache", "6", "--device", "cpu"])
    assert list(got) == list(serve_lm.ARCHS)
    for arch, row in got.items():
        assert smoke_config(arch).dtype == "bfloat16"
        assert row["shape"] == (2, 5) and (row["tokens"][:, :3] == row["prompts"]).all()
    assert len(capsys.readouterr().out.splitlines()) == 2


def test_examples_import_neither_jax_nor_repro(tmp_path):
    """All five mains at tiny flags on the CPU in a fresh interpreter,
    then no jax and no ``repro`` module in ``sys.modules``."""
    calls = [(name, flags + ["--device", "cpu"]) for name, flags in TINY_FLAGS]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-c", no_jax_script(calls)],
        capture_output=True,
        text=True,
        env=env,
        cwd=str(tmp_path),
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.rstrip().endswith("ok")
    assert (tmp_path / "traces" / "sharded_mine.trace.json").is_file()
