"""The port's LM serving launcher (``repro_torch.launch.decode_lm``) against
the JAX package's ``repro.launch.decode_lm`` on the CPU: greedy tokens
equal to the reference's ``generate`` with the same weights (float32
smoke configs; mixtral with room in its experts, so that no token drops
in either the prompt's or a step's dispatch), one device→host copy a
step, and the command line."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.launch import decode_lm as JD
from repro.models import model as JM
from repro_torch.configs.registry import smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import decode_lm as D
from repro_torch.models import model as M

ARCHS = ["qwen2-1.5b", "mixtral-8x7b", "zamba2-2.7b", "xlstm-125m", "chameleon-34b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    out = []
    for smoke in (jax_smoke_config, smoke_config):
        cfg = dataclasses.replace(smoke(name), dtype="float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
        out.append(cfg)
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_generate_equals_reference(name, monkeypatch):
    cfg_j, cfg = _cfgs(name)
    pj = JM.init_params(cfg_j, jax.random.key(0))
    p = lm_params_from_reference(pj, cfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (3, 6)).astype(np.int32)
    gen, cache_len = 8, 15
    want = JD.generate(cfg_j, pj, prompt, gen, cache_len)
    fetches = []
    real = D.to_host
    monkeypatch.setattr(D, "to_host", lambda t: fetches.append(t.shape) or real(t))
    got = D.generate(cfg, p, prompt, gen, cache_len)
    assert got.dtype == np.int32 and got.shape == (3, 6 + gen)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :6], prompt)
    assert fetches == [(3,)] * (gen + 1)  # the prompt's last step, then each generated step


def test_generate_runs_in_inference_mode(monkeypatch):
    _, cfg = _cfgs("qwen2-1.5b")
    p = M.init_params(cfg, 0, device="cpu")
    seen = []
    real = D.decode_step
    monkeypatch.setattr(D, "decode_step", lambda *a: seen.append(torch.is_inference_mode_enabled()) or real(*a))
    D.generate(cfg, p, np.zeros((1, 2), np.int32), 2, 5)
    assert seen == [True] * 4


def test_main_on_cpu(capsys):
    toks = D.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--batch", "2",
                   "--prompt-len", "4", "--gen", "3"])
    out = capsys.readouterr().out
    assert toks.shape == (2, 7) and "generated (2, 7) in" in out and "tok/s) on cpu" in out
    with pytest.raises(SystemExit, match="audio stub"):
        D.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            D.main(["--arch", "qwen2-1.5b", "--smoke"])
