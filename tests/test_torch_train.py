"""The port's training loop (``repro_torch.launch.train``) against the JAX
package's ``repro.launch.train`` on the CPU, at the registry's smoke sizes.

Weights come from the reference's ``init_params`` and are carried across
with ``repro_torch.convert.lm_params_from_reference``; the parity checks
run both packages in float32 (the smoke configs' bf16 rounds at other
places in the two frameworks).  Tolerances: ``synthetic_batch`` exact;
``loss_fn``'s gradient within 1e-4 of each leaf's largest |g| plus 1e-7
(the frameworks sum in other orders); six AdamW steps' losses within
1e-5 relative and parameters within 1e-4 (AdamW divides each update by
sqrt(v), so a gradient's rounding reaches the parameters scaled by the
learning rate, not by the gradient).  Then the reference's own training
checks (``tests/test_checkpoint_ft.py``) on the port: a resume that is
bit-exact on the CPU, and compressed training that converges.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.launch import train as JT
from repro.models import model as JM
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.distributed.checkpoint import latest_step
from repro_torch.distributed.optimizer import AdamWConfig, adamw_init
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import train as T
from repro_torch.models import layers as L
from repro_torch.models import model as M

STEPS, BATCH, SEQ = 6, 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    """The reference's and the port's float32 smoke configs of ``name``."""
    return tuple(dataclasses.replace(smoke(name), dtype="float32") for smoke in (jax_smoke_config, smoke_config))


def _each_leaf(fn, got, want, path=""):
    """``fn(got_leaf, want_leaf, path)`` over the leaves of two trees."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        for k in got:
            _each_leaf(fn, got[k], want[k], f"{path}/{k}")
    else:
        fn(got, np.asarray(want, dtype=np.float32), path)


def _leaf_close(got: torch.Tensor, want: np.ndarray, what: str):
    """Within 1e-4 of the leaf's largest |g|, plus 1e-7."""
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    tol = 1e-4 * float(np.abs(want).max()) + 1e-7
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_synthetic_batch_equals_reference(name):
    cfg = smoke_config(name)
    for step in (0, 5):
        want = JT.synthetic_batch(jax_smoke_config(name), BATCH, SEQ, step)
        got = T.synthetic_batch(cfg, BATCH, SEQ, step, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == getattr(torch, str(w.dtype)) and np.array_equal(got[k].numpy(), w), (name, k)


@pytest.mark.parametrize("backend", L.BACKENDS)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_gradient_matches_jax_grad(name, backend):
    cfg_j, cfg = _cfgs(name)
    pj = JM.init_params(cfg_j, jax.random.key(1))
    bj = JT.synthetic_batch(cfg_j, BATCH, SEQ, 2)
    want = jax.jit(jax.grad(lambda p_, b_: JM.loss_fn(p_, b_, cfg_j)))(pj, bj)
    p = lm_params_from_reference(pj, cfg, device="cpu")
    leaves = [a.requires_grad_() for a in M.tree_leaves(p)]
    batch = {k: torch.from_numpy(np.array(v)) for k, v in bj.items()}
    loss = M.loss_fn(p, batch, cfg, remat=True, attn_backend=backend)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = [torch.zeros_like(a) if g is None else g for a, g in zip(leaves, got)]
    it = iter(got)
    got_tree = M.tree_map(lambda _: next(it), p)
    _each_leaf(lambda g, w, path: _leaf_close(g, w, f"{name} {backend} {path}"), got_tree, want)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "zamba2-2.7b"])
def test_windowed_loss_gradient_matches_jax_grad(name):
    """``loss_fn``'s gradient on the kernel backend at T = 64, past the
    smoke configs' window of 32, so that the window masks keys in both the
    forward and the backward: equal to ``jax.grad`` of the reference's."""
    cfg_j, cfg = _cfgs(name)
    assert cfg.attn_window == 32
    pj = JM.init_params(cfg_j, jax.random.key(3))
    bj = JT.synthetic_batch(cfg_j, BATCH, 64, 1)
    want = jax.jit(jax.grad(lambda p_, b_: JM.loss_fn(p_, b_, cfg_j)))(pj, bj)
    p = lm_params_from_reference(pj, cfg, device="cpu")
    leaves = [a.requires_grad_() for a in M.tree_leaves(p)]
    batch = {k: torch.from_numpy(np.array(v)) for k, v in bj.items()}
    loss = M.loss_fn(p, batch, cfg, remat=True, attn_backend="kernel")
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(a) if g is None else g for a, g in zip(leaves, got)])
    got_tree = M.tree_map(lambda _: next(it), p)
    _each_leaf(lambda g, w, path: _leaf_close(g, w, f"{name} window {path}"), got_tree, want)


_REF_RUN = {}


def _reference_run():
    """The reference's ``train_loop`` over STEPS steps (qwen2-1.5b smoke in
    float32), once: its parameters and losses."""
    if not _REF_RUN:
        cfg_j, _ = _cfgs("qwen2-1.5b")
        p_ref, losses = JT.train_loop(cfg_j, steps=STEPS, batch=BATCH, seq=SEQ, ckpt_dir=None, verbose=False)
        _REF_RUN["run"] = (jax.tree_util.tree_map(np.asarray, p_ref), losses)
    return _REF_RUN["run"]


def _params_close(got, want):
    _each_leaf(lambda g, w, path: np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-4,
                                                             err_msg=path), got, want)


def test_train_steps_match_reference_train_loop():
    """STEPS steps of the port's ``make_train_step`` from the reference's
    initial weights give the reference ``train_loop``'s losses and
    parameters; the kernel backend's attention runs on its plain version
    on the CPU (no launch)."""
    cfg_j, cfg = _cfgs("qwen2-1.5b")
    p_ref, losses_ref = _reference_run()
    params = lm_params_from_reference(JM.init_params(cfg_j, jax.random.key(0)), cfg, device="cpu")
    opt = adamw_init(params)
    step_fn = T.make_train_step(cfg, AdamWConfig(lr=1e-3))
    before = (fa_ops.launches, fa_ops.bwd_launches)
    losses = []
    for step in range(STEPS):
        params, opt, loss, gn = step_fn(params, opt, T.synthetic_batch(cfg, BATCH, SEQ, step, device="cpu"))
        assert loss.shape == () and gn.shape == () and bool(torch.isfinite(gn))
        losses.append(float(loss))
    assert (fa_ops.launches, fa_ops.bwd_launches) == before
    assert int(opt["step"]) == STEPS
    np.testing.assert_allclose(losses, losses_ref, rtol=1e-5)
    _params_close(params, p_ref)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the reference's ``train_loop`` wrote at step 3 is
    resumed by the port's ``train_loop``, which reaches the reference's
    step-6 losses and parameters."""
    cfg_j, cfg = _cfgs("qwen2-1.5b")
    p_ref, losses_ref = _reference_run()
    ck = str(tmp_path / "ck")
    JT.train_loop(cfg_j, steps=3, batch=BATCH, seq=SEQ, ckpt_dir=ck, ckpt_every=3, verbose=False)
    assert latest_step(ck) == 3
    params, losses = T.train_loop(cfg, steps=STEPS, batch=BATCH, seq=SEQ, ckpt_dir=ck, ckpt_every=3,
                                  verbose=False, device="cpu")
    assert latest_step(ck) == STEPS
    np.testing.assert_allclose(losses, losses_ref[3:], rtol=1e-5)
    _params_close(params, p_ref)


def test_launcher_on_the_cpu(capsys):
    losses = T.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "3", "--batch", "2", "--seq", "40",
                     "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "final loss:" in capsys.readouterr().out


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.synthetic_batch(smoke_config("qwen2-1.5b"), 1, 4, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.train_loop(smoke_config("qwen2-1.5b"), steps=1, batch=1, seq=4, verbose=False)


# the reference's tests/test_checkpoint_ft.py on the port


def _tree_equal(a, b):
    """Bit-equal leaves, matched by key."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_tree_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_failure_injection_bit_exact_resume(tmp_path):
    """Kill training at step 6/12 (simulated), resume from the last
    committed checkpoint, and reach identical final state."""
    cfg = smoke_config("qwen2-1.5b")
    opt_cfg = AdamWConfig(lr=1e-3)
    ck = str(tmp_path / "ck")
    p_ref, _ = T.train_loop(cfg, steps=12, batch=2, seq=16, ckpt_dir=None, opt_cfg=opt_cfg, verbose=False,
                            device="cpu")
    T.train_loop(cfg, steps=6, batch=2, seq=16, ckpt_dir=ck, ckpt_every=3, opt_cfg=opt_cfg, verbose=False,
                 device="cpu")
    assert latest_step(ck) == 6
    p_res, _ = T.train_loop(cfg, steps=12, batch=2, seq=16, ckpt_dir=ck, ckpt_every=3, opt_cfg=opt_cfg,
                            verbose=False, device="cpu")
    assert _tree_equal(p_ref, p_res)


def test_compressed_training_converges():
    cfg = smoke_config("qwen2-1.5b")
    _, losses = T.train_loop(cfg, steps=8, batch=2, seq=16, ckpt_dir=None,
                             opt_cfg=AdamWConfig(lr=1e-3, compress=True), verbose=False, device="cpu")
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_smoke_forward_loss_grad():
    """tests/test_models.py::test_smoke_forward_loss_grad's gradient on the
    port's own weights, through one train step: finite, nonzero, and the
    step moves the weights."""
    cfg = smoke_config("qwen2-1.5b")
    params = M.init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    new, _, loss, gn = T.make_train_step(cfg, AdamWConfig(lr=1e-3))(
        params, opt, T.synthetic_batch(cfg, 2, 16, 0, device="cpu"))
    assert np.isfinite(float(loss)) and float(gn) > 0
    assert not _tree_equal(params, new)
