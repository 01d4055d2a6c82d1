"""The recurrent mixers (Mamba2, mLSTM, sLSTM) and the torch attention
backend on a mesh, against the port's plain path on the CPU.

On DTensors a mixer runs data-parallel on each rank's batch rows through
``local_map`` (``models.blocks._mesh_mixer``: its weights, and in decode
its state, gathered over model), and either attention backend runs each
rank's heads under the kernels' placements (``models.layers._mesh_attention``).
The port runs as 4 gloo ranks on a (2, 2) ``("data", "model")`` mesh,
spawned in one subprocess for the module (a ``FileStore`` under the
test's temporary directory; one torch thread a rank), on the smoke
configs of xlstm-125m (mLSTM + sLSTM), zamba2-2.7b (Mamba2 + the shared
windowed attention, both backends) and qwen2-1.5b (the torch backend),
in float32.

Bounds are ``tests/test_torch_distributed.py``'s: a sharded step's loss
within 1e-4, gradient norm within 1e-4 relative and parameters within
5e-3 of the plain step's; the prefill's logits and 3 decode steps on a
mesh-placed cache within 1e-4 of the plain path's.
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

CASES = [("xlstm-125m", "kernel"), ("zamba2-2.7b", "kernel"), ("zamba2-2.7b", "torch"), ("qwen2-1.5b", "torch")]

PORT = r"""
import dataclasses, json, os, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CASES = %s


def run(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    from repro_torch.configs.registry import smoke_config
    from repro_torch.distributed import ctx
    from repro_torch.distributed.optimizer import AdamWConfig, _leaves, adamw_init
    from repro_torch.distributed.sharding import cache_sharding, distribute_tree, mesh_axes, placement_tree
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M

    mesh = make_local_mesh(2, 2, device="cpu")
    axes = mesh_axes(mesh)
    ocfg = AdamWConfig(lr=1e-3)
    out = {}
    for arch, backend in CASES:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        params = M.init_params(cfg, 0, device="cpu")
        batch = T.synthetic_batch(cfg, 4, 64, 0, "cpu")
        p1, _, l1, g1 = T.make_train_step(cfg, ocfg)(params, adamw_init(params), batch)
        ps, os_ = T.place_state(mesh, params, adamw_init(params))
        p2, _, l2, g2 = T.make_sharded_train_step(cfg, ocfg, mesh, attn_backend=backend)(ps, os_, T.place_batch(mesh, batch))
        diff = max(float((a - b.full_tensor()).abs().max()) for a, b in zip(_leaves(p1), _leaves(p2)))
        r = {"loss_plain": float(l1), "loss_sharded": float(l2), "grad_norm_plain": float(g1),
             "grad_norm_sharded": float(g2), "param_diff": diff,
             "placements_kept": all(a.placements == b.placements for a, b in zip(_leaves(ps), _leaves(p2)))}
        # prefill: the logits of a forward on placed params and batch
        p_pl, _ = T.state_placements(mesh, params)
        pd = distribute_tree(params, p_pl, mesh)
        plain_logits, _ = M.forward(params, batch, cfg, attn_backend=backend)
        ctx.set_axes(mesh, *axes)
        logits, _ = M.forward(pd, T.place_batch(mesh, batch), cfg, attn_backend=backend)
        r["prefill_err"] = float((logits.full_tensor() - plain_logits).abs().max())
        # decode: 3 steps on a cache placed by cache_sharding
        toks = batch["tokens"]
        plain_cache = M.cache_init(cfg, 4, 16, device="cpu")
        plain = [M.decode_step(params, plain_cache, {"tokens": toks[:, i:i + 1]}, cfg)[0] for i in range(3)]
        c_specs = cache_sharding(mesh, M.cache_specs(cfg, 4, 16))
        cache = distribute_tree(M.cache_init(cfg, 4, 16, device="cpu"), placement_tree(mesh, c_specs), mesh)
        got = []
        for i in range(3):
            tok = distribute_tree({"tokens": toks[:, i:i + 1]}, placement_tree(mesh, {"tokens": (axes[0], None)}), mesh)
            got.append(M.decode_step(pd, cache, tok, cfg)[0].full_tensor())
        ctx.clear()
        r["decode_err"] = max(float((a - b).abs().max()) for a, b in zip(got, plain))
        r["cache_err"] = max(float((a.full_tensor() - b).abs().max())
                             for a, b in zip(M.tree_leaves(cache), M.tree_leaves(plain_cache)))
        out[f"{arch}|{backend}"] = r
    if rank == 0:
        print("RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(4, os.path.join(sys.argv[1], "store")), nprocs=4)
""" % repr(CASES)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("mixers"))
    path = os.path.join(out_dir, "job.py")
    with open(path, "w") as f:
        f.write(PORT)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_OPTS", None)
    res = subprocess.run([sys.executable, path, out_dir], capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("arch,backend", CASES)
def test_sharded_step_matches_plain_step(mesh_run, arch, backend):
    r = mesh_run[f"{arch}|{backend}"]
    assert abs(r["loss_plain"] - r["loss_sharded"]) < 1e-4, r
    assert abs(r["grad_norm_plain"] - r["grad_norm_sharded"]) <= 1e-4 * r["grad_norm_plain"], r
    assert r["param_diff"] < 5e-3, r
    assert r["placements_kept"], r


@pytest.mark.parametrize("arch,backend", CASES)
def test_sharded_prefill_and_decode_match_plain(mesh_run, arch, backend):
    r = mesh_run[f"{arch}|{backend}"]
    assert r["prefill_err"] < 1e-4, r
    assert r["decode_err"] < 1e-4, r
    assert r["cache_err"] < 1e-4, r
