"""The port's mesh (``repro_torch.launch.mesh``, ``distributed.sharding``,
``distributed.ctx``, the sharded train step, elastic restore, the
expert-parallel MoE, the R-row dispatch and decode on a mesh-placed
cache) against the port's plain path and the JAX package's mesh, on the
CPU.

The port runs as 8 gloo ranks on a (2, 4) ``("data", "model")`` mesh,
spawned in one subprocess for the module (a ``FileStore`` under the test's
temporary directory; one torch thread a rank).  The reference runs in its
own subprocesses on 8 forced host devices over a mesh with ``Auto`` axes
(jax 0.9's ``make_mesh`` defaults to ``Explicit`` ones, on which the
reference's own ``tests/test_distributed.py`` and ``tests/test_moe_ep.py``
fail), on the inputs of those two tests: qwen2's smoke config, a (8, 16)
batch, ``AdamWConfig(lr=1e-3)``; mixtral's smoke config in float32 at
capacity factor 32.

Bounds are the reference tests' own: a sharded step's loss within 1e-4
and parameters within 5e-3 (one AdamW step moves each parameter by about
the learning rate, so the gradient norm is held too, within 1e-4
relative) in float32; in bf16, where each rank rounds its partial
products before they are summed, the sharded step's loss and gradient
norm lie no farther from the float32 step's than the plain bf16 step's
do (and parameters within 5e-3); checkpoints restore exactly; EP MoE within 2e-4, expert-TP
within 1e-3, aux within 5e-3.  The R = 2 dispatch, which drops tokens at
the default capacity, is within 1e-5 of the reference's, relative to the
output's largest magnitude (about 210), and its aux loss within 1e-5; 4 decode steps
on a mesh-placed cache within 1e-4 of unsharded decode.  Port against
reference runs in float32 (bf16 rounds at other places in the two
frameworks).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REF_STEP = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs.registry import smoke_config
from repro.distributed import ctx
from repro.distributed.checkpoint import save_checkpoint
from repro.distributed.optimizer import AdamWConfig, adamw_init, adamw_update
from repro.distributed.sharding import batch_sharding, param_sharding, zero1_sharding
from repro.models.layers import moe_apply, moe_apply_shard_map, moe_init
from repro.models.model import init_params, loss_fn, param_specs

out_dir = sys.argv[1]
auto = (jax.sharding.AxisType.Auto,) * 2
flat = lambda tree, pre: {pre + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf, np.float32)
                         for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
arrays, out = {}, {}

cfg = dataclasses.replace(smoke_config("qwen2-1.5b"), dtype="float32")
params = init_params(cfg, jax.random.key(0))
opt = adamw_init(params)
ocfg = AdamWConfig(lr=1e-3)
rng = np.random.default_rng(0)
batch = {
    "tokens": jnp.asarray(rng.integers(0, cfg.vocab, (8, 16)), jnp.int32),
    "labels": jnp.asarray(rng.integers(0, cfg.vocab, (8, 16)), jnp.int32),
}

def train_step(params, opt, batch):
    loss, grads = jax.value_and_grad(loss_fn)(params, batch, cfg)
    p2, o2, gn = adamw_update(params, grads, opt, ocfg)
    return p2, o2, loss, gn

mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=auto)
p_specs = param_specs(cfg)
p_sh = param_sharding(mesh, p_specs)
b_sh = batch_sharding(mesh, jax.eval_shape(lambda: batch))
o_sh = {"m": zero1_sharding(mesh, p_specs, p_sh), "v": zero1_sharding(mesh, p_specs, p_sh),
        "step": NamedSharding(mesh, P())}
put = lambda tree, sh: jax.tree_util.tree_map(jax.device_put, tree, sh)
p_shd, o_shd, loss_shd, gn_shd = jax.jit(
    train_step, in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, None, None)
)(put(params, p_sh), put(opt, o_sh), put(batch, b_sh))
out["loss"], out["grad_norm"] = float(loss_shd), float(gn_shd)
arrays.update(flat(params, "init/"))
arrays.update(flat(jax.device_get(p_shd), "stepped/"))
arrays["tokens"], arrays["labels"] = np.asarray(batch["tokens"]), np.asarray(batch["labels"])
save_checkpoint(os.path.join(out_dir, "ck_ref"), 1, p_shd)

# EP and expert-TP MoE (tests/test_moe_ep.py's inputs)
mcfg = dataclasses.replace(smoke_config("mixtral-8x7b"), dtype="float32")
mcfg = dataclasses.replace(mcfg, moe=dataclasses.replace(mcfg.moe, capacity_factor=32.0))
mp_ = moe_init(jax.random.key(0), mcfg)
x = jnp.asarray(np.random.default_rng(0).normal(size=(32, mcfg.d_model)).astype(np.float32))
mcfg2 = dataclasses.replace(mcfg, moe=dataclasses.replace(mcfg.moe, n_experts=2, top_k=1))
mp2 = moe_init(jax.random.key(1), mcfg2)
ctx.set_axes(mesh, ("data",), ("model",))
y_ep, aux_ep = jax.jit(lambda p, x: moe_apply_shard_map(p, x, mcfg))(mp_, x)
y_tp, aux_tp = jax.jit(lambda p, x: moe_apply_shard_map(p, x, mcfg2))(mp2, x)
# the R-row dispatch at the default capacity: R = 2 rows, tokens drop
dcfg = dataclasses.replace(smoke_config("mixtral-8x7b"), dtype="float32")
y_r2, aux_r2 = jax.jit(lambda p, x: moe_apply(p, x, dcfg))(mp_, x)
ctx.clear()
y_r1, _ = moe_apply(mp_, x, dcfg)
arrays.update(flat(mp_, "moe/"))
arrays.update(flat(mp2, "moe_tp/"))
arrays.update({"moe_x": np.asarray(x), "y_ep": np.asarray(y_ep), "y_tp": np.asarray(y_tp),
               "y_r2": np.asarray(y_r2), "y_r1": np.asarray(y_r1)})
out.update({"aux_ep": float(aux_ep), "aux_tp": float(aux_tp), "aux_r2": float(aux_r2)})
np.savez(os.path.join(out_dir, "ref.npz"), **arrays)
print("RESULT " + json.dumps(out))
"""

REF_RESTORE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import numpy as np
import jax
from repro.configs.registry import smoke_config
from repro.distributed.checkpoint import restore_checkpoint
from repro.distributed.sharding import param_sharding
from repro.models.model import init_params, param_specs

out_dir = sys.argv[1]
cfg = dataclasses.replace(smoke_config("qwen2-1.5b"), dtype="float32")
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
restored, step, _ = restore_checkpoint(os.path.join(out_dir, "ck_port"), init_params(cfg, jax.random.key(0)),
                                       shardings=param_sharding(mesh, param_specs(cfg)))
want = np.load(os.path.join(out_dir, "port_saved.npz"))
diff = 0.0
for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(restored))[0]:
    key = "/".join(str(getattr(k, "key", k)) for k in path)
    diff = max(diff, float(np.abs(np.asarray(leaf) - want[key]).max()))
print("RESULT " + json.dumps({"restore_diff": diff, "restore_step": step}))
"""

PORT = r"""
import dataclasses, json, os, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def unflatten(npz, prefix):
    tree = {}
    for key in npz.files:
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = npz[key]
    return tree


def run(rank, world, out_dir, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    from repro_torch.configs.registry import smoke_config
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.distributed import ctx
    from repro_torch.distributed.checkpoint import gather_tree, restore_checkpoint, save_checkpoint
    from repro_torch.distributed.optimizer import AdamWConfig, _leaves, adamw_init
    from repro_torch.distributed.sharding import cache_sharding, distribute_tree, mesh_axes, placement_tree
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    out = {}
    ref = np.load(os.path.join(out_dir, "ref.npz"))
    mesh = make_local_mesh(2, 4, device="cpu")
    axes = mesh_axes(mesh)
    batch = {"tokens": torch.from_numpy(ref["tokens"].astype(np.int32)),
             "labels": torch.from_numpy(ref["labels"].astype(np.int32))}
    ocfg = AdamWConfig(lr=1e-3)
    base = smoke_config("qwen2-1.5b")
    maxdiff = lambda a, b: max(float((x - y).abs().max()) for x, y in zip(a, b))

    # the sharded step against the plain step (float32 and the smoke config's bf16), and
    # against the reference's sharded step (float32)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        params = lm_params_from_reference(unflatten(ref, "init/"), cfg, device="cpu")
        opt = adamw_init(params)
        p1, _, l1, g1 = T.make_train_step(cfg, ocfg)(params, opt, batch)
        ps, os_ = T.place_state(mesh, params, opt)
        p2, o2, l2, g2 = T.make_sharded_train_step(cfg, ocfg, mesh)(ps, os_, T.place_batch(mesh, batch))
        full = [a.full_tensor() for a in _leaves(p2)]
        row = {"loss_plain": float(l1), "loss_sharded": float(l2), "grad_norm_plain": float(g1),
               "grad_norm_sharded": float(g2), "param_diff_plain": maxdiff(full, _leaves(p1)),
               "placements_kept": all(a.placements == b.placements for a, b in zip(_leaves(p2), _leaves(ps)))
               and all(a.placements == b.placements for a, b in zip(_leaves(o2["m"]), _leaves(os_["m"])))
               and all(a.placements == b.placements for a, b in zip(_leaves(o2["v"]), _leaves(os_["v"])))}
        if dtype == "float32":
            want = lm_params_from_reference(unflatten(ref, "stepped/"), cfg, device="cpu")
            row["param_diff_ref"] = maxdiff(full, _leaves(want))
            stepped = p2
        out[dtype] = row

    # a MoE model's sharded step through either dispatch (no drops, no aux: the
    # shard_map's aux is a per-shard estimate), against its plain step
    moe = dataclasses.replace(smoke_config("mixtral-8x7b"), dtype="float32")
    moe = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe, capacity_factor=32.0, router_aux_weight=0.0))
    mparams = M.init_params(moe, 0, device="cpu")
    for flag in ("moe_shard_map", "no_moe_shard_map"):
        os.environ["REPRO_OPTS"] = flag
        mopt = adamw_init(mparams)
        p1, _, l1, g1 = T.make_train_step(moe, ocfg)(mparams, mopt, batch)
        ps, os_ = T.place_state(mesh, mparams, mopt)
        p2, _, l2, g2 = T.make_sharded_train_step(moe, ocfg, mesh)(ps, os_, T.place_batch(mesh, batch))
        out["moe_step_" + flag] = {"loss_plain": float(l1), "loss_sharded": float(l2), "grad_norm_plain": float(g1),
                                   "grad_norm_sharded": float(g2),
                                   "param_diff_plain": maxdiff([a.full_tensor() for a in _leaves(p2)], _leaves(p1))}
    os.environ.pop("REPRO_OPTS")

    # elastic restore: a save from (2, 4) onto (4, 2), and the reference's save onto (4, 2)
    cfg = dataclasses.replace(base, dtype="float32")
    host = gather_tree(stepped)
    if rank == 0:
        save_checkpoint(os.path.join(out_dir, "ck_port"), 1, host)
        np.savez(os.path.join(out_dir, "port_saved.npz"),
                 **{k: v for k, v in zip(["/".join(p) for p in _paths(host)], _leaves(host))})
    dist.barrier()
    mesh42 = make_local_mesh(4, 2, device="cpu")
    pl42, _ = T.state_placements(mesh42, stepped)
    like = M.param_specs(cfg)
    for name, ck, want in (("port", "ck_port", host), ("ref", "ck_ref", unflatten(ref, "stepped/"))):
        got, step, _ = restore_checkpoint(os.path.join(out_dir, ck), like, shardings=pl42, mesh=mesh42)
        d = max(float(np.abs(g.full_tensor().numpy() - np.asarray(w)).max()) for g, w in zip(_leaves(got), _leaves(want)))
        out["restore_" + name] = {"diff": d, "step": step, "mesh": list(mesh42.shape),
                                  "placements": all(g.placements == p for g, p in zip(_leaves(got), _leaves(pl42)))}

    # MoE: EP and expert-TP through moe_apply_shard_map against plain moe_apply and the reference's
    mcfg = dataclasses.replace(smoke_config("mixtral-8x7b"), dtype="float32")
    mcfg = dataclasses.replace(mcfg, moe=dataclasses.replace(mcfg.moe, capacity_factor=32.0))
    mcfg2 = dataclasses.replace(mcfg, moe=dataclasses.replace(mcfg.moe, n_experts=2, top_k=1))
    x = torch.from_numpy(ref["moe_x"])
    t_ = lambda tree: {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
    mp_, mp2 = t_(unflatten(ref, "moe/")), t_(unflatten(ref, "moe_tp/"))
    y_plain, aux_plain = L.moe_apply(mp_, x, mcfg)
    y2_plain, _ = L.moe_apply(mp2, x, mcfg2)
    ctx.set_axes(mesh, *axes)
    y_ep, aux_ep = L.moe_apply_shard_map(mp_, x, mcfg)
    y_tp, aux_tp = L.moe_apply_shard_map(mp2, x, mcfg2)
    # the same through DTensors: x over data, the experts by the param rules
    xd = distribute_tree(x, placement_tree(mesh, (axes[0], None)), mesh)
    from torch.distributed.tensor import Replicate, Shard
    ep_pl = {"router": (Replicate(), Replicate()), "w1": (Replicate(), Shard(0)), "w3": (Replicate(), Shard(0)),
             "w2": (Replicate(), Shard(0))}
    y_ep_d, aux_ep_d = L.moe_apply_shard_map(distribute_tree(mp_, ep_pl, mesh), xd, mcfg)
    # the R-row dispatch (R = data size = 2) at the default capacity, where tokens drop
    dcfg = dataclasses.replace(smoke_config("mixtral-8x7b"), dtype="float32")
    y_r2, aux_r2 = L.moe_apply(mp_, x, dcfg)
    rep = {k: (Replicate(), Replicate()) for k in mp_}
    y_r2_d, aux_r2_d = L.moe_apply(distribute_tree(mp_, rep, mesh), xd, dcfg)
    ctx.clear()
    y_r1, _ = L.moe_apply(mp_, x, dcfg)
    err = lambda a, b: float((a - torch.as_tensor(np.asarray(b))).abs().max())
    out["moe"] = {
        "err_plain": err(y_ep, y_plain), "err_tp_plain": err(y_tp, y2_plain),
        "aux_err_plain": abs(float(aux_ep) - float(aux_plain)),
        "err_ref": err(y_ep, ref["y_ep"]), "err_tp_ref": err(y_tp, ref["y_tp"]),
        "aux_err_ref": abs(float(aux_ep) - json.loads(os.environ["REF_OUT"])["aux_ep"]),
        "aux_tp_err_ref": abs(float(aux_tp) - json.loads(os.environ["REF_OUT"])["aux_tp"]),
        "err_dtensor": err(y_ep_d.full_tensor(), y_ep), "aux_err_dtensor": abs(float(aux_ep_d.full_tensor()) - float(aux_ep)),
        "r2_err_ref": err(y_r2, ref["y_r2"]), "r2_aux_err_ref": abs(float(aux_r2) - json.loads(os.environ["REF_OUT"])["aux_r2"]),
        "r2_err_dtensor": err(y_r2_d.full_tensor(), y_r2), "r2_aux_err_dtensor": abs(float(aux_r2_d.full_tensor()) - float(aux_r2)),
        "r1_err_ref": err(y_r1, ref["y_r1"]), "r2_vs_r1": err(y_r2, y_r1), "r2_scale": float(y_r2.abs().max()),
    }

    # decode: 4 steps on a cache placed by cache_sharding, kv_seq_model on and off
    cfg = dataclasses.replace(base, dtype="float32")
    params = lm_params_from_reference(unflatten(ref, "init/"), cfg, device="cpu")
    toks = torch.from_numpy(ref["tokens"][:2, :4].astype(np.int32))
    plain_cache = M.cache_init(cfg, 2, 8, device="cpu")
    plain = [M.decode_step(params, plain_cache, {"tokens": toks[:, i:i + 1]}, cfg)[0] for i in range(4)]
    out["decode"] = {}
    p_pl, _ = T.state_placements(mesh, params)
    pd = distribute_tree(params, p_pl, mesh)
    for flag in ("kv_seq_model", "no_kv_seq_model"):
        os.environ["REPRO_OPTS"] = flag
        c_specs = cache_sharding(mesh, M.cache_specs(cfg, 2, 8))
        cache = distribute_tree(M.cache_init(cfg, 2, 8, device="cpu"), placement_tree(mesh, c_specs), mesh)
        ctx.set_axes(mesh, *axes)
        got = []
        for i in range(4):
            tok = distribute_tree({"tokens": toks[:, i:i + 1]}, placement_tree(mesh, {"tokens": (axes[0], None)}), mesh)
            got.append(M.decode_step(pd, cache, tok, cfg)[0].full_tensor())
        ctx.clear()
        out["decode"][flag] = {"err": max(float((a - b).abs().max()) for a, b in zip(got, plain)),
                               "k_placements": str(cache["b0"]["k"].placements),
                               "k_cache_err": float((cache["b0"]["k"].full_tensor() - plain_cache["b0"]["k"]).abs().max()),
                               "pos": cache["b0"]["pos"].full_tensor().tolist()}
    os.environ.pop("REPRO_OPTS")
    if rank == 0:
        print("RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], pre + (k,))]
    return [pre]


if __name__ == "__main__":
    mp.spawn(run, args=(8, sys.argv[1], os.path.join(sys.argv[1], "store")), nprocs=8)
"""


def _run(script, out_dir, env_extra=None, timeout=600):
    path = os.path.join(out_dir, f"job_{abs(hash(script))}.py")
    with open(path, "w") as f:
        f.write(script)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_OPTS", None)
    env.update(env_extra or {})
    res = subprocess.run([sys.executable, path, out_dir], capture_output=True, text=True, env=env, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("mesh"))
    ref = _run(REF_STEP, out_dir)
    port = _run(PORT, out_dir, {"REF_OUT": json.dumps(ref)})
    restore = _run(REF_RESTORE, out_dir)
    return ref, port, restore


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_step_matches_plain_step(mesh_run, dtype):
    r = mesh_run[1][dtype]
    assert r["param_diff_plain"] < 5e-3, r
    assert r["placements_kept"], r
    if dtype == "float32":
        assert abs(r["loss_plain"] - r["loss_sharded"]) < 1e-4, r
        assert abs(r["grad_norm_plain"] - r["grad_norm_sharded"]) <= 1e-4 * r["grad_norm_plain"], r
        return
    # bf16: each rank rounds its partial products (row-parallel wo and w2)
    # before the sum, so the sharded step is held to lie no farther from
    # the float32 step than the plain bf16 step does
    f = mesh_run[1]["float32"]
    for key in ("loss", "grad_norm"):
        assert abs(r[key + "_sharded"] - f[key + "_plain"]) <= max(abs(r[key + "_plain"] - f[key + "_plain"]), 1e-4), r


@pytest.mark.parametrize("flag", ["moe_shard_map", "no_moe_shard_map"])
def test_moe_sharded_step_matches_plain_step(mesh_run, flag):
    """mixtral's smoke config (float32, capacity factor 32, no aux loss)
    through moe_apply_shard_map's expert parallelism or moe_apply's
    DTensor dispatch: the gradients that reach the experts, the router and
    the tokens through local_map are the plain step's."""
    r = mesh_run[1]["moe_step_" + flag]
    assert abs(r["loss_plain"] - r["loss_sharded"]) < 1e-4, r
    assert abs(r["grad_norm_plain"] - r["grad_norm_sharded"]) <= 1e-4 * r["grad_norm_plain"], r
    assert r["param_diff_plain"] < 5e-3, r


def test_sharded_step_matches_reference_sharded_step(mesh_run):
    ref, port, _ = mesh_run
    r = port["float32"]
    assert abs(r["loss_sharded"] - ref["loss"]) < 1e-4, (r, ref)
    assert r["param_diff_ref"] < 5e-3, r
    assert abs(r["grad_norm_sharded"] - ref["grad_norm"]) <= 1e-4 * ref["grad_norm"], (r, ref)


@pytest.mark.parametrize("source", ["port", "ref"])
def test_elastic_restore_onto_other_mesh(mesh_run, source):
    r = mesh_run[1]["restore_" + source]
    assert r["diff"] == 0.0 and r["step"] == 1 and r["mesh"] == [4, 2] and r["placements"], r


def test_reference_restores_port_checkpoint(mesh_run):
    r = mesh_run[2]
    assert r["restore_diff"] == 0.0 and r["restore_step"] == 1, r


def test_moe_shard_map_matches_plain_and_reference(mesh_run):
    m = mesh_run[1]["moe"]
    assert m["err_plain"] < 2e-4 and m["err_ref"] < 2e-4, m
    assert m["err_tp_plain"] < 1e-3 and m["err_tp_ref"] < 1e-3, m
    assert m["aux_err_plain"] < 5e-3 and m["aux_err_ref"] < 5e-3 and m["aux_tp_err_ref"] < 5e-3, m
    assert m["err_dtensor"] < 1e-5 and m["aux_err_dtensor"] < 1e-6, m


def test_moe_row_dispatch_matches_reference(mesh_run):
    m = mesh_run[1]["moe"]
    assert m["r2_vs_r1"] > 1e-3, m  # tokens drop: R = 2 is not the global dispatch
    # within 1e-5 of the output's largest |y| (about 210 here: a float32
    # ulp there is 1.5e-5)
    tol = 1e-5 * m["r2_scale"]
    assert m["r2_err_ref"] < tol and m["r1_err_ref"] < tol and m["r2_aux_err_ref"] < 1e-5, m
    assert m["r2_err_dtensor"] < tol and m["r2_aux_err_dtensor"] < 1e-6, m


@pytest.mark.parametrize("flag", ["kv_seq_model", "no_kv_seq_model"])
def test_decode_on_mesh_placed_cache(mesh_run, flag):
    d = mesh_run[1]["decode"][flag]
    assert d["err"] < 1e-4 and d["k_cache_err"] < 1e-5, d
    assert d["pos"] == [[4, 4]], d
    want = "Shard(dim=2)" if flag == "kv_seq_model" else "Shard(dim=4)"
    assert want in d["k_placements"], d
