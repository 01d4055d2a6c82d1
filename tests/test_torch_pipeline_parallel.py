"""GPipe pipeline parallelism of the port
(``repro_torch.distributed.pipeline``) on the CPU: 4 gloo ranks on a
``("pipe",)`` mesh at the shapes of the reference's
``tests/test_pipeline_parallel.py`` (4 stages, 8 microbatches of 2, width
16, ``tanh(h @ w_s)`` a stage).  The piped forward is within 1e-5 of the
sequential one and of the reference's ``pipeline_forward`` (4 forced host
devices), with the stage weights given whole or as DTensors sharded over
``pipe``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
S, M, MB, D = 4, 8, 2, 16

REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.distributed.pipeline import pipeline_forward

z = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("pipe",), axis_types=(jax.sharding.AxisType.Auto,))
got = pipeline_forward(mesh, lambda wi, h: jnp.tanh(h @ wi), jnp.asarray(z["w"]), jnp.asarray(z["x"]))
np.save(sys.argv[2], np.asarray(got))
"""

PORT = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, world, data, out, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    from repro_torch.distributed.pipeline import pipeline_forward, pipeline_spec
    from repro_torch.distributed.sharding import distribute_tree

    z = np.load(data)
    w, x = torch.from_numpy(z["w"]), torch.from_numpy(z["x"])
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pipe",))
    assert pipeline_spec(world, x.shape[0]) == {"n_stages": world, "n_micro": x.shape[0]}
    fn = lambda wi, h: torch.tanh(h @ wi)
    whole = pipeline_forward(mesh, fn, w, x)
    sharded = pipeline_forward(mesh, fn, distribute_tree(w, (Shard(0),), mesh), x)
    np.save(f"{out}_{rank}_whole.npy", whole.numpy())
    np.save(f"{out}_{rank}_sharded.npy", sharded.numpy())
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(4, sys.argv[1], sys.argv[2], sys.argv[3]), nprocs=4)
"""


def _run(args, tmp_path, script):
    path = tmp_path / f"job_{len(script)}.py"
    path.write_text(script)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, str(path), *args], capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(S, D, D)).astype(np.float32) * 0.3).astype(np.float32)
    x = rng.normal(size=(M, MB, D)).astype(np.float32)
    data = str(tmp / "data.npz")
    np.savez(data, w=w, x=x)
    _run([data, str(tmp / "out"), str(tmp / "store")], tmp, PORT)
    _run([data, str(tmp / "ref.npy")], tmp, REF)
    seq = x
    for s in range(S):
        seq = np.tanh(seq @ w[s])
    got = {(r, kind): np.load(tmp / f"out_{r}_{kind}.npy") for r in range(S) for kind in ("whole", "sharded")}
    return got, seq, np.load(tmp / "ref.npy")


@pytest.mark.parametrize("kind", ["whole", "sharded"])
def test_gpipe_matches_sequential(piped, kind):
    got, seq, _ = piped
    for r in range(S):  # every rank holds the last stage's outputs
        assert np.abs(got[(r, kind)] - seq).max() < 1e-5, r


def test_gpipe_matches_reference(piped):
    got, _, ref = piped
    assert np.abs(got[(0, "whole")] - ref).max() < 1e-5
    assert np.abs(got[(S - 1, "sharded")] - ref).max() < 1e-5
