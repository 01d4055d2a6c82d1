"""Collective bytes of the dry run's cells at a (2, 2) mesh, the port's
against the JAX package's, per kind and per op.  ``tests/test_torch_dryrun.py``
holds the totals to each other; run it alone to print both sides' tables:

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/dryrun_parity.py

The reference lowers each cell with its own ``repro.launch.dryrun._lower_cell``
over a ``("data", "model")`` mesh of 4 of its forced host devices with
``Auto`` axes (jax 0.9's default ``Explicit`` axes fail its sharding
rules) and reads ``repro.launch.hlo_analysis.collective_bytes`` of the
compiled HLO, in a subprocess (its module forces 512 host devices at
import); an op's name is the HLO instruction's ``op_name``.  The port
traces the sharded step on ``meta`` DTensors under a fake process group
(``repro_torch.launch.dryrun._trace_collectives``); an op's name is the
innermost frame of the port's model or launch code that issued it.
Nothing in ``src/repro`` changes.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import traceback

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CELLS = [(arch, kind) for arch in ("qwen2-1.5b", "mixtral-8x7b") for kind in ("train", "prefill", "decode")]
SEQ, BATCH = 64, 4

REF = r"""
import json, re, sys
from repro.launch import dryrun as R  # forces 512 host devices first
import jax
from repro.configs.base import ShapeSpec
from repro.configs.registry import smoke_config
from repro.distributed import ctx
from repro.distributed.sharding import mesh_axes
from repro.launch.hlo_analysis import _COLL, _SHAPE_RE, _shape_bytes, collective_bytes

cells, seq, batch = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
out = {}
for arch, kind in cells:
    ctx.set_axes(mesh, *mesh_axes(mesh))
    try:
        text = R._lower_cell(smoke_config(arch), ShapeSpec("s", seq, batch, kind), mesh).compile().as_text()
    finally:
        ctx.clear()
    ops = []
    for line in text.splitlines():
        rhs = line.strip().partition("=")[2]
        for c in _COLL:
            if re.search(rf"\s{c}(-start)?\(", rhs) and f"{c}-done" not in rhs:
                n = sum(_shape_bytes(d, dims) for d, dims in _SHAPE_RE.findall(rhs.split(c)[0]))
                name = re.search(r'op_name="([^"]*)"', line)
                ops.append([c, n, name.group(1) if name else "?"])
                break
    out[arch + "|" + kind] = {"kinds": collective_bytes(text), "ops": ops}
print("RESULT " + json.dumps(out))
"""


def reference_collectives(cells=CELLS, timeout=900):
    """{"arch|kind": {"kinds": {kind: bytes, "total"}, "ops": [[kind, bytes, op_name]]}}
    of the JAX package's lowering, in a subprocess."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_OPTS", None)
    res = subprocess.run([sys.executable, "-c", REF, json.dumps(cells), str(SEQ), str(BATCH)], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-4000:])
    line = [l for l in res.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def port_collectives(arch, kind):
    """{"kinds": {kind: bytes, "total"}, "ops": [[kind, bytes, frame]]} of
    the port's sharded step on a fake (2, 2) mesh, at the smoke config."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape

    ops = []

    class Recorder(dryrun._CollectiveBytes):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = dict(self.bytes)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            for k, v in self.bytes.items():
                if v != before[k]:
                    ops.append([k, v - before[k], _issuer()])
            return out

    saved = dryrun._CollectiveBytes
    dryrun._CollectiveBytes = Recorder
    try:
        kinds = dryrun._trace_collectives(smoke_config(arch), ShapeSpec("s", SEQ, BATCH, kind),
                                          MeshShape(("data", "model"), (2, 2)))
    finally:
        dryrun._CollectiveBytes = saved
    return {"kinds": dict(kinds, total=sum(kinds.values())), "ops": ops}


def _issuer() -> str:
    """The innermost frame of the port's model or launch code (not the dry
    run's own) on the stack: the op that issued a collective."""
    for f in reversed(traceback.extract_stack()):
        path = f.filename.replace(os.sep, "/")
        if "repro_torch/" in path and not path.endswith("launch/dryrun.py"):
            return f"{path.split('repro_torch/')[-1]}:{f.lineno} {f.name}"
    return "?"


def _table(ops):
    agg = collections.Counter()
    for kind, n, name in ops:
        agg[kind, name] += n
    return sorted(agg.items(), key=lambda kv: -kv[1])


def main():
    ref = reference_collectives()
    for arch, kind in CELLS:
        port = port_collectives(arch, kind)
        r = ref[f"{arch}|{kind}"]
        print(f"\n## {arch} {kind} (smoke, T={SEQ}, B={BATCH}, (2, 2) mesh): "
              f"reference {r['kinds']['total']:,} B, port {port['kinds']['total']:,} B")
        print("kind | reference | port")
        for k in r["kinds"]:
            if k != "total":
                print(f"{k} | {r['kinds'][k]:,} | {port['kinds'][k]:,}")
        for side, ops in (("reference", r["ops"]), ("port", port["ops"])):
            print(f"-- {side} by op:")
            for (k, name), n in _table(ops):
                print(f"   {n:>10,}  {k:18s} {name}")


if __name__ == "__main__":
    main()
