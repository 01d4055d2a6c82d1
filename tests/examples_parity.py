"""Helpers of the ``tests/test_torch_examples*.py`` files: run one of the
JAX package's example scripts unchanged in a subprocess on the CPU, and
compare printed lines with the times masked."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# a time as the scripts print one: "1978ms", "8.2s", "( 0.1s"
TIME = re.compile(r"\d+(\.\d+)?\s*(ms|s)\b")

# each example's smallest flags
TINY_FLAGS = [
    ("quickstart", ["--scale", "0.05", "--trees", "2"]),
    ("streaming_detection", ["--scale", "0.05", "--batches", "2"]),
    ("train_aml_pipeline", ["--scale", "0.05", "--trees", "2", "--epochs", "1"]),
    ("serve_lm", ["--batch", "2", "--prompt", "3", "--gen", "2", "--cache", "6"]),
    ("trace_capture", ["--scale", "0.05"]),
]


def run_reference(script: str, args, cwd, extra_env=None, timeout: int = 600) -> str:
    """The standard output of ``examples/<script>.py`` with ``args``, run
    by the JAX package on the CPU."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env.update(extra_env or {})
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{script}.py"), *args],
        capture_output=True,
        text=True,
        env=env,
        cwd=str(cwd),
        timeout=timeout,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def masked(text: str, rules=()) -> list:
    """The lines of ``text`` with every time masked, then each
    ``(pattern, replacement, reason)`` rule applied."""
    lines = []
    for line in text.splitlines():
        line = TIME.sub("<time>", line)
        for pat, rep, _reason in rules:
            line = re.sub(pat, rep, line)
        lines.append(line)
    return lines


def no_jax_script(calls) -> str:
    """A script that runs each ``(module, argv)`` example's ``main`` and
    then fails if jax or the JAX package was imported."""
    return "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module('repro_torch.examples.{m}').main({list(a)!r})" for m, a in calls]
        + [
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
            " or m == 'repro' or m.startswith('repro.'))",
            "assert not bad, bad",
            "print('ok')",
        ]
    )
