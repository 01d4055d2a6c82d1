"""Serve a small model with batched requests through the decode path:
exercises KV/state caches for an attention arch and an SSM arch (the
port of the JAX package's ``examples/serve_lm.py``).

  PYTHONPATH=src python -m repro_torch.examples.serve_lm              # on the card
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

The script has no flags.  These shrink its constants for tests, and
default to them: ``--batch`` (8), ``--prompt`` (12), ``--gen`` (24),
``--cache`` (48).  ``--device``
(``cpu``; the CUDA card when left out).  The smoke configs keep their own
dtype (bfloat16), as the script's.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

__all__ = ["ARCHS", "serve", "main"]

ARCHS = ("qwen2-1.5b", "xlstm-125m")


def serve(arch: str, cfg, params, batch: int = 8, prompt: int = 12, gen: int = 24, cache_len: int = 48) -> dict:
    """Greedy-serve ``batch`` requests of ``prompt`` tokens drawn with
    seed 0, ``gen`` new tokens each, through ``generate`` on the device
    that holds ``params``; print the script's line.  Returns the printed
    numbers (``shape``, ``seconds``, ``tokens_per_s``) and the prompts and
    tokens."""
    from repro_torch.launch.decode_lm import generate

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt)).astype(np.int32)
    t0 = time.time()
    toks = generate(cfg, params, prompts, gen=gen, cache_len=cache_len)
    dt = time.time() - t0
    print(f"{arch:12s} served batch {toks.shape} in {dt:.1f}s "
          f"({batch*gen/dt:,.0f} tok/s greedy)")
    return {"arch": arch, "shape": tuple(toks.shape), "seconds": dt, "tokens_per_s": batch * gen / dt,
            "prompts": prompts, "tokens": toks}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from repro_torch.configs.registry import smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=12)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--cache", type=int, default=48)
    ap.add_argument("--device", default=None, help="cpu; the CUDA card when left out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    for arch in ARCHS:
        cfg = smoke_config(arch)
        params = init_params(cfg, 0, device=device)
        out[arch] = serve(arch, cfg, params, args.batch, args.prompt, args.gen, args.cache)
    return out


if __name__ == "__main__":
    main()
