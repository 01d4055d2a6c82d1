"""LM serving launcher: batched greedy decode with KV and state caches, the
JAX package's ``repro.launch.decode_lm`` on a torch device.

The prompt goes in token by token through ``decode_step``, as the
reference's does (correctness first: there is no fused prefill in either
package's ``generate``).  Each step after the prompt makes one
device→host copy, the next tokens (:func:`repro_torch.device.to_host`).
Runs under ``torch.inference_mode()``; the caches are updated in place.

Usage (the CUDA card by default; ``--device cpu`` for the plain path):
  PYTHONPATH=src python -m repro_torch.launch.decode_lm --arch xlstm-125m --smoke \\
      --batch 4 --prompt-len 16 --gen 32
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.device import h2d, resolve_device, to_host
from repro_torch.models.model import cache_init, decode_step, init_params, tree_leaves

__all__ = ["generate", "make_serve_step", "main"]


def make_serve_step(cfg):
    def serve_step(params, cache, batch):
        logits, new_cache = decode_step(params, cache, batch, cfg)
        # last-axis argmax covers both layouts: flat-vocab logits yield
        # (B,), multi-codebook (n_codebooks > 0) logits yield (B, K)
        return logits[:, -1].argmax(dim=-1), new_cache

    return serve_step


def generate(cfg, params, prompt_tokens: np.ndarray, gen: int, cache_len: int) -> np.ndarray:
    """Greedy decode on the device that holds ``params``.
    prompt_tokens (B, P) int32 -> (B, P+gen) int32 on the host."""
    dev = tree_leaves(params)[0].device
    bsz, plen = prompt_tokens.shape
    with torch.inference_mode():
        cache = cache_init(cfg, bsz, cache_len, device=dev)
        step_fn = make_serve_step(cfg)
        prompt = h2d(np.asarray(prompt_tokens, dtype=np.int32), dev)
        out = [np.asarray(prompt_tokens, dtype=np.int32)]
        tok = None
        for i in range(plen):
            tok, cache = step_fn(params, cache, {"tokens": prompt[:, i : i + 1]})
        cur = to_host(tok)[:, None].astype(np.int32)
        for _ in range(gen):
            out.append(cur)
            tok, cache = step_fn(params, cache, {"tokens": h2d(cur, dev)})
            cur = to_host(tok)[:, None].astype(np.int32)
    return np.concatenate(out, axis=1)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.precomputed_embeddings:
        raise SystemExit("audio stub serves via examples/serve_lm.py embeddings path")
    dev = resolve_device(args.device)
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, args.gen, cache_len=args.prompt_len + args.gen + 1)
    dt = time.perf_counter() - t0
    tps = args.batch * args.gen / dt
    print(f"generated {toks.shape} in {dt:.2f}s ({tps:,.0f} tok/s) on {dev}")
    print(toks[0, : args.prompt_len + 8])
    return toks


if __name__ == "__main__":
    main()
