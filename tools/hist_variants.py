#!/usr/bin/env python3
"""Write copies of ``src/`` whose ``hist_update`` kernel differs from the
committed one in one design choice, for ``tools/bench_hist.py`` to time:

    python3 tools/hist_variants.py build/variants
    python3 tools/bench_hist.py time build/hist_inputs.npz --src build/variants/<name>/src

- ``local``: an add into the block's own slice is a shared-memory
  ``atomicAdd`` (a compare-and-swap loop for 64 bits on sm_90a), the
  others go through distributed shared memory;
- ``split32``: every 64-bit add is two 32-bit atomics, the low word's
  returning the carry into the high word's, in the block's own slice as
  in the others;
- ``nocombine``: no warp combine of equal keys before the atomics;
- ``split32_nocombine``: both of the last two.

Each copy goes to ``<out>/<name>/src`` and builds its own library under
``<out>/<name>/build/kernels``.  The copies are experiments, not a
configuration of the package.
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = "repro_torch/csrc/hist_update.cu"

LOCAL = '''__device__ __forceinline__ void slice_add(const unsigned long long* sh, unsigned off,
                                          unsigned owner, unsigned long long v) {
  if (owner == cooperative_groups::this_cluster().block_rank()) {
    atomicAdd(const_cast<unsigned long long*>(sh) + off, v);
    return;
  }
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(sh + off);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(owner));
  asm volatile("red.shared::cluster.add.u64 [%0], %1;" ::"r"(remote), "l"(v) : "memory");
}

'''
SPLIT32 = '''__device__ __forceinline__ void slice_add(const unsigned long long* sh, unsigned off,
                                          unsigned owner, unsigned long long v) {
  const unsigned lo = (unsigned)v, hi = (unsigned)(v >> 32);
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(sh + off);
  uint32_t remote, old;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(owner));
  asm volatile("atom.shared::cluster.add.u32 %0, [%1], %2;" : "=r"(old) : "r"(remote), "r"(lo) : "memory");
  const unsigned h = hi + (unsigned)(old + lo < old);
  if (h) asm volatile("red.shared::cluster.add.u32 [%0], %1;" ::"r"(remote + 4u), "r"(h) : "memory");
}

'''
NOCOMBINE = ("const unsigned peers = __match_any_sync(kFull, k);", "const unsigned peers = 1u << lane;")


def variants(cu: str) -> dict:
    start = cu.index("__device__ __forceinline__ void slice_add")
    end = cu.index("template <class Src>\n__global__ void __launch_bounds__")
    split32 = cu[:start] + SPLIT32 + cu[end:]
    return {
        "local": cu[:start] + LOCAL + cu[end:],
        "split32": split32,
        "nocombine": cu.replace(*NOCOMBINE),
        "split32_nocombine": split32.replace(*NOCOMBINE),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", type=Path)
    args = ap.parse_args()
    cu = (ROOT / "src" / CU).read_text()
    for name, text in variants(cu).items():
        if text == cu:
            raise SystemExit(f"variant {name} did not change the kernel")
        dst = args.out / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "src", dst / "src", ignore=shutil.ignore_patterns("__pycache__"))
        (dst / "src" / CU).write_text(text)
        print(name, dst / "src")


if __name__ == "__main__":
    main()
