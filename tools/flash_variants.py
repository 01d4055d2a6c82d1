#!/usr/bin/env python3
"""Write copies of a checkout's ``src/`` whose ``flash_attention`` kernel
differs in one choice, for ``tools/bench_flash.py`` to time (the forward
at FraudGT's shape, the long backward at the LM's training launch):

    python3 tools/flash_variants.py build/flash_variants --kind simt --src build/parent/src
    python3 tools/flash_variants.py build/flash_variants --kind short --src src
    python3 tools/bench_flash.py --shapes fraudgt --src build/parent/src \\
        --src build/flash_variants/<name>/src ...

``--kind simt`` varies the CUDA-core kernel (path C, and before the
short and wgmma paths the only one: a checkout from then times as it
ran on FraudGT's shape):

- ``exact_keys``: the score and value loops stop at key S instead of
  running over the whole 32-key tile (at S = 17, 15 padded keys a tile
  are skipped; the staging still copies the tile);
- ``stage_only``: the block stages its K/V tiles and stores its rows but
  computes nothing (the output is wrong; the time is that of the copies
  and the block schedule alone);
- ``threads256``: 256 threads a block, so 7 (b, h) problems share a block
  instead of 3.

``--kind short`` varies the short path (``csrc/flash_short.cuh``):

- ``copy_only``: the ring of bulk copies runs, no row is computed or
  stored (the output is wrong; the time is that of the copies alone);
- ``fast_exp``: ``__expf`` (the hardware ex2 with a multiply) for ``expf``;
- ``stages2`` / ``stages4``: a ring of 2 or 4 stages instead of 3;
- ``group4`` / ``group8``: the keys taken 4 or 8 at a time between exit
  tests instead of 1, independent within a group (a key past S reads key
  S - 1 and is masked);
- ``dpl16``: 16 head dims a lane instead of 8 (at hd 16 one lane holds a
  row: no shuffle, half the lanes);
- ``tmajor``: rows taken query-major (row r is query r / H, head r % H),
  so that a warp's rows span few queries and, causal, its key loops stop
  at the group after the last key its rows see (``__reduce_max_sync``);
  the rows of a warp then read several kv heads' words.

``--kind long_bwd`` varies the long backward's wgmma route
(``csrc/flash_long_bwd.cuh``), one of its choices undone in each copy:

- ``exp2f``: P by ``exp2f`` (its range handling around the
  special-function unit) instead of ``ex2.approx.ftz`` alone;
- ``always_mask``: every tile through the masked loop, not only those
  that cross the diagonal or the end of T or S;
- ``dq_keys64``: the dQ pass's ring stages hold 64 keys instead of 128
  (m64n64k16 products for S and dP);
- ``no_overlap``: both passes wait for S and dP together before forming
  P, instead of forming P while dP runs.

    python3 tools/flash_variants.py build/bwd_variants --kind long_bwd --src src
    python3 tools/bench_flash.py --direction bwd --shapes lm_train --src src \\
        --src build/bwd_variants/exp2f/src ... --src src

``--kind short_bwd`` varies the short backward's ring route
(``csrc/flash_short_bwd.cuh``), one of its choices undone in each copy:

- ``one_stage``: a ring of one stage, so no copy is in flight while a
  block computes (the card's other resident block still overlaps it);
- ``stages3``: a ring of 3 stages instead of 2 (one block an SM at
  FraudGT's shape instead of two);
- ``grid_b``: one block per batch element instead of persistent blocks
  (each block fetches its element and ends);
- ``one_wait``: every row of a stage on its first barrier, so phase 1
  starts only when the whole element has arrived;
- ``two_pass``: p and dS formed again by the key rows from the staged
  rows (the buffer carries each row's D and lse instead), as the
  chunked route forms them twice;
- ``mask_all``: every causal pair formed and the masked ones set to 0,
  instead of skipped;
- ``copy_only``: the ring of bulk copies runs, no row is computed or
  stored (the output is wrong; the time is that of the copies alone).

    python3 tools/flash_variants.py build/short_bwd_variants --kind short_bwd --src src
    python3 tools/bench_flash.py --direction bwd --shapes fraudgt_train,fraudgt --flush-l2 --src src \
        --src build/short_bwd_variants/one_stage/src ... --src src

Each copy goes to ``<out>/<name>/src`` and builds its own library under
``<out>/<name>/build/kernels``.  The copies are experiments, not a
configuration of the package.
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

CU = "repro_torch/csrc/flash_attention.cu"
SHORT = "repro_torch/csrc/flash_short.cuh"

EXACT = (
    ("      float kk[kDPL];\n", "      if (j0 + jj >= s_len) break;\n      float kk[kDPL];\n"),
    ("      const float pj = sc[jj]", "      if (j0 + jj >= s_len) break;\n      const float pj = sc[jj]"),
)
STAGE_ONLY = (("    __syncthreads();\n\n    const float* kr", "    __syncthreads();\n    continue;\n    const float* kr"),)
THREADS256 = (("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),)
SIMT = {"exact_keys": EXACT, "stage_only": STAGE_ONLY, "threads256": THREADS256}

SCORES_LOOP = "      float m = kNeg;\n#pragma unroll\n      for (int j0 = 0; j0 < kShortMaxLen; j0 += kKeyGroup) {\n        if (j0 >= s_len) break;"
VALUES_LOOP = "acc[i] = 0.f;\n#pragma unroll\n      for (int j0 = 0; j0 < kShortMaxLen; j0 += kKeyGroup) {\n        if (j0 >= s_len) break;"
SHORT_VARIANTS = {
    "copy_only": (("for (int r0 = 0; r0 < rows; r0 += slots)", "for (int r0 = 0; r0 < rows * 0; r0 += slots)"),),
    "fast_exp": (("expf(sc[j] - m)", "__expf(sc[j] - m)"),),
    "stages2": (("kShortStages = 3;", "kShortStages = 2;"),),
    "stages4": (("kShortStages = 3;", "kShortStages = 4;"),),
    "group4": (("kKeyGroup = 1;", "kKeyGroup = 4;"),),
    "group8": (("kKeyGroup = 1;", "kKeyGroup = 8;"),),
    "dpl16": (("kShortDPL = 8;", "kShortDPL = 16;"),),
    "tmajor": (
        ("const int hh = r / t_len, t = r % t_len, kh = hh / group;",
         "const int hh = r % n_heads, t = r / n_heads, kh = hh / group;\n"
         "      const int kv_end = causal ? min(s_len, (int)__reduce_max_sync(0xffffffffu, (unsigned)t) + 1) : s_len;"),
        (SCORES_LOOP, SCORES_LOOP.replace("j0 >= s_len", "j0 >= kv_end")),
        (VALUES_LOOP, VALUES_LOOP.replace("j0 >= s_len", "j0 >= kv_end")),
    ),
}
LONG_BWD = "repro_torch/csrc/flash_long_bwd.cuh"
LONG_BWD_VARIANTS = {
    "exp2f": (('  float y;\n  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;', "  return exp2f(x);"),),
    "always_mask": (
        ("      if (!need_mask) {\n#pragma unroll\n        for (int i = 0; i < 8; ++i) {",
         "      if (false) {\n#pragma unroll\n        for (int i = 0; i < 8; ++i) {"),
        ("      if (!need_mask) {\n#pragma unroll\n        for (int idx = 0;",
         "      if (false) {\n#pragma unroll\n        for (int idx = 0;"),
    ),
    "dq_keys64": (("constexpr int kKeyStage = 128;", "constexpr int kKeyStage = 64; "),),
    "no_overlap": (
        ("      wgmma_wait1();  // S^T done", "      wgmma_wait0();  // S^T and dP^T done"),
        ("      wgmma_wait1();  // S done", "      wgmma_wait0();  // S and dP done"),
    ),
}

SHORT_BWD = "repro_torch/csrc/flash_short_bwd.cuh"
RING_PAIRS = """          const float2 pd = pds[r * ld + j];  // (p, dS)
          float qf[N], dof[N];
          load_lane<T, L, NC>(qs + r * HD, sub, qf);
          load_lane<T, L, NC>(dos + r * HD, sub, dof);
"""
SHORT_BWD_VARIANTS = {
    "one_stage": (("return n < 2 ? 0 : (n < kRingStages ? (int)n : kRingStages);", "return n < 2 ? 0 : 1;"),),
    "stages3": (("constexpr int kRingStages = 2;", "constexpr int kRingStages = 3;"),),
    "grid_b": (("const int grid = (int)(b < resident ? b : resident);", "const int grid = b;"),),
    "one_wait": (("const int rows_a = min(rows, slots);", "const int rows_a = rows;"),),
    "two_pass": (
        ("if (sub == 0) prow[j] = make_float2(p, ds);", "if (sub == 0) prow[j] = make_float2(dd, lr);"),
        ("      for (int g = 0; g < group; ++g) {\n        const int h = kh * group + g;",
         "      float kf[N], vf[N];\n"
         "      load_lane<T, L, NC>(ks + c * HD, sub, kf);\n"
         "      load_lane<T, L, NC>(vs + c * HD, sub, vf);\n"
         "      for (int g = 0; g < group; ++g) {\n        const int h = kh * group + g;"),
        (RING_PAIRS,
         RING_PAIRS.replace("const float2 pd = pds[r * ld + j];  // (p, dS)",
                            "const float2 dl = pds[r * ld + j];  // (D, lse)")
         + "          const float p = expf(scale * group_sum<L>(dot_lane<N>(qf, kf), gmask) - dl.y);\n"
           "          const float2 pd = make_float2(p, p * (group_sum<L>(dot_lane<N>(dof, vf), gmask) - dl.x));\n"),
    ),
    "copy_only": (
        ("for (int pass = 0; pass * slots < rows; ++pass) {", "for (int pass = 0; pass * slots < rows * 0; ++pass) {"),
        ("for (int pass = 0; pass * slots < keys; ++pass) {", "for (int pass = 0; pass * slots < keys * 0; ++pass) {"),
    ),
    "mask_all": (
        ("const int n_keys = causal ? min(i + 1, s_len) : s_len;", "const int n_keys = s_len;"),
        ("const float p = expf(sc - lr);", "const float p = (!causal || j <= i) ? expf(sc - lr) : 0.f;"),
        ("const int i_first = causal ? j : 0;", "const int i_first = 0;"),
    ),
}


def apply(cu: str, edits) -> str:
    for old, new in edits:
        if cu.count(old) != 1:
            raise SystemExit(f"flash_variants.py: {old!r} is not in the kernel exactly once; "
                             "point --src at a checkout with that kernel")
        cu = cu.replace(old, new)
    return cu


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", type=Path)
    ap.add_argument("--src", type=Path, required=True, help="src/ of the checkout to vary")
    ap.add_argument("--kind", choices=("simt", "short", "long_bwd", "short_bwd"), required=True)
    args = ap.parse_args()
    rel, variants = {"simt": (CU, SIMT), "short": (SHORT, SHORT_VARIANTS),
                     "long_bwd": (LONG_BWD, LONG_BWD_VARIANTS),
                     "short_bwd": (SHORT_BWD, SHORT_BWD_VARIANTS)}[args.kind]
    text = (args.src / rel).read_text()
    for name, edits in variants.items():
        dst = args.out / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(args.src, dst / "src", ignore=shutil.ignore_patterns("__pycache__"))
        (dst / "src" / rel).write_text(apply(text, edits))
        print(name, dst / "src")


if __name__ == "__main__":
    main()
