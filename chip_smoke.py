#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py                 # HI-Small at its published size
    python3 chip_smoke.py --scale 28      # a tenth of it, for a quick look

Phases, in order; any failure exits non-zero:

1. build  — compile every CUDA kernel of the port from
   ``src/repro_torch/csrc`` (nvcc, sm_90a; one nvcc per source, all
   started together) and print the card's name and power limit as
   ``nvidia-smi`` reports them.
2. kernel — hold each kernel to its plain PyTorch version on the card:
   ``intersect_count`` bit for bit over the bucket-ladder shapes, both
   ``ordered`` modes, ragged batch sizes and the hand-built edge cases,
   then in the broadcast forms the compiler passes (a fixed side of
   B / W rows, int windows and windows at the fixed side's rate, no a-side
   time) and on operands one word into their storage, on both of its
   paths (``ops.plan``: ``"rows"`` and ``"block"``, which must equal the
   ``.cu`` entry's choice and must both be reached);
   ``window_search``'s four entries (``count_window``, ``count_id_in_window``
   and their ``_pos`` forms) bit for bit equal to the plain searches of
   ``core.ops``, one launch a call under ``set_sync_debug_mode("error")``,
   in each of the compiler's operand forms (lifted and broadcast views of
   ranks 1-4, ints, inverted windows, -1 ids, int32 wrap, strided and
   offset operands) at halvings that cover every row and at fewer, and at
   a hub row of 340,391 entries at 19 and 8 halvings, where it is timed;
   both entries of ``hist_update`` (``keys`` and ``rows``) bit for bit
   equal to the plain fixed-point replay (``ref.fixed_point_ref``), within
   their stated error bound of the plain version in float64, and
   bit-identical across two launches, at the shapes of
   ``tests/test_kernels.py``, the edge cases, one shape for each cluster
   size (1, 2, 4, 8, 16 blocks) and one past the cluster limit, hot keys
   (every row on one key; 90 % of rows on 1 % of the keys) and the fit's
   level shapes S = 3,072 * 2^L, L = 0..5; ``window_degree`` bit for
   bit at the ``tests/test_kernels.py`` shapes, (16384, 128) and two
   shapes that stream HBM, (1,048,576, 32) and (262,144, 128);
   ``flash_attention`` within 2e-5 (float32) or 2e-2 (bfloat16) at the
   cases of ``tests/test_flash_attention.py``, causal attention over fewer
   keys than queries, FraudGT's shape and the short path in bf16 with
   GQA, and long bfloat16 shapes on the wgmma path (causal and not, hd 64
   and 128, ragged tiles); each row logs the path ``ops.plan`` picked,
   which must be the ``.cu`` entry's, and both the short and the wgmma
   path must be reached (the wgmma path also at qwen2-1.5b's prefill
   launch, 12 query heads over 2 kv heads); the short path's backward (``flash_attention_bwd``,
   on the forward kernel's output and logsumexp) within 1e-5 (float32) or
   2e-2 relative and absolute (bfloat16) of its plain version and
   bit-identical across two launches, at FraudGT's training and inference
   shapes, GQA with T > S, the short cases of ``tests/test_torch_cuda.py``
   and a block at the shared-memory limit; the long backward
   (``csrc/flash_long_bwd.cuh``) the same way (float32 within 1e-5
   absolute plus 1e-5 relative) at qwen2-1.5b's training launch (B 4,
   T = S = 4,096, 12 over 2 heads of 128, bf16, causal), full attention in
   bf16 at hd 64, ragged tiles, causal T > S, float32 at hd 16 and 128
   with GQA, bf16 at hd 32, a single key and the wgmma route's tile edges
   (T = S = 127, 129, 257 at hd 64 and 128, a group of 8); every row logs
   the backward path ``ops.bwd_plan`` picked (which must be the ``.cu``
   entry's), all three (short, wgmma, simt) must be reached, and the
   ``.cu``'s tile loops must equal ``ops.bwd_tiles``; each timed beside the
   backward of ``scaled_dot_product_attention``.  Then the sliding window
   and head size 80, both ways: windows below, at and above T on the short
   path (both backward routes), simt and wgmma, hd 80 in bf16 (wgmma) and
   float32 (simt), each row against its plain version as above (the
   library call with the window's boolean mask), and the forward's and
   the backward's tile lists (``flash_attention_fwd_tiles``,
   ``flash_attention_bwd_tiles``) equal to ``ops.fwd_tiles`` and
   ``ops.bwd_tiles`` under windows.  Each shape is timed with CUDA events beside its
   bound, the plain version and, where one PyTorch call computes the same
   function, that call; every kernel but ``hist_update`` also under
   ``torch.profiler`` (``kernel_ms``, the kernel without the wrapper's
   host work; null, "not measured", when three profiled runs record no
   device kernel at all).
3. main path — synthetic HI-Small (``--scale 282``: about 451K accounts and
   5.1M transactions, the size of the published IBM HI-Small) through
   ``run_aml_pipeline(ds, "full", session=MiningSession(g, window=4096))``:
   the 9-pattern ``"full"`` portfolio mined cold, every edge a seed, the
   features, the default 60-tree GBDT, F1 on the last 20 % by time, under
   ``torch.cuda.set_sync_debug_mode("error")`` so that any hidden host
   sync fails the run.  The kernels' launch counts are zeroed just before
   and read just after: ``intersect_count`` and ``window_search`` must be
   > 0 and ``hist_update``
   n_trees * (max_depth + 1) = 420, n_trees * max_depth = 360 of them
   through the ``rows`` entry (one per level) and the rest the leaf sums;
   a compiled portfolio mine must sync exactly ``1 + n_compiled`` times,
   and F1 must be > 0.  Then the warm re-mine: 16,384 seeds mined twice on
   the same session (every edge until cut for the time limit), the second
   from the cached schedules, both equal to the main path's rows.  The
   first launch of each shape of the fit is kept for phase 8.
4. cross-checks — the same mine with ``kernel_backend="torch"`` over
   65,536 seeds drawn with the data seed launches neither mining kernel
   and gives bit-identical rows
   (every edge before phases 9-12 existed, then 1,048,576; cut for the
   time limit), and 4,096 seeds mined by the port on the CPU equal the
   card's rows for them.
5. detection path without mined features — ``run_aml_pipeline(ds,
   "xgb_only")`` at the same size, its ``hist_update`` launches counted
   and held as phase 3's.
6. detection cross-checks — two 10-tree fits on the card over the first
   1,048,576 training rows give bit-identical trees and probabilities,
   and a 10-tree fit on the card over 131,072 rows splits as the CPU
   port's does, or differs first at a near tie of the two gains.
7. FraudGT inference — ``FraudGT(FraudGTParams(), seed=0).predict_proba``
   over the test split (the last 20 % by time) under
   ``set_sync_debug_mode("error")``: tokenize on the host, then the graph
   transformer on the card, every block's attention through
   ``flash_attention``, which must launch n_layers * ceil(n_test / 1024)
   times.  Cross-checks on the first 16,384 test edges: the ``"kernel"``
   and ``"torch"`` attention backends agree within 1e-5 in the logits, the
   card within 1e-4 of the CPU port with the same weights, and the tokens
   are bit-identical to a CPU ``tokenize``.  Then the forward over the
   first 131,072 test edges under ``torch.profiler``: the device's busy
   share and the kernels that take its time.
8. report — each kernel checked and timed at the shapes its main path
   gave it, in the operands' own forms (``intersect_count``'s largest
   launch as the compiler passed it; ``window_search`` at the largest
   ``count_id_in_window`` and ``count_window`` launches, held bit for bit to
   the plain version and timed with L2 flushed beside the bound: the
   operand bytes, the outputs and one 32-byte sector for each halving this
   data needs and each ``indptr`` read;
   ``hist_update``'s ``rows`` entry at every level of the fit,
   its ``keys`` entry at the leaf sums and on the keys the fit would build
   at every level), then a ``{"kernels": [...]}`` line (launches on the
   main paths, max difference from the plain version, kernel / plain /
   bound / library times at the main path's largest launch), the card
   line, and last ``{"ok": true, "device": {...}}``.  The full record
   goes to ``build/chip_smoke.json``.  Phases 9-22 run between phase 8's
   timing and those last lines (the backward's kernels entry, at the shape
   of phase 16's first backward launch, after phase 16; the LM's
   ``flash_attention`` keys after phase 17; the long backward's entry, at
   a launch of phase 18's cell, after phase 18; the windowed prefills'
   ``zamba2_*`` and ``mixtral_*`` keys after phase 20, the seven
   full-width prefills' keys after phase 21):
9. oracle — every ``full_deep`` pattern mined on the card with each
   kernel backend equals the port's ``GFPReference`` on every edge of
   two random graphs (512 nodes, 5,120 edges, t_max 4,096); then the
   paper's Fig. 10 protocol (``benchmarks/bench_scaling.py``):
   ``scatter_gather`` on Trovares-10K/100K/1M, 2,000 seeds on the card,
   the first 400 through the oracle, exact; a ``fig10:`` line gives the
   compiled and GFP edges/s and their ratio, beside the card line.
10. partitioned — ``mine(backend="partitioned", n_parts=4)`` over 65,536
   seeds of the phase-3 graph equals phase 3's rows for them.
11. streaming — the phase-3 session's ``service(pipeline=True,
   retain="auto")`` over HI-Small in time order: a first tick of 65,536
   transactions, then 48 of 8,192, under ``set_sync_debug_mode("error")``
   with only each tick's gather allowed to sync.  Asserted: one host sync
   a tick, ``intersect_count`` and ``window_search`` launched (counts
   zeroed before, read after), no degraded tick, no new launch shape in the last quarter of
   the ticks, ``schedule_hits > 0``, counts equal to a card mine of the
   streamed prefix built in arrival order, and a sequential service over
   the first 8 ticks giving the same alerts and counts.  Printed:
   txns/s, tick p50/p99, stage p50s, dirty fraction, live edges, peak
   memory; ``intersect_count``'s kernels entry gains the streaming path's
   launches and its largest launch's shape, times and bound.
12. resilience — 12 ticks of the same feed through a
   ``ResilientDetectionService`` with a WAL and checkpoints under
   ``build/``, a transient fault in tick 3's mine retried once, then
   ``recover()`` into a fresh object: the same store state bit for bit
   and equal counts.  The ticks and the WAL replay each launch
   ``intersect_count`` and ``window_search`` on the service's own
   ``"kernel"`` backend (counts
   zeroed before each, read after; the kernels entry gains
   ``launches_resilience`` and ``launches_recovery``).
13. witnesses — (a) on phase 9's two random graphs, every library
   pattern with a witness layout (the refused ones are listed), 512 seeds
   at k = 3, under both kernel backends: the card's witnesses equal the
   port's ``GFPReference.mine_witnesses`` tuple for tuple, one host sync
   a mine, and witness-mode counts equal a counting mine's; (b)
   ``session.mine(<the 9 "full" patterns>, seeds, witnesses=2)`` over
   65,536 seeds of the phase-3 graph under ``set_sync_debug_mode("error")``
   (cycle4 and scatter_gather over a prefix, ``WIT_SEEDS_CUT``): one host
   sync per unique plan, ``window_search`` launched by the extraction,
   counts equal phase 3's rows, the first 1,024
   seeds' witnesses (scatter_gather's first 4) equal the CPU port's bit
   for bit; each
   pattern's count-only and witness-mode wall and their ratio, and peak
   memory, are printed; (c) every strictly time-ordered 3-cycle the data
   generator planted in the phase-3 dataset is a ``cycle3`` witness at its
   seed edge (k = that seed's count).
14. triage — the port's ``TriageServer`` over ``DetectionService(
   DEFAULT_PORTFOLIO, window=4096, witnesses=2)`` on the card (the
   service of ``src/repro/launch/serve.py``), fed HI-Small in time order
   through ``make_feed``: one warm submit of 65,536 transactions, then
   16 submits of 64 through 4 submitters (``load_test``), an audit log
   under ``build/``, under ``set_sync_debug_mode("error")``.  Asserted: no
   ``SubmitError`` and no degraded tick, ``intersect_count`` and
   ``window_search`` launched
   (``launches_triage``), host syncs == ticks + witness mines, every alert
   of a pattern counted this tick carries min(k, count) witnesses (and
   only those carry evidence), every evidence hop is the fed transaction
   with that id, the audit file ends with its metrics line; then a
   sequential service at k = 3 over 16,384 transactions and 8 submits of
   64, whose last tick's evidence equals the oracle on the store's
   snapshot for up to 256 pairs.  Printed: submit p50/p99/max, txns/s,
   alerts, evidence hops, suppressed duplicates, the share of tick time
   in ``tick:witness`` and the other tick spans, peak memory.
15. sharded — the phase-3 session's ``mine(backend="sharded")`` under
   ``set_sync_debug_mode("error")`` over 65,536 seeds drawn with the
   data seed: in 4 partitions (on one card they time-share it: the host
   gather), then in 1 (the device-side sum); each
   equals phase 3's rows, syncs once, launches ``intersect_count`` and
   ``window_search`` (counts
   zeroed before, read after) and has per-shard stats that sum to its
   totals.  Printed: walls, the dispatch window, the overlap ratio,
   ``shard_balance()``.  Then ``python -m repro_torch.launch.mine
   --pattern scatter_gather --parts 4 --scale 28`` once, in process.
16. FraudGT training — ``FraudGT(FraudGTParams(epochs=1)).fit`` (d_model
   128, 3 blocks, 8 heads, T = 17, batch 256) over the first 131,072
   edges of the HI-Small training split under
   ``set_sync_debug_mode("error")``: the forward launches with the
   logsumexp and the backward launches each equal n_layers * steps, every
   loss finite; the threshold picked on the trained edges
   (``benchmarks/bench_fraudgt.py``), the 1,027,527 test edges scored:
   probabilities not constant, F1 > 0, printed beside phases 3 and 5's.  Then 32
   steps of a second fit under ``torch.profiler``.
17. LM — the LM scaffold's serving path at qwen2-1.5b's published width
   (28 layers, d_model 1,536, 12 query and 2 kv heads of 128, vocab
   151,936, float32 weights drawn on the card with the data seed, bf16
   activations): (a) ``forward`` over 4 x 2,048 tokens, the counts zeroed
   just before and read just after: exactly 28 ``flash_attention``
   launches, on the path ``ops.plan`` and the ``.cu`` name ``"wgmma"``,
   finite logits; the prefill's wall, tokens/s, peak memory, its device
   profile, and the ``"torch"`` backend's max |diff| and argmax agreement
   beside it; both backends' bf16 logits against the float32 forward of
   the first sequence, the kernel's mean |diff| within 1.25 x the torch
   backend's; the first launch then checked (per row, relative to the
   row's scale) and timed (events,
   ``torch.profiler``, plain, SDPA, bound), the kernels line's
   ``lm_*`` keys; (b) in float32, ``forward`` over 1,024 tokens on both
   attention backends within 1e-3, and decode against forward over
   2 x 12 tokens within 2e-3; (c) ``repro_torch.launch.decode_lm.generate``
   serving 4 requests (prompt 16, 32 new tokens, cache 49) twice with
   identical tokens, then once at each realistic cache (4 requests at
   32,768 slots, 32 at 4,096): wall, tokens/s, ms a step, and 8 decode
   steps timed and under ``torch.profiler`` (device busy share); (d) every registry architecture's smoke config in
   float32 on the card: forward logits and ``loss_fn`` equal to the CPU
   port's within 1e-4, ``flash_attention`` launched for every attention
   block, decode equal to forward within 2e-3 for the five architectures
   of ``tests/test_models.py::test_decode_matches_forward``, and the
   mixtral ring buffer past its window against the windowed forward on
   the kernel backend; (e)
   ``python -m repro_torch.launch.decode_lm --arch qwen2-1.5b --batch 4
   --prompt-len 16 --gen 32`` in process, whose tokens equal (c)'s.
18. LM training — ``repro_torch.launch.train`` at qwen2-1.5b's published
   width: (a) the cell, 4 x 4,096 tokens a step (``train_4k``'s sequence,
   its batch of 256 cut to 4), bf16 activations over float32 weights,
   gradients and AdamW moments, remat on, the kernel attention backend:
   2 warm-up steps, 6 timed under ``set_sync_debug_mode("error")`` with
   the counts zeroed before and read after each (exactly 28 long
   backward launches and 56 forward launches with the logsumexp a step:
   remat runs each unit's forward again), 2 more under ``torch.profiler``;
   finite loss and gradient norm at every step; s/step, tokens/s, peak
   memory, the device's busy share, the attention backward's device ms a
   step and the model FLOPs' share of the bf16 peak; at the first step the
   ``"torch"`` backend's loss within 1e-2 relative and gradient norm
   within 2 %; (b) float32 over one sequence of 1,024 tokens at full width:
   ``loss_fn``'s gradient on ``"kernel"`` (simt forward, the long
   backward's simt route) within 1e-3 of each leaf's largest |g| of
   ``"torch"``'s; (c) every registry architecture's smoke config in
   float32: 4 steps of ``train_loop`` on the card and on the CPU port from
   one step-0 checkpoint, losses within 1e-4 relative and parameters
   within 5e-4, and the step-0 gradient where they differ most, on the
   CPU and twice on the card; (d) ``python -m repro_torch.launch.train --arch
   qwen2-1.5b --smoke --steps 4`` in process.
19. mesh — the LM's mesh (``repro_torch.launch.mesh``,
   ``distributed.sharding``): NCCL at world size 1 (a ``FileStore`` under
   ``build/``), ``make_local_mesh(1, 1)`` on cuda, qwen2-1.5b at its
   published width (float32 weights, bf16 activations, remat, the kernel
   backend) over 1 x 4,096 tokens a step (``train_4k``'s batch of 256 cut
   to 1): 2 plain steps, then 2 steps of ``make_sharded_train_step`` from
   the same init and batches on DTensors placed by the reference's rules
   (params by ``param_sharding``, AdamW moments by ``zero1_sharding``),
   one state on the card at a time.  Each sharded step runs under
   ``set_sync_debug_mode("error")``, its counts zeroed before and read
   after: exactly 28 long-backward and 56 forward launches with the
   logsumexp, on the wgmma paths, each rank's heads reaching the kernels
   through ``local_map``; losses within 1e-4 and parameters within 5e-3
   of the plain steps', every leaf's placements kept.  Printed: s/step
   plain and sharded, peak memory, each one's device busy share over one
   more step under ``torch.profiler``, the phase's wall; the kernels line's
   ``flash_attention`` and ``flash_attention_bwd_long`` entries gain
   ``launches_mesh_train``.
20. windowed LM — the sliding window and head size 80 at full width,
   float32 weights drawn on the card with the data seed, bf16 activations,
   the kernel backend, each counted run under
   ``set_sync_debug_mode("error")`` with the counts zeroed before and read
   after: (a) zamba2-2.7b at its published width and depth (54 layers,
   d_model 2,560, 32 heads of 80, window 4,096) prefilling 1 x 32,768
   tokens (``prefill_32k``'s sequence, its batch of 32 cut to 1): exactly
   9 ``flash_attention`` launches, on the wgmma path with the window,
   finite logits, the kernel's bf16 logits within 1.25 x the bf16
   ``"torch"`` backend's mean |diff| of the float32 ``"torch"`` forward;
   wall, tokens/s, peak memory and the device's busy share (one more
   forward under ``torch.profiler``); (b) mixtral-8x7b at full width
   (d_model 4,096, 32/8 heads of 128, 8 experts of 14,336) with its 32
   layers cut to 2 (46.7 B parameters do not fit one card), the same
   checks with 2 launches; (c) one zamba2-2.7b training step at full
   width over 1 x 4,096 tokens (``train_4k``'s, batch cut to 1), its 9
   units cut to 7, the most that fit beside the plain AdamW's
   temporaries (``tools/train_depth.py``: 7 peak at 80.0 GB, 8 and 9 run
   out of memory):
   exactly 14 forward launches with the logsumexp and 7 long-backward
   launches on the wgmma route at hd 80, finite losses and gradient
   norms, the first step's loss within 1e-2 relative and gradient norm
   within 2 % of the ``"torch"`` backend's.  Then each prefill's first
   launch is checked row by row against the plain version on its own
   inputs, one head at a time, and timed (events, ``torch.profiler``, the
   plain version, SDPA with the window's boolean mask, the operations
   bound over the 4,026,597,376 visible pairs); the ``flash_attention``
   entry gains ``launches_{zamba2,mixtral}_prefill``,
   ``launches_zamba2_train`` and the ``zamba2_*`` / ``mixtral_*`` times,
   ``flash_attention_bwd_long`` gains ``launches_zamba2_train``.
21. full-width LM — the seven registry architectures that phases 17-20
   run only at their smoke configs, at published width, one at a time:
   musicgen-medium (48 layers, 24 heads of 64, 4 codebook heads over
   precomputed frame embeddings), granite-8b (36 layers, 32 / 8 heads of
   128), mistral-nemo-12b (40 layers, 32 / 8 heads of 128 over d_model
   5,120), deepseek-coder-33b (56 / 8 heads: a group of 7), chameleon-34b
   (64 / 8, ``qk_norm``), moonshot-v1-16b-a3b (64 experts, top-6, vocab
   163,840) and xlstm-125m (12 layers, head size 192); the last three of
   the attention models cut to 16, 12 and 16 layers, the most whose
   float32 weights stay under 40 GB.  Each: float32 weights drawn on the
   card with the data seed, a 4 x 2,048 bf16 prefill through the kernel
   backend under ``set_sync_debug_mode("error")`` with the counts zeroed
   before and read after (one ``flash_attention`` launch an attention
   block, 0 for xlstm-125m, each planned ``"wgmma"`` by ``ops.plan`` and
   the ``.cu``), finite logits of (B, T, V) or musicgen's (B, T, 4, V);
   the wall, tokens/s, peak memory, the device's busy share over one more
   forward under ``torch.profiler`` and xlstm's sLSTM share of the wall;
   at 1 x 1,024 tokens the kernel's bf16 logits within 1.25 x the bf16
   ``"torch"`` backend's mean |diff| of the float32 ``"torch"`` forward;
   float32 decode against the forward over 2 x 12 tokens within 2e-3 (MoE
   at capacity 16); ``decode_lm.generate`` serving 4 requests at 4,096
   slots (prompt 16, 8 new tokens) twice with identical tokens (musicgen
   through ``decode_step`` over frame embeddings, identical codes); the
   weights freed, then the prefill's first launch checked against the
   plain version (each output row within 2^-7 of its scale) and timed
   (events, ``torch.profiler``, plain, SDPA, the operations bound); the
   ``flash_attention`` entry gains ``launches_<arch>_prefill`` and the
   ``<arch>_*`` times.
22. examples — the JAX package's five example scripts as the port's
   entry points (``repro_torch.examples``), each ``main`` run on the card
   as a user runs it, at the script's own defaults: ``quickstart``
   (HI-Small at scale 0.5, 30 trees), ``streaming_detection`` (0.3, 8
   ticks, and the documented 1.0, 12 ticks), ``train_aml_pipeline`` (0.4,
   five feature sets of 40 trees, FraudGT for 3 epochs), ``serve_lm``
   (qwen2-1.5b's and xlstm-125m's smoke configs, 8 requests of 12 + 24
   tokens, 48 slots) and ``trace_capture`` (0.2, traces under
   ``build/examples/``), each with its counts zeroed before and read
   after.  Asserted: the examples' own checks (``roundtrip3`` equal to
   the port's ``GFPReference``, the incremental ``cycle3`` equal to the
   batch recompute, the ``full`` F1 above 0, both traces holding
   ``dispatch:shard0`` ... ``dispatch:shard7`` and
   ``tick:ingest/plan/mine/score``, the served tokens of (8, 36) with the
   prompt kept); ``intersect_count`` and ``window_search`` launched in the
   mining examples, both
   ``hist_update`` entries in the pipelines, the attention forward with
   the logsumexp and the short backward in FraudGT's fit, no attention
   kernel in serving.  Then each example's function on the card and on
   the CPU port at one small size (``EXAMPLE_CHECK``): integer outputs
   equal (portfolio columns, ``roundtrip3``, every tick's counters, alerts
   and scores, span-name counts), the GBDT fits by phase 6's rule (equal
   trees and then equal F1, or a first difference at a near tie),
   FraudGT's card-trained weights scoring the test split on the CPU
   within 1e-4, serving's float32 smoke logits within 1e-4.  One JSON
   line an example (wall, printed numbers, launches); every kernels entry
   gains ``launches_examples``.

It imports torch, numpy and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the non-tensor-core
# rate; one pair test of intersect_count, one addition of hist_update and
# one compare-and-add of window_degree are each counted as one operation;
# flash_attention's flops count against float32 (67 T/s, no TF32: float32
# results stay float32) or the dense bf16 tensor-core peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12
KERNELS = ("intersect_count", "hist_update", "window_degree", "flash_attention", "window_search")
SMOKE_SHAPES = ((1, 4), (1, 1024), (4, 4), (16, 64), (64, 256), (256, 256), (1024, 1024))
RAGGED_B = (1, 33, 4097)
HU_SHAPES = ((16, 8), (1000, 97), (4096, 512), (513, 2048), (1, 1), (0, 64))  # (N, S)
# hist_update's keys entry: each cluster size (the kernel holds 14,528
# keys a block, in clusters of 1, 2, 4, 8 or 16 blocks) and past the limit
HU_CLUSTER_SHAPES = tuple((1 << 20, s) for s in (14_528, 14_529, 29_057, 58_113, 116_225, 232_448, 232_449))
HU_LEVEL_S = tuple(3072 << lv for lv in range(6))  # the fit's levels at F = 12, B = 256
# hist_update's rows entry (N rows, F, B, n_nodes): the fit's levels, a
# 16-block cluster, past the limit, narrow shapes and zero rows
HU_ROWS_SHAPES = (
    *((1 << 19, 12, 256, 1 << lv) for lv in range(6)),
    (1 << 18, 12, 256, 64),
    (1 << 17, 12, 256, 128),
    (1000, 1, 16, 2),
    (4097, 3, 7, 5),
    (0, 12, 256, 4),
)
# (B, D): tests/test_kernels.py's, then three to time: (16384, 128), where
# a launch costs more than its bytes, and two of about 140 MB each
WD_SHAPES = ((1, 1), (7, 16), (64, 128), (100, 33), (16384, 128), (1 << 20, 32), (1 << 18, 128))
# window_search in phase 2: the compiler's operand forms (each entry at
# halvings that cover every row and at fewer), WS_B queries a form, and a
# hub row of HI-Small's largest degree at scale 282
WS_ENTRIES = ("count_window", "count_window_pos", "count_id_in_window", "count_id_in_window_pos")
WS_FORMS = ("rank1", "lifted", "mid_lift", "rank4", "ints", "inverted", "wrap", "neg_wrap", "offset", "row", "row_wide",
            "int_node")
WS_B = 4097
WS_HUB = 340_391
# window_search's intersect_step in phase 2: each form in both strategies
# (bs1, bs2), and a hub row of WS_HUB entries swept at D = 1,024 in 512
# steps, the mining path's hub buckets (WS_STEP_HUB_B lead elements)
WS_STEP_FORMS = ("plain", "ordered", "skip3", "sweep8", "wide", "partial", "wrap", "ints", "rank3", "offset")
WS_STEP_HUB_B = 256
# intersect_count's broadcast forms in phase 2: (B_fixed, rep, Da, Db) at
# both paths, ragged, and the two paths' largest launch shapes
IC_FORM_SHAPES = ((1, 1, 1, 4), (33, 3, 4, 4), (4097, 64, 1, 4), (4096, 32, 1, 32), (129, 3, 16, 64),
                  (11, 3, 64, 64), (4, 64, 256, 256), (256, 1, 1024, 1024))
WINDOW = 4096
SEED = 0  # data seed
# The script must end within 1,200 s on a machine whose host may be far
# slower than the one it was timed on (957 s on one NVIDIA H100 machine
# at 700 W, more than 1,200 s for the same tree on another), so it aims
# at well under 1,200 s on such a host: the depths marked "cut for the
# time limit" were cut for that, each path still driven, and phase 3's
# warm re-mine covers WARM_SEEDS seeds, not every edge (PERF.md section 4
# lists the cuts with their sizes before)
CPU_SEEDS = 4096  # seeds the CPU cross-check mines
WARM_SEEDS = 1 << 14  # seeds mined twice on the main path's session: the warm re-mine
TORCH_SEEDS = 1 << 16  # seeds the "torch"-backend cross-check mines (cut for the time limit)
DET_ROWS = 1 << 20  # training rows of the card's determinism fits
CPU_FIT_ROWS = 1 << 17  # training rows of the card-against-CPU fits (cut for the time limit)
CHECK_TREES = 10  # trees of each cross-check fit
FGT_CHECK_EDGES = 16384  # test edges of the FraudGT cross-checks
FGT_PROFILE_EDGES = 1 << 17  # test edges of the profiled FraudGT forward
PROFILE_TRIES = 3  # torch.profiler runs before a device time is "not measured"
# written between the timed launches of the paths' largest intersect_count
# calls (read between those of the short attention backward), so that
# each finds its operands in HBM and not in the 50 MB L2 (the operands are
# 3-22 MB; the bound counts HBM bytes)
L2_FLUSH_BYTES = 256 << 20
# flash_attention cases (B, T, S, H, K, hd, causal, dtype): those of
# tests/test_flash_attention.py (its hypothesis test is drawn for seeds
# 0-7 in phase_flash_attention and put after them), causal T > S with S
# unaligned, FraudGT's shape (the short path), the short path with GQA in
# bf16, and the wgmma path: a long bf16 shape causal and not, at hd 64,
# with ragged tiles (1,000 rows and keys), and qwen2-1.5b's prefill launch
# (phase 17: 12 query heads over 2 kv heads, a group of 6)
FA_TEST_CASES = 11  # the first 11 are tests/test_flash_attention.py's
FA_CASES = (
    *((2, t, t, 4, 4, 32, c, "float32") for t in (64, 128, 256) for c in (True, False)),
    (1, 128, 128, 8, 2, 64, True, "float32"),
    (1, 128, 128, 4, 4, 64, True, "bfloat16"),
    (1, 96, 96, 2, 2, 32, True, "float32"),
    (1, 256, 256, 1, 1, 32, True, "float32"),
    (2, 80, 50, 4, 2, 16, True, "float32"),
    (1024, 17, 17, 8, 8, 16, True, "float32"),  # FraudGT: 1,024 edges x 8 heads
    (1001, 17, 17, 8, 2, 32, False, "bfloat16"),
    (1, 4096, 4096, 32, 8, 128, True, "bfloat16"),
    (1, 4096, 4096, 32, 8, 128, False, "bfloat16"),
    (1, 4096, 4096, 32, 8, 64, True, "bfloat16"),
    (2, 1000, 1000, 8, 2, 128, True, "bfloat16"),
    (4, 2048, 2048, 12, 2, 128, True, "bfloat16"),
)
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the sliding window and head size 80 (B, T, S, H, K, hd, window, dtype):
# on each path a window below T, at T and above T (T > S there): short,
# simt (hd 80 in float32 below T) and wgmma (hd 128 just past a tile, hd
# 80 at T: zamba2's heads at train_4k's length)
FA_WINDOW_CASES = (
    (1024, 17, 17, 8, 8, 16, 5, "float32"),
    (64, 32, 32, 4, 4, 64, 32, "bfloat16"),
    (64, 20, 12, 8, 2, 32, 40, "float32"),
    (1, 500, 500, 4, 2, 80, 100, "float32"),
    (1, 257, 257, 4, 1, 16, 257, "bfloat16"),
    (1, 300, 200, 4, 2, 32, 500, "float32"),
    (2, 1000, 1000, 8, 2, 128, 129, "bfloat16"),
    (1, 4096, 4096, 32, 32, 80, 4096, "bfloat16"),
    (1, 700, 500, 4, 2, 64, 1000, "bfloat16"),
)
# the short-path backward (B, T, S, H, K, hd, causal, dtype): FraudGT's
# training shape (a batch of 256 edges), its inference chunk, GQA with
# T > S, the short-path cases of tests/test_torch_cuda.py (a ragged B past
# the grid, the 32/32 edge at hd 128, one key; in bf16 GQA, whole kv groups
# in chunks, one group in parts) and a block at the shared-memory limit;
# then the ring route's edges, as in that file: causal T < S, GQA 4:1 at
# hd 16 in bf16 and hd 32 in float32, an lse the stage cannot bulk-copy
# (H * T = 34), the last head count whose two stages fit and the first on
# the chunked route, a chunked shape in full attention; float32 within
# FA_BWD_TOL absolute, bf16 within 2e-2 relative and absolute (one
# rounding of each output)
FA_BWD_CASES = (
    (256, 17, 17, 8, 8, 16, True, "float32"),
    (1024, 17, 17, 8, 8, 16, True, "float32"),
    (1000, 20, 12, 8, 2, 16, True, "float32"),
    (5003, 17, 17, 8, 8, 16, True, "float32"),
    (37, 32, 32, 2, 2, 128, True, "float32"),
    (3, 1, 1, 8, 8, 16, True, "float32"),
    (2, 32, 32, 12, 1, 64, True, "float32"),
    (1001, 17, 17, 8, 2, 32, False, "bfloat16"),
    (5, 32, 32, 4, 4, 128, True, "bfloat16"),
    (3, 32, 32, 16, 1, 64, True, "bfloat16"),
    (300, 12, 20, 8, 2, 16, True, "float32"),
    (700, 17, 17, 8, 2, 16, True, "bfloat16"),
    (700, 17, 17, 8, 2, 32, True, "float32"),
    (333, 17, 17, 2, 1, 16, True, "float32"),
    (40, 32, 32, 7, 7, 16, True, "float32"),
    (20, 32, 32, 8, 8, 16, True, "float32"),
    (6, 32, 32, 3, 3, 64, False, "float32"),
)
# the ring route's batch edges at FraudGT's training shape (T, S, H, K,
# hd, causal, dtype): B below the card's persistent grid, equal to it, one
# past a whole turn of the ring (grid x stages) and a B no multiple of the
# grid reaches (tests/test_torch_cuda.py's RING_EDGES)
FA_BWD_RING_SHAPE = (17, 17, 8, 8, 16, True, "float32")
FA_BWD_RING_EDGES = ("below", "equal", "turn_plus_one", "ragged")
FA_BWD_TOL = 1e-5
# the long backward (csrc/flash_long_bwd.cuh; B, T, S, H, K, hd, causal,
# dtype): qwen2-1.5b's training launch (phase 18), full attention in bf16
# at hd 64, ragged tiles (1,000 rows and keys), causal T > S, float32 at
# hd 16 and 128 with GQA (its simt route; the second is phase 18's float32
# check's launch), bf16 at hd 32 (simt), a single key, and the wgmma
# route's tile edges (64-row stages, 128-row and 128-key blocks): T = S =
# 127, 129 and 257 at hd 64 and 128, a group of 8 over K = 1.  bf16 within
# 2e-2 relative and absolute; float32 within FA_BWD_TOL absolute plus
# FA_BWD_TOL relative (its sums run over up to 1,024 rows in another
# order than the plain version's, and grow with them)
FA_LONG_BWD_CASES = (
    (4, 4096, 4096, 12, 2, 128, True, "bfloat16"),
    (2, 2048, 2048, 8, 8, 64, False, "bfloat16"),
    (2, 1000, 1000, 8, 2, 128, True, "bfloat16"),
    (2, 1024, 384, 8, 2, 128, True, "bfloat16"),
    (1, 512, 512, 8, 2, 16, True, "float32"),
    (1, 1024, 1024, 12, 2, 128, True, "float32"),
    (2, 1024, 1024, 8, 2, 32, True, "bfloat16"),
    (4, 64, 1, 4, 4, 64, True, "bfloat16"),
    (2, 127, 127, 4, 2, 64, True, "bfloat16"),
    (1, 127, 127, 8, 1, 128, False, "bfloat16"),
    (1, 129, 129, 4, 2, 128, True, "bfloat16"),
    (2, 129, 129, 8, 1, 64, False, "bfloat16"),
    (1, 257, 257, 8, 1, 128, True, "bfloat16"),
    (1, 257, 257, 4, 4, 64, True, "bfloat16"),
)
# the backward under a window and at hd 80 (B, T, S, H, K, hd, window,
# dtype): on each route a window below T, at T and above T (T > S on all
# but the chunked route):
# the short backward's ring and chunked routes, the long backward's simt
# route (hd 80 in float32 above T) and its wgmma route (hd 128, hd 64 just
# past a tile, and zamba2's training launch: 32 heads of 80 at T = 4,096
# under its window of 4,096, which masks nothing there)
FA_WINDOW_BWD_CASES = (
    (256, 17, 17, 8, 8, 16, 5, "float32"),
    (64, 20, 12, 8, 2, 32, 40, "float32"),
    (64, 32, 32, 4, 4, 64, 32, "bfloat16"),
    (20, 32, 32, 8, 8, 16, 9, "float32"),
    (20, 32, 32, 8, 8, 16, 32, "float32"),
    (20, 32, 32, 8, 8, 16, 60, "float32"),
    (1, 512, 512, 8, 2, 16, 100, "float32"),
    (1, 257, 257, 4, 1, 16, 257, "bfloat16"),
    (1, 300, 200, 4, 2, 80, 500, "float32"),
    (1, 2048, 2048, 12, 2, 128, 512, "bfloat16"),
    (2, 1000, 1000, 8, 2, 64, 129, "bfloat16"),
    (1, 4096, 4096, 32, 32, 80, 4096, "bfloat16"),
    (1, 700, 500, 4, 2, 64, 1000, "bfloat16"),
)
# T and S whose wgmma-route tile loops the .cu must give as ops.bwd_tiles
# (and, under FA_TILE_WINDOWS, the forward's as ops.fwd_tiles)
FA_BWD_TILE_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 257, 1000, 4096)
FA_TILE_WINDOWS = (None, 1, 64, 100, 128, 129, 1000, 4096, 5000)
# phase 9: the oracle's random graphs (nodes, edges, t_max) and their
# seeds, sized so GFPReference takes under a minute for the 12 full_deep
# patterns on every edge of the three; the Fig. 10 protocol's seeds
ORACLE_GRAPH = (512, 5120, 4096)
ORACLE_SEEDS = (0, 1)  # three until cut for the time limit
FIG10_SEEDS = 2000
FIG10_ORACLE_SEEDS = 400
PART_SEEDS = 1 << 16  # phase 10: seeds of the partitioned mine (cut for the time limit)
PART_N = 4
# phase 11: the live feed (HI-Small in time order): a first tick, then
# STREAM_TICKS ticks of STREAM_BATCH transactions, at the thresholds of
# examples/streaming_detection.py; no new launch shape in the last
# quarter of the ticks (the steady window of benchmarks/bench_streaming.py);
# the ticks after STREAM_WARM_TICKS that still mint one are reported; a
# sequential service replays the first STREAM_CHECK_TICKS ticks
STREAM_FIRST = 65536
STREAM_BATCH = 8192
STREAM_TICKS = 48
STREAM_THRESHOLDS = {"cycle3": 1, "scatter_gather": 1, "fan_in": 6}
STREAM_WARM_TICKS = 8
STREAM_CHECK_TICKS = 8  # 16 until cut for the time limit
RESILIENCE_TICKS = 12  # phase 12
RESILIENCE_CHECKPOINT_EVERY = 5
# phase 13: witnesses.  (a) the oracle's graphs, WIT_ORACLE_SEEDS seeds at
# k = WIT_ORACLE_K; (b) the session's witness mode over WIT_SEEDS seeds of
# the phase-3 graph at k = WIT_K, the first WIT_CPU_SEEDS of them also on
# the CPU port (4,096 until phase 18 came, then 2,048, then 1,024).  The
# CPU port's witness mines take 57-86 s for scatter_gather's 16 seeds and
# 1.2 s for the other patterns' 1,024 on NVIDIA H100 machines at 700 W,
# the host's speed varying between them, so scatter_gather's CPU check is
# cut to 4 seeds for the time limit
WIT_ORACLE_SEEDS = 512
WIT_ORACLE_K = 3
WIT_SEEDS = 1 << 16
WIT_K = 2
WIT_CPU_SEEDS = 1024
# bulk-only witness schedules cannot decompose hub rows into branches as a
# counting mine does, so hub seeds sweep whole rows: at this size up to
# 8,192 offset combinations a launch for cycle4 (253 s over 65,536 seeds
# on an NVIDIA H100 at 700 W) and 1,024 for scatter_gather (123 s over
# 4,096 seeds, 24-31.5 s over 512, cut to 64 for the time limit).
# These patterns mine a prefix of the seeds, and scatter_gather's CPU
# check a shorter one (PERF.md section 4 lists the cuts)
WIT_SEEDS_CUT = {"cycle4": 4096, "scatter_gather": 64}
WIT_CPU_SEEDS_CUT = {"scatter_gather": 4}
# phase 14: the triage server (src/repro/launch/serve.py's service and
# defaults) over HI-Small in time order: one warm submit, then
# TRIAGE_SUBMITS submits of TRIAGE_BATCH through TRIAGE_SUBMITTERS
# threads; then a sequential service at k = TRIAGE_EXACT_K whose last
# tick's evidence is held to the oracle for up to TRIAGE_EXACT_PAIRS
# pairs.  A live submit takes 1.47 s on an NVIDIA H100 at 700 W (751 s
# for 512), so the submits are cut to 16 (64 until phases 15-16 came,
# then 32 until cut for the time limit)
TRIAGE_WARM = 1 << 16  # 262,144 until cut for the time limit
TRIAGE_BATCH = 64
TRIAGE_SUBMITS = 16
TRIAGE_SUBMITTERS = 4
TRIAGE_K = 2
TRIAGE_EXACT_WARM = 16384
TRIAGE_EXACT_SUBMITS = 8
TRIAGE_EXACT_K = 3
TRIAGE_EXACT_PAIRS = 256
# phase 15: the sharded mine of the phase-3 portfolio: SHARD_PARTS
# partitions over SHARD_SEEDS seeds drawn with the data seed (time-shared
# on one card: the host gather), then one partition over the same seeds
# (the device-side sum); then repro_torch.launch.mine's command line.
# Every edge and 1,048,576 seeds until cut for the time limit, then
# 262,144 (53.5 s in 4 parts, 15.8 s in 1, on an NVIDIA H100 at 700 W)
SHARD_PARTS = 4
SHARD_SEEDS = 1 << 16
SHARD_CLI_ARGS = ("--pattern", "scatter_gather", "--parts", "4", "--scale", "28")
# phase 16: FraudGT trained for FGT_EPOCHS epoch (the reference trains 3)
# on the first FGT_FIT_ROWS training edges, its threshold picked on the
# edges it trained on (as benchmarks/bench_fraudgt.py picks it on its
# training edges), then scored on the test split.  One epoch over all
# 4,110,125 training edges takes 236-255 s of steps (63-68 steps/s, host
# bound) on an NVIDIA H100 at 700 W and the threshold 48-58 s more
# (tools/smoke_phases.py --fit-rows 0), so the rows are cut to 131,072
# (1,048,576 until phase 17 came, then 655,360 until cut for the time
# limit: 43.1 s of steps at 655,360, 22.3-24.2 s at 262,144-393,216, F1
# 0.988-0.991); FGT_PROFILE_STEPS steps of a second fit run under
# torch.profiler
FGT_EPOCHS = 1
FGT_FIT_ROWS = 1 << 17
FGT_PROFILE_STEPS = 32
# phase 17: the LM scaffold at qwen2-1.5b's published width (28 layers,
# d_model 1,536, bf16 activations over float32 weights drawn with SEED):
# a prefill of LM_PREFILL (batch, tokens) through flash_attention, timed
# LM_PREFILL_REPS times; float32 checks at LM_F32_T tokens (both attention
# backends) and LM_DECODE (batch, tokens) of decode against forward;
# generate serving LM_SERVE (requests, prompt, new tokens) twice and
# once at each of LM_SERVE_CACHES, each followed by a few decode steps
# under torch.profiler; every architecture's smoke
# config in float32 at LM_SMOKE (batch, tokens) on the card against the
# CPU port; repro_torch.launch.decode_lm's command line with LM_CLI_ARGS
LM_ARCH = "qwen2-1.5b"
LM_PREFILL = (4, 2048)
LM_PREFILL_REPS = 3
LM_F32_T = 1024
LM_DECODE = (2, 12)
LM_SERVE = (4, 16, 32)
# (requests, cache slots) of the timed serving cells: decode_32k's 32,768
# slots at 4 of its 128 sequences (all 128 would need 120 GB of bf16 KV at
# qwen2's width, more than the card's 80 GB), and 32 sequences at 4,096
# slots; each holds 3.76 GB of KV
LM_SERVE_CACHES = ((4, 32768), (32, 4096))
# the kernel backend's bf16 logits may be at most this many times further
# from the float32 logits (mean |diff|) than the torch backend's are
LM_BF16_ERR_RATIO = 1.25
LM_PROFILE_STEPS = 8
LM_SMOKE = (2, 16)
LM_DECODE_ARCHS = ("qwen2-1.5b", "mixtral-8x7b", "zamba2-2.7b", "xlstm-125m", "chameleon-34b")
LM_CLI_ARGS = ("--arch", LM_ARCH, "--batch", "4", "--prompt-len", "16", "--gen", "32")
# phase 18: LM training at qwen2-1.5b's published width, train_4k's
# sequence of 4,096 (src/repro/configs/base.py:90) with the batch cut from
# 256 to TRAIN_CELL[0]; TRAIN_WARM steps, then TRAIN_STEPS timed under
# set_sync_debug_mode("error"), TRAIN_PROFILE_STEPS more under
# torch.profiler; every smoke config trained TRAIN_SMOKE_STEPS steps on the
# card and on the CPU port from one checkpoint, at TRAIN_SMOKE_SEQ tokens
# (past the window of 32 of mixtral's and zamba2's smoke configs: the
# windowed kernels both ways); the launcher with TRAIN_CLI_ARGS in process
TRAIN_CELL = (4, 4096)
TRAIN_WARM = 2
TRAIN_STEPS = 6
TRAIN_PROFILE_STEPS = 2
TRAIN_F32_T = 1024  # the float32 gradient check's tokens (one sequence)
TRAIN_SMOKE_STEPS = 4
TRAIN_SMOKE_SEQ = 64
# the smoke trainings' bounds, card against CPU: losses within 1e-4
# relative; parameters within half of one AdamW step at lr 1e-3.  AdamW
# divides each update by sqrt(v) + 1e-8, so where a gradient element is
# zero in exact arithmetic its rounding sets the update: at mixtral's
# worst element (attn/wo) the step-0 gradient is -6.8e-9 on the CPU and
# 3.5e-8 on the card, 6e-8 of the leaf's largest |g|, the card's the same
# in two runs (smoke_grad_reading; PERF.md section 6)
TRAIN_SMOKE_LOSS_RTOL = 1e-4
TRAIN_SMOKE_PARAM_ATOL = 5e-4
TRAIN_CLI_ARGS = ("--arch", LM_ARCH, "--smoke", "--steps", "4")
# phase 19: the sharded train step on a (1, 1) NCCL mesh at qwen2-1.5b's
# published width, train_4k's sequence with its batch of 256 cut to 1
# (phase 18's cell is 4), MESH_STEPS plain steps then MESH_STEPS sharded
# ones from the same init and batches, one state on the card at a time
MESH_CELL = (1, 4096)
MESH_STEPS = 2
MESH_LOSS_ATOL = 1e-4
MESH_PARAM_ATOL = 5e-3
# phase 20: the sliding window (4,096) and head size 80 at full width.
# zamba2-2.7b (src/repro/configs/registry.py's published width and all 54
# layers) and mixtral-8x7b (full width, its 32 layers cut to
# WIN_MIXTRAL_LAYERS: 46.7 B parameters do not fit one card) each prefill
# prefill_32k's sequence of WIN_PREFILL_T tokens, its batch of 32 cut to 1,
# after a warm-up forward over WIN_WARM_T; one zamba2 training step over
# train_4k's sequence (WIN_TRAIN, its batch of 256 cut to 1) with its 9
# units cut to WIN_TRAIN_UNITS, the most that fit beside the plain AdamW's
# temporaries (D9): tools/train_depth.py on an NVIDIA H100 80GB HBM3 at
# 700 W peaked at 32.1, 41.7, 60.8 and 80.0 GB at 2, 3, 5 and 7 units, and
# 8 and 9 ran out of memory
WIN_PREFILL_T = 32768
WIN_WARM_T = 4096
WIN_MIXTRAL_LAYERS = 2
WIN_TRAIN = (1, 4096)
WIN_TRAIN_UNITS = 7

# phase 21: the seven registry architectures that phases 17-20 run only at
# their smoke configs, at published width (src/repro/configs/registry.py),
# in this order; each prefills LM_PREFILL (prefill_32k's batch of 32 and
# its 32,768 tokens cut as phase 17 cuts them) after a warm-up forward over
# WIDE_WARM_T tokens a sequence, holds its bf16 logits to the float32
# "torch" forward at 1 x LM_F32_T and decode to forward at LM_DECODE, and
# serves WIDE_SERVE (requests, cache slots, prompt, new tokens) twice; its
# prefill's first flash_attention launch is held to the plain version,
# each output row within WIDE_ROW_TOL of the row's largest |value| (the
# worst row of phase 17's launch: one bf16 step at the top of a binade),
# and timed WIDE_FA_REPS times
WIDE_ARCHS = ("musicgen-medium", "granite-8b", "mistral-nemo-12b", "deepseek-coder-33b", "chameleon-34b",
              "moonshot-v1-16b-a3b", "xlstm-125m")
# depths cut to the most layers whose float32 weights stay under 40 GB,
# which leaves room for the float32 reference forward, the casts at each
# use and moonshot's 163,840-wide logits (M.n_params): 62 -> 16 layers
# (35.8 GB), 48 -> 12 (37.5 GB), 48 -> 16 (39.2 GB); the others run at
# their published depth (mistral-nemo-12b's 40 layers are 49.0 GB)
WIDE_LAYERS = {"deepseek-coder-33b": 16, "chameleon-34b": 12, "moonshot-v1-16b-a3b": 16}
WIDE_WARM_T = 512
WIDE_ROW_TOL = 2.0 ** -7
WIDE_FA_REPS = 10
WIDE_SERVE = (4, 4096, 16, 8)

# phase 22: the JAX package's five examples as the port's entry points,
# each run by its main at the script's own defaults (streaming_detection
# also at its documented --scale 1.0 --batches 12), then the card against
# the CPU port at one small size each, the same on both sides
EXAMPLE_RUNS = (
    ("quickstart", "quickstart", ()),
    ("streaming_detection", "streaming_detection", ()),
    ("streaming_detection_scale1", "streaming_detection", ("--scale", "1.0", "--batches", "12")),
    ("train_aml_pipeline", "train_aml_pipeline", ()),
    ("serve_lm", "serve_lm", ()),
    ("trace_capture", "trace_capture", ("--out-dir", str(ROOT / "build" / "examples" / "traces"))),
)
EXAMPLE_CHECK = {"quickstart": {"scale": 0.1, "trees": 5}, "streaming_detection": {"scale": 0.1, "batches": 4},
                 "train_aml_pipeline": {"scale": 0.1, "trees": 5, "epochs": 1}, "trace_capture": {"scale": 0.05}}
EXAMPLE_SERVE = (8, 12, 24, 48)  # serve_lm's batch, prompt, new tokens, cache, as the script's
EXAMPLE_PROBA_TOL = 1e-4  # phase 7's: FraudGT's probabilities from the same weights, card and CPU
EXAMPLE_LOGIT_TOL = 1e-4  # phase 17 (d)'s: float32 smoke logits, card and CPU
# what the returned records hold beside the printed numbers: arrays and
# objects for the checks, kept out of the example's JSON line
EXAMPLE_BULKY = ("plan_text", "counts", "roundtrip3_counts", "roundtrip3_oracle", "pipeline", "results",
                 "fraudgt_proba", "prompts", "tokens", "sharded_counts", "sharded_summary", "exposition", "alerts",
                 "scores")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: int, ops: int, peak_ops: float = PEAK_OPS_PER_S):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger, and which."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ic_bound_ms(args):
    """intersect_count's bound on its operands as passed: every tensor
    read once (the fixed side at its own rows, a scalar window not at
    all), the (B,) int32 output written once; Da * Db pair tests a row."""
    import torch

    b, da = args[0].shape
    nbytes = sum(x.numel() * 4 for x in args if isinstance(x, torch.Tensor)) + 4 * b
    return bound_ms(nbytes, b * da * args[2].shape[1])


def hu_bound_ms(n: int, s: int):
    # keys and gh rows read once, the (S, 2) float32 sums written once
    return bound_ms(n * 12 + s * 8, 2 * n)


def hu_rows_bound_ms(n: int, f: int, s: int):
    # each row's F bins, node id and gh pair read once, the sums written once
    return bound_ms(n * (f + 12) + s * 8, 2 * n * f)


def wd_bound_ms(b: int, d: int):
    return bound_ms(b * (4 * d + 12), b * d)


def visible_pairs(t: int, s: int, causal: bool, window=None) -> int:
    """The (row, key) pairs of one head that the mask lets through: key j <
    S of row i < T, j <= i when causal, i - j < window under a window
    (4,026,597,376 over 32 heads at T = S = 32,768 and a window of 4,096)."""
    if not causal:
        return t * s
    return sum(min(i + 1, s) - (max(0, i - window + 1) if window else 0) for i in range(t))


def fa_bound_ms(b, t, s, h, kvh, hd, causal, dtype, window=None):
    """q, k, v read once and o written once; 4 * hd flops per (row, key)
    pair that the mask (and the window) lets through."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * t * h * hd + 2 * b * s * kvh * hd) * size
    pairs = visible_pairs(t, s, causal, window)
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_OPS_PER_S
    return bound_ms(nbytes, 4 * hd * pairs * b * h, peak)


def fa_bwd_bound_ms(b, t, s, h, kvh, hd, causal, dtype, window=None):
    """The backward's bytes: q, k, v, o, dO and the float32 lse read once,
    dQ, dK, dV written once; its operations: 10 * hd flops per (row, key)
    pair the mask lets through (the scores again, dP, dV, dQ and dK, two
    flops a multiply-add each)."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (4 * b * t * h * hd + 4 * b * s * kvh * hd) * size + 4 * b * h * t
    pairs = visible_pairs(t, s, causal, window)
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_OPS_PER_S
    return bound_ms(nbytes, 10 * hd * pairs * b * h, peak)


def cuda_ms(fn, reps: int, before=None) -> float:
    """Mean time of a call of ``fn`` by CUDA events: over ``reps`` calls in
    a row, or, given ``before``, each call timed alone after ``before()``
    has run (on the card, outside the timed span)."""
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    if before is not None:
        spans = []
        for _ in range(reps):
            before()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            spans.append((start, stop))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spans) / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ic_inputs(b, da, db, gen, device):
    """Random intersect_count inputs drawn on the card (ids in [-1, 8) so
    rows match often, windows that may invert)."""
    import torch

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    a_lo = ri(-4, 32, (b,))
    b_lo = ri(-4, 32, (b,))
    return (
        ri(-1, 8, (b, da)),
        ri(0, 64, (b, da)),
        ri(-1, 8, (b, db)),
        ri(0, 64, (b, db)),
        a_lo,
        a_lo + ri(-8, 64, (b,)),
        b_lo,
        b_lo + ri(-8, 64, (b,)),
    )


def ic_materialised(args):
    """intersect_count's operands with the broadcast forms expanded: the
    fixed side repeated to B rows, every window a (B,) tensor, a zero
    a-side time for a missing one (the plain version's operands)."""
    import torch

    a_ids, a_t, b_ids, b_t = args[:4]
    b = a_ids.shape[0]
    rep = b // max(1, b_ids.shape[0])

    def rows(w):
        if not isinstance(w, torch.Tensor):
            return torch.full((b,), w, dtype=torch.int32, device=a_ids.device)
        return w if w.shape[0] == b else w.repeat_interleave(rep)

    return (a_ids, torch.zeros_like(a_ids) if a_t is None else a_t,
            b_ids.repeat_interleave(rep, 0), b_t.repeat_interleave(rep, 0), *map(rows, args[4:]))


def ic_forms(bf, rep, da, db, gen, device, windows, a_time=True):
    """Operands in the compiler's broadcast forms: B = bf * rep rows, a
    fixed side of bf rows, the windows ints (``"scalar"``) or tensors at
    the fixed side's rate with a per-row a window (``"mixed"``)."""
    import torch

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    b = bf * rep
    if windows == "scalar":
        bounds = (5, 40, -3, 50)
    else:
        a_lo, b_lo = ri(-4, 32, (b,)), ri(-4, 32, (bf,))
        bounds = (a_lo, a_lo + ri(-8, 64, (b,)), b_lo, b_lo + ri(-8, 64, (bf,)))
    if not a_time:
        bounds = (-(2**31), 2**31 - 1) + bounds[2:]
    return (ri(-1, 8, (b, da)), ri(0, 64, (b, da)) if a_time else None, ri(-1, 8, (bf, db)),
            ri(0, 64, (bf, db)), *bounds)


def offset_view(x):
    """A contiguous copy of x that starts one word into its storage."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def ic_plain_rows(args, ordered, max_cube=1 << 27):
    """The plain version on the materialised operands, row-chunked so its
    compare cube stays small."""
    import torch
    from repro_torch.kernels.intersect_count.ref import intersect_count_ref

    args = ic_materialised(args)
    b, da = args[0].shape
    db = args[2].shape[1]
    step = max(1, max_cube // (da * db))
    outs = [
        intersect_count_ref(*(x[r : r + step] for x in args), ordered=ordered)
        for r in range(0, b, step)
    ]
    return torch.cat(outs) if outs else torch.zeros(0, dtype=torch.int32, device=args[0].device)


def phase_kernel(device, report):
    import torch
    from repro_torch.kernels.intersect_count import ops as ic_ops

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    max_err = 0
    n_cases = 0
    for da, db in SMOKE_SHAPES:
        for ordered in (False, True):
            for b in RAGGED_B:
                args = ic_inputs(b, da, db, gen, device)
                got = ic_ops.intersect_count(*args, ordered=ordered)
                want = ic_plain_rows(args, ordered)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                n_cases += 1
                if err:
                    raise AssertionError(f"intersect_count differs at B={b} Da={da} Db={db} ordered={ordered}: {err}")
    # the hand-built cases: duplicate ids, fully padded sides, an inverted
    # window, ordered ties at equal times
    t = lambda rows: torch.tensor(rows, dtype=torch.int32).to(device)
    case = (
        t([[3, 3, 3, -1], [-1, -1, -1, -1], [0, 1, 2, 3], [5, 5, -1, -1], [7, 7, 7, 7]]),
        t([[10, 20, 30, 99], [0, 0, 0, 0], [5, 6, 7, 8], [50, 60, 0, 0], [10, 10, 10, 10]]),
        t([[3, 3, -1], [1, 2, 3], [-1, -1, -1], [5, 5, 5], [7, 7, 7]]),
        t([[15, 25, 0], [1, 2, 3], [0, 0, 0], [55, 65, 75], [10, 11, 9]]),
        t([0, 0, 4, 40, 0]),
        t([25, 10, 9, 70, 99]),
        t([0, 0, 0, 60, 0]),
        t([30, 10, 9, 50, 99]),
    )
    for ordered in (False, True):
        got = ic_ops.intersect_count(*case, ordered=ordered).cpu()
        want = ic_plain_rows(case, ordered).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"intersect_count edge cases differ (ordered={ordered}): {got} vs {want}")
        expect = {0: 4, 3: 0} if not ordered else {4: 4}
        for r, v in expect.items():
            if int(got[r]) != v:
                raise AssertionError(f"edge case row {r}: {int(got[r])} != {v}")
        n_cases += 1
    # the broadcast forms, and operands one word into their storage
    paths = set()
    for bf, rep, da, db in IC_FORM_SHAPES:
        b = bf * rep
        path = ic_ops.plan(b, da, db)
        if ic_ops.kernel_plan(b, da, db) != path:
            raise AssertionError(f"ops.plan and the .cu entry choose different paths at ({b}, {da}, {db})")
        paths.add(path)
        for windows in ("mixed", "scalar"):
            for ordered, a_time in ((False, True), (True, True), (False, False)):
                args = ic_forms(bf, rep, da, db, gen, device, windows, a_time)
                want = ic_plain_rows(args, ordered)
                for form, run in (("broadcast", args), ("offset", tuple(
                        offset_view(x) if isinstance(x, torch.Tensor) else x for x in args))):
                    got = ic_ops.intersect_count(*run, ordered=ordered)
                    err = int((got.long() - want.long()).abs().max())
                    n_cases += 1
                    if err:
                        raise AssertionError(f"intersect_count differs ({form}, {windows}, a_t={a_time}, "
                                             f"ordered={ordered}) at B={b} rep={rep} Da={da} Db={db}: {err}")
    log(f"kernel: intersect_count == plain version on {n_cases} cases, broadcast forms and storage offsets "
        f"included (max |diff| {max_err}); paths {sorted(paths)}")

    timings = []
    for da, db in SMOKE_SHAPES:
        b = max(256, (1 << 24) // (da * db))
        args = ic_inputs(b, da, db, gen, device)
        row = {"B": b, "Da": da, "Db": db, "ordered": True, **ic_times(args, True, 20)}
        paths.add(row["plan"])
        timings.append(row)
        log("kernel timing: " + json.dumps(row))
    if paths != {"rows", "block"}:
        raise AssertionError(f"the intersect_count cases reached only the paths {sorted(paths)}")
    report["intersect_count_shapes"] = timings
    return max_err


def ic_times(args, ordered, reps, cold: bool = False) -> dict:
    """intersect_count on its operands as passed: the path ``ops.plan``
    names (it must be the ``.cu`` entry's), CUDA events over ``reps``
    wrapper calls (``ms``), the kernel's mean device time under
    ``torch.profiler`` (``kernel_ms``), the host's time a call, the plain
    version on the materialised operands, and the bound.

    ``cold``: ``ms`` and ``kernel_ms`` time each launch after a write of
    ``L2_FLUSH_BYTES`` has evicted the operands from L2, as the bound
    assumes; the back-to-back times, operands in L2, are kept as
    ``l2_warm_ms`` and ``l2_warm_kernel_ms``."""
    import torch
    from repro_torch.kernels.intersect_count import ops as ic_ops

    b, da = args[0].shape
    db = args[2].shape[1]
    path = ic_ops.plan(b, da, db)
    if ic_ops.kernel_plan(b, da, db) != path:
        raise AssertionError(f"ops.plan and the .cu entry choose different paths at ({b}, {da}, {db})")
    run = lambda: ic_ops.intersect_count(*args, ordered=ordered)
    kernel_ms, seen = kernel_device_ms(run, reps, match="intersect_count")
    times = {"ms": cuda_ms(run, reps), "kernel_ms": kernel_ms}
    if cold:
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=args[0].device)
        evict = flush.zero_
        kernel_ms, seen = kernel_device_ms(run, reps, match="intersect_count", before=evict)
        times = {"ms": cuda_ms(run, reps, before=evict), "kernel_ms": kernel_ms, "l2_flushed": True,
                 "l2_warm_ms": times["ms"], "l2_warm_kernel_ms": times["kernel_ms"]}
        del flush
    bound, by = ic_bound_ms(args)
    return {"plan": path, **times, "kernel_launches_profiled": seen, "host_us": host_us(run, reps),
            "plain_ms": cuda_ms(lambda: ic_plain_rows(args, ordered, max_cube=1 << 30), 3),
            "bound_ms": bound, "bound_by": by}


def host_us(fn, reps: int) -> float:
    """The host's time a call of ``fn`` (no wait for the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def hu_hold(a, b, replay, exact, bound, what: str) -> float:
    """Hold two launches of a hist_update entry to each other and to the
    plain fixed-point replay bit for bit, and to the float64 plain version
    within the stated error bound; returns the largest |difference| from
    the float64 sums."""
    import torch

    if not torch.equal(a, b):
        raise AssertionError(f"hist_update gave other bits on a second launch at {what}")
    if not torch.equal(a, replay):
        bad = int((a != replay).sum())
        raise AssertionError(f"hist_update differs from its fixed-point replay at {what} in {bad} entries")
    diff = (a.double() - exact).abs()
    over = diff > bound
    if bool(over.any()):
        raise AssertionError(f"hist_update outside its error bound at {what}: "
                             f"{int(over.sum())} entries, max |diff| {float(diff.max()):.3g}")
    return float(diff.max()) if diff.numel() else 0.0


def hu_check(keys, gh, s: int) -> float:
    """The keys entry, held as ``hu_hold`` says."""
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.hist_update.ref import fixed_point_ref, hist_update_ref

    n = keys.shape[0]
    return hu_hold(hu_ops.hist_update(keys, gh, s), hu_ops.hist_update(keys, gh, s),
                   fixed_point_ref(keys, gh, s, n), hist_update_ref(keys, gh.double(), s),
                   hu_ops.error_bound(keys, gh, s), f"N={n} S={s}")


def hu_rows_check(xb, node, gh, n_nodes: int, n_bins: int) -> float:
    """The rows entry, held as ``hu_hold`` says; the replay sums the keys
    and repeated gh that the plain version builds, at the scale of the N
    rows."""
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.hist_update.ref import fixed_point_ref, hist_update_rows_ref, row_keys

    n, f = xb.shape
    s = n_nodes * f * n_bins
    replay = fixed_point_ref(row_keys(xb, node, n_bins), gh[:, None, :].expand(n, f, 2).reshape(-1, 2), s, n)
    return hu_hold(hu_ops.hist_update_rows(xb, node, gh, n_nodes, n_bins),
                   hu_ops.hist_update_rows(xb, node, gh, n_nodes, n_bins),
                   replay.reshape(n_nodes, f, n_bins, 2),
                   hist_update_rows_ref(xb, node, gh.double(), n_nodes, n_bins),
                   hu_ops.error_bound_rows(xb, node, gh, n_nodes, n_bins), f"rows N={n} F={f} S={s}")


def hu_times(keys, gh, s: int, reps: int) -> dict:
    """Kernel, plain version (float32) and library call (one index_add_,
    into a spare row for the keys it must drop) on the same inputs."""
    import torch
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.hist_update.ref import hist_update_ref

    n = keys.shape[0]
    safe = torch.where((keys >= 0) & (keys < s), keys, s)
    lib_out = torch.zeros((s + 1, 2), dtype=torch.float32, device=keys.device)
    bound, by = hu_bound_ms(n, s)
    return {
        "ms": cuda_ms(lambda: hu_ops.hist_update(keys, gh, s), reps),
        "plain_ms": cuda_ms(lambda: hist_update_ref(keys, gh, s), reps),
        "library_ms": cuda_ms(lambda: lib_out.index_add_(0, safe, gh), reps),
        "bound_ms": bound,
        "bound_by": by,
    }


def hu_rows_times(xb, node, gh, n_nodes: int, n_bins: int, reps: int) -> dict:
    """The rows entry, its plain version (key build, repeat and segment
    sum in float32) and the library call: one index_add_ of the repeated
    gh on prebuilt keys (the key build and the repeat not counted)."""
    import torch
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.hist_update.ref import hist_update_rows_ref, row_keys

    n, f = xb.shape
    s = n_nodes * f * n_bins
    keys = row_keys(xb, node, n_bins)
    safe = torch.where((keys >= 0) & (keys < s), keys, s)
    gh_rep = gh[:, None, :].expand(n, f, 2).reshape(-1, 2)
    lib_out = torch.zeros((s + 1, 2), dtype=torch.float32, device=xb.device)
    bound, by = hu_rows_bound_ms(n, f, s)
    return {
        "ms": cuda_ms(lambda: hu_ops.hist_update_rows(xb, node, gh, n_nodes, n_bins), reps),
        "plain_ms": cuda_ms(lambda: hist_update_rows_ref(xb, node, gh, n_nodes, n_bins), reps),
        "library_ms": cuda_ms(lambda: lib_out.index_add_(0, safe, gh_rep), reps),
        "bound_ms": bound,
        "bound_by": by,
    }


def hu_keys_cases(gen, device):
    """(name, N, S, keys) of phase 2's keys-entry cases: keys in [-2, S+2)
    as tests/test_kernels.py draws them, each cluster size, the fit's
    level shapes, and hot keys."""
    import torch

    def ri(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=device, dtype=torch.int32)

    for n, s in HU_SHAPES + HU_CLUSTER_SHAPES + tuple((1 << 22, s) for s in HU_LEVEL_S):
        yield "uniform", n, s, ri(-2, s + 2, n)
    s = HU_LEVEL_S[-1]
    yield "one key", 1 << 20, s, torch.full((1 << 20,), 4321, dtype=torch.int32, device=device)
    hot = ri(0, s // 100, 1 << 22)  # 90 % of rows on 1 % of the keys
    yield "hot 90/1", 1 << 22, s, torch.where(torch.rand(1 << 22, generator=gen, device=device) < 0.9,
                                              hot, ri(0, s, 1 << 22))


def hu_rows_cases(gen, device):
    """(name, xb, node, n_nodes, n_bins) of phase 2's rows-entry cases:
    uniform bins and nodes at each shape of HU_ROWS_SHAPES, then hot keys
    at level 5: every row on node 0 and bin 0, and bins drawn from a
    skewed law (90 % bin 0) as the mined counts are."""
    import torch

    for n, f, b, n_nodes in HU_ROWS_SHAPES:
        xb = torch.randint(0, b, (n, f), generator=gen, device=device, dtype=torch.int32).to(torch.uint8)
        node = torch.randint(0, n_nodes, (n,), generator=gen, device=device, dtype=torch.int32)
        yield "uniform", xb, node, n_nodes, b
    n, f, b, n_nodes = 1 << 19, 12, 256, 32
    yield ("one key", torch.zeros((n, f), dtype=torch.uint8, device=device),
           torch.zeros(n, dtype=torch.int32, device=device), n_nodes, b)
    xb = torch.randint(0, b, (n, f), generator=gen, device=device, dtype=torch.int32).to(torch.uint8)
    xb = torch.where(torch.rand((n, f), generator=gen, device=device) < 0.9, 0, xb).to(torch.uint8)
    yield "hot 90 % bin 0", xb, torch.randint(0, n_nodes, (n,), generator=gen, device=device,
                                              dtype=torch.int32), n_nodes, b


def phase_hist_update(device, report) -> float:
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    max_err = 0.0
    rows = []
    for name, n, s, keys in hu_keys_cases(gen, device):
        gh = torch.randn((n, 2), generator=gen, device=device)
        err = hu_check(keys, gh, s)
        max_err = max(max_err, err)
        row = {"entry": "keys", "case": name, "N": n, "S": s, "max_abs_err": err, **hu_times(keys, gh, s, 10)}
        rows.append(row)
        log("kernel timing: hist_update " + json.dumps(row))
    for name, xb, node, n_nodes, b in hu_rows_cases(gen, device):
        n, f = xb.shape
        gh = torch.randn((n, 2), generator=gen, device=device)
        err = hu_rows_check(xb, node, gh, n_nodes, b)
        max_err = max(max_err, err)
        row = {"entry": "rows", "case": name, "N": n, "F": f, "B": b, "n_nodes": n_nodes, "S": n_nodes * f * b,
               "max_abs_err": err, **hu_rows_times(xb, node, gh, n_nodes, b, 10)}
        rows.append(row)
        log("kernel timing: hist_update_rows " + json.dumps(row))
    report["hist_update_shapes"] = rows
    log(f"kernel: hist_update (keys and rows entries) bit-identical to its fixed-point replay and across "
        f"launches, and within its error bound of the float64 plain version, on {len(rows)} cases "
        f"(max |diff| {max_err:.3g})")
    return max_err


def phase_window_degree(device, report):
    import torch
    from repro_torch.kernels.window_degree import ops as wd_ops
    from repro_torch.kernels.window_degree.ref import window_degree_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(2)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    rows = []
    for b, d in WD_SHAPES:
        pad = torch.rand((b, d), generator=gen, device=device) < 0.25
        t = torch.where(pad, wd_ops.PAD_T, ri(0, 128, (b, d)))
        lo = ri(0, 64, (b,))
        hi = lo + ri(0, 64, (b,))
        if not torch.equal(wd_ops.window_degree(t, lo, hi), window_degree_ref(t, lo, hi)):
            raise AssertionError(f"window_degree differs from its plain version at B={b} D={d}")
        bound, by = wd_bound_ms(b, d)
        run = lambda: wd_ops.window_degree(t, lo, hi)
        kernel_ms, seen = kernel_device_ms(run, 20, match="window_degree")
        row = {"B": b, "D": d, "max_abs_err": 0,
               "ms": cuda_ms(run, 20), "kernel_ms": kernel_ms, "kernel_launches_profiled": seen,
               "plain_ms": cuda_ms(lambda: window_degree_ref(t, lo, hi), 20),
               "library_ms": None, "bound_ms": bound, "bound_by": by}
        rows.append(row)
        log("kernel timing: window_degree " + json.dumps(row))
    report["window_degree_shapes"] = rows
    log(f"kernel: window_degree == plain version on {len(WD_SHAPES)} shapes")
    return rows[-1]


def ws_csr(seed: int, lens, n_ids: int, t_max: int, device):
    """CSR rows of the given lengths, each sorted by (id, t), and the
    time-sorted copy: (ids, t, t_sorted, indptr) as int32 tensors."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ids, ts, tsorted = [], [], []
    for n in lens:
        i = rng.integers(0, n_ids, n)
        t = rng.integers(0, t_max, n)
        o = np.lexsort((t, i))
        ids.append(i[o])
        ts.append(t[o])
        tsorted.append(np.sort(t))
    cat = lambda xs: torch.from_numpy(np.concatenate(xs).astype(np.int32)).to(device)  # noqa: E731
    return cat(ids), cat(ts), cat(tsorted), cat([[0], np.cumsum(lens)])


def ws_operands(form: str, seed: int, n_nodes: int, n_ids: int, t_max: int, device, b: int = WS_B):
    """(node, x, after, until) in one of the mining compiler's forms:
    lifted and broadcast views of ranks 1-4, Python ints, inverted windows
    (the ordered intersects' clamps), -1 ids, int32 wrap, operands one word
    into their storage."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)  # noqa: E731
    nodes = lambda shape: ri(-1, n_nodes, shape)  # noqa: E731
    ids = lambda shape: ri(-1, n_ids + 1, shape)  # noqa: E731
    times = lambda shape: ri(-2, t_max + 2, shape)  # noqa: E731
    w, d = 3, 4
    if form == "rank1":
        return nodes((b,)), ids((b,)), times((b,)), times((b,))
    if form == "lifted":
        return nodes((b, 1, 1)).expand(b, w, 1), ids((b, w, d)), 3, times((b, w, 1))
    if form == "mid_lift":
        return nodes((b, w, 1)), ids((b, 1, d)), times((b, w, 1)), times((b, 1, d))
    if form == "rank4":
        return nodes((b, 1, 1, 1)), ids((b, w, 2, d)), times((b, w, 1, 1)), t_max // 2
    if form == "ints":
        return nodes((b, w)), ids((b, w)), -(1 << 30), 1 << 30
    if form == "inverted":
        a = times((b, w))
        return nodes((b, 1)), ids((b, w)), a, a - ri(1, 10, (b, w))
    if form == "wrap":
        return nodes((b,)), ids((b,)), 2**31 - 1, 2**31 - 1
    if form == "neg_wrap":
        return nodes((b,)), ids((b,)), -(2**31), times((b,))
    if form == "offset":
        return offset_view(nodes((b, 1))), ids((b, 2 * w))[:, ::2], times((b, 1)), offset_view(times((b, w)))
    # one node for a whole innermost axis of 40-700 queries, or a Python
    # int: shared rows that every query of the axis searches
    if form == "row":
        r = b // 16
        return nodes((r, 1)), ids((r, 96)), times((r, 1)), times((r, 96))
    if form == "row_wide":
        r = b // 64
        return nodes((r, 1, 1)), ids((r, w, 700)), 3, times((r, w, 1))
    if form == "int_node":
        return 1, ids((b, 40)), times((b, 1)), times((b, 40))
    raise AssertionError(form)


def ws_args(entry: str, flats, ops_, n_iters: int) -> tuple:
    """An entry's positional arguments, as the compiler passes them."""
    ids, t, tsorted, indptr = flats
    node, x, after, until = ops_
    if entry.startswith("count_window"):
        return tsorted, indptr, node, after, until, n_iters
    return ids, t, indptr, node, x, after, until, n_iters


def ws_plain(entry: str, args):
    """window_search's plain version (the eager searches of core.ops) on
    the same operands, on the card."""
    from repro_torch.kernels.window_search import ref as ws_ref

    return getattr(ws_ref, entry + "_ref")(*args)


def ws_hold(entry: str, args, what: str) -> int:
    """The kernel's outputs against the plain version's, bit for bit, one
    launch, under set_sync_debug_mode("error"); returns the max |diff| (0)."""
    import torch
    from repro_torch.kernels.window_search import ops as ws_ops

    want = ws_plain(entry, args)
    before = ws_ops.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = getattr(ws_ops, entry)(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if ws_ops.launches != before + 1:
        raise AssertionError(f"window_search {entry} ({what}) made {ws_ops.launches - before} launches, not 1")
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != torch.int32:
            raise AssertionError(f"window_search {entry} ({what}): {tuple(a.shape)} {a.dtype}, not {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    if err:
        raise AssertionError(f"window_search {entry} ({what}) differs from its plain version by {err}")
    return err


def ws_halvings(flat, lo, hi, q, n_iters: int, seen):
    """The plain lower bound, counting the halvings that do work (the
    kernel stops a search where lo == hi) and marking in ``seen`` the
    32-byte sectors of ``flat`` that they gather: (ranks, halvings)."""
    import torch

    shape = torch.broadcast_shapes(lo.shape, hi.shape, q.shape)
    lo, hi, q = lo.expand(shape), hi.expand(shape), q.expand(shape)
    cap = flat.shape[0] - 1
    steps = torch.zeros((), dtype=torch.int64, device=flat.device)
    for _ in range(n_iters):
        act = lo < hi
        steps += act.sum()
        mid = (lo + hi) >> 1
        at = mid.clamp(0, cap)
        seen[at[act].long() >> 3] = True
        less = flat[at] < q
        lo, hi = torch.where(act & less, mid + 1, lo), torch.where(act & ~less, mid, hi)
    return lo, steps


def ws_sectors(flat):
    """A mask of ``flat``'s 32-byte sectors, none touched yet."""
    import torch

    return torch.zeros((flat.shape[0] + 7) // 8, dtype=torch.bool, device=flat.device)


def ws_steps(entry: str, args):
    """The halvings this call's data needs, over its four (two) searches,
    and the bytes of the rows they read: for each of ``indptr`` and the
    searched arrays, its distinct 32-byte sectors that the call touches,
    at most the array's own bytes."""
    import torch

    two = entry.startswith("count_id")
    ids, t, indptr, node, x, after, until, n = args if two else (None, *args[:3], None, *args[3:])
    i32 = lambda v: v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=torch.int32, device=t.device)  # noqa: E731
    last = indptr.shape[0] - 1
    safe = i32(node).long().clamp_min(0)
    rows = ws_sectors(indptr)
    rows[safe.clamp_max(last).reshape(-1) >> 3] = True
    rows[(safe + 1).clamp_max(last).reshape(-1) >> 3] = True
    lo, hi = indptr[safe.clamp_max(last)], indptr[(safe + 1).clamp_max(last)]
    total, touched = 0, [(indptr, rows)]
    if two:
        x, seen = i32(x), ws_sectors(ids)
        (lo, s1), (hi, s2) = ws_halvings(ids, lo, hi, x, n, seen), ws_halvings(ids, lo, hi, x + 1, n, seen)
        total += int(s1) + int(s2)
        touched.append((ids, seen))
    seen = ws_sectors(t)
    total += int(ws_halvings(t, lo, hi, i32(after) + 1, n, seen)[1]) + int(ws_halvings(t, lo, hi, i32(until) + 1, n, seen)[1])
    touched.append((t, seen))
    return total, sum(min(32 * int(m.sum()), 4 * a.numel()) for a, m in touched)


def ws_bound_ms(entry: str, args, outs, steps: int, row_bytes: int):
    """window_search's bound: each operand tensor's own elements read once
    (a broadcast view at its distinct elements, an int not at all), the
    outputs written once, the distinct sectors of the rows that the
    searches touch (``ws_steps``) read once, and one operation a halving."""
    import torch

    two = entry.startswith("count_id")
    operands = args[3:7] if two else args[2:5]
    nbytes = sum(4 * math.prod(n for n, st in zip(v.shape, v.stride()) if st)
                 for v in operands if isinstance(v, torch.Tensor))
    nbytes += sum(4 * o.numel() for o in outs) + row_bytes
    return bound_ms(nbytes, steps)


def ws_form(entry: str, args) -> dict:
    """The shape and operand forms of a window_search launch."""
    import torch

    two = entry.startswith("count_id")
    names = ("node", "x", "after", "until") if two else ("node", "after", "until")
    operands = args[3:7] if two else args[2:5]
    shape = torch.broadcast_shapes(*(tuple(v.shape) if isinstance(v, torch.Tensor) else () for v in operands))
    form = lambda v: "int" if not isinstance(v, torch.Tensor) else {  # noqa: E731
        "shape": list(v.shape), "stride": list(v.stride())}
    return {"entry": entry, "shape": list(shape), "n_iters": args[-1], **{k: form(v) for k, v in zip(names, operands)}}


def ws_times(entry: str, args, reps: int, cold: bool = False) -> dict:
    """window_search on its operands as passed: CUDA events over ``reps``
    calls (``ms``), the kernel's device time under ``torch.profiler``
    (``kernel_ms``), the host's time a call, the plain version, the
    halvings this data needs and the bound.  ``cold`` as in ``ic_times``."""
    import torch
    from repro_torch.kernels.window_search import ops as ws_ops

    run = lambda: getattr(ws_ops, entry)(*args)  # noqa: E731
    kernel_ms, seen = kernel_device_ms(run, reps, match="window_search")
    times = {"ms": cuda_ms(run, reps), "kernel_ms": kernel_ms}
    if cold:
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=args[0].device)
        evict = flush.zero_
        kernel_ms, seen = kernel_device_ms(run, reps, match="window_search", before=evict)
        times = {"ms": cuda_ms(run, reps, before=evict), "kernel_ms": kernel_ms, "l2_flushed": True,
                 "l2_warm_ms": times["ms"], "l2_warm_kernel_ms": times["kernel_ms"]}
        del flush
    out = run()
    outs = out if isinstance(out, tuple) else (out,)
    steps, row_bytes = ws_steps(entry, args)
    bound, by = ws_bound_ms(entry, args, outs, steps, row_bytes)
    return {**times, "kernel_launches_profiled": seen, "host_us": host_us(run, reps),
            "plain_ms": cuda_ms(lambda: ws_plain(entry, args), 3), "halvings": steps, "row_bytes": row_bytes,
            "elements": outs[0].numel(), "bound_ms": bound, "bound_by": by}


def phase_window_search(device, report):
    """window_search bit for bit against its plain version: every entry in
    each of the compiler's operand forms (``WS_FORMS``) at halvings that
    cover every row and at fewer, and at a hub row of HI-Small's largest
    degree (``WS_HUB``) at 19 and 8 halvings; timed at the hub case."""
    import numpy as np

    err, n_cases = 0, 0
    for fi, form in enumerate(WS_FORMS):
        lens = np.random.default_rng(fi).integers(0, 41, 64)
        flats = ws_csr(fi, lens, 6, 64, device)
        ops_ = ws_operands(form, fi, 64, 6, 64, device)
        for entry in WS_ENTRIES:
            for n_iters in (6, 2):
                err = max(err, ws_hold(entry, ws_args(entry, flats, ops_, n_iters), f"{form}, {n_iters} halvings"))
                n_cases += 1
    flats = ws_csr(5, np.array([WS_HUB, 5, 0, 17, 1 << 12, 3]), 4000, 1 << 20, device)
    node, x, after, until = ws_operands("rank1", 9, 6, 4000, 1 << 20, device, b=1 << 16)
    node = node.reshape(-1, 1).clone()
    node[: node.shape[0] // 2] = 0  # half the queries on the hub
    x = x.reshape(-1, 1).expand(-1, 8).contiguous()
    after = after.reshape(-1, 1)
    until = after + until.reshape(-1, 1).abs()
    rows = []
    for entry in WS_ENTRIES:
        for n_iters in (19, 8):
            args = ws_args(entry, flats, (node, x, after, until), n_iters)
            err = max(err, ws_hold(entry, args, f"hub row of {WS_HUB}, {n_iters} halvings"))
            n_cases += 1
        row = {"entry": entry, "B": int(node.shape[0]), "W": 8, "hub": WS_HUB, "n_iters": 19,
               "max_abs_err": 0, **ws_times(entry, ws_args(entry, flats, (node, x, after, until), 19), 20)}
        rows.append(row)
        log("kernel timing: window_search at a hub row " + json.dumps(row))
    report["window_search_shapes"] = rows
    # the intersect_step entry: every form in both strategies, then the
    # hub row swept at D = 1,024 (19 and 8 halvings), timed there
    steps = []
    for fi, form in enumerate(WS_STEP_FORMS):
        for strategy in ("bs1", "bs2"):
            args, kw = ws_step_case(form, strategy, 20 + fi, device)
            err = max(err, ws_step_hold(args, kw, f"{form}, {strategy}")[0])
            n_cases += 1
    for strategy in ("bs1", "bs2"):
        args, kw = ws_step_hub_case(strategy, device)
        e, plain_ms = ws_step_hold(args, kw, f"{strategy} at a hub row of {WS_HUB}")
        err, n_cases = max(err, e), n_cases + 1
        row = {"entry": "intersect_step", "hub": WS_HUB, "max_abs_err": e, "shape": ws_step_form(args, kw),
               **ws_step_times(args, kw, 5, plain_ms)}
        steps.append(row)
        log("kernel timing: window_search intersect_step at a hub row " + json.dumps(row))
    report["window_search_step_shapes"] = steps
    log(f"kernel: window_search == plain version in {n_cases} cases")
    return err, rows


def ws_step_case(form: str, strategy: str, seed: int, device, b: int = WS_B):
    """window_search's intersect_step in one of the compiled plans' forms:
    ``(args, kw)`` for ``intersect_step(*args, **kw)``.  Two CSRs of rows of
    0-40 entries over 64 nodes and 6 ids; lead shape (b, 3) (or (b, 3, 2)
    for ``rank3``), the frontier full, the fixed node (b, 1), windows (b, 1)
    and (b, 3) views or ints, -1 nodes among them; d * n_sweep from 4 to 320
    (each thread-group size of the kernel), ordered and not, 0-3 skip
    nodes, partial ranks (``partial``: 2 halvings), int32 wrap (``wrap``:
    edge times and bounds at INT32_MIN / INT32_MAX), operands one word into
    their storage (``offset``)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lens = lambda: rng.integers(0, 41, 64)  # noqa: E731
    csrs = []
    for k in range(2):
        ids, t, _, indptr = ws_csr(seed * 2 + k, lens(), 6, 64, device)
        if form == "wrap":  # times at both ends of int32, rows still sorted by (id, t)
            t = torch.where(t < 6, torch.full_like(t, -(2**31)), torch.where(t > 58, torch.full_like(t, 2**31 - 1), t))
        csrs.append((indptr, ids, t))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)  # noqa: E731
    w = 3
    lead = (b, w, 2) if form == "rank3" else (b, w)
    one = (b,) + (1,) * (len(lead) - 1)
    mid = (b, w) + (1,) * (len(lead) - 2)
    frontier, fixed = ri(-1, 64, lead), ri(-1, 64, one)
    st = ri(-2, 30, one)
    win1, win2 = (st, st + 34), (ri(-2, 66, mid), st + 40)
    ordered, n_skip, d, n_sweep, n_iters = True, 1, 8, 2, 6
    if form == "plain":
        ordered, n_skip, d, n_sweep = False, 0, 4, 1
    elif form == "skip3":
        n_skip, d, n_sweep = 3, 16, 4
    elif form == "sweep8":
        n_skip, d, n_sweep = 2, 12, 8
    elif form == "wide":
        ordered, n_skip, d, n_sweep = False, 2, 40, 8
    elif form == "partial":
        n_skip, n_iters = 2, 2
    elif form == "wrap":  # an entry at INT32_MAX clips bs1's window to after + 1 = INT32_MIN
        win1, win2 = (-(2**31), 2**31 - 1), (ri(-2, 66, mid), 2**31 - 2)
        n_skip = 2
    elif form == "ints":
        ordered, win1, win2 = False, (-(2**31), 2**31 - 2), (10, 50)
    elif form == "offset":
        frontier, win2 = offset_view(frontier), (offset_view(win2[0]), win2[1])
    skip = tuple(ri(-1, 64, one if i % 2 == 0 else lead) for i in range(n_skip))
    args = (strategy, csrs[0], csrs[1], frontier, fixed, win1, win2, skip)
    return args, {"ordered": ordered, "d": d, "n_sweep": n_sweep, "n_iters": n_iters}


def ws_step_hub_case(strategy: str, device, b: int = WS_STEP_HUB_B, n_iters: int = 19):
    """intersect_step at a hub row of WS_HUB entries, as the mining path's
    swept hub buckets run it: lead (b, 1), D = 1,024 in 512 sweep steps
    (the hub's 333 blocks of 1,024 rounded up to a power of two), half the
    lead elements on the hub, times over 2^20 and windows of up to 2^18.
    bs1 expands the hub (a frontier row) and searches short rows; bs2
    expands it (the fixed row) and searches short rows of the frontier."""
    import numpy as np
    import torch

    lens = np.array([WS_HUB, 5, 0, 17, 1 << 12, 3])
    ids, t, _, indptr = ws_csr(5, lens, 4_000, 1 << 20, device)
    hub = (indptr, ids, t)
    g = torch.Generator(device=device)
    g.manual_seed(7)
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g, device=device, dtype=torch.int32)  # noqa: E731
    # the other side: 6 nodes of short rows over the same ids and times
    ids2, t2, _, indptr2 = ws_csr(6, np.array([3, 4_000, 0, 1_700, 90, 1]), 4_000, 1 << 20, device)
    short = (indptr2, ids2, t2)
    node = ri(-1, 6, (b, 1))
    node[: b // 2] = 0
    other = ri(-1, 6, (b, 1))
    st = ri(0, 1 << 20, (b, 1))
    win = (st, st + ri(-100, 1 << 18, (b, 1)))
    if strategy == "bs1":  # the hub is the frontier's row, the fixed rows short
        args = (strategy, hub, short, node, other, win, (st - 10, st + (1 << 18)), (other,))
    else:  # the hub is the fixed row, the frontier's rows short
        args = (strategy, short, hub, other, node, (st - 10, st + (1 << 18)), win, (other,))
    return args, {"ordered": True, "d": 1024, "n_sweep": 512, "n_iters": n_iters}


def ws_step_hold(args, kw, what: str):
    """intersect_step against its plain version, bit for bit, one launch,
    under set_sync_debug_mode("error"); returns the max |diff| (0) and the
    plain version's time on the card for this call (ms, CUDA events: it is
    about a thousand launches a sweep step, so it runs once)."""
    import torch
    from repro_torch.kernels.window_search import ops as ws_ops
    from repro_torch.kernels.window_search import ref as ws_ref

    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev[0].record()
    want = ws_ref.intersect_step_ref(*args, **kw)
    ev[1].record()
    before, step_before = ws_ops.launches, ws_ops.step_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ws_ops.intersect_step(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if ws_ops.launches != before + 1 or ws_ops.step_launches != step_before + 1:
        raise AssertionError(f"window_search intersect_step ({what}) made {ws_ops.step_launches - step_before} "
                             f"launches, not 1")
    if got.shape != want.shape or got.dtype != torch.int32:
        raise AssertionError(f"window_search intersect_step ({what}): {tuple(got.shape)} {got.dtype}, "
                             f"not {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"window_search intersect_step ({what}) differs from its plain version by {err}")
    return err, ev[0].elapsed_time(ev[1])


def ws_step_steps(args, kw):
    """The work of one intersect_step call on this data: (operations: the
    expanded entries inside their rows, one window test each, and the
    halvings; the bytes of the distinct 32-byte sectors it must read of
    the expanded rows' times and ids, both CSRs' indptr and the searched
    rows, each at most its array's own bytes).  An expanded entry's time
    is read wherever the sweep reaches inside its row, its id only where
    that time lies inside the x window (the result needs no other id);
    each kept entry's four searches are the plain loop's, their sectors
    marked by ``ws_halvings``."""
    import torch
    from repro_torch.core import ops as core_ops
    from repro_torch.kernels.window_search.ref import _along

    strategy, csr_a, csr_b, frontier, fixed, w1, w2, skip = args
    bs1 = strategy == "bs1"
    (ix, idx_, tx), (is_, ids_s, ts) = (csr_a, csr_b) if bs1 else (csr_b, csr_a)
    node_x, node_s = (frontier, fixed) if bs1 else (fixed, frontier)
    (lo_x, hi_x), (lo_s, hi_s) = (w1, w2) if bs1 else (w2, w1)
    d, n_sweep, n = kw["d"], kw["n_sweep"], kw["n_iters"]
    dev = ix.device
    i32 = lambda v: v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    shape = torch.broadcast_shapes(*(tuple(v.shape) for v in (frontier, fixed, *w1, *w2, *skip)
                                     if isinstance(v, torch.Tensor)))
    nx, ns = i32(node_x).expand(shape), i32(node_s).expand(shape)
    # the expanded rows: [start + offset, min(end, start + offset + width)) of every valid lead element
    sx, ex = ix[nx.long().clamp_min(0)], ix[nx.long().clamp_min(0) + 1]
    first = sx.long() + kw.get("offset", 0)
    last = torch.minimum(ex.long(), first + d * n_sweep)
    live = (nx >= 0) & (ns >= 0) & (last > first)
    diff = torch.zeros((idx_.shape[0] + 7) // 8 + 1, dtype=torch.int64, device=dev)
    diff.index_add_(0, (first[live] >> 3), torch.ones_like(first[live]))
    diff.index_add_(0, ((last[live] - 1) >> 3) + 1, -torch.ones_like(first[live]))
    row_t = diff.cumsum(0)[:-1] > 0  # the sectors of the expanded rows' times
    total = int((last - first)[live].sum())  # the expansions inside rows
    ptr_x, ptr_s = ws_sectors(ix), ws_sectors(is_)
    for ptr, nd in ((ptr_x, nx), (ptr_s, ns)):
        safe = nd.long().clamp_min(0).reshape(-1)
        ptr[safe >> 3] = True
        ptr[(safe + 1) >> 3] = True
    seen_ids, seen_t, seen_xid = ws_sectors(ids_s), ws_sectors(ts), ws_sectors(idx_)
    start_s, end_s = is_[ns.long().clamp_min(0)], is_[ns.long().clamp_min(0) + 1]
    lo_s, hi_s = i32(lo_s).expand(shape), i32(hi_s).expand(shape)
    skips = [i32(r).expand(shape) for r in skip]
    # the sweep steps in chunks of about 2^24 expansions; each chunk's kept
    # entries compacted, then searched as the plain loop searches them
    per = max(1, (1 << 24) // max(1, nx.numel() * d))
    for i0 in range(0, n_sweep, per):
        steps = min(per, n_sweep - i0)
        offs = kw.get("offset", 0) + d * (i0 + torch.arange(steps, device=dev, dtype=torch.int32))
        m, at, x_id, x_t = core_ops.expand_pos(ix, (idx_, tx), nx[..., None], d,
                                               offset=offs.view(*([1] * nx.dim()), steps))
        m = m & (x_t > _along(_along(lo_x))) & (x_t <= _along(_along(hi_x))) & (ns >= 0)[..., None, None]
        seen_xid[at[m].long() >> 3] = True  # the ids read: entries whose time is in the x window
        m = m & (x_id >= 0)
        for r in skips:
            m = m & (x_id != r[..., None, None])
        lead = m.nonzero(as_tuple=True)[:-2]  # the kept entries' lead coordinates
        x_id, x_t = x_id[m], x_t[m]
        lo, hi = lo_s[lead], hi_s[lead]
        if kw["ordered"]:
            lo, hi = (torch.maximum(lo, x_t), hi) if bs1 else (lo, torch.minimum(hi, x_t - 1))
        a0, b0 = start_s[lead], end_s[lead]
        (lb, s1), (ub, s2) = ws_halvings(ids_s, a0, b0, x_id, n, seen_ids), ws_halvings(ids_s, a0, b0, x_id + 1, n,
                                                                                          seen_ids)
        total += int(s1) + int(s2)
        total += int(ws_halvings(ts, lb, ub, lo + 1, n, seen_t)[1]) + int(ws_halvings(ts, lb, ub, hi + 1, n, seen_t)[1])
    # an array that both sides read (one CSR as a and b) counts its sectors once
    touched = {}
    for a, m in ((ix, ptr_x), (is_, ptr_s), (tx, row_t), (idx_, seen_xid), (ids_s, seen_ids), (ts, seen_t)):
        key = (a.data_ptr(), a.numel())
        touched[key] = (a, touched[key][1] | m if key in touched else m)
    return total, sum(min(32 * int(m.sum()), 4 * a.numel()) for a, m in touched.values())


def ws_step_bound_ms(args, out, steps: int, row_bytes: int):
    """intersect_step's bound: each operand tensor's own elements read once
    (a broadcast view at its distinct elements), the output written once,
    the rows' sectors of ``ws_step_steps`` read once, one operation a
    halving."""
    import torch

    operands = (args[3], args[4], *args[5], *args[6], *args[7])
    nbytes = sum(4 * math.prod(n for n, st in zip(v.shape, v.stride()) if st)
                 for v in operands if isinstance(v, torch.Tensor))
    return bound_ms(nbytes + 4 * out.numel() + row_bytes, steps)


def ws_step_form(args, kw) -> dict:
    """The shape and operand forms of an intersect_step launch."""
    import torch

    form = lambda v: "int" if not isinstance(v, torch.Tensor) else {  # noqa: E731
        "shape": list(v.shape), "stride": list(v.stride())}
    strategy, csr_a, csr_b, frontier, fixed, w1, w2, skip = args
    shape = torch.broadcast_shapes(*(tuple(v.shape) for v in (frontier, fixed, *w1, *w2, *skip)
                                     if isinstance(v, torch.Tensor)))
    return {"strategy": strategy, "lead": list(shape), **{k: kw[k] for k in ("d", "n_sweep", "n_iters", "ordered")},
            "frontier": form(frontier), "fixed": form(fixed), "window1": [form(v) for v in w1],
            "window2": [form(v) for v in w2], "skip": [form(v) for v in skip],
            "rows": {"a": int(csr_a[1].shape[0]), "b": int(csr_b[1].shape[0])}}


def ws_step_times(args, kw, reps: int, plain_ms: float, cold: bool = False) -> dict:
    """intersect_step on its operands as passed, as ``ws_times`` times the
    search entry; ``plain_ms`` is the plain version's time on the same
    operands (``ws_step_hold``'s)."""
    import torch
    from repro_torch.kernels.window_search import ops as ws_ops

    run = lambda: ws_ops.intersect_step(*args, **kw)  # noqa: E731
    kernel_ms, seen = kernel_device_ms(run, reps, match="window_search_step")
    times = {"ms": cuda_ms(run, reps), "kernel_ms": kernel_ms}
    if cold:
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=args[1][0].device)
        evict = flush.zero_
        kernel_ms, seen = kernel_device_ms(run, reps, match="window_search_step", before=evict)
        times = {"ms": cuda_ms(run, reps, before=evict), "kernel_ms": kernel_ms, "l2_flushed": True,
                 "l2_warm_ms": times["ms"], "l2_warm_kernel_ms": times["kernel_ms"]}
        del flush
    out = run()
    steps, row_bytes = ws_step_steps(args, kw)
    bound, by = ws_step_bound_ms(args, out, steps, row_bytes)
    return {**times, "kernel_launches_profiled": seen, "host_us": host_us(run, reps),
            "plain_ms": plain_ms, "operations": steps,
            "row_bytes": row_bytes, "elements": out.numel() * kw["d"] * kw["n_sweep"], "bound_ms": bound,
            "bound_by": by}


def ws_library_ms(args, reps: int):
    """The library yardstick for ``count_window``: one ``torch.searchsorted``
    call for both window ends of every query over a prebuilt int64 key
    ``(row << 32) | (t ^ 0x80000000)`` of the time-sorted rows (the key
    built once, not timed)."""
    import torch

    t_sorted, indptr, node, after, until = args[:5]
    dev = t_sorted.device
    rows = torch.repeat_interleave(torch.arange(indptr.shape[0] - 1, device=dev, dtype=torch.int64),
                                   (indptr[1:] - indptr[:-1]).long())
    key = (rows << 32) | ((t_sorted.long() ^ 0x80000000) & 0xFFFFFFFF)
    shape = torch.broadcast_shapes(*(tuple(v.shape) for v in (node, after, until) if isinstance(v, torch.Tensor)))
    i32 = lambda v: (v if isinstance(v, torch.Tensor) else torch.tensor(v, device=dev, dtype=torch.int32)).expand(shape)  # noqa: E731
    row = i32(node).long().clamp_min(0) << 32
    q = torch.stack([row | (((i32(w) + 1).long() ^ 0x80000000) & 0xFFFFFFFF) for w in (after, until)])
    return cuda_ms(lambda: torch.searchsorted(key, q), reps)


def fa_plain(q, k, v, causal, window=None):
    """flash_attention's plain version on (B, T, H, hd) / (B, S, K, hd):
    the K/V heads repeated, then the explicit-op reference."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    b, t, h, hd = q.shape
    s = k.shape[1]
    flat = lambda x, n: x.repeat_interleave(h // x.shape[2], 2).transpose(1, 2).reshape(b * h, n, hd)
    out = flash_attention_ref(flat(q, t), flat(k, s), flat(v, s), causal=causal, window=window)
    return out.reshape(b, h, t, hd).transpose(1, 2)


def profiled_device_events(fn, tries: int = PROFILE_TRIES):
    """Run ``fn`` under ``torch.profiler`` and return the device kernels it
    recorded as (name, microseconds), with the run's wall in seconds.

    The profiler reads the card through CUPTI, which can record nothing
    (another client holds CUPTI, or its buffers are dropped): a run that
    records no device kernel is made again, up to ``tries`` times, and
    after that the list is empty and the caller reports "not measured".
    Whether the kernels ran is shown by the wrappers' launch counts, not
    by the profiler.  The events are read raw from the profiler's results
    (``kineto_results.events()``): building ``prof.events()``' event tree
    takes about 30 s of host time for 400,000 events (measured on the
    CPU), and a zamba2 prefill of 32,768 tokens launches 159,000 kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [(ev.name(), ev.duration_ns() / 1e3) for ev in prof.profiler.kineto_results.events()
                  if ev.device_type() == torch.autograd.DeviceType.CUDA]
        if events:
            return events, wall
        log(f"torch.profiler recorded no device kernel (attempt {attempt} of {tries})")
    return [], wall


def kernel_device_ms(fn, reps: int, match: str = "flash_fwd_kernel", before=None, per_call: int = 1):
    """Mean device time of the launches of kernels named ``match`` that
    ``fn`` makes (``per_call`` of them a call, summed into the call's
    time), under ``torch.profiler`` (the wrapper's host work left out), and
    how many of the ``reps`` calls the profiler recorded: the mean is over
    those it recorded.  (None, 0) when the
    profiler recorded no device kernel at all; a profile that recorded
    kernels but none named ``match`` fails.  ``before``, if given, runs
    ahead of each call (its kernels are not named ``match``)."""
    fn()

    def run():
        for _ in range(reps):
            if before is not None:
                before()
            fn()

    events, _ = profiled_device_events(run)
    if not events:
        log("kernel_ms not measured: the profiler recorded no device kernel")
        return None, 0
    us = [t for name, t in events if match in name]
    if not us:
        raise AssertionError(f"the profiler saw {len(events)} device kernels and none named {match!r}: "
                             f"{sorted({name for name, _ in events})[:8]}")
    return sum(us) / 1e3 / (len(us) / per_call), len(us) // per_call


def fa_row(q, k, v, causal, reps, window=None) -> dict:
    """flash_attention against its plain version (max |diff|, within the
    dtype's tolerance; in bfloat16 also each output row's max |diff|
    within that tolerance of the row's largest |value|, since late causal
    rows average thousands of values and are small), the path it took (``ops.plan``, which must equal
    the ``.cu`` entry's choice), and kernel / plain / library times with
    the bound: ``ms`` under CUDA events over wrapper calls, ``kernel_ms``
    the kernel's own mean device time under ``torch.profiler`` (over the
    ``kernel_launches_profiled`` of the ``reps`` launches it recorded).
    The library call is one ``F.scaled_dot_product_attention`` (under a
    window, with the window's boolean mask)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops

    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    path = fa_ops.plan(b, t, s, h, kvh, hd, q.dtype, causal)
    if fa_ops.kernel_plan(b, t, s, h, kvh, hd, q.dtype, causal) != path:
        raise AssertionError(f"ops.plan and the .cu entry choose different paths at {tuple(q.shape)}")
    got = fa_ops.flash_attention(q, k, v, causal=causal, block_k=s, window=window)
    ref = fa_plain(q, k, v, causal, window).float()
    diff = (got.float() - ref).abs().amax(-1)  # (B, T, H): per output row
    scale = ref.abs().amax(-1)
    err = float(diff.max())
    row_rel = float((diff / scale.clamp_min(torch.finfo(torch.float32).tiny)).max())
    ref_abs = {"ref_mean_abs": float(ref.abs().mean()), "ref_max_abs": float(scale.max()),
               "ref_row_max_abs_min": float(scale.min()), "max_row_rel_err": row_rel}
    del got, ref, diff, scale
    if not err <= FA_TOL[dtype] or (dtype == "bfloat16" and not row_rel <= FA_TOL[dtype]):
        raise AssertionError(f"flash_attention differs from its plain version at {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, causal={causal}, window={window}: {err} ({ref_abs})")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bound, by = fa_bound_ms(b, t, s, h, kvh, hd, causal, dtype, window)
    run = lambda: fa_ops.flash_attention(q, k, v, causal=causal, block_k=s, window=window)
    kernel_ms, seen = kernel_device_ms(run, reps)
    if window is None:
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=h != kvh)
    else:
        mask = window_mask(t, s, window, q.device)
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=h != kvh)
    return {"B": b, "T": t, "S": s, "H": h, "K": kvh, "hd": hd, "causal": causal, "window": window,
            "dtype": dtype, "plan": path, "max_abs_err": err, **ref_abs,
            "ms": cuda_ms(run, reps),
            "kernel_ms": kernel_ms, "kernel_launches_profiled": seen,
            "plain_ms": cuda_ms(lambda: fa_plain(q, k, v, causal, window), max(3, reps // 10)),
            "library_ms": cuda_ms(library, reps),
            "bound_ms": bound, "bound_by": by}


def window_regime(row) -> str:
    """Where a case's window lies against its T: below, at or above."""
    return "below T" if row["window"] < row["T"] else "at T" if row["window"] == row["T"] else "above T"


def window_mask(t: int, s: int, window: int, device):
    """The (T, S) boolean mask of the causal window: key j of row i iff
    j <= i and i - j < window."""
    import torch

    j, i = torch.arange(s, device=device)[None, :], torch.arange(t, device=device)[:, None]
    return (j <= i) & (i - j < window)


def phase_flash_attention(device, report):
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops

    cases = list(FA_CASES)
    for seed in range(8):  # tests/test_flash_attention.py::test_hypothesis_random
        rng = np.random.default_rng(seed)
        t, h, hd = int(rng.choice([64, 128, 192])), int(rng.choice([1, 2, 4])), int(rng.choice([16, 32, 64]))
        cases.insert(FA_TEST_CASES + seed, (1, t, t, h, h, hd, bool(rng.integers(0, 2)), "float32"))
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    rows = []
    for b, t, s, h, kvh, hd, causal, dtype in cases:
        dt = getattr(torch, dtype)
        q = torch.randn((b, t, h, hd), generator=gen, device=device).to(dt)
        k = torch.randn((b, s, kvh, hd), generator=gen, device=device).to(dt)
        v = torch.randn((b, s, kvh, hd), generator=gen, device=device).to(dt)
        row = fa_row(q, k, v, causal, 20)
        rows.append(row)
        log("kernel timing: flash_attention " + json.dumps(row))
    for b, t, s, h, kvh, hd, window, dtype in FA_WINDOW_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((b, t, h, hd), generator=gen, device=device).to(dt)
        k, v = (torch.randn((b, s, kvh, hd), generator=gen, device=device).to(dt) for _ in range(2))
        row = fa_row(q, k, v, True, 20, window=window)
        rows.append(row)
        log("kernel timing: flash_attention (window, hd 80) " + json.dumps(row))
        del q, k, v
    report["flash_attention_shapes"] = rows
    windowed = {(r["plan"], window_regime(r)) for r in rows if r["window"] is not None}
    wanted = {(p, w) for p in fa_ops.PATHS for w in ("below T", "at T", "above T")}
    if windowed != wanted:
        raise AssertionError(f"the windowed cases missed {sorted(wanted - windowed)}")
    if not {("wgmma", 80), ("simt", 80)} <= {(r["plan"], r["hd"]) for r in rows}:
        raise AssertionError("the hd-80 cases did not reach both the wgmma and the simt path")
    tiles = 0
    for t in FA_BWD_TILE_LENGTHS:
        for s in FA_BWD_TILE_LENGTHS:
            for window in FA_TILE_WINDOWS:
                if window is not None and t > s + window - 1:
                    continue
                if fa_ops.kernel_fwd_tiles(t, s, True, window) != fa_ops.fwd_tiles(t, s, True, window):
                    raise AssertionError(f"the .cu's wgmma forward tiles differ from ops.fwd_tiles at T {t}, "
                                         f"S {s}, window {window}")
                tiles += 1
    log(f"kernel: flash_attention's wgmma forward tiles equal ops.fwd_tiles at {tiles} (T, S, window)")
    reached = {r["plan"] for r in rows}
    if not {"short", "wgmma"} <= reached:
        raise AssertionError(f"the flash_attention cases reached only the paths {sorted(reached)}")
    worst = {d: max(r["max_abs_err"] for r in rows if r["dtype"] == d) for d in FA_TOL}
    log(f"kernel: flash_attention within {FA_TOL} of its plain version on {len(rows)} cases "
        f"(max |diff| {worst})")
    return worst


def fa_bwd_plain(q, k, v, o, do, lse, causal, window=None):
    """The backward's plain version in float32 on (B, T, H, hd) / (B, S, K,
    hd) operands: K/V heads repeated, dK and dV summed over each group
    before any rounding to the operands' type."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    flat = lambda x, n: x.float().repeat_interleave(h // x.shape[2], 2).transpose(1, 2).reshape(b * h, n, hd)
    dq, dk, dv = flash_attention_bwd_ref(flat(q, t), flat(k, s), flat(v, s), flat(o, t), flat(do, t),
                                         lse.reshape(b * h, t), causal=causal, window=window)
    fold = lambda x: x.reshape(b, kvh, g, s, hd).sum(2).transpose(1, 2)
    return dq.reshape(b, h, t, hd).transpose(1, 2), fold(dk), fold(dv)


def fa_bwd_row(q, k, v, do, causal, reps, o=None, lse=None, rtol32: float = 0.0, flush_l2: bool = False,
               window=None) -> dict:
    """The backward kernel (short or long path, ``ops.bwd_plan``'s, which
    must equal the ``.cu`` entry's; on the short path also the route and
    stage count of ``ops.short_bwd_route``, which must equal the ``.cu``'s,
    and the blocks it launches) against its plain version on the same
    inputs (the forward kernel's o and lse unless given): max |diff| over
    dQ, dK, dV, within FA_BWD_TOL (plus ``rtol32`` relative) in float32 and
    2e-2 relative and absolute in bf16 (on the long path also the max
    |diff| within 2e-2 of the outputs' largest |value|, ``max_rel_err``); two
    launches bit-identical; and
    kernel / plain / library times with the bound (``ms`` by CUDA events
    over wrapper calls, ``kernel_ms`` under ``torch.profiler``: the sum of
    the call's kernels, one on the short path, three on the long one).
    The library call is the backward of one
    ``F.scaled_dot_product_attention`` at the same shape
    (``torch.autograd.grad`` of its output at dO).  ``flush_l2`` also
    times each launch after a read of ``L2_FLUSH_BYTES`` has evicted the
    operands from L2 (``l2_flushed_ms`` by events, ``l2_flushed_kernel_ms``
    under the profiler), as the bytes bound assumes: a read, so that L2
    holds clean lines and the launch pays for no other buffer's
    write-back (as it would after a write such as ``ic_times``')."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops

    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    path = fa_ops.bwd_plan(b, t, s, h, kvh, hd, q.dtype, causal)
    if fa_ops.kernel_bwd_plan(b, t, s, h, kvh, hd, q.dtype, causal) != path:
        raise AssertionError(f"ops.bwd_plan and the .cu entry choose different backward paths at {tuple(q.shape)}")
    route, stages, grid = None, None, None
    if path == "short":
        route, stages = fa_ops.short_bwd_route(b, t, s, h, kvh, hd, q.dtype, causal)
        if fa_ops.kernel_short_bwd_route(b, t, s, h, kvh, hd, q.dtype, causal) != (route, stages):
            raise AssertionError(f"ops.short_bwd_route and the .cu choose different routes at {tuple(q.shape)}")
        grid = fa_ops.kernel_short_bwd_grid(b, t, s, h, kvh, hd, q.dtype)
    if o is None:
        o, lse = fa_ops.flash_attention(q, k, v, causal=causal, block_k=s, return_lse=True, window=window)
    run = lambda: fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    got, again = run(), run()
    want = fa_bwd_plain(q, k, v, o, do, lse, causal, window)
    err = max(float((x.float() - z).abs().max()) for x, z in zip(got, want))
    # the max |diff| over the largest |value| of dQ, dK and dV together: on
    # a training launch dO is the mean loss's gradient (about 1e-8), where
    # the absolute bound alone would pass anything; one common scale, since
    # an output can be zero in exact arithmetic (a single key: dS = 0) and
    # hold only rounding there
    scale = max(float(z.abs().max()) for z in want)
    rel = max(float((x.float() - z).abs().max()) for x, z in zip(got, want)) / max(scale, 1e-30)
    if dtype == "bfloat16" and path != "short" and not rel <= 2e-2:
        raise AssertionError(f"flash_attention_bwd differs from its plain version by {rel} of an output's scale "
                             f"at {tuple(q.shape)}, {tuple(k.shape)}, causal={causal}, window={window}")
    rtol, atol = (2e-2, 2e-2) if dtype == "bfloat16" else (rtol32, FA_BWD_TOL)
    for name, x, y, z in zip("qkv", got, again, want):
        if not torch.equal(x, y):
            raise AssertionError(f"two launches of flash_attention_bwd differ in d{name} at {tuple(q.shape)}")
        if not bool(((x.float() - z).abs() <= atol + rtol * z.abs()).all()):
            raise AssertionError(f"flash_attention_bwd differs from its plain version in d{name} at "
                                 f"{tuple(q.shape)}, {tuple(k.shape)}, causal={causal}, window={window}: {err}")
    del got, again, want
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    if window is None:
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=h != kvh)
    else:
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=window_mask(t, s, window, q.device),
                                                 enable_gqa=h != kvh)
    do_t = do.transpose(1, 2)
    bound, by = fa_bwd_bound_ms(b, t, s, h, kvh, hd, causal, dtype, window)
    kernel_ms, seen = kernel_device_ms(run, reps, match="flash_bwd_kernel", per_call=1 if path == "short" else 3)
    flushed = {}
    if flush_l2:
        flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=q.device)
        flushed = {"l2_flushed_ms": cuda_ms(run, reps, before=flush.max),
                   "l2_flushed_kernel_ms": kernel_device_ms(run, reps, match="flash_bwd_kernel", before=flush.max,
                                                            per_call=1 if path == "short" else 3)[0]}
        del flush
    return {"B": b, "T": t, "S": s, "H": h, "K": kvh, "hd": hd, "causal": causal, "window": window, "dtype": dtype,
            "bwd_plan": path, "route": route, "stages": stages, "grid": grid, **flushed,
            "chunk_heads": fa_ops.bwd_chunk_heads(b, t, s, h, kvh, hd, q.dtype), "max_abs_err": err,
            "max_rel_err": rel,
            "ms": cuda_ms(run, reps), "kernel_ms": kernel_ms, "kernel_launches_profiled": seen,
            "plain_ms": cuda_ms(lambda: fa_bwd_plain(q, k, v, o, do, lse, causal, window), max(3, reps // 10)),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), do_t, retain_graph=True),
                                  reps),
            "bound_ms": bound, "bound_by": by}


def ring_edge_batch(edge: str, grid: int, stages: int) -> int:
    """The batch of a FA_BWD_RING_EDGES case on a card whose persistent
    grid at the shape is ``grid`` blocks over a ring of ``stages``."""
    return {"below": grid // 2, "equal": grid, "turn_plus_one": grid * stages + 1,
            "ragged": 3 * grid + grid // 3 + 1}[edge]


def phase_flash_attention_bwd(device, report):
    """The backward kernels against their plain version: the short path at
    every case of FA_BWD_CASES and at FA_BWD_RING_EDGES' batches (both of
    its routes must be reached; every row logs its route, the ring's
    rows also with L2 flushed), the long backward at every case of
    FA_LONG_BWD_CASES (both of its routes must be reached), timed beside
    their bound and SDPA's backward.  Returns the worst float32 |diff| of
    each path."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    t_, s_, h_, kvh_, hd_, causal_, dtype_ = FA_BWD_RING_SHAPE
    dt_ = getattr(torch, dtype_)
    grid = fa_ops.kernel_short_bwd_grid(1 << 30, t_, s_, h_, kvh_, hd_, dt_)
    stages = fa_ops.short_bwd_route(1, t_, s_, h_, kvh_, hd_, dt_, causal_)[1]
    edges = tuple((ring_edge_batch(e, grid, stages), *FA_BWD_RING_SHAPE) for e in FA_BWD_RING_EDGES)
    log(f"kernel: the short backward's ring at {FA_BWD_RING_SHAPE}: a grid of {grid} blocks, {stages} stages; "
        f"edge batches {[c[0] for c in edges]}")
    rows = []
    for long, cases in ((False, FA_BWD_CASES + edges), (True, FA_LONG_BWD_CASES)):
        for b, t, s, h, kvh, hd, causal, dtype in cases:
            dt = getattr(torch, dtype)
            q, do = (torch.randn((b, t, h, hd), generator=gen, device=device).to(dt) for _ in range(2))
            k, v = (torch.randn((b, s, kvh, hd), generator=gen, device=device).to(dt) for _ in range(2))
            ring = not long and fa_ops.short_bwd_route(b, t, s, h, kvh, hd, dt, causal)[0] == "ring"
            row = fa_bwd_row(q, k, v, do, causal, 20, rtol32=FA_BWD_TOL if long else 0.0, flush_l2=ring)
            if (row["bwd_plan"] != "short") != long:
                raise AssertionError(f"the backward case {(b, t, s, h, kvh, hd)} took the {row['bwd_plan']!r} path")
            rows.append(row)
            log(f"kernel timing: flash_attention_bwd ({row['route'] or row['bwd_plan']}) " + json.dumps(row))
            del q, do, k, v
            torch.cuda.empty_cache()
    for b, t, s, h, kvh, hd, window, dtype in FA_WINDOW_BWD_CASES:
        dt = getattr(torch, dtype)
        q, do = (torch.randn((b, t, h, hd), generator=gen, device=device).to(dt) for _ in range(2))
        k, v = (torch.randn((b, s, kvh, hd), generator=gen, device=device).to(dt) for _ in range(2))
        long = fa_ops.bwd_plan(b, t, s, h, kvh, hd, dt, True) != "short"
        row = fa_bwd_row(q, k, v, do, True, 20, rtol32=FA_BWD_TOL if long else 0.0, window=window)
        rows.append(row)
        log(f"kernel timing: flash_attention_bwd ({row['route'] or row['bwd_plan']}, window, hd 80) "
            + json.dumps(row))
        del q, do, k, v
        torch.cuda.empty_cache()
    report["flash_attention_bwd_shapes"] = rows
    windowed = {(r["route"] or r["bwd_plan"], window_regime(r)) for r in rows if r["window"] is not None}
    wanted = {(p, w) for p in ("ring", "chunked", "simt", "wgmma") for w in ("below T", "at T", "above T")}
    if windowed != wanted:
        raise AssertionError(f"the windowed backward cases missed {sorted(wanted - windowed)}")
    reached = {r["bwd_plan"] for r in rows}
    if reached != set(fa_ops.BWD_PATHS):
        raise AssertionError(f"the backward cases reached only the paths {sorted(reached)}")
    routes = {r["route"] for r in rows if r["bwd_plan"] == "short"}
    if routes != set(fa_ops.SHORT_BWD_ROUTES):
        raise AssertionError(f"the short backward's cases reached only the routes {sorted(routes)}")
    tiles = 0
    for t in FA_BWD_TILE_LENGTHS:
        for s in FA_BWD_TILE_LENGTHS:
            for causal, window in [(False, None)] + [(True, w) for w in FA_TILE_WINDOWS]:
                if window is not None and t > s + window - 1:
                    continue
                if fa_ops.kernel_bwd_tiles(t, s, causal, window) != fa_ops.bwd_tiles(t, s, causal, window):
                    raise AssertionError(f"the .cu's wgmma tile loops differ from ops.bwd_tiles at T {t}, S {s}, "
                                         f"causal={causal}, window {window}")
                tiles += 1
    log(f"kernel: flash_attention_bwd's wgmma tile loops equal ops.bwd_tiles at {tiles} (T, S, mask, window)")
    worst = {p: max((r["max_abs_err"] for r in rows if r["dtype"] == "float32" and (r["bwd_plan"] == "short") == (p == "short")),
                    default=0.0) for p in ("short", "long")}
    log(f"kernel: flash_attention_bwd within {FA_BWD_TOL} (float32; the long path also {FA_BWD_TOL} relative) "
        f"of its plain version on {len(rows)} cases (max |diff| {worst})")
    return worst


def device_profile(fn, top: int = 12) -> dict:
    """``fn`` under ``torch.profiler``: its device kernel time against the
    profiled wall (one stream, so kernels do not overlap: the busy share),
    the ``flash_attention`` kernel's share and the top kernels by device
    time; ``{"profiled": False}`` when the profiler recorded no device
    kernel."""
    import collections

    events, wall_profiled = profiled_device_events(fn)
    if not events:
        return {"profiled": False}
    kern = collections.defaultdict(lambda: [0.0, 0])
    for name, us in events:
        kern[name][0] += us / 1e6  # us -> s
        kern[name][1] += 1
    busy = sum(v[0] for v in kern.values())
    # every path's kernel is named flash_fwd_kernel* (short, wgmma, or the CUDA-core one)
    flash = sum(v[0] for k, v in kern.items() if "flash_fwd_kernel" in k)
    # every backward kernel is named flash_bwd_kernel* (the short one; the long one's row-dot, dQ and dK/dV passes)
    bwd = {k[:100]: v[0] for k, v in kern.items() if "flash_bwd_kernel" in k}
    return {
        "profiled": True,
        "wall_profiled_s": wall_profiled,
        "device_kernel_s": busy,
        "device_busy_share": busy / wall_profiled if wall_profiled else None,
        "kernel_launches": sum(v[1] for v in kern.values()),
        "flash_attention_kernel_s": flash,
        "flash_attention_share_of_device": flash / busy if busy else None,
        "flash_attention_bwd_kernel_s": sum(bwd.values()),
        "flash_attention_bwd_kernels_s": bwd,
        "top_kernels": [{"name": k[:100], "s": v[0], "count": v[1]}
                        for k, v in sorted(kern.items(), key=lambda kv: -kv[1][0])[:top]],
    }


def profile_forward(ft, toks) -> dict:
    """FraudGT's forward over ``toks`` timed alone and then under
    ``torch.profiler`` (:func:`device_profile`; ``"profiled": false`` and
    only the plain wall when the profiler recorded no device kernel)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ft.logits(*toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = device_profile(lambda: ft.logits(*toks))
    if not prof["profiled"]:
        log("FraudGT forward profile not measured: the profiler recorded no device kernel")
    elif not prof["flash_attention_kernel_s"]:
        raise AssertionError("the profiled FraudGT forward shows no flash_fwd_kernel launch")
    return {"edges": int(len(toks[0])), "wall_s": wall, **prof}


def phase_fraudgt(ds, device, report, zero_launches, read_launches):
    """FraudGT inference over the test split on the card, its launch count
    and its cross-checks; returns the launch counts and the arguments of
    the path's first (largest) flash_attention launch."""
    import numpy as np
    import torch
    from repro_torch.data.loader import temporal_split
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.ml.fraudgt import FraudGT, FraudGTParams

    g = ds.graph
    _, test_ids = temporal_split(ds)
    n_test = len(test_ids)
    fgt_params = FraudGTParams()
    ft = FraudGT(fgt_params, seed=0, device=device)
    fa_fn = fa_ops.flash_attention
    fa_path = {}  # the first launch: 1,024 edges, the path's largest

    def capture_fa(q, k, v, **kw):
        fa_path.setdefault("args", (q, k, v, kw.get("causal", True)))
        return fa_fn(q, k, v, **kw)

    fa_ops.flash_attention = capture_fa
    zero_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        proba = ft.predict_proba(g, test_ids)
        total_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        fa_ops.flash_attention = fa_fn
    fgt_launches = read_launches()
    want_launches = fgt_params.n_layers * math.ceil(n_test / 1024)
    fgt = {"n_test": n_test, "tokenize_s": ft.seconds["tokenize"], "forward_s": ft.seconds["forward"],
           "total_s": total_s, "edges_per_s": n_test / total_s, "launches": fgt_launches,
           "expected_flash_launches": want_launches,
           "proba_mean": float(proba.mean()), "proba_min": float(proba.min()), "proba_max": float(proba.max())}
    log("FraudGT inference: " + json.dumps(fgt))
    if fgt_launches["flash_attention"] != want_launches:
        raise AssertionError(f"FraudGT launched flash_attention {fgt_launches['flash_attention']} times, "
                             f"not {want_launches}")
    if proba.shape != (n_test,) or not np.all(np.isfinite(proba)) or not np.all((proba >= 0) & (proba <= 1)):
        raise AssertionError(f"FraudGT probabilities of shape {proba.shape} are not finite values in [0, 1]")
    sub = test_ids[:FGT_CHECK_EDGES]
    toks = ft.tokenize(g, sub)
    on_cpu = FraudGT(fgt_params, seed=0, device="cpu")
    t0 = time.perf_counter()
    toks_cpu = on_cpu.tokenize(g, sub)
    cpu_tok_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(toks, toks_cpu)):
        raise AssertionError("the card run's tokens differ from a CPU tokenize")
    logit_k = ft.logits(*toks)
    logit_t = FraudGT(fgt_params, seed=0, device=device, attn_backend="torch").logits(*toks)
    t0 = time.perf_counter()
    logit_c = on_cpu.logits(*toks_cpu)
    cpu_fwd_s = time.perf_counter() - t0
    check = {"edges": int(len(sub)),
             "kernel_vs_torch_max_abs": float((logit_k - logit_t).abs().max()),
             "card_vs_cpu_max_abs": float((logit_k.cpu() - logit_c).abs().max()),
             "run_vs_rescore_max_abs": float(np.abs(proba[: len(sub)] - torch.sigmoid(logit_k).cpu().numpy()).max()),
             "logit_abs_max": float(logit_k.abs().max()), "tokens_equal": True,
             "cpu_tokenize_s": cpu_tok_s, "cpu_forward_s": cpu_fwd_s}
    fgt["cross_checks"] = check
    report["fraudgt"] = fgt
    log("FraudGT cross-checks: " + json.dumps(check))
    if not check["kernel_vs_torch_max_abs"] <= 1e-5:
        raise AssertionError(f'the "kernel" and "torch" attention backends disagree: {check}')
    if not check["card_vs_cpu_max_abs"] <= 1e-4:
        raise AssertionError(f"the card's FraudGT logits differ from the CPU port's: {check}")
    if not check["run_vs_rescore_max_abs"] <= 1e-6:
        raise AssertionError(f"the predict_proba run disagrees with rescoring its first edges: {check}")
    fgt["profile"] = profile_forward(ft, ft.tokenize(g, test_ids[:FGT_PROFILE_EDGES]))
    log("FraudGT forward profile: " + json.dumps(fgt["profile"]))
    return fgt_launches, fa_path["args"]



def random_temporal_graph(seed: int):
    """A dense random temporal graph (the style of tests/conftest.py):
    every window of the ``full_deep`` patterns sees many edges."""
    import numpy as np
    from repro_torch.graph.csr import build_temporal_graph

    n_nodes, n_edges, t_max = ORACLE_GRAPH
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    fix = src == dst
    dst[fix] = (dst[fix] + 1) % n_nodes
    t = rng.integers(0, t_max, n_edges).astype(np.int64)
    return build_temporal_graph(src, dst, t, n_nodes=n_nodes)


def phase_oracle(report):
    """(a) every ``full_deep`` pattern mined on the card under both kernel
    backends equals the port's GFPReference on every edge of two random
    graphs; (b) the paper's Fig. 10 protocol (benchmarks/bench_scaling.py):
    scatter_gather on Trovares-10K/100K/1M, 2,000 seeds on the card, the
    first 400 of them through the oracle, exact, with both rates."""
    import numpy as np
    from repro_torch.api import MiningSession
    from repro_torch.core.compiler import CompiledPattern
    from repro_torch.core.oracle import GFPReference
    from repro_torch.core.patterns import build_pattern, feature_pattern_set
    from repro_torch.data.trovares import TROVARES_SIZES, generate_trovares_graph

    pats = feature_pattern_set("full_deep")
    graphs = []
    for seed in ORACLE_SEEDS:
        g = random_temporal_graph(seed)
        t0 = time.perf_counter()
        want = MiningSession(g, window=WINDOW, device="cpu").register(*pats).mine(backend="oracle").counts
        oracle_s = time.perf_counter() - t0
        row = {"seed": seed, "n_nodes": g.n_nodes, "n_edges": g.n_edges, "oracle_s": oracle_s,
               "nonzero_cells": int((want != 0).sum()), "totals": dict(zip(pats, want.sum(0).tolist()))}
        for backend in ("kernel", "torch"):
            t0 = time.perf_counter()
            got = MiningSession(g, window=WINDOW, kernel_backend=backend).register(*pats).mine().counts
            row[f"{backend}_s"] = time.perf_counter() - t0
            if not np.array_equal(got, want):
                bad = np.argwhere(got != want)[:5]
                raise AssertionError(f"graph seed {seed}: the {backend} mine differs from GFPReference at {bad.tolist()}")
        graphs.append(row)
        log("oracle: " + json.dumps(row))
    fig10 = {}
    spec = build_pattern("scatter_gather", WINDOW)
    for name, n_edges in TROVARES_SIZES.items():
        g = generate_trovares_graph(n_edges, seed=1)
        rng = np.random.default_rng(0)
        sample = rng.choice(g.n_edges, size=min(FIG10_SEEDS, g.n_edges), replace=False).astype(np.int32)
        cp = CompiledPattern(spec, g)
        cp.mine(sample)  # first call: schedule build and first launches
        t0 = time.perf_counter()
        got = cp.mine(sample)
        dt = time.perf_counter() - t0
        osub = sample[:FIG10_ORACLE_SEEDS]
        t0 = time.perf_counter()
        ref = GFPReference(spec, g).mine(osub)
        odt = time.perf_counter() - t0
        if not np.array_equal(got[: len(osub)], ref):
            raise AssertionError(f"Fig. 10 {name}: the card's counts differ from GFPReference")
        fig10[name] = {"n_edges": g.n_edges, "seeds": int(len(sample)), "oracle_seeds": int(len(osub)),
                       "compiled_edges_per_s": len(sample) / dt, "gfp_edges_per_s": len(osub) / odt,
                       "speedup": (len(sample) / dt) / (len(osub) / odt), "nonzero": int((got != 0).sum())}
    report["oracle"] = {"graph": dict(zip(("n_nodes", "n_edges", "t_max"), ORACLE_GRAPH)),
                        "patterns": list(pats), "graphs": graphs, "fig10": fig10}
    return fig10


def ic_form(args, ordered) -> dict:
    """The shape and operand forms of an intersect_count launch."""
    import torch

    b, da = args[0].shape
    bf, db = args[2].shape
    form = lambda w: "int" if not isinstance(w, torch.Tensor) else ("per row" if w.shape[0] == b else "per fixed row")
    return {"B": b, "Da": da, "Db": db, "B_fixed": bf, "W1_Wk": b // max(1, bf), "ordered": bool(ordered),
            "a_t": args[1] is not None, "windows": [form(w) for w in args[4:8]]}


def capture_biggest(biggest):
    """A stand-in for ic_ops.intersect_count that keeps the arguments of
    the largest launch (by B * Da * Db) in ``biggest`` and launches."""
    from repro_torch.kernels.intersect_count import ops as ic_ops

    kernel_fn = ic_ops.intersect_count

    def capture(*a, **kw):
        b, da = a[0].shape
        work = b * da * a[2].shape[1]
        if work > biggest.get("work", -1):
            biggest.update(work=work, args=a, ordered=kw.get("ordered", False))
        return kernel_fn(*a, **kw)

    return kernel_fn, capture


def stream_feed(g):
    """The streaming phases' microbatches: HI-Small in time order, one
    first tick of STREAM_FIRST transactions and then STREAM_TICKS ticks of
    STREAM_BATCH; ``lateness`` is the widest batch's time span + 1."""
    import numpy as np

    order = np.argsort(g.t, kind="stable")
    bounds = [0, STREAM_FIRST] + [STREAM_FIRST + STREAM_BATCH * (i + 1) for i in range(STREAM_TICKS)]
    chunks = [order[a:b] for a, b in zip(bounds, bounds[1:])]
    lateness = max(int(g.t[c].max() - g.t[c].min()) for c in chunks) + 1
    return order, chunks, lateness


def alert_arrays(batch):
    return (batch.eids, batch.src, batch.dst, batch.t, batch.amount, batch.counts, batch.score, batch.triggered)


def same_alerts(a, b) -> bool:
    import numpy as np

    return a.report.tick == b.report.tick and all(
        np.array_equal(x, y) for x, y in zip(alert_arrays(a), alert_arrays(b)))


def phase_streaming(session, g, report, zero_launches, read_launches):
    """The slice's path: a pipelined DetectionService from the phase-3
    session over a live HI-Small feed, under sync-debug "error" with only
    the tick's gather allowed to sync; then the batch recompute of the
    streamed prefix and a sequential service over the first ticks."""
    import numpy as np
    import torch
    from repro_torch.api import MiningSession
    from repro_torch.device import allowed_sync
    from repro_torch.graph.csr import build_temporal_graph
    from repro_torch.kernels.intersect_count import ops as ic_ops

    order, chunks, lateness = stream_feed(g)
    names = session.pattern_names
    svc_kw = dict(thresholds=STREAM_THRESHOLDS, retain="auto", lateness=lateness)
    svc = session.service(pipeline=True, **svc_kw)
    biggest = {}
    kernel_fn, capture = capture_biggest(biggest)
    batches, walls, jit_after = [], [], []
    n_check = STREAM_CHECK_TICKS
    checked_counts = None
    ic_ops.intersect_count = capture
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i, ch in enumerate(chunks):
            t0 = time.perf_counter()
            b = svc.submit(g.src[ch], g.dst[ch], g.t[ch], g.amount[ch])
            walls.append(time.perf_counter() - t0)
            if b is not None:
                batches.append(b)
                jit_after.append(svc.stats["jit_cache_entries"])
                if b.report.tick == n_check:
                    # ticks 1..n_check committed, tick n_check + 1 in flight
                    n_first = sum(len(c) for c in chunks[:n_check])
                    checked_counts = {n: svc.pattern_counts(n)[:n_first].copy() for n in names}
        t0 = time.perf_counter()
        for b in svc.flush():
            batches.append(b)
            jit_after.append(svc.stats["jit_cache_entries"])
        walls[-1] += time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        ic_ops.intersect_count = kernel_fn
    launches = read_launches()
    peak = int(torch.cuda.max_memory_allocated())
    reps = [b.report for b in batches]
    n_ticks = len(chunks)
    steady = walls[1:]  # the ticks after the first
    n_steady_txns = sum(len(c) for c in chunks[1:])
    stream = {
        "n_ticks": n_ticks, "first_tick_txns": len(chunks[0]), "tick_txns": STREAM_BATCH,
        "n_txns": int(sum(len(c) for c in chunks)), "lateness": lateness, "retain": svc.store.retain,
        "time_radius": svc.scheduler.max_time_radius, "thresholds": STREAM_THRESHOLDS,
        "first_tick_s": walls[0],
        "txns_per_s": n_steady_txns / sum(steady),
        "tick_ms": {"p50": float(np.percentile(steady, 50) * 1e3), "p99": float(np.percentile(steady, 99) * 1e3)},
        "stage_ms_p50": {s: float(np.percentile([getattr(r, s) for r in reps[1:]], 50))
                         for s in ("ingest_ms", "plan_ms", "mine_ms", "score_ms")},
        "dirty_fraction": {"mean": float(np.mean([r.dirty_fraction for r in reps[1:]])),
                           "last": float(reps[-1].dirty_fraction)},
        "paths": {p: sum(r.path == p for r in reps) for p in sorted({r.path for r in reps})},
        "live_edges": {"max": int(max(r.n_live for r in reps)), "last": int(reps[-1].n_live)},
        "peak_mem_bytes": peak,
        "launches": launches,
        "stats": dict(svc.stats),
        "store": dict(svc.store.stats),
        "trace_misses_by_tick": [int(r.trace_misses) for r in reps],
        "jit_cache_entries_by_tick": jit_after,
        "alerts": int(sum(len(b) for b in batches)),
        "degraded": sorted({d for r in reps for d in r.degraded}),
    }
    log("streaming: " + json.dumps({k: v for k, v in stream.items() if k != "trace_misses_by_tick"}))
    if [r.tick for r in reps] != list(range(1, n_ticks + 1)):
        raise AssertionError(f"committed ticks {[r.tick for r in reps]} are not 1..{n_ticks}")
    if svc.stats["host_syncs"] != n_ticks:
        raise AssertionError(f"the stream synced {svc.stats['host_syncs']} times over {n_ticks} ticks")
    if launches["intersect_count"] <= 0 or launches["window_search"] <= 0 or launches["window_search_step"] <= 0:
        raise AssertionError(f"the streaming ticks did not launch the mining kernels: {launches}")
    if stream["degraded"]:
        raise AssertionError(f"a plain service tick reports degradation: {stream['degraded']}")
    # a launch shape is the JAX package's trace key; the live window keeps
    # realizing new (strategy, dims, width) structure well past warm-up,
    # so the steady window is the last quarter, as the reference's own
    # benchmark defines it
    n_steady = max(3, n_ticks // 4)
    stream["steady_window_ticks"] = n_steady
    stream["steady_trace_misses"] = int(sum(r.trace_misses for r in reps[-n_steady:]))
    stream["mints_after_warm"] = [[r.tick, int(r.trace_misses)] for r in reps
                                  if r.tick > STREAM_WARM_TICKS and r.trace_misses]
    if stream["steady_trace_misses"] or jit_after[-n_steady - 1] != jit_after[-1]:
        raise AssertionError(f"the last {n_steady} ticks minted new launch shapes: "
                             f"{stream['jit_cache_entries_by_tick']}")
    if svc.stats["schedule_hits"] <= 0:
        raise AssertionError("no streaming tick replayed a cached schedule shape")

    # the batch recompute: the streamed prefix in arrival order, mined on the card
    prefix = order[: stream["n_txns"]]
    t0 = time.perf_counter()
    gp = build_temporal_graph(g.src[prefix], g.dst[prefix], g.t[prefix], g.amount[prefix])
    full = MiningSession(gp, window=WINDOW).register(*names).mine()
    stream["recompute_s"] = time.perf_counter() - t0
    for j, n in enumerate(names):
        if not np.array_equal(svc.pattern_counts(n), full.counts[:, j]):
            bad = np.flatnonzero(svc.pattern_counts(n) != full.counts[:, j])[:5]
            raise AssertionError(f"incremental {n} differs from the batch recompute at eids {bad.tolist()}")
    stream["recompute_totals"] = full.totals()

    # a sequential service over the first ticks: the same counts and alerts
    seq = session.service(pipeline=False, **svc_kw)
    t0 = time.perf_counter()
    seq_batches = [seq.submit(g.src[c], g.dst[c], g.t[c], g.amount[c]) for c in chunks[:n_check]]
    with allowed_sync():
        torch.cuda.synchronize()
    stream["sequential_s"] = time.perf_counter() - t0
    if not all(same_alerts(a, b) for a, b in zip(seq_batches, batches[:n_check])):
        raise AssertionError(f"the sequential service's alerts differ from the pipelined one's over {n_check} ticks")
    for n in names:
        if not np.array_equal(seq.pattern_counts(n), checked_counts[n]):
            raise AssertionError(f"sequential {n} counts differ from the pipelined ones after tick {n_check}")
    stream["sequential_equal_ticks"] = n_check
    report["streaming"] = stream
    log("streaming cross-checks: " + json.dumps({k: stream[k] for k in
                                                 ("steady_window_ticks", "steady_trace_misses",
                                                  "mints_after_warm", "recompute_s", "recompute_totals",
                                                  "sequential_s", "sequential_equal_ticks")}))
    return launches["intersect_count"], biggest


def phase_resilience(session, g, report, zero_launches, read_launches):
    """RESILIENCE_TICKS ticks of the same feed through a
    ResilientDetectionService with a WAL and checkpoints under build/, a
    transient fault armed in tick 3's mine (retried once), then recovery
    into a fresh object: the same store state bit for bit and equal counts.
    The ticks and the WAL replay of recover() each launch intersect_count
    (counts zeroed before each, read after): no rung of the ladder, and no
    replay, gives way to the plain version.  Returns the two launch counts."""
    import shutil

    import numpy as np
    from repro_torch.stream import (FaultInjector, ResilienceConfig, ResilientDetectionService,
                                    TransientFault, store_states_equal)

    _, chunks, lateness = stream_feed(g)
    chunks = chunks[:RESILIENCE_TICKS]
    names = session.pattern_names
    specs = [session._specs[n] for n in names]
    base = ROOT / "build" / "chip_smoke_resilience"
    shutil.rmtree(base, ignore_errors=True)
    cfg = ResilienceConfig(wal_dir=str(base / "wal"), checkpoint_dir=str(base / "ckpt"),
                           checkpoint_every=RESILIENCE_CHECKPOINT_EVERY)
    kw = dict(window=WINDOW, thresholds=STREAM_THRESHOLDS, retain="auto", lateness=lateness)
    chaos = FaultInjector()
    chaos.arm("mine", tick=3, times=1, exc=TransientFault)
    svc = ResilientDetectionService(specs, resilience=cfg, chaos=chaos, **kw)
    zero_launches()
    t0 = time.perf_counter()
    reps = [svc.submit(g.src[c], g.dst[c], g.t[c], g.amount[c]).report for c in chunks]
    run_s = time.perf_counter() - t0
    tick_ln = read_launches()
    tick_launches = tick_ln["intersect_count"]
    replayed = svc.wal.ticks()
    zero_launches()
    t0 = time.perf_counter()
    rec = ResilientDetectionService.recover(specs, resilience=cfg, **kw)
    recover_s = time.perf_counter() - t0
    recover_ln = read_launches()
    recover_launches = recover_ln["intersect_count"]
    res = {"ticks": len(chunks), "checkpoint_every": RESILIENCE_CHECKPOINT_EVERY, "run_s": run_s,
           "recover_s": recover_s, "retries_by_tick": [r.retries for r in reps],
           "degraded_by_tick": [list(r.degraded) for r in reps], "recovered_tick": rec.tick,
           "wal_replayed_ticks": replayed, "backends": [svc.backend, rec.backend],
           "intersect_count_launches": {"ticks": tick_launches, "recover": recover_launches},
           "window_search_launches": {"ticks": tick_ln["window_search"], "recover": recover_ln["window_search"]},
           "window_search_step_launches": {"ticks": tick_ln["window_search_step"],
                                           "recover": recover_ln["window_search_step"]},
           "health": svc.health()}
    report["resilience"] = res
    log("resilience: " + json.dumps(res))
    if reps[2].retries != 1 or any(r.retries for i, r in enumerate(reps) if i != 2):
        raise AssertionError(f"expected one retry on tick 3 alone: {res['retries_by_tick']}")
    if (not replayed or tick_launches <= 0 or recover_launches <= 0 or {svc.backend, rec.backend} != {"kernel"}
            or min(res["window_search_launches"].values()) <= 0
            or min(res["window_search_step_launches"].values()) <= 0):
        raise AssertionError(f"the resilient ticks or the WAL replay {replayed} did not run on "
                             f"intersect_count and window_search: {res['intersect_count_launches']}, "
                             f"{res['window_search_launches']}, {res['window_search_step_launches']}, "
                             f"{res['backends']}")
    if rec.tick != svc.tick or not store_states_equal(rec.store.state_dict(), svc.store.state_dict()):
        raise AssertionError("the recovered store differs from the live one")
    for n in names:
        if not np.array_equal(rec.pattern_counts(n), svc.pattern_counts(n)):
            raise AssertionError(f"the recovered {n} counts differ from the live ones")
    shutil.rmtree(base, ignore_errors=True)
    return tick_launches, recover_launches


def phase_witness(session, ds, counts, report):
    """(a) compiled witnesses on the card equal the port's GFPReference on
    the oracle's two random graphs, for every library pattern that has a
    witness layout, under both kernel backends, and witness-mode counts
    equal a counting mine's; (b) the session's witness mode over WIT_SEEDS
    seeds of the phase-3 graph under sync-debug "error" (one host sync per
    unique plan; counts equal phase 3's rows; the first WIT_CPU_SEEDS
    seeds' witnesses equal the CPU port's), beside each pattern's
    count-only wall; (c) every strictly time-ordered 3-cycle the data
    generator planted comes back as a cycle3 witness at its seed edge."""
    import numpy as np
    import torch
    from repro_torch.api import MiningSession
    from repro_torch.core.compiler import CompiledPattern, analyze_stage_graph
    from repro_torch.core.oracle import GFPReference
    from repro_torch.core.patterns import PATTERN_NAMES, build_pattern
    from repro_torch.data.synth_aml import planted_instances
    from repro_torch.device import allowed_sync
    from repro_torch.kernels.window_search import ops as ws_ops
    from repro_torch.witness import witness_layout

    wit = {}
    # (a) oracle exactness on the card
    accepted, refused = [], []
    for name in PATTERN_NAMES:
        try:
            witness_layout(analyze_stage_graph(build_pattern(name, WINDOW)))
            accepted.append(name)
        except NotImplementedError:
            refused.append(name)
    t0 = time.perf_counter()
    oracle_s, card_s, n_witnesses = 0.0, 0.0, 0
    for seed in ORACLE_SEEDS:
        g = random_temporal_graph(seed)
        seeds = np.random.default_rng(seed).choice(g.n_edges, size=WIT_ORACLE_SEEDS, replace=False).astype(np.int32)
        for name in accepted:
            spec = build_pattern(name, WINDOW)
            ts = time.perf_counter()
            oc, ow = GFPReference(spec, g).mine_witnesses(seeds, k=WIT_ORACLE_K)
            oracle_s += time.perf_counter() - ts
            n_witnesses += sum(len(x[:WIT_ORACLE_K]) for x in ow)
            for backend in ("kernel", "torch"):
                ts = time.perf_counter()
                cp = CompiledPattern(spec, g, backend=backend)
                w = cp.mine(seeds, witnesses=WIT_ORACLE_K)
                card_s += time.perf_counter() - ts
                if cp.stats["host_syncs"] != 1:
                    raise AssertionError(f"{name} ({backend}): the witness mine synced {cp.stats['host_syncs']} times")
                if not np.array_equal(w.counts, oc) or not np.array_equal(cp.mine(seeds), w.counts):
                    raise AssertionError(f"graph seed {seed}, {name} ({backend}): witness-mode counts differ")
                for i in range(len(seeds)):
                    if w.tuples(i) != ow[i][:WIT_ORACLE_K]:
                        raise AssertionError(f"graph seed {seed}, {name} ({backend}): seed {int(seeds[i])}'s "
                                             f"witnesses {w.tuples(i)} differ from the oracle's {ow[i][:WIT_ORACLE_K]}")
    wit["oracle"] = {"patterns": accepted, "refused": refused, "graphs": len(ORACLE_SEEDS),
                     "seeds": WIT_ORACLE_SEEDS, "k": WIT_ORACLE_K, "witnesses_checked": n_witnesses,
                     "oracle_s": oracle_s, "card_s": card_s, "phase_s": time.perf_counter() - t0}
    log("witness oracle: " + json.dumps(wit["oracle"]))

    # (b) the session's witness mode at full width, over the seed prefix
    # each pattern is cut to (WIT_SEEDS_CUT), one session mine per prefix
    g = ds.graph
    pats = list(session.pattern_names)
    seeds = np.random.default_rng(SEED).choice(g.n_edges, size=min(WIT_SEEDS, g.n_edges), replace=False).astype(np.int32)
    n_of = {n: min(WIT_SEEDS_CUT.get(n, WIT_SEEDS), len(seeds)) for n in pats}
    cpu_of = {n: min(WIT_CPU_SEEDS_CUT.get(n, WIT_CPU_SEEDS), n_of[n]) for n in pats}
    count_s, res, stats = {}, {}, []
    wit_wall, ws_launches = 0.0, 0
    step_before = ws_ops.step_launches
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for n in pats:
            cp = session._compiled_for(session._canon_of[n])
            ts = time.perf_counter()
            col = cp.mine(seeds[: n_of[n]])
            count_s[n] = time.perf_counter() - ts
            if not np.array_equal(col, counts[seeds[: n_of[n]], pats.index(n)]):
                raise AssertionError(f"the count-only {n} mine differs from phase 3's rows")
        for m in sorted(set(n_of.values()), reverse=True):
            group = [n for n in pats if n_of[n] == m]
            ts = time.perf_counter()
            ws_before = ws_ops.launches
            r = session.mine(group, seeds[:m], witnesses=WIT_K)
            wit_wall += time.perf_counter() - ts
            ws_launches += ws_ops.launches - ws_before
            n_plans = len({session._canon_of[n] for n in group})
            if r.stats["host_syncs"] != n_plans:
                raise AssertionError(f"the witness mine of {group} synced {r.stats['host_syncs']} times, not {n_plans}")
            if not np.array_equal(r.counts, counts[seeds[:m]][:, [pats.index(n) for n in group]]):
                raise AssertionError(f"witness-mode counts of {group} differ from phase 3's rows")
            stats.append({"patterns": group, "seeds": m, **r.stats})
            res.update({n: (r.witnesses[n], r.seconds[n]) for n in group})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_launches = ws_ops.step_launches - step_before  # the count-only and the witness mines
    peak = int(torch.cuda.max_memory_allocated())
    ts = time.perf_counter()
    cpu = MiningSession(g, window=WINDOW, device="cpu").register(*pats)
    cpu_group_s = []
    for m in sorted(set(cpu_of.values()), reverse=True):
        group = [n for n in pats if cpu_of[n] == m]
        tg = time.perf_counter()
        r = cpu.mine(group, seeds[:m], witnesses=WIT_K)
        cpu_group_s.append({"patterns": group, "seeds": m, "s": time.perf_counter() - tg})
        for n in group:
            a, b = res[n][0], r.witnesses[n]
            if not (np.array_equal(a.eids[:m], b.eids) and np.array_equal(a.counts[:m], b.counts)):
                raise AssertionError(f"{n}: the card's witnesses differ from the CPU port's")
    cpu_s = time.perf_counter() - ts
    per = {n: {"seeds": n_of[n], "cpu_seeds": cpu_of[n], "count_only_s": count_s[n], "witness_s": res[n][1],
               "overhead_x": res[n][1] / count_s[n], "n_hops": res[n][0].n_hops,
               "seeds_with_witnesses": int((res[n][0].n_found > 0).sum())}
           for n in pats}
    wit["session"] = {"seeds": int(len(seeds)), "k": WIT_K, "witness_wall_s": wit_wall,
                      "count_only_wall_s": sum(count_s.values()), "per_pattern": per, "mines": stats,
                      "peak_mem_bytes": peak, "cpu_s": cpu_s, "cpu_mines": cpu_group_s, "cpu_equal": True,
                      "window_search_launches": ws_launches, "window_search_step_launches": step_launches}
    log("witness session: " + json.dumps(wit["session"]))
    if ws_launches <= 0:
        raise AssertionError("the session's witness mines launched window_search no time")
    if step_launches <= 0:
        raise AssertionError("the session's count-only and witness mines launched intersect_step no time")

    # (c) plant and recover at full size
    planted = [inst["eids"] for inst in planted_instances(ds, "cycle")
               if len(inst["eids"]) == 3 and np.all(np.diff(g.t[inst["eids"]]) > 0)]
    if not planted:
        raise AssertionError("the data generator planted no strictly time-ordered 3-cycle")
    cp = session._compiled_for(session._canon_of["cycle3"])
    seed_edges = np.asarray([e[0] for e in planted], dtype=np.int32)
    ts = time.perf_counter()
    c3 = cp.mine(seed_edges)
    recovered = 0
    for k in sorted({max(1, int(c)) for c in c3}):
        sel = np.flatnonzero(np.maximum(c3, 1) == k)
        w = cp.mine(seed_edges[sel], witnesses=k)
        for r, i in enumerate(sel):
            if (int(planted[i][1]), int(planted[i][2])) not in w.tuples(r):
                raise AssertionError(f"planted 3-cycle {planted[i].tolist()} is not a cycle3 witness at its seed edge "
                                     f"(count {int(c3[i])}, witnesses {w.tuples(r)})")
            recovered += 1
    with allowed_sync():
        torch.cuda.synchronize()
    wit["plant_and_recover"] = {"planted_3cycles": len(planted), "recovered": recovered,
                                "max_count": int(c3.max()), "s": time.perf_counter() - ts}
    log("witness plant-and-recover: " + json.dumps(wit["plant_and_recover"]))
    report["witness"] = wit


def phase_triage(g, report, zero_launches, read_launches):
    """The port's TriageServer over DetectionService(DEFAULT_PORTFOLIO,
    witnesses=2) on the card (src/repro/launch/serve.py's service), fed
    HI-Small in time order through make_feed: one warm submit, then
    TRIAGE_SUBMITS submits through TRIAGE_SUBMITTERS threads, with an
    audit log under build/, under sync-debug "error".  Then a sequential
    service at k = TRIAGE_EXACT_K whose last tick's evidence equals the
    oracle on the store's snapshot.  Returns intersect_count's launches."""
    import numpy as np
    import torch
    import repro_torch.stream.service as service_mod
    from repro_torch.core.oracle import GFPReference
    from repro_torch.launch.serve import DEFAULT_PORTFOLIO, SubmitError, TriageServer, load_test, make_feed
    from repro_torch.obs import trace as obs_trace
    from repro_torch.stream import DetectionService

    feed = make_feed(g, TRIAGE_BATCH)
    n_warm = TRIAGE_WARM // TRIAGE_BATCH
    warm = tuple(np.concatenate([b[j] for b in feed[:n_warm]]) for j in range(4))
    live = feed[n_warm : n_warm + TRIAGE_SUBMITS]
    names = list(DEFAULT_PORTFOLIO)
    svc = DetectionService(names, window=WINDOW, thresholds=dict(DEFAULT_PORTFOLIO), witnesses=TRIAGE_K)
    audit = ROOT / "build" / "chip_smoke_triage.jsonl"
    audit.parent.mkdir(parents=True, exist_ok=True)
    audit.unlink(missing_ok=True)
    server = TriageServer(svc, audit_path=str(audit))
    # independent records of what the service was fed and what it mined:
    # the inputs in the order they reached the store (global eids are
    # arrival order), each tick's dirty seeds, and the witness mines run
    fed, dirty, outs, wit_mines = [], {}, [], [0]
    svc_submit, dispatch, mine_witnesses = svc.submit, svc._dispatch_mine, service_mod.mine_witnesses

    def record_submit(src, dst, t, amount=None):
        fed.append((src, dst, t, amount))
        return svc_submit(src, dst, t, amount)

    def record_dispatch(plan, view, stats):
        dirty[svc.tick] = {n: set(int(e) for e in d) for n, d in plan.dirty.items()}
        return dispatch(plan, view, stats)

    def count_mines(*a, **kw):
        wit_mines[0] += 1
        return mine_witnesses(*a, **kw)

    server_submit = server.submit

    def keep(*a):
        out = server_submit(*a)
        outs.append(out)
        return out

    svc.submit, svc._dispatch_mine, service_mod.mine_witnesses, server.submit = (
        record_submit, record_dispatch, count_mines, keep)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    tracer = obs_trace.get_tracer()
    torch.cuda.set_sync_debug_mode("error")
    try:
        server.submit(*warm)
        tracer.reset()
        obs_trace.enable()
        lt = load_test(server, live, TRIAGE_SUBMITTERS)
    finally:
        obs_trace.disable()
        torch.cuda.set_sync_debug_mode(0)
        service_mod.mine_witnesses = mine_witnesses
    launches = read_launches()
    peak = int(torch.cuda.max_memory_allocated())
    spans = tracer.spans()
    server.close()
    errors = [o for o in outs if isinstance(o, SubmitError)]
    if errors:
        raise AssertionError(f"{len(errors)} submits failed: {errors[0]}")
    lat = np.asarray(server.latencies[1:]) * 1e3  # the live submits, the warm one set aside
    span_ms = {}
    for ev in spans:
        if ev["name"] == "tick" or ev["name"].startswith("tick:"):
            span_ms[ev["name"]] = span_ms.get(ev["name"], 0.0) + ev["dur_ns"] / 1e6
    reps = [b.report for b in outs[1:]]
    tri = {
        "warm_txns": int(len(warm[0])), "submits": len(live), "batch": TRIAGE_BATCH, "submitters": TRIAGE_SUBMITTERS,
        "k": TRIAGE_K, "portfolio": DEFAULT_PORTFOLIO, "warm_submit_s": float(server.latencies[0]),
        "submit_ms": {"p50": float(np.percentile(lat, 50)), "p99": float(np.percentile(lat, 99)),
                      "max": float(lat.max())},
        "txns_per_s": float(sum(len(b[0]) for b in live) / lt["wall_s"]),
        "wall_s": float(lt["wall_s"]), "alerts": int(server.n_alerts), "evidence_hop_tuples": int(server.n_evidence_hops),
        "suppressed_duplicates": int(server.n_suppressed), "ticks": int(svc.tick), "witness_mines": wit_mines[0],
        "host_syncs": int(svc.stats["host_syncs"]), "launches": launches, "peak_mem_bytes": peak,
        "span_ms": span_ms, "witness_share": span_ms.get("tick:witness", 0.0) / span_ms["tick"],
        "stage_ms_p50": {s: float(np.percentile([getattr(r, s) for r in reps], 50))
                         for s in ("ingest_ms", "plan_ms", "mine_ms", "score_ms")},
        "paths": {p: sum(r.path == p for r in reps) for p in sorted({r.path for r in reps})},
        "degraded": sorted({d for b in outs for d in b.report.degraded}),
    }
    if tri["degraded"]:
        raise AssertionError(f"a triage tick reports degradation: {tri['degraded']}")
    if launches["intersect_count"] <= 0 or launches["window_search"] <= 0 or launches["window_search_step"] <= 0:
        raise AssertionError(f"the triage ticks did not launch the mining kernels: {launches}")
    if svc.stats["host_syncs"] != svc.tick + wit_mines[0]:
        raise AssertionError(f"{svc.stats['host_syncs']} host syncs over {svc.tick} ticks and {wit_mines[0]} witness mines")
    # every alert of a pattern counted this tick carries min(k, count)
    # witnesses, and only those carry evidence
    fsrc, fdst, ft, famt = (np.concatenate([np.asarray(f[j]) for f in fed]) for j in range(4))
    pairs = hops = 0
    for b in outs:
        mined = dirty.get(b.report.tick, {})
        for i in range(len(b)):
            e = int(b.eids[i])
            want = {n for j, n in enumerate(b.columns) if b.triggered[i, j] and e in mined.get(n, ())}
            if set(b.evidence[i]) != want:
                raise AssertionError(f"tick {b.report.tick}, eid {e}: evidence for {sorted(b.evidence[i])}, "
                                     f"fired and counted {sorted(want)}")
            for n, wits in b.evidence[i].items():
                if len(wits) != min(TRIAGE_K, int(b.counts[i, b.columns.index(n)])):
                    raise AssertionError(f"tick {b.report.tick}, eid {e}, {n}: {len(wits)} witnesses")
                pairs += 1
                for hop in (h for wit in wits for h in wit if h["eid"] >= 0):
                    x = hop["eid"]
                    if (int(fsrc[x]), int(fdst[x]), int(ft[x]), float(np.float32(famt[x]))) != (
                            hop["src"], hop["dst"], hop["t"], hop["amount"]):
                        raise AssertionError(f"evidence hop {hop} is not the fed transaction {x}")
                    hops += 1
    tri["evidence_pairs_checked"], tri["evidence_hops_checked"] = pairs, hops
    lines = [json.loads(ln) for ln in audit.read_text().splitlines()]
    if not lines or lines[-1].get("metrics") is not True:
        raise AssertionError("the audit log does not end with its metrics line")
    tri["audit_lines"] = len(lines)

    # exactness, sequentially, small enough for the oracle
    seq = DetectionService(names, window=WINDOW, thresholds=dict(DEFAULT_PORTFOLIO), witnesses=TRIAGE_EXACT_K)
    order = np.argsort(g.t, kind="stable")
    head = order[:TRIAGE_EXACT_WARM]
    seq.submit(g.src[head], g.dst[head], g.t[head], g.amount[head])
    for i in range(TRIAGE_EXACT_SUBMITS):
        c = order[TRIAGE_EXACT_WARM + i * TRIAGE_BATCH : TRIAGE_EXACT_WARM + (i + 1) * TRIAGE_BATCH]
        last = seq.submit(g.src[c], g.dst[c], g.t[c], g.amount[c])
    snap = seq.store.snapshot()
    oracles = {n: GFPReference(seq._specs[n], snap.graph) for n in names}
    checked = 0
    for i in range(len(last)):
        for n, wits in last.evidence[i].items():
            if checked >= TRIAGE_EXACT_PAIRS:
                break
            seed = int(last.eids[i])  # no retention: global ids are the snapshot's
            _, ow = oracles[n].mine_witnesses(np.array([seed], np.int32), k=TRIAGE_EXACT_K)
            if [tuple(h["eid"] for h in wit) for wit in wits] != ow[0][:TRIAGE_EXACT_K]:
                raise AssertionError(f"sequential tick {last.report.tick}, eid {seed}, {n}: evidence differs from the oracle")
            checked += 1
    if checked == 0:
        raise AssertionError("the sequential service's last tick carried no evidence to check")
    tri["oracle_pairs_checked"] = checked
    report["triage"] = tri
    log("triage: " + json.dumps(tri))
    return launches["intersect_count"]


def phase_sharded(session, g, counts, report, zero_launches, read_launches):
    """Phase 15: the phase-3 session's sharded mine of SHARD_SEEDS seeds,
    twice, under ``set_sync_debug_mode("error")``: in SHARD_PARTS
    partitions (they time-share the card: the host gather) and in one
    (the device-side sum).  Each must equal phase
    3's rows, sync once, launch ``intersect_count`` and have per-shard
    stats that sum to its totals.  Then ``repro_torch.launch.mine``'s
    command line once.  Returns intersect_count's launches."""
    import contextlib
    import io

    import numpy as np
    import torch
    from repro_torch.core import executor
    from repro_torch.device import allowed_sync
    from repro_torch.launch import mine as mine_cli

    sub = np.random.default_rng(SEED).choice(g.n_edges, size=min(SHARD_SEEDS, g.n_edges),
                                             replace=False).astype(np.int32)
    rows = {}
    launches = 0
    for name, seeds, n_parts, mode in (("parts", sub, SHARD_PARTS, "host"), ("seeds", sub, 1, "collective")):
        zero_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            res = session.mine(seeds=seeds, backend="sharded", n_parts=n_parts)
            with allowed_sync():
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        row = {"n_seeds": int(res.n_seeds), "n_parts": res.partition_plan.n_parts, "wall_s": wall,
               "dispatch_wall_s": res.dispatch_wall_s, "overlap_ratio": res.dispatch_overlap_ratio(),
               "per_shard_s": res.per_shard_seconds, "balance": res.shard_balance(),
               "gather_mode": res.gather_mode, "devices": list(res.shard_devices),
               "launches": read_launches(), "stats": res.stats}
        rows[name] = row
        log(f"sharded mine ({name}): " + json.dumps(row))
        if not np.array_equal(res.counts, counts[seeds]):
            raise AssertionError(f"the sharded mine ({name}) differs from phase 3's rows")
        if res.gather_mode != mode or res.stats["host_syncs"] != 1:
            raise AssertionError(f"the sharded mine ({name}) gathered by {res.gather_mode!r} with "
                                 f"{res.stats['host_syncs']} host syncs, not {mode!r} with 1")
        if (row["launches"]["intersect_count"] <= 0 or row["launches"]["window_search"] <= 0
                or row["launches"]["window_search_step"] <= 0):
            raise AssertionError(f"the sharded mine ({name}) did not launch the mining kernels: {row['launches']}")
        for key in executor.STAT_KEYS:
            part = sum(st[key] for st in res.shard_stats)
            if key in ("host_syncs", "bytes_d2h"):
                part += res.stats[key]  # charged to the mine's gather alone
            if part != res.stats[key]:
                raise AssertionError(f"the shards' {key} sum to {part}, not the mine's {res.stats[key]}")
        launches += row["launches"]["intersect_count"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_counts, _, cli_timing = mine_cli.main(list(SHARD_CLI_ARGS))
    cli = {"argv": list(SHARD_CLI_ARGS), "wall_s": time.perf_counter() - t0, "output": buf.getvalue().strip(),
           "instances": int(cli_counts.sum()), "host_syncs": cli_timing["host_syncs"],
           "gather_mode": cli_timing["gather_mode"]}
    rows["cli"] = cli
    log("sharded mine (repro_torch.launch.mine): " + json.dumps(cli))
    if cli["host_syncs"] != 1:
        raise AssertionError(f"repro_torch.launch.mine synced {cli['host_syncs']} times")
    report["sharded"] = rows
    return launches


def phase_fraudgt_fit(ds, report, zero_launches, read_launches):
    """Phase 16: FraudGT trained on the card (FraudGTParams(epochs=
    FGT_EPOCHS), the widths every caller uses) over the first FGT_FIT_ROWS
    training edges under ``set_sync_debug_mode("error")``, every step's
    attention through the forward kernel (with the logsumexp) and the
    backward kernel; the threshold picked on the edges it trained on and
    F1 on the test split, as ``benchmarks/bench_fraudgt.py`` does; then
    FGT_PROFILE_STEPS steps of a second fit under ``torch.profiler`` (the
    device's busy share of a step, kernels a step).  Returns the launch
    counts and the arguments of the fit's first backward launch."""
    import numpy as np
    import torch
    from repro_torch.data.loader import temporal_split
    from repro_torch.device import allowed_sync, to_host
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.ml.fraudgt import FraudGT, FraudGTParams
    from repro_torch.ml.metrics import best_f1_threshold, precision_recall_f1

    g = ds.graph
    y = ds.labels.astype(np.float32)
    train_ids, test_ids = temporal_split(ds)
    fit_ids = train_ids if FGT_FIT_ROWS is None else train_ids[:FGT_FIT_ROWS]
    params = FraudGTParams(epochs=FGT_EPOCHS)
    ft = FraudGT(params, seed=0)
    bwd_fn = fa_ops.flash_attention_bwd
    path = {}  # the fit's first backward launch: a batch of 256 edges

    def capture_bwd(q, k, v, o, do, lse, **kw):
        path.setdefault("args", tuple(x.detach() for x in (q, k, v, o, do, lse)) + (kw.get("causal", True),))
        return bwd_fn(q, k, v, o, do, lse, **kw)

    fa_ops.flash_attention_bwd = capture_bwd
    zero_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        ft.fit(g, ds.labels, fit_ids)
        with allowed_sync():
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        fa_ops.flash_attention_bwd = bwd_fn
    launches = read_launches()
    steps = ft.fit_seconds["steps"]
    losses = to_host(ft.losses)
    t0 = time.perf_counter()
    thr = best_f1_threshold(y[fit_ids], ft.predict_proba(g, fit_ids))
    thr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proba = ft.predict_proba(g, test_ids)
    predict_s = time.perf_counter() - t0
    prec, rec, f1 = precision_recall_f1(y[test_ids], proba >= thr)
    det = report.get("detection", {})
    row = {"epochs": params.epochs, "fit_edges": int(len(fit_ids)), "batch": params.batch, "steps": steps,
           "tokenize_s": ft.fit_seconds["tokenize"], "train_s": ft.fit_seconds["train"], "fit_s": fit_s,
           "steps_per_s": steps / ft.fit_seconds["train"], "threshold": thr, "threshold_s": thr_s,
           "predict_s": predict_s, "predict_tokenize_s": ft.seconds["tokenize"], "n_test": int(len(test_ids)),
           "f1": f1, "precision": prec, "recall": rec,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "loss_mean_last_100": float(losses[-100:].mean()),
           "proba_min": float(proba.min()), "proba_max": float(proba.max()), "proba_std": float(proba.std()),
           "launches": launches, "expected_attention_launches": params.n_layers * steps,
           "pipeline_f1": {fs: det.get(fs, {}).get("f1") for fs in ("full", "xgb_only")}}
    row["profile"] = profile_fit(FraudGT(params, seed=0), g, ds.labels,
                                 fit_ids[: FGT_PROFILE_STEPS * params.batch], FGT_PROFILE_STEPS)
    report["fraudgt_fit"] = row
    log("FraudGT training: " + json.dumps(row))
    want = params.n_layers * steps
    got = (launches["flash_attention"], launches["flash_attention_lse"], launches["flash_attention_bwd"])
    if got != (want, want, want):
        raise AssertionError(f"the fit's attention launches (forward, with lse, backward) are {got}, not {want} each")
    if not np.all(np.isfinite(losses)) or len(losses) != steps:
        raise AssertionError(f"the fit's {len(losses)} losses are not {steps} finite values")
    if not proba.std() > 0 or not np.all(np.isfinite(proba)):
        raise AssertionError("the trained FraudGT scores every test edge alike or not finitely")
    if not f1 > 0:
        raise AssertionError(f"the trained FraudGT detected nothing on the test split (F1 {f1})")
    return launches, path["args"]


def profile_fit(ft, g, labels, ids, steps) -> dict:
    """``steps`` steps of ``ft.fit`` on ``ids`` timed under
    ``torch.profiler``: the device's kernel time against the wall (one
    stream: the busy share), kernels a step, the attention kernels' share
    and the top kernels (``"profiled": false`` when the profiler recorded
    no device kernel).  The wall includes tokenizing ``ids``."""
    import collections

    events, wall = profiled_device_events(lambda: ft.fit(g, labels, ids))
    if not events:
        return {"steps": steps, "wall_s": wall, "profiled": False}
    kern = collections.defaultdict(lambda: [0.0, 0])
    for name, us in events:
        kern[name][0] += us / 1e6
        kern[name][1] += 1
    busy = sum(v[0] for v in kern.values())
    train = ft.fit_seconds["train"]
    return {"steps": steps, "profiled": True, "wall_s": wall, "train_s": train,
            "device_kernel_s": busy, "device_busy_share_of_steps": busy / train if train else None,
            "kernels_per_step": len(events) / steps,
            "flash_fwd_s": sum(v[0] for k, v in kern.items() if "flash_fwd_kernel" in k),
            "flash_bwd_s": sum(v[0] for k, v in kern.items() if "flash_bwd_kernel" in k),
            "top_kernels": [{"name": k[:100], "s": v[0], "count": v[1]}
                            for k, v in sorted(kern.items(), key=lambda kv: -kv[1][0])[:10]]}


def lm_smoke_batch(cfg, b: int, t: int, seed: int) -> dict:
    """A smoke batch drawn with numpy: tokens and labels, or the audio
    stub's frame embeddings and per-codebook labels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if cfg.precomputed_embeddings:
        return {"embeds": rng.normal(size=(b, t, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (b, t, cfg.n_codebooks)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}


def decode_all(params, cfg, toks, cache_len: int, device):
    """Decode ``toks`` (B, T), or the audio stub's frames (B, T, d), one
    step at a time from an empty cache: the logits of the steps, (B, T, V)
    or (B, T, n_codebooks, V)."""
    import torch
    from repro_torch.models import model as M

    key = "embeds" if cfg.precomputed_embeddings else "tokens"
    cache = M.cache_init(cfg, toks.shape[0], cache_len, device=device)
    return torch.stack([M.decode_step(params, cache, {key: toks[:, i : i + 1]}, cfg)[0][:, 0]
                        for i in range(toks.shape[1])], dim=1)


def lm_serve(cfg, params, nreq: int, cache_len: int, calls: int, device, plen: int = LM_SERVE[1],
             ngen: int = LM_SERVE[2], profile: bool = True):
    """``decode_lm.generate`` serving ``nreq`` requests of ``plen`` prompt
    and ``ngen`` new tokens (LM_SERVE's by default) from a
    ``cache_len``-slot cache, ``calls`` times, then LM_PROFILE_STEPS decode
    steps on a fresh cache of that length timed and, with ``profile``,
    under ``torch.profiler`` (decode attention reads every slot, live or
    not, so a step costs the same at any position).  ``step_bound_ms``:
    the float32 weights and the bf16 KV cache read once, over the card's
    memory rate.  Returns the cell and the calls' tokens."""
    import numpy as np
    import torch
    from repro_torch.device import h2d
    from repro_torch.launch import decode_lm
    from repro_torch.models import model as M

    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (nreq, plen)).astype(np.int32)  # as decode_lm.main
    served, walls = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        served.append(decode_lm.generate(cfg, params, prompt, ngen, cache_len=cache_len))
        walls.append(time.perf_counter() - t0)
    with torch.inference_mode():
        cache = M.cache_init(cfg, nreq, cache_len, device=device)
        kv_bytes = sum(a.numel() * a.element_size() for a in M.tree_leaves(cache))
        step = decode_lm.make_serve_step(cfg)
        cur = h2d(prompt[:, :1], device)
        step(params, cache, {"tokens": cur})
        torch.cuda.synchronize()

        def steps():
            for _ in range(LM_PROFILE_STEPS):
                step(params, cache, {"tokens": cur})

        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / LM_PROFILE_STEPS
        step_prof = device_profile(steps) if profile else None
        del cache
    w_bytes = sum(a.numel() * a.element_size() for a in M.tree_leaves(params))
    cell = {"requests": nreq, "prompt": plen, "new_tokens": ngen, "cache_len": cache_len, "kv_cache_bytes": kv_bytes,
            "walls_s": walls, "tokens_per_s": nreq * ngen / min(walls),
            "ms_per_step": 1e3 * min(walls) / (plen + ngen), "identical": all(np.array_equal(served[0], x) for x in served),
            "step_ms_steady": 1e3 * step_s, "step_bound_ms": (w_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3,
            "step_profile_steps": LM_PROFILE_STEPS, "step_profile": step_prof,
            "first_tokens": served[0][0, : plen + 8].tolist()}
    return cell, served


def phase_lm(report, zero_launches, read_launches):
    """Phase 17: the LM scaffold's serving path on the card, at qwen2-1.5b's
    published width with seeded weights, then every architecture's smoke
    config.  Returns the prefill's launch counts and the arguments of its
    first flash_attention launch."""
    import contextlib
    import dataclasses
    import io

    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS, get_config, smoke_config
    from repro_torch.device import h2d
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import decode_lm
    from repro_torch.models import model as M

    device = torch.device("cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32, as the CPU
    cfg = get_config(LM_ARCH)
    out = {"arch": LM_ARCH, "n_params": M.n_params(cfg), "dtype": cfg.dtype}
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["weights_bytes"] = sum(a.numel() * a.element_size() for a in M.tree_leaves(params))

    # (a) the prefill at full width, bf16, every layer's attention through the kernel
    b, t = LM_PREFILL
    toks = h2d(np.random.default_rng(SEED).integers(0, cfg.vocab, (b, t)).astype(np.int32), device)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    path = fa_ops.plan(b, t, t, h, kvh, hd, torch.bfloat16, True)
    if path != "wgmma" or fa_ops.kernel_plan(b, t, t, h, kvh, hd, torch.bfloat16, True) != path:
        raise AssertionError(f"qwen2's prefill launch is planned on the {path!r} path, not the wgmma path")
    fa_fn = fa_ops.flash_attention
    fa_args = {}

    def capture_fa(q, k, v, **kw):
        fa_args.setdefault("args", (q, k, v, kw.get("causal", True)))
        return fa_fn(q, k, v, **kw)

    batch = {"tokens": toks}
    walls = []
    with torch.inference_mode():
        M.forward(params, batch, cfg)  # warm up: cuBLAS handles, the kernel's first launch
        torch.cuda.synchronize()
        fa_ops.flash_attention = capture_fa
        try:
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            t0 = time.perf_counter()
            logits, aux = M.forward(params, batch, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = read_launches()
        finally:
            fa_ops.flash_attention = fa_fn
        peak = torch.cuda.max_memory_allocated()
        for _ in range(LM_PREFILL_REPS - 1):
            t0 = time.perf_counter()
            M.forward(params, batch, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        finite = bool(torch.isfinite(logits).all())
        logits_t, _ = M.forward(params, batch, cfg, attn_backend="torch")
        diff = max(float((logits[i].float() - logits_t[i].float()).abs().max()) for i in range(b))
        agree = float((logits.argmax(-1) == logits_t.argmax(-1)).float().mean())
        # both bf16 backends against the float32 forward of the first sequence
        l32, _ = M.forward(params, {"tokens": toks[:1]}, dataclasses.replace(cfg, dtype="float32"))
        err_k = (logits[0].float() - l32[0]).abs()
        err_t = (logits_t[0].float() - l32[0]).abs()
        vs32 = {"logits32_max_abs": float(l32.abs().max()), "logits32_mean_abs": float(l32.abs().mean()),
                "kernel_vs_float32_max_abs": float(err_k.max()), "kernel_vs_float32_mean_abs": float(err_k.mean()),
                "torch_vs_float32_max_abs": float(err_t.max()), "torch_vs_float32_mean_abs": float(err_t.mean())}
        shape = tuple(logits.shape)
        del logits, logits_t, l32, err_k, err_t
        prof = device_profile(lambda: M.forward(params, batch, cfg))
    prefill = {"batch": b, "tokens": t, "walls_s": walls, "wall_s": min(walls), "tokens_per_s": b * t / min(walls),
               "peak_mem_bytes": int(peak), "launches": launches, "expected_flash_launches": cfg.n_layers,
               "plan": path, "logits_shape": shape, "logits_finite": finite, "aux": float(aux),
               "kernel_vs_torch_max_abs": diff, "kernel_vs_torch_argmax_agree": agree, **vs32, "profile": prof}
    out["prefill"] = prefill
    log("LM prefill: " + json.dumps(prefill))
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"the prefill launched flash_attention {launches['flash_attention']} times, "
                             f"not {cfg.n_layers}")
    if not finite or shape != (b, t, cfg.vocab):
        raise AssertionError(f"the prefill's logits of shape {shape} are not all finite")
    if not vs32["kernel_vs_float32_mean_abs"] <= LM_BF16_ERR_RATIO * vs32["torch_vs_float32_mean_abs"]:
        raise AssertionError(f"the kernel backend's bf16 logits are further from float32 than "
                             f"{LM_BF16_ERR_RATIO} x the torch backend's: {vs32}")

    # (b) float32 at full width: both attention backends, decode against forward
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.inference_mode():
        one = {"tokens": toks[:1, :LM_F32_T]}
        lk, _ = M.forward(params, one, cfg32)
        lt, _ = M.forward(params, one, cfg32, attn_backend="torch")
        f32_diff = float((lk - lt).abs().max())
        f32_ok = bool(torch.allclose(lk, lt, rtol=1e-3, atol=1e-3))
        del lk, lt
        db, dtn = LM_DECODE
        full, _ = M.forward(params, {"tokens": toks[:db, :dtn]}, cfg32)
        dec = decode_all(params, cfg32, toks[:db, :dtn], dtn, device)
        dec_diff = float((dec - full).abs().max())
        dec_ok = bool(torch.allclose(dec, full, rtol=2e-3, atol=2e-3))
        del full, dec
    f32 = {"tokens": LM_F32_T, "plan": fa_ops.plan(1, LM_F32_T, LM_F32_T, h, kvh, hd, torch.float32, True),
           "kernel_vs_torch_max_abs": f32_diff, "decode_shape": list(LM_DECODE), "decode_vs_forward_max_abs": dec_diff}
    out["float32"] = f32
    log("LM float32 checks: " + json.dumps(f32))
    if not f32_ok:
        raise AssertionError(f"the float32 backends differ by more than 1e-3 at full width: {f32_diff}")
    if not dec_ok:
        raise AssertionError(f"decode differs from forward by more than 2e-3 at full width: {dec_diff}")

    # (c) serving: generate twice at LM_SERVE's small cache (identical
    # tokens), then once at each of LM_SERVE_CACHES, each cell followed by a
    # few decode steps under the profiler
    nreq, plen, ngen = LM_SERVE
    zero_launches()
    serve, served = lm_serve(cfg, params, nreq, plen + ngen + 1, 2, device)
    serve["launches"] = read_launches()
    out["serve"] = serve
    log("LM serving: " + json.dumps(serve))
    if not serve["identical"] or served[0].shape != (nreq, plen + ngen):
        raise AssertionError("two generate calls on the same prompt gave different tokens")
    out["serve_long"] = []
    for reqs, slots in LM_SERVE_CACHES:
        cell, toks_long = lm_serve(cfg, params, reqs, slots, 1, device)
        out["serve_long"].append(cell)
        log("LM serving at a long cache: " + json.dumps(cell))
        if toks_long[0].shape != (reqs, plen + ngen):
            raise AssertionError(f"generate at {reqs} x {slots} slots gave tokens of shape {toks_long[0].shape}")
        del toks_long
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    # (d) every architecture's smoke config, float32, the card against the CPU port
    smoke = {}
    sb, st = LM_SMOKE
    for name in sorted(ARCHS):
        c = dataclasses.replace(smoke_config(name), dtype="float32")
        p_cpu = M.init_params(c, SEED, device="cpu")
        p_dev = M.tree_map(lambda a: a.to(device), p_cpu)
        bt = lm_smoke_batch(c, sb, st, SEED)
        on = lambda d: {k: torch.from_numpy(v).to(d) for k, v in bt.items()}
        zero_launches()
        with torch.inference_mode():
            lg_d, aux_d = M.forward(p_dev, on(device), c)
            loss_d = M.loss_fn(p_dev, on(device), c)
            fa = read_launches()["flash_attention"]
            lg_c, aux_c = M.forward(p_cpu, on("cpu"), c)
            loss_c = M.loss_fn(p_cpu, on("cpu"), c)
        row = {"logits_max_abs": float((lg_d.cpu() - lg_c).abs().max()), "aux_abs": abs(float(aux_d) - float(aux_c)),
               "loss_card": float(loss_d), "loss_cpu": float(loss_c), "flash_launches": fa}
        if not (torch.allclose(lg_d.cpu(), lg_c, rtol=1e-4, atol=1e-4) and row["aux_abs"] <= 1e-4
                and abs(row["loss_card"] - row["loss_cpu"]) <= 1e-4 * abs(row["loss_cpu"])):
            raise AssertionError(f"{name}: the card's forward or loss differs from the CPU port's: {row}")
        n_attn = sum(bt_ in ("attn", "moe_attn", "shared_attn") for bt_ in c.unit) * c.n_units
        if fa != 2 * n_attn:  # forward and loss each run every attention block once
            raise AssertionError(f"{name}: flash_attention launched {fa} times, not {2 * n_attn}")
        if name in LM_DECODE_ARCHS:
            if c.moe is not None:  # room in the experts: no drop in either dispatch
                c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=16.0))
            toks_s = torch.from_numpy(bt["tokens"][:, :12]).to(device)
            with torch.inference_mode():
                full, _ = M.forward(p_dev, {"tokens": toks_s}, c)
                row["decode_vs_forward_max_abs"] = float((decode_all(p_dev, c, toks_s, 12, device) - full).abs().max())
            if not row["decode_vs_forward_max_abs"] <= 2e-3:
                raise AssertionError(f"{name}: decode differs from forward on the card: {row}")
        smoke[name] = row
    # tests/test_models.py::test_sliding_window_decode_ring_buffer, the windowed forward on the kernel backend
    c = dataclasses.replace(smoke_config("mixtral-8x7b"), dtype="float32", attn_window=8)
    c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=16.0))
    p_dev = M.init_params(c, SEED, device=device)
    toks_s = torch.from_numpy(lm_smoke_batch(c, 1, 20, SEED)["tokens"]).to(device)
    with torch.inference_mode():
        full, _ = M.forward(p_dev, {"tokens": toks_s}, c)
        ring = float((decode_all(p_dev, c, toks_s, c.attn_window, device) - full).abs().max())
    smoke["mixtral-8x7b ring buffer (window 8, T 20, kernel backend)"] = {"decode_vs_forward_max_abs": ring}
    out["smoke"] = smoke
    log("LM smoke configs on the card: " + json.dumps(smoke))
    if not ring <= 2e-3:
        raise AssertionError(f"the ring-buffer decode differs from the windowed forward: {ring}")

    # (e) the launcher's command line, in process: the weights and prompt of (c)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_toks = decode_lm.main(list(LM_CLI_ARGS))
    cli = {"argv": list(LM_CLI_ARGS), "wall_s": time.perf_counter() - t0, "output": buf.getvalue().strip(),
           "tokens_equal_serving": bool(np.array_equal(cli_toks, served[0]))}
    out["cli"] = cli
    log("LM launcher (repro_torch.launch.decode_lm): " + json.dumps(cli))
    if "generated (4, 48) in" not in cli["output"] or not cli["tokens_equal_serving"]:
        raise AssertionError(f"repro_torch.launch.decode_lm did not serve the tokens of (c): {cli}")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    report["lm"] = out
    return launches, fa_args["args"]


def train_flops(cfg, n_params: int, b: int, t: int) -> float:
    """A training step's model FLOPs: 6 N per token for the weights (the
    tied embedding counted once, as the head's product), and the causal
    attention's two products three times over (forward, and twice that
    backward) at 2 flops a multiply-add: 3 * 4 * hd * T (T + 1) / 2 per
    head and sequence a layer."""
    n_attn = sum(bt in ("attn", "moe_attn", "shared_attn") for bt in cfg.unit) * cfg.n_units
    return 6.0 * n_params * b * t + 12.0 * cfg.head_dim * (t * (t + 1) / 2) * cfg.n_heads * b * n_attn


def tree_rel_check(got, want, rel: float) -> float:
    """The largest |diff| of a leaf over that leaf's largest |value|; fails
    above ``rel``."""
    import torch

    worst = 0.0
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        d = float((a - b).abs().max()) / scale if scale else float((a - b).abs().max())
        worst = max(worst, d)
    if not worst <= rel:
        raise AssertionError(f"gradients differ by {worst} of a leaf's largest |g| (limit {rel})")
    return worst


def _leaf_paths(tree, prefix: str = "") -> list:
    """The leaves' key paths, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaf_paths(v, f"{prefix}/{k}")]
    return [prefix]


def loss_and_grads(params, batch, cfg, backend):
    """``loss_fn`` (remat on) and its gradient leaves, in ``tree_leaves``
    order, a None (an unused leaf) as zeros."""
    import torch
    from repro_torch.models import model as M

    leaves = M.tree_leaves(params)
    req = [a.detach().requires_grad_() for a in leaves]
    it = iter(req)
    loss = M.loss_fn(M.tree_map(lambda _: next(it), params), batch, cfg, remat=True, attn_backend=backend)
    got = torch.autograd.grad(loss, req, allow_unused=True)
    return loss.detach(), [torch.zeros_like(a) if g is None else g for a, g in zip(leaves, got)]


def smoke_grad_reading(smoke, device) -> dict:
    """What lies behind the smoke trainings' parameter bound: for the
    architecture whose card and CPU parameters differ most, its step-0
    gradient of that leaf (the same weights and batch) on the CPU and twice
    on the card, at the element where the parameters differ most and over
    the leaf."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    name = max(smoke, key=lambda n: smoke[n]["param_max_abs_diff"])
    row = smoke[name]
    c = dataclasses.replace(smoke_config(name), dtype="float32")
    p_cpu = M.init_params(c, SEED, device="cpu")
    i = _leaf_paths(p_cpu).index(row["param_worst_leaf"])
    at = row["param_worst_at"]
    p_dev = M.tree_map(lambda a: a.to(device), p_cpu)
    g_c = loss_and_grads(p_cpu, T.synthetic_batch(c, 2, row["seq"], 0, "cpu"), c, "kernel")[1][i].flatten()
    batch = T.synthetic_batch(c, 2, row["seq"], 0, device)
    g_d1 = loss_and_grads(p_dev, batch, c, "kernel")[1][i].flatten().cpu()
    g_d2 = loss_and_grads(p_dev, batch, c, "kernel")[1][i].flatten().cpu()
    scale = float(g_c.abs().max())
    return {"arch": name, "leaf": row["param_worst_leaf"], "at": at, "param_abs_diff": row["param_max_abs_diff"],
            "grad_cpu_at": float(g_c[at]), "grad_card_at": float(g_d1[at]), "grad_card_again_at": float(g_d2[at]),
            "grad_leaf_max_abs": scale, "grad_at_over_leaf_max": abs(float(g_c[at])) / scale if scale else None,
            "grad_card_vs_cpu_leaf_max_abs": float((g_d1 - g_c).abs().max()),
            "grad_card_vs_card_leaf_max_abs": float((g_d1 - g_d2).abs().max()),
            "grad_leaf_elements_below_1e-8": int((g_c.abs() < 1e-8).sum()), "grad_leaf_elements": g_c.numel()}


def phase_train(report, zero_launches, read_launches):
    """Phase 18: the LM's training loop on the card.  (a) qwen2-1.5b at its
    published width, 4 x 4,096 tokens a step, bf16 activations over float32
    weights, remat on, the kernel attention backend: TRAIN_WARM steps, then
    TRAIN_STEPS timed under set_sync_debug_mode("error") with the launch
    counts read after each (exactly 28 backward launches, all on the long
    backward, and 2 x 28 forward launches with the logsumexp: each unit's
    forward runs again in its recompute), then TRAIN_PROFILE_STEPS under
    torch.profiler; at the first step the "torch" backend's loss and
    gradient norm beside the kernel's; (b) float32 at full width over
    TRAIN_F32_T tokens: the kernel backend's gradient against the torch
    backend's; (c) every smoke config trained on the card against the CPU
    port; (d) the launcher in process.  Returns the step's launch counts and
    the arguments of a backward launch of the cell."""
    import contextlib
    import dataclasses
    import io
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS, get_config, smoke_config
    from repro_torch.device import allowed_sync
    from repro_torch.distributed.checkpoint import save_checkpoint
    from repro_torch.distributed.optimizer import AdamWConfig, _global_norm, adamw_init
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    device = torch.device("cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32, as the CPU
    cfg = get_config(LM_ARCH)
    b, t = TRAIN_CELL
    n_attn = sum(bt in ("attn", "moe_attn", "shared_attn") for bt in cfg.unit) * cfg.n_units
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    path = fa_ops.bwd_plan(b, t, t, h, kvh, hd, torch.bfloat16, True)
    if path != "wgmma" or fa_ops.kernel_bwd_plan(b, t, t, h, kvh, hd, torch.bfloat16, True) != path:
        raise AssertionError(f"qwen2's training launch is planned on the {path!r} backward path, not 'wgmma'")
    n_params = M.n_params(cfg)
    out = {"arch": LM_ARCH, "n_params": n_params, "dtype": cfg.dtype, "batch": b, "tokens": t, "remat": True,
           "attn_backend": "kernel", "bwd_plan": path}
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    step_fn = T.make_train_step(cfg, AdamWConfig(lr=1e-3))
    batches = [T.synthetic_batch(cfg, b, t, i, device) for i in range(TRAIN_WARM + TRAIN_STEPS + TRAIN_PROFILE_STEPS)]

    # (a) the cell: the torch backend's loss and gradient norm at the first step's weights
    loss_t, g_t = loss_and_grads(params, batches[0], cfg, "torch")
    gn_t = _global_norm(g_t)
    del g_t
    torch.cuda.empty_cache()
    bwd_fn = fa_ops.flash_attention_bwd
    bwd_args = {}

    def capture_bwd(q, k, v, o, do, lse, causal=True, window=None):
        bwd_args.setdefault("args", (q, k, v, o, do, lse, causal))
        return bwd_fn(q, k, v, o, do, lse, causal=causal, window=window)

    losses, norms, walls = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARM):
        fa_ops.flash_attention_bwd = capture_bwd if i == 1 else bwd_fn
        try:
            zero_launches()
            params, opt, loss, gn = step_fn(params, opt, batches[i])
            warm_launches = read_launches()
        finally:
            fa_ops.flash_attention_bwd = bwd_fn
        losses.append(loss)
        norms.append(gn)
    torch.cuda.synchronize()
    per_step = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for i in range(TRAIN_WARM, TRAIN_WARM + TRAIN_STEPS):
            zero_launches()
            params, opt, loss, gn = step_fn(params, opt, batches[i])
            per_step.append(read_launches())
            losses.append(loss)
            norms.append(gn)
        with allowed_sync():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    peak = torch.cuda.max_memory_allocated()

    def steps():
        nonlocal params, opt
        for i in range(TRAIN_WARM + TRAIN_STEPS, len(batches)):
            params, opt, loss, gn = step_fn(params, opt, batches[i])
            losses.append(loss)
            norms.append(gn)

    prof = device_profile(steps)
    losses_h = [float(x) for x in losses]
    norms_h = [float(x) for x in norms]
    step_s = wall / TRAIN_STEPS
    flops = train_flops(cfg, n_params, b, t)
    want = {"flash_attention": 2 * n_attn, "flash_attention_lse": 2 * n_attn, "flash_attention_bwd": n_attn,
            "flash_attention_bwd_long": n_attn}
    cell = {"warm_steps": TRAIN_WARM, "timed_steps": TRAIN_STEPS, "wall_s": wall, "s_per_step": step_s,
            "steps_per_s": 1.0 / step_s, "tokens_per_s": b * t / step_s, "peak_mem_bytes": int(peak),
            "model_flops_per_step": flops, "bf16_peak_share": flops / step_s / PEAK_BF16_FLOPS,
            "losses": losses_h, "grad_norms": norms_h, "launches_per_step": per_step, "launches_warm": warm_launches,
            "expected_launches_per_step": want, "sync_debug": "error",
            "torch_backend_first_step": {"loss": float(loss_t), "grad_norm": float(gn_t),
                                         "loss_rel_diff": abs(float(loss_t) - losses_h[0]) / abs(float(loss_t)),
                                         "grad_norm_rel_diff": abs(float(gn_t) - norms_h[0]) / float(gn_t)}}
    if prof.get("profiled"):
        cell["profile"] = prof
        cell["attn_bwd_device_ms_per_step"] = prof["flash_attention_bwd_kernel_s"] / TRAIN_PROFILE_STEPS * 1e3
        cell["attn_bwd_device_ms_per_step_by_kernel"] = {
            k_: s_ / TRAIN_PROFILE_STEPS * 1e3 for k_, s_ in prof["flash_attention_bwd_kernels_s"].items()}
        cell["device_busy_share"] = prof["device_busy_share"]
    else:
        cell["profile"] = prof
        cell["attn_bwd_device_ms_per_step"] = None  # not measured
    out["cell"] = cell
    log("LM training cell: " + json.dumps({k_: v for k_, v in cell.items() if k_ != "profile"}))
    log("LM training profile: " + json.dumps(prof))
    if not (np.isfinite(losses_h).all() and np.isfinite(norms_h).all()):
        raise AssertionError(f"a step's loss or gradient norm is not finite: {losses_h}, {norms_h}")
    for i, got in enumerate(per_step):
        if any(got[k_] != v for k_, v in want.items()):
            raise AssertionError(f"timed step {i} launched {got}, not {want}")
    ft = cell["torch_backend_first_step"]
    if not (ft["loss_rel_diff"] <= 1e-2 and ft["grad_norm_rel_diff"] <= 2e-2):
        raise AssertionError(f"the backends' first step differs: {ft}")
    del opt, batches, losses, norms
    torch.cuda.empty_cache()

    # (b) float32 at full width: the kernel backend's gradient against the torch backend's
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    one = T.synthetic_batch(cfg32, 1, TRAIN_F32_T, 0, device)
    loss_k, g_k = loss_and_grads(params, one, cfg32, "kernel")
    loss_t, g_t = loss_and_grads(params, one, cfg32, "torch")
    worst = tree_rel_check(g_k, g_t, 1e-3)
    f32 = {"tokens": TRAIN_F32_T, "bwd_plan": fa_ops.bwd_plan(1, TRAIN_F32_T, TRAIN_F32_T, h, kvh, hd, torch.float32,
                                                               True),
           "loss_kernel": float(loss_k), "loss_torch": float(loss_t), "grad_max_rel_diff": worst}
    out["float32"] = f32
    log("LM training float32 check: " + json.dumps(f32))
    del params, g_k, g_t
    torch.cuda.empty_cache()

    # (c) every smoke config: train_loop on the card against the CPU port, from one step-0 checkpoint
    smoke, bad = {}, []
    root = ROOT / "build" / "train_smoke"
    for name in sorted(ARCHS):
        c = dataclasses.replace(smoke_config(name), dtype="float32")
        seq = TRAIN_SMOKE_SEQ
        p_cpu = M.init_params(c, SEED, device="cpu")
        as_np = lambda tree: M.tree_map(lambda a: a.numpy(), tree)
        shutil.rmtree(root, ignore_errors=True)
        save_checkpoint(str(root / "card"), 0, (as_np(p_cpu), as_np(adamw_init(p_cpu))))
        shutil.copytree(root / "card", root / "cpu")
        zero_launches()
        t0 = time.perf_counter()
        pd, ld = T.train_loop(c, TRAIN_SMOKE_STEPS, 2, seq, ckpt_dir=str(root / "card"), verbose=False)
        card_s = time.perf_counter() - t0
        launched = read_launches()
        pc, lc = T.train_loop(c, TRAIN_SMOKE_STEPS, 2, seq, ckpt_dir=str(root / "cpu"), verbose=False, device="cpu")
        names = _leaf_paths(pd)  # both trees come back from adamw_update with their keys sorted
        dabs = [(a.cpu() - z).abs() for a, z in zip(M.tree_leaves(pd), M.tree_leaves(pc))]
        diffs = [float(d.max()) for d in dabs]
        worst = max(range(len(diffs)), key=diffs.__getitem__)
        at = int(dabs[worst].argmax())
        del dabs
        lrel = max(abs(x - y) / abs(y) for x, y in zip(ld, lc))
        na = sum(bt in ("attn", "moe_attn", "shared_attn") for bt in c.unit) * c.n_units
        row = {"seq": seq, "losses_card": ld, "losses_cpu": lc, "loss_max_rel_diff": lrel,
               "param_max_abs_diff": diffs[worst], "param_worst_leaf": names[worst], "param_worst_at": at,
               "card_s": card_s,
               "flash_attention_bwd": launched["flash_attention_bwd"], "expected_bwd": TRAIN_SMOKE_STEPS * na}
        smoke[name] = row
        if not (lrel <= TRAIN_SMOKE_LOSS_RTOL and diffs[worst] <= TRAIN_SMOKE_PARAM_ATOL):
            bad.append(f"{name}: the card's training differs from the CPU port's")
        if launched["flash_attention_bwd"] != TRAIN_SMOKE_STEPS * na:
            bad.append(f"{name}: flash_attention_bwd launched {launched['flash_attention_bwd']} times")
    shutil.rmtree(root, ignore_errors=True)
    out["smoke"] = smoke
    log("LM training, smoke configs on the card against the CPU port: " + json.dumps(smoke))
    out["smoke_grad_reading"] = smoke_grad_reading(smoke, device)
    log("LM training, the step-0 gradient where the smoke parameters differ most: "
        + json.dumps(out["smoke_grad_reading"]))
    if bad:
        raise AssertionError("; ".join(bad))

    # (d) the launcher's command line, in process
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_losses = T.main(list(TRAIN_CLI_ARGS))
    cli = {"argv": list(TRAIN_CLI_ARGS), "wall_s": time.perf_counter() - t0, "output": buf.getvalue().strip()[-400:],
           "losses": cli_losses}
    out["cli"] = cli
    log("LM training launcher (repro_torch.launch.train): " + json.dumps(cli))
    if "final loss:" not in buf.getvalue() or not np.isfinite(cli_losses).all():
        raise AssertionError(f"repro_torch.launch.train did not train: {cli}")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    report["train"] = out
    return per_step[0], bwd_args["args"]


def phase_mesh(report, zero_launches, read_launches):
    """Phase 19: the LM's mesh on the card.  NCCL at world size 1 (a
    FileStore under build/), ``make_local_mesh(1, 1)`` on cuda, qwen2-1.5b
    at its published width (float32 weights, bf16 activations, remat, the
    kernel attention backend) over 1 x 4,096 tokens a step: MESH_STEPS
    plain steps (``make_train_step``) and one more under torch.profiler,
    then, from the same init and
    batches, MESH_STEPS steps of ``make_sharded_train_step`` on DTensors
    placed by the reference's rules, each under
    set_sync_debug_mode("error") with the launch counts zeroed before and
    read after (exactly 28 long-backward launches and 56 forward launches
    with the logsumexp a step, all on the wgmma path: each rank's heads
    reach the kernels through ``local_map``).  Losses within
    MESH_LOSS_ATOL and parameters within MESH_PARAM_ATOL of the plain
    steps', placements kept; then one more sharded step under the
    profiler.  s/step is the last timed step's wall (the first warms up).
    Returns a sharded step's launch counts."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.device import allowed_sync
    from repro_torch.distributed.optimizer import AdamWConfig, _leaves, adamw_init
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    b, t = MESH_CELL
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_attn = sum(bt in ("attn", "moe_attn", "shared_attn") for bt in cfg.unit) * cfg.n_units
    plans = {"fwd": (fa_ops.plan(b, t, t, h, kvh, hd, torch.bfloat16, True),
                     fa_ops.kernel_plan(b, t, t, h, kvh, hd, torch.bfloat16, True)),
             "bwd": (fa_ops.bwd_plan(b, t, t, h, kvh, hd, torch.bfloat16, True),
                     fa_ops.kernel_bwd_plan(b, t, t, h, kvh, hd, torch.bfloat16, True))}
    if any(v != ("wgmma", "wgmma") for v in plans.values()):
        raise AssertionError(f"the mesh cell's attention is not planned on the wgmma paths: {plans}")
    ocfg = AdamWConfig(lr=1e-3)
    batches = [T.synthetic_batch(cfg, b, t, i, device) for i in range(MESH_STEPS)]
    init = lambda: M.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    out = {"arch": LM_ARCH, "batch": b, "tokens": t, "mesh": [1, 1], "backend": "nccl", "steps": MESH_STEPS,
           "plans": plans}

    # the plain steps; their parameters go to the host, so one state is on the card at a time
    params = init()
    opt = adamw_init(params)
    step = T.make_train_step(cfg, ocfg)
    plain = {"losses": [], "grad_norms": [], "walls_s": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(MESH_STEPS):
        t0 = time.perf_counter()
        params, opt, loss, gn = step(params, opt, batches[i])
        torch.cuda.synchronize()
        plain["walls_s"].append(time.perf_counter() - t0)
        plain["losses"].append(float(loss))
        plain["grad_norms"].append(float(gn))
    plain["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    # one more step under torch.profiler (its results dropped): the device's busy share
    plain["profile"] = device_profile(lambda: step(params, opt, batches[-1]))
    want = [a.detach().cpu() for a in _leaves(params)]
    del params, opt, step
    torch.cuda.empty_cache()

    store = ROOT / "build" / "mesh_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_local_mesh(1, 1)
        params = init()
        ps, os_ = T.place_state(mesh, params, adamw_init(params))
        del params
        p_in = [a.placements for a in _leaves(ps)]
        o_in = [a.placements for a in _leaves(os_["m"]) + _leaves(os_["v"])]
        sstep = T.make_sharded_train_step(cfg, ocfg, mesh)
        sharded = {"losses": [], "grad_norms": [], "walls_s": [], "launches": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(MESH_STEPS):
            bs = T.place_batch(mesh, batches[i])
            torch.cuda.synchronize()
            zero_launches()
            torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.perf_counter()
                ps, os_, loss, gn = sstep(ps, os_, bs)
                sharded["launches"].append(read_launches())
                with allowed_sync():
                    torch.cuda.synchronize()
                sharded["walls_s"].append(time.perf_counter() - t0)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sharded["losses"].append(float(loss))
            sharded["grad_norms"].append(float(gn))
        sharded["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
        sharded["profile"] = device_profile(lambda: sstep(ps, os_, bs))
        kept = ([a.placements for a in _leaves(ps)] == p_in
                and [a.placements for a in _leaves(os_["m"]) + _leaves(os_["v"])] == o_in)
        diffs = [float((a.full_tensor() - w.to(device)).abs().max()) for a, w in zip(_leaves(ps), want)]
        del ps, os_, want
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = tf32
    loss_diff = max(abs(x - y) for x, y in zip(plain["losses"], sharded["losses"]))
    out.update({"plain": plain, "sharded": sharded, "placements_kept": kept, "loss_max_abs_diff": loss_diff,
                "param_max_abs_diff": max(diffs), "sync_debug": "error",
                "s_per_step_plain": plain["walls_s"][-1], "s_per_step_sharded": sharded["walls_s"][-1],
                "peak_mem_bytes_plain": plain["peak_mem_bytes"], "peak_mem_bytes_sharded": sharded["peak_mem_bytes"],
                "busy_share_plain": plain["profile"].get("device_busy_share"),
                "busy_share_sharded": sharded["profile"].get("device_busy_share"),
                "phase_s": time.perf_counter() - t_phase})
    report["mesh"] = out
    log("LM mesh step (1, 1): " + json.dumps({k_: v for k_, v in out.items() if k_ not in ("plain", "sharded")}))
    log("LM mesh step, plain / sharded: " + json.dumps({"plain": plain, "sharded": sharded}))
    wanted = {"flash_attention": 2 * n_attn, "flash_attention_lse": 2 * n_attn, "flash_attention_bwd": n_attn,
              "flash_attention_bwd_long": n_attn}
    for i, got in enumerate(sharded["launches"]):
        if any(got[k_] != v for k_, v in wanted.items()):
            raise AssertionError(f"sharded step {i} launched {got}, not {wanted}")
    if not kept:
        raise AssertionError("the sharded step changed a leaf's placements")
    if not (loss_diff <= MESH_LOSS_ATOL and max(diffs) <= MESH_PARAM_ATOL):
        raise AssertionError(f"the sharded step differs from the plain step: loss {loss_diff}, params {max(diffs)}")
    return sharded["launches"][0]


def fa_window_row(q, k, v, window, reps) -> dict:
    """flash_attention at a long windowed launch (the LM prefills of phase
    20, 32,768 tokens) against its plain version on the same inputs, one
    query head at a time (the plain version's score matrix of one head is
    4.3 GB in float32; all 32 at once would not fit): each output row's max
    |diff| within FA_TOL of the row's largest |value| (bf16), and the max
    |diff|.  Times: the kernel by CUDA events (``ms``) and under
    torch.profiler (``kernel_ms``), the plain version summed over the heads
    (``plain_ms``), one ``F.scaled_dot_product_attention`` with the
    window's boolean mask over the repeated kv heads (``library_ms``; the
    memory-efficient backend, null with the reason when the library
    refuses), and the bound over the visible pairs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops

    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    path = fa_ops.plan(b, t, s, h, kvh, hd, q.dtype, True)
    if fa_ops.kernel_plan(b, t, s, h, kvh, hd, q.dtype, True) != path:
        raise AssertionError(f"ops.plan and the .cu entry choose different paths at {tuple(q.shape)}")
    tiles = (fa_ops.fwd_tiles(t, s, True, window), fa_ops.kernel_fwd_tiles(t, s, True, window))
    if tiles[0] != tiles[1]:
        raise AssertionError(f"the .cu's forward tiles differ from ops.fwd_tiles at T {t}, window {window}")
    got = fa_ops.flash_attention(q, k, v, window=window)
    err, row_rel, plain_ms = 0.0, 0.0, 0.0
    for hh in range(h):
        one = lambda x, i: x[:, :, i:i + 1].contiguous()
        qh, kh, vh = one(q, hh), one(k, hh // g), one(v, hh // g)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = fa_plain(qh, kh, vh, True, window).float()
        stop.record()
        diff = (got[:, :, hh:hh + 1].float() - ref).abs().amax(-1)
        scale = ref.abs().amax(-1)
        err = max(err, float(diff.max()))
        row_rel = max(row_rel, float((diff / scale.clamp_min(torch.finfo(torch.float32).tiny)).max()))
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(stop)
        del ref, diff, scale
    del got
    torch.cuda.empty_cache()
    if not (err <= FA_TOL[dtype] and row_rel <= FA_TOL[dtype]):
        raise AssertionError(f"flash_attention differs from its plain version at {tuple(q.shape)}, window "
                             f"{window}: max |diff| {err}, per row {row_rel}")
    run = lambda: fa_ops.flash_attention(q, k, v, window=window)
    kernel_ms, seen = kernel_device_ms(run, reps)
    bound, by = fa_bound_ms(b, t, s, h, kvh, hd, True, dtype, window)
    row = {"B": b, "T": t, "S": s, "H": h, "K": kvh, "hd": hd, "causal": True, "window": window, "dtype": dtype,
           "plan": path, "key_tiles_per_block_max": max(e - f for f, e in tiles[0]),
           "visible_pairs": visible_pairs(t, s, True, window) * b * h, "max_abs_err": err,
           "max_row_rel_err": row_rel, "ms": cuda_ms(run, reps), "kernel_ms": kernel_ms,
           "kernel_launches_profiled": seen, "plain_ms": plain_ms, "plain": "the plain version one head at a time",
           "bound_ms": bound, "bound_by": by}
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = q.transpose(1, 2), k.repeat_interleave(g, 2).transpose(1, 2), v.repeat_interleave(g, 2).transpose(1, 2)
    mask = window_mask(t, s, window, q.device)
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps)
        row["library"] = "F.scaled_dot_product_attention, memory-efficient backend, the window's boolean mask"
    except RuntimeError as e:  # the library refuses the shape: not measured
        row["library_ms"] = None
        row["library"] = f"not measured: {type(e).__name__}: {str(e)[:200]}"
    del qt, kt, vt, mask
    torch.cuda.empty_cache()
    return row


def lm_prefill_window(name: str, cfg, zero_launches, read_launches) -> tuple:
    """One windowed prefill of phase 20 at full width: ``cfg``'s float32
    weights drawn on the card with the data seed, 1 x WIN_PREFILL_T tokens
    in bf16 through the kernel backend under set_sync_debug_mode("error"),
    its counts zeroed before and read after (one flash_attention launch an
    attention block, all on the wgmma path with the window); finite
    logits; the bf16 kernel logits' mean |diff| from the float32 "torch"
    forward within LM_BF16_ERR_RATIO of the bf16 "torch" backend's; the
    device's busy share over one more forward under torch.profiler.
    Returns the record and the first launch's arguments."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.device import allowed_sync, h2d
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M

    t_part = time.perf_counter()
    device = torch.device("cuda")
    t = WIN_PREFILL_T
    h, kvh, hd, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.attn_window
    n_attn = sum(bt in ("attn", "moe_attn", "shared_attn") for bt in cfg.unit) * cfg.n_units
    plans = (fa_ops.plan(1, t, t, h, kvh, hd, torch.bfloat16, True, window),
             fa_ops.kernel_plan(1, t, t, h, kvh, hd, torch.bfloat16, True))
    if plans != ("wgmma", "wgmma"):
        raise AssertionError(f"{name}'s prefill launch is planned on {plans}, not the wgmma path")
    out = {"arch": name, "n_layers": cfg.n_layers, "n_params": M.n_params(cfg), "batch": 1, "tokens": t,
           "heads": [h, kvh, hd], "window": window, "plan": plans[0], "expected_flash_launches": n_attn}
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    toks = h2d(np.random.default_rng(SEED).integers(0, cfg.vocab, (1, t)).astype(np.int32), device)
    batch = {"tokens": toks}
    fa_fn = fa_ops.flash_attention
    fa_args = {}

    def capture_fa(q, k, v, **kw):
        fa_args.setdefault("args", (q, k, v, kw.get("window")))
        return fa_fn(q, k, v, **kw)

    with torch.inference_mode():
        M.forward(params, {"tokens": toks[:, :WIN_WARM_T]}, cfg)  # warm up: cuBLAS, the kernel's first launch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.flash_attention = capture_fa
        zero_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            logits, _ = M.forward(params, batch, cfg)
            with allowed_sync():
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            fa_ops.flash_attention = fa_fn
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
        prof = device_profile(lambda: M.forward(params, batch, cfg))
        # the bf16 backends against the float32 forward on the torch backend
        l32, _ = M.forward(params, batch, dataclasses.replace(cfg, dtype="float32"), attn_backend="torch")
        err_k = float((logits.float() - l32).abs().mean())
        del logits
        lt, _ = M.forward(params, batch, cfg, attn_backend="torch")
        err_t = float((lt.float() - l32).abs().mean())
        scale32 = float(l32.abs().mean())
        del lt, l32
    del params
    torch.cuda.empty_cache()
    out.update({"wall_s": wall, "tokens_per_s": t / wall, "peak_mem_bytes": int(peak), "launches": launches,
                "sync_debug": "error", "logits_shape": shape, "logits_finite": finite,
                "logits32_mean_abs": scale32, "kernel_vs_float32_mean_abs": err_k,
                "torch_vs_float32_mean_abs": err_t, "profile": prof,
                "device_busy_share": prof.get("device_busy_share"), "part_s": time.perf_counter() - t_part})
    log(f"windowed LM prefill, {name}: " + json.dumps(out))
    if launches["flash_attention"] != n_attn or launches["flash_attention_lse"] != 0:
        raise AssertionError(f"{name}'s prefill launched flash_attention {launches['flash_attention']} times, "
                             f"not {n_attn}")
    if fa_args["args"][3] != window:
        raise AssertionError(f"{name}'s prefill passed the window {fa_args['args'][3]}, not {window}")
    if not finite or shape != (1, t, cfg.vocab):
        raise AssertionError(f"{name}'s prefill logits of shape {shape} are not all finite")
    if not err_k <= LM_BF16_ERR_RATIO * err_t:
        raise AssertionError(f"{name}: the kernel backend's bf16 logits are further from float32 than "
                             f"{LM_BF16_ERR_RATIO} x the torch backend's: {err_k} against {err_t}")
    return out, fa_args["args"]


def phase_windowed_lm(report, zero_launches, read_launches):
    """Phase 20: the sliding window and head size 80 at full width.  (a)
    zamba2-2.7b at its published width and depth (54 layers: 9 units of 5
    Mamba2 layers and the shared attention block, 32 heads of 80, window
    4,096) prefilling 1 x WIN_PREFILL_T tokens, 9 windowed flash_attention
    launches at hd 80; (b) mixtral-8x7b at full width (d_model 4,096, 32/8
    heads of 128, 8 experts of 14,336, window 4,096) with its depth cut to
    WIN_MIXTRAL_LAYERS, 2 windowed launches; each as
    ``lm_prefill_window`` checks it; (c) one zamba2-2.7b training step at
    full width over WIN_TRAIN tokens with the depth cut to WIN_TRAIN_UNITS
    units, under set_sync_debug_mode("error") after a warm-up step: 2 x
    n_attn forward launches with the logsumexp and n_attn long-backward
    launches on the wgmma route at hd 80, finite loss and gradient norm,
    the "torch" backend's loss within 1e-2 relative and gradient norm
    within 2 % at the same weights.  Returns the launch counts and the
    first prefill launches' arguments."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.device import allowed_sync
    from repro_torch.distributed.optimizer import AdamWConfig, _global_norm, adamw_init
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    device = torch.device("cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    out = {}
    zamba = get_config("zamba2-2.7b")
    out["zamba2_prefill"], zamba_args = lm_prefill_window("zamba2-2.7b", zamba, zero_launches, read_launches)
    mixtral = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=WIN_MIXTRAL_LAYERS)
    out["mixtral_prefill"], mixtral_args = lm_prefill_window("mixtral-8x7b", mixtral, zero_launches, read_launches)

    # (c) a zamba2 training step at full width, the depth cut to WIN_TRAIN_UNITS units
    t_part = time.perf_counter()
    cfg = dataclasses.replace(zamba, n_layers=WIN_TRAIN_UNITS * len(zamba.unit))
    b, t = WIN_TRAIN
    h, kvh, hd, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.attn_window
    n_attn = sum(bt in ("attn", "moe_attn", "shared_attn") for bt in cfg.unit) * cfg.n_units
    plans = (fa_ops.bwd_plan(b, t, t, h, kvh, hd, torch.bfloat16, True, window),
             fa_ops.kernel_bwd_plan(b, t, t, h, kvh, hd, torch.bfloat16, True))
    if plans != ("wgmma", "wgmma"):
        raise AssertionError(f"zamba2's training launch is planned on {plans}, not the wgmma backward route")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    batches = [T.synthetic_batch(cfg, b, t, i, device) for i in range(2)]
    loss_t, g_t = loss_and_grads(params, batches[0], cfg, "torch")
    gn_t = float(_global_norm(g_t))
    del g_t
    torch.cuda.empty_cache()
    opt = adamw_init(params)
    step_fn = T.make_train_step(cfg, AdamWConfig(lr=1e-3))
    torch.cuda.reset_peak_memory_stats()
    # the first step (it warms up) is held to the torch backend at the same
    # weights; the second runs under sync-debug "error" with its counts read
    params, opt, loss0, gn0 = step_fn(params, opt, batches[0])
    loss0, gn0 = float(loss0), float(gn0)
    zero_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        params, opt, loss, gn = step_fn(params, opt, batches[1])
        launches = read_launches()
        with allowed_sync():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    peak = torch.cuda.max_memory_allocated()
    loss, gn = float(loss), float(gn)
    del params, opt
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    want = {"flash_attention": 2 * n_attn, "flash_attention_lse": 2 * n_attn, "flash_attention_bwd": n_attn,
            "flash_attention_bwd_long": n_attn}
    train = {"arch": "zamba2-2.7b", "units": WIN_TRAIN_UNITS, "n_layers": cfg.n_layers, "n_params": M.n_params(cfg),
             "batch": b, "tokens": t, "window": window, "bwd_plan": plans[0], "remat": True, "attn_backend": "kernel",
             "s_per_step": wall, "tokens_per_s": b * t / wall, "peak_mem_bytes": int(peak),
             "losses": [loss0, loss], "grad_norms": [gn0, gn], "launches": launches, "expected_launches": want,
             "sync_debug": "error",
             "torch_backend_first_step": {"loss": float(loss_t), "grad_norm": gn_t,
                                          "loss_rel_diff": abs(float(loss_t) - loss0) / abs(float(loss_t)),
                                          "grad_norm_rel_diff": abs(gn_t - gn0) / gn_t},
             "part_s": time.perf_counter() - t_part}
    out["zamba2_train"] = train
    log("windowed LM training step, zamba2-2.7b: " + json.dumps(train))
    if any(launches[k_] != v for k_, v in want.items()):
        raise AssertionError(f"zamba2's training step launched {launches}, not {want}")
    if not np.isfinite([loss0, gn0, loss, gn]).all():
        raise AssertionError(f"zamba2's training steps' losses {train['losses']} or norms {train['grad_norms']} "
                             f"are not finite")
    tb = train["torch_backend_first_step"]
    if not (tb["loss_rel_diff"] <= 1e-2 and tb["grad_norm_rel_diff"] <= 2e-2):
        raise AssertionError(f"zamba2's step differs between the backends: {tb}")
    report["windowed_lm"] = out
    return out, zamba_args, mixtral_args


def frames_serve(cfg, params, nreq: int, cache_len: int, plen: int, ngen: int, calls: int, device):
    """The audio stub's serving, which ``decode_lm.generate`` cannot do (it
    takes tokens; both packages' command lines refuse the stub):
    ``decode_lm.make_serve_step`` over ``plen + ngen`` precomputed frame
    embeddings drawn with the data seed, ``calls`` times from a fresh
    ``cache_len``-slot cache, each step's argmax codes (B, n_codebooks)
    fetched to the host from the prompt's last step on, as ``generate``
    fetches its tokens.  Returns the cell and the calls' codes."""
    import numpy as np
    import torch
    from repro_torch.device import h2d, to_host
    from repro_torch.launch import decode_lm
    from repro_torch.models import model as M

    frames = h2d(np.random.default_rng(SEED).normal(size=(nreq, plen + ngen, cfg.d_model)).astype(np.float32), device)
    step = decode_lm.make_serve_step(cfg)
    served, walls = [], []
    with torch.inference_mode():
        for _ in range(calls):
            t0 = time.perf_counter()
            cache = M.cache_init(cfg, nreq, cache_len, device=device)
            codes = []
            for i in range(plen + ngen):
                tok, cache = step(params, cache, {"embeds": frames[:, i : i + 1]})
                if i >= plen - 1:
                    codes.append(to_host(tok))
            walls.append(time.perf_counter() - t0)
            served.append(np.stack(codes, axis=1))
            del cache
    cell = {"requests": nreq, "prompt_frames": plen, "new_frames": ngen, "cache_len": cache_len,
            "entry": "decode_lm.make_serve_step over {'embeds': ...}", "walls_s": walls,
            "frames_per_s": nreq * ngen / min(walls), "ms_per_step": 1e3 * min(walls) / (plen + ngen),
            "identical": all(np.array_equal(served[0], x) for x in served), "codes_shape": list(served[0].shape),
            "first_codes": served[0][0, :4].tolist()}
    return cell, served


def lm_wide(name: str, zero_launches, read_launches) -> dict:
    """One architecture of phase 21 at its published width, its depth cut
    to WIDE_LAYERS where one card forces it (the cut and its reason in the
    record): (a) float32 weights drawn on the card with the data seed, a
    warm-up forward over WIDE_WARM_T tokens a sequence, then LM_PREFILL in
    bf16 through the kernel backend under set_sync_debug_mode("error"),
    its counts zeroed before and read after: one flash_attention launch
    an attention block, each planned "wgmma" by ``ops.plan`` and the .cu;
    finite logits of (B, T, V), or (B, T, n_codebooks, V); the wall,
    tokens/s, peak memory and the device's busy share over one more
    forward under torch.profiler; the sLSTM blocks' share of the wall
    (CUDA events around each, no sync); at 1 x LM_F32_T the kernel's
    bf16 logits' mean |diff| from the float32 "torch" forward within
    LM_BF16_ERR_RATIO of the bf16 "torch" backend's; (c) float32
    decode against the forward at LM_DECODE within 2e-3 (MoE at capacity
    16, where nothing drops), then serving WIDE_SERVE twice with identical
    tokens (``lm_serve``; the audio stub through ``frames_serve``), the
    peak memory; (d) the weights freed; (b) the prefill's first
    flash_attention launch against the plain version on its own inputs,
    each output row within WIDE_ROW_TOL of its scale, timed by ``fa_row``
    beside its bound and SDPA.  Returns the record."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.device import allowed_sync, h2d
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M

    t_part = time.perf_counter()
    device = torch.device("cuda")
    published = get_config(name)
    cfg = dataclasses.replace(published, n_layers=WIDE_LAYERS[name]) if name in WIDE_LAYERS else published
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dec32 = cfg32  # decode against forward: with room in the experts, nothing drops in either
    if cfg.moe is not None:
        dec32 = dataclasses.replace(cfg32, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    b, t = LM_PREFILL
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_attn = sum(bt in B.ATTN_TYPES for bt in cfg.unit) * cfg.n_units
    out = {"arch": name, "n_layers": cfg.n_layers, "published_layers": published.n_layers,
           "n_params": M.n_params(cfg), "batch": b, "tokens": t, "heads": [h, kvh, hd],
           "expected_flash_launches": n_attn}
    if name in WIDE_LAYERS:
        out["cut"] = (f"{published.n_layers} -> {cfg.n_layers} layers: the most whose float32 weights stay under "
                      f"40 GB (all {published.n_layers}: {4 * M.n_params(published) / 1e9:.1f} GB)")
    if n_attn:
        plans = (fa_ops.plan(b, t, t, h, kvh, hd, torch.bfloat16, True),
                 fa_ops.kernel_plan(b, t, t, h, kvh, hd, torch.bfloat16, True))
        if plans != ("wgmma", "wgmma"):
            raise AssertionError(f"{name}'s prefill launch is planned on {plans}, not the wgmma path")
        out["plan"] = plans[0]
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["weights_bytes"] = sum(a.numel() * a.element_size() for a in M.tree_leaves(params))
    rng = np.random.default_rng(SEED)
    key = "embeds" if cfg.precomputed_embeddings else "tokens"
    if cfg.precomputed_embeddings:  # the EnCodec frontend is a stub: frame embeddings come in
        x = h2d(rng.normal(size=(b, t, cfg.d_model)).astype(np.float32), device)
    else:
        x = h2d(rng.integers(0, cfg.vocab, (b, t)).astype(np.int32), device)
    want_shape = (b, t, cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks else (b, t, cfg.vocab)
    fa_fn = fa_ops.flash_attention
    fa_args = {}

    def capture_fa(q, k, v, **kw):
        fa_args.setdefault("args", (q, k, v, kw.get("causal", True)))
        return fa_fn(q, k, v, **kw)

    slstm = B._MIXERS["slstm"]
    spans = []

    def timed_slstm(p, xx, c):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = slstm[0](p, xx, c)
        stop.record()
        spans.append((start, stop))
        return y

    with torch.inference_mode():
        M.forward(params, {key: x[:, :WIDE_WARM_T]}, cfg)  # warm up: cuBLAS at these widths
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.flash_attention = capture_fa
        B._MIXERS["slstm"] = (timed_slstm, slstm[1])
        zero_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            logits, _ = M.forward(params, {key: x}, cfg)
            with allowed_sync():
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            fa_ops.flash_attention = fa_fn
            B._MIXERS["slstm"] = slstm
        peak = torch.cuda.max_memory_allocated()
        shape = tuple(logits.shape)
        finite = bool(torch.isfinite(logits).all())
        del logits
        slstm_s = sum(a.elapsed_time(z) for a, z in spans) / 1e3
        prof = device_profile(lambda: M.forward(params, {key: x}, cfg))
        # the bf16 backends against the float32 forward on the torch backend
        one = {key: x[:1, :LM_F32_T]}
        l32, _ = M.forward(params, one, cfg32, attn_backend="torch")
        lk, _ = M.forward(params, one, cfg)
        err_k = float((lk.float() - l32).abs().mean())
        del lk
        lt, _ = M.forward(params, one, cfg, attn_backend="torch")
        err_t = float((lt.float() - l32).abs().mean())
        scale32 = float(l32.abs().mean())
        del lt, l32
        # float32 decode against the forward
        db, dtn = LM_DECODE
        xs = x[:db, :dtn]
        full, _ = M.forward(params, {key: xs}, dec32)
        dec = decode_all(params, dec32, xs, dtn, device)
        dec_diff = float((dec - full).abs().max())
        dec_ok = bool(torch.allclose(dec, full, rtol=2e-3, atol=2e-3))
        del full, dec
    torch.cuda.empty_cache()
    nreq, slots, plen, ngen = WIDE_SERVE
    torch.cuda.reset_peak_memory_stats()
    if cfg.precomputed_embeddings:
        serve, served = frames_serve(cfg, params, nreq, slots, plen, ngen, 2, device)
        serve_shape = (nreq, ngen + 1, cfg.n_codebooks)
    else:
        serve, served = lm_serve(cfg, params, nreq, slots, 2, device, plen=plen, ngen=ngen, profile=False)
        serve_shape = (nreq, plen + ngen)
    serve["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    del params, x
    torch.cuda.empty_cache()
    out.update({"wall_s": wall, "tokens_per_s": b * t / wall, "peak_mem_bytes": int(peak), "launches": launches,
                "sync_debug": "error", "logits_shape": shape, "logits_finite": finite,
                "slstm_s": slstm_s, "slstm_share_of_wall": slstm_s / wall, "slstm_blocks": len(spans),
                "logits32_mean_abs": scale32, "kernel_vs_float32_mean_abs": err_k, "torch_vs_float32_mean_abs": err_t,
                "bf16_err_ratio": err_k / err_t if err_t else None, "profile": prof,
                "device_busy_share": prof.get("device_busy_share"),
                "decode_shape": list(LM_DECODE), "decode_vs_forward_max_abs": dec_diff, "serve": serve})
    row = None
    if "args" in fa_args:
        q, k, v, causal = fa_args.pop("args")
        if (tuple(q.shape), tuple(k.shape)) != ((b, t, h, hd), (b, t, kvh, hd)):
            raise AssertionError(f"{name}'s first launch took q {tuple(q.shape)} and k {tuple(k.shape)}")
        row = fa_row(q, k, v, causal, WIDE_FA_REPS)
        del q, k, v
        torch.cuda.empty_cache()
        out["fa_launch"] = row
    out["part_s"] = time.perf_counter() - t_part
    log(f"full-width LM, {name}: " + json.dumps(out))
    if launches["flash_attention"] != n_attn or launches["flash_attention_lse"] != 0:
        raise AssertionError(f"{name}'s prefill launched flash_attention {launches['flash_attention']} times, "
                             f"not {n_attn}")
    if not finite or shape != want_shape:
        raise AssertionError(f"{name}'s prefill logits of shape {shape} (want {want_shape}) are not all finite")
    if not err_k <= LM_BF16_ERR_RATIO * err_t:
        raise AssertionError(f"{name}: the kernel backend's bf16 logits are further from float32 than "
                             f"{LM_BF16_ERR_RATIO} x the torch backend's: {err_k} against {err_t}")
    if not dec_ok:
        raise AssertionError(f"{name}: decode differs from forward by more than 2e-3: {dec_diff}")
    if not serve["identical"] or served[0].shape != serve_shape:
        raise AssertionError(f"{name}: two serving calls gave different tokens, or of shape {served[0].shape}")
    if row is not None and not row["max_row_rel_err"] <= WIDE_ROW_TOL:
        raise AssertionError(f"{name}: a row of the prefill's first launch is {row['max_row_rel_err']} of its "
                             f"scale from the plain version, past {WIDE_ROW_TOL}")
    if "slstm" in cfg.unit and len(spans) != cfg.unit.count("slstm") * cfg.n_units:
        raise AssertionError(f"{name}: {len(spans)} sLSTM blocks timed in the prefill")
    return out


def phase_wide_lm(report, zero_launches, read_launches):
    """Phase 21: the seven registry architectures that phases 17-20 run
    only at their smoke configs, at published width, one at a time in
    WIDE_ARCHS' order (``lm_wide``).  Returns the records by
    architecture."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    out = {}
    try:
        for name in WIDE_ARCHS:
            out[name] = lm_wide(name, zero_launches, read_launches)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    report["wide_lm"] = {"archs": out}
    return out


class _Tee:
    """A text stream that writes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


@contextlib.contextmanager
def fresh_obs():
    """A tracer and a metrics registry of their own, as an example script
    has in a fresh process, without the earlier phases' spans; the
    process's own are put back after."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace

    previous = obs_trace.set_tracer(obs_trace.Tracer()), obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    try:
        yield
    finally:
        obs_trace.set_tracer(previous[0])
        obs_metrics.set_registry(previous[1])


def example_numbers(x):
    """An example's returned record without the arrays and objects kept
    for the checks (EXAMPLE_BULKY): its printed numbers."""
    if isinstance(x, dict):
        return {k: example_numbers(v) for k, v in x.items() if k not in EXAMPLE_BULKY}
    if isinstance(x, (list, tuple)):
        return [example_numbers(v) for v in x]
    return x


def comparable_ticks(ticks) -> list:
    """An example's tick records without their walls, and with span ids,
    which run on across a process's runs, as spans since the first tick."""
    first = ticks[0].get("span_id") if ticks else None
    return [{**{k: v for k, v in t.items() if k not in ("seconds", "span_id")},
             **({} if first is None else {"spans_since_first": t["span_id"] - first})} for t in ticks]


def gbdt_against_cpu(card, cpu, what: str) -> dict:
    """Phase 6's rule for one pipeline fitted on the card and on the CPU
    (``PipelineResult`` each): the trees split alike, or first differ at a
    near tie of the two gains (``first_split_difference``); where they
    split alike, F1, precision and recall are equal too."""
    from repro_torch.ml.gbdt import first_split_difference

    diff = first_split_difference(card.classifier, cpu.classifier, card.n_train)
    row = {"first_difference": diff, "f1": [card.f1, cpu.f1]}
    if diff is None and (card.f1, card.precision, card.recall) != (cpu.f1, cpu.precision, cpu.recall):
        raise AssertionError(f"{what}: the trees split alike on the card and the CPU, but F1, precision or recall "
                             f"differ: {(card.f1, card.precision, card.recall)} against "
                             f"{(cpu.f1, cpu.precision, cpu.recall)}")
    if diff is not None and not diff["near_tie"]:
        raise AssertionError(f"{what}: the card and the CPU split differently where the gains are no near tie: {diff}")
    return row


def examples_against_cpu(device, zero_launches, read_launches) -> dict:
    """Phase 22's second half: each example's function on ``device`` (the
    card) and on the CPU port at EXAMPLE_CHECK's size (EXAMPLE_SERVE for
    serve_lm), the same inputs on both sides, each run as in a fresh
    process (``fresh_obs``).  Integer outputs equal (portfolio columns,
    roundtrip3, every tick's counters, alerts and scores, the traces'
    span-name counts and part counters); the GBDT fits by
    ``gbdt_against_cpu``; FraudGT's card-trained weights scoring the test
    split on the CPU within EXAMPLE_PROBA_TOL of the card; serve_lm's
    float32 smoke logits within EXAMPLE_LOGIT_TOL.  Returns the record."""
    import dataclasses
    import io

    import numpy as np
    import torch
    from repro_torch.configs.registry import smoke_config
    from repro_torch.convert import fraudgt_params_numpy
    from repro_torch.data import generate_aml_dataset
    from repro_torch.data.loader import temporal_split
    from repro_torch.examples import quickstart, serve_lm, streaming_detection, trace_capture, train_aml_pipeline
    from repro_torch.ml.fraudgt import FraudGT, FraudGTParams
    from repro_torch.models import model as M

    out = {}

    def both(fn):
        # fn(device, side): the card's run, then the CPU's, each as in a
        # fresh process, their printing kept out of the log
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            with fresh_obs():
                card = fn(device, "card")
            t1 = time.perf_counter()
            with fresh_obs():
                cpu = fn(torch.device("cpu"), "cpu")
            t2 = time.perf_counter()
        return card, cpu, {"card_s": t1 - t0, "cpu_s": t2 - t1}

    # quickstart: the portfolio's columns, roundtrip3, the full pipeline
    c = EXAMPLE_CHECK["quickstart"]
    ds = generate_aml_dataset("HI-Small", seed=0, scale=c["scale"])
    card, cpu, row = both(lambda d, _: quickstart.run(ds, trees=c["trees"], device=d))
    if not (np.array_equal(card["counts"], cpu["counts"]) and card["columns"] == cpu["columns"]
            and np.array_equal(card["roundtrip3_counts"], cpu["roundtrip3_counts"])
            and card["kernel_calls"] == cpu["kernel_calls"] and card["plan_text"] == cpu["plan_text"]):
        raise AssertionError("quickstart: the card's portfolio columns, roundtrip3 or plan differ from the CPU's")
    row.update({**c, "n_edges": card["n_edges"], "counts_equal": True,
                "gbdt": gbdt_against_cpu(card["pipeline"], cpu["pipeline"], "quickstart's full pipeline")})
    out["quickstart"] = row

    # streaming_detection: every tick's counters, alerts and scores
    c = EXAMPLE_CHECK["streaming_detection"]
    g = generate_aml_dataset("HI-Small", seed=3, scale=c["scale"]).graph
    card, cpu, row = both(lambda d, _: streaming_detection.run(g, batches=c["batches"], device=d))
    if (comparable_ticks(card["ticks"]) != comparable_ticks(cpu["ticks"]) or card["totals"] != cpu["totals"]
            or not all(np.array_equal(card["counts"][n], cpu["counts"][n]) for n in cpu["counts"])):
        raise AssertionError("streaming_detection: the card's ticks, alerts or counts differ from the CPU's")
    row.update({**c, "ticks": len(card["ticks"]), "alerts": card["total_alerts"], "equal": True})
    out["streaming_detection"] = row

    # train_aml_pipeline: five GBDT fits; FraudGT trained on the card, its
    # weights scoring the test split on the CPU; and, for the record, a
    # FraudGT trained on the CPU from the same init
    c = EXAMPLE_CHECK["train_aml_pipeline"]
    ds = generate_aml_dataset("HI-Small", seed=0, scale=c["scale"])
    fts = {}

    def train(d, side):
        fts[side] = FraudGT(FraudGTParams(epochs=c["epochs"]), device=d)
        return train_aml_pipeline.run(ds, fts[side], trees=c["trees"], device=d)

    card, cpu, row = both(train)
    row.update(c)
    row["gbdt"] = {fs: gbdt_against_cpu(card["results"][fs], cpu["results"][fs], f"the {fs} pipeline")
                   for fs in train_aml_pipeline.FEATURE_SETS}
    ft = fts["card"]
    same = FraudGT(ft.p, device="cpu").load_params(fraudgt_params_numpy(ft))
    same.amount_edges = ft.amount_edges
    _, test_ids = temporal_split(ds)
    err = float(np.abs(same.predict_proba(ds.graph, test_ids) - card["fraudgt_proba"]).max())
    row["fraudgt"] = {"test_edges": int(len(test_ids)), "same_weights_max_abs": err,
                      "cpu_fit_max_abs": float(np.abs(cpu["fraudgt_proba"] - card["fraudgt_proba"]).max()),
                      "f1": [card["fraudgt_f1"], cpu["fraudgt_f1"]]}
    out["train_aml_pipeline"] = row
    if not err <= EXAMPLE_PROBA_TOL:
        raise AssertionError(f"train_aml_pipeline: FraudGT's card-trained weights score the test split on the CPU "
                             f"{err} from the card, past {EXAMPLE_PROBA_TOL}")

    # serve_lm: float32 smoke weights drawn on the CPU, the same on the card
    b, plen, ngen, cache = EXAMPLE_SERVE
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    rows = {}
    try:
        for arch in serve_lm.ARCHS:
            cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
            p_cpu = M.init_params(cfg, SEED, device="cpu")
            p_dev = M.tree_map(lambda a: a.to(device), p_cpu)
            card, cpu, r = both(lambda d, side: serve_lm.serve(arch, cfg, p_dev if side == "card" else p_cpu,
                                                               b, plen, ngen, cache))
            toks = torch.from_numpy(card["tokens"])
            zero_launches()
            with torch.inference_mode():
                lg_d, _ = M.forward(p_dev, {"tokens": toks.to(device)}, cfg)
                lg_c, _ = M.forward(p_cpu, {"tokens": toks}, cfg)
            r.update({"logits_max_abs": float((lg_d.cpu() - lg_c).abs().max()),
                      "logits_close": bool(torch.allclose(lg_d.cpu(), lg_c, rtol=EXAMPLE_LOGIT_TOL,
                                                          atol=EXAMPLE_LOGIT_TOL)),
                      "tokens_equal": bool(np.array_equal(card["tokens"], cpu["tokens"])),
                      "forward_launches": read_launches()["flash_attention"]})
            rows[arch] = r
            del p_dev, lg_d
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["serve_lm"] = {"shape": [b, plen, ngen, cache], "archs": rows}
    bad = [a for a, r in rows.items() if not r["logits_close"]]
    if bad:
        raise AssertionError(f"serve_lm: the card's float32 logits differ from the CPU's past {EXAMPLE_LOGIT_TOL} "
                             f"for {bad}: {rows}")

    # trace_capture: the parts' counters and counts, the ticks, the span names
    c = EXAMPLE_CHECK["trace_capture"]
    ds = generate_aml_dataset("HI-Small", seed=0, scale=c["scale"])
    base = ROOT / "build" / "examples" / "check"
    card, cpu, row = both(lambda d, side: trace_capture.run(ds, out_dir=str(base / side), device=d))
    keys = ("sharded_kernel_calls", "sharded_host_syncs", "sharded_spans", "streaming_spans", "span_names")
    if (any(card[k] != cpu[k] for k in keys) or comparable_ticks(card["ticks"]) != comparable_ticks(cpu["ticks"])
            or not np.array_equal(card["sharded_counts"], cpu["sharded_counts"])):
        raise AssertionError("trace_capture: the card's counters, ticks or span names differ from the CPU's: "
                             + json.dumps({k: [card[k], cpu[k]] for k in keys}))
    row.update({**c, "span_names": card["span_names"], "equal": True})
    out["trace_capture"] = row
    return out


def phase_examples(device, report, zero_launches, read_launches) -> dict:
    """Phase 22: the JAX package's five example scripts as the port's
    entry points (``repro_torch.examples``), each ``main`` run on the card
    as a user runs it, at the script's own defaults (EXAMPLE_RUNS), its
    launch counts zeroed before and read after; each example's own checks
    (roundtrip3 equal to the oracle, the incremental cycle3 equal to the
    batch recompute, the full pipeline's F1 above 0, both traces holding
    ``dispatch:shard0..7`` and ``tick:ingest/plan/mine/score`` and no span
    of another run, the served tokens of (8, 36) with the prompt kept) and
    the kernels each reaches:
    ``intersect_count`` in the mining examples, both ``hist_update``
    entries in the pipelines, the attention forward with the logsumexp
    and the short backward in FraudGT's fit, and no attention kernel in
    serving.  One JSON line an example: wall, printed numbers, launches.
    Then ``examples_against_cpu``.  Returns each run's launch counts."""
    import importlib
    import io

    import numpy as np

    runs, launches = {}, {}
    for label, name, argv in EXAMPLE_RUNS:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        buf = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with fresh_obs(), contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            got = mod.main(list(argv))
        wall = time.perf_counter() - t0
        launches[label] = read_launches()
        row = {"example": name, "argv": list(argv), "wall_s": wall, "launches": launches[label],
               "printed": example_numbers(got)}
        runs[label] = {**row, "output_lines": len(buf.getvalue().splitlines())}
        log(f"example {label}: " + json.dumps(row, default=str))
        ln = launches[label]
        mining = name in ("quickstart", "streaming_detection", "trace_capture")
        pipeline = name in ("quickstart", "train_aml_pipeline")
        if mining and not (ln["intersect_count"] > 0 and ln["window_search"] > 0 and ln["window_search_step"] > 0):
            raise AssertionError(f"{label} did not launch the mining kernels: {ln}")
        if pipeline and not ln["hist_update"] > ln["hist_update_rows"] > 0:
            raise AssertionError(f"{label} did not launch both hist_update entries: {ln}")
        if name == "train_aml_pipeline":
            if not (ln["flash_attention"] > 0 and ln["flash_attention_lse"] > 0 and ln["flash_attention_bwd"] > 0):
                raise AssertionError(f"{label}: FraudGT did not train through the attention kernels: {ln}")
        elif ln["flash_attention"] or ln["flash_attention_bwd"]:
            raise AssertionError(f"{label} launched flash_attention: {ln}")
        if name == "quickstart":
            if not (np.array_equal(got["roundtrip3_counts"], got["roundtrip3_oracle"]) and got["f1"] > 0):
                raise AssertionError(f"quickstart: roundtrip3 differs from the oracle or F1 is {got['f1']}")
        if name == "streaming_detection" and not got["cycle3_equal"]:
            raise AssertionError(f"{label}: the incremental cycle3 differs from the batch recompute")
        if name == "train_aml_pipeline" and not got["pipelines"]["full"]["f1"] > 0:
            raise AssertionError("train_aml_pipeline: the full feature set detected nothing")
        if name == "serve_lm":
            for arch, r in got.items():
                p = r["prompts"].shape[1]
                if r["tokens"].shape != (8, 36) or not np.array_equal(r["tokens"][:, :p], r["prompts"]):
                    raise AssertionError(f"serve_lm {arch}: tokens of shape {r['tokens'].shape}, or the prompt lost")
        if name == "trace_capture":
            want = {"sharded_mine": ({f"dispatch:shard{k}" for k in range(8)}, got["sharded_spans"]),
                    "streaming": ({"tick:ingest", "tick:plan", "tick:mine", "tick:score"}, got["streaming_spans"])}
            for key, (names, n_spans) in want.items():
                with open(got["paths"][key]) as f:
                    events = json.load(f)["traceEvents"]
                held = {e["name"] for e in events}
                if not names <= held:
                    raise AssertionError(f"trace_capture: {key}'s trace lacks {sorted(names - held)}")
                if len(events) != n_spans:
                    raise AssertionError(f"trace_capture: {key}'s trace holds {len(events)} spans, not {n_spans}")
            if "tick" in got["span_names"]["sharded_mine"]:
                raise AssertionError("trace_capture: the sharded mine's trace holds a streaming tick")
    t0 = time.perf_counter()
    check = examples_against_cpu(device, zero_launches, read_launches)
    check["phase_s"] = time.perf_counter() - t0
    log("examples, the card against the CPU port: " + json.dumps(check, default=str))
    report["examples"] = {"runs": runs, "against_cpu": check}
    return launches


def same_trees(a, b) -> bool:
    """Bit-equal splits, gains and leaves."""
    import numpy as np

    return len(a.trees) == len(b.trees) and all(
        all(np.array_equal(p, q) for p, q in zip(ta[0] + ta[1] + [ta[2], ga], tb[0] + tb[1] + [tb[2], gb]))
        for ta, tb, ga, gb in zip(a.trees, b.trees, a.gains, b.gains)
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=282.0, help="HI-Small scale (282 = published size)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py: run it from a checkout of the repository (src/repro_torch is missing)", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.api import MiningSession
    from repro_torch.core.patterns import feature_pattern_set
    from repro_torch.data.synth_aml import generate_aml_dataset
    from repro_torch.device import allowed_sync
    from repro_torch.core.features import base_features
    from repro_torch.data.loader import temporal_split
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.hist_update.ref import row_keys
    from repro_torch.kernels.intersect_count import ops as ic_ops
    from repro_torch.kernels.window_degree import ops as wd_ops
    from repro_torch.kernels.window_search import ops as ws_ops
    from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams, first_split_difference
    from repro_torch.ml.pipeline import FEATURE_SETS, run_aml_pipeline

    device = torch.device("cuda")
    report = {"scale": args.scale, "seed": SEED, "phase_end_s": {}}

    def mark(phase: int) -> None:
        # the seconds since the script started, at the end of each phase
        report["phase_end_s"][phase] = time.perf_counter() - t_start
        log(f"phase {phase} ended at {report['phase_end_s'][phase]:.1f} s")

    def zero_launches():
        ic_ops.launches = hu_ops.launches = hu_ops.rows_launches = wd_ops.launches = fa_ops.launches = 0
        ws_ops.launches = ws_ops.step_launches = 0
        fa_ops.lse_launches = fa_ops.bwd_launches = fa_ops.long_bwd_launches = 0

    def read_launches():
        # "hist_update" counts both of its entries, "hist_update_rows" the rows entry alone;
        # "flash_attention" every forward launch, "flash_attention_lse" those that wrote the logsumexp,
        # "flash_attention_bwd" every backward launch, "flash_attention_bwd_long" those on the long backward;
        # "window_search" both of its entries, "window_search_step" the intersect_step entry
        return {"intersect_count": ic_ops.launches, "hist_update": hu_ops.launches,
                "hist_update_rows": hu_ops.rows_launches,
                "window_degree": wd_ops.launches, "flash_attention": fa_ops.launches,
                "flash_attention_lse": fa_ops.lse_launches, "flash_attention_bwd": fa_ops.bwd_launches,
                "flash_attention_bwd_long": fa_ops.long_bwd_launches, "window_search": ws_ops.launches,
                "window_search_step": ws_ops.step_launches}

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.load, KERNELS))
    report["build_s"] = time.perf_counter() - t0
    report["nvcc_s"] = {k: build.build_seconds[k] for k in KERNELS}
    card = card_line()
    report["card"] = card
    log(f"build: {', '.join(KERNELS)} from src/repro_torch/csrc in {report['build_s']:.2f} s "
        f"(nvcc in parallel: {json.dumps(report['nvcc_s'])})")
    log(f"card: {card}")
    mark(1)

    # ---- 2. kernels against their plain versions ----------------------
    def timed2(name, fn):
        # phase 2's seconds by kernel
        t0 = time.perf_counter()
        out = fn(device, report)
        report.setdefault("phase2_s", {})[name] = time.perf_counter() - t0
        return out

    max_err = timed2("intersect_count", phase_kernel)
    hu_err = timed2("hist_update", phase_hist_update)
    wd_row = timed2("window_degree", phase_window_degree)
    ws_err, _ = timed2("window_search", phase_window_search)
    fa_err = timed2("flash_attention", phase_flash_attention)
    fa_bwd_err = timed2("flash_attention_bwd", phase_flash_attention_bwd)
    log("phase 2 by kernel: " + json.dumps(report["phase2_s"]))
    mark(2)

    # ---- 3. main path at a real size: mine, features, fit, F1 ---------
    t0 = time.perf_counter()
    ds = generate_aml_dataset("HI-Small", seed=SEED, scale=args.scale)
    g = ds.graph
    report["data"] = {"n_nodes": g.n_nodes, "n_edges": g.n_edges, "gen_s": time.perf_counter() - t0,
                      "max_out_deg": g.max_out_deg(), "max_in_deg": g.max_in_deg()}
    log("data: " + json.dumps(report["data"]))
    pats = feature_pattern_set("full")
    session = MiningSession(g, window=WINDOW).register(*pats)

    params = GBDTParams()
    fit_launches = params.n_trees * (params.max_depth + 1)
    rows_fit_launches = params.n_trees * params.max_depth
    hu_fn, hu_rows_fn = hu_ops.hist_update, hu_ops.hist_update_rows
    hu_path = {}  # (N, S) -> the first keys-entry launch of each shape the fit makes
    hu_rows_path = {}  # (N, S) -> the first rows-entry launch of each shape

    def capture_hu(keys, gh, s):
        hu_path.setdefault((keys.shape[0], s), (keys, gh, s))
        return hu_fn(keys, gh, s)

    def capture_hu_rows(xb, node, gh, n_nodes, n_bins):
        hu_rows_path.setdefault((xb.shape[0], n_nodes * xb.shape[1] * n_bins), (xb, node, gh, n_nodes, n_bins))
        return hu_rows_fn(xb, node, gh, n_nodes, n_bins)

    def detection_row(fs, res, wall):
        row = {"f1": res.f1, "precision": res.precision, "recall": res.recall, "confusion": res.confusion,
               "mine_seconds": res.mine_seconds, "train_seconds": res.train_seconds,
               "fit_seconds": res.fit_seconds, "wall_s": wall, "n_train": res.n_train, "n_test": res.n_test,
               "launches": read_launches(),
               "mine_host_syncs": res.mining.stats["host_syncs"] if res.mining else 0}
        log(f"detection path ({fs}): " + json.dumps(row))
        if row["launches"]["hist_update"] != fit_launches:
            raise AssertionError(f"the {fs} fit launched hist_update {row['launches']['hist_update']} "
                                 f"times, not {fit_launches}")
        if row["launches"]["hist_update_rows"] != rows_fit_launches:
            raise AssertionError(f"the {fs} fit launched the rows entry {row['launches']['hist_update_rows']} "
                                 f"times, not {rows_fit_launches}")
        if not 0.0 <= res.f1 <= 1.0 or res.n_train + res.n_test != g.n_edges:
            raise AssertionError(f"{fs}: F1 {res.f1} or split {res.n_train}+{res.n_test} out of range")
        return row

    biggest = {}
    kernel_fn, capture = capture_biggest(biggest)
    ws_biggest = {}  # entry -> (elements, args) of the largest window_search call
    ws_fns = {e: getattr(ws_ops, e) for e in ("count_window", "count_id_in_window")}

    def capture_ws(entry):
        def run(*a):
            n = math.prod(torch.broadcast_shapes(*(tuple(v.shape) for v in a[-5 if entry == "count_id_in_window"
                                                                               else -4:-1]
                                                   if isinstance(v, torch.Tensor))))
            if n > ws_biggest.get(entry, (-1,))[0]:
                ws_biggest[entry] = (n, a)
            return ws_fns[entry](*a)
        return run

    ws_step_fn = ws_ops.intersect_step
    ws_step_biggest = {}  # strategy -> (lead elements x expansions, args, kw) of its largest intersect_step call

    def capture_step(*a, **kw):
        out = ws_step_fn(*a, **kw)
        n = out.numel() * kw["d"] * kw["n_sweep"]
        if n > ws_step_biggest.get(a[0], (-1,))[0]:
            ws_step_biggest[a[0]] = (n, a, kw)
        return out

    ic_ops.intersect_count = capture
    hu_ops.hist_update, hu_ops.hist_update_rows = capture_hu, capture_hu_rows
    for e in ws_fns:
        setattr(ws_ops, e, capture_ws(e))
    ws_ops.intersect_step = capture_step
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        full = run_aml_pipeline(ds, "full", session=session)
        wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        ic_ops.intersect_count = kernel_fn
        hu_ops.hist_update, hu_ops.hist_update_rows = hu_fn, hu_rows_fn
        for e, fn in ws_fns.items():
            setattr(ws_ops, e, fn)
        ws_ops.intersect_step = ws_step_fn
    detection = {"full": detection_row("full", full, wall)}
    main_launches = detection["full"]["launches"]
    launches = main_launches["intersect_count"]
    n_compiled = len(session._compiled)
    cold = full.mining
    counts = cold.counts
    # the warm re-mine: WARM_SEEDS seeds mined twice, the second time from
    # the cached schedules
    wsub = np.random.default_rng(SEED + 2).choice(g.n_edges, size=min(WARM_SEEDS, g.n_edges),
                                                  replace=False).astype(np.int32)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        first = session.mine(seeds=wsub)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = session.mine(seeds=wsub)
        warm_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    main = {
        "patterns": list(pats),
        "n_seeds": int(cold.n_seeds),
        "cold_s": full.mine_seconds,
        "pipeline_s": wall,
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
        "launches": main_launches,
        "n_compiled": n_compiled,
        "fused": list(cold.fused),
        "totals": cold.totals(),
        "stats_cold": cold.stats,
        "seconds_cold": cold.seconds,
        "warm_seeds": int(len(wsub)),
        "first_s": first_s,
        "warm_s": warm_s,
        "stats_warm": warm.stats,
    }
    report["main_path"] = main
    log("main path: " + json.dumps(main))
    if launches <= 0:
        raise AssertionError("the main path launched intersect_count no time")
    if main_launches["window_search"] <= 0 or main_launches["window_search_step"] <= 0:
        raise AssertionError(f"the main path launched window_search (its intersect_step entry) no time: "
                             f"{main_launches}")
    for name, res in (("cold", cold), ("first subset", first), ("warm", warm)):
        if res.stats["host_syncs"] != 1 + n_compiled:
            raise AssertionError(f"{name} mine synced {res.stats['host_syncs']} times, not {1 + n_compiled}")
    if warm.stats["schedule_hits"] <= 0:
        raise AssertionError("the warm mine did not replay its schedules")
    if cold.columns != FEATURE_SETS["full"] or counts.shape != (g.n_edges, len(pats)) or (counts < 0).any():
        raise AssertionError(f"count matrix has columns {cold.columns}, shape {counts.shape} or negative counts")
    if not (np.array_equal(first.counts, counts[wsub]) and np.array_equal(warm.counts, counts[wsub])):
        raise AssertionError("the subset's mines disagree with the main path's rows")
    if full.f1 <= 0.0:
        raise AssertionError("the full feature set detected nothing")
    mark(3)

    # ---- 4. cross-checks on the card ----------------------------------
    t0 = time.perf_counter()
    tsub = np.random.default_rng(SEED + 1).choice(g.n_edges, size=min(TORCH_SEEDS, g.n_edges), replace=False)
    zero_launches()
    res_t = MiningSession(g, window=WINDOW, kernel_backend="torch").register(*pats).mine(seeds=tsub)
    torch_s = time.perf_counter() - t0
    torch_launches = read_launches()
    if torch_launches["window_search"] or torch_launches["intersect_count"]:
        raise AssertionError(f'the kernel_backend="torch" mine launched the mining kernels: {torch_launches}')
    if not np.array_equal(res_t.counts, counts[tsub]):
        bad = tsub[np.argwhere(res_t.counts != counts[tsub])[:5, 0]]
        raise AssertionError(f'kernel_backend="torch" disagrees with "kernel" at {bad.tolist()}')
    rng = np.random.default_rng(SEED)
    sub = rng.choice(g.n_edges, size=min(CPU_SEEDS, g.n_edges), replace=False).astype(np.int32)
    t0 = time.perf_counter()
    res_c = MiningSession(g, window=WINDOW, device="cpu").register(*pats).mine(seeds=sub)
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(res_c.counts, counts[sub]):
        raise AssertionError("the CPU port disagrees with the card on the seed subset")
    report["cross_checks"] = {"torch_seeds": int(len(tsub)), "torch_backend_s": torch_s, "torch_backend_equal": True,
                              "torch_backend_launches": torch_launches,
                              "cpu_seeds": int(len(sub)), "cpu_s": cpu_s, "cpu_equal": True,
                              "cpu_nonzero_cells": int((res_c.counts != 0).sum())}
    log("cross-checks: " + json.dumps(report["cross_checks"]))
    mark(4)

    # ---- 5. the detection path without mined features -----------------
    zero_launches()
    t0 = time.perf_counter()
    res = run_aml_pipeline(ds, "xgb_only")
    detection["xgb_only"] = detection_row("xgb_only", res, time.perf_counter() - t0)
    report["detection"] = detection
    mark(5)

    # ---- 6. detection cross-checks ------------------------------------
    x = np.concatenate([base_features(g), counts.astype(np.float32)], axis=1)
    y = ds.labels.astype(np.float32)
    train_ids, _ = temporal_split(ds)
    small = GBDTParams(n_trees=CHECK_TREES)
    rows = train_ids[:DET_ROWS]
    t0 = time.perf_counter()
    fit_a = GBDTClassifier(small).fit(x[rows], y[rows])
    fit_b = GBDTClassifier(small).fit(x[rows], y[rows])
    det_s = time.perf_counter() - t0
    proba_a, proba_b = fit_a.predict_proba(x[rows]), fit_b.predict_proba(x[rows])
    if not same_trees(fit_a, fit_b) or not np.array_equal(proba_a, proba_b):
        raise AssertionError(f"two fits on the card differ: {first_split_difference(fit_a, fit_b, len(rows))}")
    rows = train_ids[:CPU_FIT_ROWS]
    t0 = time.perf_counter()
    on_card = GBDTClassifier(small).fit(x[rows], y[rows])
    card_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = GBDTClassifier(small, device="cpu").fit(x[rows], y[rows])
    cpu_fit_s = time.perf_counter() - t0
    diff = first_split_difference(on_card, on_cpu, len(rows))
    check = {"determinism_rows": int(min(DET_ROWS, len(train_ids))), "determinism_s": det_s,
             "determinism_equal": True, "cpu_rows": int(len(rows)), "card_fit_s": card_fit_s,
             "cpu_fit_s": cpu_fit_s, "first_difference": diff}
    if diff is None:
        check["leaf_max_abs_diff"] = max(float(np.abs(ta[2] - tb[2]).max())
                                         for ta, tb in zip(on_card.trees, on_cpu.trees))
        check["proba_max_abs_diff"] = float(np.abs(on_card.predict_proba(x[rows])
                                                   - on_cpu.predict_proba(x[rows])).max())
    report["detection_cross_checks"] = check
    log("detection cross-checks: " + json.dumps(check))
    if diff is not None and not diff["near_tie"]:
        raise AssertionError(f"the card and the CPU split differently where the gains are no near tie: {diff}")
    mark(6)

    # ---- 7. FraudGT inference ----------------------------------------
    fgt_launches, fa_args = phase_fraudgt(ds, device, report, zero_launches, read_launches)
    mark(7)

    # ---- 8. report -----------------------------------------------------
    a = biggest["args"]
    ordered = biggest["ordered"]
    b = a[0].shape[0]
    got = ic_ops.intersect_count(*a, ordered=ordered)
    want = ic_plain_rows(a, ordered)
    err = int((got.long() - want.long()).abs().max()) if b else 0
    if err:
        raise AssertionError(f"intersect_count differs from its plain version on the main path's launch: {err}")
    max_err = max(max_err, err)
    times = ic_times(a, ordered, 20, cold=True)
    log("kernel timing: intersect_count on the mining path " + json.dumps(times))
    kernels = [{
        "name": "intersect_count",
        "route": "cuda",
        "source": "src/repro_torch/csrc/intersect_count.cu",
        "replaces": "src/repro/kernels/intersect_count/kernel.py:83",
        "launches": launches,
        "max_abs_err": max_err,
        **{k: times[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "kernel_ms", "l2_flushed",
                                 "l2_warm_ms", "l2_warm_kernel_ms", "plan")},
        "library_ms": None,
        "shape": ic_form(a, ordered),
    }]
    # window_search at the main path's largest launch of each searching
    # entry, in the operand forms the compiler passed
    ws_path = {}
    for entry, (_, args) in sorted(ws_biggest.items()):
        err = ws_hold(entry, args, "the main path's largest launch")
        ws_path[entry] = {"max_abs_err": err, **ws_times(entry, args, 20, cold=True), "shape": ws_form(entry, args)}
        log(f"kernel timing: window_search ({entry}) on the mining path " + json.dumps(ws_path[entry]))
    # the whole intersect steps at the main path's largest launch of each
    # strategy, held against the plain version and timed with L2 flushed
    for strategy, (_, args, kw) in sorted(ws_step_biggest.items()):
        err, plain_ms = ws_step_hold(args, kw, f"the main path's largest {strategy} launch")
        row = {"max_abs_err": err, "shape": ws_step_form(args, kw),
               **ws_step_times(args, kw, 10, plain_ms, cold=True)}
        ws_path[f"intersect_step_{strategy}"] = row
        log(f"kernel timing: window_search (intersect_step, {strategy}) on the mining path " + json.dumps(row))
    # the entry's headline: the path's largest launch (by elements: the
    # bs2 hub sweep's intersect_step).  No one PyTorch call computes an
    # intersect step; the library yardstick (a searchsorted over a prebuilt
    # key) is count_window's, stated with that launch's shape beside it
    top_name = max(ws_path, key=lambda e: ws_path[e]["elements"])
    top = ws_path[top_name]
    library_ms = ws_library_ms(ws_biggest["count_window"][1], 20) if "count_window" in ws_biggest else None
    if library_ms is not None:
        ws_path["count_window"]["library_ms"] = library_ms
    ws_entry = {
        "name": "window_search",
        "route": "cuda",
        "source": "src/repro_torch/csrc/window_search.cu",
        # not a TPU kernel: the reference's fori_loop searches, compiled by XLA
        "replaces": "src/repro/core/ops.py:46",
        "launches": main_launches["window_search"],
        "step_launches": main_launches["window_search_step"],
        "max_abs_err": max([ws_err] + [r["max_abs_err"] for r in ws_path.values()]),
        "headline": top_name,
        **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "kernel_ms", "l2_flushed", "l2_warm_ms",
                               "l2_warm_kernel_ms", "host_us", "halvings", "operations", "row_bytes", "elements")
           if k in top},
        "library_ms": library_ms,
        "library": "torch.searchsorted over a prebuilt int64 (row << 32) | (t ^ 0x80000000) key, count_window",
        "library_shape": ws_path["count_window"]["shape"] if library_ms is not None else None,
        "shape": top["shape"],
        "path_launches": {e: {k: r[k] for k in ("ms", "kernel_ms", "l2_warm_ms", "plain_ms", "library_ms",
                                                "bound_ms", "bound_by", "row_bytes", "halvings", "operations",
                                                "elements", "shape")
                              if k in r}
                          for e, r in ws_path.items()},
        "launches_torch_backend": torch_launches["window_search"],
    }
    kernels.insert(1, ws_entry)  # kernels[0] stays intersect_count, kernels[-1] flash_attention
    # hist_update on the detection path: the rows entry at every level of
    # the fit and the keys entry at the leaf sums, each as the fit launched
    # it; then the keys entry on the keys and repeated gh that the fit
    # would build at every level, which is where it ran before the rows
    # entry existed
    path_rows = []
    for (n, s), (keys, gh, _) in sorted(hu_path.items()):
        err = hu_check(keys, gh, s)
        hu_err = max(hu_err, err)
        path_rows.append({"entry": "keys", "launched": True, "N": int(n), "S": s, "max_abs_err": err,
                          **hu_times(keys, gh, s, 20)})
        log("kernel timing: hist_update on the detection path " + json.dumps(path_rows[-1]))
    rows_rows = []
    for (n, s), (xb, node, gh, n_nodes, n_bins) in sorted(hu_rows_path.items()):
        err = hu_rows_check(xb, node, gh, n_nodes, n_bins)
        hu_err = max(hu_err, err)
        rows_rows.append({"entry": "rows", "N": int(n), "F": int(xb.shape[1]), "n_nodes": n_nodes, "S": s,
                          "max_abs_err": err, **hu_rows_times(xb, node, gh, n_nodes, n_bins, 20)})
        log("kernel timing: hist_update_rows on the detection path " + json.dumps(rows_rows[-1]))
        keys = row_keys(xb, node, n_bins)
        gh_rep = gh[:, None, :].expand(n, xb.shape[1], 2).reshape(-1, 2)
        err = hu_check(keys, gh_rep, s)
        hu_err = max(hu_err, err)
        path_rows.append({"entry": "keys", "launched": False, "N": int(keys.shape[0]), "S": s,
                          "max_abs_err": err, **hu_times(keys, gh_rep, s, 20)})
        log("kernel timing: hist_update on the fit's level keys " + json.dumps(path_rows[-1]))
        del keys, gh_rep
    report["hist_update_path_shapes"] = path_rows + rows_rows
    top = max(path_rows, key=lambda r: (r["N"], r["S"]))  # the keys entry's largest path shape
    fit_launch = detection["full"]["launches"]
    kernels.append({
        "name": "hist_update",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hist_update.cu",
        "replaces": "src/repro/kernels/hist_update/kernel.py:42",
        # the keys entry: the leaf sums of the fit; 420 with the rows entry's
        "launches": fit_launch["hist_update"] - fit_launch["hist_update_rows"],
        "launches_both_entries": fit_launch["hist_update"],
        "max_abs_err": hu_err,
        **{k: top[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "shape": {"N": top["N"], "S": top["S"], "keys": "the fit's level-5 (node, feature, bin) keys"},
    })
    top = max(rows_rows, key=lambda r: (r["N"], r["S"]))
    kernels.append({
        "name": "hist_update_rows",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hist_update.cu",
        "replaces": "src/repro/kernels/hist_update/kernel.py:42",
        "launches": fit_launch["hist_update_rows"],
        "max_abs_err": max(r["max_abs_err"] for r in rows_rows),
        **{k: top[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "library": "index_add_ of the repeated gh on prebuilt keys (the key build and the repeat not counted)",
        "shape": {k: top[k] for k in ("N", "F", "n_nodes", "S")},
    })
    kernels.append({
        "name": "window_degree",
        "route": "cuda",
        "source": "src/repro_torch/csrc/window_degree.cu",
        "replaces": "src/repro/kernels/window_degree/kernel.py:34",
        # no path of the system calls it (as in the JAX package)
        "launches": main_launches["window_degree"] + detection["xgb_only"]["launches"]["window_degree"],
        **{k: wd_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": {"B": wd_row["B"], "D": wd_row["D"]},
    })
    fa_main = fa_row(*fa_args, 50)
    log("kernel timing: flash_attention on the FraudGT path " + json.dumps(fa_main))
    report["flash_attention_path_shape"] = fa_main
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
        "launches": fgt_launches["flash_attention"],
        **{k: fa_main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "kernel_ms", "plan")},
        "max_abs_err_cases": fa_err,
        "shape": {k: fa_main[k] for k in ("B", "T", "S", "H", "K", "hd", "causal", "dtype")},
    })
    mark(8)

    # ---- 9. the oracle on the card, and the paper's Fig. 10 ------------
    t0 = time.perf_counter()
    fig10 = phase_oracle(report)
    report["oracle"]["phase_s"] = time.perf_counter() - t0
    log("fig10: " + json.dumps({k: {kk: v[kk] for kk in ("compiled_edges_per_s", "gfp_edges_per_s", "speedup")}
                                for k, v in fig10.items()}))
    log(f"card: {card}")
    mark(9)

    # ---- 10. partitioned mine against phase 3's rows ------------------
    sub = np.random.default_rng(SEED).choice(g.n_edges, size=min(PART_SEEDS, g.n_edges),
                                             replace=False).astype(np.int32)
    zero_launches()
    t0 = time.perf_counter()
    part = session.mine(seeds=sub, backend="partitioned", n_parts=PART_N)
    part_row = {"seeds": int(len(sub)), "n_parts": part.partition_plan.n_parts, "wall_s": time.perf_counter() - t0,
                "per_part_s": part.per_part_seconds, "skew": float(part.partition_plan.skew),
                "launches": read_launches(), "stats": part.stats}
    report["partitioned"] = part_row
    log("partitioned: " + json.dumps(part_row))
    if not np.array_equal(part.counts, counts[sub]):
        raise AssertionError("the partitioned mine differs from phase 3's rows")
    mark(10)

    # ---- 11. the streaming detection service over a live feed ---------
    t0 = time.perf_counter()
    stream_launches, sbig = phase_streaming(session, g, report, zero_launches, read_launches)
    report["streaming"]["phase_s"] = time.perf_counter() - t0
    a = sbig["args"]
    b = a[0].shape[0]
    got = ic_ops.intersect_count(*a, ordered=sbig["ordered"])
    want = ic_plain_rows(a, sbig["ordered"])
    err = int((got.long() - want.long()).abs().max()) if b else 0
    if err:
        raise AssertionError(f"intersect_count differs from its plain version on the streaming launch: {err}")
    times = ic_times(a, sbig["ordered"], 20, cold=True)
    ws_entry["launches_streaming"] = report["streaming"]["launches"]["window_search"]
    ws_entry["step_launches_streaming"] = report["streaming"]["launches"]["window_search_step"]
    kernels[0].update({
        "launches_streaming": stream_launches,
        "streaming_shape": ic_form(a, sbig["ordered"]),
        "streaming_max_abs_err": err,
        **{f"streaming_{k}": times[k] for k in ("ms", "kernel_ms", "l2_warm_ms", "l2_warm_kernel_ms", "host_us",
                                                "plain_ms", "bound_ms", "bound_by", "plan")},
    })
    log("kernel timing: intersect_count on the streaming path " + json.dumps(
        {k: v for k, v in kernels[0].items() if k.startswith(("launches_streaming", "streaming_"))}))
    mark(11)

    # ---- 12. resilience: retry, WAL + checkpoint recovery -------------
    res_launches, rec_launches = phase_resilience(session, g, report, zero_launches, read_launches)
    kernels[0].update({"launches_resilience": res_launches, "launches_recovery": rec_launches})
    ws_entry.update({"launches_resilience": report["resilience"]["window_search_launches"]["ticks"],
                     "launches_recovery": report["resilience"]["window_search_launches"]["recover"],
                     "step_launches_resilience": report["resilience"]["window_search_step_launches"]["ticks"],
                     "step_launches_recovery": report["resilience"]["window_search_step_launches"]["recover"]})
    mark(12)

    # ---- 13. witnesses: oracle, session witness mode, plant and recover
    t0 = time.perf_counter()
    phase_witness(session, ds, counts, report)
    report["witness"]["phase_s"] = time.perf_counter() - t0
    ws_entry["launches_witness"] = report["witness"]["session"]["window_search_launches"]
    ws_entry["step_launches_witness"] = report["witness"]["session"]["window_search_step_launches"]
    mark(13)

    # ---- 14. the triage server over a live feed -----------------------
    t0 = time.perf_counter()
    kernels[0]["launches_triage"] = phase_triage(g, report, zero_launches, read_launches)
    ws_entry["launches_triage"] = report["triage"]["launches"]["window_search"]
    ws_entry["step_launches_triage"] = report["triage"]["launches"]["window_search_step"]
    report["triage"]["phase_s"] = time.perf_counter() - t0
    log(f"card: {card}")
    mark(14)

    # ---- 15. the sharded mine -------------------------------------------
    t0 = time.perf_counter()
    kernels[0]["launches_sharded"] = phase_sharded(session, g, counts, report, zero_launches, read_launches)
    ws_entry["launches_sharded"] = sum(report["sharded"][k]["launches"]["window_search"] for k in ("parts", "seeds"))
    ws_entry["step_launches_sharded"] = sum(report["sharded"][k]["launches"]["window_search_step"]
                                            for k in ("parts", "seeds"))
    report["sharded"]["phase_s"] = time.perf_counter() - t0
    mark(15)

    # ---- 16. FraudGT training through the attention kernels both ways --
    t0 = time.perf_counter()
    fit_launches, bwd_args = phase_fraudgt_fit(ds, report, zero_launches, read_launches)
    report["fraudgt_fit"]["phase_s"] = time.perf_counter() - t0
    kernels[-1]["launches_fit"] = fit_launches["flash_attention"]
    q, k, v, o, do, lse, causal = bwd_args
    bwd_main = fa_bwd_row(q, k, v, do, causal, 50, o=o, lse=lse, flush_l2=True)
    log("kernel timing: flash_attention_bwd on the FraudGT training path " + json.dumps(bwd_main))
    report["flash_attention_bwd_path_shape"] = bwd_main
    kernels.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_short_bwd.cuh",
        # not a TPU kernel: the JAX fit differentiates XLA's attention
        "replaces": "src/repro/models/layers.py:108",
        "launches": fit_launches["flash_attention_bwd"],
        **{k: bwd_main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                    "kernel_ms", "l2_flushed_ms", "l2_flushed_kernel_ms", "stages", "grid")},
        # the kernel's own route inside the short path ("route" is the port's: cuda)
        "short_bwd_route": bwd_main["route"],
        "max_abs_err_cases": fa_bwd_err["short"],
        "library": "the backward of F.scaled_dot_product_attention at the same shape",
        "shape": {k: bwd_main[k] for k in ("B", "T", "S", "H", "K", "hd", "causal", "dtype")},
    })
    log(f"card: {card}")
    mark(16)

    # ---- 17. the LM scaffold's serving path: qwen2-1.5b at full width --
    t0 = time.perf_counter()
    lm_launches, lm_args = phase_lm(report, zero_launches, read_launches)
    report["lm"]["phase_s"] = time.perf_counter() - t0
    q, k, v, causal = lm_args
    lm_main = fa_row(q, k, v, causal, 20)
    log("kernel timing: flash_attention on the LM prefill path " + json.dumps(lm_main))
    report["flash_attention_lm_shape"] = lm_main
    fa_entry = next(e for e in kernels if e["name"] == "flash_attention")
    fa_entry.update({
        "launches_lm": lm_launches["flash_attention"],
        **{f"lm_{key}": lm_main[key] for key in ("max_abs_err", "ms", "kernel_ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by", "plan")},
        "lm_shape": {key: lm_main[key] for key in ("B", "T", "S", "H", "K", "hd", "causal", "dtype")},
    })
    log(f"card: {card}")
    mark(17)

    # ---- 18. the LM's training loop: qwen2-1.5b at full width -----------
    t0 = time.perf_counter()
    train_launches, train_args = phase_train(report, zero_launches, read_launches)
    report["train"]["phase_s"] = time.perf_counter() - t0
    q, k, v, o, do, lse, causal = train_args
    bwd_long = fa_bwd_row(q, k, v, do, causal, 20, o=o, lse=lse, rtol32=FA_BWD_TOL)
    del q, k, v, o, do, lse, train_args
    log("kernel timing: flash_attention_bwd on the LM training path " + json.dumps(bwd_long))
    report["flash_attention_bwd_train_shape"] = bwd_long
    kernels.append({
        "name": "flash_attention_bwd_long",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_long_bwd.cuh",
        # not a TPU kernel: the JAX train step differentiates XLA's attention
        "replaces": "src/repro/models/layers.py:108",
        "launches": train_launches["flash_attention_bwd_long"],
        **{k_: bwd_long[k_] for k_ in ("max_abs_err", "max_rel_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                       "bound_by", "kernel_ms", "bwd_plan")},
        "max_abs_err_cases": fa_bwd_err["long"],
        "launches_per": "one training step of the phase-18 cell",
        "library": "the backward of F.scaled_dot_product_attention at the same shape",
        "shape": {k_: bwd_long[k_] for k_ in ("B", "T", "S", "H", "K", "hd", "causal", "dtype")},
    })
    fa_entry.update({"launches_train": train_launches["flash_attention"],
                     "launches_train_lse": train_launches["flash_attention_lse"]})
    log(f"card: {card}")
    mark(18)

    # ---- 19. the LM's mesh: the sharded train step on a (1, 1) mesh -------
    mesh_launches = phase_mesh(report, zero_launches, read_launches)
    fa_entry["launches_mesh_train"] = mesh_launches["flash_attention"]
    next(e for e in kernels if e["name"] == "flash_attention_bwd_long")["launches_mesh_train"] = \
        mesh_launches["flash_attention_bwd_long"]
    log(f"card: {card}")
    mark(19)

    # ---- 20. the windowed LM: zamba2-2.7b and mixtral-8x7b at full width ----
    t0 = time.perf_counter()
    win, zamba_args, mixtral_args = phase_windowed_lm(report, zero_launches, read_launches)
    report["windowed_lm"]["phase_s"] = time.perf_counter() - t0
    for key, args in (("zamba2", zamba_args), ("mixtral", mixtral_args)):
        q, k, v, window = args
        row = fa_window_row(q, k, v, window, 10)
        del q, k, v
        log(f"kernel timing: flash_attention on the {key} prefill path " + json.dumps(row))
        report[f"flash_attention_{key}_shape"] = row
        fa_entry.update({
            f"launches_{key}_prefill": win[f"{key}_prefill"]["launches"]["flash_attention"],
            **{f"{key}_{k_}": row[k_] for k_ in ("max_abs_err", "ms", "kernel_ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by", "plan")},
            f"{key}_shape": {k_: row[k_] for k_ in ("B", "T", "S", "H", "K", "hd", "window", "dtype")},
        })
    del zamba_args, mixtral_args
    train_w = win["zamba2_train"]["launches"]
    fa_entry.update({"launches_zamba2_train": train_w["flash_attention"],
                     "launches_zamba2_train_lse": train_w["flash_attention_lse"]})
    next(e for e in kernels if e["name"] == "flash_attention_bwd_long")["launches_zamba2_train"] = \
        train_w["flash_attention_bwd_long"]
    log(f"card: {card}")
    mark(20)

    # ---- 21. the seven other registry architectures at published width ----
    t0 = time.perf_counter()
    wide = phase_wide_lm(report, zero_launches, read_launches)
    report["wide_lm"]["phase_s"] = time.perf_counter() - t0
    for name, rec in wide.items():
        key = name.split("-")[0]
        fa_entry[f"launches_{key}_prefill"] = rec["launches"]["flash_attention"]
        row = rec.get("fa_launch")
        if row is not None:
            fa_entry.update({
                **{f"{key}_{k_}": row[k_] for k_ in ("max_abs_err", "max_row_rel_err", "ms", "kernel_ms", "plain_ms",
                                                     "library_ms", "bound_ms", "bound_by", "plan")},
                f"{key}_shape": {k_: row[k_] for k_ in ("B", "T", "S", "H", "K", "hd", "causal", "dtype")},
            })
    log(f"card: {card}")
    mark(21)

    # ---- 22. the JAX package's five examples as the port's entry points ----
    t0 = time.perf_counter()
    ex = phase_examples(device, report, zero_launches, read_launches)
    report["examples"]["phase_s"] = time.perf_counter() - t0
    per_entry = {  # each kernels entry's launches out of a run's counts
        "intersect_count": lambda ln: ln["intersect_count"],
        "window_search": lambda ln: ln["window_search"],
        "hist_update": lambda ln: ln["hist_update"] - ln["hist_update_rows"],
        "hist_update_rows": lambda ln: ln["hist_update_rows"],
        "window_degree": lambda ln: ln["window_degree"],
        "flash_attention": lambda ln: ln["flash_attention"],
        "flash_attention_bwd": lambda ln: ln["flash_attention_bwd"] - ln["flash_attention_bwd_long"],
        "flash_attention_bwd_long": lambda ln: ln["flash_attention_bwd_long"],
    }
    for entry in kernels:
        entry["launches_examples"] = {label: per_entry[entry["name"]](ln) for label, ln in ex.items()}
    fa_entry["launches_examples_lse"] = {label: ln["flash_attention_lse"] for label, ln in ex.items()}
    ws_entry["step_launches_examples"] = {label: ln["window_search_step"] for label, ln in ex.items()}
    log(f"card: {card}")
    mark(22)

    report["kernels"] = kernels
    out = ROOT / "build" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
