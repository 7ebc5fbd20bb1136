#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run it from the repository root with no arguments:

    python3 chip_smoke.py

What it does, in order; any failure ends the run with a non-zero exit code:

1. card     -- prints the GPU's name and power limit as ``nvidia-smi`` gives
               them, and builds the CUDA kernels from ``src/repro_torch/
               kernels/csrc`` with ``nvcc`` (reported as set-up seconds).
2. kernels  -- each of the nine kernels against its plain torch version on
               the GPU, at the shapes its path gives it (K6 with a query
               offset and K7's partial sum at phase 10's rank shapes too).  K1-K4: yolov2
               (26 groups), resnet152 (160), retinanet (119, the widest
               slot map of K1's on-chip state: 7 lanes live at once) and
               efficientnet-b1 (139, with SE side groups); cut-derived and
               random frame masks, all three objectives, duplicated argmin
               keys; K1 also from its chunks' state rows (the prefix
               kernel's, ``PREFIX_CASES``: every chunk of yolov2's space
               at 2^20, four of yolov3's at 2^20 and 64 at 1,024, a
               sub-space with fixed leading cuts) against the plain
               version's whole replay, and without a row at resnet152's
               8,748; K2 at each width of its stores (``enum_frames_plan``:
               16 candidates a thread at yolov2's chunk, 4 at resnet152's
               8,748, 1 at an odd B), at B = 1 and, on the spaces larger
               than 2^32, from ``lo`` = 2^32 - 5; K3 under both of its plans
               (a thread a candidate, and four, ``cost_rows_plan``), on a
               ragged batch (B odd, an odd ``lo``) and on one block (B 200),
               each case three times back to back with the chunk's winner
               taken by its block 0 (K4's reduction, on winner slots that
               the launch must leave NaN) and held against
               ``argmin_rows_torch`` of its rows, and once on a second
               stream.  K5, the float32
               scorer, under both of its kernels (a thread a candidate, and
               a warp a candidate: ``score_batch_plan``): the engine's
               default batch of 1,024 candidates at resnet152's 160 groups,
               a chunk of 1,048,576 at yolov2's 26 and 8 candidates at
               efficientnet-b1's 139 (the largest batch the descent gives
               it), fed K2's masks and K1's io as the pipeline and the
               device engine feed it (masks lane-major and row-major),
               random masks with float32 and int32 io in both layouts,
               B 1 and 3; B at the rule's crossover and either side of it,
               and G 1; under the device replay at B 1, 3 and 8 one
               kernel a call and no copy, by a trace.  Integers must be
               equal and the float64 and float32 rows bit-equal.  The LM
               kernels K6 (flash attention), K7 (fused MLP block) and K9
               (RG-LRU scan) at recurrentgemma-2b's serving shapes (batch 2,
               3,072 tokens, window 2,048; K7 also at decode, M = 2), K6 and
               K7 there in bfloat16 and in float32, at ragged shapes, K6
               with gemma2's soft cap and GQA, K7 ungated and with the
               sandwich norm: within 2e-5 in float32 and 2e-2 in
               bfloat16.  K7 also in float32 at rows wider than its SIMT
               row tiles hold (d > 2,560: the ``simt_wide`` passes):
               gemma2-27b's MLP (d 4,608, F 36,864, gated gelu, sandwich
               norm) at prefill (M 1,024) and decode (M 2), granite-20b's
               (d 6,144, F 24,576, ungated) at M 1,024, each timed beside
               its plain version with its bound.  K6 and K7 also at the
               vlm and audio serves' shapes in bfloat16 (``FAMILY_*``):
               K6 not causal at llama-3.2-vision's cross-attention (B 2,
               S 1,024, T 1,600, 32/8 heads, hd 128), whisper-base's
               encoder (B 4, S = T = 1,500, a ragged last tile) and its
               decoder's cross-attention (S 128, T 1,500); K7 at
               llama-3.2-vision's MLP (d 4,096, F 14,336) at M 2,048 and
               M 2 and whisper's encoder MLP (M 6,000, d 512), each timed
               beside its plain version, K6 beside
               ``scaled_dot_product_attention``, K7 beside its three
               products in ``torch.matmul``, with its bound.  Those K6
               cases draw scores near -6 (``FAMILY_SCORE_SHIFT``), are held
               also within 4 bfloat16 ulps of the largest output, and at
               T 1,500 a planted fault (the plain version over the ragged
               tile's keys zero-padded and unmasked) must fail both
               limits.  K9 bit for bit at the serve's shape, at S shorter
               than its ring, S 3,071, W 2,561, B 1 x W 16 and on
               unaligned rows (its 4-byte copies).  K6 and K7 each pick a kernel by a
               fixed rule (``flash_attention_variant``,
               ``fused_block_variant``):
               bfloat16 runs on the tensor cores, float32 on the SIMT
               kernels; every case states the variant it
               must run, and a ragged bfloat16 case of each reaches the
               tensor cores with every dimension off the tile.  K8 (the
               Mamba-2 SSD scan), on ``y`` and the final state, at
               mamba2-2.7b's serving shape (batch 4, 2,048 tokens, 80 heads
               of 64, state 128, chunk 256) in bfloat16 and float32,
               at a ragged 2,000 tokens from a random initial state, with 8
               groups of heads, and at a ragged chunk, head and state dim,
               each in both types: y within 1e-4 in float32 and 2e-2 in
               bfloat16, the state within 1e-4 in both.  K8 too picks its
               kernel by a fixed rule (``ssd_scan_variant``: bfloat16 on
               the tensor cores, float32 on the SIMT kernel).  Each kernel and
               its plain version are timed with CUDA events; K6 also beside
               ``scaled_dot_product_attention``, K7's prefill beside its
               three bfloat16 products alone in ``torch.matmul``
               (``matmul_ms``); K6, K7 and K8 also beside their SIMT
               kernels on the same bfloat16 inputs, launched by their C
               entry points (``earlier_design_ms``); K8 also in float32
               at the serve's shape (the SIMT kernel).
3. main     -- ``compile_graph`` on the 8 zoo nets in four sweeps: default
               options (``engine="pipeline"`` on ``device="cuda"``, among
               them yolov2@416 with its full space of 7,962,624 cut tuples),
               ``engine="device"``, and both again with
               ``backend="pallas"`` (the float32 scorer).  Each sweep has its
               own launch counts, set to 0 just before it and read just
               after: K1-K3 must have run under ``pipeline``, K1 under
               ``device``, K5 under both ``pallas`` sweeps and K1 under the
               second; in every sweep K4's standalone kernel 0 times and its
               reduction once in each K3 launch (``fused_launches``).  The
               default plans are held against the port's host ``journal``
               engine (against ``pipeline:torch`` on the GPU
               for yolov2, whose space is too large for the host) and pinned
               reference values; the ``pallas`` plans against the same
               compile with ``device="cpu"`` (yolov2's exhaustive plan under
               ``pipeline``, which the scorer never touches, against the
               pinned values).
3b. pool    -- ``core/search_pool.py`` on the card, after phase 3 (CUDA is
               live in this process): one ``ParallelSearchDriver(workers=2)``
               with a defaulted context, which the first search must
               ratchet to spawn.  yolov2@416 (all 7,962,624 tuples, 18
               tasks) under ``pipeline@1048576`` and the four descent nets
               under ``backend="pallas"`` (K5) and ``engine="device"`` (K1),
               each equal to its serial plan of phase 3 with no fault event
               (under ``pallas`` without ``evaluated``: ROADMAP R10); the
               yolov2 search cold and warm.  Launch counts are per process,
               so ``pool_task_probe`` runs each task through ``driver.map``
               with its worker's counts set to 0 just before: every yolov2
               task must launch K1, K2 and K3 (K4 in each K3), every
               descent task K5 or K1, and the probes must merge to the
               plan.  Then a chaos ``kill`` at the last yolov2 prefix
               (the injector reaches spawn workers through the pool's
               initializer): one ``retry`` for it and the same plan; the
               same kill with ``max_retries=0`` under a ``resume_dir``
               raises, and a second search there resumes the journaled
               tasks to the same plan.
3c. service -- ``service.CompileService`` on the card with its default
               options (``pipeline`` on ``device="cuda"``), one thread, a
               cache under ``build/``: the 8 zoo nets at their published
               sizes, each ``request_key`` equal to the JAX package's
               (pinned in ``SERVICE_KEYS``: the standard-library msgpack
               writer's bytes), each a miss whose plan equals phase 3's
               default plan (yolov2 the pinned one), the four exhaustive
               ones launching K2, K1 and K3 (the descent nets score on the
               host under these options, as in phase 3); the 8 again, each a hit that launches nothing and
               whose ``encode_plan`` equals the miss's, with its ms, its
               record's bytes and codec; a second service on the same
               directory serves all 8 as hits; yolov2 on a config with
               half the SRAM budget, a warm-started miss whose plan equals
               a cold compile of it in a fresh cache; a descent net under
               ``backend="pallas"``, a miss that launches K5 and whose hit
               is byte-equal; two threads taking two misses at once
               (yolov2 and resnet152), each equal to its serial record.
4. numerics -- the quickstart pipeline (``examples/quickstart.py``) on the
               card at full width, for each zoo net at its published size:
               compile with ``verify="strict"``, the dry simulator audit
               equal to ``dram_report``, the simulator executed with
               ``init_params`` weights on a seeded input and its output equal
               to ``run_graph``'s on the card bit for bit; at 64 pixels,
               ``run_graph`` on the card within 1e-5 of the output's scale
               of the same on the host (TF32 would miss by ~1e-3).
5. serve    -- ``launch/serve.py::serve`` at full width in bfloat16,
               weights from ``torch.Generator(0)`` on the card, for each
               architecture of ``LM_SERVES``, each with its own launch
               counts, set to 0 just before and read just after:
               recurrentgemma-2b, batch 2, a 3,072-token prompt (over the
               2,048-token window: K6 masks by window and skips tiles,
               decode runs through the ring cache), 16 tokens, exactly K6 8,
               K9 18, K7 416 (K6 and K7 all on the tensor-core kernels);
               then mamba2-2.7b (64 layers, d 2,560, 80 heads of 64, state
               128), batch 4, a 2,048-token prompt, 16 tokens, exactly K8 64
               (all on the tensor-core kernel) and every other kernel 0;
               then moonshot-v1-16b-a3b (48 MoE layers, 64 experts top 6,
               ~55 GB of weights: served with nothing else on the card),
               batch 2, 2,048 tokens, 16 tokens, exactly K6 48 (the
               experts are batched products in torch); llama-3.2-vision-11b
               (32 self- and 8 cross-attention layers over 1,600 patches of
               zeros, as the JAX ``serve()``), batch 2, 1,024 tokens, 16
               tokens, exactly K6 40, K7 640; whisper-base (6 encoder
               layers over 1,500 frames of zeros, 6 decoder layers), batch
               4, 128 tokens, 16 tokens, exactly K6 18, K7 102; all on the
               tensor cores.  Each: prefill / decode seconds, tokens per
               second, peak memory and the serve's bounds (counted from
               the layers that run, ``serve_bounds``); two more runs on
               the same weights (handed in: the serve holds them in place),
               one traced for the kernels' device time.  Then each model
               at full width in float32 at the depth of its check
               (recurrentgemma 4 layers, a 1,024-token prompt; mamba2 4, 1,000 tokens, a ragged last
               chunk; moonshot 2, batch 1, 1,024 tokens, its routes
               compared between the two runs; llama-3.2-vision 5 (one
               pattern cycle), batch 1, 512 tokens, random patches, both
               gates 0.5; whisper-base whole, batch 2, random frames, 128
               tokens): prefill and one decode step through the
               kernels and through their plain versions
               (``ops.plain_versions()``), logits within 1e-3 of their
               scale, with exactly the launches ``LM_SERVES`` states (on
               the SIMT kernels: float32).  Then the same check of
               gemma2-27b (``LM_CHECKS``: not served) at full width, depth
               2 (one local and one global layer), batch 1, 1,024 tokens:
               its MLPs on K7's ``simt_wide`` passes.
7. train    -- after phase 5 and before the report: ``launch/train.py::
               train`` on smollm-360m at its published width and depth (32
               layers, d 960), float32 masters and bfloat16 activations,
               ``remat="full"``, batch 8 x 512 tokens of the synthetic data
               (seed 0), 12 steps of AdamW (lr 6e-4, warmup 4), with its own
               launch counts: exactly K6 and K7 64 a step (the forward and
               the recomputation of each layer), all on the tensor cores,
               nothing else; every loss finite and the last below the
               first; the median step (steps 2-12), tokens per second, peak
               memory; one more step of ``make_train_step`` traced, with
               CUDA events at its marks around the forward, backward and
               optimizer and the device time by kernel; the step's model
               FLOPs (``utils/costmodel.py::cell_cost``) and their share
               of the bfloat16 dense peak at the median step (``mfu``).
               The same run again under ``remat="dots"`` (the products
               with no batch dimension and K7's output kept): exactly K6
               64 and K7 32 a step, each loss within 1e-4 of the
               ``"full"`` run's, the same numbers.  (Phase 5 holds K6
               and K7 at this run's bfloat16 shapes against their plain
               versions.)  Then float32 gradient checks at full width and
               cut depth (smollm-360m 2 layers, once more under
               ``remat="full"`` and once under ``remat="dots"``,
               recurrentgemma-2b 3, also under ``"dots"``, mamba2-2.7b 2;
               batch 2 x 512; ``GRAD_CHECKS``): the loss through the
               kernels within 1e-5 (relative) of the loss under
               ``ops.plain_versions()`` without remat, each parameter's
               gradient within
               1e-3 of its largest magnitude, none missing, K6-K9 each
               launched as pinned (K9 also in the backward).  Then the
               restart: smollm-360m at depth 2, 6 steps straight against 3,
               a checkpoint and a fresh ``train()`` resuming at 3, losses
               at steps 3-5 within 1e-4; the checkpoint's bytes, read and
               write seconds, and its parameters equal to the 3-step run's.
8. examples -- after phase 7: the four example twins
               (``examples/{quickstart,serve_compile,serve_lm,train_lm}
               _torch.py``) on the card at their defaults, each through its
               ``main`` in this process, with its own launch counts and a
               line with its wall seconds and its last printed line; the
               service's cache and the trainer's checkpoints in fresh
               directories under ``build/``.
9. mesh     -- after phase 8: ``launch/dryrun.py`` on both production
               meshes (the 32 valid cells each, analytic; the fit judged
               against this card's memory), one line a cell; its per-device
               parameter and cache bytes of recurrentgemma-2b's and
               whisper-base's phase-5 serves on a 1 x 1 mesh, each part
               on its own: the bytes of the tensors placed equal to the
               prediction (the cache's position, a host int, aside), and
               the rise in ``torch.cuda.memory_allocated()`` equal to the
               caching allocator's blocks of those tensors in its
               snapshot and within the allocator's computed rounding
               bound; the total within 1 %.  Then an NCCL process group
               of one rank from a ``FileStore`` (``device_id`` cuda:0), in
               which recurrentgemma-2b is served whole (batch 2, 512 + 8
               tokens) on mesh (1, 1) -- its plan is FSDP, every weight
               read through an all-gather -- and without a mesh: tokens
               and logits bit-equal, the same launches (K6, K7 and K9
               among them), then each once more under ``torch.profiler``
               (a line of where the two serves' host and device time
               go); and smollm-360m trained whole as phase 7 trains it,
               3 steps under ``remat="full"``, on mesh (1, 1) with FSDP
               forced on and without a mesh: every loss bit-equal, the
               same launches (K6, K7); a checkpoint of the mesh run's
               state then raises the device's peak by less than the
               model's float32 parameters (one leaf gathered at a time).
               Before the group, the traced half of the dry-run
               (``dryrun.trace_cell``: the step run once on fake tensors
               on a process group of fake ranks, started and destroyed)
               on mesh (1, 1) for smollm-360m's train step (8 x 512,
               ``"full"``) and recurrentgemma-2b's prefill (2 x 3,072);
               inside the group each step on the card: the traced peak
               within ``MESH_TRACE_TOL`` of the rise of
               ``torch.cuda.max_memory_allocated()`` over the step, one
               line each.  The group is destroyed before the phase ends; the
               ``kernels`` line gains each kernel's
               ``launches_in_mesh_phase``.
10. model axis -- after phase 9: tensor parallelism over a mesh's
               ``model`` axis, mesh (1, 2) as two rank processes of this
               script (``--model-axis-rank``) on the one card, joined over
               gloo with a ``FileStore`` (NCCL refuses two ranks on one
               device; each collective one gloo call on CUDA tensors, no
               copy through the host).  Every case runs
               first in this process without a mesh, then on the ranks:
               recurrentgemma-2b served (``tp`` plan, 5 heads a rank, the
               ring cache split by sequence; K6, K7's partial form, K9),
               smollm-360m served with ``cp=True`` (``hybrid`` plan; K6
               with a query offset, K7's partial form) and trained 3 steps
               at 8 x 512, mamba2-2.7b served (40 heads a rank; K8) and
               moonshot-v1-16b-a3b served at 24 of its 48 layers (32
               experts a rank, the dispatch by all-to-all; K6); and
               recurrentgemma-2b again with Megatron-SP (``seq_shard``:
               the stream between blocks split by sequence, K6, K7's
               partial form and K9 on the gathered sequence), held to the
               ranks' run without SP: float32 logits within 1e-5 of
               their scale, bf16 tokens equal, the same launches, each
               rank's peak beside the run without SP, and one prefill
               and one decode step whose collectives by kind equal their
               traces' on two fake ranks.  Each in
               float32 at cut depth (mamba2-2.7b at its full 64 layers,
               and there also the run without a mesh against itself
               through the plain versions): logits (or losses) within 1e-4 of
               their scale of the run without a mesh, and a planted fault
               (rank 1's MLP shard of the first layer zeroed; the cp
               slices run from position 0) must fail that check; and in
               bfloat16 at full width: walls, launches a rank by kernel,
               variant and form (each kernel of the path above 0 on every
               rank), the collectives' host seconds, peak allocated bytes and
               token agreement with the run without a mesh (mamba2's also
               beside that run's own spread, kernels against plain
               versions, which rounding alone makes over 64 layers).
               Every rank's placed parameters and cache equal
               ``dryrun.shard_bytes``.
               ``compressed_psum`` over the ``pod`` group of a (2, 1, 1)
               mesh equals its plain formula on 2^20 random gradients a
               rank, and gives the reference's values on R11's vectors.
               Every collective of CUDA tensors the cases made (operation,
               dtype, shape, group size, reduction) is run once more by
               gloo on fresh data and must equal its plain result on
               every rank (one line), so a gloo that refuses or garbles
               one fails the phase.
               A second world, mesh (1, 3) as three rank processes on
               the card (gloo): qwen3-moe-235b-a22b at full width, 2 of
               its 94 layers, served 2 x 2,048 + 16 in bf16 (64 heads and
               128 experts do not divide by 3, ``d_ff`` 1,536 does: the
               ``hybrid`` plan, attention whole on every rank, the
               experts' ``ff`` split, the MoE's local path with the
               partial down products summed over ``model``; K6 and no
               other kernel, all ``tensor_core``), its float32 check at
               depth 1 (1 x 512, capacity factor E / K) within 1e-4, and
               its planted fault (the ``ff`` partials left unreduced)
               caught; placed bytes, walls, transport and peaks a rank
               as above.
               The ``kernels`` line gains the two forms and each LM
               kernel's ``launches_in_model_axis_phase``.
6. report   -- wall and candidates per second of each compile, the execute
               times; the yolov2 compile again, 5 runs for the median wall
               and one run traced with ``torch.profiler`` for the card's busy
               share; the pool's walls beside that median, its workers'
               memory on the card and ``os.cpu_count()``; one JSON line
               listing the kernels (times, bounds, launches per sweep,
               serve and training run), the card line, and a last line
               ``{"ok": true, "device": {...}}``.

The chunk of the pipeline engine is ``CHUNK`` candidates (``@1048576``): the
option's default of 1024 is sized for the host scorer.

It imports ``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import io
import os
import runpy
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHUNK = 1 << 20

# NVIDIA H100 SXM peaks the bounds are computed against: device memory rate,
# and the vector (non tensor core) rates for the two operation types these
# kernels use.  int32 issues at half the float32 rate of 67 TFLOP/s; float64
# is the data sheet's 34 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 33.5e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_F64_OPS_PER_S = 34e12
# dense tensor-core rate for bfloat16 products (the LM kernels' bound on
# bfloat16 inputs; float32 inputs are held to PEAK_F32_OPS_PER_S)
PEAK_BF16_OPS_PER_S = 989e12

# What the JAX package's ``pipeline:reference`` engine returns for
# yolov2@416 (exhaustive over all 7,962,624 tuples), and its winners for the
# two ResNets.
YOLOV2_PINNED = {
    "cuts": (2, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 3, 2, 1, 0),
    "evaluated": 7962624, "path": "exhaustive",
    "latency_cycles": 5728364.05, "dram_total": 55686129,
    "dram_fm": 4744337, "sram_total": 5131776, "bram18k": 3904,
    "feasible": True,
}
RESNET_PINNED = {"cuts": (5, 0, 2, 0, 2, 0, 1, 0), "evaluated": 8748}

KERNEL_INFO = {
    "alloc_scan": {
        "source": "src/repro_torch/kernels/csrc/alloc_scan.cu",
        "replaces": "src/repro/kernels/alloc_scan.py:492"},
    # K1's shared prefix: the state a chunk's candidates share, replayed
    # once a chunk (one launch a sub-space); the TPU kernel replays every
    # group for every candidate
    "alloc_prefix": {
        "source": "src/repro_torch/kernels/csrc/alloc_scan.cu",
        "replaces": None},
    "enum_frames": {
        "source": "src/repro_torch/kernels/csrc/search_pipeline.cu",
        "replaces": "src/repro/kernels/search_pipeline.py:448"},
    "cost_rows": {
        "source": "src/repro_torch/kernels/csrc/search_pipeline.cu",
        "replaces": "src/repro/kernels/search_pipeline.py:490"},
    "argmin_rows": {
        "source": "src/repro_torch/kernels/csrc/search_pipeline.cu",
        "replaces": "src/repro/kernels/search_pipeline.py:592",
        # on the main path K4's reduction runs in K3's block 0; the
        # standalone kernel serves argmin_lanes and argmin_rows
        "fused_into": "cost_rows_kernel / cost_rows_split_kernel: "
                      "finish_block -> chunk_winner",
        "standalone": "argmin_rows_kernel -> rows_argmin"},
    "score_batch": {
        "source": "src/repro_torch/kernels/csrc/score_batch.cu",
        "replaces": "src/repro/kernels/score_batch.py:149",
        # score_batch_plan: a warp a candidate below two blocks an SM of the
        # thread-a-candidate kernel (every batch of the main path)
        "variants": {
            "thread": "src/repro_torch/kernels/csrc/score_batch.cu",
            "split": "src/repro_torch/kernels/csrc/score_batch.cu"},
        "kernels": {"thread": "score_batch_kernel",
                    "split": "score_batch_split_kernel"}},
    # K6, K7 and K8: "source" is the kernel of the bfloat16 prefill (the
    # serve's main path); "variants" every source the wrapper picks from
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "variants": {
            "tensor_core":
                "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
            "simt": "src/repro_torch/kernels/csrc/flash_attention.cu"}},
    "fused_block": {
        "source": "src/repro_torch/kernels/csrc/fused_block_tc.cu",
        "replaces": "src/repro/kernels/fused_block.py:37",
        "variants": {
            "tensor_core": "src/repro_torch/kernels/csrc/fused_block_tc.cu",
            "simt": "src/repro_torch/kernels/csrc/fused_block.cu",
            "simt_split": "src/repro_torch/kernels/csrc/fused_block.cu",
            "simt_wide": "src/repro_torch/kernels/csrc/fused_block.cu"}},
    "ssd_scan": {
        "source": "src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:26",
        "variants": {
            "tensor_core": "src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
            "simt": "src/repro_torch/kernels/csrc/ssd_scan.cu"}},
    "rglru_scan": {
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:25"},
}
# K5's shapes: the engine's default batch at the widest zoo net, one
# pipeline chunk at yolov2's groups, and the largest batch the descent gives
# it on the main path (a sweep's trials, 1 to 8 candidates)
SCORER_SHAPES = (("resnet152", 1024), ("yolov2", CHUNK),
                 ("efficientnet-b1", 8))
# the four sweeps of the main path: (engine, backend, exhaustive limits,
# kernels that must have launched); K4 runs inside K3's launches
PIPELINE_KERNELS = ("alloc_scan", "enum_frames", "cost_rows", "argmin_rows")
SWEEPS = (("pipeline", "numpy", {}, ("alloc_scan", "alloc_prefix",
                                     "enum_frames", "cost_rows")),
          ("device", "numpy", {"yolov2": 100000}, ("alloc_scan",)),
          ("pipeline", "pallas", {}, ("score_batch",)),
          ("device", "pallas", {"yolov2": 100000},
           ("alloc_scan", "score_batch")))


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------- card
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the GPU, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kernel, plain, reps) -> dict:
    """``{"ms", "plain_ms"}``: CUDA-event times of a kernel and its plain
    version taken in turns (plain, kernel, kernel, plain), the less of
    each pair."""
    p1 = time_ms(plain, reps=2)
    k1 = time_ms(kernel, reps=reps, warmup=1)
    k2 = time_ms(kernel, reps=reps, warmup=0)
    p2 = time_ms(plain, reps=2, warmup=0)
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2)}


def device_time_by_kernel(prof) -> dict:
    """``{kernel: {"count", "device_ms"}}`` from a ``torch.profiler`` trace
    (empty when the trace holds no device time)."""
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0))
        if dev_us and "kernel" in ev.key:
            name = ev.key.split("::")[-1].split("(")[0]
            by_kernel[name] = {"count": ev.count, "device_ms": dev_us / 1e3}
    return by_kernel


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * n_ops / ops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# Operations of one allocator step as core/allocator.py::alloc_step states
# it, counted one per compare, add, maximum or select with buffers addressed
# by index (not this kernel's unrolled three-way forms):
#   a main-path step -- main operand in a buffer? (1), first free buffer (3),
#     fetch needed? (1), input buffer maximum (2), boundary reads into io and
#     bfm (2), final output? with its write into io, bfm, wrf (5), first
#     free buffer that holds no operand (3), take-over of the main operand's
#     buffer (3), claim or spill with its bytes and feasibility (5), owner and
#     buffer maximum (2), location (1): 28; a shortcut adds its buffer's
#     maximum (2);
#   each producer it consumes -- in DRAM? and its read bytes (2), mark its
#     buffer (1), consume (1), row-mode boundary write into io, bfm, wrf (5),
#     dead? owner? release (3): 12;
#   a side step -- side maximum and location (2); each producer: consume,
#     dead? owner? release (4).
ALLOC_OPS_STEP, ALLOC_OPS_SHORTCUT, ALLOC_OPS_PRODUCER = 28, 2, 12
ALLOC_OPS_SIDE_STEP, ALLOC_OPS_SIDE_PRODUCER = 2, 4


def alloc_ops_per_candidate(at) -> int:
    """Integer operations one candidate's replay needs on this graph."""
    side = at.is_side.astype(bool)
    fan_in = (at.gin != at.sink_idx).sum(axis=1)
    shortcuts = int((at.sc[~side] != at.sink_idx).sum())
    return int((~side).sum() * ALLOC_OPS_STEP
               + shortcuts * ALLOC_OPS_SHORTCUT
               + fan_in[~side].sum() * ALLOC_OPS_PRODUCER
               + side.sum() * ALLOC_OPS_SIDE_STEP
               + fan_in[side].sum() * ALLOC_OPS_SIDE_PRODUCER)


def kernel_bounds(B: int, G: int, free_runs: int, L: int,
                  alloc_ops: int) -> dict:
    """The least time the card could take for each kernel's work at these
    shapes: each input read once, each output written once, against the
    operations the function itself needs per candidate (not the
    instructions this implementation spends on them)."""
    return {
        # frame bits in; io (int32) and 7 stats out; the step rule's
        # operations, counted by alloc_ops_per_candidate
        "alloc_scan": bound(B * G + 4 * B * G + 28 * B, B * alloc_ops,
                            PEAK_INT32_OPS_PER_S),
        # one byte out per candidate and group; one divide and one modulo
        # per enumerated run (a fixed prefix run needs none), a compare and
        # a direction select per group
        "enum_frames": bound(B * G, B * (2 * free_runs + 3 * G),
                             PEAK_INT32_OPS_PER_S),
        # mask (1 B) + io (4 B) per candidate and group and 7 stats in, one
        # 32-byte row per block of 256 out; ~8 float64 operations per group
        "cost_rows": bound(5 * B * G + 28 * B + 32 * (-(-B // 256)),
                           B * (8 * G + 16), PEAK_F64_OPS_PER_S),
        # L rows of 32 bytes in, one out; up to 4 compares per row
        "argmin_rows": bound(32 * L + 32, 4 * L, PEAK_F64_OPS_PER_S),
    }


def scorer_bound(B: int, G: int):
    """K5: a mask byte and four io bytes per candidate and group and the
    nine float32 table rows in, six float32 stats per candidate out; about
    14 float32 operations per group (the latency term: add, divide,
    maximum, add, two selects, the sum; the row-mode term: select, add;
    the four masked maxima and their masks)."""
    return bound(5 * B * G + 36 * G + 24 * B, 14 * B * G, PEAK_F32_OPS_PER_S)


# --------------------------------------------------------- kernels vs plain
def make_engine(net: str):
    from repro_torch.cnn import build_cnn
    from repro_torch.core.cutpoint import CutpointEngine
    from repro_torch.core.grouping import group_nodes
    from repro_torch.core.hw import KCU1500
    gg = group_nodes(build_cnn(net))
    return CutpointEngine(gg, KCU1500, engine="pipeline:cuda", device="cuda")


def check_space(engine, target: int):
    """The whole cut space when it has at most ``target`` tuples, else the
    sub-space of the trailing runs that does (leading cuts fixed mid-run)."""
    from repro_torch.kernels.search_pipeline import SubSpace
    dims = [len(r) + 1 for r in engine.runs]
    size, q = 1, len(dims)
    while q > 0 and size * dims[q - 1] <= target:
        q -= 1
        size *= dims[q]
    prefix = tuple(len(r) // 2 for r in engine.runs[:q])
    return SubSpace.make(prefix, dims[q:], "cuda")


# K3's two kernels, by the plan's ``split``
COST_PLANS = {False: "a thread a candidate", True: "split"}


def fuzz_lanes(gen, n: int):
    """Key lanes designed to tie (tiny value sets), (4, n) float64."""
    import torch

    def pick(values):
        v = torch.tensor(values, dtype=torch.float64, device="cuda")
        return v[torch.randint(len(values), (n,), generator=gen,
                               device="cuda")]

    idx = torch.randperm(10 * n, generator=gen, device="cuda")[:n]
    return torch.stack([pick([0.0, 1.0]), pick([3.0, 7.0, 7.0, 11.0, 1e9]),
                        pick([2.0, 5.0, 5.0, 123456.0]),
                        idx.to(torch.float64)])


def max_abs_err(got, want) -> float:
    import torch
    return float((got.to(torch.float64) - want.to(torch.float64))
                 .abs().max()) if got.numel() else 0.0


def check_kernels(net: str, target: int, timed: bool, reps: int) -> dict:
    """Every kernel against its plain version on the GPU at ``net``'s
    shapes; returns per-kernel ``{"max_abs_err", "ms", "plain_ms", ...}``."""
    import torch
    from repro_torch.kernels import alloc_scan as scan
    from repro_torch.kernels import search_pipeline as pipe

    engine = make_engine(net)
    tbl = pipe._engine_tables(engine)
    at = engine.alloc_tables()
    space = check_space(engine, target)
    B = min(CHUNK, space.size)
    lo = space.size - B                   # the ragged end of the space
    G, nr = tbl.n, len(engine.runs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1000 + G)
    errs = {name: 0.0 for name in PIPELINE_KERNELS}

    def same(name, got, want, what, bits=False):
        require(got.shape == want.shape,
                f"{net} {name} {what}: shape {tuple(got.shape)} != "
                f"{tuple(want.shape)}")
        errs[name] = max(errs[name], max_abs_err(got, want))
        if bits:
            ok = torch.equal(got.contiguous().view(torch.int64),
                             want.contiguous().view(torch.int64))
        else:
            ok = torch.equal(got.to(torch.int64), want.to(torch.int64))
        require(ok, f"{net} {name} {what}: kernel != plain version "
                    f"(max abs err {errs[name]})")

    # K2 enumeration: the chunk, an odd B (one candidate a thread), B = 1,
    # and across 2^32 on a space that holds it
    frame_k = pipe.enum_frames_cuda(tbl, space, lo, B)
    frame_p = pipe.enum_frames_torch(tbl, space, lo, B)
    same("enum_frames", frame_k, frame_p,
         f"masks, V {pipe.enum_frames_plan(B)}")
    enum_cases = [(space, lo + 1, B - 1 - B % 2), (space, lo, 1)]
    full = pipe.SubSpace.make((), [len(r) + 1 for r in engine.runs], "cuda")
    if full.size > (1 << 32) + 4096:
        enum_cases += [(full, (1 << 32) - 5, 4096),
                       (full, (1 << 32) - 5, 4093)]
    for sp, lo_e, count in enum_cases:
        if count > 0:
            same("enum_frames", pipe.enum_frames_cuda(tbl, sp, lo_e, count),
                 pipe.enum_frames_torch(tbl, sp, lo_e, count),
                 f"masks, V {pipe.enum_frames_plan(count)}, lo {lo_e}, "
                 f"B {count}")

    # K1 allocator replay: cut-derived masks and random masks
    rand = (torch.rand((B, G), generator=gen, device="cuda")
            < torch.rand((B, 1), generator=gen, device="cuda"))
    runs = {}
    for what, frame in (("cut masks", frame_k), ("random masks", rand)):
        res_k = scan.alloc_scan_cuda(at, frame)
        res_p = scan.alloc_scan_torch(at, frame)
        same("alloc_scan", res_k.io, res_p.io, f"{what} io")
        same("alloc_scan", res_k.stats, res_p.stats, f"{what} stats")
        runs[what] = (frame, res_k, res_p)
    for b in (1, 3):                       # B = 1 and a ragged batch
        res_k = scan.alloc_scan_cuda(at, rand[:b])
        res_p = scan.alloc_scan_torch(at, rand[:b])
        same("alloc_scan", res_k.io, res_p.io, f"B={b} io")
        same("alloc_scan", res_k.stats, res_p.stats, f"B={b} stats")

    # K3 cost rows, three objectives, fed by the kernel's and by the plain
    # version's replay (int32 lane-major and int64 row-major inputs); each
    # launch three times back to back, each taking the chunk's winner in its
    # block 0 (the winner slots must be NaN again for the next)
    def cost_case(frame, res, lo_c, objective, split, want, what):
        wins = [torch.empty(4, dtype=torch.float64, device="cuda")
                for _ in range(3)]
        for win in wins:
            got = pipe.cost_rows_cuda(tbl, frame, res.io, res.stats, lo_c,
                                      objective, split=split, winner=win)
        same("cost_rows", got, want, f"{what}, {COST_PLANS[split]}",
             bits=True)
        best = pipe.argmin_rows_torch(want)
        for k, win in enumerate(wins):
            same("argmin_rows", win, best,
                 f"{what}, {COST_PLANS[split]}: chunk winner of launch "
                 f"{k + 1} of 3 in K3's block 0", bits=True)
        require(bool(torch.isnan(pipe._winner_slots(tbl.device, 1)).all()),
                f"{what}, {COST_PLANS[split]}: the winner slots were not "
                f"left NaN")

    rows_main = None
    for what, (frame, res_k, res_p) in runs.items():
        for objective in pipe.OBJECTIVES:
            want = pipe.cost_rows_torch(tbl, frame, res_p.io, res_p.stats,
                                        lo, objective)
            for feed, res in (("kernel-fed", res_k), ("plain-fed", res_p)):
                for split in (False, True):
                    cost_case(frame, res, lo, objective, split, want,
                              f"{what} {objective} {feed}")
            if what == "cut masks" and objective == "latency":
                rows_main = want
    # a ragged batch from an odd lo: B odd (a multiple of neither 4 nor 16),
    # the last block short; and one block's worth
    frame, res_k, res_p = runs["random masks"]
    off = 7 if lo % 2 == 0 else 8
    n_odd = B - off - (B - off + 1) % 2
    for start, count in ((off, n_odd), (0, min(200, B))):
        if count <= 0:
            continue
        sub = slice(start, start + count)
        for objective in pipe.OBJECTIVES:
            want = pipe.cost_rows_torch(tbl, frame[sub], res_p.io[sub],
                                        res_p.stats[sub], lo + start,
                                        objective)
            part = scan.AllocScanResult(io=res_k.io[sub],
                                        stats=res_k.stats[sub])
            for split in (False, True):
                cost_case(frame[sub], part, lo + start, objective, split,
                          want, f"B={count} lo={lo + start} {objective}")
    # a second stream has its own winner slots
    frame, res_k, res_p = runs["cut masks"]
    main_slots = pipe._winner_slots(tbl.device, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        win = torch.empty(4, dtype=torch.float64, device="cuda")
        pipe.cost_rows_cuda(tbl, frame, res_k.io, res_k.stats, lo, "latency",
                            winner=win)
        require(pipe._winner_slots(tbl.device, 1).data_ptr()
                != main_slots.data_ptr(), "two streams share winner slots")
    torch.cuda.current_stream().wait_stream(side)
    same("argmin_rows", win, pipe.argmin_rows_torch(rows_main),
         "chunk winner on a second stream", bits=True)

    # K4 argmin: the cost stage's rows, and keys stuffed with duplicates
    lanes_list = [rows_main] + [fuzz_lanes(gen, n)
                                for n in (1, 2, 255, 256, 257, 4096, 100003)]
    for lanes in lanes_list:
        same("argmin_rows", pipe.argmin_rows_cuda(lanes),
             pipe.argmin_rows_torch(lanes), f"L={lanes.shape[1]}", bits=True)
    torch.cuda.synchronize()

    out = {"net": net, "B": B, "G": G, "runs": nr, "L": rows_main.shape[1],
           "alloc_slots": at.slots.width, "errs": errs}
    if not timed:
        return out
    frame, res_k, res_p = runs["cut masks"]
    win = torch.empty(4, dtype=torch.float64, device="cuda")
    # K3 as the main path runs it: with the chunk's winner
    cases = {
        "enum_frames": (lambda: pipe.enum_frames_cuda(tbl, space, lo, B),
                        lambda: pipe.enum_frames_torch(tbl, space, lo, B)),
        "alloc_scan": (lambda: scan.alloc_scan_cuda(at, frame),
                       lambda: scan.alloc_scan_torch(at, frame)),
        "cost_rows": (lambda: pipe.cost_rows_cuda(tbl, frame, res_k.io,
                                                  res_k.stats, lo, "latency",
                                                  winner=win),
                      lambda: pipe.cost_rows_torch(tbl, frame, res_p.io,
                                                   res_p.stats, lo,
                                                   "latency", winner=win)),
        "argmin_rows": (lambda: pipe.argmin_rows_cuda(rows_main),
                        lambda: pipe.argmin_rows_torch(rows_main)),
    }
    bounds = kernel_bounds(B, G, len(space.dims), rows_main.shape[1],
                           alloc_ops_per_candidate(at))
    out["alloc_ops_per_candidate"] = alloc_ops_per_candidate(at)
    out["times"] = {}
    for name, (kernel, plain) in cases.items():
        # in turns: plain, kernel, kernel, plain
        p1 = time_ms(plain, reps=2)
        k1 = time_ms(kernel, reps=reps, warmup=2)
        k2 = time_ms(kernel, reps=reps, warmup=0)
        p2 = time_ms(plain, reps=2, warmup=0)
        out["times"][name] = {
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
    # K3 under each of its plans (the plan's own is "ms")
    out["times"]["cost_rows"]["plan"] = COST_PLANS[
        pipe.cost_rows_plan(B, sms=pipe._sm_count(0)).split]
    out["times"]["cost_rows"]["at_plans"] = {
        COST_PLANS[split]: min(time_ms(lambda: pipe.cost_rows_cuda(
            tbl, frame, res_k.io, res_k.stats, lo, "latency", split=split),
            reps=reps, warmup=1) for _ in range(2))
        for split in (False, True)}
    # K3 against the groups it prices: the same candidates, the first k
    # groups only (k = 0 leaves the stats, the block argmin and the launch)
    by_groups = {}
    for k in sorted({0, G // 4, G // 2, G}):
        part = dataclasses.replace(tbl, n=k, tab=tbl.tab[:, :k].contiguous())
        f_k, io_k = frame[:, :k], res_k.io[:, :k]
        by_groups[k] = min(time_ms(lambda: pipe.cost_rows_cuda(
            part, f_k, io_k, res_k.stats, lo, "latency"), reps=reps,
            warmup=1) for _ in range(2))
    out["times"]["cost_rows"]["by_groups"] = by_groups
    # and the device time alone, from a trace (at a small B the wrapper's
    # host time exceeds the kernel's, and "ms" times the wrapper); K3 also
    # without the winner, for the cost of its last block's epilogue
    for name in cases:
        out["times"][name]["device_ms"] = traced_ms(cases[name][0], name,
                                                    reps)
    out["times"]["cost_rows"]["device_ms_without_winner"] = traced_ms(
        lambda: pipe.cost_rows_cuda(tbl, frame, res_k.io, res_k.stats, lo,
                                    "latency"), "cost_rows", reps)
    out["times"]["enum_frames"]["vec"] = pipe.enum_frames_plan(B)
    return out


# K1 from its state rows: (net, chunk, chunks checked -- None: all, else
# that many spread over the space from the first to the last, sub-space --
# None: the whole space, else its size with the leading cuts fixed mid-run,
# check_space)
PREFIX_CASES = (("yolov2", CHUNK, None, None), ("yolov3", CHUNK, 4, None),
                ("yolov3", 1024, 64, None), ("yolov2", 4096, 8, 20000),
                ("mobilenet-v3", CHUNK, 4, None))
# the nets whose first whole chunk of 2^20 is timed by CUDA events
PREFIX_TIMED = ("yolov3", "mobilenet-v3", "yolov2")
# K1 without a row at resnet152's 8,748 candidates, device ms from a trace,
# before the state rows came a block of candidates at a time: the path
# without a row should be no slower (logged on its own line)
NO_ROW_RESNET152_MS = 0.1169


def check_alloc_prefix(timed: bool, reps: int) -> dict:
    """K1 started from the state rows (``alloc_prefix_cuda``, one launch a
    space) at the block of D candidates that ``row_grain`` picks, each
    row's ``g0`` its ``g1``, against the plain version's whole replay of
    the same chunk's masks, every integer equal.  Rows of another grain
    too: a row a chunk, each row's ``g0`` equal to ``shared_prefix``'s,
    K1 from them on each chunk and on a launch straddling two chunks whose
    ``g0`` differ (each thread from its own row's group).  Then K1 without
    a row over resnet152's whole space (8,748 candidates), and from a row a
    candidate there.  Timed, by CUDA events: the prefix launch and K1 from
    its rows and without a row, at the first chunk of 2^20 of yolov3,
    mobilenet-v3 and yolov2, and K1 at resnet152; the same at yolov3 and
    resnet152 from a trace."""
    import torch
    from repro_torch.kernels import alloc_scan as scan
    from repro_torch.kernels import search_pipeline as pipe

    def whole(engine):
        return pipe.SubSpace.make((), [len(r) + 1 for r in engine.runs],
                                  "cuda")

    def equal(got, want, what):
        require(torch.equal(got.io.to(torch.int64), want.io)
                and torch.equal(got.stats.to(torch.int64), want.stats),
                f"{what}: K1 != the plain version's whole replay")

    out, timed_at = {}, {}
    for net, chunk, picks, target in PREFIX_CASES:
        engine = make_engine(net)
        tbl = pipe._engine_tables(engine)
        at = engine.alloc_tables()
        space = whole(engine) if target is None else check_space(engine,
                                                                 target)
        grain = pipe.row_grain(space, engine._run_of, chunk,
                               4 * scan.state_row_width(at))
        require(grain is not None, f"{net} at {chunk}: no rows fit")
        D, g1 = grain
        rows = scan.alloc_prefix_cuda(at, tbl, space, chunk)
        blocks = scan.alloc_prefix_cuda(at, tbl, space, D)
        require(bool((blocks[:, 0] == g1).all()),
                f"{net} at {chunk}: a row of a block of {D} does not "
                f"start at g1 {g1}")
        n_chunks = rows.shape[0]
        picked = (range(n_chunks) if picks is None else sorted(
            {round(i * (n_chunks - 1) / (picks - 1)) for i in range(picks)}))
        g0s = set()
        for k in picked:
            lo = k * chunk
            count = min(chunk, space.size - lo)
            frame = pipe.enum_frames_cuda(tbl, space, lo, count)
            g0 = int(rows[k, 0])
            what = f"{net} at {chunk}, chunk {k} of {n_chunks} (g0 {g0})"
            require(g0 == pipe.shared_prefix(space, engine._run_of, lo,
                                             count),
                    f"{what}: the prefix kernel's g0 != shared_prefix's")
            want = scan.alloc_scan_torch(at, frame)
            equal(scan.alloc_scan_cuda(at, frame,
                                       scan.StateRows(blocks, D, lo)),
                  want, f"{what}, rows a block of {D}")
            equal(scan.alloc_scan_cuda(at, frame,
                                       scan.StateRows(rows, chunk, lo)),
                  want, f"{what}, its chunk's row")
            g0s.add(g0)
            if net in PREFIX_TIMED and chunk == CHUNK and k == 0:
                timed_at[net] = (at, tbl, space, frame, D, blocks)
        # a launch across the first boundary where the chunks' g0 change,
        # up to 4,100 candidates each side, so a block of K1's threads
        # reads two rows that start at different groups
        starts = rows[:, 0].tolist()
        edge = next((k for k in range(1, n_chunks)
                     if starts[k] != starts[k - 1]), None)
        if edge is not None:
            lo = max(0, edge * chunk - 4100)
            frame = pipe.enum_frames_cuda(tbl, space, lo,
                                          min(8200, space.size - lo))
            equal(scan.alloc_scan_cuda(at, frame,
                                       scan.StateRows(rows, chunk, lo)),
                  scan.alloc_scan_torch(at, frame),
                  f"{net} at {chunk}, across chunk {edge}'s start "
                  f"(g0 {starts[edge - 1]} then {starts[edge]})")
        name = f"{net}@{chunk}" + ("" if target is None
                                   else f" of {space.size}")
        out[name] = {"chunks": n_chunks, "checked": len(picked),
                     "g0": sorted(g0s), "groups": tbl.n, "block": D,
                     "g1": g1, "straddling": sum(k * chunk % D != 0
                                                 for k in picked),
                     "across_g0_change": edge}
    engine = make_engine("resnet152")
    r_at = engine.alloc_tables()
    space = whole(engine)
    r_tbl = pipe._engine_tables(engine)
    r_frame = pipe.enum_frames_cuda(r_tbl, space, 0, space.size)
    r_want = scan.alloc_scan_torch(r_at, r_frame)
    equal(scan.alloc_scan_cuda(r_at, r_frame), r_want,
          f"resnet152, B {space.size}, no row")
    out["resnet152 no row"] = {"B": space.size}
    # a row a candidate, each at g0 = G: the most rows a block of K1 copies
    # (33 rows of 338 words for a block of 32 threads), and a replay of no
    # group
    ones = scan.alloc_prefix_cuda(r_at, r_tbl, space, 1)
    require(bool((ones[:, 0] == r_at.n).all()),
            "resnet152, a row a candidate: a row's g0 is not G")
    equal(scan.alloc_scan_cuda(r_at, r_frame, scan.StateRows(ones, 1)),
          r_want, f"resnet152, B {space.size}, a row a candidate")
    torch.cuda.synchronize()
    if not timed:
        return out
    out["event_ms"] = {}
    for net, (at, tbl, space, frame, D, blocks) in timed_at.items():
        out["event_ms"][net] = {
            "block": D,
            "alloc_prefix": time_ms(lambda: scan.alloc_prefix_cuda(
                at, tbl, space, D), reps),
            "alloc_scan_from_rows": time_ms(lambda: scan.alloc_scan_cuda(
                at, frame, scan.StateRows(blocks, D)), reps),
            "alloc_scan_no_row": time_ms(lambda: scan.alloc_scan_cuda(
                at, frame), reps)}
    out["event_ms"]["resnet152 no row"] = {"alloc_scan_no_row": time_ms(
        lambda: scan.alloc_scan_cuda(r_at, r_frame), reps)}
    at, tbl, space, frame, D, blocks = timed_at["yolov3"]
    out["device_ms"] = {
        "alloc_prefix": traced_ms(lambda: scan.alloc_prefix_cuda(
            at, tbl, space, D), "alloc_prefix", reps),
        "alloc_scan_from_row": traced_ms(lambda: scan.alloc_scan_cuda(
            at, frame, scan.StateRows(blocks, D)), "alloc_scan", reps),
        "alloc_scan_no_row": traced_ms(lambda: scan.alloc_scan_cuda(
            at, frame), "alloc_scan", reps),
        "alloc_scan_resnet152_no_row": traced_ms(lambda: scan.alloc_scan_cuda(
            r_at, r_frame), "alloc_scan", reps)}
    # so short a launch runs at the pace the host launches it through the
    # wrapper, which the events time with it: the trace's time is the
    # device's
    no_row = out["device_ms"]["alloc_scan_resnet152_no_row"]
    no_slower = (no_row <= NO_ROW_RESNET152_MS if isinstance(no_row, float)
                 else "not measured")
    log(f"K1 without a row at resnet152 (B {r_frame.shape[0]}): {no_row} "
        f"ms device from a trace; {NO_ROW_RESNET152_MS} ms before the state "
        f"rows came a block of candidates at a time: no slower {no_slower}")
    return out


def traced_ms(fn, name: str, reps: int):
    """Device milliseconds of one launch of ``fn``, from a ``torch.profiler``
    trace of ``reps`` launches, the kernels of wrapper ``name`` matched by
    substring (a templated kernel's name carries its arguments)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    traced = [v for key, v in device_time_by_kernel(prof).items()
              if any(n in key for n in TRACE_NAMES[name])]
    return (sum(v["device_ms"] for v in traced)
            / sum(v["count"] for v in traced) if traced else "not measured")


def scorer_cases(frame, io, rand, rio):
    """K5's inputs at one shape, by name: K2's lane-major masks with K1's
    lane-major int32 io (the layout of the device replay, whose host mask
    matrix is column-major, and of the pipeline), the same masks
    row-major, random row-major masks with float32 io (the journal
    replay's host matrices as they lie), both lane-major, int32 io
    row-major beside lane-major masks, B = 1 and B = 3."""
    import torch
    from repro_torch.kernels.alloc_scan import lane_major
    return (("cut masks lane-major, K1 io", frame, io),
            ("cut masks row-major, K1 io", frame.contiguous(), io),
            ("random masks row-major, float32 io row-major", rand, rio),
            ("random masks lane-major, float32 io lane-major",
             lane_major(rand), lane_major(rio)),
            ("random masks lane-major, int32 io row-major", lane_major(rand),
             rio.to(torch.int32)),
            ("B=1", rand[:1], rio[:1]),
            ("B=3", rand[:3], rio[:3]))


def scorer_equal(t, f, i, args, what) -> float:
    """Both K5 kernels (forced by ``split``) against the plain version on
    one input, bit for bit; returns the largest error."""
    import torch
    from repro_torch.kernels import score_batch as sb
    want = sb.score_batch_torch(t, f, i, *args)
    err = 0.0
    for split in (False, True):
        got, ran = ran_variant(
            sb.score_batch_cuda,
            lambda: sb.score_batch_cuda(t, f, i, *args, split=split))
        name = f"score_batch {what}, {sb.VARIANTS[split]} kernel"
        require(ran == sb.VARIANTS[split], f"{name}: ran {ran}")
        require(got.shape == want.shape == (f.shape[0], sb.N_STATS),
                f"{name}: shape {tuple(got.shape)}")
        err = max(err, max_abs_err(got, want))
        require(torch.equal(got.contiguous().view(torch.int32),
                            want.contiguous().view(torch.int32)),
                f"{name}: kernel != plain version (max abs err {err})")
    return err


def scorer_edges() -> dict:
    """K5 at the rule's crossover (the largest B it gives the split kernel,
    and one more, each with a neighbour) at yolov2's groups, through the
    rule and forced both ways, and at G = 1; each bit for bit against the
    plain version.  Returns the crossover, the kernel the rule ran at each
    B, and each case's error."""
    import torch
    from repro_torch.kernels import score_batch as sb
    from repro_torch.kernels.search_pipeline import _sm_count
    engine = make_engine("yolov2")
    t = engine.score_tables()
    args = (engine.hw.dram_bytes_per_cycle, engine.hw.group_overhead_cycles)
    sms = _sm_count(0)
    top = (2 * sms - 1) * sb.SCORE_BLOCK        # the last B split by rule
    require(sb.score_batch_plan(top, t.g, sms).split
            and not sb.score_batch_plan(top + 1, t.g, sms).split,
            f"score_batch_plan's crossover is not at B {top} / {top + 1}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3000)
    out = {"crossover": top, "rule": {}, "errs": {}}
    for B in (top - 1, top, top + 1, top + 2):
        rand = (torch.rand((B, t.g), generator=gen, device="cuda")
                < torch.rand((B, 1), generator=gen, device="cuda"))
        rio = torch.randint(0, 1 << 22, (B, t.g), generator=gen,
                            device="cuda").to(torch.float32)
        want = sb.score_batch_torch(t, rand, rio, *args)
        got, ran = ran_variant(
            sb.score_batch_cuda,
            lambda: sb.score_batch_cuda(t, rand, rio, *args))
        require(ran == sb.score_batch_plan(B, t.g, sms).variant
                and torch.equal(got.contiguous().view(torch.int32),
                                want.contiguous().view(torch.int32)),
                f"score_batch at B {B} (the rule's {ran} kernel) != plain "
                f"version")
        out["rule"][f"B={B}"] = ran
        out["errs"][f"B={B}"] = scorer_equal(t, rand, rio, args,
                                             f"yolov2 B={B}")
    one = sb.ScoreTables(g=1, rows=t.rows[:, :1].contiguous())
    for B in (1, 3, 8, 1024):
        rand = torch.rand((B, 1), generator=gen, device="cuda") < 0.5
        rio = torch.randint(0, 1 << 22, (B, 1), generator=gen,
                            device="cuda", dtype=torch.int32)
        out["errs"][f"G=1, B={B}"] = scorer_equal(one, rand, rio, args,
                                                  f"G=1 B={B}")
    return out


def scorer_device_replay(reps: int) -> dict:
    """K5 as the device replay calls it (``score_stats`` on the engine's
    own mask tensor and K1's io) at efficientnet-b1, B 1, 3 and 8: a trace
    of ``reps`` calls must hold the split kernel ``reps`` times and nothing
    else but the stats' read-back: no copy kernel.  Returns the trace's
    activities and the inputs' strides by B."""
    import random

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.cnn import build_cnn
    from repro_torch.core.cutpoint import CutpointEngine
    from repro_torch.core.grouping import group_nodes
    from repro_torch.core.hw import KCU1500
    from repro_torch.kernels.score_batch import score_stats
    engine = CutpointEngine(group_nodes(build_cnn("efficientnet-b1")),
                            KCU1500, engine="device", device="cuda",
                            backend="pallas")
    rng = random.Random(4000)
    out = {}
    for B in (1, 3, 8):
        tuples = [tuple(rng.randint(0, len(r)) for r in engine.runs)
                  for _ in range(B)]
        frame, res = engine._device_replay(engine._frame_matrix(tuples))
        t = engine.score_tables()

        def call():
            return score_stats(t, frame, res.io, engine.hw)
        call()
        torch.cuda.synchronize()
        # a warm-up cycle first, which the trace drops: a trace that starts
        # with the calls can miss the first few (5 of 20 once on an H100)
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            call()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            prof.step()
        seen = {k: v["count"] for k, v in device_time_all(prof).items()}
        kernels = {k: n for k, n in seen.items()
                   if not k.startswith("Memcpy")}
        require(list(kernels.values()) == [reps]
                and "score_batch_split_kernel" in next(iter(kernels))
                and set(seen) - set(kernels)
                <= {k for k in seen if k.startswith("Memcpy DtoH")},
                f"K5 under the device replay at B {B}: the trace of {reps} "
                f"calls holds {seen}, not the split kernel alone and the "
                f"read-back")
        out[f"B={B}"] = {"trace": seen, "frame_strides": frame.stride(),
                          "io_strides": res.io.stride()}
    return out


def per_launch(seen: dict, name: str):
    """Device milliseconds a launch of the one trace entry whose name holds
    ``name`` (``seen`` from :func:`device_time_all`)."""
    hits = [v for k, v in seen.items() if name in k]
    return (hits[0]["device_ms"] / hits[0]["count"] if len(hits) == 1
            else "not measured")


def check_scorer(shapes, timed: bool, reps: int) -> dict:
    """K5's two kernels (``split`` forced each way) against the plain
    version on the GPU, bit for bit, at each ``(net, B)`` of ``shapes``
    with the inputs of :func:`scorer_cases`.  Returns ``{net: {"B", "G",
    "variant", "max_abs_err"[, "ms", "device_ms", "plain_ms", "bound_ms",
    "bound_by", "launch_floor_ms", "by_variant"]}}``: ``variant`` is the
    kernel ``score_batch_plan`` picks there, ``ms`` a call through the
    wrapper by CUDA events and ``device_ms`` the kernel's own time in a
    ``torch.profiler`` trace of ``reps`` calls, both of that kernel
    (``by_variant`` has both kernels'); ``launch_floor_ms`` is a
    ``zero_()`` of the 6 x B float32 stats in the same trace, the device
    time of the least kernel launch at that size."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import alloc_scan as scan
    from repro_torch.kernels import score_batch as sb
    from repro_torch.kernels import search_pipeline as pipe

    out = {}
    for net, B in shapes:
        engine = make_engine(net)
        tbl = pipe._engine_tables(engine)
        space = check_space(engine, 8 * CHUNK)
        require(space.size >= B, f"{net}: {space.size} tuples < B = {B}")
        frame = pipe.enum_frames_cuda(tbl, space, space.size - B, B)
        io = scan.alloc_scan_cuda(engine.alloc_tables(), frame).io
        t = engine.score_tables()
        G = t.g
        args = (engine.hw.dram_bytes_per_cycle,
                engine.hw.group_overhead_cycles)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2000 + G)
        rand = (torch.rand((B, G), generator=gen, device="cuda")
                < torch.rand((B, 1), generator=gen, device="cuda"))
        rio = torch.randint(0, 1 << 22, (B, G), generator=gen,
                            device="cuda").to(torch.float32)
        err = 0.0
        for what, f, i in scorer_cases(frame, io, rand, rio):
            err = max(err, scorer_equal(t, f, i, args, f"{net} {what}"))
        torch.cuda.synchronize()
        plan = sb.score_batch_plan(B, G, pipe._sm_count(0))
        row = {"B": B, "G": G, "variant": plan.variant, "max_abs_err": err}
        if timed:
            # timed on the device replay's and the pipeline's layout:
            # lane-major masks and K1's io
            floor = torch.empty(sb.N_STATS * B, device="cuda")

            def plain():
                return sb.score_batch_torch(t, frame, io, *args)
            by_variant = {}
            for split in (False, True):
                def kernel():
                    return sb.score_batch_cuda(t, frame, io, *args,
                                               split=split)
                # in turns: plain, kernel, kernel, plain
                p1 = time_ms(plain, reps=2)
                k1 = time_ms(kernel, reps=reps, warmup=2)
                k2 = time_ms(kernel, reps=reps, warmup=0)
                p2 = time_ms(plain, reps=2, warmup=0)
                # the floor after the kernel's launches, not between them:
                # its dirty lines in L2 would slow the chunk's kernel
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        kernel()
                    for _ in range(reps):
                        floor.zero_()
                    torch.cuda.synchronize()
                variant = sb.VARIANTS[split]
                name = KERNEL_INFO["score_batch"]["kernels"][variant]
                seen = device_time_all(prof)
                by_variant[variant] = {
                    "ms": min(k1, k2), "plain_ms": min(p1, p2),
                    "device_ms": per_launch(seen, name),
                    "launch_floor_ms": per_launch(seen, "FillFunctor")}
            b = scorer_bound(B, G)
            mine = by_variant[plan.variant]
            row.update(ms=mine["ms"], device_ms=mine["device_ms"],
                       plain_ms=min(v["plain_ms"]
                                    for v in by_variant.values()),
                       bound_ms=b[0], bound_by=b[1],
                       launch_floor_ms=mine["launch_floor_ms"],
                       by_variant=by_variant)
        out[net] = row
    return out


# ------------------------------------------------ LM kernels vs plain
# The architectures phase 5 serves, each with the shape of its serve, what
# one serve must launch (every other kernel 0), and its float32 model check
# (depth, batch, prompt) with what that must launch.
LM_SERVES = {
    "recurrentgemma-2b": {
        "shape": {"batch": 2, "prompt_len": 3072, "gen_len": 16},
        # a flash attention per local-attention layer (8) and a scan per
        # recurrent layer (18) in the prefill, a fused block per layer (26)
        # in each of the 16 forwards (the prefill and 15 decode steps)
        "launches": {"flash_attention": 8, "rglru_scan": 18,
                     "fused_block": 26 * 16},
        # bfloat16: all on the tensor cores, the prefill and decode (M 2)
        "launches_by_variant": {
            "flash_attention": {"tensor_core": 8},
            "fused_block": {"tensor_core": 26 * 16}},
        # depth 4 (one pattern cycle and one tail layer), 1,024 tokens: the
        # prefill has 2 * 1,024 / 8 = 256 row tiles, more than the SMs, so
        # K7 takes there its single-split branch, as in the serve
        "check": {"n_layers": 4, "batch": 2, "prompt_len": 1024},
        "check_launches": {"flash_attention": 1, "fused_block": 8,
                           "rglru_scan": 3},
        # float32 runs on the SIMT kernels only
        "check_launches_by_variant": {
            "flash_attention": {"simt": 1},
            "fused_block": {"simt": 4, "simt_split": 4}}},
    "mamba2-2.7b": {
        "shape": {"batch": 4, "prompt_len": 2048, "gen_len": 16},
        # an SSD scan per layer (64) in the prefill (8 chunks of 256); the
        # ssm layers have no MLP, and decode is plain torch
        "launches": {"ssd_scan": 64},
        # bfloat16: all on the tensor cores
        "launches_by_variant": {"ssd_scan": {"tensor_core": 64}},
        # depth 4, 1,000 tokens: three chunks of 256 and a ragged one of 232
        "check": {"n_layers": 4, "batch": 2, "prompt_len": 1000},
        "check_launches": {"ssd_scan": 4},
        # float32 runs on the SIMT kernel
        "check_launches_by_variant": {"ssd_scan": {"simt": 4}}},
    # 48 layers, d 2,048, 64 experts top 6 (27.7 G parameters, ~55 GB in
    # bfloat16: served alone on the card, the earlier serves' models freed)
    "moonshot-v1-16b-a3b": {
        "shape": {"batch": 2, "prompt_len": 2048, "gen_len": 16},
        # a flash attention per layer (48) in the prefill; the experts are
        # batched products in torch, so K7 never runs
        "launches": {"flash_attention": 48},
        "launches_by_variant": {"flash_attention": {"tensor_core": 48}},
        # depth 2, batch 1, 1,024 tokens; the routes of the kernel and the
        # plain run are compared
        "check": {"n_layers": 2, "batch": 1, "prompt_len": 1024},
        "check_launches": {"flash_attention": 2},
        "check_launches_by_variant": {"flash_attention": {"simt": 2}}},
    # 40 layers (32 self-attention, 8 cross-attention over 1,600 patches),
    # d 4,096, F 14,336
    "llama-3.2-vision-11b": {
        "shape": {"batch": 2, "prompt_len": 1024, "gen_len": 16},
        # a flash attention per layer (40: self and cross) in the prefill,
        # a fused block per layer (40) in each of the 16 forwards
        "launches": {"flash_attention": 40, "fused_block": 40 * 16},
        "launches_by_variant": {
            "flash_attention": {"tensor_core": 40},
            "fused_block": {"tensor_core": 40 * 16}},
        # one pattern cycle (4 self, 1 cross), batch 1, 512 tokens, random
        # patches, both gates 0.5 (at 0, their initial value, a cross layer
        # adds nothing); K7 at d 4,096 in float32: the wide passes
        "check": {"n_layers": 5, "batch": 1, "prompt_len": 512,
                  "gates": 0.5},
        "check_launches": {"flash_attention": 5, "fused_block": 10},
        "check_launches_by_variant": {
            "flash_attention": {"simt": 5},
            "fused_block": {"simt_wide": 10}}},
    # 6 encoder layers over 1,500 frames, 6 decoder layers, d 512
    "whisper-base": {
        "shape": {"batch": 4, "prompt_len": 128, "gen_len": 16},
        # K6 per encoder layer (6) and per decoder layer twice, self- and
        # cross-attention (12), in the prefill; K7 per encoder layer (6)
        # and per decoder layer (6) in each of the 16 forwards
        "launches": {"flash_attention": 6 + 6 + 6,
                     "fused_block": 6 + 6 * 16},
        "launches_by_variant": {
            "flash_attention": {"tensor_core": 18},
            "fused_block": {"tensor_core": 102}},
        # the whole model, batch 2, random frames, 128 tokens: the
        # encoder's 3,000 rows fill the SMs (simt), the decoder's 256 and
        # the decode step's 2 do not (simt_split)
        "check": {"n_layers": 6, "batch": 2, "prompt_len": 128},
        "check_launches": {"flash_attention": 18, "fused_block": 18},
        "check_launches_by_variant": {
            "flash_attention": {"simt": 18},
            "fused_block": {"simt": 6, "simt_split": 12}}},
}
# float32 model checks of architectures phase 5 does not serve, as
# LM_SERVES[arch]["check"]: gemma2-27b, the widest MLP, whose rows only K7's
# wide SIMT path takes in float32
LM_CHECKS = {
    "gemma2-27b": {
        # one local and one global layer (the pattern's cycle), batch 1,
        # 1,024 tokens: K6 once a layer in the prefill (the decode step
        # attends in torch); K7 once a layer in the prefill (M 1,024) and
        # in the decode step (M 1), all on the wide path (d 4,608)
        "check": {"n_layers": 2, "batch": 1, "prompt_len": 1024},
        "check_launches": {"flash_attention": 2, "fused_block": 4},
        "check_launches_by_variant": {
            "flash_attention": {"simt": 2},
            "fused_block": {"simt_wide": 4}}},
}
# K7 in float32 at rows wider than the SIMT row tiles hold: (arch, M), the
# arch's MLP at its full width
K7_WIDE = (("gemma2-27b", 1024), ("gemma2-27b", 2), ("granite-20b", 1024))
LM_ARCH = "recurrentgemma-2b"        # K6, K7, K9 are checked at its shapes
SSD_ARCH = "mamba2-2.7b"             # K8 at its shapes
LM_KERNELS = ("flash_attention", "fused_block", "ssd_scan", "rglru_scan")
# (rtol, atol) as tests/test_kernels.py holds the TPU kernels; K8 in
# bfloat16 as K6 and K7 (the output is rounded once, at the same point)
LM_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
SSD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}


def require_close(name, got, want, what, tol, errs, cases):
    """Hold a kernel's output against its plain version's: same shape and
    type, finite, within ``tol``; record the error in ``errs`` and
    ``cases``."""
    import torch
    err = max_abs_err(got, want)
    errs[name] = max(errs.get(name, 0.0), err)
    cases.append({"kernel": name, "case": what, "max_abs_err": err})
    log(f"  {name} {what}: max abs err {err:.3g}")
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name} {what}: {tuple(got.shape)} {got.dtype} != "
            f"{tuple(want.shape)} {want.dtype}")
    require(bool(torch.isfinite(got.float()).all()),
            f"{name} {what}: non-finite output")
    require(torch.allclose(got.float(), want.float(), rtol=tol[0],
                           atol=tol[1]),
            f"{name} {what}: kernel != plain version (max abs err {err}, "
            f"tolerance {tol})")


def require_same(name, got, want, what, errs, cases):
    """Hold a kernel's output against its plain version's bit for bit (the
    kernels whose arithmetic and order are the plain version's)."""
    import torch
    err = max_abs_err(got, want)
    errs[name] = max(errs.get(name, 0.0), err)
    cases.append({"kernel": name, "case": what, "max_abs_err": err})
    log(f"  {name} {what}: max abs err {err:.3g}")
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name} {what}: {tuple(got.shape)} {got.dtype} != "
            f"{tuple(want.shape)} {want.dtype}")
    require(torch.equal(got.contiguous().view(torch.uint8),
                        want.contiguous().view(torch.uint8)),
            f"{name} {what}: kernel != plain version bit for bit (max abs "
            f"err {err})")


def attention_pairs(S: int, T: int, causal: bool, window: int,
                    q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps, for one batch row and head, the
    queries at positions ``q_offset ..``."""
    n = 0
    for i in range(q_offset, q_offset + S):
        hi = min(T, i + 1) if causal else T
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def lm_peak(itemsize: int) -> float:
    return PEAK_BF16_OPS_PER_S if itemsize == 2 else PEAK_F32_OPS_PER_S


def flash_bound(B, S, T, NH, NKV, hd, causal, window, itemsize,
                q_offset=0):
    """K6: q, k, v read and o written once; 4 * hd operations (the two
    products) per (query, key) pair the mask keeps, at the tensor-core rate
    of the input type."""
    pairs = B * NH * attention_pairs(S, T, causal, window, q_offset)
    n_bytes = itemsize * (2 * B * S * NH * hd + 2 * B * T * NKV * hd)
    return bound(n_bytes, 4 * hd * pairs, lm_peak(itemsize))


def fused_block_bound(M, d, F, gated, itemsize, partial=False):
    """K7: x read and the output written once (the partial form's in
    float32), the two or three weight matrices and the float32 norm scales
    read once; 2 * M * d * F operations per matrix product."""
    mats = 3 if gated else 2
    n_bytes = (itemsize * (M * d + mats * d * F) + 4 * 2 * d
               + (4 if partial else itemsize) * M * d)
    return bound(n_bytes, 2 * M * d * F * mats, lm_peak(itemsize))


def rglru_bound(B, S, W):
    """K9: a and b read and h written once, float32; a product and a sum
    per element."""
    return bound(12 * B * S * W, 2 * B * S * W, PEAK_F32_OPS_PER_S)


def ssd_multiply_adds(b, s, h, g, p, n, chunk):
    """K8's multiply-adds from a given state h0, chunk by chunk (a ragged
    last one counted at its length L): the causal half of C B^T once per
    group, as ``ssd_chunked`` computes it, and of the scores times x, per
    head; the state's two products per head, C . state and the increment
    x^T B."""
    macs = 0
    for c0 in range(0, s, chunk):
        L = min(chunk, s - c0)
        tri = L * (L + 1) // 2
        macs += g * tri * n + h * tri * p + 2 * h * L * p * n
    return b * macs


def ssd_bound(b, s, h, g, p, n, chunk, itemsize):
    """K8 from a given state (the serve passes its cache's): x, B, C, dt,
    A, D and h0 read and y and the state written once; two operations a
    multiply-add at the tensor-core rate of the input type (bfloat16: its
    products of bfloat16 x, B and C are exact there; float32: the vector
    rate), as ``flash_bound``."""
    n_bytes = (itemsize * (2 * b * s * h * p + 2 * b * s * g * n)
               + 4 * (b * s * h + 2 * h) + 4 * 2 * b * h * p * n)
    return bound(n_bytes, 2 * ssd_multiply_adds(b, s, h, g, p, n, chunk),
                 lm_peak(itemsize))


def ran_variant(wrapper, call):
    """``call()``'s result and the one variant of ``wrapper`` it launched
    (by the wrapper's per-variant counts)."""
    before = dict(wrapper.launches_by_variant)
    got = call()
    ran = [v for v, n in wrapper.launches_by_variant.items()
           if n != before[v]]
    require(len(ran) == 1, f"one call launched the variants {ran}")
    return got, ran[0]


def check_lm_kernels(timed: bool, reps: int) -> dict:
    """K6, K7 and K9 against their plain versions on the GPU: at the
    full-width shapes of LM_ARCH's serve and of phase 7's training run
    (bfloat16, on the tensor cores), at ragged shapes, K6 with gemma2's
    soft cap and GQA, K7 ungated and with the sandwich norm.  Each K6 and
    K7 case names the variant it must run.  Returns ``{"errs", "cases"[,
    "times"]}``; each time is a launch through the wrapper by CUDA events,
    beside the plain version's, K6's library call's and the bfloat16
    products of K7 alone in ``torch.matmul``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_block as fb
    from repro_torch.kernels import rglru_scan as rs

    cfg = get_config(LM_ARCH)
    tcfg, tb, ts = train_config(), TRAIN_RUN["batch"], TRAIN_RUN["seq"]
    shape = LM_SERVES[LM_ARCH]["shape"]
    B, S = shape["batch"], shape["prompt_len"]
    nh, nkv, hd, win = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window
    d, ff, w = cfg.d_model, cfg.d_ff, cfg.lru_width
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3000)

    def randn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(dtype)

    errs = {"flash_attention": 0.0, "fused_block": 0.0, "rglru_scan": 0.0,
            "flash_attention[q_offset]": 0.0, "fused_block[partial]": 0.0}
    cases = []

    def close(name, got, want, what, tol):
        require_close(name, got, want, what, tol, errs, cases)

    def close_variant(wrapper, plain, args, kw, what, variant, form=None):
        name = wrapper.__name__.removesuffix("_cuda")
        if form:
            name = f"{name}[{form}]"
        got, ran = ran_variant(wrapper, lambda: wrapper(*args, **kw))
        log(f"  {name} {what}: ran the {ran} kernel")
        require(ran == variant, f"{name} {what}: ran the {ran} kernel, not "
                                f"{variant}")
        close(name, got, plain(*args, **kw), what,
              LM_TOL[str(args[0].dtype).split(".")[-1]])
        cases[-1]["variant"] = ran

    # ---- K6
    def attn(b, s, t, heads, kv_heads, dim, dtype):
        return (randn((b, s, heads, dim), dtype),
                randn((b, t, kv_heads, dim), dtype),
                randn((b, t, kv_heads, dim), dtype))

    full_attn = attn(B, S, S, nh, nkv, hd, bf16)
    tc, simt, split = "tensor_core", "simt", "simt_split"
    attn_cases = [
        ("full width bf16", full_attn, dict(causal=True, window=win), tc),
        ("full width float32", attn(B, S, S, nh, nkv, hd, f32),
         dict(causal=True, window=win), simt),
        ("heads of the full width, 1024 tokens, float32",
         attn(1, 1024, 1024, nh, nkv, hd, f32),
         dict(causal=True, window=win // 4), simt),
        ("ragged 333 tokens, hd 96, GQA 4/2, window 100, float32",
         attn(1, 333, 333, 4, 2, 96, f32), dict(causal=True, window=100),
         simt),
        ("ragged 333 tokens, hd 96, GQA 4/2, window 100, bf16",
         attn(1, 333, 333, 4, 2, 96, bf16), dict(causal=True, window=100),
         tc),
        ("ragged, not causal, S 70 T 45, float32",
         attn(2, 70, 45, 2, 1, 16, f32), dict(causal=False, window=0), simt),
        ("gemma2: softcap 50, GQA 8/4, 1000 tokens, bf16",
         attn(1, 1000, 1000, 8, 4, 256, bf16),
         dict(causal=True, window=0, softcap=50.0), tc),
        ("gemma2: softcap 50, GQA 8/4, window 300, float32",
         attn(1, 700, 700, 8, 4, 256, f32),
         dict(causal=True, window=300, softcap=50.0), simt),
        # every dimension off the tensor-core kernel's tiles
        ("ragged 333 tokens, hd 96, GQA 4/2, window 100, softcap 30, bf16",
         attn(1, 333, 333, 4, 2, 96, bf16),
         dict(causal=True, window=100, softcap=30.0), tc),
        ("ragged, not causal, S 70 T 45, hd 16, bf16",
         attn(2, 70, 45, 2, 1, 16, bf16), dict(causal=False, window=0), tc),
        # phase 7's training shape (each layer's forward and recomputation)
        (f"{TRAIN_ARCH} training, B {tb} S {ts}, GQA {tcfg.n_heads}/"
         f"{tcfg.n_kv_heads}, hd {tcfg.hd}, bf16",
         attn(tb, ts, ts, tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd, bf16),
         dict(causal=True, window=0, softcap=tcfg.attn_softcap), tc),
    ]
    for what, args, kw, variant in attn_cases:
        close_variant(fa.flash_attention_cuda, fa.flash_attention_torch,
                      args, kw, what, variant)

    # ---- K6 with a query offset: the context-parallel slices of phase
    # 10's prefill of MODEL_AXIS_CP_ARCH on two ranks (queries S / 2 from
    # offset 0 and S / 2 against all S keys)
    ccfg = get_config(MODEL_AXIS_CP_ARCH)
    cb, cs = (MODEL_AXIS_SERVES[MODEL_AXIS_CP_ARCH]["shape"][k]
              for k in ("batch", "prompt_len"))
    half = cs // 2
    cp_heads = (ccfg.n_heads, ccfg.n_kv_heads, ccfg.hd)
    cp_attn = attn(cb, half, cs, *cp_heads, bf16)
    offset_cases = [
        (f"{MODEL_AXIS_CP_ARCH} cp slice of rank 1: {half} queries from "
         f"{half} of {cs} keys, bf16", cp_attn,
         dict(causal=True, q_offset=half), tc),
        (f"{MODEL_AXIS_CP_ARCH} cp slice of rank 0, bf16", cp_attn,
         dict(causal=True, q_offset=0), tc),
        (f"{MODEL_AXIS_CP_ARCH} cp slice of rank 1, float32",
         attn(cb, half, cs, *cp_heads, f32),
         dict(causal=True, q_offset=half), simt),
        ("ragged 333 queries from 367 of 700 keys, hd 96, window 100, bf16",
         attn(1, 333, 700, 4, 2, 96, bf16),
         dict(causal=True, window=100, q_offset=367), tc),
        ("ragged 333 queries from 367 of 700 keys, hd 96, window 100, "
         "float32", attn(1, 333, 700, 4, 2, 96, f32),
         dict(causal=True, window=100, q_offset=367), simt),
    ]
    for what, args, kw, variant in offset_cases:
        close_variant(fa.flash_attention_cuda, fa.flash_attention_torch,
                      args, kw, what, variant, form="q_offset")

    # ---- K7
    def block(m, dd, f, dtype):
        return (randn((m, dd), dtype), randn((dd,), f32, 0.1),
                randn((dd, f), dtype, dd ** -0.5),
                randn((dd, f), dtype, dd ** -0.5),
                randn((f, dd), dtype, f ** -0.5), randn((dd,), f32, 0.1))

    prefill_x = block(B * S, d, ff, bf16)
    decode_x = (randn((B, d), bf16),) + prefill_x[1:]
    geglu = dict(act=cfg.act, gated=cfg.mlp_gated, sandwich=False)
    block_cases = [
        ("prefill, full width bf16", prefill_x, geglu, tc),
        ("prefill, full width float32", block(B * S, d, ff, f32), geglu,
         simt),
        ("decode, full width bf16", decode_x, geglu, tc),
        ("ragged M 37, d 200, F 333, ungated silu, float32",
         block(37, 200, 333, f32), dict(act="silu", gated=False), split),
        ("ragged M 37, d 200, F 333, ungated silu, bf16",
         block(37, 200, 333, bf16), dict(act="silu", gated=False), split),
        ("gemma2 width, M 300, sandwich, bf16", block(300, 2304, 9216, bf16),
         dict(act="gelu", gated=True, sandwich=True), tc),
        ("gemma2 width, M 3, sandwich, float32", block(3, 2304, 9216, f32),
         dict(act="gelu", gated=True, sandwich=True), split),
        # every dimension off the tensor-core kernel's tiles, gated and
        # ungated
        ("ragged M 333, d 200, F 344, gated gelu, bf16",
         block(333, 200, 344, bf16), dict(act="gelu", gated=True), tc),
        ("ragged M 70, d 136, F 264, ungated silu, sandwich, bf16",
         block(70, 136, 264, bf16),
         dict(act="silu", gated=False, sandwich=True), tc),
        # wider than the SIMT kernel's registers hold (d > MAX_D)
        ("gemma2-27b width, M 130, d 4608, F 36864, sandwich, bf16",
         block(130, 4608, 36864, bf16),
         dict(act="gelu", gated=True, sandwich=True), tc),
        # phase 7's training shape: every MLP of the trained run
        (f"{TRAIN_ARCH} training, M {tb * ts}, d {tcfg.d_model}, F "
         f"{tcfg.d_ff}, gated {tcfg.act}, bf16",
         block(tb * ts, tcfg.d_model, tcfg.d_ff, bf16),
         dict(act=tcfg.act, gated=tcfg.mlp_gated,
              sandwich=tcfg.sandwich_norm), tc),
    ]
    for what, args, kw, variant in block_cases:
        close_variant(fb.fused_block_cuda, fb.fused_block_torch, args, kw,
                      what, variant)

    # ---- K7's partial sum at LM_ARCH's rank shape on two ranks (F / 2)
    part_x = block(B * S, d, ff // 2, bf16)
    partial = dict(geglu, partial=True)
    partial_cases = [
        (f"partial, rank shape M {B * S} d {d} F {ff // 2}, bf16", part_x,
         partial, tc),
        (f"partial, rank shape M {B * S} d {d} F {ff // 2}, float32",
         block(B * S, d, ff // 2, f32), partial, simt),
        (f"partial, decode M {B} d {d} F {ff // 2}, bf16",
         (randn((B, d), bf16),) + part_x[1:], partial, tc),
        (f"partial, decode M {B} d {d} F {ff // 2}, float32",
         block(B, d, ff // 2, f32), partial, split),
        ("partial, wide M 64 d 4608 F 4608 (sandwich ignored), float32",
         block(64, 4608, 4608, f32),
         dict(act="gelu", gated=True, sandwich=True, partial=True),
         "simt_wide"),
        ("partial, ragged M 70 d 136 F 264 ungated, bf16",
         block(70, 136, 264, bf16),
         dict(act="silu", gated=False, partial=True), tc),
    ]
    for what, args, kw, variant in partial_cases:
        close_variant(fb.fused_block_cuda, fb.fused_block_torch, args, kw,
                      what, variant, form="partial")
    wide = [check_wide_block(arch, m, block, close_variant, cases, timed)
            for arch, m in K7_WIDE]
    families = check_family_shapes(randn, block, close_variant, cases,
                                   timed, reps)

    # ---- K9: equal bit for bit
    def scan(b, s, width):
        return (torch.sigmoid(randn((b, s, width), f32)),
                randn((b, s, width), f32))

    def unaligned(x):
        """``x``'s numbers in a contiguous tensor 4 bytes off a 16-byte
        boundary: the kernel's 4-byte copies."""
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    full_scan = scan(B, S, w)
    ring = rs.RING_STAGES * rs.STAGE_STEPS
    short = scan(B, ring // 2 + 3, w)
    scan_cases = [
        ("full width", full_scan),
        ("ragged B 3, S 77, W 100", scan(3, 77, 100)),
        (f"S {ring // 2 + 3} shorter than the ring of {ring} steps", short),
        ("S 1", scan(2, 1, 64)),
        (f"S {S - 1}", scan(B, S - 1, w)),
        (f"W {w + 1}", scan(B, 700, w + 1)),
        ("B 1, W 16", scan(1, 500, 16)),
        ("unaligned rows", tuple(unaligned(t) for t in short)),
        (f"rank shape: W {w // 2} of {w}", scan(B, S, w // 2)),
    ]
    for what, (a, bb) in scan_cases:
        plan = rs.rglru_scan_plan(*a.shape, aligned=all(
            t.data_ptr() % 16 == 0 for t in (a, bb)))
        require_same("rglru_scan", rs.rglru_scan_cuda(a, bb),
                     rs.rglru_scan_torch(a, bb),
                     f"{what}, {4 * plan.vec}-byte copies", errs, cases)
    torch.cuda.synchronize()
    out = {"errs": errs, "cases": cases, "wide": wide, "families": families}
    if not timed:
        return out

    q, k, v = full_attn
    mask = torch.ones((S, S), dtype=torch.bool, device="cuda").tril()
    mask &= ~torch.ones_like(mask).tril(-win)     # keep 0 <= i - j < win
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in full_attn)

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              enable_gqa=True)

    lib_err = max_abs_err(library().transpose(1, 2),
                          fa.flash_attention_torch(q, k, v, window=win))
    # K7's three bfloat16 products alone (cuBLAS), on its prefill's shapes:
    # no single PyTorch call computes the block, so this is `matmul_ms`
    def products_of(block_x):
        x_mm, _s, wg_mm, wu_mm, wd_mm, _p = block_x
        h_mm = randn((x_mm.shape[0], wd_mm.shape[0]), bf16)
        return lambda: (x_mm @ wg_mm, x_mm @ wu_mm, h_mm @ wd_mm)

    products = products_of(prefill_x)
    decode_products = products_of(decode_x)
    timing = {
        "flash_attention": (
            lambda: fa.flash_attention_cuda(q, k, v, window=win),
            lambda: fa.flash_attention_torch(q, k, v, window=win),
            flash_bound(B, S, S, nh, nkv, hd, True, win, 2),
            dict(B=B, S=S, T=S, NH=nh, NKV=nkv, hd=hd, window=win,
                 dtype="bfloat16")),
        "fused_block": (
            lambda: fb.fused_block_cuda(*prefill_x, **geglu),
            lambda: fb.fused_block_torch(*prefill_x, **geglu),
            fused_block_bound(B * S, d, ff, True, 2),
            dict(M=B * S, d=d, F=ff, dtype="bfloat16")),
        "fused_block_decode": (
            lambda: fb.fused_block_cuda(*decode_x, **geglu),
            lambda: fb.fused_block_torch(*decode_x, **geglu),
            fused_block_bound(B, d, ff, True, 2),
            dict(M=B, d=d, F=ff, dtype="bfloat16")),
        "rglru_scan": (
            lambda: rs.rglru_scan_cuda(*full_scan),
            lambda: rs.rglru_scan_torch(*full_scan),
            rglru_bound(B, S, w), dict(B=B, S=S, W=w, dtype="float32")),
        "flash_attention[q_offset]": (
            lambda: fa.flash_attention_cuda(*cp_attn, q_offset=half),
            lambda: fa.flash_attention_torch(*cp_attn, q_offset=half),
            flash_bound(cb, half, cs, *cp_heads, True, 0, 2, q_offset=half),
            dict(B=cb, S=half, T=cs, NH=cp_heads[0], NKV=cp_heads[1],
                 hd=cp_heads[2], q_offset=half, dtype="bfloat16")),
        "rglru_scan_rank": (
            lambda: rs.rglru_scan_cuda(*scan_cases[-1][1]),
            lambda: rs.rglru_scan_torch(*scan_cases[-1][1]),
            rglru_bound(B, S, w // 2),
            dict(B=B, S=S, W=w // 2, dtype="float32")),
        "fused_block[partial]": (
            lambda: fb.fused_block_cuda(*part_x, **partial),
            lambda: fb.fused_block_torch(*part_x, **partial),
            fused_block_bound(B * S, d, ff // 2, True, 2, partial=True),
            dict(M=B * S, d=d, F=ff // 2, dtype="bfloat16")),
    }
    out["times"] = {}
    for name, (kernel, plain, bnd, shape) in timing.items():
        out["times"][name] = {**in_turns(kernel, plain, reps),
                              "bound_ms": bnd[0], "bound_by": bnd[1],
                              "shape": shape}
    lib = [time_ms(library, reps=reps, warmup=1) for _ in range(2)]
    out["times"]["flash_attention"].update(library_ms=min(lib),
                                           library_max_abs_err=lib_err)
    # the cp slice in SDPA: rank 1's queries keep the keys up to their
    # positions (a boolean mask), the kv heads spread over GQA
    cq, ck, cv = (t.transpose(1, 2).contiguous() for t in cp_attn)
    cmask = (torch.arange(half, cs, device="cuda")[:, None]
             >= torch.arange(cs, device="cuda")[None, :])

    def cp_library():
        return F.scaled_dot_product_attention(cq, ck, cv, attn_mask=cmask,
                                              enable_gqa=True)

    cp_lib = [time_ms(cp_library, reps=reps, warmup=1) for _ in range(2)]
    out["times"]["flash_attention[q_offset]"].update(
        library_ms=min(cp_lib), library_max_abs_err=max_abs_err(
            cp_library().transpose(1, 2),
            fa.flash_attention_torch(*cp_attn, q_offset=half)))
    for name, fn in (("fused_block", products),
                     ("fused_block_decode", decode_products),
                     ("fused_block[partial]", products_of(part_x))):
        mm = [time_ms(fn, reps=reps, warmup=1) for _ in range(2)]
        out["times"][name]["matmul_ms"] = min(mm)
    variants = {"flash_attention": (fa.flash_attention_cuda, q, k, v),
                "fused_block": (fb.fused_block_cuda, *prefill_x),
                "fused_block_decode": (fb.fused_block_cuda, *decode_x)}
    for name, (wrapper, *args) in variants.items():
        kw = dict(window=win) if name == "flash_attention" else geglu
        out["times"][name]["shape"]["variant"] = ran_variant(
            wrapper, lambda: wrapper(*args, **kw))[1]
    for name, (ms, err) in earlier_design_times(full_attn, win, prefill_x,
                                                decode_x, cfg.act == "gelu",
                                                reps).items():
        out["times"][name].update(earlier_design_ms=ms,
                                  earlier_design_max_abs_err=err)
    return out


# K6 at the shapes the vlm and audio serves give it, bfloat16 and not
# causal, and at qwen3-moe's prefill in phase 10 (causal, GQA 64 / 4):
# (case, arch, B, S, T, causal), the arch giving the heads and head dim
FAMILY_ATTENTION = (
    ("llama-3.2-vision-11b cross-attention prefill",
     "llama-3.2-vision-11b", 2, 1024, 1600, False),
    ("whisper-base encoder", "whisper-base", 4, 1500, 1500, False),
    ("whisper-base decoder cross-attention prefill", "whisper-base", 4, 128,
     1500, False),
    ("qwen3-moe-235b-a22b prefill", "qwen3-moe-235b-a22b", 2, 2048, 2048,
     True))
# K7 at those serves' MLPs, bfloat16: (arch, M), the prefill's and the
# decode step's rows (whisper's encoder: 4 x 1,500 frames)
FAMILY_BLOCKS = (("llama-3.2-vision-11b", 2048), ("llama-3.2-vision-11b", 2),
                 ("whisper-base", 6000))
# K6's family cases draw q ~ N(1, 1) and k ~ N(-shift / sqrt(hd), 1) in
# each element: every score then sits near -shift, so a key that the
# kernel left unmasked past T (score 0, against zero padding) would
# outweigh the real ones and show far beyond the limits
FAMILY_SCORE_SHIFT = 6.0
# and each is held, beyond LM_TOL, within this many bfloat16 ulps of the
# largest |output| of the plain version
FAMILY_ATTENTION_ULPS = 4


def flash_tc_key_tile(hd: int) -> int:
    """Keys a tile of the tensor-core K6 (``csrc/flash_attention_tc.cu``,
    ``BKV``)."""
    return 32 if hd == 256 else 64


def bf16_ulps(x, n: int) -> float:
    """``n`` bfloat16 ulps at the largest |value| of ``x``."""
    top = float(x.float().abs().max())
    return n * 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0


def check_family_shapes(randn, block, close_variant, cases, timed,
                        reps) -> dict:
    """K6 and K7 against their plain versions at ``FAMILY_ATTENTION`` and
    ``FAMILY_BLOCKS`` (bfloat16, on the tensor cores), each with its bound
    and, if ``timed``, its time beside the plain version's and K6's
    ``scaled_dot_product_attention`` / K7's three products in
    ``torch.matmul`` (``matmul_ms``).  Returns ``{"flash_attention":
    {case: ...}, "fused_block": {case: ...}}``; each case's inputs are
    freed before the next."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_block as fb

    bf16 = torch.bfloat16
    out = {"flash_attention": {}, "fused_block": {}}
    for what, arch, b, s, t, causal in FAMILY_ATTENTION:
        cfg = get_config(arch)
        nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        f32 = torch.float32
        q = (randn((b, s, nh, hd), f32) + 1).to(bf16)
        k = (randn((b, t, nkv, hd), f32)
             - FAMILY_SCORE_SHIFT / math.sqrt(hd)).to(bf16)
        v = randn((b, t, nkv, hd), bf16)
        kw = dict(causal=causal, window=0)
        label = (f"{what}, B {b} S {s} T {t}, GQA {nh}/{nkv}, hd {hd}, "
                 f"{'causal' if causal else 'not causal'}, bf16")
        close_variant(fa.flash_attention_cuda, fa.flash_attention_torch,
                      (q, k, v), kw, label, "tensor_core")
        err = cases[-1]["max_abs_err"]
        want = fa.flash_attention_torch(q, k, v, **kw)
        limit = bf16_ulps(want, FAMILY_ATTENTION_ULPS)
        require(err <= limit, f"flash_attention {label}: max abs err {err} "
                              f"> {FAMILY_ATTENTION_ULPS} bf16 ulps of its "
                              f"largest |output| ({limit})")
        bnd = flash_bound(b, s, t, nh, nkv, hd, causal, 0, 2)
        entry = {"arch": arch, "B": b, "S": s, "T": t, "NH": nh, "NKV": nkv,
                 "hd": hd, "causal": causal, "dtype": "bfloat16",
                 "variant": cases[-1]["variant"], "max_abs_err": err,
                 "limit_abs": limit, "bound_ms": bnd[0], "bound_by": bnd[1]}
        pad = -t % flash_tc_key_tile(hd)
        if pad:
            # the fault the limits must catch: the ragged last tile's keys
            # past T zero-padded and left unmasked
            zeros = torch.zeros((b, pad, nkv, hd), dtype=bf16, device="cuda")
            planted = fa.flash_attention_torch(
                q, torch.cat([k, zeros], 1), torch.cat([v, zeros], 1), **kw)
            planted_err = max_abs_err(planted, want)
            log(f"  flash_attention {what}: a ragged tile left unmasked "
                f"({pad} zero keys) would be off by {planted_err:.3g} "
                f"(limit {limit:.3g}; kernel {err:.3g})")
            rtol, atol = LM_TOL["bfloat16"]
            require(planted_err > limit and not torch.allclose(
                planted.float(), want.float(), rtol=rtol, atol=atol),
                f"flash_attention {label}: the limits would pass an "
                f"unmasked ragged tile (off by {planted_err})")
            entry["planted_unmasked_tile_max_abs_err"] = planted_err
            del planted, zeros
        del want
        if timed:
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=causal, enable_gqa=True)
            entry["library_max_abs_err"] = max_abs_err(
                library().transpose(1, 2),
                fa.flash_attention_torch(q, k, v, **kw))
            entry.update(in_turns(
                lambda: fa.flash_attention_cuda(q, k, v, **kw),
                lambda: fa.flash_attention_torch(q, k, v, **kw), reps))
            entry["library_ms"] = min(time_ms(library, reps=reps, warmup=1)
                                      for _ in range(2))
            log(f"  flash_attention {what}: {entry['ms']:.4g} ms (bound "
                f"{bnd[0]:.4g} ms, {bnd[1]}), plain {entry['plain_ms']:.4g}"
                f" ms, scaled_dot_product_attention "
                f"{entry['library_ms']:.4g} ms")
        out["flash_attention"][what] = entry
        del q, k, v
        torch.cuda.empty_cache()
    for arch, m in FAMILY_BLOCKS:
        cfg = get_config(arch)
        d, f = cfg.d_model, cfg.d_ff
        args = block(m, d, f, bf16)
        kw = dict(act=cfg.act, gated=cfg.mlp_gated,
                  sandwich=cfg.sandwich_norm)
        what = (f"{arch} MLP, M {m}, d {d}, F {f}, "
                f"{'gated' if cfg.mlp_gated else 'ungated'} {cfg.act}, bf16")
        close_variant(fb.fused_block_cuda, fb.fused_block_torch, args, kw,
                      what, "tensor_core")
        bnd = fused_block_bound(m, d, f, cfg.mlp_gated, 2)
        entry = {"arch": arch, "M": m, "d": d, "F": f,
                 "gated": cfg.mlp_gated, "dtype": "bfloat16",
                 "variant": cases[-1]["variant"],
                 "max_abs_err": cases[-1]["max_abs_err"],
                 "bound_ms": bnd[0], "bound_by": bnd[1]}
        if timed:
            x, _s, wg, wu, wd, _p = args
            h = randn((m, f), bf16)

            def products():
                return x @ wg, x @ wu, h @ wd
            entry.update(in_turns(lambda: fb.fused_block_cuda(*args, **kw),
                                  lambda: fb.fused_block_torch(*args, **kw),
                                  reps))
            entry["matmul_ms"] = min(time_ms(products, reps=reps, warmup=1)
                                     for _ in range(2))
            log(f"  fused_block {what}: {entry['ms']:.4g} ms (bound "
                f"{bnd[0]:.4g} ms, {bnd[1]}), plain {entry['plain_ms']:.4g}"
                f" ms, products in cuBLAS {entry['matmul_ms']:.4g} ms")
            del x, wg, wu, wd, h
        out["fused_block"][what] = entry
        del args
        torch.cuda.empty_cache()
    return out


def check_wide_block(arch, m, block, close_variant, cases, timed) -> dict:
    """K7 on ``arch``'s MLP at its full width in float32, M rows: rows wider
    than the SIMT row tiles hold, so the ``simt_wide`` passes; held against
    the plain version at ``LM_TOL["float32"]`` and, if ``timed``, timed
    beside it (plain, kernel, kernel, plain) with its bound.  The weights
    are freed before the next case."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_block as fb

    cfg = get_config(arch)
    d, f = cfg.d_model, cfg.d_ff
    args = block(m, d, f, torch.float32)
    kw = dict(act=cfg.act, gated=cfg.mlp_gated, sandwich=cfg.sandwich_norm)
    what = (f"{arch} width float32, M {m}, d {d}, F {f}, "
            f"{'gated' if cfg.mlp_gated else 'ungated'} {cfg.act}"
            f"{', sandwich' if cfg.sandwich_norm else ''}")
    close_variant(fb.fused_block_cuda, fb.fused_block_torch, args, kw, what,
                  "simt_wide")
    bnd = fused_block_bound(m, d, f, cfg.mlp_gated, 4)
    entry = {"arch": arch, "M": m, "d": d, "F": f, "gated": cfg.mlp_gated,
             "sandwich": cfg.sandwich_norm, "dtype": "float32",
             "variant": cases[-1]["variant"],
             "max_abs_err": cases[-1]["max_abs_err"],
             "splits": fb.simt_wide_splits(
                 m, d, f, torch.cuda.get_device_properties(0)
                 .multi_processor_count),
             "bound_ms": bnd[0], "bound_by": bnd[1]}
    if timed:
        def kernel():
            return fb.fused_block_cuda(*args, **kw)

        def plain():
            return fb.fused_block_torch(*args, **kw)
        entry.update(in_turns(kernel, plain, reps=3))
        log(f"  fused_block {what}: {entry['ms']:.4g} ms on "
            f"{entry['variant']} (bound {bnd[0]:.4g} ms, {bnd[1]}), plain "
            f"{entry['plain_ms']:.4g} ms")
    del args
    torch.cuda.empty_cache()
    return entry


def earlier_design_times(full_attn, win, prefill_x, decode_x, gelu,
                         reps) -> dict:
    """``{name: (ms, max abs err against the plain version)}`` of the SIMT
    kernels on the bfloat16 serve-shape inputs that the tensor-core kernels
    now take, launched through their C entry points (the wrappers' rule no
    longer sends bfloat16 there) with the arguments the wrappers gave them:
    the earlier design, timed in the same run beside the new one.  These
    launches go through no wrapper and count nowhere."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_block as fb

    lib = _build.load()
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q, k, v = full_attn
    b, s, nh, hd = q.shape
    o = torch.empty_like(q)

    def attention():
        _build.check(lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, s,
            nh, k.shape[2], hd, hd ** -0.5, 1, win, 0.0, 0, 1, dev, stream),
            "flash_attention (earlier design)")
        return o

    def block(args):
        x, scale, wg, wu, wd, _post = args
        m, d = x.shape
        f = wu.shape[1]
        bf, splits = fb.simt_slabs(
            fb.fused_block_variant(torch.float32, m, d, f, sms), m, f, sms)
        out = torch.empty_like(x)
        part = torch.empty((splits, m, d), dtype=torch.float32,
                           device=x.device)

        def run():
            _build.check(lib.fused_block_launch(
                x.data_ptr(), scale.data_ptr(), wg.data_ptr(),
                wu.data_ptr(), wd.data_ptr(), None, out.data_ptr(), None,
                part.data_ptr(), m, d, f, bf, splits, 1, int(gelu), 0,
                fb.EPS, 1, dev, stream), "fused_block (earlier design)")
            return out
        return run

    act = "gelu" if gelu else "silu"
    runs = {"flash_attention": (
                attention, lambda: fa.flash_attention_torch(q, k, v,
                                                            window=win)),
            "fused_block": (block(prefill_x), lambda: fb.fused_block_torch(
                *prefill_x[:5], act=act)),
            "fused_block_decode": (block(decode_x),
                                   lambda: fb.fused_block_torch(
                                       *decode_x[:5], act=act))}
    out = {}
    rtol, atol = LM_TOL["bfloat16"]
    for name, (run, plain) in runs.items():
        got, want = run().float(), plain().float()
        err = max_abs_err(got, want)
        require(torch.allclose(got, want, rtol=rtol, atol=atol),
                f"{name}, earlier design: max abs err {err}")
        out[name] = (min(time_ms(run, reps=reps, warmup=1)
                         for _ in range(2)), err)
    return out


def ssd_float64(x, dt, A, Bm, Cm, D, h0, chunk):
    """The chunked SSD of ``ssd_chunked`` evaluated in float64 throughout
    (cum included): the yardstick K8 and its plain version are both held
    against at the serve's shape, to show how far float32 carries."""
    import torch
    import torch.nn.functional as F
    f64 = torch.float64
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    pad = (-s) % chunk
    nc = (s + pad) // chunk

    def chunks(t):
        t = F.pad(t.to(f64), (0, 0) * (t.ndim - 2) + (0, pad))
        return t.reshape(b, nc, chunk, *t.shape[2:])
    xc, dtc, Bc, Cc = chunks(x), chunks(dt), chunks(Bm), chunks(Cm)
    Bc, Cc = (t.repeat_interleave(h // g, dim=3) for t in (Bc, Cc))
    cum = torch.cumsum(dtc * A.to(f64), dim=2)               # [b,nc,l,h]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    state = (torch.zeros((b, h, p, n), dtype=f64, device=x.device)
             if h0 is None else h0.to(f64))
    ys = []
    for c in range(nc):
        ck, xdt = cum[:, c], xc[:, c] * dtc[:, c][..., None]
        L = torch.exp((ck[:, :, None] - ck[:, None]).masked_fill(~causal,
                                                                 -1e300))
        sc = torch.einsum("blhn,bmhn->blmh", Cc[:, c], Bc[:, c]) * L
        ys.append(torch.einsum("blmh,bmhp->blhp", sc, xdt)
                  + torch.einsum("blhn,bhpn->blhp", Cc[:, c], state)
                  * torch.exp(ck)[..., None])
        decay = torch.exp(ck[:, -1:] - ck)[..., None]
        state = (state * torch.exp(ck[:, -1])[:, :, None, None]
                 + torch.einsum("blhn,blhp->bhpn", Bc[:, c], xdt * decay))
    y = torch.cat(ys, dim=1)[:, :s] + x.to(f64) * D.to(f64)[:, None]
    return y, state


def check_ssd_kernel(timed: bool, reps: int) -> dict:
    """K8 against its plain version on the GPU, on ``y`` and on the final
    state: at the full-width shape of SSD_ARCH's serve in bfloat16 and in
    float32, at a ragged length with a non-zero initial state, with 8
    groups (the head -> group map), and at a ragged chunk, head dim and
    state dim, each in both types; every case names the variant it must
    run (bfloat16: the tensor cores).  B and C are the two halves of one
    projection, read in place, as the model hands them over.  Returns
    ``{"errs", "cases", "against_float64"[, "times"]}``; the time is a
    launch through the wrapper by CUDA events at the serve's shape, from
    the zero state of a fresh cache, beside the plain version's and the
    SIMT kernel's on the same bfloat16 inputs (``earlier_design_ms``).  No
    single PyTorch call computes the scan (no library time)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ss

    cfg = get_config(SSD_ARCH)
    shape = LM_SERVES[SSD_ARCH]["shape"]
    b, s = shape["batch"], shape["prompt_len"]
    h, p, g = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups
    n, q = cfg.ssm_state, cfg.ssm_chunk
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4000)

    def randn(shape, dtype=f32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(dtype)

    def inputs(b, s, h, g, p, n, dtype, h0):
        """x, dt (after softplus), A < 0, B and C (halves of one
        projection), D and h0 (None, "zero" or "random")."""
        bc = randn((b, s, 2 * g * n), dtype)
        Bm, Cm = (t.reshape(b, s, g, n)
                  for t in torch.split(bc, [g * n, g * n], dim=-1))
        state = {None: None, "zero": torch.zeros((b, h, p, n), device="cuda"),
                 "random": randn((b, h, p, n))}[h0]
        return (randn((b, s, h, p), dtype), F.softplus(randn((b, s, h))),
                -torch.exp(randn((h,), scale=0.5)), Bm, Cm, randn((h,)),
                state)

    errs, cases = {"ssd_scan": 0.0}, []
    serve_in = inputs(b, s, h, g, p, n, bf16, "zero")
    tc, simt = "tensor_core", "simt"
    ssd_cases = [
        ("serve shape bf16, the zero state of a fresh cache", serve_in, q,
         tc),
        ("serve shape float32, no state", inputs(b, s, h, g, p, n, f32, None),
         q, simt),
        ("ragged S 2000, random h0, bf16",
         inputs(b, 2000, h, g, p, n, bf16, "random"), q, tc),
        ("ragged S 2000, random h0, float32",
         inputs(2, 2000, h, g, p, n, f32, "random"), q, simt),
        ("8 groups of 10 heads, S 777, random h0, float32",
         inputs(2, 777, h, 8, p, n, f32, "random"), q, simt),
        ("8 groups of 10 heads, S 777, random h0, bf16",
         inputs(2, 777, h, 8, p, n, bf16, "random"), q, tc),
        ("p 24, n 40, 6 heads in 3 groups, chunk 100, S 333, float32",
         inputs(3, 333, 6, 3, 24, 40, f32, "random"), 100, simt),
        # every dimension off the tensor-core kernel's tiles
        ("p 24, n 40, 6 heads in 3 groups, chunk 100, S 333, bf16",
         inputs(3, 333, 6, 3, 24, 40, bf16, "random"), 100, tc),
        # a rank's heads on a model axis of 2 (phase 10)
        (f"rank shape: {h // 2} of the {h} heads, bf16, zero state",
         inputs(b, s, h // 2, g, p, n, bf16, "zero"), q, tc),
    ]
    float64 = {}
    for what, args, chunk, variant in ssd_cases:
        tol = SSD_TOL[str(args[0].dtype).split(".")[-1]]
        (y_k, st_k), ran = ran_variant(
            ss.ssd_scan_cuda, lambda: ss.ssd_scan_cuda(*args, chunk=chunk))
        log(f"  ssd_scan {what}: ran the {ran} kernel")
        require(ran == variant,
                f"ssd_scan {what}: ran the {ran} kernel, not {variant}")
        y_p, st_p = ss.ssd_scan_torch(*args, chunk=chunk)
        require_close("ssd_scan", y_k, y_p, what + ": y", tol, errs, cases)
        cases[-1]["variant"] = ran
        require_close("ssd_scan", st_k, st_p, what + ": state",
                      SSD_TOL["float32"], errs, cases)
        cases[-1]["variant"] = ran
        if what.startswith("serve shape"):
            y_64, st_64 = ssd_float64(*args, chunk)
            float64[ran] = {
                "case": what, "max_abs_y": float(y_64.abs().max()),
                "kernel_y": max_abs_err(y_k, y_64),
                "plain_y": max_abs_err(y_p, y_64),
                "kernel_state": max_abs_err(st_k, st_64),
                "plain_state": max_abs_err(st_p, st_64)}
            del y_64, st_64
            log(f"  ssd_scan against a float64 evaluation: "
                f"{json.dumps(float64[ran])}")
    torch.cuda.synchronize()
    out = {"errs": errs, "cases": cases, "against_float64": float64}
    if not timed:
        return out

    def kernel():
        return ss.ssd_scan_cuda(*serve_in, chunk=q)

    def plain():
        return ss.ssd_scan_torch(*serve_in, chunk=q)

    bf16_times = in_turns(kernel, plain, reps)
    bnd = ssd_bound(b, s, h, g, p, n, q, 2)
    earlier_ms, earlier_err = ssd_earlier_design_time(serve_in, q, reps)
    # the float32 case at the serve's shape (no state): the SIMT kernel
    f32_in = ssd_cases[1][1]

    def kernel_f32():
        return ss.ssd_scan_cuda(*f32_in, chunk=q)

    def plain_f32():
        return ss.ssd_scan_torch(*f32_in, chunk=q)

    f32_times = in_turns(kernel_f32, plain_f32, reps)
    bnd32 = ssd_bound(b, s, h, g, p, n, q, 4)
    rank_in = ssd_cases[-1][1]
    rank_times = in_turns(lambda: ss.ssd_scan_cuda(*rank_in, chunk=q),
                          lambda: ss.ssd_scan_torch(*rank_in, chunk=q), reps)
    bnd_rank = ssd_bound(b, s, h // 2, g, p, n, q, 2)
    out["times"] = {"ssd_scan": {
        **bf16_times, "bound_ms": bnd[0],
        "bound_by": bnd[1], "library_ms": None,
        "earlier_design_ms": earlier_ms,
        "earlier_design_max_abs_err": earlier_err,
        "multiply_adds": ssd_multiply_adds(b, s, h, g, p, n, q),
        "at_rank_shape": {
            **rank_times, "bound_ms": bnd_rank[0], "bound_by": bnd_rank[1],
            "library_ms": None,
            "shape": dict(b=b, s=s, h=h // 2, p=p, g=g, n=n, chunk=q,
                          dtype="bfloat16", h0="zero")},
        "shape": dict(b=b, s=s, h=h, p=p, g=g, n=n, chunk=q,
                      dtype="bfloat16", h0="zero",
                      variant=ran_variant(ss.ssd_scan_cuda, kernel)[1]),
        "float32": {
            **f32_times, "bound_ms": bnd32[0], "bound_by": bnd32[1], "library_ms": None,
            "shape": dict(b=b, s=s, h=h, p=p, g=g, n=n, chunk=q,
                          dtype="float32", h0=None,
                          variant=ran_variant(ss.ssd_scan_cuda,
                                              kernel_f32)[1])}}}
    return out


def ssd_earlier_design_time(serve_in, chunk, reps):
    """``(ms, max abs err of y against the plain version)`` of the SIMT
    kernel (``csrc/ssd_scan.cu``) on the bfloat16 serve inputs that the
    tensor-core kernel now takes, launched through its C entry point with
    the arguments the wrapper gave it: the earlier design, timed in the same
    run.  These launches go through no wrapper and count nowhere."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ss

    x, dt, A, Bm, Cm, D, h0 = serve_in
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    lib = _build.load()
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)

    def run():
        _build.check(lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
            state.data_ptr(), b, s, h, g, p, n, chunk, Bm.stride(1), 1, dev,
            stream), "ssd_scan (earlier design)")
        return y
    want = ss.ssd_scan_torch(*serve_in, chunk=chunk)[0]
    err = max_abs_err(run(), want)
    rtol, atol = SSD_TOL["bfloat16"]
    require(torch.allclose(run().float(), want.float(), rtol=rtol, atol=atol),
            f"ssd_scan, earlier design: max abs err {err}")
    return min(time_ms(run, reps=reps, warmup=1) for _ in range(2)), err


# ------------------------------------------------------------------ serve
# the f32 whole-model check (LM_SERVES[arch]["check"]): logits of the
# prefill and of one decode step within MODEL_CHECK_TOL of their scale,
# kernels against plain versions
MODEL_CHECK_TOL = 1e-3
# the names of every kernel in a torch.profiler trace (its __global__
# functions), by wrapper; a trace entry counts for a wrapper when one of
# them is a substring of its name
TRACE_NAMES = {"alloc_scan": ("alloc_scan_kernel",),
               "alloc_prefix": ("alloc_prefix_kernel",),
               "enum_frames": ("enum_frames_kernel",),
               "cost_rows": ("cost_rows_kernel", "cost_rows_split_kernel"),
               "argmin_rows": ("argmin_rows_kernel",),
               "score_batch": ("score_batch_kernel",
                               "score_batch_split_kernel"),
               "flash_attention": ("flash_attention_kernel",
                                   "flash_attention_tc_kernel"),
               "fused_block": ("fused_block_kernel",
                               "fused_block_reduce_kernel",
                               "fused_block_wide_norm_kernel",
                               "fused_block_wide_up_kernel",
                               "fused_block_wide_down_kernel",
                               "fused_block_wide_post_kernel",
                               "fused_block_norm_kernel",
                               "fused_block_up_kernel",
                               "fused_block_down_kernel",
                               "fused_block_post_kernel"),
               "ssd_scan": ("ssd_scan_kernel", "ssd_tc_chunk_state_kernel",
                            "ssd_tc_output_kernel"),
               "rglru_scan": ("rglru_scan_kernel",)}


def require_variants(counts: dict, expected: dict, what: str):
    """Each wrapper's per-variant launches equal to ``expected`` (a variant
    it does not name: 0)."""
    for name, by_variant in counts.items():
        want = {v: expected.get(name, {}).get(v, 0) for v in by_variant}
        require(by_variant == want,
                f"{what} launched {name} as {by_variant}, not {want}")


def device_time_all(prof) -> dict:
    """``{name: {"count", "device_ms"}}`` of every device activity in a
    trace taken with CUDA activity only (kernels, copies, sets)."""
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0))
        if dev_us:
            out[ev.key] = {"count": ev.count, "device_ms": dev_us / 1e3}
    return out


def serve_bounds(cfg, sc) -> dict:
    """The least time a serve's prefill and a decode step could take on
    the card, counted from the parameters of the layers that run (their
    shapes from a model on the meta device).  Prefill: two operations per
    weight per row it multiplies, at the bfloat16 tensor-core rate: the
    decoder's matrices over the prompt's tokens (a MoE layer's experts at
    top_k of E), a cross layer's key and value projections over the
    context instead, the encoder's over its frames, the unembedding over
    the last position only.  Decode step: every weight the step reads,
    once, at the memory rate: a MoE step computes every expert on its
    capacity buffer, so it reads them all; an untied embedding table gives
    two rows, and the encoder and the cross key / value projections do not
    run.  Left out: the embedding lookup, the norms, the attention's own
    products and the KV cache."""
    from repro_torch.models.model import Model

    model = Model(cfg, device="meta")
    b, s = sc.batch, sc.prompt_len
    ctx = {"audio": cfg.enc_seq, "vlm": cfg.vision_seq}.get(cfg.family, 0)
    ops = step_bytes = 0
    for name, p in model.named_parameters():
        n, parts = p.numel(), name.split(".")
        if name == "embed.tok" and not cfg.tie_embeddings:
            continue                             # a lookup of B rows
        if parts[0] in ("enc_layers", "enc_norm"):
            ops += 2 * n * b * ctx * (p.dim() >= 2)
            continue
        if parts[0] == "layers":
            kind = model.layers[int(parts[1])].kind
            if parts[-1] in ("wk", "wv") and (parts[2] == "xattn"
                                              or kind == "cross"):
                ops += 2 * n * b * ctx
                continue
        step_bytes += n * p.element_size()
        if p.dim() < 2:
            continue                             # norms and gates
        if parts[0] == "embed":
            ops += 2 * n * b                     # the last position's logits
        elif cfg.n_experts and parts[2] == "ffn" and p.dim() == 3:
            ops += 2 * n * b * s * cfg.top_k // cfg.n_experts
        else:
            ops += 2 * n * b * s
    return {"prefill_bound_ms": 1e3 * ops / PEAK_BF16_OPS_PER_S,
            "decode_step_bound_ms": 1e3 * step_bytes / PEAK_BYTES_PER_S,
            "prefill_operations": ops, "decode_step_bytes": step_bytes,
            "bounds_of": "prefill: 2 x each weight x the rows it multiplies "
                         "(prompt tokens; experts at top_k / E; cross K/V "
                         "and encoder: the context; unembedding: B rows) at "
                         "989e12 operations/s; decode step: the weights it "
                         "reads once at 3.35e12 B/s; embedding lookup, "
                         "norms, attention products, KV cache left out"}


def serve_phase(arch: str) -> dict:
    """``arch`` served at full width on the card (phase 5, see the module
    docstring): the counted main-path run, a second run for the times and a
    third traced with ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import (launch_counts, launch_counts_by_variant,
                                     reset_launch_counts)
    from repro_torch.launch.serve import ServeConfig, serve
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    shape, expected = LM_SERVES[arch]["shape"], LM_SERVES[arch]["launches"]
    sc = ServeConfig(**shape, seed=0)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    weight_bytes = 2 * cfg.param_count()
    log(f"serve of {arch}: {weight_bytes / 1e9:.2f} GB of bfloat16 weights, "
        f"{before / 1e9:.3f} GB allocated on the card before it, "
        f"{card_bytes / 1e9:.1f} GB in all")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    first = serve(cfg, sc)                          # the main path
    counts = launch_counts()
    by_variant = launch_counts_by_variant()
    peak = torch.cuda.max_memory_allocated()
    log(f"launches in one serve of {arch}: {counts}, by variant "
        f"{by_variant}")
    for name, n in counts.items():
        want = expected.get(name, 0)
        require(n == want,
                f"serve of {arch} launched {name} {n} times, not {want}")
    require_variants(by_variant,
                     LM_SERVES[arch].get("launches_by_variant", {}),
                     f"serve of {arch}")
    toks = first["tokens"]
    require(toks.shape == (sc.batch, sc.gen_len)
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
            f"serve returned tokens {toks.shape} outside [0, {cfg.vocab})")
    # the same weights handed in again, for the times and the trace (the
    # serve holds them in place: no second copy)
    weights = Model(cfg, device="cuda").init_weights(sc.seed).state_dict()
    second = serve(cfg, sc, params=weights)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = serve(cfg, sc, params=weights)
    by_name = device_time_all(prof)
    busy = sum(v["device_ms"] for v in by_name.values())
    kernels = {}
    for name in expected:
        names = TRACE_NAMES[name]
        by_kernel = {}
        for key, v in by_name.items():
            for n in names:
                if n in key:
                    got = by_kernel.setdefault(n, {"count": 0,
                                                   "device_ms": 0.0})
                    got["count"] += v["count"]
                    got["device_ms"] += v["device_ms"]
        kernels[name] = {
            "count": sum(v["count"] for v in by_kernel.values()),
            "device_ms": sum(v["device_ms"] for v in by_kernel.values()),
            "by_kernel": by_kernel}
    del weights
    runs = [{k: r[k] for k in ("prefill_s", "decode_s", "tok_per_s")}
            for r in (first, second, traced)]
    wall_ms = 1e3 * (second["prefill_s"] + second["decode_s"])
    return {
        "serve": arch, **shape, "dtype": cfg.dtype,
        "runs": runs, "launches": counts, "launches_by_variant": by_variant,
        **serve_bounds(cfg, sc),
        "peak_memory_bytes": peak, "allocated_before_bytes": before,
        "tokens_row0": toks[0].tolist(),
        "same_tokens_in_all_runs": bool(
            (toks == second["tokens"]).all()
            and (toks == traced["tokens"]).all()),
        "traced_device_busy_ms": busy if by_name else "not measured",
        "traced_device_activities": sum(v["count"] for v in by_name.values())
        if by_name else "not measured",
        "kernels_device_ms": kernels if by_name else "not measured",
        "kernels_share_of_device_busy":
            sum(k["device_ms"] for k in kernels.values()) / busy
            if by_name else "not measured",
        "device_busy_share_of_untraced_wall":
            busy / wall_ms if by_name else "not measured",
        "top_device_time": dict(sorted(
            by_name.items(), key=lambda kv: -kv[1]["device_ms"])[:8])}


def model_check(arch: str) -> dict:
    """``arch`` at full width in float32, at the depth, batch and prompt
    length of ``LM_SERVES[arch]["check"]`` (or ``LM_CHECKS[arch]``): the
    prefill and one decode step, through the kernels and again through
    their plain versions (``ops.plain_versions()``) on the same weights and
    tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import (launch_counts, launch_counts_by_variant,
                                     ops, reset_launch_counts)
    from repro_torch.models.model import Model

    require(not torch.backends.cuda.matmul.allow_tf32,
            "float32 matmuls would run in TF32")
    spec = {**LM_SERVES, **LM_CHECKS}[arch]
    check = spec["check"]
    b, s = check["batch"], check["prompt_len"]
    cfg = get_config(arch).replace(n_layers=check["n_layers"],
                                   dtype="float32", max_seq=s + 1)
    model = Model(cfg, device="cuda").init_weights(0)
    if "gates" in check:
        for layer in model.layers:
            if layer.kind == "cross":
                layer.attn.gate_attn.fill_(check["gates"])
                layer.attn.gate_mlp.fill_(check["gates"])
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)).cuda()}
    nxt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)).cuda()
    # random frames / patches: zeros would give every cross-attention
    # keys and values of 0
    for key, length in (("frames", cfg.enc_seq), ("patches",
                                                   cfg.vision_seq)):
        if key in model.batch_spec(s, b, "prefill"):
            batch[key] = torch.from_numpy(rng.standard_normal(
                (b, length, cfg.d_model)).astype(np.float32)).cuda()

    def run():
        pre, cache = model.prefill(batch)
        dec, _ = model.decode_step(cache, nxt)
        torch.cuda.synchronize()
        return pre, dec

    reset_launch_counts()
    with recorded_routes(cfg) as kernel_routes:
        kernel = run()
    counts = {k: n for k, n in launch_counts().items() if n}
    by_variant = launch_counts_by_variant()
    with ops.plain_versions(), recorded_routes(cfg) as plain_routes:
        plain = run()
    require(not any(launch_counts()[k] - counts.get(k, 0)
                    for k in launch_counts()),
            "plain_versions() launched a kernel")
    require(counts == spec["check_launches"],
            f"the kernel path of {arch} launched {counts}, not "
            f"{spec['check_launches']}")
    require_variants(by_variant, spec.get("check_launches_by_variant", {}),
                     f"the kernel path of {arch}")
    out = {"model_check": arch, **check, "dtype": "float32",
           "tolerance_of_scale": MODEL_CHECK_TOL, "launches": counts,
           "launches_by_variant": by_variant}
    for what, k, p in (("prefill", kernel[0], plain[0]),
                       ("decode", kernel[1], plain[1])):
        scale = float(p.abs().max())
        rel = max_abs_err(k, p) / scale
        require(bool(torch.isfinite(k).all()) and k.shape == p.shape
                and rel <= MODEL_CHECK_TOL,
                f"{what} logits: kernels vs plain versions {rel:.3g} of the "
                f"scale {scale:.3g}")
        out[what] = {"max_abs_err_over_scale": rel, "scale": scale,
                     "same_argmax": bool((k.argmax(-1) == p.argmax(-1))
                                         .all())}
    if cfg.n_experts:
        out["routes"] = compare_routes(kernel_routes, plain_routes)
        log(f"  routes of {arch}'s {len(plain_routes)} MoE calls, kernels "
            f"against plain versions: {json.dumps(out['routes'])}")
    return out


@contextlib.contextmanager
def recorded_routes(cfg):
    """Inside the block, record each MoE call's experts and its top
    ``top_k + 1`` router probabilities (for the margins), in call order;
    nothing without experts."""
    import torch
    from repro_torch.models import moe

    calls = []
    if not cfg.n_experts:
        yield calls
        return
    route = moe._route

    def recording(p, h2, c, router=None):
        got = route(p, h2, c, router)
        router = p.router if router is None else router
        probs = torch.softmax(h2.to(torch.float32)
                              @ router.to(torch.float32), dim=-1)
        calls.append((got[1], torch.topk(probs, c.top_k + 1, dim=-1).values))
        return got
    moe._route = recording
    try:
        yield calls
    finally:
        moe._route = route


def compare_routes(kernel, plain) -> dict:
    """Whether two runs routed every token of every MoE call to the same
    experts in the same order; where not, each such token with its margin
    in the plain run (the least gap between its top ``top_k + 1``
    probabilities)."""
    import torch
    require(len(kernel) == len(plain),
            f"{len(kernel)} MoE calls against {len(plain)}")
    differ = []
    for i, ((ki, _kp), (pi, pp)) in enumerate(zip(kernel, plain)):
        rows = torch.nonzero((ki != pi).any(dim=-1)).flatten().tolist()
        gaps = (pp[:, :-1] - pp[:, 1:]).amin(dim=-1)
        differ += [{"call": i, "token": r, "margin": float(gaps[r])}
                   for r in rows]
    return {"calls": len(plain),
            "tokens": sum(int(p[0].shape[0]) for p in plain),
            "equal": not differ, "differences": differ[:20]}


# ------------------------------------------------------------------ train
# phase 7's full run: smollm-360m at its published width and depth, the JAX
# CLI's batch and sequence, float32 masters, bfloat16 activations
TRAIN_ARCH = "smollm-360m"
TRAIN_RUN = {"batch": 8, "seq": 512, "steps": 12,
             "opt": {"lr": 6e-4, "warmup_steps": 4, "total_steps": 12}}
# the full run's remat policies, in the order phase 7 runs them (same
# weights, same data: the second run's losses are held to the first's)
TRAIN_REMATS = ("full", "dots")
TRAIN_LOSS_TOL = 1e-4            # remat changes no value
# launches a step: remat="full" runs each layer's forward again in the
# backward, so K6 and K7 launch twice a layer (the forward and the
# recomputation; their backwards are plain torch); "dots" keeps K7's
# output and runs K6 again; bfloat16 with 16-byte rows: all on the tensor
# cores
TRAIN_LAUNCHES_PER_STEP = {
    "full": {"flash_attention": 2 * 32, "fused_block": 2 * 32},
    "dots": {"flash_attention": 2 * 32, "fused_block": 32}}
# the cost model's cell of the full run (``utils/costmodel.py::cell_cost``:
# 4 forwards' FLOPs a step under remat="full", 3 otherwise), its FLOPs
# over the bfloat16 dense peak: the run's model FLOPs utilisation
TRAIN_CELL = ("smollm_train", 512, 8, "train")
# the float32 gradient checks, full width, cut depth, each against plain
# autograd with remat="none": each forward kernel once a layer, twice under
# remat="full" (the per-layer checkpoint runs the layer again in the
# backward), and K9 again in each recurrent layer's backward (the reversed
# recurrence); float32 runs on the SIMT kernels (K7's 1,024 rows are 128 row
# tiles, fewer than the SMs: simt_split)
GRAD_CHECKS = {
    "smollm-360m": {
        "arch": "smollm-360m", "n_layers": 2, "remat": "none",
        "launches": {"flash_attention": 2, "fused_block": 2},
        "by_variant": {"flash_attention": {"simt": 2},
                       "fused_block": {"simt_split": 2}}},
    "smollm-360m remat=full": {
        "arch": "smollm-360m", "n_layers": 2, "remat": "full",
        "launches": {"flash_attention": 4, "fused_block": 4},
        "by_variant": {"flash_attention": {"simt": 4},
                       "fused_block": {"simt_split": 4}}},
    "recurrentgemma-2b": {
        "arch": "recurrentgemma-2b", "remat": "none",
        "n_layers": 3,                  # recurrent, recurrent, local
        "launches": {"flash_attention": 1, "fused_block": 3,
                     "rglru_scan": 2 + 2},
        "by_variant": {"flash_attention": {"simt": 1},
                       "fused_block": {"simt_split": 3}}},
    "mamba2-2.7b": {
        "arch": "mamba2-2.7b", "n_layers": 2, "remat": "none",
        "launches": {"ssd_scan": 2},
        "by_variant": {"ssd_scan": {"simt": 2}}},
    # "dots": K6 again in the recomputation, K7's output kept; K9 as under
    # "full" (the forward, the recomputation and the backward)
    "smollm-360m remat=dots": {
        "arch": "smollm-360m", "n_layers": 2, "remat": "dots",
        "launches": {"flash_attention": 4, "fused_block": 2},
        "by_variant": {"flash_attention": {"simt": 4},
                       "fused_block": {"simt_split": 2}}},
    "recurrentgemma-2b remat=dots": {
        "arch": "recurrentgemma-2b", "remat": "dots", "n_layers": 3,
        "launches": {"flash_attention": 2, "fused_block": 3,
                     "rglru_scan": 2 + 2 + 2},
        "by_variant": {"flash_attention": {"simt": 2},
                       "fused_block": {"simt_split": 3}}},
}
GRAD_BATCH = (2, 512)
GRAD_LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3                  # of each parameter's largest gradient
RESTART_TOL = 1e-4               # the JAX package's restart test's
RESTART_LAYERS = 2


def train_config(n_layers=None):
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH).replace(max_seq=TRAIN_RUN["seq"])
    return cfg.replace(n_layers=n_layers) if n_layers else cfg


def train_data(cfg):
    from repro_torch.data.pipeline import DataConfig
    return DataConfig(seq_len=TRAIN_RUN["seq"],
                      global_batch=TRAIN_RUN["batch"], vocab=cfg.vocab,
                      seed=0)


def fresh_dir(name: str) -> Path:
    import shutil
    path = ROOT / "build" / name
    shutil.rmtree(path, ignore_errors=True)
    return path


def trace_groups(by_name: dict) -> dict:
    """Device ms of a trace by group: K6, K7, the cuBLAS products, the
    rest."""
    groups = {"flash_attention": 0.0, "fused_block": 0.0, "gemm": 0.0,
              "other": 0.0}
    for key, v in by_name.items():
        if any(n in key for n in TRACE_NAMES["flash_attention"]):
            g = "flash_attention"
        elif any(n in key for n in TRACE_NAMES["fused_block"]):
            g = "fused_block"
        elif any(n in key.lower() for n in ("gemm", "cutlass", "xmma")):
            g = "gemm"
        else:
            g = "other"
        groups[g] += v["device_ms"]
    return groups


def train_full_run(remat: str) -> dict:
    """``train()`` on smollm-360m at full width and depth under ``remat``
    (phase 7): the counted main-path run, then one more step traced, with
    CUDA events around its forward, backward and optimizer."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import SyntheticSource
    from repro_torch.kernels import (launch_counts, launch_counts_by_variant,
                                     reset_launch_counts)
    from repro_torch.launch.steps import STEP_MARKS, make_train_step
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.utils.costmodel import cell_cost

    cfg = train_config()
    dc = train_data(cfg)
    opt = AdamWConfig(**TRAIN_RUN["opt"])
    steps = TRAIN_RUN["steps"]
    per_step = TRAIN_LAUNCHES_PER_STEP[remat]
    tc = TrainConfig(steps=steps, log_every=1, ckpt_every=steps + 1,
                     ckpt_dir=str(fresh_dir(f"train_{remat}")), seed=0,
                     remat=remat, opt=opt)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = train(cfg, tc, data_cfg=dc)                  # the main path
    counts = launch_counts()
    by_variant = launch_counts_by_variant()
    peak = torch.cuda.max_memory_allocated()
    log(f"launches in {steps} train steps of {TRAIN_ARCH} under "
        f"remat={remat!r}: {counts}, by variant {by_variant}")
    for name, n in counts.items():
        want = steps * per_step.get(name, 0)
        require(n == want, f"training under remat={remat!r} launched {name} "
                           f"{n} times, not {want}")
    require_variants(by_variant, {
        name: {"tensor_core": steps * n} for name, n in per_step.items()},
        f"training under remat={remat!r}")
    losses = [loss for _s, loss in out["losses"]]
    require(len(losses) == steps
            and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0],
            f"training losses {losses}: not {steps} finite, falling ones")
    step_ms_each = [1e3 * t for t in out["step_s"]]
    median_s = sorted(out["step_s"][1:])[(steps - 1) // 2]
    flops = cell_cost(cfg, ShapeCell(*TRAIN_CELL), 1, remat=remat).flops

    model, opt_state = out["model"], out["opt_state"]
    batch = SyntheticSource(dc).batch_at(steps)
    ev = {m: torch.cuda.Event(enable_timing=True) for m in STEP_MARKS}
    peaks = {}

    def mark(m):
        ev[m].record()
        peaks[m] = torch.cuda.max_memory_allocated()

    step_fn = make_train_step(model, opt, remat=remat, mark=mark)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_fn(opt_state, batch)
        torch.cuda.synchronize()
    parts = {f"{b}_ms": ev[a].elapsed_time(ev[b])
             for a, b in zip(STEP_MARKS, STEP_MARKS[1:])}
    step_ms = sum(parts.values())
    by_name = device_time_all(prof)
    busy = sum(v["device_ms"] for v in by_name.values())
    del model, opt_state, step_fn, out
    torch.cuda.empty_cache()
    return {
        "train": TRAIN_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "batch": TRAIN_RUN["batch"], "seq": TRAIN_RUN["seq"],
        "steps": steps, "remat": remat, "dtype": cfg.dtype,
        "param_dtype": "float32", "opt": TRAIN_RUN["opt"], "losses": losses,
        "step_ms": step_ms_each,
        "step_ms_median_2_to_12": 1e3 * median_s,
        "tokens_per_s": TRAIN_RUN["batch"] * TRAIN_RUN["seq"] / median_s,
        "peak_memory_bytes": peak, "launches": counts,
        "launches_by_variant": by_variant,
        "model_flops_per_step": flops,
        "model_flops_of": f"utils/costmodel.py::cell_cost(smollm-360m, "
                          f"ShapeCell{TRAIN_CELL}, 1, remat={remat!r})",
        "mfu": flops / median_s / PEAK_BF16_OPS_PER_S,
        "mfu_peak": "PEAK_BF16_OPS_PER_S",
        "mfu_peak_ops_per_s": PEAK_BF16_OPS_PER_S,
        "traced_step": {
            **parts, "step_ms": step_ms,
            "backward_share": parts["backward_ms"] / step_ms,
            # the peak up to the end of the backward (the activations a
            # remat policy keeps), and the step's (AdamW's temporaries)
            "peak_memory_bytes_to_backward": peaks["backward"],
            "peak_memory_bytes": peaks["optimizer"],
            "device_busy_ms": busy if by_name else "not measured",
            "by_group_device_ms": trace_groups(by_name)
            if by_name else "not measured",
            "top_device_time": dict(sorted(
                by_name.items(), key=lambda kv: -kv[1]["device_ms"])[:10])}}


def grad_check(check: str) -> dict:
    """``GRAD_CHECKS[check]``'s model in float32 at full width and its
    depth, weights from ``torch.Generator(0)``, batch 2 x 512: the loss and
    every parameter's gradient through the kernels (their
    ``autograd.Function``s) under the check's remat, against the same
    under ``ops.plain_versions()`` with remat="none" (ordinary autograd
    through the plain versions, no checkpoint)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import (launch_counts, launch_counts_by_variant,
                                     ops, reset_launch_counts)
    from repro_torch.launch.steps import train_params
    from repro_torch.models.model import Model

    spec = GRAD_CHECKS[check]
    arch = spec["arch"]
    b, s = GRAD_BATCH
    cfg = get_config(arch).replace(n_layers=spec["n_layers"],
                                   dtype="float32", max_seq=s)
    model = Model(cfg, device="cuda", param_dtype=torch.float32)
    model.init_weights(0)
    params = train_params(model)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(
        np.int32)).cuda() for k in ("tokens", "labels")}

    def run(remat):
        loss, _ = model.loss(batch, remat=remat)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        torch.cuda.synchronize()
        return loss.detach(), grads

    reset_launch_counts()
    loss_k, grads_k = run(spec["remat"])
    counts = {k: n for k, n in launch_counts().items() if n}
    by_variant = launch_counts_by_variant()
    with ops.plain_versions():
        loss_p, grads_p = run("none")
    require(not any(launch_counts()[k] - counts.get(k, 0)
                    for k in launch_counts()),
            "plain_versions() launched a kernel")
    require(counts == spec["launches"],
            f"the gradient check {check} launched {counts}, not "
            f"{spec['launches']}")
    require_variants(by_variant, spec["by_variant"],
                     f"the gradient check {check}")
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    require(math.isfinite(float(loss_k)) and loss_rel <= GRAD_LOSS_RTOL,
            f"{arch}: loss {float(loss_k)} through the kernels vs "
            f"{float(loss_p)} plain ({loss_rel:.3g} relative)")
    worst = (0.0, "")
    for name, gk, gp in zip(params, grads_k, grads_p):
        require(gk is not None and gp is not None,
                f"{arch}: no gradient for {name}")
        scale = float(gp.abs().max())
        rel = max_abs_err(gk, gp) / scale if scale else max_abs_err(gk, gp)
        require(bool(torch.isfinite(gk).all()) and rel <= GRAD_TOL,
                f"{arch}: gradient of {name} {rel:.3g} of its scale "
                f"{scale:.3g} from the plain versions'")
        worst = max(worst, (rel, name))
    del model, params, grads_k, grads_p
    torch.cuda.empty_cache()
    return {"grad_check": check, "arch": arch, "n_layers": spec["n_layers"],
            "batch": b, "seq": s, "dtype": "float32", "remat": spec["remat"],
            "remat_plain": "none",
            "loss": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel_err": loss_rel,
            "worst_grad_err_of_scale": worst[0], "worst_grad": worst[1],
            "tolerance": {"loss_rtol": GRAD_LOSS_RTOL,
                          "grad_of_scale": GRAD_TOL},
            "launches": counts, "launches_by_variant": by_variant}


def restart_check() -> dict:
    """smollm-360m at full width, depth ``RESTART_LAYERS``, batch 8 x 512:
    6 steps straight, against 3 steps, a checkpoint, and a fresh
    ``train()`` on the same directory that resumes at step 3; then the
    checkpoint read back (equal to the model of the 3-step run) and written
    again, each timed."""
    import torch
    from repro_torch.checkpoint.checkpoint import latest_step, restore, save
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.optim.adamw import AdamWConfig

    cfg = train_config(n_layers=RESTART_LAYERS)
    dc = train_data(cfg)
    opt = AdamWConfig(**TRAIN_RUN["opt"])

    def run(steps, directory, ckpt_every):
        return train(cfg, TrainConfig(steps=steps, log_every=1,
                                      ckpt_every=ckpt_every,
                                      ckpt_dir=str(directory), seed=0,
                                      opt=opt), data_cfg=dc)

    straight = dict(run(6, fresh_dir("train_straight"), 7)["losses"])
    directory = fresh_dir("train_restart")
    first = run(3, directory, 3)
    require(latest_step(directory) == 3, "no checkpoint at step 3")
    want = {k: v.cpu() for k, v in first["model"].state_dict().items()}
    del first
    resumed = run(6, directory, 7)
    got = dict(resumed["losses"])
    require(sorted(got) == [3, 4, 5],
            f"the resumed run logged steps {sorted(got)}, not 3-5")
    errs = {s: abs(got[s] - straight[s]) for s in got}
    require(all(e < RESTART_TOL for e in errs.values()),
            f"restart: losses {got} vs straight {straight}")
    del resumed
    torch.cuda.empty_cache()
    step_dir = directory / "step_000000003"
    n_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    t0 = time.perf_counter()
    tree = restore(directory, 3)
    read_s = time.perf_counter() - t0
    from repro_torch.convert import lm_params_from_numpy
    back = lm_params_from_numpy(cfg, tree[0])
    require(all(torch.equal(back[k], want[k]) for k in want),
            "the checkpoint's parameters are not the 3-step run's")
    t0 = time.perf_counter()
    save(tree, fresh_dir("train_rewrite"), 3)
    write_s = time.perf_counter() - t0
    return {"restart": TRAIN_ARCH, "n_layers": RESTART_LAYERS,
            "batch": TRAIN_RUN["batch"], "seq": TRAIN_RUN["seq"],
            "straight_losses": [straight[s] for s in sorted(straight)],
            "resumed_losses_3_to_5": [got[s] for s in (3, 4, 5)],
            "max_abs_diff": max(errs.values()), "tolerance": RESTART_TOL,
            "checkpoint_bytes": n_bytes,
            "checkpoint_files": sorted(f.name for f in step_dir.iterdir()),
            "checkpoint_read_s": read_s, "checkpoint_write_s": write_s,
            "os_cpu_count": os.cpu_count()}


def train_phase() -> dict:
    """Phase 7 (see the module docstring)."""
    t0 = time.perf_counter()
    runs = {}
    for remat in TRAIN_REMATS:
        t1 = time.perf_counter()
        runs[remat] = train_full_run(remat)
        log(json.dumps(runs[remat]))
        log(f"  train run under remat={remat!r} "
            f"({time.perf_counter() - t1:.1f} s)")
    first = runs[TRAIN_REMATS[0]]["losses"]
    for remat in TRAIN_REMATS[1:]:
        errs = [abs(a - b) for a, b in zip(runs[remat]["losses"], first)]
        require(max(errs) <= TRAIN_LOSS_TOL,
                f"remat={remat!r}: losses {runs[remat]['losses']} are "
                f"{max(errs):.3g} from remat={TRAIN_REMATS[0]!r}'s {first}")
        log(f"  remat={remat!r} losses within {max(errs):.3g} of "
            f"remat={TRAIN_REMATS[0]!r}'s, step by step (limit "
            f"{TRAIN_LOSS_TOL})")
    checks = {}
    for check in GRAD_CHECKS:
        t1 = time.perf_counter()
        checks[check] = grad_check(check)
        log(json.dumps(checks[check]))
        log(f"  gradient check {check} ({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    restart = restart_check()
    log(json.dumps(restart))
    log(f"  restart check ({time.perf_counter() - t1:.1f} s)")
    return {"runs": runs, "grad_checks": checks, "restart": restart,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------- examples
# the example twins, each run at its defaults (``--device`` is cuda by
# default; only where it writes goes to a fresh directory under build/),
# with the kernels it must launch: the quickstart's efficientnet-b1 is a
# descent net, which the default options score on the host (phase 3), so
# it launches none; resnet50's 8,748 tuples go through the pipeline (K1-K3)
EXAMPLES = {
    "quickstart_torch": ({}, ()),
    "serve_compile_torch": ({"--cache-dir": "examples/plans"},
                            ("alloc_scan", "enum_frames", "cost_rows")),
    "serve_lm_torch": ({}, ("flash_attention", "fused_block", "rglru_scan")),
    "train_lm_torch": ({"--ckpt-dir": "examples/train_lm"},
                       ("flash_attention", "fused_block")),
}


def examples_phase() -> dict:
    """Phase 8: each example twin's ``main`` on the card, its output
    captured, with its wall seconds and launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    rows = {}
    for name, (dirs, needed) in EXAMPLES.items():
        argv = [arg for flag, sub in dirs.items()
                for arg in (flag, str(fresh_dir(sub)))]
        main_fn = runpy.run_path(str(ROOT / "examples" / f"{name}.py"))["main"]
        out = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main_fn(argv)
        wall = time.perf_counter() - t0
        counts = {k: n for k, n in launch_counts().items() if n}
        lines = out.getvalue().splitlines()
        require(lines and all(counts.get(k) for k in needed),
                f"{name}: printed {len(lines)} lines, launched {counts}, "
                f"not each of {needed}")
        rows[name] = {"example": name, "argv": argv, "wall_s": wall,
                      "launches": counts, "lines": len(lines),
                      "last_line": lines[-1]}
        log(json.dumps(rows[name]))
    return rows


# -------------------------------------------------------------------- mesh
# phase 9: the dry-run's memory model against the card at phase 5's serve
# shapes of these, within MESH_MEMORY_TOL of the rise in allocated bytes
MESH_MEMORY_ARCHS = ("recurrentgemma-2b", "whisper-base")
MESH_MEMORY_TOL = 0.01
# a mesh of one rank (NCCL, world 1) against no mesh: recurrentgemma-2b
# served whole (its plan on 1 x 1 is FSDP: every weight read through an
# all-gather of one rank), and smollm-360m trained whole as phase 7 trains
# it, with FSDP forced on (the gathers in the forward and the
# recomputation, the reduce-scatters in the backward); each bit-equal to
# the meshless run, with the same launches of these kernels
MESH_SERVE = ("recurrentgemma-2b",
              {"batch": 2, "prompt_len": 512, "gen_len": 8})
MESH_SERVE_KERNELS = ("flash_attention", "fused_block", "rglru_scan")
MESH_TRAIN_STEPS = 3
MESH_TRAIN_KERNELS = ("flash_attention", "fused_block")
# the traced half of the dry-run on mesh (1, 1) against the card: one step
# (``dryrun.cell_step``) of each, traced on a fake rank
# (``dryrun.trace_cell``), then run on the card; the traced peak
# (arguments + the most live temporaries, each storage rounded up to
# 512 B as the caching allocator rounds a block) within MESH_TRACE_TOL of
# the rise of ``torch.cuda.max_memory_allocated()`` over the step from
# before its model was placed.  The trace sees every tensor the step's
# ops make and frees each when its last reference goes, as the allocator
# does; it does not see what is allocated inside a launch (cuBLAS's
# workspace, made once a handle and stream and already there by phase 9)
# nor a library's scratch inside an op (a sort's, a reduction's), which
# the card's peak holds for the op's duration: a few MB at these shapes,
# far under 10 % of steps of 1.5-12 GB.  The tolerance covers those with
# room; a miscount of one saved activation a layer would exceed it.
MESH_TRACES = {
    "smollm-360m train": ("smollm-360m", ("smollm_train", 512, 8, "train"),
                          "full"),
    "recurrentgemma-2b prefill": ("recurrentgemma-2b",
                                  ("serve", 3072, 2, "prefill"), "full")}
MESH_TRACE_TOL = 0.10


def allocator_bound(sizes) -> int:
    """The most that ``torch.cuda.memory_allocated()`` rises by when
    tensors of ``sizes`` bytes are allocated: the caching allocator rounds
    each request up to 512 B, and gives a request above 1 MiB the rest of
    its block too when that rest is 1 MiB or less (it splits a large
    block only for a larger rest)."""
    mib = 1 << 20
    return sum(-(-max(n, 1) // 512) * 512 + (mib if n > mib else 0)
               for n in sizes)


def allocator_blocks(storages: dict) -> tuple[int, int]:
    """The sizes and requested sizes, summed, of the caching allocator's
    blocks (``torch.cuda.memory_snapshot()``) that start at the
    addresses of ``storages`` (``{data_ptr: nbytes}``)."""
    import torch

    size = requested = 0
    found = set()
    for seg in torch.cuda.memory_snapshot():
        for block in seg["blocks"]:
            if (block["state"] == "active_allocated"
                    and block["address"] in storages):
                found.add(block["address"])
                size += block["size"]
                requested += block["requested_size"]
    require(found == set(storages),
            f"{len(set(storages) - found)} of {len(storages)} storages have "
            f"no block in the allocator's snapshot")
    return size, requested


def mesh_memory(arch: str) -> dict:
    """The dry-run's per-device parameter and cache bytes of ``arch``'s
    phase-5 serve on a 1 x 1 mesh against what placing them allocates,
    each part on its own: the tensors' bytes equal the prediction, and
    the rise in ``torch.cuda.memory_allocated()`` is the allocator's
    blocks of them, within ``allocator_bound``; the total within
    ``MESH_MEMORY_TOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import make_plan
    from repro_torch.models.model import Model

    shape = LM_SERVES[arch]["shape"]
    batch, max_len = shape["batch"], shape["prompt_len"] + shape["gen_len"]
    cfg = get_config(arch).replace(max_seq=max_len)
    mesh = make_host_mesh()
    want = dryrun.cell_bytes(cfg, ShapeCell("serve", max_len, batch,
                                            "decode"), mesh,
                             make_plan(cfg, mesh))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = Model(cfg, device="cuda")
    torch.cuda.synchronize()
    rise_params = torch.cuda.memory_allocated() - before
    cache = model.init_cache(batch, max_len)
    torch.cuda.synchronize()
    rise_cache = torch.cuda.memory_allocated() - before - rise_params

    def tensors(node):
        if isinstance(node, torch.Tensor):
            yield node
        elif isinstance(node, dict):
            for v in node.values():
                yield from tensors(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from tensors(v)

    parts = {}
    # the cache's position: a host int here, the reference's int32 scalar
    # in the prediction
    for part, ts, rise, predicted in (
            ("params", list(model.parameters()), rise_params,
             want["params"]),
            ("cache", list(tensors(cache)), rise_cache, want["cache"] - 4)):
        placed = sum(t.numel() * t.element_size() for t in ts)
        storages = {t.untyped_storage().data_ptr():
                    t.untyped_storage().nbytes() for t in ts
                    if t.untyped_storage().nbytes()}
        blocks, requested = allocator_blocks(storages)
        bound = allocator_bound(storages.values())
        require(placed == predicted,
                f"{arch}: the dry-run predicts {predicted} B of {part}, "
                f"the port places {placed} B")
        require(requested == sum(storages.values()) and rise == blocks
                and placed <= rise <= bound,
                f"{arch}: placing {placed} B of {part} raised the "
                f"allocated bytes by {rise}; its blocks {blocks} B "
                f"(requested {requested} B), the allocator's bound {bound}")
        parts[part] = {"predicted_bytes": predicted, "placed_bytes": placed,
                       "allocated_rise_bytes": rise,
                       "allocator_blocks_bytes": blocks,
                       "allocator_bound_bytes": bound,
                       "rounding_bytes": rise - placed,
                       "tensors": len(storages)}
    del model, cache
    predicted = want["params"] + want["cache"]
    rise = rise_params + rise_cache
    err = abs(rise - predicted) / predicted
    require(err <= MESH_MEMORY_TOL,
            f"{arch}: the dry-run predicts {predicted} B of parameters and "
            f"cache, placing them allocated {rise} B (off by {err:.4f})")
    return {"arch": arch, "batch": batch, "max_len": max_len, **{
        f"{part}_{k}": v for part, row in parts.items()
        for k, v in row.items()},
            "predicted_bytes": predicted, "allocated_rise_bytes": rise,
            "relative_error": err}


def profile_summary(run, top: int = 8) -> dict:
    """``run()`` once under ``torch.profiler`` (CPU and CUDA): its wall,
    the device time in kernels and the ops with the most host and the
    most device time (self), in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()

    def dev(r):
        return getattr(r, "self_device_time_total",
                       getattr(r, "self_cuda_time_total", 0))

    def pick(key):
        return [{"op": r.key, "calls": r.count, "ms": key(r) / 1e3}
                for r in sorted(rows, key=key, reverse=True)[:top]
                if key(r) > 0]

    nccl = [r for r in rows if "nccl" in r.key.lower()
            or r.key.startswith("c10d::")]
    return {"wall_ms": wall * 1e3,
            "device_ms": sum(dev(r) for r in rows) / 1e3,
            "collective_calls": sum(r.count for r in nccl
                                    if r.key.startswith("c10d::")),
            "collective_host_ms": sum(r.self_cpu_time_total for r in nccl
                                      if r.key.startswith("c10d::")) / 1e3,
            "collective_device_ms": sum(dev(r) for r in nccl) / 1e3,
            "top_host": pick(lambda r: r.self_cpu_time_total),
            "top_device": pick(dev)}


def mesh_compare(what: str, run, kernels) -> dict:
    """``run(mesh)`` with no mesh and on a 1 x 1 mesh, each with its own
    launch counts; the two launch the same kernels the same times."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh

    outs, counts, walls = {}, {}, {}
    for name, mesh in (("no_mesh", None), ("mesh", make_host_mesh())):
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs[name] = run(mesh)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts[name] = launch_counts()
    require(counts["mesh"] == counts["no_mesh"]
            and all(counts["mesh"][k] > 0 for k in kernels),
            f"{what}: launches {counts['mesh']} on the mesh, "
            f"{counts['no_mesh']} without")
    return {"outs": outs, "launches": counts["mesh"], "wall_s": walls}


def mesh_checkpoint_peak(cfg, out: dict) -> dict:
    """A checkpoint's tree of a mesh train's result
    (``train.py::checkpoint_tree``): the rise of the device's peak while
    it is gathered, below the model's float32 parameters."""
    import torch
    from repro_torch.launch.train import checkpoint_tree

    sizes = [p.numel() * 4 for p in out["model"].parameters()]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = checkpoint_tree(cfg, out["model"], out["opt_state"], out["run"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    require(tree is not None and peak < sum(sizes),
            f"a checkpoint of the mesh train raised the device's peak by "
            f"{peak} B, the parameters are {sum(sizes)} B")
    return {"mesh_checkpoint": cfg.name, "peak_rise_bytes": peak,
            "param_bytes": sum(sizes), "largest_leaf_bytes": max(sizes),
            "seconds": seconds}


def mesh_traces() -> dict:
    """Each of ``MESH_TRACES`` traced on a fake rank of mesh (1, 1)
    (a process group of fake ranks started and destroyed by each)."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    out = {}
    for name, (arch, cell, remat) in MESH_TRACES.items():
        out[name] = dryrun.trace_cell(arch, ShapeCell(*cell), remat=remat,
                                      mesh=make_host_mesh())
        require(not dist.is_initialized(),
                f"the trace of {name}'s process group outlived it")
    return out


def mesh_trace_on_card(name: str, traced: dict) -> dict:
    """``MESH_TRACES[name]``'s step on the card on mesh (1, 1) (inside
    phase 9's process group of one): the rise of the allocated bytes over
    placing its model and inputs, and of the peak over the step, against
    the trace's arguments and peak."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch.distributed import MeshRun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model

    arch, cell, remat = MESH_TRACES[name]
    cfg, cell = dryrun.cell_config(arch, ShapeCell(*cell))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    run = MeshRun(cfg, make_host_mesh(), None, "cuda")
    model = Model(cfg, device="meta", param_dtype=(
        torch.float32 if cell.mode == "train" else None))
    run.place_init(model, 0)
    call, _args = dryrun.cell_step(model, run, cell, remat)
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    launches = launch_counts()
    del out, call, _args, model, run
    torch.cuda.empty_cache()
    mem = traced["memory"]
    err = (mem["peak_bytes"] - peak) / peak
    require(abs(err) <= MESH_TRACE_TOL,
            f"{name}: traced peak {mem['peak_bytes']} B, the card's "
            f"{peak} B (off by {err:+.4f}, > {MESH_TRACE_TOL})")
    return {"traced_step": name, "mesh": [1, 1], "remat": remat,
            "traced_peak_bytes": mem["peak_bytes"],
            "card_peak_rise_bytes": peak, "relative_error": err,
            "tol": MESH_TRACE_TOL,
            "traced_argument_bytes": mem["argument_bytes"],
            "card_placed_bytes": placed,
            "traced_temp_bytes": mem["temp_bytes"],
            "card_temp_rise_bytes": peak - placed,
            "traced_flops": traced["cost"]["flops"],
            "traced_bytes_accessed": traced["cost"]["bytes_accessed"],
            "trace_s": traced["trace_s"], "card_step_s": seconds,
            "launches": launches}


def mesh_phase() -> dict:
    """Phase 9 (see the module docstring)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config, valid_cells
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import ServeConfig, serve
    from repro_torch.launch.sharding import force_fsdp, make_plan
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.optim.adamw import AdamWConfig

    t0 = time.perf_counter()
    total_memory = torch.cuda.get_device_properties(0).total_memory
    log(f"  mesh: the card's total_memory {total_memory} B, "
        f"dryrun.H100_HBM_BYTES {dryrun.H100_HBM_BYTES} B")
    cells = [dryrun.run_cell(arch, shape, multi_pod=mp, device="cuda")
             for arch, shape in valid_cells() for mp in (False, True)]
    for res in cells:
        log(f"  dryrun {dryrun.cell_line(res)}")
    require(len(cells) == 64, f"the dry-run planned {len(cells)} cells")
    dry_s = time.perf_counter() - t0
    memory = {arch: mesh_memory(arch) for arch in MESH_MEMORY_ARCHS}
    for row in memory.values():
        log(f"  {json.dumps(row)}")
    t_traces = time.perf_counter()
    traced = mesh_traces()
    traces_s = time.perf_counter() - t_traces

    store = fresh_dir("mesh_store")
    store.mkdir(parents=True)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(store / "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        trace_rows = [mesh_trace_on_card(name, traced[name])
                      for name in MESH_TRACES]
        for row in trace_rows:
            log(json.dumps(row))
        arch, shape = MESH_SERVE
        cfg = get_config(arch)
        sc = ServeConfig(**shape, seed=0)
        plan = make_plan(cfg, make_host_mesh())
        served = mesh_compare(
            f"serve of {arch}",
            lambda mesh: serve(cfg, sc, mesh=mesh), MESH_SERVE_KERNELS)
        a, b = served["outs"]["no_mesh"], served["outs"]["mesh"]
        require(np.array_equal(a["tokens"], b["tokens"])
                and torch.equal(a["logits"], b["logits"]),
                f"serve of {arch} on a 1 x 1 mesh: tokens or logits differ "
                f"from the meshless serve's (max abs "
                f"{float((a['logits'] - b['logits']).abs().max())})")
        serve_row = {"mesh_serve": arch, **shape, "plan": plan.kind,
                     "fsdp": plan.fsdp, "launches": served["launches"],
                     "wall_s": served["wall_s"], "tokens_equal": True,
                     "logits_bit_equal": True,
                     "tokens_row0": a["tokens"][0].tolist()}
        del served, a, b
        log(json.dumps(serve_row))
        for name, mesh in (("no_mesh", None), ("mesh", make_host_mesh())):
            log(json.dumps({"mesh_serve_profile": name, **profile_summary(
                lambda: serve(cfg, sc, mesh=mesh))}))

        tcfg = train_config()
        tplan = force_fsdp(make_plan(tcfg, make_host_mesh()))

        def train_run(mesh):
            tc = TrainConfig(steps=MESH_TRAIN_STEPS, log_every=1,
                             ckpt_every=MESH_TRAIN_STEPS + 1,
                             ckpt_dir=str(fresh_dir("mesh_train")), seed=0,
                             opt=AdamWConfig(**TRAIN_RUN["opt"]))
            return train(tcfg, tc, data_cfg=train_data(tcfg), mesh=mesh,
                         plan=tplan if mesh is not None else None)

        trained = mesh_compare(f"training of {TRAIN_ARCH}", train_run,
                               MESH_TRAIN_KERNELS)
        la = [x for _s, x in trained["outs"]["no_mesh"]["losses"]]
        lb = [x for _s, x in trained["outs"]["mesh"]["losses"]]
        require(len(la) == MESH_TRAIN_STEPS and la == lb,
                f"training of {TRAIN_ARCH} on a 1 x 1 mesh with FSDP: "
                f"losses {lb}, without a mesh {la}")
        ckpt_row = mesh_checkpoint_peak(tcfg, trained["outs"]["mesh"])
        log(json.dumps(ckpt_row))
        train_row = {"mesh_train": TRAIN_ARCH, "batch": TRAIN_RUN["batch"],
                     "seq": TRAIN_RUN["seq"], "steps": MESH_TRAIN_STEPS,
                     "remat": "full", "plan": tplan.kind, "fsdp": tplan.fsdp,
                     "losses": lb, "losses_bit_equal": True,
                     "launches": trained["launches"],
                     "wall_s": trained["wall_s"], "checkpoint": ckpt_row}
        del trained
        log(json.dumps(train_row))
    finally:
        dist.destroy_process_group()
    require(not dist.is_initialized(), "the process group outlived phase 9")
    return {"seconds": time.perf_counter() - t0, "dryrun_s": dry_s,
            "traces_s": traces_s, "traces": trace_rows,
            "total_memory_bytes": total_memory, "memory": memory,
            "serve": serve_row, "train": train_row}


# phase 10: the model axis on one card: mesh (1, 2) as two rank processes
# over gloo (NCCL refuses two ranks on one device).  Each serve at full
# width in bfloat16 (its depth, where given, cut so both ranks fit), with
# its float32 check at cut depth against the run without a mesh; the
# kernels each must launch on every rank (a form in brackets).
MODEL_AXIS_DIMS = (1, 2)       # the world of every case without "dims"
MODEL_AXIS_TOL = 1e-4            # of the logits' / losses' scale, float32
MODEL_AXIS_TIMEOUT_S = 600
MODEL_AXIS_CP_ARCH = "smollm-360m"
MODEL_AXIS_SERVES = {
    # tp plan: heads 5 a rank, the one kv head whole, the local layers'
    # 2,048-slot ring split by sequence, F 3,840 a rank
    "recurrentgemma-2b": {
        "shape": {"batch": 2, "prompt_len": 3072, "gen_len": 16},
        "check": {"n_layers": 3, "batch": 2, "prompt_len": 512,
                  "gen_len": 4},
        "kernels": ("flash_attention", "fused_block[partial]",
                    "rglru_scan"),
        "fault": "ff_zero"},
    # hybrid plan: 15 heads whole on each rank, attention context-parallel
    # at the prefill, F and the vocabulary split
    "smollm-360m": {
        "shape": {"batch": 2, "prompt_len": 1024, "gen_len": 8},
        "cp": True,
        "check": {"n_layers": 2, "batch": 2, "prompt_len": 512,
                  "gen_len": 4},
        "kernels": ("flash_attention[q_offset]", "fused_block[partial]"),
        "fault": "cp_offset0"},
    # 40 of the 80 heads a rank; the float32 check at all 64 layers;
    # "spread": its runs without a mesh (float32 and bf16) also through
    # the plain versions, the logits' spread between K8 and its plain
    # version over the 64 layers, beside the mesh's
    "mamba2-2.7b": {
        "shape": {"batch": 4, "prompt_len": 2048, "gen_len": 16},
        "check": {"n_layers": 64, "batch": 2, "prompt_len": 512,
                  "gen_len": 4},
        "kernels": ("ssd_scan",), "spread": True},
    # 32 of the 64 experts a rank, the dispatch by all-to-all; 24 of the
    # 48 layers
    "moonshot-v1-16b-a3b": {
        "shape": {"batch": 2, "prompt_len": 2048, "gen_len": 16},
        "n_layers": 24,
        "check": {"n_layers": 2, "batch": 1, "prompt_len": 512,
                  "gen_len": 4},
        "kernels": ("flash_attention",)},
    # three ranks: the hybrid plan (64 heads, 128 experts: 3 divides
    # neither), so attention whole on each rank and the experts' ff split
    # (512 of 1,536 a rank), the MoE's local path; 2 of the 94 layers, K6
    # and nothing else (every layer is MoE), all on the tensor cores
    "qwen3-moe-235b-a22b": {
        "dims": (1, 3),
        "shape": {"batch": 2, "prompt_len": 2048, "gen_len": 16},
        "n_layers": 2,
        "check": {"n_layers": 1, "batch": 1, "prompt_len": 512,
                  "gen_len": 4},
        "kernels": ("flash_attention",), "only": True,
        "variants": {"flash_attention": "tensor_core"},
        "fault": "moe_ff_unreduced"},
}
# Megatron-SP (``seq_shard=True``): recurrentgemma-2b's serve and its
# float32 check again with the stream split by sequence, each against the
# same case on the ranks without SP: tokens equal, the float32 logits
# within MODEL_AXIS_SP_TOL of their scale (two ranks: a reduce-scatter
# adds the same two numbers as the all-reduce), the same launches; and
# one prefill and one decode step at the serve's shape whose collectives
# by kind equal the step's trace on fake ranks
MODEL_AXIS_SP = {"arch": "recurrentgemma-2b", "tol": 1e-5,
                 "step": {"batch": 2, "seq": 3072}}
MODEL_AXIS_TRAIN = {"arch": "smollm-360m", "batch": 8, "seq": 512,
                    "steps": 3, "check": {"n_layers": 2, "batch": 2,
                                          "seq": 256},
                    "kernels": ("flash_attention", "fused_block[partial]")}
MODEL_AXIS_PSUM = {"dims": (2, 1, 1), "numel": 1 << 20,
                   "r11": [[1.0, -0.5, 0.25], [10.0, 3.0, -7.0]]}


def model_axis_cfg(case: dict, seq: int):
    """``arch`` as phase 10 runs it: float32 at the check's depth, or
    bfloat16 at its full width (and the serve's cut depth, if any).  The
    float32 check of a config with experts takes a capacity of every
    token (``capacity_factor`` E / K): the mesh routes each rank's half of
    the rows with the capacity of that half, the run without a mesh all
    rows with theirs (the reference's two paths), and with no token
    dropped the two keep the same tokens."""
    from repro_torch.configs import get_config

    spec = (MODEL_AXIS_SERVES[case["arch"]] if case["kind"] == "serve"
            else MODEL_AXIS_TRAIN)
    cfg = get_config(case["arch"]).replace(max_seq=seq)
    if case["check"]:
        cfg = cfg.replace(n_layers=spec["check"]["n_layers"],
                          dtype="float32")
        if cfg.n_experts:
            cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
        return cfg
    return cfg.replace(n_layers=spec["n_layers"]) if spec.get(
        "n_layers") else cfg


def model_axis_jobs() -> list:
    """The cases both the ranks and the run without a mesh drive, in
    order: per serve its float32 check, its planted fault (ranks only) and
    its bfloat16 run; the training run likewise; the compressed psum.
    Each case names the dims of its world's mesh."""
    cases = []
    for arch, spec in MODEL_AXIS_SERVES.items():
        for check in (True, False):
            shape = spec["check"] if check else spec["shape"]
            base = dict(kind="serve", arch=arch, check=check,
                        dims=spec.get("dims", MODEL_AXIS_DIMS),
                        cp=spec.get("cp", False),
                        shape={k: shape[k] for k in ("batch", "prompt_len",
                                                     "gen_len")})
            cases.append(dict(base, id=f"{arch}-{'f32' if check else 'bf16'}"))
            if check and spec.get("fault"):
                cases.append(dict(base, id=f"{arch}-fault",
                                  fault=spec["fault"]))
            if arch == MODEL_AXIS_SP["arch"]:
                tag = "f32" if check else "bf16"
                cases.append(dict(base, seq_shard=True, sp_steps=not check,
                                  id=f"{arch}-sp-{tag}"))
    t = MODEL_AXIS_TRAIN
    for check in (True, False):
        shape = t["check"] if check else t
        cases.append(dict(kind="train", arch=t["arch"], check=check,
                          dims=MODEL_AXIS_DIMS,
                          id=f"train-{'f32' if check else 'bf16'}",
                          batch=shape["batch"], seq=shape["seq"],
                          steps=t["steps"]))
    cases.append(dict(kind="psum", id="psum", dims=MODEL_AXIS_DIMS))
    return cases


def model_axis_run(case: dict, mesh=None) -> dict:
    """One case of phase 10 on this process's card: without a mesh, or on
    ``mesh`` as one of its ranks (the process group started).  Returns
    what the comparison reads: logits or losses, tokens, walls, launches
    (all, by variant and by form), the collectives' host seconds, the peak
    of allocated bytes, and on a mesh the placed and predicted bytes."""
    import torch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import (launch_counts, launch_counts_by_form,
                                     launch_counts_by_variant,
                                     reset_launch_counts)
    from repro_torch.launch import tensor_parallel as tpc
    from repro_torch.launch.dryrun import (abstract_cache, abstract_params,
                                           shard_bytes)
    from repro_torch.launch.serve import ServeConfig, serve
    from repro_torch.launch.sharding import (cache_pspecs, make_plan,
                                             param_pspecs)
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.models.layers import model_dtype
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launch_counts()
    tpc.reset_transport()
    t0 = time.perf_counter()
    if case["kind"] == "serve":
        shape = case["shape"]
        seq = shape["prompt_len"] + shape["gen_len"]
        cfg = model_axis_cfg(case, seq)
        out = serve(cfg, ServeConfig(**shape, seed=0), mesh=mesh,
                    cp=case["cp"] and mesh is not None,
                    seq_shard=case.get("seq_shard", False))
        res = {"tokens": out["tokens"].tolist(),
               "logits": out["logits"].float().cpu(),
               "prefill_s": out["prefill_s"], "decode_s": out["decode_s"]}
    else:
        cfg = model_axis_cfg(case, case["seq"])
        out = train(cfg, TrainConfig(
            steps=case["steps"], log_every=1, ckpt_every=case["steps"] + 1,
            ckpt_dir=str(fresh_dir(f"model_axis_ckpt_{os.getpid()}")),
            seed=0, opt=AdamWConfig(**TRAIN_RUN["opt"])),
            data_cfg=DataConfig(seq_len=case["seq"],
                                global_batch=case["batch"], vocab=cfg.vocab,
                                seed=0), mesh=mesh)
        res = {"losses": [x for _s, x in out["losses"]],
               "step_s": out["step_s"]}
    torch.cuda.synchronize()
    res.update(wall_s=time.perf_counter() - t0,
               launches=launch_counts(),
               launches_by_variant=launch_counts_by_variant(),
               launches_by_form=launch_counts_by_form(),
               transport=dict(tpc.TRANSPORT),
               peak_bytes=torch.cuda.max_memory_allocated() - before)
    if case.get("sp_steps"):
        res["step_collectives"] = model_axis_sp_steps(cfg, mesh)
    if mesh is not None:
        plan = make_plan(cfg, mesh)
        meta = Model(cfg, device="meta")
        if case["kind"] == "serve":
            pdtype = model_dtype(cfg)
            res.update(param_bytes=out["param_bytes"],
                       cache_bytes=out["cache_bytes"])
            cache = abstract_cache(cfg, shape["batch"], seq)
            res["shard_cache_bytes"] = shard_bytes(
                cache, cache_pspecs(cache, mesh, shape["batch"], plan),
                mesh) - 4
        else:
            pdtype = torch.float32
            res["param_bytes"] = sum(p.numel() * p.element_size()
                                     for p in out["model"].parameters())
        res["shard_param_bytes"] = shard_bytes(
            abstract_params(meta, pdtype), param_pspecs(meta, mesh, plan),
            mesh)
    del out
    return res


def sp_step_cells():
    """The prefill and decode cells of phase 10's SP steps."""
    from repro_torch.configs.base import ShapeCell

    st = MODEL_AXIS_SP["step"]
    return {mode: ShapeCell(f"sp_{mode}", st["seq"], st["batch"], mode)
            for mode in ("prefill", "decode")}


def model_axis_sp_steps(cfg, mesh) -> dict:
    """One prefill and one decode step (``dryrun.cell_step``) of ``cfg``
    with Megatron-SP on this rank of ``mesh``: the collectives of each by
    kind (``tensor_parallel.collectives_summary``)."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch import tensor_parallel as tpc
    from repro_torch.launch.distributed import MeshRun
    from repro_torch.models.model import Model

    out = {}
    for mode, cell in sp_step_cells().items():
        run = MeshRun(cfg, mesh, None, "cuda", seq_shard=True)
        model = Model(cfg.replace(max_seq=cell.seq_len), device="meta")
        run.place_init(model, 0)
        call, _args = dryrun.cell_step(model, run, cell)
        tpc.reset_transport()
        call()
        torch.cuda.synchronize()
        out[mode] = tpc.collectives_summary()
        del run, model, call, _args
        torch.cuda.empty_cache()
    return out


def model_axis_psum() -> dict:
    """``compressed_psum`` over the ``pod`` group of a (2, 1, 1) mesh on
    this rank: random gradients of its own against the plain formula on
    the gathered inputs (each rank's int8 codes at its own scale, summed,
    times the largest scale, over 2), and the reference's two vectors
    (ROADMAP R11)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import tensor_parallel as tpc
    from repro_torch.launch.distributed import MeshRun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import compress, compressed_psum

    p = MODEL_AXIS_PSUM
    run = MeshRun(get_config(MODEL_AXIS_CP_ARCH), make_mesh(p["dims"]),
                  None, "cuda")
    group, n = run.groups["pod"], p["dims"][0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(100 + dist.get_rank())
    g = torch.randn(p["numel"], generator=gen, device="cuda") * (
        1 + dist.get_rank())
    zero = torch.zeros_like(g)
    t0 = time.perf_counter()
    mean, err = compressed_psum({"w": g}, {"w": zero}, group)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    everyone = tpc.all_gather_list(g, group, n)
    codes = [compress({"w": x}, {"w": zero}) for x in everyone]
    total = sum(c[0]["w"].to(torch.int32) for c in codes)
    top = max(float(c[1]["w"]) for c in codes)
    plain = total.to(torch.float32) * torch.tensor(top, device="cuda") / n
    r11 = torch.tensor(p["r11"][dist.get_rank()], device="cuda")
    r11_mean, _ = compressed_psum({"w": r11}, {"w": torch.zeros_like(r11)},
                                  group)
    return {"max_abs_err": float((mean["w"] - plain).abs().max()),
            "error_max": float(err["w"].abs().max()), "seconds": seconds,
            "numel": p["numel"], "r11_mean": r11_mean["w"].tolist()}


@contextlib.contextmanager
def planted(fault):
    """A fault in this rank's run, to show phase 10's check sees it:
    ``"ff_zero"`` zeroes rank 1's shard of the first layer's MLP down
    projection when it is placed; ``"cp_offset0"`` runs every rank's
    context-parallel slice from position 0; ``"moe_ff_unreduced"`` leaves
    the MoE's partial down products of an ``ff`` split unsummed over the
    ranks."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import distributed
    from repro_torch.launch.distributed import param_name
    from repro_torch.models import moe, transformer

    real_place, real_cp = distributed.MeshRun.place, transformer.cp_attention
    real_ff_sum = moe._ff_sum

    def place(self, model, leaf):
        real_place(self, model, leaf)
        if dist.get_rank() == 1:            # the stored shard, not a gather
            for name, p in model.named_parameters():
                if param_name(name) == "layers.0.ffn.w_down":
                    p.data.zero_()

    def cp_from_zero(q, k, v, tp, *, causal=True, window=0, softcap=0.0):
        chunk = q.shape[1] // tp.n
        mine = q[:, tp.rank * chunk:(tp.rank + 1) * chunk].contiguous()
        return tp.gather(ops.flash_attention(
            mine, k, v, causal=causal, window=window, softcap=softcap), 1)

    if fault == "ff_zero":
        distributed.MeshRun.place = place
    elif fault == "cp_offset0":
        transformer.cp_attention = cp_from_zero
    elif fault == "moe_ff_unreduced":
        moe._ff_sum = lambda part, tp: part
    try:
        yield
    finally:
        distributed.MeshRun.place = real_place
        transformer.cp_attention = real_cp
        moe._ff_sum = real_ff_sum


COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single")


@contextlib.contextmanager
def recorded_collectives(seen: set):
    """Inside the block, every ``torch.distributed`` collective of a CUDA
    tensor this process makes adds its (operation, dtype, input shape,
    group size, reduction) to ``seen``."""
    import torch.distributed as dist

    real = {name: getattr(dist, name) for name in COLLECTIVES}

    def recording(name):
        def call(*args, **kw):
            t = args[0] if name in ("all_reduce", "broadcast") else args[1]
            if t.is_cuda:
                op = kw.get("op", dist.ReduceOp.SUM)
                seen.add((name, str(t.dtype).removeprefix("torch."),
                          tuple(t.shape), dist.get_world_size(kw.get("group")),
                          ("max" if op == dist.ReduceOp.MAX else "sum")
                          if name == "all_reduce" else ""))
            return real[name](*args, **kw)
        return call

    for name in COLLECTIVES:
        setattr(dist, name, recording(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def gloo_cuda_probe(seen: set) -> dict:
    """Every collective in ``seen`` (the union over the ranks) run once
    more by gloo on CUDA tensors of fresh data, over the world group or a
    group of this rank alone, and held to its plain result computed here
    from every member's data: ``{"signatures": k, "by_op": {"op dtype":
    k}, "ok": k_ok, "failed": [...]}``; a failure is ``"wrong"`` or the
    error's first line.  A sum over three members or more is not bound to
    one order of adding them (gloo's ring adds each chunk in its own), so
    each element of a float sum must equal the sum of the members in some
    order, in the type or with a float32 accumulator
    (:func:`matches_some_sum`); everything else, exactly."""
    import torch
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    everyone = [None] * n
    dist.all_gather_object(everyone, sorted(seen))
    sigs = sorted({tuple(x) for mine in everyone for x in mine},
                  key=repr)
    solo = [dist.new_group([i]) for i in range(n)][r]
    groups = {n: (None, list(range(n))), 1: (solo, [r])}

    def data(i, member, shape, dtype):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1000 * i + member)
        if dtype.is_floating_point:
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return torch.randint(-1000, 1000, shape, generator=gen,
                             device="cuda").to(dtype)

    by_op, ok, failed = {}, 0, []
    for i, (name, dt, shape, size, red) in enumerate(sigs):
        key = f"{name} {dt}"
        by_op[key] = by_op.get(key, 0) + 1
        if size not in groups:
            failed.append([name, dt, shape, size, red, "no such group"])
            continue
        group, members = groups[size]
        me = members.index(r)
        dtype = getattr(torch, dt)
        xs = [data(i, m, shape, dtype) for m in members]
        x = xs[me].clone()
        total = xs[0].clone()
        for y in xs[1:]:
            total = torch.maximum(total, y) if red == "max" else total + y
        summed = red != "max" and name in ("all_reduce",
                                           "reduce_scatter_tensor")
        try:
            if name == "all_reduce":
                dist.all_reduce(x, op=dist.ReduceOp.MAX if red == "max"
                                else dist.ReduceOp.SUM, group=group)
                got, want = x, total
            elif name == "broadcast":
                dist.broadcast(x, members[0], group=group)
                got, want = x, xs[0]
            elif name == "all_gather_into_tensor":
                got = torch.empty((size * shape[0], *shape[1:]),
                                  dtype=dtype, device="cuda")
                dist.all_gather_into_tensor(got, x, group=group)
                want = torch.cat(xs)
            elif name == "reduce_scatter_tensor":
                got = torch.empty((shape[0] // size, *shape[1:]),
                                  dtype=dtype, device="cuda")
                dist.reduce_scatter_tensor(got, x, group=group)
                want = total.chunk(size)[me]
            else:
                got = torch.empty_like(x)
                dist.all_to_all_single(got, x, group=group)
                want = torch.cat([y.chunk(size)[me] for y in xs])
            if summed and dtype.is_floating_point and size > 2:
                part = None if name == "all_reduce" else (me, size)
                equal = matches_some_sum(got, xs, part)
            else:
                equal = torch.equal(got, want)
            result = "ok" if equal else "wrong"
        except Exception as e:  # record what gloo says, choose nothing
            result = f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"
        if result == "ok":
            ok += 1
        else:
            failed.append([name, dt, shape, size, red, result])
        dist.barrier()
    return {"signatures": len(sigs), "by_op": by_op, "ok": ok,
            "failed": failed[:10]}


def matches_some_sum(got, xs: list, part=None) -> bool:
    """Whether each element of ``got`` equals the sum of the members'
    ``xs`` in some order (a first pair, then the others one by one) and
    rounding (in their type after each add, or in float32 and rounded
    once); ``part`` ``(i, n)``: ``got`` is chunk ``i`` of ``n`` of the
    sum.  One order at a time, so at most one sum is held beside ``xs``."""
    import itertools

    import torch

    def cut(t):
        return t if part is None else t.chunk(part[1])[part[0]]
    xs = [cut(x) for x in xs]
    hit = torch.zeros(got.shape, dtype=torch.bool, device=got.device)
    accumulators = {xs[0].dtype, torch.float32}
    for order in itertools.permutations(range(len(xs))):
        if order[0] > order[1]:
            continue                    # the first add commutes
        for acc in accumulators:
            total = xs[order[0]].to(acc) + xs[order[1]].to(acc)
            for k in order[2:]:
                total = total + xs[k].to(acc)
            hit |= total.to(got.dtype) == got
            del total
    return bool(hit.all())


def model_axis_rank(job_path: str) -> int:
    """One rank of phase 10 (``--model-axis-rank JOB``): joins the gloo
    group of the job's store on cuda:0, runs every case of the job on the
    job's mesh (the psum on its pod mesh), and writes its results beside
    the job."""
    import torch
    from repro_torch.launch.distributed import close_ranks, init_ranks
    from repro_torch.launch.mesh import make_mesh

    job = json.loads(Path(job_path).read_text())
    init_ranks(job["store"], "cuda", backend="gloo")
    import torch.distributed as dist
    rank = dist.get_rank()
    results, seen = {}, set()
    try:
        with recorded_collectives(seen):
            for case in job["cases"]:
                if case["kind"] == "psum":
                    results[case["id"]] = model_axis_psum()
                    continue
                with planted(case.get("fault")):
                    results[case["id"]] = model_axis_run(
                        case, make_mesh(job["dims"]))
        t0 = time.perf_counter()
        results["gloo_cuda"] = gloo_cuda_probe(seen)
        results["gloo_cuda"]["seconds"] = time.perf_counter() - t0
    finally:
        close_ranks()
    torch.save(results, Path(job_path).parent / f"rank{rank}.pt")
    return 0


def model_axis_world(dims: tuple, cases: list) -> list:
    """Phase 10's ranks of mesh ``dims`` on ``cases``: one subprocess of
    this script a rank on the same card, joined over gloo through a
    ``FileStore``; every rank's results, after each rank's gloo probe of
    its collectives passed (the phase fails otherwise)."""
    import torch

    n = math.prod(dims)
    tag = "x".join(map(str, dims))
    work = fresh_dir(f"model_axis_{tag}")
    work.mkdir(parents=True)
    job = work / "job.json"
    job.write_text(json.dumps({"store": f"file://{work / 'store'}",
                               "dims": list(dims), "cases": cases}))
    free, total = torch.cuda.mem_get_info()
    log(f"  model axis {dims}: {n} ranks; the card has {free} B of {total} "
        f"free, this process {torch.cuda.memory_allocated()} B allocated "
        f"and {torch.cuda.memory_reserved()} B reserved")
    procs = []
    for rank in range(n):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(n),
               "LOCAL_RANK": "0"}
        with open(work / f"rank{rank}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--model-axis-rank", str(job)], env=env, cwd=ROOT,
                stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + MODEL_AXIS_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        require(p.returncode == 0,
                f"phase 10 mesh {dims} rank {rank} exited {p.returncode}: "
                f"{(work / f'rank{rank}.log').read_text()[-3000:]}")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(n)]
    for rank, r in enumerate(ranks):
        probe = r["gloo_cuda"]
        require(probe["signatures"] > 0 and not probe["failed"]
                and probe["ok"] == probe["signatures"],
                f"phase 10 mesh {dims} rank {rank}: gloo's collectives on "
                f"CUDA tensors at the cases' shapes: "
                f"{json.dumps(probe)[:1500]}")
    log(f"  model axis {dims}: gloo on CUDA tensors, every collective of "
        f"the cases again on fresh data: {json.dumps(ranks[0]['gloo_cuda'])}")
    return ranks


def model_axis_phase() -> dict:
    """Phase 10 (see the module docstring): every case without a mesh in
    this process, then the two ranks on mesh (1, 2), each a subprocess of
    this script on the same card; the comparisons."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    from repro_torch.kernels import ops

    cases = model_axis_jobs()
    alone = {c["id"]: model_axis_run(c) for c in cases
             if c["kind"] != "psum" and not c.get("fault")
             and not c.get("seq_shard")}
    sp_traced = model_axis_sp_traces()
    spread = {}
    for c in cases:
        if (c["kind"] == "serve" and not c.get("fault")
                and MODEL_AXIS_SERVES[c["arch"]].get("spread")):
            with ops.plain_versions():
                plain = model_axis_run(c)
            want = alone[c["id"]]
            spread[c["id"]] = {
                "rel_err": float((plain["logits"] - want["logits"]).abs()
                                 .max() / want["logits"].abs().max()),
                "token_agreement": float(np.mean(
                    np.asarray(plain["tokens"])
                    == np.asarray(want["tokens"])))}
    torch.cuda.empty_cache()
    worlds, ranks_s = {}, {}
    for dims in dict.fromkeys(tuple(c["dims"]) for c in cases):
        t_ranks = time.perf_counter()
        worlds[dims] = model_axis_world(
            dims, [c for c in cases if tuple(c["dims"]) == dims])
        ranks_s["x".join(map(str, dims))] = time.perf_counter() - t_ranks
    rows = {}
    for case in cases:
        cid = case["id"]
        ranks = worlds[tuple(case["dims"])]
        got = [r[cid] for r in ranks]
        if case["kind"] == "psum":
            for rank, g in enumerate(got):
                require(g["max_abs_err"] == 0.0,
                        f"compressed_psum on rank {rank}: off its plain "
                        f"formula by {g['max_abs_err']}")
            rows[cid] = got
            log(json.dumps({"model_axis": cid, "ranks": got}))
            continue
        if case.get("seq_shard"):
            rows[cid] = model_axis_sp_row(case, got, [
                r[cid.replace("-sp", "")] for r in ranks], sp_traced)
            log(json.dumps(rows[cid]))
            continue
        want = alone[case["id"].replace("-fault", "-f32")]
        row = {"model_axis": cid, "kind": case["kind"], "arch": case["arch"],
               "check": case["check"], "fault": case.get("fault"),
               "cp": case.get("cp", False)}
        for rank, g in enumerate(got):
            require(g["param_bytes"] == g["shard_param_bytes"]
                    and g.get("cache_bytes") == g.get("shard_cache_bytes"),
                    f"{cid} rank {rank}: placed {g['param_bytes']} B of "
                    f"parameters and {g.get('cache_bytes')} B of cache, the "
                    f"dry-run's shards {g['shard_param_bytes']} B and "
                    f"{g.get('shard_cache_bytes')} B")
        if case["kind"] == "serve":
            scale = float(want["logits"].abs().max())
            errs = [float((g["logits"] - want["logits"]).abs().max())
                    / scale for g in got]
            agree = [float(np.mean(np.asarray(g["tokens"])
                                   == np.asarray(want["tokens"])))
                     for g in got]
            row.update(rel_err=errs, token_agreement=agree)
            if case["check"]:
                row["tol"] = MODEL_AXIS_TOL
            if cid in spread:
                row["alone_kernels_vs_plain"] = spread[cid]
        else:
            errs = [max(abs(a - b) / abs(b)
                        for a, b in zip(g["losses"], want["losses"]))
                    for g in got]
            row.update(rel_err=errs, losses=[g["losses"] for g in got],
                       losses_alone=want["losses"])
        if case["check"] and case.get("fault"):
            require(max(errs) > MODEL_AXIS_TOL,
                    f"{cid}: the planted fault {case['fault']} passed the "
                    f"float32 check ({max(errs)} <= {MODEL_AXIS_TOL})")
        elif case["check"]:
            require(max(errs) <= MODEL_AXIS_TOL,
                    f"{cid}: mesh {tuple(case['dims'])} off the run without "
                    f"a mesh by "
                    f"{max(errs)} of the scale (> {MODEL_AXIS_TOL})")
        else:
            spec = (MODEL_AXIS_SERVES[case["arch"]] if case["kind"] == "serve"
                    else MODEL_AXIS_TRAIN)
            # every kernel on every rank; a form on some rank (rank 0's
            # context-parallel slice starts at position 0)
            for kernel in spec["kernels"]:
                base, _, form = kernel.partition("[")
                for rank, g in enumerate(got):
                    require(g["launches"][base] > 0,
                            f"{cid}: rank {rank} launched {base} no time")
                require(not form or sum(
                    g["launches_by_form"][base][form[:-1]] for g in got) > 0,
                    f"{cid}: no rank launched {kernel}")
            bases = {k.partition("[")[0] for k in spec["kernels"]}
            for rank, g in enumerate(got):
                require(not spec.get("only") or all(
                    n == 0 for k, n in g["launches"].items()
                    if k not in bases),
                    f"{cid}: rank {rank} launched {g['launches']}, only "
                    f"{sorted(bases)} expected")
                for k, v in spec.get("variants", {}).items():
                    require(g["launches_by_variant"][k].get(v, 0)
                            == g["launches"][k],
                            f"{cid}: rank {rank} ran {k} as "
                            f"{g['launches_by_variant'][k]}, not all {v}")
        row.update({k: [g[k] for g in got] for k in (
            "wall_s", "launches", "launches_by_variant", "launches_by_form",
            "transport", "peak_bytes", "param_bytes")})
        row.update(wall_s_alone=want["wall_s"],
                   peak_bytes_alone=want["peak_bytes"],
                   launches_alone=want["launches"])
        if case["kind"] == "serve":
            row.update({k: [g[k] for g in got] for k in (
                "prefill_s", "decode_s", "cache_bytes")})
            row.update(prefill_s_alone=want["prefill_s"],
                       decode_s_alone=want["decode_s"])
        else:
            row.update(step_s=[g["step_s"] for g in got],
                       step_s_alone=want["step_s"])
        rows[cid] = row
        log(json.dumps(row))
    return {"seconds": time.perf_counter() - t0, "ranks_s": ranks_s,
            "rows": rows}


def model_axis_sp_traces() -> dict:
    """Phase 10's SP steps traced on two fake ranks of mesh (1, 2)
    (``dryrun.trace_cell``, a process group of fake ranks started and
    destroyed here): ``{mode: the trace}``."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    arch = MODEL_AXIS_SP["arch"]
    out = {mode: dryrun.trace_cell(arch, cell, mesh=make_mesh(
        MODEL_AXIS_DIMS), seq_shard=True)
        for mode, cell in sp_step_cells().items()}
    require(not dist.is_initialized(),
            "a trace's process group of fake ranks outlived it")
    return out


def model_axis_sp_row(case: dict, got: list, base: list,
                      traced: dict) -> dict:
    """Phase 10's row of an SP case: each rank (``got``) against the
    same case without SP on the same rank (``base``): tokens equal, the
    float32 logits within ``MODEL_AXIS_SP["tol"]`` of their scale, the
    same launches, each rank's peak with and without SP; for the bf16
    serve, K6, K7's partial form and K9 launched on every rank, and its
    steps' collectives by kind equal to their traces'."""
    import numpy as np

    cid = case["id"]
    errs, agree = [], []
    for rank, (g, b) in enumerate(zip(got, base)):
        scale = float(b["logits"].abs().max())
        errs.append(float((g["logits"] - b["logits"]).abs().max()) / scale)
        agree.append(float(np.mean(np.asarray(g["tokens"])
                                   == np.asarray(b["tokens"]))))
        require(g["launches"] == b["launches"]
                and g["launches_by_form"] == b["launches_by_form"],
                f"{cid} rank {rank}: launches {g['launches_by_form']}, "
                f"without SP {b['launches_by_form']}")
        require(g["param_bytes"] == g["shard_param_bytes"]
                and g["cache_bytes"] == g["shard_cache_bytes"],
                f"{cid} rank {rank}: placed bytes off the dry-run's")
    row = {"model_axis": cid, "kind": "serve", "arch": case["arch"],
           "check": case["check"], "seq_shard": True, "rel_err": errs,
           "token_agreement": agree}
    if case["check"]:
        require(max(errs) <= MODEL_AXIS_SP["tol"] and min(agree) == 1.0,
                f"{cid}: SP off the ranks without it by {max(errs)} of "
                f"the logits' scale (> {MODEL_AXIS_SP['tol']}), tokens "
                f"agree {agree}")
        row["tol"] = MODEL_AXIS_SP["tol"]
    else:
        require(min(agree) == 1.0,
                f"{cid}: tokens agree {agree} with the ranks without SP")
        for kernel in ("flash_attention", "fused_block", "rglru_scan"):
            require(all(g["launches"][kernel] > 0 for g in got),
                    f"{cid}: a rank launched {kernel} no time")
        require(all(g["launches_by_form"]["fused_block"]["partial"] > 0
                    for g in got), f"{cid}: K7's partial form not launched")
        for mode, tr in traced.items():
            real = got[0]["step_collectives"][mode]
            require(real == tr["collectives"],
                    f"{cid}: the {mode} step's collectives {real}, its "
                    f"trace's {tr['collectives']}")
            if mode == "prefill":
                require(real["dynamic_count"].get("reduce-scatter", 0) > 0
                        and "all-reduce" not in real["dynamic_count"],
                        f"{cid}: SP's prefill made {real['dynamic_count']}")
        row["step_collectives"] = {
            mode: {"real_rank0": got[0]["step_collectives"][mode],
                   "traced": tr["collectives"], "equal": True,
                   "trace_s": tr["trace_s"],
                   "traced_peak_bytes": tr["memory"]["peak_bytes"]}
            for mode, tr in traced.items()}
    row.update({k: [g[k] for g in got] for k in (
        "wall_s", "launches", "launches_by_variant", "launches_by_form",
        "transport", "peak_bytes", "param_bytes", "prefill_s",
        "decode_s", "cache_bytes")})
    row["peak_bytes_without_sp"] = [b["peak_bytes"] for b in base]
    row["transport_without_sp"] = [b["transport"] for b in base]
    return row


# ---------------------------------------------------------------- main path
def plan_signature(plan) -> dict:
    c = plan.candidate
    return {
        "cuts": tuple(c.cuts), "evaluated": plan.search.evaluated,
        "path": plan.search.path, "latency_cycles": plan.latency.cycles,
        "dram_total": plan.dram.total, "dram_fm": plan.dram.fm_bytes,
        "sram_total": plan.sram.sram_total, "bram18k": plan.sram.bram18k,
        "feasible": c.feasible,
        "words": tuple(tuple(int(w) for w in i.encode())
                       for i in plan.instructions),
    }


def require_same_plan(got: dict, want: dict, what: str):
    for key, value in want.items():
        require(got[key] == value,
                f"{what}: {key} differs: {str(got[key])[:200]} != "
                f"{str(value)[:200]}")


def drive_main_path(nets, engine, limits, backend="numpy"):
    """One sweep of kernel-path compiles over ``nets`` under ``engine``
    (``"pipeline"``, the default options, or ``"device"``) and ``backend``,
    with the launch counts set to 0 just before it and read just after.
    Returns ``({(net, engine, backend): (signature, seconds, options)},
    launches, fused launches, launches by variant)``."""
    import torch
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.options import CompileOptions
    from repro_torch.kernels import (fused_launch_counts, launch_counts,
                                     launch_counts_by_variant,
                                     reset_launch_counts)

    out = {}
    reset_launch_counts()
    for net in nets:
        opts = CompileOptions(engine=f"{engine}@{CHUNK}", backend=backend)
        require(opts.device == "cuda"
                and opts.engine_spec().variant == "cuda",
                "default options do not resolve to the CUDA kernels")
        if net in limits:
            opts = opts.replace(exhaustive_limit=limits[net])
        t0 = time.perf_counter()
        plan = compile_graph(build_cnn(net), options=opts)
        torch.cuda.synchronize()
        out[net, engine, backend] = (plan_signature(plan),
                                     time.perf_counter() - t0, opts)
    return (out, launch_counts(), fused_launch_counts(),
            launch_counts_by_variant())


def check_main_path(results):
    """Hold the kernel-path plans against the host journal engine, the plain
    versions on the GPU, and the pinned reference values."""
    import torch
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph

    for (net, engine, backend), (sig, _seconds, opts) in results.items():
        if backend != "numpy":
            continue
        what = f"{net} under {opts.engine}"
        require(all(w == w for w in (sig["latency_cycles"],))
                and sig["latency_cycles"] > 0 and sig["words"],
                f"{what}: empty or non-finite plan")
        if net == "yolov2" and engine == "pipeline":
            # 7,962,624 tuples: too many for the host's journal walk here
            other = opts.replace(engine=f"pipeline:torch@{CHUNK}")
            against = "pipeline:torch on the GPU"
        else:
            other = opts.replace(engine="journal")
            against = "the host journal engine"
        t0 = time.perf_counter()
        want = plan_signature(compile_graph(build_cnn(net), options=other))
        torch.cuda.synchronize()
        log(f"  {what}: equals {against} "
            f"({time.perf_counter() - t0:.2f} s)")
        require_same_plan(sig, want, f"{what} vs {against}")
    sig = results["yolov2", "pipeline", "numpy"][0]
    require_same_plan(sig, YOLOV2_PINNED, "yolov2 vs the pinned reference")
    for net in ("resnet50", "resnet152"):
        require_same_plan(results[net, "pipeline", "numpy"][0],
                          RESNET_PINNED, f"{net} vs the pinned reference")


def check_pallas_path(results):
    """Hold the ``backend="pallas"`` plans against the same compile with
    ``device="cpu"``, the plain versions (K5 equals its plain version bit
    for bit, so the plans must be equal); yolov2's exhaustive plan under
    ``pipeline``, which the scorer never touches, against the pinned
    reference values (its space is too large for the host)."""
    import torch
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph

    for (net, engine, backend), (sig, _seconds, opts) in results.items():
        if backend != "pallas":
            continue
        what = f"{net} under {opts.engine}, backend='pallas'"
        if net == "yolov2" and engine == "pipeline":
            require_same_plan(sig, YOLOV2_PINNED,
                              f"{what} vs the pinned reference")
            continue
        t0 = time.perf_counter()
        want = plan_signature(compile_graph(
            build_cnn(net), options=opts.replace(device="cpu")))
        torch.cuda.synchronize()
        log(f"  {what}: equals device='cpu' "
            f"({time.perf_counter() - t0:.2f} s)")
        require_same_plan(sig, want, f"{what} vs device='cpu'")


# ------------------------------------------------------------------- pool
POOL_WORKERS = 2
# the descent nets of the main path, each searched in the pool under the
# float32 scorer (K5) and under the device replay (K1): (engine, backend)
# -> the kernel every worker task must launch
DESCENT_NETS = ("yolov3", "efficientnet-b1", "retinanet", "mobilenet-v3")
DESCENT_SWEEPS = {("pipeline", "pallas"): "score_batch",
                  ("device", "numpy"): "alloc_scan"}
RESULT_KEYS = ("cuts", "evaluated", "path", "latency_cycles", "dram_total",
               "dram_fm", "sram_total", "bram18k", "feasible")


def result_signature(result) -> dict:
    """The part of ``plan_signature`` a ``SearchResult`` holds."""
    b = result.best
    return {"cuts": tuple(b.cuts), "evaluated": result.evaluated,
            "path": result.path, "latency_cycles": b.latency_cycles,
            "dram_total": b.dram_total, "dram_fm": b.dram_fm,
            "sram_total": b.sram_total, "bram18k": b.bram18k,
            "feasible": b.feasible}


def serial_signature(sig: dict) -> dict:
    return {k: sig[k] for k in RESULT_KEYS}


def pool_task_probe(task) -> dict:
    """Runs in a pool worker (sent through ``ParallelSearchDriver.map``):
    one search task with that process's launch counts set to 0 just
    before, returned with the counts it left and the worker's memory on
    the card."""
    import torch
    from repro_torch.core import search_pool
    from repro_torch.kernels import (fused_launch_counts, launch_counts,
                                     launch_counts_by_variant,
                                     reset_launch_counts)

    reset_launch_counts()
    if isinstance(task, search_pool.SubspaceTask):
        best, evals, _pruned, events = search_pool._run_subspace(task)
        visited = None
    else:
        best, visited, events = search_pool._run_descent(task)
        evals = len(visited)
    torch.cuda.synchronize()
    return {"pid": os.getpid(), "best": best, "evals": evals,
            "visited": visited, "events": events,
            "launches": launch_counts(), "fused": fused_launch_counts(),
            "score_batch_by_variant":
                launch_counts_by_variant()["score_batch"],
            "memory_reserved_bytes": torch.cuda.memory_reserved(),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def require_probes(probes, needed, what) -> None:
    """Every task ran on the card, in a worker, and launched ``needed``."""
    for p in probes:
        require(p["events"] == (),
                f"{what}: a worker task degraded: {p['events']}")
        for name in needed:
            require(p["launches"][name] > 0,
                    f"{what}: worker {p['pid']} ran a task without "
                    f"launching {name}: {p['launches']}")


def compute_apps() -> list:
    """``nvidia-smi``'s processes on the card and the memory of each."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi failed: {e}"]
    return [line.strip() for line in out.splitlines() if line.strip()]


def pool_phase(results) -> dict:
    """The search pool on the card (see the module docstring, phase 3b):
    one driver with a defaulted context, which the first search must
    ratchet to spawn; yolov2@416 at full width under the pipeline and the
    four descent nets under the float32 scorer and the device replay, each
    equal to its serial plan of phase 3 with no fault events; probes
    through ``driver.map`` that count each task's launches in its worker;
    then a chaos kill, and a kill that exhausts the retries of a journaled
    search followed by its resume."""
    import shutil
    from repro_torch.cnn import build_cnn
    from repro_torch.core.cutpoint import (_key, descent_starts,
                                           monotone_runs, split_blocks)
    from repro_torch.core.grouping import group_nodes
    from repro_torch.core.hw import KCU1500
    from repro_torch.core.search_pool import (TASKS_PER_WORKER,
                                              ParallelSearchDriver,
                                              partition_space)
    from repro_torch.runtime import chaos

    out = {"pool": "ParallelSearchDriver", "workers": POOL_WORKERS,
           "os_cpu_count": os.cpu_count()}
    gg = group_nodes(build_cnn("yolov2"))
    serial_sig, _s, opts = results["yolov2", "pipeline", "numpy"]
    serial = serial_signature(serial_sig)
    runs = monotone_runs(split_blocks(gg))
    prefixes, suffix_dims = partition_space(
        runs, POOL_WORKERS * TASKS_PER_WORKER)
    out["yolov2_tasks"] = len(prefixes)

    def same(result, want, what):
        require(result.events == [],
                f"{what}: fault events {result.events}")
        require_same_plan(result_signature(result), want,
                          f"{what} vs the serial plan")

    import torch
    driver = ParallelSearchDriver(workers=POOL_WORKERS)
    try:
        require(driver.start_method == "fork",
                f"the defaulted context is {driver.start_method}, not fork")
        free_before = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        cold = driver.search(gg, KCU1500, opts)
        out["yolov2_cold_ms"] = 1e3 * (time.perf_counter() - t0)
        # the card's memory the live workers hold: contexts and caches
        out["card_memory_taken_by_the_workers_bytes"] = (
            free_before - torch.cuda.mem_get_info()[0])
        require(driver.start_method == "spawn",
                f"a search on the card left the pool under "
                f"{driver.start_method}, not spawn")
        same(cold, serial, "yolov2 in the pool, cold")
        warm_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            warm = driver.search(gg, KCU1500, opts)
            warm_ms.append(1e3 * (time.perf_counter() - t0))
            same(warm, serial, "yolov2 in the pool, warm")
        out["yolov2_warm_ms"] = warm_ms
        log(f"  yolov2 in the pool ({len(prefixes)} tasks, "
            f"{POOL_WORKERS} spawn workers): equals the serial plan, cold "
            f"{out['yolov2_cold_ms']:.0f} ms, warm "
            f"{[round(w, 1) for w in warm_ms]} ms")

        # every task launched its kernels in its worker
        probes = driver.map(pool_task_probe, driver.subspace_tasks(
            gg, KCU1500, prefixes, suffix_dims, opts))
        require_probes(probes, ("alloc_scan", "enum_frames", "cost_rows"),
                       "yolov2 probe")
        for p in probes:
            require(p["launches"]["argmin_rows"] == 0
                    and p["fused"]["argmin_rows"]
                    == p["launches"]["cost_rows"],
                    f"yolov2 probe: K4 not in every K3 launch: "
                    f"{p['launches']}, fused {p['fused']}")
        best = min((p["best"] for p in probes),
                   key=lambda m: (_key(m, "latency"), m.cuts))
        merged = {"cuts": tuple(best.cuts),
                  "evaluated": sum(p["evals"] for p in probes),
                  "latency_cycles": best.latency_cycles,
                  "dram_total": best.dram_total, "dram_fm": best.dram_fm,
                  "sram_total": best.sram_total, "bram18k": best.bram18k,
                  "feasible": best.feasible}
        require_same_plan(merged, {k: serial[k] for k in merged},
                          "yolov2 probes merged vs the serial plan")
        pids = sorted({p["pid"] for p in probes})
        out["worker_pids"] = pids
        out["probe_launches_by_task"] = [
            {k: v for k, v in p["launches"].items() if v} for p in probes]
        out["worker_memory"] = {
            str(pid): {k: max(p[k] for p in probes if p["pid"] == pid)
                       for k in ("memory_reserved_bytes",
                                 "max_memory_allocated_bytes")}
            for pid in pids}
        out["nvidia_smi_compute_apps"] = compute_apps()
        log(f"  yolov2 probes: every task launched K1, K2 and K3 in its "
            f"worker, K4 in each K3; workers {pids}; nvidia-smi: "
            f"{out['nvidia_smi_compute_apps']}")

        # the descent nets
        out["descent_ms"] = {}
        for net in DESCENT_NETS:
            ngg = group_nodes(build_cnn(net))
            for (engine, backend), kernel in DESCENT_SWEEPS.items():
                sig, serial_s, nopts = results[net, engine, backend]
                what = f"{net} in the pool under {nopts.engine}, {backend}"
                t0 = time.perf_counter()
                r = driver.search(ngg, KCU1500, nopts)
                ms = 1e3 * (time.perf_counter() - t0)
                want = serial_signature(sig)
                if backend == "pallas":
                    # ROADMAP R10: the serial engine never memoizes a
                    # float32 score, so its count includes re-scorings;
                    # the pool counts distinct tuples (below)
                    want.pop("evaluated")
                same(r, want, what)
                require(r.path == "descent", f"{what}: path {r.path}")
                blocks = split_blocks(ngg)
                probes = driver.map(pool_task_probe, driver.descent_tasks(
                    ngg, KCU1500,
                    descent_starts(blocks, monotone_runs(blocks)), nopts))
                require_probes(probes, (kernel,), what + " probe")
                if kernel == "score_batch":
                    for p in probes:
                        require(p["score_batch_by_variant"]["thread"] == 0,
                                f"{what}: K5 not all split: "
                                f"{p['score_batch_by_variant']}")
                visited = set().union(*(p["visited"] for p in probes))
                require(len(visited) == r.evaluated
                        and (backend == "pallas"
                             or r.evaluated == sig["evaluated"]),
                        f"{what}: probes visited {len(visited)}, pool "
                        f"evaluated {r.evaluated}, serial "
                        f"{sig['evaluated']}")
                out["descent_ms"][f"{net} {engine}+{backend}"] = {
                    "pool_ms": ms, "serial_ms": 1e3 * serial_s,
                    "pool_evaluated": r.evaluated,
                    "serial_evaluated": sig["evaluated"],
                    "launches_by_task": [p["launches"][kernel]
                                         for p in probes]}
                log(f"  {what}: equals the serial plan ({ms:.0f} ms; "
                    f"serial {1e3 * serial_s:.0f} ms); {kernel} launched "
                    f"in every worker task")
    finally:
        driver.close()

    # fault tolerance: a kill at the last yolov2 prefix reaches the spawn
    # workers (through the pool's initializer)
    victim = prefixes[-1]
    journal = ROOT / "build" / "pool_journal"
    shutil.rmtree(journal, ignore_errors=True)
    chaos.install(chaos.ChaosInjector(
        events={("task", victim): chaos.ChaosEvent("kill")}))
    try:
        with ParallelSearchDriver(workers=POOL_WORKERS) as d:
            t0 = time.perf_counter()
            r = d.search(gg, KCU1500, opts)
            out["yolov2_with_a_kill_ms"] = 1e3 * (time.perf_counter() - t0)
            method = d.start_method
        require(method == "spawn", f"chaos search ran under {method}")
        mine = [e for e in r.events if e.kind == "retry" and e.task == victim]
        require(len(mine) == 1 and mine[0].attempt == 1,
                f"the kill at {victim} gave {mine}, not one retry")
        require(all(e.kind == "retry" and "died" in e.detail
                    for e in r.events),
                f"the kill gave other events: {r.events}")
        require_same_plan(result_signature(r), serial,
                          "yolov2 after a kill vs the serial plan")
        out["kill_events"] = [[e.kind, list(e.task), e.attempt]
                              for e in r.events]
        log(f"  a kill at {victim} reached a spawn worker: retry events "
            f"{out['kill_events']} (the victim once; other retries are "
            f"the tasks in flight when the pool broke), the same plan")
        failed = None
        with ParallelSearchDriver(workers=POOL_WORKERS, max_retries=0) as d:
            try:
                d.search(gg, KCU1500, opts.replace(resume_dir=journal))
            except RuntimeError as e:
                failed = e
        require(failed is not None and "worker process died" in str(failed),
                f"a kill with max_retries=0 did not raise: {failed!r}")
    finally:
        chaos.uninstall()
    journaled = len(list(journal.glob("search_*/task_*.rec")))
    with ParallelSearchDriver(workers=POOL_WORKERS) as d:
        r = d.search(gg, KCU1500, opts.replace(resume_dir=journal))
    resumed = [e for e in r.events if e.kind == "resume"]
    require(journaled >= 1 and len(resumed) == journaled
            and len(resumed) == len(r.events),
            f"resume: {journaled} records, events {r.events}")
    require_same_plan(result_signature(r), serial,
                      "yolov2 resumed vs the serial plan")
    shutil.rmtree(journal, ignore_errors=True)
    out["journaled_before_the_kill"] = journaled
    log(f"  max_retries=0 raised ({failed}); the resume reused "
        f"{journaled} journaled tasks and equals the serial plan")
    return out


# ---------------------------------------------------------------- service
# request_key of each zoo net at its published size under the default
# CompileOptions(), as the JAX package's repro.service.request_key computes
# it (canonicalization alone, no search): the port's standard-library
# msgpack writer must give the same bytes on a machine with no msgpack
SERVICE_KEYS = {
    "vgg16-conv":
        "cce13a698fc4652962aea8c6ab70e6d62d7b0b20ea1f2785d85522e8d0cf1a8c",
    "yolov2":
        "8afcceb3a18fc2b712962303b77c92afdceb33bdde604821e26bf1f7b7fc9197",
    "yolov3":
        "5fc60518879f602068aeac507e3c29f376bd57225a4b8005fafd6d84c0ab79f1",
    "resnet50":
        "7b27ddb83e5710558dd91b9eca87608c34fec61bb02dfd810f48e72534a80e86",
    "resnet152":
        "d5770384cdb7ba4f04e1815bcac9ca853b54a3f7bdcc767a4fcf1c4d3ac6d759",
    "efficientnet-b1":
        "bb4c6125dd1f17692539c66ec3992f6e5c37abfd3bc3e62a0bd92f300bf1dde8",
    "retinanet":
        "389fb300714739b6895368d028b28e91513b16e62738c4b792831290505e65b8",
    "mobilenet-v3":
        "0e8e4a413b3697b8a4a8c98f778ac86692ceeca3fb4a8aae2456064928336d11",
}
SERVICE_PALLAS_NET = "yolov3"        # a descent net, K5 on its miss
SERVICE_CONCURRENT = ("yolov2", "resnet152")
SERVICE_TIMEOUT_S = 600


def service_phase(results) -> dict:
    """The compile service on the card (phase 3c, see the module
    docstring).  Launch counts are set to 0 just before each request and
    read just after it (the service's threads share the process's
    counters); their sum over the phase is ``launches``."""
    import shutil
    import torch
    from repro_torch.cnn import build_cnn
    from repro_torch.core.hw import KCU1500
    from repro_torch.core.options import CompileOptions
    from repro_torch.kernels import (fused_launch_counts, launch_counts,
                                     reset_launch_counts)
    from repro_torch.service import CompileService, encode_plan, request_key
    from repro_torch.service.packing import unpackb

    root = ROOT / "build" / "service_cache"
    shutil.rmtree(root, ignore_errors=True)
    graphs = {net: build_cnn(net) for net in SERVICE_KEYS}
    total = dict.fromkeys(launch_counts(), 0)
    fused_total = dict.fromkeys(fused_launch_counts(), 0)

    def served(svc, net, hw=KCU1500, options=None):
        """One request through ``svc``: (ticket, plan, its launches)."""
        reset_launch_counts()
        t = svc.submit(graphs[net], hw, options)
        plan = t.result(timeout=SERVICE_TIMEOUT_S)
        torch.cuda.synchronize()
        counts = launch_counts()
        for name, n in counts.items():
            total[name] += n
        for name, n in fused_launch_counts().items():
            fused_total[name] += n
        return t, plan, {k: n for k, n in counts.items() if n}

    def record(svc, key):
        path = svc.cache._path(key)
        return path.stat().st_size, unpackb(path.read_bytes())["codec"]

    out = {"service": "CompileService", "nets": {}}
    cold = {}
    try:
        with CompileService(root / "main", threads=1) as svc:
            require(svc.options == CompileOptions()
                    and svc.options.device == "cuda"
                    and svc.options.engine_spec().variant == "cuda",
                    "the service's default options are not the card's")
            for net, pinned in SERVICE_KEYS.items():
                key = request_key(graphs[net], KCU1500, svc.options)
                require(key == pinned, f"{net}: request_key {key} != the "
                                       f"JAX package's {pinned}")
                t, plan, counts = served(svc, net)
                require(not t.hit, f"{net}: the first request was a hit")
                # an exhaustive search runs the pipeline's kernels; a
                # descent (space > exhaustive_limit) scores on the host
                # under backend="numpy", as in phase 3
                require(plan.search.path != "exhaustive"
                        or all(counts.get(k) for k in ("enum_frames",
                                                       "alloc_scan",
                                                       "cost_rows")),
                        f"{net}: the miss launched {counts}, not K2, K1, K3")
                sig = plan_signature(plan)
                require_same_plan(sig, results[net, "pipeline", "numpy"][0],
                                  f"{net} from the service vs phase 3")
                if net == "yolov2":
                    require_same_plan(sig, YOLOV2_PINNED,
                                      "yolov2 from the service vs the "
                                      "pinned reference")
                cold[net] = encode_plan(plan)
                out["nets"][net] = {"request_key": key,
                                    "path": plan.search.path,
                                    "cold_ms": 1e3 * t.service_s,
                                    "miss_launches": counts}
            for net in SERVICE_KEYS:
                t, plan, counts = served(svc, net)
                require(t.hit and not counts,
                        f"{net}: the second request hit={t.hit}, launched "
                        f"{counts}")
                require(encode_plan(plan) == cold[net],
                        f"{net}: the hit's record differs from the miss's")
                size, codec = record(svc, t.key)
                out["nets"][net].update(hit_ms=1e3 * t.service_s,
                                        record_bytes=size, codec=codec,
                                        plan_bytes=len(cold[net]))
                log(f"  service {net}: miss {out['nets'][net]['cold_ms']:.2f}"
                    f" ms ({out['nets'][net]['path']}, launched "
                    f"{out['nets'][net]['miss_launches']}), "
                    f"hit {1e3 * t.service_s:.3f} ms (decode + verify, no "
                    f"launch), record {size} B ({len(cold[net])} B of plan, "
                    f"{codec}), hit == miss byte for byte")
            out["stats"] = dict(svc.stats)
        require(out["stats"]["misses"] == 8 and out["stats"]["hits"] == 8,
                f"service stats {out['stats']}")

        with CompileService(root / "main", threads=1) as svc:
            for net in SERVICE_KEYS:
                t, plan, counts = served(svc, net)
                require(t.hit and not counts
                        and encode_plan(plan) == cold[net],
                        f"{net} after a restart: hit={t.hit}, launched "
                        f"{counts}, or a record unlike the miss's")
            out["after_restart"] = dict(svc.stats)
        require(out["after_restart"]["hits"] == 8
                and out["after_restart"]["misses"] == 0,
                f"a restarted service: {out['after_restart']}")
        log("  a second service on the same directory served all 8 as hits")

        hw2 = dataclasses.replace(KCU1500, name="kcu1500-smallsram",
                                  sram_budget=KCU1500.sram_budget // 2)
        with CompileService(root / "main", threads=1) as svc:
            t, warm, counts = served(svc, "yolov2", hw2)
            require(not t.hit and t.warm_started,
                    f"yolov2 on {hw2.name}: hit={t.hit}, warm_started="
                    f"{t.warm_started}")
        with CompileService(root / "fresh", threads=1) as svc:
            t2, cold2, _ = served(svc, "yolov2", hw2)
            require(not t2.hit and not t2.warm_started,
                    "yolov2 on a fresh cache was not a cold miss")
        require(encode_plan(warm) == encode_plan(cold2),
                f"yolov2 on {hw2.name}: the warm-started plan differs from "
                f"a cold compile")
        out["warm_start"] = {"net": "yolov2", "hw": hw2.name,
                             "warm_ms": 1e3 * t.service_s,
                             "cold_ms": 1e3 * t2.service_s,
                             "launches": counts}
        log(f"  yolov2 on {hw2.name}: a warm-started miss "
            f"({1e3 * t.service_s:.2f} ms) equals a cold compile in a fresh "
            f"cache ({1e3 * t2.service_s:.2f} ms)")

        net = SERVICE_PALLAS_NET
        pallas = CompileOptions(backend="pallas")
        with CompileService(root / "main", threads=1) as svc:
            t, miss, counts = served(svc, net, options=pallas)
            require(not t.hit and counts.get("score_batch"),
                    f"{net} under pallas: hit={t.hit}, launched {counts}")
            require_same_plan(plan_signature(miss),
                              results[net, "pipeline", "pallas"][0],
                              f"{net} under pallas from the service vs "
                              f"phase 3")
            t2, hit, hit_counts = served(svc, net, options=pallas)
            require(t2.hit and not hit_counts
                    and encode_plan(hit) == encode_plan(miss),
                    f"{net} under pallas: the hit launched {hit_counts} or "
                    f"differs from the miss")
        out["pallas"] = {"net": net, "miss_ms": 1e3 * t.service_s,
                         "hit_ms": 1e3 * t2.service_s,
                         "miss_launches": counts}
        log(f"  {net} under backend='pallas': the miss launched {counts}, "
            f"the hit none and equals it byte for byte")

        with CompileService(root / "two", threads=2) as svc:
            tickets = {}
            for net in SERVICE_CONCURRENT:
                tickets[net] = svc.submit(graphs[net])
            t0 = time.perf_counter()
            plans = {net: t.result(timeout=SERVICE_TIMEOUT_S)
                     for net, t in tickets.items()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            require(svc.stats["misses"] == 2,
                    f"two threads: stats {svc.stats}")
        for net, plan in plans.items():
            require(encode_plan(plan) == cold[net],
                    f"{net} on two threads differs from its serial record")
        out["concurrent"] = {
            "nets": list(SERVICE_CONCURRENT), "threads": 2,
            "wall_ms": 1e3 * wall,
            "service_ms": {n: 1e3 * t.service_s for n, t in tickets.items()},
            "queue_wait_ms": {n: 1e3 * t.queue_wait_s
                              for n, t in tickets.items()}}
        log(f"  two threads, two misses at once {list(SERVICE_CONCURRENT)}:"
            f" each equals its serial record ({1e3 * wall:.1f} ms)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {k: n for k, n in total.items() if n}
    out["fused_launches"] = {k: n for k, n in fused_total.items() if n}
    return out


# ------------------------------------------------------------- numerics
def quickstart(nets, device="cuda") -> list:
    """The quickstart pipeline on the card at full width, one row per net
    (see the module docstring, phase 4); ``device`` is the card, or the
    CPU for a rehearsal at small sizes."""
    import numpy as np
    import torch
    from repro_torch.analysis import errors_of
    from repro_torch.cnn import build_cnn
    from repro_torch.cnn.torch_ref import init_params, load_params, run_graph
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.dram import dram_report
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.simulator import simulate

    def seeded_input(size):
        return np.random.default_rng(0).standard_normal((1, size, size, 3),
                                                        dtype=np.float32)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    rows = []
    for net in nets:
        graph = build_cnn(net)
        size, last = graph.nodes[0].out_h, len(graph.nodes) - 1
        t0 = time.perf_counter()
        plan = compile_graph(graph, options=CompileOptions(
            engine=f"pipeline@{CHUNK}", verify="strict", device=device))
        compile_s = time.perf_counter() - t0
        require(not errors_of(plan.diagnostics),
                f"{net}: verify='strict' let errors through")
        _, dry = simulate(plan.grouped, plan.alloc, plan.instructions,
                          execute=False)
        rep = dram_report(plan.grouped, plan.alloc)
        require(dry.fm_total == rep.fm_bytes == plan.dram.fm_bytes
                and dry.weight_reads == rep.weight_bytes
                and dry.dangling_reads == 0,
                f"{net}: dry audit {dry} != dram_report {rep}")
        w = load_params(init_params(graph), device)
        x = torch.from_numpy(seeded_input(size)).to(device)
        want = run_graph(graph, w, x, device=device)[last]     # warm-up
        sync()
        t0 = time.perf_counter()
        out, run = simulate(plan.grouped, plan.alloc, plan.instructions, w,
                            x, device=device)
        sync()
        simulate_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        again = run_graph(graph, w, x, device=device)[last]
        sync()
        run_graph_ms = 1e3 * (time.perf_counter() - t0)
        for other, what in ((want, "run_graph"), (again, "run_graph again")):
            require(out.shape == other.shape and torch.equal(
                out.view(torch.int32), other.view(torch.int32)),
                f"{net}: simulator output != {what} on the card")
        require(bool(torch.isfinite(out).all()),
                f"{net}: non-finite output")
        require(dataclasses.astuple(run) == dataclasses.astuple(dry),
                f"{net}: executed counters {run} != dry counters {dry}")
        del w, want, again
        # the card's float32 against the host's on a small input
        small = build_cnn(net, 64)
        sp, sx = init_params(small), seeded_input(64)
        card = run_graph(small, sp, sx, device=device)[len(small.nodes) - 1]
        host = run_graph(small, sp, sx, device="cpu")[len(small.nodes) - 1]
        card, host = card.cpu().double(), host.double()
        rel = float((card - host).abs().max() / host.abs().max())
        require(card.shape == host.shape and rel <= 1e-5,
                f"{net}@64: card vs host {rel:.3g} of the output's scale")
        rows.append({
            "quickstart": net, "size": size,
            "groups": len(plan.grouped.groups),
            "output": list(out.shape), "compile_s": compile_s,
            "simulate_ms": simulate_ms, "run_graph_ms": run_graph_ms,
            "dram_fm_bytes": dry.fm_total, "onchip_hit_bytes": dry.onchip_hits,
            "card_vs_host_at_64px": rel})
        log(json.dumps(rows[-1]))
    return rows


# ------------------------------------------------- where the time goes
def yolov2_wall_and_busy() -> dict:
    """The yolov2@416 compile under default options at ``CHUNK``: the wall of
    5 runs, then one run traced with ``torch.profiler`` for the kernels'
    device time (the card's busy share of the untraced median wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.options import CompileOptions

    graph = build_cnn("yolov2")

    def compile_once():
        t0 = time.perf_counter()
        plan = compile_graph(graph, options=CompileOptions(
            engine=f"pipeline@{CHUNK}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require_same_plan(plan_signature(plan), YOLOV2_PINNED,
                          "yolov2, repeated compile")
        return 1e3 * wall

    compile_once()                                       # warm
    walls = sorted(compile_once() for _ in range(5))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall = compile_once()
    by_kernel = device_time_by_kernel(prof)
    busy = sum(k["device_ms"] for k in by_kernel.values())
    return {
        "yolov2_compile": "pipeline:cuda", "chunk": CHUNK,
        "wall_ms_5_runs": walls, "wall_ms_median": walls[2],
        "candidates_per_s_at_median":
            YOLOV2_PINNED["evaluated"] / (walls[2] / 1e3),
        "traced_wall_ms": traced_wall,
        "device_busy_ms": busy if by_kernel else "not measured",
        "device_busy_share_of_median_wall":
            busy / walls[2] if by_kernel else "not measured",
        "device_time_by_kernel": by_kernel}


# --------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels, print what ptxas says, check "
                         "them against their plain versions at small "
                         "sizes, and stop")
    ap.add_argument("--model-axis-rank", metavar="JOB", default=None,
                    help="run as one rank of phase 10 on JOB (phase 10 "
                         "starts two of these)")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures on the GPU only",
              file=sys.stderr)
        return 2
    if args.model_axis_rank:
        return model_axis_rank(args.model_axis_rank)
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    from repro_torch.cnn import CNN_BUILDERS
    from repro_torch.kernels import _build
    _build.load(verbose=args.kernels_only)
    log(f"set-up: kernels built in {_build.build_seconds:.1f} s")

    if args.kernels_only:
        for net in ("yolov2", "resnet152", "retinanet", "efficientnet-b1"):
            r = check_kernels(net, target=20000, timed=False, reps=0)
            log(f"kernels equal their plain versions: {json.dumps(r)}")
        r = check_alloc_prefix(timed=True, reps=10)
        log(f"alloc_scan from its state rows equals the whole replay: "
            f"{json.dumps(r)}")
        r = check_scorer((("resnet152", 1024), ("yolov2", 20000),
                          ("efficientnet-b1", 8)), timed=False, reps=0)
        log(f"score_batch equals its plain version: {json.dumps(r)}")
        r = scorer_edges()
        log(f"score_batch at the rule's crossover and G 1: {json.dumps(r)}")
        r = scorer_device_replay(reps=5)
        log(f"score_batch under the device replay: {json.dumps(r)}")
        r = check_lm_kernels(timed=False, reps=0)
        log(f"LM kernels equal their plain versions: "
            f"{json.dumps(r['errs'])}")
        r = check_ssd_kernel(timed=False, reps=0)
        log(f"ssd_scan equals its plain version: {json.dumps(r['errs'])}")
        return 0

    # ---- phase 2: kernels against their plain versions, and their times
    checks = {}
    for net, target, timed in (("yolov2", CHUNK * 8, True),
                               ("resnet152", CHUNK, True),
                               ("retinanet", CHUNK, True),
                               ("efficientnet-b1", 200000, False)):
        t0 = time.perf_counter()
        checks[net] = check_kernels(net, target, timed, reps=10)
        c = checks[net]
        log(f"kernels == plain versions at {net} shapes "
            f"(B={c['B']}, G={c['G']}, runs={c['runs']}, K1 slots "
            f"{c['alloc_slots']}): max abs err "
            f"{c['errs']} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    prefix = check_alloc_prefix(timed=True, reps=10)
    log(f"alloc_scan from its state rows == the plain version's whole "
        f"replay: {json.dumps(prefix)} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    scorer = check_scorer(SCORER_SHAPES, timed=True, reps=20)
    log(f"score_batch == plain version at {SCORER_SHAPES}: "
        f"{json.dumps(scorer)} ({time.perf_counter() - t0:.1f} s)")
    scorer_at_edges = scorer_edges()
    log(f"score_batch == plain version at the rule's crossover and G 1: "
        f"{json.dumps(scorer_at_edges)}")
    in_replay = scorer_device_replay(reps=20)
    log(f"score_batch under the device replay, one kernel a call and no "
        f"copy: {json.dumps(in_replay)}")
    t0 = time.perf_counter()
    lm = check_lm_kernels(timed=True, reps=5)
    log(f"LM kernels == plain versions: {json.dumps(lm)} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ssd = check_ssd_kernel(timed=True, reps=5)
    log(f"ssd_scan == plain version: {json.dumps(ssd)} "
        f"({time.perf_counter() - t0:.1f} s)")
    lm["errs"].update(ssd["errs"])
    lm["times"].update(ssd["times"])

    # ---- phase 3: the main path, four sweeps, each with its own launch
    # counts (set to 0 just before the sweep, read just after)
    nets = list(CNN_BUILDERS)
    results, launches, fused, variants = {}, {}, {}, {}
    for engine, backend, limits, needed in SWEEPS:
        swept, counts, in_k3, by_variant = drive_main_path(nets, engine,
                                                           limits, backend)
        launches[engine, backend] = counts
        fused[engine, backend] = in_k3
        variants[engine, backend] = by_variant["score_batch"]
        results.update(swept)
        log(f"launches under engine={engine!r}, backend={backend!r}: "
            f"{counts}; fused into another kernel's launch: {in_k3}; "
            f"score_batch by variant: {by_variant['score_batch']}")
        # the main path gives K5 batches of 1 to 1,024: all on the split
        # kernel
        require(by_variant["score_batch"]
                == {"thread": 0, "split": counts["score_batch"]},
                f"engine={engine!r}, backend={backend!r}: score_batch ran "
                f"as {by_variant['score_batch']}, not all split")
        for name in needed:
            require(counts[name] > 0,
                    f"kernel {name} was never launched under "
                    f"engine={engine!r}, backend={backend!r}")
        # every chunk winner is taken by K3's last block
        require(counts["argmin_rows"] == 0
                and in_k3["argmin_rows"] == counts["cost_rows"],
                f"engine={engine!r}, backend={backend!r}: argmin_rows "
                f"launched {counts['argmin_rows']} times, its reduction run "
                f"in {in_k3['argmin_rows']} of {counts['cost_rows']} K3 "
                f"launches")
    check_main_path(results)
    check_pallas_path(results)

    # ---- phase 3b: the search pool on the card, its kernels launched in
    # spawned workers, and its fault tolerance
    t0 = time.perf_counter()
    pool = pool_phase(results)
    log(f"pool phase ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 3c: the compile service on the card, each request with its
    # own launch counts
    t0 = time.perf_counter()
    service = service_phase(results)
    log(json.dumps(service))
    log(f"service phase ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 4: the quickstart pipeline at full width
    t0 = time.perf_counter()
    quick = quickstart(nets)
    log(f"quickstart pipeline on {len(quick)} nets: compile, strict verify, "
        f"audit, simulator == run_graph bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 5: the LM serving path, one serve per architecture with
    # its own launch counts, and each model held against its plain versions
    served, checked = {}, {}
    for arch in LM_SERVES:
        t0 = time.perf_counter()
        served[arch] = serve_phase(arch)
        log(json.dumps(served[arch]))
        checked[arch] = model_check(arch)
        log(json.dumps(checked[arch]))
        log(f"serve phase of {arch} ({time.perf_counter() - t0:.1f} s)")
    for arch in LM_CHECKS:
        t0 = time.perf_counter()
        checked[arch] = model_check(arch)
        log(json.dumps(checked[arch]))
        log(f"model check of {arch} ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 7: the training path at full width, its gradients through
    # the kernels, and a restart from a checkpoint
    trained = train_phase()
    log(f"train phase ({trained['seconds']:.1f} s)")

    # ---- phase 8: the example twins at their defaults
    t0 = time.perf_counter()
    examples_phase()
    log(f"examples phase ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 9: the dry-run's memory model on the card, and a mesh of
    # one rank against no mesh
    meshed = mesh_phase()
    log(f"mesh phase ({meshed['seconds']:.1f} s)")

    # ---- phase 10: the model axis, meshes (1, 2) and (1, 3) as two and
    # three ranks on the card
    model_axis = model_axis_phase()
    log(f"model axis phase ({model_axis['seconds']:.1f} s, of which the "
        f"ranks {model_axis['ranks_s']})")

    # ---- phase 6: numbers
    for (net, engine, backend), (sig, seconds, opts) in results.items():
        log(json.dumps({
            "compile": net, "engine": opts.engine_spec().spelling(),
            "backend": backend, "path": sig["path"],
            "evaluated": sig["evaluated"], "wall_s": seconds,
            "candidates_per_s": sig["evaluated"] / seconds}))
    for net in ("yolov2", "resnet152", "retinanet"):
        c = checks[net]
        log(json.dumps({"kernel_times_at": net, "B": c["B"], "G": c["G"],
                        "L": c["L"], "alloc_slots": c["alloc_slots"],
                        "alloc_ops_per_candidate":
                            c["alloc_ops_per_candidate"],
                        "times": c["times"]}))
    by_sweep = {name: {f"{e}+{b}": launches[e, b][name]
                       for e, b, _l, _n in SWEEPS}
                for name in KERNEL_INFO}
    main_shape = checks["yolov2"]
    kernels = []
    for name in PIPELINE_KERNELS:
        info, t = KERNEL_INFO[name], main_shape["times"][name]
        # K4 runs in K3's last block on the main path: its launches are
        # those, its standalone kernel's are 0
        main = fused if name == "argmin_rows" else launches
        kernels.append({
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"],
            "launches": main["pipeline", "numpy"][name],
            "launches_by_sweep": by_sweep[name],
            "max_abs_err": max(c["errs"][name] for c in checks.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": {"B": main_shape["B"], "G": main_shape["G"],
                      "L": main_shape["L"]}})
        kernels[-1]["device_ms"] = t["device_ms"]
        if name == "enum_frames":
            kernels[-1]["vec"] = t["vec"]
        if name == "cost_rows":
            kernels[-1].update({k: t[k] for k in (
                "plan", "at_plans", "by_groups", "device_ms_without_winner")})
        if name == "argmin_rows":
            kernels[-1].update({
                "standalone_launches": launches["pipeline", "numpy"][name],
                "fused_launches_by_sweep": {
                    f"{e}+{b}": fused[e, b][name] for e, b, _l, _n in SWEEPS},
                "fused_into": info["fused_into"],
                "standalone": info["standalone"],
                "times_are_of": "the standalone kernel at L rows"})
        kernels[-1]["launches_in_service_phase"] = (
            service["fused_launches"] if name == "argmin_rows"
            else service["launches"]).get(name, 0)
        if name in ("alloc_scan", "cost_rows"):
            kernels[-1]["at_other_shapes"] = {
                net: {"B": checks[net]["B"], "G": checks[net]["G"],
                      "slots": checks[net]["alloc_slots"],
                      **checks[net]["times"][name]}
                for net in ("resnet152", "retinanet")}
        if name == "alloc_scan":
            kernels[-1]["slots"] = main_shape["alloc_slots"]
    info = KERNEL_INFO["alloc_prefix"]
    kernels.append({
        "name": "alloc_prefix", "route": "cuda", "source": info["source"],
        "replaces": info["replaces"],
        "launches": launches["pipeline", "numpy"]["alloc_prefix"],
        "launches_by_sweep": by_sweep["alloc_prefix"],
        "launches_in_service_phase": service["launches"].get(
            "alloc_prefix", 0),
        "max_abs_err": 0, "cases": {k: v for k, v in prefix.items()
                                    if k not in ("device_ms", "event_ms")},
        "device_ms": prefix["device_ms"], "event_ms": prefix["event_ms"]})
    info = KERNEL_INFO["score_batch"]
    t, chunk, descent = (scorer[net] for net, _b in SCORER_SHAPES)
    kernels.append({
        "name": "score_batch", "route": "cuda", "source": info["source"],
        "replaces": info["replaces"],
        "launches": launches["pipeline", "pallas"]["score_batch"],
        "launches_by_sweep": by_sweep["score_batch"],
        "launches_by_variant": {f"{e}+{b}": variants[e, b]
                                for e, b, _l, _n in SWEEPS},
        "variants": info["kernels"],
        "max_abs_err": max([r["max_abs_err"] for r in scorer.values()]
                           + list(scorer_at_edges["errs"].values())),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "device_ms": t["device_ms"], "launch_floor_ms": t["launch_floor_ms"],
        "variant": t["variant"], "by_variant": t["by_variant"],
        "shape": {"B": t["B"], "G": t["G"]},
        "at_chunk": chunk, "at_descent_batch": descent,
        "launches_in_service_phase": service["launches"].get(
            "score_batch", 0)})
    lm_times = lm["times"]
    for name in LM_KERNELS:
        info, t = KERNEL_INFO[name], lm_times[name]
        arch = next(a for a, v in LM_SERVES.items() if name in v["launches"])
        entry = {
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"],
            "launches": served[arch]["launches"][name],
            "launches_by_serve": {a: served[a]["launches"][name]
                                  for a in LM_SERVES},
            "launches_in_model_checks": {
                a: checked[a]["launches"].get(name, 0) for a in LM_SERVES},
            "launches_in_lm_checks": {
                a: checked[a]["launches"].get(name, 0) for a in LM_CHECKS},
            "max_abs_err": lm["errs"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), "shape": t["shape"]}
        if "variants" in info:
            entry["variants"] = info["variants"]
            entry["launches_by_variant"] = served[arch][
                "launches_by_variant"][name]
        if name == "flash_attention":
            entry["library"] = ("torch.nn.functional.scaled_dot_product_"
                                "attention, boolean causal-and-window mask, "
                                "enable_gqa=True")
            entry["library_max_abs_err"] = t["library_max_abs_err"]
        if "earlier_design_ms" in t:
            entry["earlier_design_ms"] = t["earlier_design_ms"]
            entry["earlier_design"] = ("the SIMT kernel on the same "
                                       "bfloat16 inputs")
        if name in TRAIN_LAUNCHES_PER_STEP["full"]:
            entry["launches_in_train_phase"] = {
                remat: run["launches"][name]
                for remat, run in trained["runs"].items()}
        entry["launches_in_grad_checks"] = {
            a: c["launches"].get(name, 0)
            for a, c in trained["grad_checks"].items()}
        if name == "ssd_scan":
            entry["at_float32"] = t["float32"]
            entry["at_rank_shape"] = t["at_rank_shape"]
        if name == "rglru_scan":
            entry["at_rank_shape"] = lm_times["rglru_scan_rank"]
        if name in lm["families"]:
            entry["at_other_shapes"] = lm["families"][name]
        if name == "fused_block":
            entry["at_decode"] = lm_times["fused_block_decode"]
            entry["matmul_ms"] = t["matmul_ms"]
            entry["matmul"] = ("torch.matmul of n @ Wg, n @ Wu and h @ Wd "
                               "in bfloat16, the block's products alone")
            entry["at_wide_float32"] = lm["wide"]
        kernels.append(entry)
    axis_rows = {cid: row for cid, row in model_axis["rows"].items()
                 if cid != "psum" and not row["check"]}
    for name, base, form, main_case in (
            ("flash_attention[q_offset]", "flash_attention", "q_offset",
             f"{MODEL_AXIS_CP_ARCH}-bf16"),
            ("fused_block[partial]", "fused_block", "partial",
             "recurrentgemma-2b-bf16")):
        info, t = KERNEL_INFO[base], lm_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"],
            # both ranks' launches (rank 0's cp slice starts at 0: K6
            # runs there without the offset)
            "launches": sum(r[base][form] for r in
                            axis_rows[main_case]["launches_by_form"]),
            "launches_by_rank": {
                cid: [r[base][form] for r in row["launches_by_form"]]
                for cid, row in axis_rows.items()},
            "max_abs_err": lm["errs"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), "shape": t["shape"],
            "variants": info["variants"]})
        if form == "q_offset":
            kernels[-1]["library"] = (
                "torch.nn.functional.scaled_dot_product_attention, boolean "
                "mask of the slice's positions, enable_gqa=True")
            kernels[-1]["library_max_abs_err"] = t["library_max_abs_err"]
        else:
            kernels[-1]["matmul_ms"] = t["matmul_ms"]
    for entry in kernels:
        entry["launches_in_mesh_phase"] = {
            run: meshed[run]["launches"].get(entry["name"], 0)
            for run in ("serve", "train")}
        if entry["name"] in LM_KERNELS:
            entry["launches_in_model_axis_phase"] = {
                cid: [r.get(entry["name"], 0) for r in row["launches"]]
                for cid, row in axis_rows.items()}
    serial_wall = yolov2_wall_and_busy()
    log(json.dumps(serial_wall))
    pool["serial_wall_ms_median"] = serial_wall["wall_ms_median"]
    pool["card"] = card
    log(json.dumps(pool))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)
