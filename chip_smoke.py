#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, in order; any failed check raises and the script exits non-zero:

1. Report the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; build every CUDA kernel from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once).
2. Kernel phase: hold each kernel against its plain PyTorch version on the
   card at the shapes the main path gives it, and time both with CUDA
   events (median of repeated launches).  The segment-view family runs at
   the main path's sizes with random ids (the worst case), after its path
   choice (``segment_view_plan``) is held equal to the Python mirror; both
   degrees take path A with each group's row where G = M; the blocks
   kernel's paths A and C run at every degree, also in float64, with
   random ids.  The grouped Grams' launch plan (``segment_gram_plan``:
   CTAs a tile, entry split, copies of the hot bands, chunks) is held
   equal to its mirror, and segment_gram must take one launch at K = 6,
   G = 4,100.  moments at the date column is held to plain in float32 and
   float64; it, segment_gram and multi_segment_gram are also timed back
   to back and profiled.  Also gram at
   K = 130, forced segment_gram group chunking, chunking by the plan at
   K = 40, G = 4,000, a float64 and a K = 313 grouped Gram, the
   multi_segment_gram per-column fallback, and flash at the serving
   path's shape (bf16 and float32),
   olmo-1b's and mixtral's head layouts (the latter windowed), non-causal
   ragged lengths and the head dims 8 to 256, and phase 13's model
   shapes: whisper-medium's cross attention (4,096 queries over 1,500
   keys, non-causal, bf16 and float32) and causal self attention (16
   heads of 64), llava-next-mistral-7b's prefill (32 / 8 heads of 128);
   float32 at head dims up to 128 bound by its 3xTF32 kernel (3 times the
   operations at TF32's rate), the scalar bound (float32's rate) beside
   it, and first the library's float32 instantiation per head dim must
   equal ``f32_geometry``'s and its workspace ``fwd_f32_workspace``'s.
   At every one of those shapes the flash backward (``flash_bwd``: dq, dk,
   dv from the forward kernel's output and row log-sum-exp) is held to
   ``flash_backward_ref`` by flash's three bounds, each of dq, dk and dv
   (elementwise FLASH_TOL, each row FLASH_ROW_RTOL, the whole tensor
   FLASH_NORM_RTOL; exact zeros where no row sees a key, in bf16 and
   float32), and timed at the training shapes (smollm-135m's, qwen2-moe-
   a2.7b's 16 heads of 128 as olmo-1b's, llava-next-mistral-7b's) and at
   whisper-medium's cross and self attention beside its bound (2.5 times
   the forward's operations; the bytes of q, k, v, o, dO, dq, dk, dv, L
   and Δ; float32 at head dims up to 128 bound as the forward) and the
   backward of
   ``scaled_dot_product_attention``; first the library's instantiation per
   head dim, in bf16 and float32, must equal ``bwd_geometry``'s, and its
   workspace size ``bwd_workspace``'s at every shape.
3. Main path: ``favorita_like(1684, 54, 4100, 0.05, seed=0)`` (18,641,880
   sales rows) through ``linear_regression`` v1 (BGD, V1_MAX_ITER steps)
   and closed form, both with the moments kernel, then one degree-1
   aggregate batch.  Launch
   counters are zeroed just before and read just after; every kernel must
   have launched.  The degree-1 batch is checked against float64 sums of
   the fact table.  The arguments of the profiled closed-form traversal's
   ``segment_view`` and ``segment_blocks`` calls are captured, and each
   call runs again: against its plain version, path A bitwise equal across
   two calls, one float64 call per path, timed per call and back to back
   beside its bound and its device time in the profiled traversal; then
   the host/device split of one regroup at transactions against
   ``index_add_``.  The degree-1 batch runs profiled, and its
   ``segment_view`` calls are captured and run again the same way.  The
   profiled closed-form run's ``moments`` calls (one a column) are
   captured too; each runs again against its plain version, timed per
   call, back to back and profiled beside its 4·m-byte bound.
4. Categorical and cofactor baselines, on the same 18.6 M-row bundle:
   ``linear_regression`` closed form with ``categorical=("store_nbr",
   "item_nbr")`` on its factorized leg and on its materialized leg through
   the ``multi_segment_gram`` kernel (4,158 coefficients; the two must
   predict alike and agree in θ off the one-hot null space), the scale
   factors through ``moments``, ``cofactors_materialized`` through ``gram``
   (against the factorized cofactors), ``cofactors_streaming`` in 4 M-row
   chunks (against the one-shot Gram) and ``cofactors_grouped`` by item
   through ``segment_gram`` (its groups sum to the global cofactors).
   Counters are zeroed before and read after; all seven kernels must have
   launched.  A second, profiled run of the factorized leg captures its
   degree-1 ``segment_view`` calls (the ``g:`` queries), and the
   ``segment_gram`` and ``multi_segment_gram`` calls of the grouped and
   materialized paths are captured; each runs again against its plain
   version and is timed beside its bound.  Before each profiled rerun
   (phases 3 and 4) the store's view cache is evicted, so that no node is
   served from it and every kernel of the rerun launches.
5. Incremental maintenance, on a fresh lazy ``Store`` over the same
   relations: cold continuous and categorical ``sufficient_stats`` (torch
   backend) publish their views to the 256 MB view cache (the 18.6 M-row
   views exceed it and are dropped); then one new day (11,070 sales rows,
   54 transactions, 1 oil price, drawn as ``favorita_like`` draws, the
   dates new to the date dictionary) is appended to three relations, and
   drained by ``flush``, profiled, with the launch counters zeroed before
   and read after: ``segment_view``, ``segment_view1`` and
   ``segment_reduce`` must launch.  The read after the drain must visit no
   node, and the drained statistics must equal a cold recompute on the
   merged catalog (a fresh store, ``refresh=True``) within 1e-4 of the
   largest cofactor.  (The batch of 9 more days runs on the oracle cell
   only, for the smoke's time.)  Each ``segment_blocks`` call of the drain's
   ``_merge_views`` (cached view ⊎ delta view) runs again against its
   plain version, timed beside its bound and ``index_add_``.  On the
   oracle cell (below) one day and then 9 more (27 appends, below the
   compaction ratio, so they fold) drain on the float64 numpy engine
   to a cold numpy recompute within 1e-12, the float32 torch drain equals
   the float64 one within 1e-4, and the warm closed form
   (``use_cache=True``) equals the cold one within 1e-8.
6. Oracle: the torch engine on the card against the port's float64 numpy
   engine on the 410-item bundle (1,864,188 sales rows), for the continuous
   and the categorical closed form; and the FD leg on ``fd_star_schema``
   (8 categorical keys, each determining a second one): FD-reduced equals
   full at 1e-10 on the numpy engine and predicts alike through the
   float32 ``multi_segment_gram`` kernel.  The categorical torch leg
   starts from an empty view cache (else the numpy leg's float64 views
   would serve it).
7. LM serving: smollm-135m at its full published width and depth (30
   layers, d_model 576, 9 query / 3 KV heads, vocab 49,152, bf16; random
   weights from a seeded generator) behind the continuous-batching
   ``Engine`` (4 slots, prompts padded to 4,096 tokens, a 4,160-slot
   cache) answers 4 requests of 2,049–4,096 prompt tokens and 32 new tokens
   each (8 until phase 12 needed the smoke's time).  Counters are zeroed before and read after: the flash kernel must
   have launched exactly 30 times per prefill.  Then the same weights in
   float32 serve the same requests; their greedy tokens must be those of
   the full-forward oracle (one teacher-forced forward per request, which
   also runs flash 30 times), except at reported near-ties (top logit within
   1e-3 of the engine's pick), and a prefill's last logits must match the
   plain ``chunked_attention`` path on the card within 1e-4 of the largest.
   Last, the bf16 model's forward logits at all 4,096 positions through
   flash are held to the plain path in bf16 and, beside it, to the float32
   model (flash may be no farther from float32 than the plain path is).

8. GLM and polynomial, run after phase 5 on phase 3's 18.6 M-row store
   (logged as phase 8).  bench_categorical's GLM leg at full size: logistic,
   ridge 1e-3, label ``onpromotion``, ``transactions`` with the two
   categorical keys (4,156 parameters; G ≈ m groups) and the keys alone
   (G = 221,400): the compression through the torch engine on the card
   (segment_view and segment_reduce must launch, counters zeroed before
   and read after), host float64 IRLS, and GD with ``gd_accum="pairs"`` on
   the card for GLM_GD_STEPS steps (the G ≪ m leg twice, to see whether
   the float32 atomics of the gradient scatter repeat) and for one
   profiled chunk (device busy against wall a step, the device traced
   alone); GD's gradient at its
   last θ equals the host's float64 one within 1e-3 of the magnitudes each
   entry sums.  Each leg's compression then runs again, equal to the
   first, its segment_view and segment_blocks calls captured and run
   again against their plain versions (1e-4 of the largest sum) beside
   ``index_add_`` and their bound.  Then
   ``polynomial_cofactors`` at degree 3 (aggregates up to degree 6,
   float64 on the card through segment_reduce; its degree-1 block equal
   to the float64 quadratic engine at 1e-10; degrees 1 and 2 are cut at
   full size for the smoke's time); the degree-3 run's
   ``segment_blocks`` calls are captured and run again against their plain
   version beside ``index_add_`` and their bound (until PR 23 a second
   degree-3 run was captured).  On the oracle cell: the
   torch compression equals the numpy one exactly and IRLS θ on the two is
   bitwise equal; GD (``pairs``, up to 100,000 steps) on the
   categorical-only design predicts within 5e-3 of IRLS, twice (fp32
   accumulation is run beside it and reported); polynomial degrees 1–3 on
   the card equal the CPU's at 1e-12 and degree 2 the flat oracle at rtol
   1e-7; ``sum_product`` equals the numpy engine's cofactors.  On the FD
   cell, ``glm_regression`` with the compression on the card: FD-reduced
   equals full at 1e-10, penalized NLLs within 1e-8.
9. The multi-tenant factorized service, run after phase 8 (logged as phase
   9), on a fresh lazy ``Store`` over phase 3's relations.  Leg 1, at
   full size: ``FactorizedService(store)`` with its defaults (the torch
   engine on the card), its threaded runtime started; eight client
   threads, tenants t0–t7, send a window of 12 reads — 6 trains (ridge
   0.006, label ``unit_sales``) over feature subsets drawn Zipf-skewed
   (seeded) from a pool of overlapping subsets of the eight features, 3
   scores of phase 3's closed-form θ, 2 cofactor reads and 1 aggregates
   read (degree 1 by ``store_nbr``, degree 2 by ``cluster``).  The window
   arrives as one burst (queued in a fixed order while the cycle lock is
   held), so the worker serves it in one cycle: its merged plan fails, as
   the aggregates read groups by attributes other reads use as features,
   and the cycle bisects it as the reference does.  A writer tenant then
   appends one new day (phase 5's ``new_days``: 11,070 sales rows, 54
   transactions, 1 oil price) in three tickets, which the idle policy
   folds; window 2 sends the 12 reads again and one that the fold leaves
   cold (degree 1 by ``date``); ``stop(drain=True)``.  Launch counters
   are zeroed before and read at each step's end (under the cycle lock):
   segment_view and segment_reduce must launch in both windows and in the
   fold.  Every segment-kernel call of the three steps is captured, with
   its output, from the worker threads, then run again against its plain
   version (1e-4 of the largest; the worker's own output too), timed
   beside its plain version, its bound and ``index_add_`` (JSON rows
   ``service``).  Every ticket must resolve with a value, nothing be
   quarantined, no fold fail, and the per-tenant passes, node visits and
   view-cache hits, misses and bytes sum to the store totals exactly.
   Each read is held to float64 numpy over its window's catalog
   (``Oracle64``: the join is the sales rows with their dimension rows
   looked up; a train's θ is the scaled ridge solve, in numpy): cofactors
   and group sums within 1e-4 of the largest, a score within 1e-4 of the
   magnitude its quadratic form sums, a train's θ in the scaled
   coordinates within 1e-3 of its largest coefficient and its predictions
   on every join row within 1e-4 of the largest (its θ error per
   coefficient against 1e-3 is reported: float32 leaves the coefficients
   the data barely determine free, as in the reference,
   ``tools/service_theta_witness.py``).  Window 1 runs again with
   ``coalesce=False`` on another fresh store for the first read of each
   kind (the private arm; each coalesced ticket of those reads equal to
   its private answer within 1e-4), and once more, coalesced, on the merged catalog, cold and profiled
   (device busy against wall, peak memory).  Leg 2, on the oracle cell:
   the same schedule on the float64 numpy service and on the card (held to
   each other and to the numpy, whose θ is held to ``linear_regression``'s
   warm closed form at 1e-8); then on the card under a seeded
   ``FaultInjector`` with a ``RetryPolicy``: eviction storms every 2
   snapshots, random node faults at 5 % and then 20 %, a terminal trap in
   window 2 and the idle fold poisoned.  A failed ticket must fail with an
   injected fault or ``ServiceStopped``, a fault must fire, and every
   served read equals the fault-free run's within 1e-4.  Leg 3, on the
   oracle cell: the schedule on the card once more, with the port's
   ``LockSanitizer`` (``repro_torch.analysis``) installed after the service
   is built and before its runtime starts, wrapping the service's and the
   store's locks and the kernels' ``_load_lock`` (put back after).  Its
   report must be empty (no lock taken out of the declared order, no wait
   while holding another lock, no field whose lockset went empty); the
   cycle, queue and stats locks, the store's mutate lock and the view
   cache's lock must each be acquired and the access probes fire;
   segment_view and segment_reduce must launch, every segment-kernel call
   with the cycle lock held; every read is held to ``Oracle64`` as in leg
   2 and to the unsanitized card run's within 1e-4.  Each segment-kernel
   call of leg 3 (captured with its output) then runs again against its
   plain version, as leg 1's do; they are the kernels line's
   ``sanitized`` entries of rows 1 and 3.

10. Distribution at world size 1, run after phase 7: a process group of
   one rank on NCCL (a ``FileStore`` rendezvous in a scratch directory of
   the checkout) and a ``("data",)`` ``DeviceMesh`` of 1.  On phase 4's
   join, kept as arrays (18,641,880 rows), ``sharded_cofactors`` must equal
   phase 4's factorized cofactors and ``sharded_cat_cofactors`` the
   factorized categorical cofactors of phase 4's factorized leg, each within
   1e-4 of the largest; both incremental functions fold the last date's
   rows into the cofactors of the rest, within 1e-4 of the whole.  Launch
   counters are zeroed before and read after: ``gram`` and
   ``multi_segment_gram`` must launch; every call of either is captured
   with its output and run again against its plain version (KERNEL_RTOL),
   timed beside its bound and, for gram, ``x.T @ x``.  Seconds by call:
   kernels, ``all_reduce`` (each synchronised) and the rest (host slicing
   and padding, copies, the pair counts' scatter).  ``compressed_psum`` on
   the group of one must equal ``compress_decompress`` on the same tree.
11. LM training: ``python -m repro_torch.launch.train``'s path
   (``launch.train.setup`` / ``run``) for smollm-135m at full width and
   depth in float32 (30 layers, d_model 576, 134.5 M parameters,
   microbatches 4), seeded weights, ``TokenPipeline`` batches of 8 × 128
   tokens, AdamW with the CLI's schedule (peak 3e-4, warmup 1, cosine over
   20 steps).  Step 2 (the first with a learning rate) on the card is held
   against the same step on the CPU from a copy of the same state: loss
   and grad norm at float32 tolerance, parameters within 1e-2 of the
   learning rate, moments within 1e-4 of each leaf's largest.  Then 10
   steps with an async checkpoint at step 5: the mean loss of the last 5
   below that of the first 5; a fresh run resumed from the step-5
   checkpoint alone repeats steps 5–9 within 1e-4 of their losses; a
   5-step ``--compress-grads`` run's loss falls.  Step ms (median),
   tokens/s and peak memory are reported.  Over the 2,048-token threshold
   (the configs' ``train_4k`` length): one float32 microbatch of 1 × 4,096
   tokens at full width and depth, its loss and every leaf's gradient
   through the kernels (flash and flash_bwd exactly 30 times each, counted
   from zero) against the same step through the plain
   ``chunked_attention`` on the card (checkpointed; no kernel launched):
   loss 1e-6 relative, grad norm 1e-5, each leaf 1e-4 of its largest, and
   the same loss and gradients once more under the profiler (the device
   alone): the device ms of flash_bwd's kernels and of flash's;
   then the config's bf16 at 4 × 4,096 tokens in 4 microbatches for 6
   steps through ``launch.train`` (flash and flash_bwd 720 times each):
   the mean loss of the last 3 steps below that of the first 3, step ms,
   tokens/s, peak memory; then one more step under the profiler (the
   device alone): device busy against the run's median step, and the
   device ms of flash_bwd's kernels and of flash's by kernel name; then
   the dry run's estimate of that step (``launch.dryrun --mesh host``,
   one device on meta tensors, in a host subprocess that sees no card,
   started before phase 1 and run beside phases 1–11; its status must be
   ``ok``): its memory beside the measured peak and
   their ratio, its counted FLOPs beside ``model_flops``, and the step's
   model FLOPs over step time × the bf16 peak, with the card's name and
   power limit.  Step 2's line also prints the host's
   ``torch.backends.cpu`` capability.
   Last, ``--mesh 1x1`` (a NCCL group of one that
   the run starts and ends; the state and batches DTensors under the train
   policy) for 3 steps at 8 × 128 against the same run without a mesh:
   losses, grad norms and every leaf of the final state within 1e-5.
   Beside every phase, a second host subprocess that sees no card runs the
   dry run on the production meshes (``MESH_CELLS``: smollm-135m at 2
   layers, qwen2-moe-a2.7b at 1, xlstm-1.3b at 8, on fake groups of 256
   and 512 ranks, this host's torch); after phase 13 every cell must be
   ``ok``, each smollm cell on ``pod16x16`` within 1.1 times its data
   shard's share of the unsharded FLOPs, and the smollm train step's peak
   estimate within 24 GB (JSON line ``{"mesh_cells": ...}``).
12. The MoE, Mamba and xLSTM mixers, after phase 11.  Leg 1: qwen2-moe-a2.7b
   at full width and depth (24 layers of attention + MoE, 60 experts top-4
   and the shared experts, bf16, seeded weights) behind the ``Engine``
   with phase 7's prompts and budget (4 requests of 2,049–4,096 tokens, 32
   new, 4 slots, prefill 4,096): flash must launch exactly 24 times a prefill;
   the dropped (token, pick) share of each prefill (pads are routed, as
   in the reference), tokens/s, latency, prefill and decode-step ms, a
   profiled decode step.  flash at this shape (16 heads of 128) as in
   phase 2.  The bf16 forward over 4,096 positions at full depth, flash
   vs the plain path, each held to the float32 model (the weights cast
   in place) as phase 7 holds it.  Then the first 4 layers in float32:
   each MoE layer of one prefill at the serving capacity factor — the
   plain dispatch on the CPU from the card's own router probabilities
   equal to the card's (selection, positions, keep), the output within
   1e-5 of the CPU float32 layer's wherever the two selections agree
   (a differing selection must be a near-tie, within 1e-6); and, dropless,
   the engine's greedy tokens against the full-forward oracle, as in
   phase 7.  Leg 2: xlstm-1.3b at full width and depth (6 sLSTM and 42
   mLSTM layers, bf16) serves 1 prompt of 2,048–4,096 tokens (a multiple
   of ``xlstm_chunk``) through the exact-length prefill, 32 new tokens:
   sLSTM and mLSTM prefill seconds, decode-step ms; in float32, a
   2,048-token prefill and 256 teacher-forced decode steps against the
   full forward at 2,304 tokens (1e-4 of max |logit|).  Leg 3: one Mamba
   mixer at jamba-1.5-large's width (d_inner 16,384) over 4,095 tokens
   (not a multiple of the chunk) with its peak memory bounded by chunked
   working sets, 64 decode steps from its cache, in float32 against the
   apply at 4,159 tokens (1e-4 of the largest); then jamba's smoke config
   end to end through the ``Engine``, card tokens equal to the CPU's.
   ``launch.serve --arch qwen2-moe-a2.7b`` and ``--arch xlstm-1.3b`` run
   at full size after their legs.
13. whisper's encoder and cross attention and llava's patch prefix, after
   phase 12.  Leg 1: whisper-medium at full width and depth (24 encoder
   and 24 decoder layers, d_model 1,024, 16 heads of 64, bf16, seeded
   weights) serves 4 requests of 1,500 seeded stub frames and a 64-token
   prompt, 128 greedy new tokens each, through ``prefill`` and
   ``decode_step`` (the engine takes token prompts only): the encoder
   and cross attention stay dense at 1,500 frames, so flash must launch
   0 times; encode, prefill and decode-step ms, tokens/s, peak memory, a
   profiled decode step.  The bf16 forward at 4,096 decoder tokens (the
   repo's prefill_32k shape cut as phase 7 cuts it) launches flash
   exactly 48 times (24 self, 24 cross) and is held to the plain path
   and to the float32 model with phase 7's ratios; the float32 replica
   (the weights cast in place) decodes the 4 requests again: every
   decode step's logits (through the cross cache) within 1e-4 of the
   teacher-forced full forward's largest, and its greedy tokens the
   forward's top logit but near-ties.  Leg 2: llava-next-mistral-7b at
   full width and depth (32 layers, d_model 4,096, 32 / 8 heads of 128,
   bf16) serves 2 requests of 2,880 seeded patch embeddings and 1,216
   tokens (4,096 positions), 32 greedy new tokens each, decode
   positions after the prefix: flash exactly 32 times a prefill; the
   bf16 forward at 4,096 positions as leg 1's; the float32 replica at
   full depth against the full forward as leg 1's; then its first 2
   layers in one row's prefill on the card (the patch prefix and 64
   tokens, 2,944 positions), each layer's attention and MLP again on the
   CPU on the card's own input (as phase 12 holds each MoE layer):
   outputs, cached V and cached K before RoPE within 1e-5 of the largest
   (RoPE's float32 angles round apart on the two devices).

The last lines are the phase-8 JSON object, the phase-9 JSON object
(``{"service": ...}``), the phase-10, phase-11, phase-12 and phase-13
JSON objects (``{"distribution": ...}``, ``{"training": ...}``,
``{"mixers": ...}``, ``{"encoder_decoder": ...}``), the kernels JSON
object, the card's name and power limit, and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch.mesh import HW  # noqa: E402  (the card's constants; imports torch alone)

SEED = 0
N_SALES = 18_641_880  # favorita_like(1684, 54, 4100, 0.05) fact rows
SALES_FRACTION = 0.05  # the cut's share of (date, store, item) triples
HBM_BYTES_PER_S = HW.hbm_bw  # H100 SXM, 3.35e12
FP32_FLOPS = HW.peak_flops_fp32  # H100 SXM, off the tensor cores, 67e12
BF16_FLOPS = HW.peak_flops_bf16  # H100 SXM, dense tensor cores, 989e12
TF32_FLOPS = HW.peak_flops_tf32  # H100 SXM, dense tensor cores, 495e12
# kernel vs plain: both sum in float32 in run-dependent orders (atomics);
# the rounding error of a sum of n terms is ~sqrt(n)·2^-24·Σ|terms|, under
# 1e-5 of the largest sum at the ≤ 10^4 terms per group these shapes have
KERNEL_RTOL = 1e-4
# float64 kernels vs plain: sums of ≤ 10^4 terms in another order, ~1e-16
# relative each
F64_RTOL = 1e-10
# float32 engine on the card vs the float64 numpy engine, relative to the
# largest cofactor: 1.86 M rows summed in float32 through five nodes
ORACLE_RTOL = 1e-4
THETA_RTOL = 1e-3
# categorical θ in float32: the one-hot blocks and the intercept are
# collinear, so θ along those null directions is pinned only by the 0.006
# ridge and float32 rounding of the grouped sums moves it freely.  What the
# data determine is compared: predictions on every join row (≤ 1e-4 of the
# largest) and θ with its null-space components removed — the level
# (intercept plus each block's mean), the continuous coefficients and each
# block centred (≤ 5e-4 of the largest).  Both sit well above float32
# rounding of 18.6 M-row sums carried through a solve whose identifiable
# part is well conditioned; PERF.md records the observed errors.
PRED_RTOL = 1e-4
THETA_ID_RTOL = 5e-4
FD_ATOL = 1e-10  # FD-reduced vs full, float64 (the reference's own bound)
CAT = ("store_nbr", "item_nbr")
N_CAT_PARAMS = 1 + 2 + 54 + 4_100 + 1  # intercept, date, onpromotion, blocks, label
STREAM_ROWS = 4_000_000
# phase 3: v1's BGD budget (the version's own 200,000 until the flash
# backward's checks needed the smoke's time; v1's θ is checked finite)
V1_MAX_ITER = 25_000
GRAM_WIDE = (1_000_000, 130)  # the reference's widest gram test, scaled up
# the kernels each path must launch: phase 3 (the continuous main path)
# and phase 4 (all seven)
PHASE3_KERNELS = ("segment_view", "segment_view1", "segment_reduce", "moments")
PHASE4_KERNELS = PHASE3_KERNELS + ("gram", "segment_gram", "multi_segment_gram")
ALL_KERNELS = PHASE4_KERNELS + ("flash", "flash_bwd")  # phases 7 and 11 launch these
# the engine's host-side structure work, timed by name (Timers): joins and
# group keys where the engine and polynomial modules call them, group ids
# where kernels.ops does
HOST_JOIN = ("join_keys", "sort_merge_join", "group_key")
HOST_IDS = ("group_ids_device",)
# phase 5: every drain folds through these
INGEST_KERNELS = ("segment_view", "segment_view1", "segment_reduce")
INGEST_BATCH_DAYS = 9  # the second append: ~100 K sales rows, under compaction
INGEST_FULL_DAYS = (1,)  # full size: one day (the nine-day batch is cut for the smoke's time)
# float64 drain vs float64 cold recompute, of the largest cofactor: the
# same sums in another order
INGEST_F64_RTOL = 1e-12
# warm closed form (float64 cofactors rescaled) vs cold (scaled traversal):
# the reference's own bound for the warm retrain
WARM_THETA_RTOL = 1e-8
# phase 8: bench_categorical's GLM leg and bench_polynomial's degrees
GLM_CONT, GLM_LABEL, GLM_RIDGE = ("transactions",), "onpromotion", 1e-3
GLM_CAT = CAT
GLM_GD_STEPS = 125  # the GD budget of the 18.6 M-row legs (250 until phase 11's legs, 500 until phase 12)
GLM_ORACLE_GD_STEPS = 100_000  # the reference's default cap
GLM_GD_PROFILE_STEPS = 128  # one chunk of predicated steps, profiled
GLM_PRED_ATOL = 5e-3  # GD vs IRLS predictions: the reference's own bound
# GD's float32 gradient vs the host's float64 one, of the magnitudes each
# entry sums: the categorical entries are float32 atomic sums of up to 340 k
# terms (√n·2⁻²⁴ ≈ 3.5e-5 a sum)
GD_GRAD_RTOL = 1e-3
PHASE8_KERNELS = ("segment_view", "segment_reduce")
# where the host seconds of IRLS and of a polynomial degree go (Timers):
# _combine holds the joins, _aggregate_out the group keys and np.unique
IRLS_STEPS = ("_hessian", "_grad_theta", "_family_stats")
POLY_STEPS = ("_encode", "_combine", "_extend", "_aggregate_out")
POLY_DEGREES = (1, 2, 3)
# full size: degree 3 alone (degrees 1 and 2 cut for the smoke's time; its
# degree-1 block is held to the quadratic engine)
POLY_FULL_DEGREES = (3,)
# polynomial aggregates are float64 on both sides: the card vs the CPU, and
# degree 1 vs the quadratic engine, are the same sums in another order
POLY_DEVICE_RTOL = 1e-12  # of the largest aggregate
POLY_QUAD_RTOL = 1e-10  # of the largest entry (tests/test_property.py's check)
POLY_FLAT_RTOL = 1e-7  # degree 2 vs the flat oracle, bench_polynomial's bound
FD_NLL_ATOL = 1e-8  # FD-reduced vs full penalized NLL (tests/test_fd.py)
FP64_FLOPS = HW.peak_flops_fp64  # H100 SXM, off the tensor cores, 34e12
# flash vs its plain version; three bounds must all hold.  Elementwise
# |a - b| <= tol·(1 + |b|): the reference's own flash tolerances
# (tests/test_kernels.py).  Those floors are as large as the outputs once an
# output row averages thousands of keys, so also, scaled to the outputs:
# each output row (one query, one head) ‖a_r - b_r‖ <= rtol·(‖b_r‖ +
# sqrt(D)·rms(b)), and the whole output ‖a - b‖ <= norm_rtol·‖b‖.  In bf16
# the kernel rounds p = exp(s - m) against its running max, the plain
# version the normalized softmax, each to 2^-9: rows differ by a few 1e-3
# relative, whatever the number of keys.  float32 sums in another order.
# PERF.md records the readings.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}
FLASH_ROW_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLASH_NORM_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# phase 7: smollm-135m behind the engine
LM_ARCH = "smollm-135m"
LM_SERVE = dict(slots=4, prefill_len=4_096, max_len=4_160)
# 4 requests (8 until phase 12 needed the smoke's time; phase 12 keeps 8)
LM_REQUESTS, LM_NEW, LM_PROMPT = 4, 32, (2_049, 4_096)
LOGIT_RTOL = 1e-4  # flash vs chunked_attention prefill, float32, of max |logit|
# bf16 forward logits, per position, in the plain bf16 path's own distance
# from the float32 model on the same weights: flash may be no farther from
# float32 than BF16_FAR_RATIO times that (both round p, the attention output
# and every other activation to bf16 alike; a wrong tile would put flash far
# off), and no farther from the plain path than BF16_NEAR_RATIO times it
# (two bf16 paths, each about that far from float32)
BF16_FAR_RATIO = 1.5
BF16_NEAR_RATIO = 2.0
NEAR_TIE = 1e-3  # a greedy pick this close to the top logit is a tie


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One progress line, stamped with the seconds since the start."""
    print(f"[{time.perf_counter() - _T0:8.1f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of one call of ``fn``, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def time_ms_back_to_back(fn, launches: int = 20, warmup: int = 2) -> float:
    """CUDA-event time of ``launches`` calls of ``fn`` queued back to back,
    over their count, in ms: the host's launch work overlaps the device's
    (as on the model's path), where ``time_ms`` counts it per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / launches


def profiled_ms(fn, calls: int = 20) -> float:
    """Device ms a call of ``fn``: every kernel, fill and copy the device
    ran for ``calls`` calls under the profiler, over their count."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return device_busy_ms(prof) / calls


def paired_ms(fns: dict, rounds: int = 6, reps: int = 50, launches: int = 200) -> dict:
    """{name: (ms a call, ms back to back)} for calls whose host work is
    their cost: each the median over ``rounds`` in which the calls take
    turns (the order reversed every other round), so that drift on the
    shared host falls on all alike."""
    got = {name: ([], []) for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[name][0].append(time_ms(fns[name], reps=reps))
            got[name][1].append(time_ms_back_to_back(fns[name], launches=launches))
    return {name: (statistics.median(a), statistics.median(b))
            for name, (a, b) in got.items()}


def max_err(got, expect) -> tuple:
    """(max |got − expect|, max |expect|) over a tuple of outputs."""
    err, scale = 0.0, 0.0
    for a, b in zip(got, expect):
        if a is None and b is None:
            continue
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a - b).abs().max()))
            scale = max(scale, float(b.abs().max()))
    return err, scale


def within(what, got, want, rtol, scale=None) -> float:
    """max |got − want| ≤ rtol · scale (scale: the largest |want|); the
    error over the scale, or raise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max()) if got.size else 0.0
    if not err <= rtol * scale:
        raise AssertionError(f"{what}: max_abs_err {err:.3e} > {rtol} · {scale:.3e}")
    return err / scale if scale else err


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels vs plain versions ---------------------------------------

def library_gram(x) -> torch.Tensor:
    """The one PyTorch call computing gram's function (cuBLAS; timed as
    ``library_ms``, never called by the port)."""
    return x.T @ x


def library_segment_sum(data, seg64, g: int) -> torch.Tensor:
    """The one PyTorch call computing segment_reduce's function (timed as
    ``library_ms``; the port never calls it)."""
    zeros = torch.zeros(g, data.shape[1], dtype=data.dtype, device=data.device)
    return zeros.index_add_(0, seg64, data)


def view_inputs(m: int, k: int, g: int, gen: torch.Generator):
    """Random rows and random ids: a random permutation where G = M (one row
    per group), else uniform ids — the worst case, not the main path's
    order (phase 3 times the main path's own ids)."""
    dev = "cuda"
    c = torch.rand(m, device=dev, generator=gen) + 0.5
    x = torch.randn(m, device=dev, generator=gen)
    l = torch.randn(m, k, device=dev, generator=gen)
    q = torch.randn(m, k, k, device=dev, generator=gen)
    if g == m:
        seg = torch.randperm(m, device=dev, generator=gen)
    else:
        seg = torch.randint(0, g, (m,), device=dev, generator=gen)
    return c, x, l, q, seg.to(torch.int32)


def plan_check(sv) -> None:
    """segment_view's path choice and padded layout: the Python mirror
    (``kernels/segment_view.py:plan``, which the CPU tests check) must equal
    the library's own for every payload, degree and width, with and
    without each group's row."""
    n = 0
    for payload, degrees in (("view", (2,)), ("view1", (1,)), ("blocks", (0, 1, 2))):
        for degree in degrees:
            for k in (0, 1, 2, 3, 4, 5, 40):
                for one_row in (False, True):
                    args = (payload, k, degree, one_row)
                    got, want = sv.kernel_plan(*args), sv.plan(*args)
                    if got != want:
                        raise AssertionError(f"segment_view plan {args}: {got} != {want}")
                    n += 1
    log(f"{'segment_view':15s} plans of {n} calls as mirrored (path, width, padded)")


#: the id columns' group counts gram_plan_check sweeps (the main path's
#: among them: item; store and item; sixteen small bands)
PLAN_GROUPS = ([1], [54], [4_100], [54, 4_100], [17_200], [90_936],
               [96] * 8 + [48] * 8, [256, 257], [8] * 8)


def gram_plan_check(sg) -> None:
    """The grouped Grams' launch plan (CTAs a tile, entries a CTA, stages, rows,
    copies of the hot bands, groups a launch holds, chunks, shared memory):
    the Python mirror (``kernels/segment_gram.py:plan``, which the CPU tests
    check) must equal the library's own at every width, band list and type
    below."""
    n = 0
    for k in (1, 2, 3, 4, 5, 6, 7, 8, 9, 40, 130, 221, 313):
        for groups in PLAN_GROUPS:
            for elem in (4, 8):
                got, want = sg.kernel_plan(k, groups, elem), sg.plan(k, groups, elem)
                if got != want:
                    raise AssertionError(
                        f"segment_gram plan {(k, groups[:4], elem)}: {got} != {want}")
                n += 1
    log(f"{'segment_gram':15s} plans of {n} shapes as mirrored; K 6, G 4,100: "
        f"{sg.plan(6, 4_100, 4)}; K 4, G 54 + 4,100: {sg.plan(4, [54, 4_100], 4)}")


# (node, rows M, features k, groups G) of the main path's traversal
FEATURE_NODES = [
    ("onpromotion", N_SALES, 0, N_SALES),
    ("unit_sales", N_SALES, 1, N_SALES),
    ("item_nbr", N_SALES, 2, 90_936),
    ("store_nbr", 90_936, 3, 1_684),
    ("date", 1_684, 4, 1),
]
REGROUP_NODES = [
    ("transactions", 90_936, 90_936),
    ("perishable", 4_100, 4_100),
    ("dcoilwtico", 1_684, 1_684),
    ("cluster", 54, 54),
]
TIMED_VIEW_NODE = "item_nbr"
TIMED_REGROUP_NODE = "transactions"


def kernel_phase(ref, sv, sg, mom, kops, kflash) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}

    def check(name, node, got, expect):
        err, scale = max_err(got, expect)
        tol = KERNEL_RTOL * max(1.0, scale)
        log(f"{name:15s} {node:13s} max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"{name} at {node}: error {err} > {tol}")
        return err, tol

    plan_check(sv)
    gram_plan_check(sg)
    log("segment_view family at the main path's sizes with random ids (the worst "
        "case; phase 3 times the main path's own ids)")
    for degree, name in ((2, "segment_view"), (1, "segment_view1")):
        for node, m, k, g in FEATURE_NODES:
            c, x, l, q, seg = view_inputs(m, k, g, gen)
            qq = q if degree == 2 else None
            args = (c, x, l, qq, seg, g)
            kern = functools.partial(sv.segment_view, *args, degree=degree)
            plain = functools.partial(ref.segment_view_ref, *args, degree=degree)
            want = plain()
            err, tol = check(name, node, kern(), want)
            if g == m:  # path A: each group's row passed
                order = torch.argsort(seg).to(torch.int32)
                err = max(err, check(name, f"{node} order", sv.segment_view(
                    *args, degree=degree, order=order), want)[0])
            del want
            if node != TIMED_VIEW_NODE:
                continue
            s = 4
            w_out = 1 + (k + 1) + ((k + 1) ** 2 if degree == 2 else 0)
            w_in = 2 + k + (k * k if degree == 2 else 0)
            nbytes = m * (w_in * s + 4) + g * w_out * s
            flops = m * ((5 + 3 * k + k * k) if degree == 2 else (k + 3))
            b, by = bound_ms(nbytes, flops)
            rows[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/segment_view.cu",
                replaces=(
                    "src/repro/kernels/segment_view.py:97 segment_view_kernel_call"
                    if degree == 2 else
                    "src/repro/kernels/segment_view.py:161 segment_view1_kernel_call"
                ),
                shape=dict(node=node, rows=m, k=k, groups=g, degree=degree,
                           ids="random"),
                max_abs_err=err, tol=tol,
                ms=time_ms(kern), plain_ms=time_ms(plain),
                bound_ms=b, bound_by=by, library_ms=None,
            )
    for node, m, g in REGROUP_NODES:
        c, _, l, q, seg = view_inputs(m, 0, g, gen)
        order = torch.argsort(seg).to(torch.int32)  # path A, as on the main path
        kern = functools.partial(sv.segment_blocks, c, l, q, seg, g, degree=2,
                                 order=order)
        plain = functools.partial(ref.segment_blocks_ref, c, l, q, seg, g, degree=2)
        err, tol = check("segment_reduce", node, kern(), plain())
        check("segment_reduce", f"{node} no order", sv.segment_blocks(
            c, l, q, seg, g, degree=2), plain())
        if node == TIMED_REGROUP_NODE:
            lib = functools.partial(
                library_segment_sum, c[:, None].contiguous(), seg.long(), g
            )
            b, by = bound_ms(m * 8 + g * 4, m)
            # tens of µs of host work a call: kernel and library in turns
            t = paired_ms({"kernel": kern, "library": lib})
            rows["segment_reduce"] = dict(
                name="segment_reduce", route="cuda",
                source="src/repro_torch/csrc/segment_view.cu",
                replaces="src/repro/kernels/segment_view.py:212 segment_reduce_kernel_call",
                shape=dict(node=node, rows=m, width=1, groups=g, ids="random permutation"),
                max_abs_err=err, tol=tol,
                ms=t["kernel"][0], plain_ms=time_ms(plain),
                bound_ms=b, bound_by=by, library_ms=t["library"][0],
                ms_back_to_back=t["kernel"][1], library_ms_back_to_back=t["library"][1],
            )
    # both paths of the blocks kernel with random ids, at every degree, in
    # float32 and float64 (the main path's regroups all take A)
    for what, m, k, g in (("one_row", 90_936, 3, 90_936), ("atomic", 90_936, 3, 54),
                          ("atomic", 1_000_000, 2, 90_936)):
        c, _, l, q, seg = view_inputs(m, k, g, gen)
        order = torch.argsort(seg).to(torch.int32) if what == "one_row" else None
        for degree in (0, 1, 2):
            label = f"path {what} G {g} deg {degree}"
            if sv.plan("blocks", k, degree, order is not None)["path"] != what:
                raise AssertionError(f"segment_reduce {label}: planned another path")
            check("segment_reduce", label,
                  sv.segment_blocks(c, l, q, seg, g, degree=degree, order=order),
                  ref.segment_blocks_ref(c, l, q, seg, g, degree=degree))
            c64, l64, q64 = c.double(), l.double(), q.double()
            err, scale = max_err(
                sv.segment_blocks(c64, l64, q64, seg, g, degree=degree, order=order),
                ref.segment_blocks_ref(c64, l64, q64, seg, g, degree=degree))
            log(f"{'segment_reduce':15s} float64 {label} max_abs_err={err:.3e}")
            if not err <= F64_RTOL * max(1.0, scale):
                raise AssertionError(f"segment_reduce float64 {label}: error {err}")
    rows.update(gram_family(ref, kops, sg, gen, check))
    rows["flash"] = flash_rows(ref, kops, kflash, gen)
    rows["flash_bwd"] = flash_bwd_rows(ref, kflash, gen)
    # the date column: SalesF + Transactions + Oil rows
    m = N_SALES + 90_936 + 1_684
    x = torch.randint(0, 1_684, (m,), device="cuda", generator=gen).float()
    kern = functools.partial(mom.moments, x)
    plain = functools.partial(ref.moments_ref, x)
    (ks, kmx, kn), (ps, pmx, pn) = kern(), plain()
    if kn != pn or float(kmx) != float(pmx):
        raise AssertionError(f"moments: count/max {kn},{float(kmx)} vs {pn},{float(pmx)}")
    err = abs(float(ks) - float(ps))
    tol = KERNEL_RTOL * abs(float(ps))
    log(f"{'moments':15s} {'date column':13s} max_abs_err={err:.3e} tol={tol:.3e}")
    if not err <= tol:
        raise AssertionError(f"moments: sum error {err} > {tol}")
    x64 = x.double()
    (ks64, kmx64, _), (ps64, pmx64, _) = mom.moments(x64), ref.moments_ref(x64)
    err64 = abs(float(ks64) - float(ps64))
    log(f"{'moments':15s} {'date float64':13s} max_abs_err={err64:.3e}")
    if not (err64 <= F64_RTOL * abs(float(ps64)) and float(kmx64) == float(pmx64)):
        raise AssertionError(f"moments float64: sum error {err64}")
    del x64
    b, by = bound_ms(m * 4 + 8, 2 * m)
    rows["moments"] = dict(
        name="moments", route="cuda",
        source="src/repro_torch/csrc/moments.cu",
        replaces="src/repro/kernels/moments.py:41 moments_kernel_call",
        shape=dict(column="date", rows=m),
        max_abs_err=err, tol=tol, max_abs_err_f64=err64,
        ms=time_ms(kern), plain_ms=time_ms(plain),
        bound_ms=b, bound_by=by, library_ms=None,
        ms_back_to_back=time_ms_back_to_back(kern), device_ms_profiled=profiled_ms(kern),
    )
    for r in rows.values():
        log(
            f"{r['name']:15s} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} library_ms={r['library_ms']}"
        )
    return rows


def gram_family(ref, kops, sg, gen, check) -> dict:
    """gram, segment_gram and multi_segment_gram at the shapes phase 4 gives
    them: the noPre design matrix (five paper columns), the grouped Gram by
    item over u = [1, five columns], and the categorical leg's u = [1, date,
    onpromotion, unit_sales] grouped by store and by item.  Row order is
    the join's, in which ids are unordered."""
    dev, m, s = "cuda", N_SALES, 4
    rows = {}
    x = torch.randn(m, 5, device=dev, generator=gen)
    kern = functools.partial(kops.gram, x)
    plain = functools.partial(ref.gram_ref, x)
    err, tol = check("gram", "noPre K=5", (kern(),), (plain(),))
    b, by = bound_ms(m * 5 * s + 25 * s, m * 5 * 6)
    mw, kw = GRAM_WIDE
    xw = torch.randn(mw, kw, device=dev, generator=gen)
    errw, tolw = check("gram", f"K={kw}", (kops.gram(xw),), (ref.gram_ref(xw),))
    bw, byw = bound_ms(mw * kw * s + kw * kw * s, mw * kw * (kw + 1))
    rows["gram"] = dict(
        name="gram", route="cuda", source="src/repro_torch/csrc/gram.cu",
        replaces="src/repro/kernels/gram.py:56 gram_kernel_call",
        shape=dict(rows=m, k=5), max_abs_err=err, tol=tol,
        ms=time_ms(kern), plain_ms=time_ms(plain),
        bound_ms=b, bound_by=by, library_ms=time_ms(functools.partial(library_gram, x)),
        also=dict(
            rows=mw, k=kw, max_abs_err=errw, tol=tolw,
            ms=time_ms(functools.partial(kops.gram, xw)),
            plain_ms=time_ms(functools.partial(ref.gram_ref, xw)),
            bound_ms=bw, bound_by=byw,
            library_ms=time_ms(functools.partial(library_gram, xw)),
        ),
    )
    del xw

    g_item, g_store = 4_100, 54
    u = torch.cat([torch.ones(m, 1, device=dev), torch.rand(m, 5, device=dev, generator=gen)], 1)
    item = torch.randint(0, g_item, (m,), device=dev, generator=gen, dtype=torch.int32)
    kern = functools.partial(kops.segment_gram, u, item, g_item)
    plain = functools.partial(ref.segment_gram_ref, u, item, g_item)
    want = plain()
    kops.reset_launch_counts()
    got = kern()
    n_launch = kops.launch_counts()["segment_gram"]
    if n_launch != 1:
        raise AssertionError(f"segment_gram at K 6, G {g_item}: {n_launch} launches, not one")
    err, tol = check("segment_gram", "item K=6", (got,), (want,))
    del got
    budget = 32 * 1024  # forces 11 chunks of at most 390 groups
    errc, tolc = check("segment_gram", "item chunked",
                       (kops.segment_gram(u, item, g_item, smem_budget=budget),), (want,))
    del want
    other = grouped_gram_shapes(ref, kops, sg, gen, check)
    b, by = bound_ms(m * 6 * s + m * 4 + g_item * 36 * s, m * 21 * 2)
    rows["segment_gram"] = dict(
        name="segment_gram", route="cuda",
        source="src/repro_torch/csrc/segment_gram.cu",
        replaces="src/repro/kernels/segment_gram.py:65 segment_gram_kernel_call",
        shape=dict(rows=m, k=6, groups=g_item), max_abs_err=max(err, errc), tol=tol,
        ms=time_ms(kern), plain_ms=time_ms(plain, reps=3),
        bound_ms=b, bound_by=by, library_ms=None,
        ms_back_to_back=time_ms_back_to_back(kern), device_ms_profiled=profiled_ms(kern),
        launches_per_call=n_launch, plan=sg.plan(6, g_item, 4), also=other,
    )

    u4 = u[:, :4].contiguous()
    store = torch.randint(0, g_store, (m,), device=dev, generator=gen, dtype=torch.int32)
    segs = torch.stack([store, item], 1).contiguous()
    groups = [g_store, g_item]
    kern = functools.partial(kops.multi_segment_gram, u4, segs, groups)
    plain = functools.partial(ref.multi_segment_gram_ref, u4, segs, groups)
    want = plain()
    err, tol = check("multi_seg_gram", "store,item K=4", kern(), want)
    errf, _ = check("multi_seg_gram", "fallback",
                    kops.multi_segment_gram(u4, segs, groups, smem_budget=budget), want)
    del want
    b, by = bound_ms(m * 4 * s + m * 2 * 4 + (g_store + g_item) * 16 * s, m * 10 * 2 * 2)
    rows["multi_segment_gram"] = dict(
        name="multi_segment_gram", route="cuda",
        source="src/repro_torch/csrc/segment_gram.cu",
        replaces="src/repro/kernels/segment_gram.py:138 multi_segment_gram_kernel_call",
        shape=dict(rows=m, k=4, groups=groups), max_abs_err=max(err, errf), tol=tol,
        ms=time_ms(kern), plain_ms=time_ms(plain, reps=3),
        bound_ms=b, bound_by=by, library_ms=None,
        ms_back_to_back=time_ms_back_to_back(kern), device_ms_profiled=profiled_ms(kern),
        plan=sg.plan(4, groups, 4),
    )
    return rows


def grouped_gram_shapes(ref, kops, sg, gen, check) -> list:
    """segment_gram off the main path's shape, each against its plain
    version: chunked by the launch plan at K = 40, G = 4,000 (the reference
    test's shape, 9 launches); float64 at K = 6, G = 4,100 (a split of 5);
    one group of K = 313 (the widest, rows read from the stage)."""
    out = []
    for what, m, k, g, dt in (("K 40 chunked by the plan", 200_000, 40, 4_000, torch.float32),
                              ("K 6 float64", 1_000_000, 6, 4_100, torch.float64),
                              ("K 313 one group", 20_000, 313, 1, torch.float32)):
        x = torch.randn(m, k, device="cuda", generator=gen, dtype=dt)
        seg = torch.randint(0, g, (m,), device="cuda", generator=gen, dtype=torch.int32)
        kops.reset_launch_counts()
        got = kops.segment_gram(x, seg, g)
        n = kops.launch_counts()["segment_gram"]
        want = ref.segment_gram_ref(x, seg, g)
        if dt == torch.float64:
            err, scale = max_err((got,), (want,))
            log(f"{'segment_gram':15s} {what:13s} max_abs_err={err:.3e}")
            if not err <= F64_RTOL * max(1.0, scale):
                raise AssertionError(f"segment_gram {what}: error {err}")
        else:
            err, _ = check("segment_gram", what, (got,), (want,))
        plan = sg.plan(k, g, x.element_size())
        if n != plan["chunks"]:
            raise AssertionError(f"segment_gram {what}: {n} launches, plan {plan}")
        out.append(dict(what=what, rows=m, k=k, groups=g, dtype=str(dt).split(".")[-1],
                        max_abs_err=err, launches=n, plan=plan))
        del x, seg, got, want
    return out


BF16, F32 = torch.bfloat16, torch.float32
# (what, B, Sq, Sk, H, KH, D, causal, window, kv_len, dtype, timed), kv_len
# None meaning Sk; the first row is the serving path's prefill (the JSON
# row), the others ride in "also"
# the flash backward is timed at the training shapes and whisper's: smollm-
# 135m's, qwen2-moe-a2.7b's (16 heads of 128, as olmo-1b's), llava's and
# whisper-medium's cross and self attention (every shape until phase 11's
# legs needed the smoke's time; all are checked)
FLASH_BWD_TIMED = ("smollm-135m prefill", "olmo-1b heads", "llava-next-mistral-7b prefill",
                   "whisper-medium cross attention", "whisper-medium self attention")
FLASH_SHAPES = [
    ("smollm-135m prefill", 1, 4096, 4096, 9, 3, 64, True, None, None, BF16, True),
    ("smollm-135m prefill", 1, 4096, 4096, 9, 3, 64, True, None, None, F32, True),
    ("olmo-1b heads", 1, 4096, 4096, 16, 16, 128, True, None, None, BF16, True),
    ("olmo-1b heads", 1, 4096, 4096, 16, 16, 128, True, None, None, F32, True),
    ("mixtral heads, window 1024", 1, 4096, 4096, 32, 8, 128, True, 1024, None, BF16, True),
    ("mixtral heads, window 1024", 1, 4096, 4096, 32, 8, 128, True, 1024, None, F32, False),
    ("non-causal ragged", 2, 1000, 3001, 8, 2, 64, False, None, None, BF16, True),
    ("non-causal ragged", 2, 1000, 3001, 8, 2, 64, False, None, None, F32, True),
    ("non-causal, kv_len 2,777 of 3,001", 2, 1000, 3001, 8, 2, 64, False, None, 2777, BF16, True),
    ("non-causal, kv_len 2,777 of 3,001", 2, 1000, 3001, 8, 2, 64, False, None, 2777, F32, False),
    ("non-causal, kv_len 0", 2, 1000, 3001, 8, 2, 64, False, None, 0, BF16, False),
    ("non-causal, kv_len 0", 2, 1000, 3001, 8, 2, 64, False, None, 0, F32, False),
    ("causal 1,111 tokens, head dim 128", 1, 1111, 1111, 4, 1, 128, True, None, None, BF16, True),
    ("causal 1,111 tokens, head dim 128", 1, 1111, 1111, 4, 1, 128, True, None, None, F32, False),
    ("head dim 8", 1, 300, 300, 2, 1, 8, True, None, None, BF16, False),
    ("head dim 40, window 50", 1, 300, 300, 2, 1, 40, True, 50, None, BF16, False),
    ("head dim 40, window 50", 1, 300, 300, 2, 1, 40, True, 50, None, F32, False),
    ("head dim 256", 1, 333, 333, 2, 2, 256, True, None, None, BF16, False),
    ("head dim 256", 1, 333, 333, 2, 2, 256, True, None, None, F32, False),
    # phase 13's model shapes: whisper's cross attention (more queries than
    # keys) and decoder self attention, llava's prefill
    ("whisper-medium cross attention", 1, 4096, 1500, 16, 16, 64, False, None, None, BF16, True),
    ("whisper-medium cross attention", 1, 4096, 1500, 16, 16, 64, False, None, None, F32, True),
    ("whisper-medium self attention", 1, 4096, 4096, 16, 16, 64, True, None, None, BF16, True),
    ("llava-next-mistral-7b prefill", 1, 4096, 4096, 32, 8, 128, True, None, None, BF16, True),
]


def visible_pairs(sq: int, kv_len: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave visible: the work this input needs."""
    i = np.arange(sq)
    hi = np.minimum(i + 1, kv_len) if causal else np.full(sq, kv_len)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def library_attention(q, k, v, causal, window, kv_len):
    """The one PyTorch call computing flash's function, on [B, H, S, D]
    copies of q and of the first kv_len keys made beforehand (timed as
    ``library_ms``; the port never calls it)."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k[:, :kv_len], v[:, :kv_len]))
    if window is None:
        return functools.partial(
            F.scaled_dot_product_attention, qt, kt, vt, is_causal=causal, enable_gqa=True
        )
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(kv_len, device=q.device)[None, :]
    mask = (j > i - window) & ((j <= i) if causal else True)
    return functools.partial(
        F.scaled_dot_product_attention, qt, kt, vt, attn_mask=mask, enable_gqa=True
    )


def flash_rows(ref, kops, kflash, gen) -> dict:
    """flash against its plain version at every shape of FLASH_SHAPES, timed
    where marked; returns the JSON row of the first shape, the others in
    ``also``.  First the bf16 and the float32 instantiations the library
    reports for every head dim must be the ones ``kernels/flash.py``
    mirrors (and the CPU tests check); at each float32 shape its workspace
    too."""
    for d in range(8, 257, 8):
        got, want = kflash.kernel_bf16_geometry(d), kflash.bf16_geometry(d)
        if got != want:
            raise AssertionError(f"flash bf16 geometry at head dim {d}: {got} != {want}")
    log(f"{'flash':15s} bf16 geometry of head dims 8-256 as mirrored: "
        f"{sorted({tuple(kflash.bf16_geometry(d).values()) for d in (16, 32, 64, 128, 256)})}")
    for d in range(8, 257, 8):
        got, want = kflash.kernel_f32_geometry(d), kflash.f32_geometry(d)
        if got != want:
            raise AssertionError(f"flash float32 geometry at head dim {d}: {got} != {want}")
    log(f"{'flash':15s} float32 geometry of head dims 8-256 as mirrored: "
        f"{sorted({tuple(kflash.f32_geometry(d).values()) for d in (16, 32, 64, 128, 256)})}")
    out = [flash_case(ref, kops, gen, shape) for shape in FLASH_SHAPES]
    main = out[0]
    return dict(
        name="flash", route="cuda", source="src/repro_torch/csrc/flash.cu",
        replaces="src/repro/kernels/flash.py:106 flash_kernel_call",
        **main, also=out[1:],
    )


def flash_work(b, sq, kv_len, h, kh, d, causal, window, size: int) -> tuple:
    """(bytes, operations) of one forward: q, k and v read and the output
    written once (the keys up to ``kv_len``), 4·D operations a visible pair."""
    nbytes = 2 * b * sq * h * d * size + 2 * b * kv_len * kh * d * size
    return nbytes, 4 * d * h * b * visible_pairs(sq, kv_len, causal, window)


def flash_bound(nbytes: float, flops: float, dt, tf32: bool) -> dict:
    """The bound of one flash call (forward or backward) as the kernel runs
    it: bf16 products on the tensor cores; float32 where the kernel runs
    3xTF32 (``tf32``: its geometry's ``wgmma``) three times the operations
    at TF32's rate, with the scalar bound (float32's rate, off the tensor
    cores) beside it as ``scalar_bound_ms``; float32 on the scalar kernels
    (head dim 256) the scalar bound."""
    if dt == BF16:
        bnd, by = bound_ms(nbytes, flops, BF16_FLOPS)
        return dict(bound_ms=bnd, bound_by=by)
    scalar, scalar_by = bound_ms(nbytes, flops, FP32_FLOPS)
    if not tf32:
        return dict(bound_ms=scalar, bound_by=scalar_by)
    bnd, by = bound_ms(nbytes, 3 * flops, TF32_FLOPS)
    return dict(bound_ms=bnd, bound_by=by, scalar_bound_ms=scalar, scalar_bound_by=scalar_by)


def scalar_bound_note(row: dict) -> str:
    """A timed float32 row's share of its scalar bound, for the log (set in
    ``row`` as ``pct_of_scalar_bound``); empty where it has none."""
    if "scalar_bound_ms" not in row:
        return ""
    row["pct_of_scalar_bound"] = 100 * row["scalar_bound_ms"] / row["ms"]
    return (f" scalar_bound_ms={row['scalar_bound_ms']:.4f} ({row['scalar_bound_by']}, "
            f"{row['pct_of_scalar_bound']:.1f} %)")


def flash_case(ref, kops, gen, shape) -> dict:
    """flash against its plain version at one ``FLASH_SHAPES`` entry, timed
    (per call, back to back, plain, bound, ``scaled_dot_product_attention``)
    where marked; a float32 row at head dims up to 128 is bound by 3xTF32 on
    the tensor cores (:func:`flash_bound`), its scalar bound beside it; its
    JSON row."""
    from repro_torch.kernels import flash as kflash
    what, b, sq, sk, h, kh, d, causal, window, kv_len, dt, timed = shape
    kv_len = sk if kv_len is None else kv_len
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, sk, kh, d, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, sk, kh, d, device="cuda", generator=gen).to(dt)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    kern = functools.partial(kops.flash_attention, q, k, v, **kw)
    plain = functools.partial(ref.flash_attention_ref, q, k, v, **kw)
    got, want = kern().float(), plain().float()
    tol, row_rtol, norm_rtol = FLASH_TOL[dt], FLASH_ROW_RTOL[dt], FLASH_NORM_RTOL[dt]
    name = f"{what} {str(dt).split('.')[-1]}"
    if dt == F32:  # the kernel's workspace, as the library sizes it, against the mirror
        ws = (kflash.kernel_fwd_f32_workspace(b, sq, sk, h, kh, d),
              kflash.fwd_f32_workspace(b, sq, sk, h, kh, d))
        if ws[0] != ws[1]:
            raise AssertionError(f"flash float32 workspace at {name}: {ws[0]} != {ws[1]} floats")
    diff = got - want
    err = float(diff.abs().max())
    if kv_len == 0:  # no row sees a key: both must be exact zeros
        if bool(got.any()) or bool(want.any()):
            raise AssertionError(f"flash at {name}: output not exactly 0")
        row_err = norm_err = 0.0
    else:
        floor = d**0.5 * float(want.square().mean().sqrt())
        row_err = float((diff.norm(dim=-1) / (want.norm(dim=-1) + floor)).max())
        norm_err = float(diff.norm() / want.norm())
    ok = (bool((diff.abs() <= tol * (1 + want.abs())).all()) and row_err <= row_rtol
          and norm_err <= norm_rtol and bool(torch.isfinite(got).all()))
    log(f"{'flash':15s} {name:34s} max_abs_err={err:.3e} tol={tol:.0e} "
        f"row_err={row_err:.3e} rtol={row_rtol:.0e} norm_err={norm_err:.3e} "
        f"rtol={norm_rtol:.0e}")
    if not ok:
        raise AssertionError(
            f"flash at {name}: error {err}, row {row_err}, norm {norm_err} over "
            f"tolerance {tol} / {row_rtol} / {norm_rtol}")
    row = dict(
        shape=dict(what=what, batch=b, sq=sq, sk=sk, heads=h, kv_heads=kh,
                   head_dim=d, causal=causal, window=window, kv_len=kv_len,
                   dtype=str(dt).split(".")[-1]),
        max_abs_err=err, tol=tol, row_err=row_err, row_rtol=row_rtol,
        norm_err=norm_err, norm_rtol=norm_rtol,
    )
    if timed:
        nbytes, flops = flash_work(b, sq, kv_len, h, kh, d, causal, window, q.element_size())
        lib = library_attention(q, k, v, causal, window, kv_len)
        row.update(
            ms=time_ms(kern), plain_ms=time_ms(plain),
            **flash_bound(nbytes, flops, dt, kflash.f32_geometry(d)["wgmma"] == 1),
            library_ms=time_ms(lib), ms_back_to_back=time_ms_back_to_back(kern),
            library_ms_back_to_back=time_ms_back_to_back(lib),
        )
        row["pct_of_bound"] = 100 * row["bound_ms"] / row["ms"]
        log(f"{'flash':15s} {name:34s} ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, {row['pct_of_bound']:.1f} %)"
            f"{scalar_bound_note(row)} "
            f"library_ms={row['library_ms']:.4f}; back to back "
            f"{row['ms_back_to_back']:.4f} vs library {row['library_ms_back_to_back']:.4f}")
    del q, k, v, got, want, diff
    return row


def library_attention_bwd(q, k, v, dout, causal, window, kv_len):
    """The backward of ``scaled_dot_product_attention`` (as
    ``library_attention`` calls it) on [B, H, S, D] copies of the same
    inputs, as one call of ``torch.autograd.grad`` (timed as the backward's
    ``library_ms``; the port never calls it)."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k[:, :kv_len], v[:, :kv_len]))
    kw = dict(is_causal=causal)
    if window is not None:
        i = torch.arange(q.shape[1], device=q.device)[:, None]
        j = torch.arange(kv_len, device=q.device)[None, :]
        kw = dict(attn_mask=(j > i - window) & ((j <= i) if causal else True))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
    gt = dout.transpose(1, 2).contiguous()
    return functools.partial(torch.autograd.grad, out, (qt, kt, vt), gt, retain_graph=True)


def flash_bwd_rows(ref, kflash, gen) -> dict:
    """The flash backward (``flash_bwd``) against ``ref.flash_backward_ref``
    at every shape of FLASH_SHAPES, from the forward kernel's own output and
    row log-sum-exp; the JSON row of the first shape, the others in
    ``also``.  First the bf16 backward's instantiation the library reports
    for every head dim must be the one ``kernels/flash.py`` mirrors
    (``bwd_geometry``, which the CPU tests check)."""
    for dt in (BF16, F32):
        for d in range(8, 257, 8):
            got, want = kflash.kernel_bwd_geometry(d, dt), kflash.bwd_geometry(d, dt)
            if got != want:
                raise AssertionError(f"flash_bwd {dt} geometry at head dim {d}: {got} != {want}")
        log(f"{'flash_bwd':15s} {str(dt).split('.')[-1]} geometry of head dims 8-256 as "
            f"mirrored: {sorted({tuple(kflash.bwd_geometry(d, dt).values()) for d in (16, 32, 64, 128, 256)})}")
    for shape in FLASH_SHAPES:
        _, b, sq, sk, h, kh, d, *_, dt, _ = shape
        got, want = (kflash.kernel_bwd_workspace(dt, b, sq, sk, h, kh, d),
                     kflash.bwd_workspace(dt, b, sq, sk, h, kh, d))
        if got != want:
            raise AssertionError(f"flash_bwd workspace at {shape}: {got} != {want} floats")
    out = [flash_bwd_case(ref, kflash, gen, shape) for shape in FLASH_SHAPES]
    return dict(
        name="flash_bwd", route="cuda", source="src/repro_torch/csrc/flash_bwd.cu",
        replaces=("none: the gradient of src/repro/kernels/flash.py:106 flash_kernel_call, "
                  "which has no backward (the reference differentiates chunked_attention, "
                  "src/repro/models/attention.py:97)"),
        **out[0], also=out[1:],
    )


def flash_bwd_case(ref, kflash, gen, shape) -> dict:
    """dq, dk, dv of the backward kernel against its plain version at one
    ``FLASH_SHAPES`` entry (each within flash's three bounds: elementwise
    FLASH_TOL, per row FLASH_ROW_RTOL, whole FLASH_NORM_RTOL; where no row
    sees a key, exact zeros), timed at FLASH_BWD_TIMED beside its bound (2.5
    times the forward's operations: five products for two; the bytes of q,
    k, v, o, dO, dq, dk, dv, L and Δ) and the backward of
    ``scaled_dot_product_attention``."""
    what, b, sq, sk, h, kh, d, causal, window, kv_len, dt, timed = shape
    timed = timed and what in FLASH_BWD_TIMED
    kv_len = sk if kv_len is None else kv_len
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, sk, kh, d, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, sk, kh, d, device="cuda", generator=gen).to(dt)
    dout = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dt)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    o, lse = kflash.flash_attention(q, k, v, with_lse=True, **kw)
    kern = functools.partial(kflash.flash_backward, q, k, v, o, dout, lse, **kw)
    plain = functools.partial(ref.flash_backward_ref, q, k, v, o, dout, **kw)
    got, want = kern(), plain()
    tol, row_rtol, norm_rtol = FLASH_TOL[dt], FLASH_ROW_RTOL[dt], FLASH_NORM_RTOL[dt]
    name = f"{what} {str(dt).split('.')[-1]}"
    errs = []  # (max |Δ|, worst row, whole) of dq, dk, dv
    for part, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.float(), w.float()
        diff = a - w
        if kv_len == 0:  # no row sees a key: exact zeros
            if bool(a.any()) or bool(w.any()):
                raise AssertionError(f"flash_bwd at {name}: {part} not exactly 0")
            row_err = norm_err = 0.0
        else:
            # a row is one query's (dq) or one key's (dk, dv) vector of one head
            floor = d**0.5 * float(w.square().mean().sqrt())
            row_err = float((diff.norm(dim=-1) / (w.norm(dim=-1) + floor)).max())
            norm_err = float(diff.norm() / w.norm())
        errs.append((float(diff.abs().max()), row_err, norm_err))
        if not (bool(torch.isfinite(a).all()) and bool((diff.abs() <= tol * (1 + w.abs())).all())
                and row_err <= row_rtol and norm_err <= norm_rtol):
            raise AssertionError(
                f"flash_bwd at {name}: {part} error {errs[-1][0]}, row {row_err}, norm "
                f"{norm_err} over tolerance {tol} / {row_rtol} / {norm_rtol}")
    err, row_err, norm_err = (max(e[i] for e in errs) for i in range(3))
    log(f"{'flash_bwd':15s} {name:34s} max_abs_err={err:.3e} tol={tol:.0e} "
        f"row_err={row_err:.3e} rtol={row_rtol:.0e} norm_err={norm_err:.3e} "
        f"rtol={norm_rtol:.0e} (dq, dk, dv: "
        + "; ".join(f"{e:.2e} {r:.2e} {n:.2e}" for e, r, n in errs) + ")")
    row = dict(
        shape=dict(what=what, batch=b, sq=sq, sk=sk, heads=h, kv_heads=kh,
                   head_dim=d, causal=causal, window=window, kv_len=kv_len,
                   dtype=str(dt).split(".")[-1]),
        max_abs_err=err, tol=tol, row_err=row_err, row_rtol=row_rtol,
        norm_err=norm_err, norm_rtol=norm_rtol,
    )
    if timed:
        s = q.element_size()
        nbytes = (4 * b * sq * h * d * s + 4 * b * kv_len * kh * d * s
                  + 2 * b * h * sq * 4)
        flops = 2.5 * 4 * d * h * b * visible_pairs(sq, kv_len, causal, window)
        lib = library_attention_bwd(q, k, v, dout, causal, window, kv_len)
        row.update(ms=time_ms(kern), plain_ms=time_ms(plain, reps=3, warmup=1),
                   **flash_bound(nbytes, flops, dt, kflash.bwd_geometry(d, dt)["wgmma"] == 1),
                   library_ms=time_ms(lib),
                   ms_back_to_back=time_ms_back_to_back(kern, launches=5))
        row["pct_of_bound"] = 100 * row["bound_ms"] / row["ms"]
        log(f"{'flash_bwd':15s} {name:34s} ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, {row['pct_of_bound']:.2f} %)"
            f"{scalar_bound_note(row)} "
            f"library_ms={row['library_ms']:.4f} (SDPA backward); back to back "
            f"{row['ms_back_to_back']:.4f}")
        del lib
    del q, k, v, dout, o, lse, got, want
    return row


# -- phase 3: the main path ---------------------------------------------------

class Timers:
    """Wall seconds spent in callables, by patching the names their callers
    look up: ``targets`` are (owner, names) pairs, an owner a module or a
    class.  A callable that runs inside another timed one counts in both."""

    def __init__(self, *targets):
        self.targets = targets
        self.seconds = {n: 0.0 for _, names in targets for n in names}

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t0
        return timed

    def __enter__(self):
        self.saved = [(owner, n, getattr(owner, n)) for owner, names in self.targets
                      for n in names]
        for owner, n, fn in self.saved:
            setattr(owner, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for owner, n, fn in self.saved:
            setattr(owner, n, fn)


class Capture:
    """The arguments of every call of ``names`` (by default the engine's
    ``segment_view`` and ``segment_blocks``), by patching the names the
    engine module calls (as Timers does), from whichever thread calls them;
    with ``results``, each call's outputs too (``outputs``, in call order).
    The tensors are kept, not copied (~1.3 GB on the card for one
    closed-form traversal of the 18.6 M-row bundle)."""

    NAMES = ("segment_view", "segment_blocks")

    def __init__(self, kops, names=NAMES, results: bool = False):
        self.kops, self.names, self.results = kops, names, results
        self.calls, self.outputs, self.lock = [], [], threading.Lock()

    def _wrap(self, name, fn):
        def captured(*args, **kwargs):
            out = fn(*args, **kwargs)
            with self.lock:
                self.calls.append((name, args, kwargs))
                if self.results:
                    self.outputs.append(out)
            return out
        return captured

    def __enter__(self):
        self.saved = {n: getattr(self.kops, n) for n in self.names}
        for n, fn in self.saved.items():
            setattr(self.kops, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.kops, n, fn)


def device_ops(prof) -> list:
    """(name, device µs) of the kernels and copies the device ran, longest
    first.  Host-side op rows are left out: they repeat the device time of
    the kernels they launched."""
    ops = [
        (e.key, e.self_device_time_total)
        for e in prof.key_averages()
        if e.device_type != torch.autograd.DeviceType.CPU
        and not e.key.startswith("Activity Buffer")  # the tracer's own
    ]
    return sorted((o for o in ops if o[1] > 0), key=lambda o: -o[1])


def device_busy_ms(prof) -> float:
    return sum(us for _, us in device_ops(prof)) / 1e3


def favorita(rt):
    t0 = time.perf_counter()
    bundle = rt.favorita_like(1684, 54, 4100, SALES_FRACTION, seed=SEED)
    n = bundle.store.get("SalesF").num_rows
    log(f"data: {n} sales rows, {bundle.store.total_rows()} rows in all, "
          f"{time.perf_counter() - t0:.2f}s to generate")
    if n != N_SALES:
        raise AssertionError(f"expected {N_SALES} sales rows, got {n}")
    return bundle


def main_path(rt, bundle) -> dict:
    store, vorder = bundle.store, bundle.vorder
    feats, label = bundle.features, bundle.label
    n = N_SALES

    rt.kops.reset_launch_counts()
    store.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    results = {}
    with Timers((rt.fz, HOST_JOIN), (rt.kops, HOST_IDS)) as timers:
        for version in ("v1", "closed"):
            cfg = dataclasses.replace(
                rt.VERSIONS[version], backend="torch", device="cuda",
                use_kernel=True,
            )
            if version == "v1":
                cfg = dataclasses.replace(cfg, max_iter=V1_MAX_ITER)
            t = time.perf_counter()
            r = rt.linear_regression(store, vorder, feats, label, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            results[version] = r
            if not np.all(np.isfinite(r.theta)) or r.theta.shape != (len(feats) + 2,):
                raise AssertionError(f"{version}: bad theta {r.theta}")
            log(f"{version}: theta={np.array2string(r.theta, precision=6)} "
                f"iterations={r.iterations} scale={r.seconds_scale:.3f}s "
                f"cofactor={r.seconds_cofactor:.3f}s gd={r.seconds_gd:.3f}s "
                f"wall={wall:.3f}s")
        # device time of the closed-form run, from a second, profiled run
        # (the profiler's own host cost would inflate its wall time; BGD's
        # 25,000 small steps would swamp the trace)
        activities = [
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]
        # (the segment kernels' arguments are captured in this run, after
        # the peak memory of the path is read)
        peak = torch.cuda.max_memory_allocated()
        with torch.profiler.profile(activities=activities) as prof, \
                Capture(rt.kops) as cap, Capture(rt.kops, ("moments",)) as cap_m:
            rt.linear_regression(store, vorder, feats, label, cfg)
            torch.cuda.synchronize()
        busy = device_busy_ms(prof) / 1e3
        names = {k: v for k, v in rt.sv.KERNEL_NAMES.items()}
        names["moments"] = ("moments_kernel<",)
        by_kernel = {
            k: sum(us for name, us in device_ops(prof) if any(p in name for p in v)) / 1e3
            for k, v in names.items()
        }
        ours = sum(by_kernel.values()) / 1e3
        log(f"closed device_busy={busy:.3f}s (port kernels {ours:.3f}s) of "
            f"{wall:.3f}s unprofiled wall: idle_share={1 - busy / wall:.4f}")
        log("  port kernels' device ms in the profiled traversal: " + " ".join(
            f"{k}={v:.4f}" for k, v in by_kernel.items()))
        for name, us in device_ops(prof)[:12]:
            log(f"  device {us / 1e3:10.3f} ms  {name[:100]}")
        node_ms = node_device_ms(prof, cap.calls, rt.sv)
        scale_ms = kernel_device_ms(prof, "moments_kernel")
        # one degree-1 batch: every feature node through segment_view1.
        # The store's view cache is evicted first, so that no node is
        # served from it (a scaled engine opts out of it anyway).
        cols = feats + [label]
        factors = results["closed"].factors
        store.view_cache.clear()
        eng = rt.FactorizedEngine(
            store, vorder, cols, scale=factors, device="cuda"
        )
        t = time.perf_counter()
        with torch.profiler.profile(activities=activities) as prof1, \
                Capture(rt.kops) as cap1:
            blk = eng.run_batch([rt.AggregateQuery("deg1", (), 1)])["deg1"]
            torch.cuda.synchronize()
        log(f"degree-1 batch (profiled): {time.perf_counter() - t:.3f}s")
        node_ms1 = node_device_ms(prof1, cap1.calls, rt.sv)
    torch.cuda.synchronize()
    counts = rt.kops.launch_counts()
    log(f"passes={store.passes} node_visits={store.node_visits} "
          f"launches={counts} "
          f"max_memory_allocated={peak} (before the capture)")
    log("host seconds: " + " ".join(
        f"{k}={v:.3f}" for k, v in timers.seconds.items()))
    missing = [k for k in PHASE3_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    # the captured calls again, after the main path's counts are read
    traversal = main_path_kernels(rt, cap.calls, node_ms)
    traversal["degree1"] = main_path_kernels(rt, *view1_calls(rt, cap1.calls, node_ms1),
                                             split=False)
    traversal["moments"] = moments_calls(rt, cap_m.calls, feats + [label], scale_ms)
    traversal["theta_closed"] = results["closed"].theta  # phase 9 scores it
    del cap, cap1, cap_m

    # the degree-1 aggregates over the join equal float64 sums of the fact
    # table: every sale joins exactly one row of each dimension
    sales = store.get("SalesF")
    if not abs(blk.count[0] - n) <= ORACLE_RTOL * n:  # float32 past 2^24
        raise AssertionError(f"degree-1 count {blk.count[0]} != {n}")
    for j, f in enumerate(blk.features):
        terms = factors.transform(f, sales.column(f).astype(np.float64))
        got, expect = blk.lin[0, j], terms.sum()
        if not abs(got - expect) <= ORACLE_RTOL * np.abs(terms).sum():
            raise AssertionError(f"degree-1 Σ{f}: {got} vs {expect}")
    return counts, traversal


def kernel_device_ms(prof, name: str) -> list:
    """Device ms of each launch of the kernels whose name holds ``name`` in
    a profiled run, in launch order."""
    return [us / 1e3 for _, us in sorted(
        (e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
        if e.device_type != torch.autograd.DeviceType.CPU and name in e.name)]


def moments_calls(rt, calls, columns, device_ms) -> list:
    """Each captured ``moments`` call of the profiled closed-form run (one
    a column, in ``columns``' order) again, on its own column: against its
    plain version (count and max equal, the sum within KERNEL_RTOL of
    Σ|x|), whether two calls give bitwise-equal sums, timed per call, back
    to back and profiled (all the call's device work), beside its bound (4·m
    bytes read) and its kernel's device time in the profiled run."""
    if len(calls) != len(columns):
        raise AssertionError(f"{len(calls)} moments calls for the columns {columns}")
    if len(device_ms) != len(calls):
        log(f"  {len(device_ms)} profiled moments launches for {len(calls)} calls: "
            "no per-call device time")
        device_ms = [None] * len(calls)
    out = []
    for (_, args, _), col, dev_ms in zip(calls, columns, device_ms):
        x = args[0]
        kern = functools.partial(rt.kops.moments, x)
        (ks, kmx, kn), (ps, pmx, pn) = kern(), rt.ref.moments_ref(x)
        err = abs(float(ks) - float(ps))
        tol = KERNEL_RTOL * float(x.double().abs().sum())
        if kn != pn or float(kmx) != float(pmx) or not err <= tol:
            raise AssertionError(f"moments at {col}: ({float(ks)}, {float(kmx)}, {kn}) vs "
                                 f"({float(ps)}, {float(pmx)}, {pn}), tol {tol}")
        b, by = bound_ms(4 * x.shape[0], 2 * x.shape[0])
        row = dict(column=col, rows=int(x.shape[0]), max_abs_err=err, tol=tol,
                   bitwise_equal=bool(torch.equal(ks, kern()[0])),
                   ms=time_ms(kern), ms_back_to_back=time_ms_back_to_back(kern),
                   device_ms_call=profiled_ms(kern), device_ms_profiled=dev_ms,
                   plain_ms=time_ms(functools.partial(rt.ref.moments_ref, x)),
                   bound_ms=b, bound_by=by)
        dev = "not attributed" if dev_ms is None else f"{dev_ms:.4f}"
        log(f"  moments {col:12s} M {row['rows']}: ms={row['ms']:.4f} back-to-back "
            f"{row['ms_back_to_back']:.4f} profiled {row['device_ms_call']:.4f} (in the run "
            f"{dev}) plain_ms={row['plain_ms']:.4f} bound_ms={b:.4f} ({by}) "
            f"max_abs_err={err:.3e} tol={tol:.3e} bitwise_equal={row['bitwise_equal']}")
        out.append(row)
    return out


def call_node(sv, name, args, kwargs) -> dict:
    """A captured call's node (by its sizes, FEATURE_NODES / REGROUP_NODES),
    payload, sizes and plan."""
    c, num = args[0], int(args[-1])
    l = args[2] if name == "segment_view" else args[1]
    m, degree = c.shape[0], kwargs.get("degree", 2)
    k = l.shape[1] if l is not None else 0
    payload = ("view" if degree == 2 else "view1") if name == "segment_view" else "blocks"
    node = next((n for n, nm, nk, ng in FEATURE_NODES if (nm, nk, ng) == (m, k, num)),
                None) if name == "segment_view" else next(
        (n for n, nm, ng in REGROUP_NODES if (nm, ng) == (m, num)), None)
    unique = kwargs.get("order") is not None
    kernel = {"view": "segment_view", "view1": "segment_view1"}.get(payload, "segment_reduce")
    path = sv.plan(payload, k, degree, unique)["path"]
    return dict(node=node or f"{payload} M {m} G {num}", kernel=kernel, payload=payload,
                rows=m, k=k, groups=num, degree=degree, unique=unique, path=path,
                launches=2 if path == "atomic" else 1)


def node_device_ms(prof, calls, sv) -> list:
    """Device ms of each captured call's kernels in the profiled run: the
    kernels of each name in launch order, shared out among the calls in call
    order (path C launches two).  None where the counts do not match."""
    events = [e for e in prof.events() if e.device_type != torch.autograd.DeviceType.CPU]
    queues = {}
    for kernel, names in sv.KERNEL_NAMES.items():
        queues[kernel] = sorted(
            (e.time_range.start, e.time_range.elapsed_us()) for e in events
            if any(n in e.name for n in names))
    nodes = [call_node(sv, *call) for call in calls]
    taken = {k: 0 for k in queues}
    out = []
    for nd in nodes:
        i, n = taken[nd["kernel"]], nd["launches"]
        out.append(sum(d for _, d in queues[nd["kernel"]][i : i + n]) / 1e3)
        taken[nd["kernel"]] = i + n
    if any(taken[k] != len(q) for k, q in queues.items()):
        log(f"  profiled kernels {({k: len(q) for k, q in queues.items()})} do not match "
            f"the captured calls' launches {taken}: no per-node device time")
        return [None] * len(nodes)
    return out


def view1_calls(rt, calls, device_ms) -> tuple:
    """(calls, device ms) of the captured degree-1 ``segment_view`` calls."""
    keep = [i for i, call in enumerate(calls)
            if call_node(rt.sv, *call)["kernel"] == "segment_view1"]
    return [calls[i] for i in keep], [device_ms[i] for i in keep]


def node_bound(sv, nd) -> tuple:
    """(ms, by) the card needs for one call: each input read once (rows,
    feature, and the ids the path reads: ``order`` on path A, the segment
    ids on path C), each output written once, the row arithmetic at the
    float32 rate."""
    m, k, g, s = nd["rows"], nd["k"], nd["groups"], 4
    if nd["payload"] == "view":
        w_in, w_out, flops = 2 + k + k * k, 1 + (k + 1) + (k + 1) ** 2, 5 + 3 * k + k * k
    elif nd["payload"] == "view1":
        w_in, w_out, flops = 2 + k, 1 + (k + 1), k + 3
    else:
        w_in = w_out = sv.width("blocks", k, nd["degree"])
        flops = 0 if nd["unique"] else w_in
    return bound_ms(m * (w_in * s + 4) + g * w_out * s, m * flops)


def call_pair(sv, ref, name, args, kwargs, dtype=None):
    """(kernel, plain) of a captured call as calls without arguments, on the
    call's own tensors (cast to ``dtype`` if given)."""
    cast = (lambda t: t if t is None or dtype is None else t.to(dtype))

    def ids(a):  # segment ids and orders as the wrappers take them
        return None if a is None else torch.as_tensor(a, device=args[0].device).to(torch.int32)

    seg = ids(args[-2])
    kw = dict(degree=kwargs.get("degree", 2), order=ids(kwargs.get("order")))
    blocks = [cast(t.contiguous()) if t is not None else None for t in args[:-2]]
    kern_fn, plain_fn = ((sv.segment_view, ref.segment_view_ref) if name == "segment_view"
                         else (sv.segment_blocks, ref.segment_blocks_ref))
    return (functools.partial(kern_fn, *blocks, seg, int(args[-1]), **kw),
            functools.partial(plain_fn, *blocks, seg, int(args[-1]), degree=kw["degree"]))


def main_path_kernels(rt, calls, device_ms, split: bool = True, outputs=None) -> dict:
    """Each captured segment-kernel call (a traversal's, a batch's, a
    drain's merges) again, on its own arguments: kernel vs plain version
    (KERNEL_RTOL), and so the call's own ``outputs`` where captured; path A
    bitwise equal across two calls, one float64 call per (kernel, path)
    within F64_RTOL; timed per call and back to back, beside its plain
    version, its bound and its device time in the profiled traversal; with
    ``split``, the host/device split of the regroup at transactions."""
    sv, ref = rt.sv, rt.ref
    rows, f64_done = [], set()
    log(f"{len(calls)} captured calls, again on their own segment ids")
    for i, ((name, args, kwargs), dev_ms) in enumerate(zip(calls, device_ms)):
        nd = call_node(sv, name, args, kwargs)
        kern, plain = call_pair(sv, ref, name, args, kwargs)
        got, want = kern(), plain()
        err, scale = max_err(got, want)
        tol = KERNEL_RTOL * max(1.0, scale)
        if outputs is not None:
            nd["call_max_abs_err"], _ = max_err(outputs[i], want)
            err = max(err, nd["call_max_abs_err"])
        del want
        if not err <= tol:
            raise AssertionError(f"{nd['kernel']} at {nd['node']}: error {err} > {tol}")
        if nd["path"] == "one_row":
            again = kern()
            if not all(a is None or torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{nd['kernel']} at {nd['node']}: path A not bitwise "
                                     "equal across two calls")
        del got
        if (nd["kernel"], nd["path"]) not in f64_done:
            f64_done.add((nd["kernel"], nd["path"]))
            k64, p64 = call_pair(sv, ref, name, args, kwargs, dtype=torch.float64)
            e64, s64 = max_err(k64(), p64())
            log(f"  float64 {nd['kernel']} path {nd['path']} at {nd['node']}: "
                f"max_abs_err={e64:.3e} tol={F64_RTOL * max(1.0, s64):.3e}")
            if not e64 <= F64_RTOL * max(1.0, s64):
                raise AssertionError(f"float64 {nd['kernel']} at {nd['node']}: {e64}")
            del k64, p64
        b, by = node_bound(sv, nd)
        nd.update(max_abs_err=err, tol=tol, ms=time_ms(kern),
                  ms_back_to_back=time_ms_back_to_back(kern),
                  plain_ms=time_ms(plain, reps=3), bound_ms=b, bound_by=by,
                  device_ms_profiled=dev_ms)
        rows.append(nd)
        dev = "not attributed" if dev_ms is None else f"{dev_ms:.4f}"
        log(f"  {nd['kernel']:14s} {nd['node']:12s} path {nd['path']:7s} M {nd['rows']} "
            f"k {nd['k']} G {nd['groups']}: ms={nd['ms']:.4f} back-to-back "
            f"{nd['ms_back_to_back']:.4f} profiled {dev} plain_ms={nd['plain_ms']:.4f} "
            f"bound_ms={b:.4f} ({by}) max_abs_err={err:.3e} tol={tol:.3e}")
    sums = {}
    for kernel in sorted({r["kernel"] for r in rows}):
        mine = [r for r in rows if r["kernel"] == kernel]
        prof = [r["device_ms_profiled"] for r in mine]
        sums[kernel] = dict(
            calls=len(mine), ms=sum(r["ms"] for r in mine),
            ms_back_to_back=sum(r["ms_back_to_back"] for r in mine),
            plain_ms=sum(r["plain_ms"] for r in mine),
            bound_ms=sum(r["bound_ms"] for r in mine),
            device_ms_profiled=None if None in prof else sum(prof),
        )
        log(f"  {kernel} per traversal ({len(mine)} calls): " + " ".join(
            f"{key}={v:.4f}" if isinstance(v, float) else f"{key}={v}"
            for key, v in sums[kernel].items()))
    out = dict(nodes=rows, per_traversal=sums)
    if split:
        out["transactions_split"] = regroup_split(rt, calls)
    return out


def host_device_split(fns: dict, n: int = 200) -> dict:
    """Where each call's time goes, the calls of ``fns`` taking turns: the
    host's enqueue µs a call (``n`` calls, no synchronise; median of three
    turns), the device µs a call (profiler), and CUDA events a call (host
    and device in turn) and back to back (overlapped), from paired_ms."""
    host = {name: [] for name in fns}
    for r in range(3):
        for name, fn in fns.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            host[name].append((time.perf_counter() - t) / n * 1e6)
            torch.cuda.synchronize()
    times = paired_ms(fns, launches=n)
    out = {}
    for name, fn in fns.items():
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out[name] = dict(host_us=statistics.median(host[name]),
                         device_us=device_busy_ms(prof) * 1e3 / n,
                         event_us=times[name][0] * 1e3,
                         back_to_back_us=times[name][1] * 1e3)
    return out


def regroup_args(sv, calls):
    """The captured segment_blocks call at TIMED_REGROUP_NODE."""
    return next((n, a, kw) for n, a, kw in calls if n == "segment_blocks"
                and call_node(sv, n, a, kw)["node"] == TIMED_REGROUP_NODE)


def regroup_split(rt, calls) -> dict:
    """host_device_split of one segment_blocks call at transactions (the
    main path's own ids) and of index_add_ on the same inputs."""
    name, args, kwargs = regroup_args(rt.sv, calls)
    kern, _ = call_pair(rt.sv, rt.ref, name, args, kwargs)
    c, seg, g = args[0], kern.args[-2], int(args[-1])
    lib = functools.partial(library_segment_sum, c[:, None].contiguous(), seg.long(), g)
    out = host_device_split({"segment_reduce": kern, "index_add_": lib})
    for what, split in out.items():
        log(f"  split at {TIMED_REGROUP_NODE}, {what}: " + " ".join(
            f"{key}={v:.2f}" for key, v in split.items()))
    return out


# -- phase 4: categorical regression and the cofactor baselines --------------

def row_predictions(theta, names, joined, label) -> np.ndarray:
    """θ's prediction on every join row, read by name: ``intercept``, a
    continuous column, or ``attr=g`` (a gather of the block by the row's
    id) — the one-hot design matrix never forms."""
    pred = np.zeros(joined.num_rows)
    blocks = {}
    for i, name in enumerate(names):
        if name == "intercept":
            pred += theta[i]
        elif name == label:
            continue
        elif "=" in name:
            attr, g = name.split("=")
            blocks.setdefault(attr, {})[int(g)] = theta[i]
        else:
            pred += theta[i] * joined.column(name).astype(np.float64)
    for attr, coef in blocks.items():
        table = np.zeros(max(coef) + 1)
        table[list(coef)] = list(coef.values())
        pred += table[joined.column(attr).astype(np.int64)]
    return pred


def identifiable(theta, names, cat) -> np.ndarray:
    """θ without its null-space components: the level (intercept plus each
    categorical block's mean), the continuous coefficients, and each block
    centred.  Two models that predict alike agree here."""
    level = theta[0]
    cont = [i for i, n in enumerate(names[1:-1], 1) if "=" not in n]
    parts = [theta[cont]]
    for c in cat:
        blk = theta[[i for i, n in enumerate(names) if n.startswith(c + "=")]]
        level += blk.mean()
        parts.append(blk - blk.mean())
    return np.concatenate([[level]] + parts)


def compare_models(what, got, want, joined, label, cat=None) -> None:
    """Predictions on every join row within PRED_RTOL of the largest and,
    given ``cat``, identifiable θ within THETA_ID_RTOL of its largest."""
    if got.names != want.names:
        raise AssertionError(f"{what}: names differ")
    p, q = (row_predictions(r.theta, r.names, joined, label) for r in (got, want))
    err, scale = float(np.abs(p - q).max()), float(np.abs(q).max())
    msg = f"{what}: prediction max_abs_err={err:.3e} (of {scale:.3e})"
    if not np.all(np.isfinite(p)) or not err <= PRED_RTOL * scale:
        raise AssertionError(msg)
    if cat is not None:
        a, b = identifiable(got.theta, got.names, cat), identifiable(want.theta, want.names, cat)
        id_err, id_scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        raw = float(np.abs(got.theta - want.theta).max())
        msg += (f"; identifiable theta max_abs_err={id_err:.3e} (of {id_scale:.3e}),"
                f" raw theta {raw:.3e}")
        if not id_err <= THETA_ID_RTOL * id_scale:
            raise AssertionError(msg)
    log(msg)


def check_cofactors(what, got, want, count_exact=False) -> None:
    rel = within(what, got.matrix(), want.matrix(), ORACLE_RTOL)
    log(f"{what}: max_abs_err {rel:.3e} of the largest cofactor (tol {ORACLE_RTOL})")
    if count_exact and got.count != want.count:
        raise AssertionError(f"{what}: count {got.count} != {want.count}")


def categorical_phase(rt, bundle) -> dict:
    store, vorder = bundle.store, bundle.vorder
    feats, label = bundle.features, bundle.label
    cols = feats + [label]
    rt.kops.reset_launch_counts()

    def timed(what, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        log(f"{what}: {time.perf_counter() - t:.3f}s")
        return out

    res, cfgs = {}, {}
    cap_multi = Capture(rt.kops, ("multi_segment_gram",))
    # the factorized leg's categorical cofactors, kept for phase 10
    cap_cat = Capture(rt.regression, ("cat_cofactors_factorized",), results=True)
    for leg, fact in (("factorized", True), ("materialized", False)):
        cfg = cfgs[leg] = dataclasses.replace(
            rt.VERSIONS["closed"], backend="torch", device="cuda",
            categorical=CAT, factorized=fact, use_kernel=not fact,
        )
        with (cap_multi if leg == "materialized" else cap_cat):
            r = timed(f"categorical {leg}", functools.partial(
                rt.linear_regression, store, vorder, feats, label, cfg))
        log(f"  cofactor={r.seconds_cofactor:.3f}s solve={r.seconds_gd:.3f}s")
        if r.theta.shape != (N_CAT_PARAMS,) or not np.all(np.isfinite(r.theta)):
            raise AssertionError(f"categorical {leg}: bad theta shape {r.theta.shape}")
        res[leg] = r
    joined = timed("materialize_join", store.materialize_join)
    compare_models("categorical factorized vs materialized", res["factorized"],
                   res["materialized"], joined, label, cat=CAT)

    factors = timed("scale factors (moments kernel)", functools.partial(
        rt.compute_scale_factors, store, feats, label, use_kernel=True, device="cuda"))
    one = timed("cofactors_materialized (gram kernel)", functools.partial(
        rt.cofactors_materialized, store, cols, use_kernel=True, scale=factors,
        device="cuda"))
    fact = timed("cofactors_factorized", functools.partial(
        rt.cofactors_factorized, store, vorder, cols, backend="torch",
        scale=factors, device="cuda"))
    check_cofactors("materialized vs factorized cofactors", one, fact)
    x = timed("design_matrix", functools.partial(rt.design_matrix, joined, cols, scale=factors))
    stream = timed(f"cofactors_streaming ({STREAM_ROWS} rows a chunk)", functools.partial(
        rt.cofactors_streaming, x, cols, chunk_rows=STREAM_ROWS, device="cuda"))
    check_cofactors("streaming vs one-shot", stream, one, count_exact=True)
    n_items = store.attr_domain("item_nbr")
    with Capture(rt.kops, ("segment_gram",)) as cap_sg:
        groups = timed("cofactors_grouped by item_nbr", functools.partial(
            rt.cofactors_grouped, x, joined.column("item_nbr"), n_items, cols,
            device="cuda"))
    total = groups[0]
    for g in groups[1:]:
        total = total + g
    if len(groups) != n_items:
        raise AssertionError(f"{len(groups)} groups, expected {n_items}")
    check_cofactors("grouped sum vs one-shot", total, one, count_exact=True)

    torch.cuda.synchronize()
    counts = rt.kops.launch_counts()
    log(f"launches={counts}")
    missing = [k for k in PHASE4_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched in phase 4: {missing}")
    # phase 10's inputs: this phase's join, as arrays, and its factorized
    # cofactors (continuous, scaled; categorical, unscaled)
    (cat_args,) = [a for _, a, _ in cap_cat.calls]
    cont = list(cat_args[2])
    if list(cat_args[3]) != list(CAT):
        raise AssertionError(f"phase 4's categorical leg ran over {cat_args[3]}, not {CAT}")
    dist_inputs = dict(
        x=x, cols=cols, cofactors=fact, cont=cont,
        x_cont=np.stack([joined.column(f).astype(np.float64) for f in cont], axis=1),
        ids=np.stack([joined.column(c).astype(np.int64) for c in CAT], axis=1),
        domains={c: store.attr_domain(c) for c in CAT},
        date=joined.column("date"), cat_cofactors=cap_cat.outputs[0],
    )
    del joined, one, stream, cap_cat

    # after the counts: the factorized leg again, profiled, for its
    # degree-1 calls (the g: queries) on their own arguments; the first run
    # published its views to the store's view cache, which would serve
    # every node of this one, so the cache is evicted first
    store.view_cache.clear()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof, Capture(rt.kops) as cap:
        rt.linear_regression(store, vorder, feats, label, cfgs["factorized"])
        torch.cuda.synchronize()
    log(f"categorical factorized (profiled): {time.perf_counter() - t:.3f}s")
    views = main_path_kernels(
        rt, *view1_calls(rt, cap.calls, node_device_ms(prof, cap.calls, rt.sv)), split=False)
    del prof, cap
    grams = {"segment_gram": gram_calls(rt, cap_sg.calls),
             "multi_segment_gram": gram_calls(rt, cap_multi.calls)}
    return counts, views, grams, dist_inputs


def gram_bound(x, n_seg: int, groups: int) -> tuple:
    """(ms, by) of a grouped Gram: x and the ids read once, the [ΣG, K, K]
    output written once, two flops per product and column."""
    m, k = x.shape
    s = x.element_size()
    return bound_ms(m * k * s + m * n_seg * 4 + groups * k * k * s,
                    m * n_seg * k * (k + 1))


def gram_calls(rt, calls) -> dict:
    """Each captured ``segment_gram`` / ``multi_segment_gram`` call of phase
    4 again through ``ops``, on its own arguments: against its plain version
    in float64 on the same values (KERNEL_RTOL; the store band sums 345 K
    unscaled rows a group, where the float32 plain version's own rounding
    reaches ~7e-5 of the largest sum, so float64 keeps the error the
    kernel's), its launches (the plan's chunks) apart from the call, and
    timed per call and back to back beside its float32 plain version and
    bound."""
    kops, ref = rt.kops, rt.ref
    out = []
    for name, args, _ in calls:
        x = args[0]
        ids = torch.as_tensor(args[1], device=x.device)
        ids = (ids if ids.dtype == torch.int32 else ids.to(torch.int32)).contiguous()
        groups = args[2]
        if name == "segment_gram":
            kern = functools.partial(kops.segment_gram, x, ids, groups)
            plain = functools.partial(ref.segment_gram_ref, x, ids, groups)
            n_seg, total = 1, int(groups)
        else:
            kern = functools.partial(kops.multi_segment_gram, x, ids, groups)
            plain = functools.partial(ref.multi_segment_gram_ref, x, ids, groups)
            n_seg, total = len(groups), sum(int(g) for g in groups)
        kops.reset_launch_counts()
        got = kern()
        launches = kops.launch_counts()[name]
        got = [g.double() for g in (got if isinstance(got, list) else [got])]
        want = plain.func(x.double(), *plain.args[1:])
        err, scale = max_err(got, want if isinstance(want, list) else [want])
        tol = KERNEL_RTOL * max(1.0, scale)
        if not err <= tol:
            raise AssertionError(f"{name} at its phase-4 arguments: error {err} > {tol}")
        del got, want
        b, by = gram_bound(x, n_seg, total)
        row = dict(rows=x.shape[0], k=x.shape[1], groups=groups, launches=launches,
                   max_abs_err=err, tol=tol, ms=time_ms(kern),
                   ms_back_to_back=time_ms_back_to_back(kern),
                   plain_ms=time_ms(plain, reps=3), bound_ms=b, bound_by=by)
        log(f"  {name} M {row['rows']} K {row['k']} G {groups}: {launches} launch(es), "
            f"ms={row['ms']:.4f} back-to-back {row['ms_back_to_back']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} bound_ms={b:.4f} ({by}) "
            f"max_abs_err={err:.3e} tol={tol:.3e}")
        out.append(row)
    return dict(calls=len(calls), nodes=out)


# -- phase 5: incremental maintenance ---------------------------------------------

def new_days(rt, store, first_date: int, n_days: int, rng) -> dict:
    """Rows of ``n_days`` new dates from ``first_date`` on for SalesF,
    Transactions and Oil, drawn as ``favorita_like`` draws its own: the
    cut's share (SALES_FRACTION) of the (store, item) pairs each day, the
    same label model, 500–3,000 transactions a store, the oil price's
    random walk.  The dates are values no relation holds yet, so they extend
    the date dictionary."""
    stores, items, oil = (store.get(n) for n in ("Stores", "Items", "Oil"))
    n_stores, n_items = stores.num_rows, items.num_rows
    cluster = np.empty(n_stores)
    cluster[stores.keys["store_nbr"]] = stores.values["cluster"]
    perishable = np.empty(n_items)
    perishable[items.keys["item_nbr"]] = items.values["perishable"]
    last_oil = float(oil.values["dcoilwtico"][np.argmax(oil.keys["date"])])
    per_day = int(n_stores * n_items * SALES_FRACTION)
    days = np.arange(first_date, first_date + n_days, dtype=np.int32)
    flat = np.concatenate([rng.choice(n_stores * n_items, size=per_day, replace=False)
                           for _ in days])
    date = np.repeat(days, per_day)
    s, it = flat // n_items, flat % n_items
    promo = rng.integers(0, 2, size=flat.size).astype(np.float64)
    sales = (5.0 + 0.05 * date + 2.0 * cluster[s] + 3.0 * perishable[it] + 4.0 * promo
             + rng.normal(0, 1.0, size=flat.size))
    n_dates = first_date + n_days
    rel = rt.Relation.from_columns
    return {
        "SalesF": rel("SalesF", {"date": date, "store_nbr": s, "item_nbr": it},
                      {"unit_sales": sales, "onpromotion": promo},
                      {"date": n_dates, "store_nbr": n_stores, "item_nbr": n_items}),
        "Transactions": rel(
            "Transactions",
            {"date": np.repeat(days, n_stores),
             "store_nbr": np.tile(np.arange(n_stores), n_days)},
            {"transactions": rng.integers(500, 3000, size=n_days * n_stores) * 1.0},
            {"date": n_dates, "store_nbr": n_stores}),
        "Oil": rel("Oil", {"date": days},
                   {"dcoilwtico": last_oil + np.cumsum(rng.normal(0, 1, size=n_days))},
                   {"date": n_dates}),
    }


def append_days(rt, stores, first_date: int, n_days: int, rng) -> int:
    """Append ``n_days`` new days, one day at a time, to SalesF,
    Transactions and Oil of every store in ``stores`` (the same rows);
    returns the SalesF rows appended."""
    rows = 0
    for d in range(n_days):
        rels = new_days(rt, stores[0], first_date + d, 1, rng)
        rows += rels["SalesF"].num_rows
        for store in stores:
            for name, rel in rels.items():
                store.append(name, rel)
    return rows


def sufficient(store, bundle, what=None, **kw) -> tuple:
    """The continuous and the categorical (CAT) sufficient statistics of the
    bundle's regression, read through the store (each read's seconds logged
    under ``what``, if given)."""
    args = (bundle.vorder, bundle.features, bundle.label)
    out = []
    for part, cat in (("continuous", ()), ("categorical", CAT)):
        t = time.perf_counter()
        out.append(store.sufficient_stats(*args, categorical=cat, **kw))
        torch.cuda.synchronize()
        if what:
            log(f"{what}, {part}: {time.perf_counter() - t:.3f}s")
    return tuple(out)


def check_stats(what, got, want, rtol) -> None:
    """Each pair of sufficient statistics within ``rtol`` of the largest
    cofactor."""
    for part, g, w in zip(("continuous", "categorical"), got, want):
        rel = within(f"{what}, {part}", g.matrix(), w.matrix(), rtol)
        log(f"  {what}, {part}: max_abs_err {rel:.3e} of the largest (tol {rtol})")


class StepTimers:
    """Wall seconds of a store's fold steps, by patching the instance's
    methods: each relation's whole fold, and within it the view-cache
    folds and the continuous and categorical result-cache delta passes."""

    STEPS = ("_maintain_view_cache", "_delta_cofactors", "_delta_cat_cofactors")

    def __init__(self, store):
        self.store, self.folds, self.steps = store, [], {n: 0.0 for n in self.STEPS}

    def __enter__(self):
        for name in self.STEPS:
            setattr(self.store, name, self._timed(name, getattr(self.store, name)))
        fold = self.store._fold_relation

        def timed_fold(name, *args, **kwargs):
            t = time.perf_counter()
            try:
                return fold(name, *args, **kwargs)
            finally:
                self.folds.append((name, time.perf_counter() - t))

        self.store._fold_relation = timed_fold
        return self

    def _timed(self, step, fn):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.steps[step] += time.perf_counter() - t
        return timed

    def __exit__(self, *exc):
        for name in self.STEPS + ("_fold_relation",):
            del self.store.__dict__[name]


class MergeCapture:
    """The ``segment_blocks`` calls a drain makes inside the engine's
    ``_merge_views`` (a cached view ⊎ its delta view, regrouped), with the
    cached and delta row counts of each merge, by patching the engine class
    and the name the engine module calls (as Capture does)."""

    def __init__(self, rt):
        self.rt, self.calls, self.sizes, self._merging = rt, [], [], None

    def __enter__(self):
        self.saved = (self.rt.FactorizedEngine._merge_views, self.rt.kops.segment_blocks)
        merge, blocks = self.saved

        def merge_views(engine, a, b, degree):
            self._merging = (a.num_rows, b.num_rows)
            try:
                return merge(engine, a, b, degree)
            finally:
                self._merging = None

        def segment_blocks(*args, **kwargs):
            if self._merging is not None:
                self.calls.append(("segment_blocks", args, kwargs))
                self.sizes.append(self._merging)
            return blocks(*args, **kwargs)

        self.rt.FactorizedEngine._merge_views = merge_views
        self.rt.kops.segment_blocks = segment_blocks
        return self

    def __exit__(self, *exc):
        self.rt.FactorizedEngine._merge_views, self.rt.kops.segment_blocks = self.saved


def drain(rt, store, what: str, profile: bool = False) -> tuple:
    """Flush ``store``'s pending appends with the launch counters zeroed
    just before and read just after; the drain must launch the three
    segment kernels.  Logs the seconds of each relation's fold and of its
    steps, the engine's host structure work and, with ``profile``, the
    device's busy time (the profiler's own host cost then inflates the
    wall).  Returns (launch counts, MergeCapture)."""
    rt.kops.reset_launch_counts()
    store.reset_counters()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with MergeCapture(rt) as cap, StepTimers(store) as steps, \
            Timers((rt.fz, HOST_JOIN), (rt.kops, HOST_IDS)) as host, \
            (torch.profiler.profile(activities=activities) if profile
             else contextlib.nullcontext()) as prof:
        t = time.perf_counter()
        drained = store.flush()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    counts = rt.kops.launch_counts()
    log(f"{what}: folds " + " ".join(f"{n}={s:.3f}s" for n, s in steps.folds)
        + "; steps " + " ".join(f"{n.lstrip('_')}={s:.3f}s" for n, s in steps.steps.items())
        + "; host " + " ".join(f"{n}={s:.3f}s" for n, s in host.seconds.items()))
    if profile:
        busy = device_busy_ms(prof) / 1e3
        log(f"{what}: profiled drain {seconds:.3f}s, device busy {busy:.3f}s, "
            f"idle_share={1 - busy / seconds:.4f}")
    info = store.cache_info()
    log(f"{what}: drained {drained} in {seconds:.3f}s; passes={info['passes']} "
        f"node_visits={info['node_visits']} cat_passes={info['cat_passes']} "
        f"cat_node_visits={info['cat_node_visits']} view cache hits={info['view_cache_hits']} "
        f"misses={info['view_cache_misses']} entries={info['view_cache_entries']} "
        f"bytes={info['view_cache_bytes']}; delta log "
        f"{ {k: info[k] for k in ('pending_rows', 'drains', 'drained_rows', 'compactions')} }; "
        f"merges={len(cap.calls)} launches={counts}")
    missing = [k for k in INGEST_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched in the drain: {missing}")
    return counts, cap


def time_index_add(nd, args) -> None:
    """Puts in ``nd`` the time of ``index_add_`` over a captured
    ``segment_blocks`` call's ids into its groups (the blocks laid side by
    side in one [M, W] tensor beforehand)."""
    seg = torch.as_tensor(args[3], device=args[0].device).long()
    data = torch.cat([t.reshape(t.shape[0], -1) for t in (args[0][:, None], *args[1:3])
                      if t is not None], 1).contiguous()
    lib = functools.partial(library_segment_sum, data, seg, int(args[4]))
    nd.update(width=int(data.shape[1]), library_ms=time_ms(lib),
              library_ms_back_to_back=time_ms_back_to_back(lib))


def merge_calls(rt, calls, sizes) -> list:
    """Each captured merge regroup again on its own arguments, measured as
    the main path's calls are (main_path_kernels), with its cached + delta
    rows and the time of ``index_add_`` (time_index_add)."""
    rows = main_path_kernels(rt, calls, [None] * len(calls), split=False)["nodes"]
    for nd, (_, args, _), (cached, delta) in zip(rows, calls, sizes):
        time_index_add(nd, args)
        nd.update(cached_rows=cached, delta_rows=delta)
        log(f"  merge {cached} + {delta} rows → {nd['groups']} groups, W {nd['width']}, "
            f"path {nd['path']}: ms={nd['ms']:.4f} back-to-back {nd['ms_back_to_back']:.4f} "
            f"bound_ms={nd['bound_ms']:.5f} index_add_ {nd['library_ms']:.4f} / "
            f"{nd['library_ms_back_to_back']:.4f}")
    return rows


def ingest_phase(rt, bundle) -> dict:
    """INGEST_FULL_DAYS (one new day) appended to a fresh lazy torch-backend
    Store over the bundle's relations and drained on the card, profiled;
    after the drain the warm read visits no node and equals a cold recompute
    on the merged catalog."""
    store = rt.Store(bundle.store.relations())
    kw = dict(backend="torch", device="cuda")
    t = time.perf_counter()
    sufficient(store, bundle, "cold read", **kw)
    info = store.cache_info()
    log(f"cold reads: {time.perf_counter() - t:.3f}s; passes={info['passes']} "
        f"node_visits={info['node_visits']} view cache entries={info['view_cache_entries']} "
        f"bytes={info['view_cache_bytes']} misses={info['view_cache_misses']}")
    rng = np.random.default_rng(SEED + 1)
    first = store.attr_domain("date")
    counts, merges, sizes = {k: 0 for k in INGEST_KERNELS}, [], []
    for n_days in INGEST_FULL_DAYS:
        what = f"{n_days} new day(s)"
        t = time.perf_counter()
        rows = append_days(rt, [store], first, n_days, rng)
        info = store.cache_info()
        log(f"{what}: {rows} sales rows appended in {time.perf_counter() - t:.3f}s; "
            f"pending relations={info['pending_relations']} rows={info['pending_rows']} "
            f"appends={info['pending_appends']}")
        first += n_days
        # profiled for the device's idle share
        got, cap = drain(rt, store, what, profile=True)
        for k in counts:
            counts[k] += got[k]
        merges += cap.calls
        sizes += cap.sizes
        store.reset_counters()
        t = time.perf_counter()
        warm = sufficient(store, bundle, **kw)
        log(f"{what}: read after the drain {time.perf_counter() - t:.3f}s, "
            f"passes={store.passes} node_visits={store.node_visits}")
        if store.node_visits != 0:
            raise AssertionError(f"{what}: the read after the drain visited "
                                 f"{store.node_visits} nodes")
        fresh = rt.Store(store.relations())
        cold = sufficient(fresh, bundle, f"{what}: cold recompute on the merged catalog",
                          refresh=True, **kw)
        check_stats(f"{what}: drained vs cold", warm, cold, ORACLE_RTOL)
        del fresh, cold, warm
    log(f"phase 5 launches (the drains): {counts}; the drains' merge regroups:")
    return dict(launches=counts, merges=merge_calls(rt, merges, sizes))


def ingest_oracle(rt) -> None:
    """One day and then INGEST_BATCH_DAYS more appended on the oracle cell:
    after each, the float64 numpy drain equals a
    cold numpy recompute (INGEST_F64_RTOL), the float32 torch drain the
    float64 one (ORACLE_RTOL), and the warm closed form (``use_cache``)
    the cold one (WARM_THETA_RTOL)."""
    bundle = rt.favorita_like(1684, 54, 410, SALES_FRACTION, seed=SEED)
    kws = {"numpy": dict(backend="numpy"), "torch": dict(backend="torch", device="cuda")}
    stores = {b: rt.Store(bundle.store.relations()) for b in kws}
    for b, store in stores.items():
        sufficient(store, bundle, **kws[b])
    rng = np.random.default_rng(SEED + 2)
    first = stores["numpy"].attr_domain("date")
    for n_days in (1, INGEST_BATCH_DAYS):
        what = f"oracle cell, {n_days} new day(s)"
        append_days(rt, list(stores.values()), first, n_days, rng)
        first += n_days
        t = time.perf_counter()
        drained = {b: sufficient(store, bundle, **kws[b]) for b, store in stores.items()}
        log(f"{what}: drained and read in {time.perf_counter() - t:.3f}s")
        cold = sufficient(rt.Store(stores["numpy"].relations()), bundle, refresh=True,
                          **kws["numpy"])
        check_stats(f"{what}: numpy drained vs numpy cold", drained["numpy"], cold,
                    INGEST_F64_RTOL)
        check_stats(f"{what}: torch drained vs numpy drained", drained["torch"],
                    drained["numpy"], ORACLE_RTOL)
    cfg = dataclasses.replace(rt.VERSIONS["closed"], backend="numpy", device="cuda")
    args = (bundle.vorder, bundle.features, bundle.label)
    warm = rt.linear_regression(stores["numpy"], *args,
                                dataclasses.replace(cfg, use_cache=True)).theta
    cold = rt.linear_regression(rt.Store(stores["numpy"].relations()), *args, cfg).theta
    rel = float(np.max(np.abs(warm - cold) / np.maximum(np.abs(cold), 1e-12)))
    log(f"oracle cell: warm closed form (use_cache) vs cold, max rel err {rel:.3e} "
        f"(tol {WARM_THETA_RTOL})")
    if not rel <= WARM_THETA_RTOL:
        raise AssertionError(f"warm closed form off the cold one: {rel}")


# -- phase 6: the float64 oracle ------------------------------------------------

def oracle_phase(rt) -> None:
    bundle = rt.favorita_like(1684, 54, 410, SALES_FRACTION, seed=SEED)
    store, vorder = bundle.store, bundle.vorder
    feats, label = bundle.features, bundle.label
    cols = feats + [label]
    log(f"data: {store.get('SalesF').num_rows} sales rows")
    factors = rt.compute_scale_factors(store, feats, label)
    t = time.perf_counter()
    exact = rt.cofactors_factorized(
        store, vorder, cols, backend="numpy", scale=factors
    ).matrix()
    t_np = time.perf_counter() - t
    t = time.perf_counter()
    gpu = rt.cofactors_factorized(
        store, vorder, cols, backend="torch", device="cuda", scale=factors
    ).matrix()
    t_gpu = time.perf_counter() - t
    err = float(np.abs(gpu - exact).max())
    tol = ORACLE_RTOL * float(np.abs(exact).max())
    log(f"cofactors: numpy fp64 {t_np:.3f}s, torch cuda fp32 {t_gpu:.3f}s, "
          f"max_abs_err={err:.3e} tol={tol:.3e}")
    if not err <= tol:
        raise AssertionError(f"cofactors off the fp64 oracle: {err} > {tol}")
    th = {}
    for backend in ("numpy", "torch"):
        cfg = dataclasses.replace(
            rt.VERSIONS["closed"], backend=backend, device="cuda"
        )
        th[backend] = rt.linear_regression(store, vorder, feats, label, cfg).theta
    rel = float(np.max(np.abs(th["torch"] - th["numpy"]) /
                       np.maximum(np.abs(th["numpy"]), 1e-12)))
    log(f"closed-form theta: max rel err {rel:.3e} (tol {THETA_RTOL})")
    if not rel <= THETA_RTOL:
        raise AssertionError(f"theta off the fp64 oracle: {rel}")

    # the categorical closed form: torch on the card vs the float64 engine;
    # the torch leg starts from an empty view cache, or the numpy leg's
    # float64 views would serve it
    cat = {}
    for backend in ("numpy", "torch"):
        store.view_cache.clear()
        cfg = dataclasses.replace(
            rt.VERSIONS["closed"], backend=backend, device="cuda", categorical=CAT
        )
        t = time.perf_counter()
        cat[backend] = rt.linear_regression(store, vorder, feats, label, cfg)
        log(f"categorical closed form, {backend}: {time.perf_counter() - t:.3f}s")
    compare_models("categorical torch cuda vs numpy fp64", cat["torch"], cat["numpy"],
                   store.materialize_join(), label, cat=CAT)


def fd_oracle(rt) -> None:
    """FD-reduced ≡ full on ``fd_star_schema`` at the sizes of the reference's
    ``bench_categorical.run_fd``: float64 at 1e-10, and through the float32
    ``multi_segment_gram`` kernel alike in prediction."""
    b = rt.fd_star_schema(n_cat=8, domain=96, dep_domain=48, n_rows=4000, seed=13)
    found = b.store.infer_fds()
    cat = tuple(f"c{i}" for i in range(8)) + tuple(f"d{i}" for i in range(8))
    feats = ["x"] + list(cat)
    red = b.store.fd_reduction(list(cat))
    log(f"FDs inferred: {len(found)}; reduction keeps {red.kept}")
    if sorted(red.dropped) != sorted(cat[8:]):
        raise AssertionError(f"expected every d_i dropped, got {sorted(red.dropped)}")
    out = {}
    for leg, fact in (("numpy", True), ("kernel", False)):
        for fds in (True, False):
            cfg = dataclasses.replace(
                rt.VERSIONS["closed"], backend="numpy", device="cuda", categorical=cat,
                factorized=fact, use_kernel=not fact, use_fds=fds,
            )
            out[leg, fds] = rt.linear_regression(b.store, b.vorder, feats, b.label, cfg)
    exact, full = out["numpy", True], out["numpy", False]
    err = float(np.abs(exact.theta - full.theta).max())
    log(f"FD-reduced vs full, float64: max_abs_err={err:.3e} over {len(exact.theta)} "
        f"coefficients (tol {FD_ATOL})")
    if exact.names != full.names or not err <= FD_ATOL:
        raise AssertionError(f"FD-reduced theta off the full solve: {err}")
    joined = b.store.materialize_join()
    for fds in (True, False):
        compare_models(f"FD kernel leg use_fds={fds} vs float64", out["kernel", fds],
                       exact, joined, b.label)


# -- phase 8: GLM and polynomial -------------------------------------------------

def glm_config(rt, **kw):
    """bench_categorical's GLM: logistic, ridge GLM_RIDGE, GD on the card."""
    return rt.GLMConfig(family="logistic", ridge=GLM_RIDGE, device="cuda", **kw)


def glm_fit(rt, design, what: str, **kw) -> dict:
    """``fit_glm`` on ``design``, timed and logged: the result and its
    seconds, iterations (ms a step), ``converged`` and penalized NLL."""
    t = time.perf_counter()
    res = rt.fit_glm(design, glm_config(rt, **kw))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    if res.theta.shape != (design.num_params,) or not np.all(np.isfinite(res.theta)):
        raise AssertionError(f"{what}: bad theta of shape {res.theta.shape}")
    ms = sec / max(res.iterations, 1) * 1e3
    log(f"{what}: {sec:.3f}s, iterations={res.iterations} ({ms:.4f} ms a step) "
        f"converged={res.converged} nll={res.nll!r}")
    return dict(result=res, seconds=sec, iterations=res.iterations,
                converged=res.converged, nll=res.nll, ms_per_step=ms)


def public(row: dict) -> dict:
    """A fit's row without its result object (for the JSON line)."""
    return {k: v for k, v in row.items() if k != "result"}


def compress(rt, store, vorder, cont, what: str, backend: str = "torch"):
    """The GLM's compressed design, from an evicted view cache; (design, s)."""
    store.view_cache.clear()
    t = time.perf_counter()
    design = rt.compressed_design_factorized(
        store, vorder, list(cont), list(GLM_CAT), GLM_LABEL, backend=backend,
        device="cuda")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    log(f"{what}: compressed to {design.num_rows} groups, {design.num_params} "
        f"parameters, {backend} backend, {sec:.3f}s")
    return design, sec


def gd_profile(rt, design, what: str) -> dict:
    """One chunk of GD ``pairs`` steps (GLM_GD_PROFILE_STEPS) under the
    profiler, on the device alone (a host trace of the chunk's ops cost
    tens of seconds): the device's busy ms a step against the wall's, and
    the longest device ops."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    cfg = glm_config(rt, solver="gd", gd_accum="pairs", gd_max_iter=GLM_GD_PROFILE_STEPS)
    t = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        res = rt.fit_glm(design, cfg)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    steps = max(res.iterations, 1)
    busy = device_busy_ms(prof)
    ops = device_ops(prof)[:8]
    out = dict(steps=res.iterations, wall_ms_per_step=wall * 1e3 / steps,
               device_ms_per_step=busy / steps, idle_share=1 - busy / (wall * 1e3),
               top_ops=[(name[:80], us / 1e3 / steps) for name, us in ops])
    log(f"{what}: GD profiled, {res.iterations} steps: device busy "
        f"{out['device_ms_per_step']:.4f} ms a step of {out['wall_ms_per_step']:.4f} "
        f"(profiled wall), idle_share={out['idle_share']:.4f}")
    for name, ms in out["top_ops"]:
        log(f"  device {ms:9.4f} ms a step  {name}")
    return out


def gd_repeat(first: dict, again: dict) -> dict:
    """Whether two GD runs on the card gave the same iteration count and θ
    (the categorical gradient adds with float32 atomics)."""
    a, b = first["result"], again["result"]
    out = dict(iterations=[a.iterations, b.iterations],
               same_iterations=a.iterations == b.iterations,
               theta_equal=bool(np.array_equal(a.theta, b.theta)),
               max_theta_diff=float(np.abs(a.theta - b.theta).max()),
               nll=[a.nll, b.nll])
    log(f"  GD again: {out}")
    return out


def captured_calls(rt, calls, outputs=None) -> dict:
    """Each captured segment-kernel call (a GLM compression's, the
    service's) again on its own arguments, measured and checked as the main
    path's calls are (main_path_kernels, with the calls' own ``outputs``
    where captured, and its sums per kernel); a ``segment_blocks`` call
    also beside ``index_add_`` (time_index_add)."""
    out = main_path_kernels(rt, calls, [None] * len(calls), split=False, outputs=outputs)
    for nd, (name, args, _) in zip(out["nodes"], calls):
        if name != "segment_blocks":
            nd["library_ms"] = None
            continue
        time_index_add(nd, args)
        log(f"  {nd['node']}: index_add_ {nd['library_ms']:.4f} / "
            f"{nd['library_ms_back_to_back']:.4f} back to back")
    return out


def gd_grad_check(rt, design, theta, what: str) -> dict:
    """GD's objective on the card (``pairs``) at ``theta``, moved into GD's
    scaled coordinates: its gradient against the host's float64
    ``_grad_theta`` on the design scaled alike, entry by entry within
    GD_GRAD_RTOL of the magnitudes the entry sums."""
    nll_grad, avg, mx = rt.glm._gd_objective(
        design, glm_config(rt, solver="gd", gd_accum="pairs"))
    k = len(design.cont_names)
    ts = theta.copy()
    ts[0] += theta[1 : 1 + k] @ avg
    ts[1 : 1 + k] *= mx
    ts = ts.astype(np.float32)
    _, _, g = nll_grad(torch.as_tensor(ts, device="cuda"))
    got = g.double().cpu().numpy()
    ts = ts.astype(np.float64)
    scaled = dataclasses.replace(design, cont=(design.cont - avg) / mx)
    oid = design.offset_ids()
    grad_eta, _, _ = rt.glm._family_stats("logistic", scaled.linpred(ts), design.counts,
                                          design.ysum)
    want = rt.glm._grad_theta(scaled, grad_eta, oid)
    mag = rt.glm._grad_theta(dataclasses.replace(scaled, cont=np.abs(scaled.cont)),
                             np.abs(grad_eta), oid)
    want[1:] += GLM_RIDGE * ts[1:]
    mag[1:] += GLM_RIDGE * np.abs(ts[1:])
    ratio = float(np.max(np.abs(got - want) / np.maximum(mag, np.finfo(np.float64).tiny)))
    log(f"{what}: GD gradient at its last θ vs the host's float64: max |Δg|/Σ|terms| "
        f"{ratio:.3e} (tol {GD_GRAD_RTOL}) over {len(got)} entries")
    if not ratio <= GD_GRAD_RTOL:
        raise AssertionError(f"{what}: GD gradient off the host's: {ratio}")
    return dict(max_rel_to_magnitude=ratio, tol=GD_GRAD_RTOL)


def glm_phase(rt, bundle) -> tuple:
    """bench_categorical's GLM leg at full size, G ≈ m (``transactions``
    with the two categorical keys) and G ≪ m (the keys alone): the
    compression through kernels 1 and 3 (counts zeroed before, read
    after), IRLS on the host, GD ``pairs`` on the card (its gradient
    checked against the host's); then the compression's kernel calls
    again against their plain versions (captured_calls)."""
    store, vorder = bundle.store, bundle.vorder
    promo = float(store.get("SalesF").column(GLM_LABEL).sum())
    out, counts = {}, {k: 0 for k in PHASE8_KERNELS}
    for leg, cont in (("full", GLM_CONT), ("cat_only", ())):
        rt.kops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        design, sec = compress(rt, store, vorder, cont, f"GLM {leg}")
        got = rt.kops.launch_counts()
        log(f"GLM {leg}: launches {got}")
        missing = [k for k in PHASE8_KERNELS if got[k] == 0]
        if missing:
            raise AssertionError(f"GLM {leg}: kernels never launched: {missing}")
        for k in counts:
            counts[k] += got[k]
        # counts and label sums are integers: exact in float32 on the card
        params = 1 + len(cont) + sum(store.attr_domain(c) for c in GLM_CAT)
        if (design.num_params != params or design.total_rows != N_SALES
                or design.ysum.sum() != promo):
            raise AssertionError(
                f"GLM {leg}: {design.num_params} parameters, {design.total_rows} "
                f"rows, label sum {design.ysum.sum()} (want {params}, {N_SALES}, {promo})")
        with Timers((rt.glm, IRLS_STEPS)) as steps:
            irls = glm_fit(rt, design, f"GLM {leg}: IRLS")
        irls["host_seconds"] = steps.seconds
        log(f"GLM {leg}: IRLS host seconds " + " ".join(
            f"{n}={v:.3f}" for n, v in steps.seconds.items()))
        gd = glm_fit(rt, design, f"GLM {leg}: GD pairs", solver="gd",
                     gd_accum="pairs", gd_max_iter=GLM_GD_STEPS)
        gd["profiled"] = gd_profile(rt, design, f"GLM {leg}")
        gd["gradient"] = gd_grad_check(rt, design, gd["result"].theta, f"GLM {leg}")
        # θ = 0 predicts 1/2 everywhere: GD must have descended from there
        nll0 = N_SALES * np.log(2.0)
        if not irls["result"].converged or not gd["nll"] < nll0:
            raise AssertionError(f"GLM {leg}: IRLS converged={irls['converged']}, "
                                 f"GD nll {gd['nll']} vs {nll0} at θ = 0")
        row = dict(groups=design.num_rows, params=design.num_params,
                   seconds_compress=sec, launches={k: got[k] for k in PHASE8_KERNELS},
                   irls=public(irls), gd_pairs=public(gd),
                   gd_nll_minus_irls=gd["nll"] - irls["nll"])
        if leg == "cat_only":
            row["gd_again"] = gd_repeat(gd, glm_fit(
                rt, design, f"GLM {leg}: GD pairs again", solver="gd",
                gd_accum="pairs", gd_max_iter=GLM_GD_STEPS))
        row["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"GLM {leg}: GD nll − IRLS nll = {row['gd_nll_minus_irls']!r}; "
            f"peak memory {row['peak_bytes']}")
        # the compression again with its calls captured (the tensors held
        # would swell the peak above), each call then against its plain version
        with Capture(rt.kops) as cap:
            again, _ = compress(rt, store, vorder, cont, f"GLM {leg}, calls captured")
        if not all(np.array_equal(getattr(again, n), getattr(design, n))
                   for n in ("cont", "cat_ids", "counts", "ysum")):
            raise AssertionError(f"GLM {leg}: the compression differs between two runs")
        row["calls"] = captured_calls(rt, cap.calls)["nodes"]
        out[leg] = row
        del design, again, cap
    return out, counts


def poly_calls(rt, calls) -> list:
    """Each captured ``segment_blocks`` call of a degree-3 run again on its
    own arguments: against its plain version (F64_RTOL), path A bitwise
    equal across two calls, timed per call and back to back beside the
    plain version, ``index_add_`` over the same ids and the bound (each
    float64 row and its id read once, each sum written once)."""
    out = []
    for name, args, kwargs in calls:
        c, lin, g = args[0], args[1], int(args[-1])
        m, w = c.shape[0], 1 + (0 if lin is None else lin.shape[1])
        path = rt.sv.plan("blocks", w - 1, kwargs.get("degree", 2),
                          kwargs.get("order") is not None)["path"]
        kern, plain = call_pair(rt.sv, rt.ref, name, args, kwargs)
        got = kern()
        err, scale = max_err(got, plain())
        tol = F64_RTOL * max(1.0, scale)
        if not err <= tol:
            raise AssertionError(f"polynomial segment_blocks M {m} W {w}: {err} > {tol}")
        if path == "one_row" and not all(
                a is None or torch.equal(a, b) for a, b in zip(got, kern())):
            raise AssertionError(f"polynomial segment_blocks M {m}: path A not bitwise equal")
        del got
        data = c[:, None] if lin is None else torch.cat([c[:, None], lin], 1)
        lib = functools.partial(library_segment_sum, data, kern.args[-2].long(), g)
        b, by = bound_ms(m * (w * 8 + 4) + g * w * 8, 0 if path == "one_row" else m * w,
                         peak=FP64_FLOPS)
        row = dict(rows=m, groups=g, width=w, path=path, max_abs_err=err, tol=tol,
                   ms=time_ms(kern), ms_back_to_back=time_ms_back_to_back(kern),
                   plain_ms=time_ms(plain, reps=3), library_ms=time_ms(lib, reps=3),
                   bound_ms=b, bound_by=by)
        del data, lib
        log(f"  segment_blocks float64 M {m} G {g} W {w} path {path}: ms={row['ms']:.4f} "
            f"back-to-back {row['ms_back_to_back']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"index_add_ {row['library_ms']:.4f} bound_ms={b:.4f} ({by}) "
            f"max_abs_err={err:.3e} tol={tol:.3e}")
        out.append(row)
    return out


def poly_phase(rt, bundle) -> tuple:
    """bench_polynomial's degrees (POLY_FULL_DEGREES) on the 18.6 M-row store: each degree's
    seconds, kernel 3's launches (zeroed before, read after) and peak
    memory; the first degree's degree-1 block (intercept, features,
    label) against the quadratic engine in float64; the last
    degree's ``segment_blocks`` calls captured and run again (poly_calls),
    so its peak counts the captured calls' inputs."""
    store, vorder = bundle.store, bundle.vorder
    feats, label = bundle.features, bundle.label
    rows, launches = [], 0
    for d in POLY_FULL_DEGREES:
        rt.kops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        capture = Capture(rt.kops, ("segment_blocks",) if d == POLY_FULL_DEGREES[-1] else ())
        with Timers((rt.poly._PolyEngine, POLY_STEPS), (rt.poly, HOST_JOIN)) as steps, capture:
            t = time.perf_counter()
            cof = rt.polynomial_cofactors(store, vorder, feats, label, degree=d,
                                          device="cuda")
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
        got = rt.kops.launch_counts()
        if got["segment_reduce"] == 0:
            raise AssertionError(f"polynomial degree {d}: segment_reduce never launched")
        launches += got["segment_reduce"]
        mat = cof.matrix()
        k = len(rt.expand_monomials(feats, d)) + 1
        if mat.shape != (k + 1, k + 1) or not np.all(np.isfinite(mat)) or cof.count != N_SALES:
            raise AssertionError(f"polynomial degree {d}: {mat.shape}, count {cof.count}")
        row = dict(degree=d, columns=k, seconds=sec, launches=got["segment_reduce"],
                   peak_bytes=torch.cuda.max_memory_allocated(), steps=steps.seconds)
        log(f"polynomial degree {d}: {sec:.3f}s, {k} columns, launches {got}, "
            f"peak memory {row['peak_bytes']}; seconds in " + " ".join(
                f"{n}={v:.3f}" for n, v in steps.seconds.items()))
        if d == POLY_FULL_DEGREES[0]:
            # the intercept, the degree-1 monomials (sorted features, first
            # of the monomials) and the label: the degree-1 cofactors
            lin = list(range(1 + len(feats))) + [mat.shape[0] - 1]
            quad = rt.cofactors_factorized(
                store, vorder, sorted(feats) + [label], backend="torch",
                dtype=torch.float64, use_view_cache=False, device="cuda").matrix()
            sub = mat[np.ix_(lin, lin)]
            err, tol = float(np.abs(sub - quad).max()), POLY_QUAD_RTOL * float(np.abs(quad).max())
            log(f"  degree-1 block vs the quadratic engine (float64): max_abs_err={err:.3e} "
                f"tol={tol:.3e}")
            if not err <= tol:
                raise AssertionError(f"polynomial degree 1 off the quadratic engine: {err}")
            row["vs_quadratic"] = dict(max_abs_err=err, tol=tol)
        rows.append(row)
    log(f"polynomial degree {POLY_FULL_DEGREES[-1]}: its {len(capture.calls)} segment_blocks "
        f"calls captured")
    return dict(degrees=rows, calls=poly_calls(rt, capture.calls)), launches


def glm_poly_oracle(rt) -> dict:
    """Phase 8's checks on the oracle cell, each against the port's own
    float64 paths: the torch compression equals the numpy one exactly and
    IRLS on the two gives the same θ bit for bit; GD on the G ≪ m design
    predicts within GLM_PRED_ATOL of IRLS; polynomial degrees on the card
    equal the CPU's and degree 2 the flat oracle; ``sum_product`` equals
    the numpy engine's cofactors."""
    bundle = rt.favorita_like(1684, 54, 410, SALES_FRACTION, seed=SEED)
    store, vorder = bundle.store, bundle.vorder
    feats, label = bundle.features, bundle.label
    out = {}
    designs = {}
    for backend in ("torch", "numpy"):
        designs[backend], _ = compress(rt, store, vorder, GLM_CONT,
                                       "oracle cell GLM", backend=backend)
    a, b = designs["torch"], designs["numpy"]
    for name in ("cont", "cat_ids", "counts", "ysum"):
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"oracle cell: torch compression's {name} != numpy's")
    if a.param_names() != b.param_names():
        raise AssertionError("oracle cell: compressed layouts differ")
    irls = {k: glm_fit(rt, d, f"oracle cell IRLS on the {k} design")["result"]
            for k, d in designs.items()}
    if not np.array_equal(irls["torch"].theta, irls["numpy"].theta):
        raise AssertionError("oracle cell: IRLS θ differs between the two designs")
    out["compression"] = dict(groups=a.num_rows, equal=True, irls_theta_bitwise=True)
    log("oracle cell: torch compression ≡ numpy (keys, ids, order, counts, "
        "label sums); IRLS θ bitwise equal")

    design, _ = compress(rt, store, vorder, (), "oracle cell GLM, categorical only")
    base = glm_fit(rt, design, "oracle cell IRLS (categorical only)")["result"]
    want = rt.glm_predict_raw(base.theta, design.cont, design.cat_ids, design, "logistic")
    # pairs: at 1.86 M rows the float32 NLL floor stops fp32 GD by α
    # collapse before it reaches the bound (reported below), the
    # reference's JAX GD as the port's on the CPU (tools/glm_gd_witness.py)
    gd = [glm_fit(rt, design, f"oracle cell GD pairs, run {i}", solver="gd",
                  gd_accum="pairs", gd_max_iter=GLM_ORACLE_GD_STEPS) for i in (1, 2)]
    pred = rt.glm_predict_raw(gd[0]["result"].theta, design.cont, design.cat_ids,
                              design, "logistic")
    err = float(np.abs(pred - want).max())
    log(f"oracle cell GD vs IRLS predictions: max_abs_err={err:.3e} (tol {GLM_PRED_ATOL})")
    if not err <= GLM_PRED_ATOL:
        raise AssertionError(f"oracle cell: GD predictions off IRLS's: {err}")
    # the plain float32 accumulation on the same design, reported only
    fp32 = glm_fit(rt, design, "oracle cell GD fp32 (reported)", solver="gd",
                   gd_max_iter=GLM_ORACLE_GD_STEPS)
    fp32["pred_err"] = float(np.abs(rt.glm_predict_raw(
        fp32["result"].theta, design.cont, design.cat_ids, design, "logistic") - want).max())
    log(f"oracle cell GD fp32 vs IRLS predictions: max_abs_err={fp32['pred_err']:.3e}")
    out["gd"] = dict(groups=design.num_rows, gd=public(gd[0]), pred_err=err,
                     again=gd_repeat(*gd), fp32=public(fp32))

    polys = []
    for d in POLY_DEGREES:
        got = {}
        for where, dev in (("card", "cuda"), ("host", "cpu")):
            t = time.perf_counter()
            got[where] = rt.polynomial_cofactors(store, vorder, feats, label, degree=d,
                                                 device=dev).matrix()
            torch.cuda.synchronize()
            got[where + "_s"] = time.perf_counter() - t
        err = float(np.abs(got["card"] - got["host"]).max())
        tol = POLY_DEVICE_RTOL * float(np.abs(got["host"]).max())
        log(f"oracle cell polynomial degree {d}: cuda {got['card_s']:.3f}s, cpu "
            f"{got['host_s']:.3f}s, max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"polynomial degree {d}: cuda off cpu by {err}")
        polys.append(dict(degree=d, cuda_s=got["card_s"], cpu_s=got["host_s"],
                          max_abs_err=err, tol=tol))
        if d == 2:
            flat = poly_flat(rt, store, feats, label)
            if not np.allclose(got["card"], flat, rtol=POLY_FLAT_RTOL, atol=1e-5):
                raise AssertionError("polynomial degree 2 off the flat oracle")
            rel = float(np.max(np.abs(got["card"] - flat) / np.maximum(np.abs(flat), 1e-300)))
            log(f"  degree 2 vs the flat oracle: max rel err {rel:.3e} (rtol {POLY_FLAT_RTOL})")
            polys[-1]["flat_rel_err"] = rel
    out["polynomial"] = polys

    pair = ["unit_sales", "onpromotion"]
    cof = rt.FactorizedEngine(store, vorder, pair, backend="numpy",
                              use_view_cache=False).cofactors()
    engine = rt.FactorizedEngine(store, vorder, pair, backend="torch",
                                 use_view_cache=False, device="cuda")
    sums = []
    for attrs, want in (([], cof.count), (pair[:1], cof.lin[0]), (pair, cof.quad[0, 1])):
        got = engine.sum_product(attrs)
        tol = ORACLE_RTOL * abs(want) if attrs else 0.0
        log(f"oracle cell sum_product({attrs}): {got!r} vs numpy {float(want)!r} (tol {tol:.3e})")
        if not abs(got - want) <= tol:
            raise AssertionError(f"sum_product({attrs}) = {got}, numpy {want}")
        sums.append(dict(attrs=attrs, got=got, numpy=float(want), tol=tol))
    out["sum_product"] = sums
    return out


def poly_flat(rt, store, feats, label) -> np.ndarray:
    """bench_polynomial's flat pass at degree 2: the materialized join
    expanded to monomial columns, then one float64 Gram on the host."""
    cols = feats + [label]
    z = rt.design_matrix(store.materialize_join(), cols)
    col_of = {c: i for i, c in enumerate(cols)}
    exp = [np.ones(z.shape[0])]
    for mono in rt.expand_monomials(feats, 2):
        v = np.ones(z.shape[0])
        for name in mono:
            v = v * z[:, col_of[name]]
        exp.append(v)
    exp.append(z[:, col_of[label]])
    zz = np.stack(exp, axis=1)
    return zz.T @ zz


def fd_glm(rt) -> dict:
    """``glm_regression`` on the FD cell as ``tests/test_fd.py`` runs it,
    the compression on the card: FD-reduced ≡ full (θ at FD_ATOL, the
    penalized NLL at FD_NLL_ATOL)."""
    b = rt.fd_star_schema(n_cat=8, domain=96, dep_domain=48, n_rows=4000, seed=13)
    b.store.infer_fds()
    cat = [f"c{i}" for i in range(8)] + [f"d{i}" for i in range(8)]
    cfg = glm_config(rt, tol=1e-14)
    res = {}
    for fds in (False, True):
        t = time.perf_counter()
        res[fds] = rt.glm_regression(b.store, b.vorder, ["x"], cat, "promo", cfg,
                                     backend="torch", use_fds=fds)
        log(f"FD cell GLM use_fds={fds}: {time.perf_counter() - t:.3f}s, "
            f"{len(res[fds].theta)} coefficients, iterations={res[fds].iterations}")
    full, red = res[False], res[True]
    err, dnll = float(np.abs(red.theta - full.theta).max()), abs(red.nll - full.nll)
    log(f"FD cell GLM reduced vs full: max_abs_err={err:.3e} (tol {FD_ATOL}), "
        f"|Δ nll|={dnll:.3e} (tol {FD_NLL_ATOL})")
    if full.names != red.names or not err <= FD_ATOL or not dnll < FD_NLL_ATOL:
        raise AssertionError(f"FD cell GLM: reduced off full by {err}, nll {dnll}")
    return dict(coefficients=len(full.theta), max_abs_err=err, nll_diff=dnll)


def phase8(rt, bundle) -> tuple:
    """GLM and polynomial (see the module docstring); (JSON, launches)."""
    t = time.perf_counter()
    glm, counts = glm_phase(rt, bundle)
    poly, n_poly = poly_phase(rt, bundle)
    counts["segment_reduce"] += n_poly
    out = dict(glm=glm, polynomial=poly, oracle=glm_poly_oracle(rt), fd=fd_glm(rt),
               launches=counts)
    out["seconds"] = time.perf_counter() - t
    log(f"phase 8: {out['seconds']:.1f}s, launches {counts}")
    return out, counts


# -- phase 9: the factorized service ---------------------------------------------

# the multi-tenant train pool: overlapping subsets of Favorita's eight
# features, drawn Zipf-skewed (a few popular models and a long tail)
SERVICE_FEATURES = ("date", "store_nbr", "item_nbr", "onpromotion", "transactions",
                    "dcoilwtico", "perishable", "cluster")
SERVICE_POOL = (
    ("date", "store_nbr", "item_nbr", "onpromotion"),
    ("onpromotion", "perishable", "cluster"),
    ("date", "onpromotion", "transactions"),
    ("store_nbr", "cluster", "transactions", "dcoilwtico"),
    ("date", "item_nbr", "perishable", "dcoilwtico"),
    SERVICE_FEATURES,
)
SERVICE_LABEL = "unit_sales"
SERVICE_RIDGE = 0.006
SERVICE_TENANTS = 8  # client threads t0–t7, one a tenant
SERVICE_AGG = ("unit_sales", "onpromotion", "transactions")  # the aggregates read
SERVICE_WAIT_S = 900  # longest a ticket or the fold may take
# the cycle's steps, timed by name (Timers) on the engine and the service
SERVICE_ENGINE_STEPS = ("__init__", "run_batch")
SERVICE_STEPS = ("_finish", "_apply_write", "_flush_pending")
# fault leg: the per-visit hazards of its two windows
FAULT_RATES = (0.05, 0.20)
SERVICE_KERNELS = INGEST_KERNELS  # what the service's reads and folds launch


def service_reads(rt, bundle, theta, seed: int) -> tuple:
    """(window 1, window 2) as lists of (tenant, kind, features, extra).
    Window 1 has 12 reads: 6 trains and 2 cofactor reads over pool subsets
    drawn Zipf-skewed, 3 scores of ``theta`` over the bundle's own
    features, 1 aggregates read (degree 1 by store_nbr, degree 2 by
    cluster), in a seeded order, the tenants t0–t7 in turn.  Window 2 sends
    them again and one read the idle fold leaves cold (degree 1 by date)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(SERVICE_POOL) + 1)
    picks = rng.choice(len(SERVICE_POOL), size=8, p=p / p.sum())
    reads = [("train", SERVICE_POOL[i], None) for i in picks[:6]]
    reads += [("score", tuple(bundle.features), np.asarray(theta))] * 3
    reads += [("cofactors", SERVICE_POOL[i] + (SERVICE_LABEL,), None) for i in picks[6:]]
    reads.append(("aggregates", SERVICE_AGG, (
        rt.AggregateQuery("by_store", ("store_nbr",), 1),
        rt.AggregateQuery("by_cluster", ("cluster",), 2))))
    reads = [reads[i] for i in rng.permutation(len(reads))]
    reads.append(("aggregates", SERVICE_AGG, (rt.AggregateQuery("by_date", ("date",), 1),)))
    reads = [(f"t{i % SERVICE_TENANTS}", *r) for i, r in enumerate(reads)]
    return reads[:-1], reads


def read_key(read) -> tuple:
    """What a read asks, whoever the tenant: its kind, features and extra
    argument (the same θ or queries object for a repeated read)."""
    _, kind, feats, extra = read
    return kind, tuple(feats), id(extra)


def submit(svc, vorder, read):
    tenant, kind, feats, extra = read
    if kind == "train":
        return svc.train(tenant, vorder, list(feats), SERVICE_LABEL, ridge=SERVICE_RIDGE)
    if kind == "score":
        return svc.score(tenant, vorder, list(feats), SERVICE_LABEL, extra)
    if kind == "cofactors":
        return svc.cofactors(tenant, vorder, list(feats))
    return svc.aggregates(tenant, vorder, list(feats), list(extra))


def run_window(svc, vorder, reads) -> dict:
    """One window, arriving as one burst while a cycle is in flight: the
    reads are queued in their listed order under the service's cycle lock
    (held as a running cycle holds it), so the drain worker serves the
    window in one cycle and both windows split alike where the cycle
    bisects a window whose merged plan fails.  A client thread a tenant
    waits for its reads.  Returns the tickets, each read's latency (submit
    to result) and the window's wall seconds, from the first submit to the
    last result."""
    mine = {}
    for i, r in enumerate(reads):
        mine.setdefault(r[0], []).append(i)
    tickets, submitted, done, late = [], [], [0.0] * len(reads), []

    def client(idx):
        for i in idx:
            if tickets[i].wait(SERVICE_WAIT_S):
                done[i] = time.perf_counter()
            else:
                late.append(i)

    threads = [threading.Thread(target=client, args=(idx,)) for idx in mine.values()]
    with svc._cycle_lock:
        for r in reads:
            submitted.append(time.perf_counter())
            tickets.append(submit(svc, vorder, r))
        for t in threads:  # waiting before the worker can serve a read
            t.start()
    for t in threads:
        t.join(SERVICE_WAIT_S + 60)
    if late or any(t.is_alive() for t in threads):
        raise AssertionError(f"reads {late} not served in {SERVICE_WAIT_S}s")
    return dict(tickets=tickets, latency=[d - s for s, d in zip(submitted, done)],
                wall=max(done) - min(submitted))


class Oracle64:
    """Float64 numpy over a Favorita catalog's join, independent of the
    port: every sale joins exactly one row of each dimension, so the join
    is the sales rows with their dimension columns looked up.  ``cof``
    projects the one cofactor matrix of the eight features and the label
    (Prop. 4.1).  ``theta`` is the ridge closed form of §4.2: each column
    scaled by its mean and max|x| over the relations that hold it (the
    label centred only), the scaled join's normal equations solved with
    ``np.linalg.solve``, θ unscaled; ``scaled`` takes a θ into those
    coordinates, where every feature lies in [−1, 1]."""

    def __init__(self, store):
        sales = store.get("SalesF")
        col = {a: sales.column(a).astype(np.float64)
               for a in ("date", "store_nbr", "item_nbr", "onpromotion", SERVICE_LABEL)}
        d, s, it = (col[a].astype(np.int64) for a in ("date", "store_nbr", "item_nbr"))

        def lookup(name, keys, value, index):
            rel = store.get(name)
            table = np.full([int(rel.column(k).max()) + 1 for k in keys], np.nan)
            table[tuple(rel.column(k).astype(np.int64) for k in keys)] = rel.column(value)
            return table[index]

        col["transactions"] = lookup("Transactions", ("date", "store_nbr"),
                                     "transactions", (d, s))
        col["dcoilwtico"] = lookup("Oil", ("date",), "dcoilwtico", (d,))
        col["perishable"] = lookup("Items", ("item_nbr",), "perishable", (it,))
        col["cluster"] = lookup("Stores", ("store_nbr",), "cluster", (s,))
        self.names = list(SERVICE_FEATURES) + [SERVICE_LABEL]
        self.x = np.column_stack([col[a] for a in self.names])
        if not np.isfinite(self.x).all():
            raise AssertionError("a sale without its dimension rows")
        n = self.x.shape[0]
        lin = self.x.sum(0)
        self.c = np.empty((len(self.names) + 1,) * 2)
        self.c[0, 0], self.c[0, 1:], self.c[1:, 0] = n, lin, lin
        self.c[1:, 1:] = self.x.T @ self.x
        union = [np.concatenate([r.column(a).astype(np.float64) for r in store.relations()
                                 if a in r.keys or a in r.values]) for a in self.names]
        self.avg = np.array([u.mean() for u in union])
        self.mx = np.array([np.abs(u).max() for u in union])
        self.mx[self.mx == 0] = 1.0
        self.mx[-1] = 1.0  # the label is centred only
        a = np.diag(np.append(1.0, 1.0 / self.mx))  # [1, x] → [1, (x − avg) / max]
        a[0, 1:] = -self.avg / self.mx
        self.cz = a.T @ self.c @ a

    def _idx(self, feats):
        return [self.names.index(f) for f in feats]

    def cof(self, feats) -> np.ndarray:
        idx = [0] + [1 + i for i in self._idx(feats)]
        return self.c[np.ix_(idx, idx)]

    def theta(self, feats) -> np.ndarray:
        j, p = self._idx(feats), len(feats) + 1
        idx = [0] + [1 + i for i in j] + [len(self.names)]
        m = self.cz[np.ix_(idx, idx)]
        t = np.append(np.linalg.solve(m[:p, :p] + SERVICE_RIDGE * np.eye(p), m[:p, p]), -1.0)
        t[1:p] /= self.mx[j]
        t[0] += self.avg[-1] - t[1:p] @ self.avg[j]
        return t

    def scaled(self, theta, feats) -> np.ndarray:
        j, p = self._idx(feats), len(feats) + 1
        t = np.array(theta, np.float64)
        t[0] += t[1:p] @ self.avg[j] - self.avg[-1]
        t[1:p] *= self.mx[j]
        return t

    def predict(self, theta, feats) -> np.ndarray:
        w = np.zeros(len(self.names))  # one matvec over all the columns
        w[self._idx(feats)] = theta[1:1 + len(feats)]
        return theta[0] + self.x @ w

    def sse_scale(self, theta, feats) -> float:
        """Σ |a_i a_j C_ij| with a = [θ, −1]: the magnitude the score's
        quadratic form sums (its float32 rounding is relative to this)."""
        a = np.abs(np.asarray(theta))
        return float(a @ np.abs(self.cof(list(feats) + [SERVICE_LABEL])) @ a)

    def groups(self, attr, feats, degree) -> dict:
        """GROUP BY ``attr`` (integral values: ids, cluster numbers): count,
        Σx and (degree 2) Σx xᵀ of ``feats``."""
        col = self.x[:, self.names.index(attr)]
        v = col.astype(np.int64)
        if not np.array_equal(v, col):
            raise AssertionError(f"{attr}: group keys are not integers")
        present = np.bincount(v - v.min()) > 0
        keys = (np.flatnonzero(present) + v.min()).astype(np.float64)
        inv = (np.cumsum(present) - 1)[v - v.min()]
        x = self.x[:, self._idx(feats)]
        g = len(keys)
        out = dict(keys=keys, count=np.bincount(inv, minlength=g).astype(np.float64),
                   lin=np.stack([np.bincount(inv, x[:, j], g) for j in range(x.shape[1])], 1))
        if degree == 2:
            k = x.shape[1]
            out["quad"] = np.stack([
                np.stack([np.bincount(inv, x[:, i] * x[:, j], g) for j in range(k)], 1)
                for i in range(k)], 1)
        return out


def same_result(what, read, got, want, rtol, oracle) -> float:
    """One read's result against another run's, by the largest-entry rule
    of ``within``: a train by its predictions on every join row of
    ``oracle``'s catalog, a score against the magnitude its quadratic form
    sums."""
    _, kind, feats, extra = read
    if kind == "cofactors":
        return within(what, got.matrix(), want.matrix(), rtol)
    if kind == "train":
        return within(f"{what} predictions", oracle.predict(got.theta, feats),
                      oracle.predict(want.theta, feats), rtol)
    if kind == "score":
        return within(what, got.sse, want.sse, rtol, oracle.sse_scale(extra, feats))
    err = 0.0
    for name, blk in want.items():
        for part in ("count", "lin", "quad"):
            if getattr(blk, part) is not None:
                err = max(err, within(f"{what} {name}.{part}", getattr(got[name], part),
                                      getattr(blk, part), rtol))
    return err


def check_window(what, reads, tickets, oracle, theta_err: list) -> None:
    """Each read of a window against the float64 numpy of its catalog
    (Oracle64): cofactors and group sums within ORACLE_RTOL of the largest,
    a score within ORACLE_RTOL of the magnitude it sums, a train's θ in the
    scaled coordinates within THETA_RTOL of its largest coefficient and its
    predictions on every join row within PRED_RTOL of the largest; each
    train's relative error per coefficient goes to ``theta_err``."""
    for i, (read, t) in enumerate(zip(reads, tickets)):
        _, kind, feats, extra = read
        got, tag = t.result(), f"{what} read {i} ({kind})"
        if kind == "cofactors":
            within(tag, got.matrix(), oracle.cof(feats), ORACLE_RTOL)
        elif kind == "score":
            want = float(extra @ oracle.cof(list(feats) + [SERVICE_LABEL]) @ extra)
            within(tag, got.sse, want, ORACLE_RTOL, oracle.sse_scale(extra, feats))
        elif kind == "train":
            want = oracle.theta(feats)
            rel = np.abs(got.theta - want) / np.maximum(np.abs(want), 1e-12)
            scaled = within(f"{tag} scaled θ", oracle.scaled(got.theta, feats),
                            oracle.scaled(want, feats), THETA_RTOL)
            theta_err.append(dict(features=list(feats), rel_err=rel.tolist(),
                                  over=int((rel > THETA_RTOL).sum()), scaled_err=scaled))
            within(f"{tag} predictions", oracle.predict(got.theta, feats),
                   oracle.predict(want, feats), PRED_RTOL)
        else:
            for q in extra:
                want = oracle.groups(q.group_by[0], feats, q.degree)
                blk = got[q.name]
                np.testing.assert_array_equal(blk.keys[q.group_by[0]], want["keys"])
                np.testing.assert_array_equal(blk.count, want["count"])  # < 2^24 a group
                within(f"{tag} {q.name}.lin", blk.lin, want["lin"], ORACLE_RTOL)
                if q.degree == 2:
                    within(f"{tag} {q.name}.quad", blk.quad, want["quad"], ORACLE_RTOL)


def sync_counts(rt, svc) -> dict:
    """The launch counts once the service is between cycles: ``cache_info``
    takes the cycle lock, so no cycle or fold is running when it returns
    (and none starts: nothing is queued and no fold debt is left)."""
    svc.cache_info()
    return dict(rt.kops.launch_counts())


def step_seconds(timers) -> dict:
    s = timers.seconds
    return {"engine_and_traversal": s["__init__"] + s["run_batch"],
            "finish": s["_finish"], "writes": s["_apply_write"],
            "fold": s["_flush_pending"]}


def diff(after: dict, before: dict) -> dict:
    return {k: round(after[k] - before[k], 6) for k in after}


SERVICE_SCHEDULE = ("window1", "append", "window2")


def service_schedule(rt, store, bundle, windows, day, what, svc_kw=None, arm=None,
                     capture: bool = False, install=None) -> dict:
    """The schedule of phase 9 on one service over ``store``, its threaded
    runtime started: window 1 (``windows[0]``, from the eight client
    threads); a writer tenant appends ``day`` (one new day, in three
    tickets) and the idle policy folds it; window 2 (``windows[1]``);
    ``stop(drain=True)``.  ``install(svc)`` (the sanitized leg's) runs once
    the service is built and before its runtime starts; ``arm(step)`` (the
    fault leg's) runs before each step.  Launch counts, the cycle's step
    seconds and the store's counters are read at each step's end; with
    ``capture``, each step's segment kernel calls and their outputs
    (Capture, from the worker threads)."""
    svc = rt.FactorizedService(store, **(svc_kw or {}))
    out = dict(svc=svc, windows=[], launches={}, steps={}, calls={})
    if install is not None:
        install(svc)
    svc.start()
    rt.kops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    counts = dict(rt.kops.launch_counts())
    with Timers((rt.FactorizedEngine, SERVICE_ENGINE_STEPS),
                (type(svc), SERVICE_STEPS)) as timers:
        marks = [(counts, step_seconds(timers), store.node_visits, store.passes)]

        def mark(step):
            c = sync_counts(rt, svc)
            out["launches"][step] = diff(c, marks[-1][0])
            out["steps"][step] = diff(step_seconds(timers), marks[-1][1])
            out[f"node_visits_{step}"] = store.node_visits - marks[-1][2]
            out[f"passes_{step}"] = store.passes - marks[-1][3]
            marks.append((c, step_seconds(timers), store.node_visits, store.passes))

        for step in SERVICE_SCHEDULE:
            if arm is not None:
                arm(step)
            with (Capture(rt.kops, results=True) if capture
                  else contextlib.nullcontext()) as cap:
                if step == "append":
                    t = time.perf_counter()
                    writes = [svc.append("w", name, rel) for name, rel in day.items()]
                    for w in writes:
                        if not w.wait(SERVICE_WAIT_S):
                            raise AssertionError(f"{what}: an append not served")
                    deadline = time.monotonic() + SERVICE_WAIT_S
                    while svc.fold_debt_rows() > 0 and time.monotonic() < deadline:
                        time.sleep(0.01)
                    out["append"] = dict(tickets=writes, seconds=time.perf_counter() - t,
                                         rows={n: int(r.num_rows) for n, r in day.items()})
                else:
                    out["windows"].append(run_window(svc, bundle.vorder,
                                                     windows[len(out["windows"])]))
                mark(step)
            if capture:
                out["calls"][step] = (cap.calls, cap.outputs)
        svc.stop(drain=True, timeout=SERVICE_WAIT_S)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["info"] = svc.cache_info()
    out["quarantined"] = svc.quarantined()
    for step in SERVICE_SCHEDULE:
        log(f"{what}: {step} launches {out['launches'][step]} steps "
            + " ".join(f"{k}={v:.3f}s" for k, v in out["steps"][step].items())
            + f" passes={out[f'passes_{step}']} node_visits={out[f'node_visits_{step}']}")
    return out


def window_stats(win) -> dict:
    lat = sorted(win["latency"])
    return dict(wall_s=win["wall"], requests_per_s=len(lat) / win["wall"],
                latency_p50_s=statistics.median(lat), latency_p100_s=lat[-1])


def no_hidden_failures(what, run) -> None:
    """Every ticket resolved with a value, nothing quarantined (runtime
    errors included), no fold failed."""
    tickets = [t for w in run["windows"] for t in w["tickets"]] + run["append"]["tickets"]
    for t in tickets:
        if not t.done:
            raise AssertionError(f"{what}: a ticket left unresolved")
        t.result()  # raises the ticket's error
    if run["quarantined"] or run["info"]["fold_failures"]:
        raise AssertionError(f"{what}: quarantined {run['quarantined']}, "
                             f"fold failures {run['info']['fold_failures']}")


def tenant_audit(what, info, storms: bool = False) -> None:
    """Per-tenant shares sum to the store totals exactly (but the view
    cache's bytes where eviction storms drop them outside any request)."""
    totals = dict(passes=info["passes"], node_visits=info["node_visits"],
                  vc_hits=info["view_cache_hits"], vc_misses=info["view_cache_misses"])
    if not storms:
        totals["vc_bytes"] = info["view_cache_bytes"]
    for field, total in totals.items():
        got = sum(t[field] for t in info["tenants"].values())
        if got != total:
            raise AssertionError(f"{what}: tenants' {field} sum to {got}, store {total}")


def service_calls(rt, run, what: str = "phase 9") -> dict:
    """Each segment-kernel call the threaded service made (captured in each
    step, from its worker threads) again against its plain version, its
    own output too (captured_calls), with its bound and index_add_; per
    step and kernel, the calls' sums."""
    out = {}
    for step in SERVICE_SCHEDULE:
        calls, outputs = run["calls"].pop(step)
        log(f"{what} {step}: the service's kernel calls against their plain versions")
        got = captured_calls(rt, calls, outputs)
        out[step] = dict(nodes=got["nodes"], per_kernel=got["per_traversal"])
    return out


def service_leg1(rt, bundle, theta) -> dict:
    """Phase 9, leg 1: the service at full size on the card (see the module
    docstring)."""
    windows = service_reads(rt, bundle, theta, SEED + 9)
    store = rt.Store(bundle.store.relations())
    day = new_days(rt, store, store.attr_domain("date"), 1, np.random.default_rng(SEED + 3))
    t = time.perf_counter()
    run = service_schedule(rt, store, bundle, windows, day, "phase 9", capture=True)
    seconds = time.perf_counter() - t
    no_hidden_failures("phase 9", run)
    info = run["info"]
    tenant_audit("phase 9", info)
    for step in SERVICE_SCHEDULE:
        missing = [k for k in PHASE8_KERNELS if run["launches"][step][k] == 0]
        if missing:
            raise AssertionError(f"phase 9 {step}: kernels never launched: {missing}")
    counts = {k: sum(run["launches"][s][k] for s in run["launches"])
              for k in SERVICE_KERNELS}
    wins = [window_stats(w) for w in run["windows"]]
    log(f"phase 9: {seconds:.3f}s; windows {wins}; append {run['append']['seconds']:.3f}s "
        f"{run['append']['rows']}; coalesced_batches={info['coalesced_batches']} "
        f"coalesced_requests={info['coalesced_requests']} passes={info['passes']} "
        f"node_visits={info['node_visits']} drains={info['drains']} "
        f"peak={run['peak_bytes']} (the captured calls held)")
    calls = service_calls(rt, run)

    # correctness against the float64 numpy of each window's catalog
    theta_err = []
    t = time.perf_counter()
    pre = Oracle64(rt.Store(bundle.store.relations()))
    check_window("window 1", windows[0], run["windows"][0]["tickets"], pre, theta_err)
    merged = Oracle64(store)
    check_window("window 2", windows[1], run["windows"][1]["tickets"], merged, theta_err)
    log(f"phase 9 checks vs float64 numpy: {time.perf_counter() - t:.3f}s; train θ "
        f"coefficients over THETA_RTOL: {[e['over'] for e in theta_err]}; scaled θ "
        f"errors {[round(e['scaled_err'], 9) for e in theta_err]}")

    # the private arm: the first read of each kind in window 1 again (4 of
    # the 12: a train, a score, a cofactors and an aggregates read; all 12
    # until PR 26, cut for the smoke's time), one engine a read,
    # synchronously; every coalesced ticket of those reads (the same read
    # from another tenant too) against its private answer
    private = rt.FactorizedService(rt.Store(bundle.store.relations()), coalesce=False)
    keys = [read_key(r) for r in windows[0]]
    first_of_kind = {}
    for key, r in zip(keys, windows[0]):
        first_of_kind.setdefault(r[1], (key, r))
    tickets = {key: submit(private, bundle.vorder, r) for key, r in first_of_kind.values()}
    t = time.perf_counter()
    private.run()
    torch.cuda.synchronize()
    private_s = time.perf_counter() - t
    errs = [same_result(f"coalesced vs private read {i}", r, a.result(), tickets[key].result(),
                        ORACLE_RTOL, pre)
            for i, (r, a, key) in enumerate(zip(windows[0], run["windows"][0]["tickets"],
                                                keys)) if key in tickets]
    log(f"private arm: {len(tickets)} reads (one of each kind) of {len(keys)}, "
        f"{len(errs)} coalesced tickets compared, {private_s:.3f}s, "
        f"passes={private.store.passes}; coalesced vs private: largest error "
        f"{max(errs):.3e} of its scale")
    del private, tickets, pre

    # window 1's reads once more, coalesced, cold and profiled, on the
    # merged catalog (window 2's first 12)
    store.view_cache.evict_all()
    prof_svc = rt.FactorizedService(store)
    tickets = [submit(prof_svc, bundle.vorder, r) for r in windows[0]]
    torch.cuda.reset_peak_memory_stats()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t = time.perf_counter()
        prof_svc.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    busy = device_busy_ms(prof) / 1e3
    for i, (r, a, b) in enumerate(zip(windows[0], tickets, run["windows"][1]["tickets"])):
        same_result(f"profiled window read {i}", r, a.result(), b.result(), ORACLE_RTOL,
                    merged)
    log(f"profiled coalesced window: {wall:.3f}s, device busy {busy:.3f}s, "
        f"idle_share={1 - busy / wall:.4f}, peak {peak}")
    return dict(
        seconds=seconds, windows=wins, append_s=run["append"]["seconds"],
        append_rows=run["append"]["rows"], steps=run["steps"], launches=run["launches"],
        node_visits={s: run[f"node_visits_{s}"] for s in SERVICE_SCHEDULE},
        passes_by_step={s: run[f"passes_{s}"] for s in SERVICE_SCHEDULE},
        coalesced_batches=info["coalesced_batches"],
        coalesced_requests=info["coalesced_requests"], passes=info["passes"],
        node_visits_total=info["node_visits"], drains=info["drains"],
        private_s=private_s, coalesced_vs_private_err=max(errs),
        profiled_window=dict(wall_s=wall, busy_s=busy, idle_share=1 - busy / wall,
                             peak_bytes=peak),
        peak_bytes_calls_held=run["peak_bytes"], theta_rel_err=theta_err, counts=counts,
        calls=calls,
    )


def service_oracle(rt, theta) -> dict:
    """Phase 9, leg 2, on the oracle cell: the schedule on the float64 numpy
    service and on the card; then on the card again under a FaultInjector."""
    bundle = rt.favorita_like(1684, 54, 410, SALES_FRACTION, seed=SEED)
    windows = service_reads(rt, bundle, theta, SEED + 9)
    day = new_days(rt, bundle.store, bundle.store.attr_domain("date"), 1,
                   np.random.default_rng(SEED + 4))
    runs = {}
    for name, kw in (("numpy", dict(backend="numpy")), ("card", {})):
        store = rt.Store(bundle.store.relations())
        t = time.perf_counter()
        runs[name] = service_schedule(rt, store, bundle, windows, day,
                                      f"oracle cell, {name}", svc_kw=kw)
        runs[name]["seconds"] = time.perf_counter() - t
        runs[name]["store"] = store
        no_hidden_failures(f"oracle cell, {name}", runs[name])
        tenant_audit(f"oracle cell, {name}", runs[name]["info"])
    oracles = [Oracle64(rt.Store(bundle.store.relations())), Oracle64(runs["numpy"]["store"])]
    # the numpy θ is linear_regression's warm closed form (leg 1 holds the
    # card to the numpy alone: float64 traversals cost minutes there)
    cfg = dataclasses.replace(rt.VERSIONS["closed"], backend="numpy", use_cache=True,
                              ridge=SERVICE_RIDGE)
    lr_store = rt.Store(bundle.store.relations())
    for feats in sorted({r[2] for r in windows[0] if r[1] == "train"}):
        want = rt.linear_regression(lr_store, bundle.vorder, list(feats), SERVICE_LABEL,
                                    cfg).theta
        within(f"oracle cell: numpy θ over {feats} vs linear_regression",
               oracles[0].theta(feats), want, WARM_THETA_RTOL)
    del lr_store
    theta_err, errs = [], []
    for w, oracle in enumerate(oracles):
        win64, win32 = runs["numpy"]["windows"][w], runs["card"]["windows"][w]
        for i, (r, b) in enumerate(zip(windows[w], win64["tickets"])):
            if r[1] == "train":  # the float64 service is the numpy θ
                within(f"oracle cell window {w + 1} read {i}: numpy service θ vs numpy",
                       b.result().theta, oracle.theta(r[2]), WARM_THETA_RTOL)
        check_window(f"oracle cell, card, window {w + 1}", windows[w], win32["tickets"],
                     oracle, theta_err)
        errs += [same_result(f"oracle cell window {w + 1} read {i}: card vs numpy",
                             r, a.result(), b.result(), PRED_RTOL if r[1] == "train"
                             else ORACLE_RTOL, oracle)
                 for i, (r, a, b) in enumerate(zip(windows[w], win32["tickets"],
                                                   win64["tickets"]))]
    log(f"oracle cell: card vs numpy service: largest error {max(errs):.3e} of its scale; "
        f"train θ coefficients over THETA_RTOL: {[e['over'] for e in theta_err]}")
    faults = service_faults(rt, bundle, windows, day, runs["card"], oracles)
    sanitized = service_sanitized(rt, bundle, windows, day, runs["card"], oracles)
    return dict(
        numpy_s=runs["numpy"]["seconds"], card_s=runs["card"]["seconds"],
        card_windows=[window_stats(w) for w in runs["card"]["windows"]],
        numpy_windows=[window_stats(w) for w in runs["numpy"]["windows"]],
        card_vs_numpy_err=max(errs), theta_rel_err=theta_err,
        launches=runs["card"]["launches"], faults=faults, sanitized=sanitized,
    )


def service_faults(rt, bundle, windows, day, clean, oracles) -> dict:
    """The schedule on the card under a FaultInjector (seeded) with a
    RetryPolicy: eviction storms every 2 snapshots throughout; random
    node faults at FAULT_RATES in the two windows, a terminal trap at a
    coalesced window's third node visit, and the idle fold after the append
    poisoned.  Failed tickets must fail with an injected fault or
    ServiceStopped; the others equal the fault-free run's within 1e-4."""
    inj = rt.FaultInjector(rt.Store(bundle.store.relations()), seed=SEED)
    inj.arm_eviction_storms(every_snapshots=2)

    def arm(step):
        if step == "window1":
            inj.arm_random_node_faults(FAULT_RATES[0])
        elif step == "append":
            inj.arm_random_node_faults(0.0)
            inj.fail_next_fold()
        else:
            inj.arm_random_node_faults(FAULT_RATES[1])
            inj.fail_at_node_visit(3, transient=False)

    t = time.perf_counter()
    run = service_schedule(rt, inj, bundle, windows, day, "fault leg",
                           svc_kw=dict(retry=rt.RetryPolicy(max_attempts=3, backoff=0.001)),
                           arm=arm)
    seconds = time.perf_counter() - t
    if not inj.fired:
        raise AssertionError("fault leg: no fault fired")
    served = failed = 0
    for w, oracle in enumerate(oracles):
        got, want = run["windows"][w]["tickets"], clean["windows"][w]["tickets"]
        for i, (r, a, b) in enumerate(zip(windows[w], got, want)):
            try:
                value = a.result()
            except (rt.InjectedFault, rt.ServiceStopped):
                failed += 1
                continue
            served += 1
            same_result(f"fault leg window {w + 1} read {i} vs fault-free", r, value,
                        b.result(), ORACLE_RTOL, oracle)
    for t in run["append"]["tickets"]:
        t.result()
    info = run["info"]
    tenant_audit("fault leg", info, storms=True)
    kinds = sorted({k for k, _ in inj.fired})
    log(f"fault leg: {seconds:.3f}s; fired {len(inj.fired)} ({kinds}); served {served}, "
        f"failed {failed}; retries={info['retries']} fold_failures="
        f"{info['fold_failures']} quarantined={info['quarantined']}")
    return dict(seconds=seconds, fired=len(inj.fired), fired_kinds=kinds, served=served,
                failed=failed, retries=info["retries"], fold_failures=info["fold_failures"],
                quarantined=[q["kind"] for q in run["quarantined"]])


class HeldAtCall(Capture):
    """Capture's patching of the engine's segment-kernel calls, recording
    for each call the locks its thread held (the sanitizer's per-thread
    stack) in place of its arguments."""

    def __init__(self, kops, san):
        super().__init__(kops)
        self.san = san

    def _wrap(self, name, fn):
        def held(*args, **kwargs):
            with self.lock:
                self.calls.append((name, tuple(self.san._held.stack)))
            return fn(*args, **kwargs)
        return held


# the locks of the service and the store that leg 3 must see acquired
SANITIZED_LOCKS = ("FactorizedService._cycle_lock", "FactorizedService._lock",
                   "FactorizedService._stats_lock", "Store._mutate_lock",
                   "ViewCache._mu")


def service_sanitized(rt, bundle, windows, day, clean, oracles) -> dict:
    """Phase 9, leg 3: the oracle cell's schedule on the card once more,
    with the port's LockSanitizer installed once the service is built and
    before its runtime starts (the kernels' module-level ``_load_lock``
    wrapped too, and put back after).  The sanitizer's report must be
    empty; every lock of the service and the store acquired and its probes
    fired; segment_view and segment_reduce launched, each segment-kernel
    call made with the cycle lock held (the launch counters are exact
    under it); every read within leg 2's bounds of Oracle64 and within
    ORACLE_RTOL of the unsanitized card run's; then each of its segment-kernel
    calls again against its plain version (service_calls)."""
    san = rt.LockSanitizer()
    t = time.perf_counter()
    try:
        with HeldAtCall(rt.kops, san) as held:
            run = service_schedule(
                rt, rt.Store(bundle.store.relations()), bundle, windows, day,
                "sanitized leg", capture=True,
                install=lambda svc: san.install(service=svc, load_lock=True))
    finally:
        san.uninstall()
    seconds = time.perf_counter() - t
    san.assert_clean()  # raises: a report that is not empty fails the smoke
    no_hidden_failures("sanitized leg", run)
    tenant_audit("sanitized leg", run["info"])
    missing = [k for k in SANITIZED_LOCKS if not san.acquisitions.get(k)]
    if missing or san.accesses == 0:
        raise AssertionError(f"sanitized leg: locks never acquired {missing}, "
                             f"accesses {san.accesses}")
    launches = {k: sum(run["launches"][s][k] for s in SERVICE_SCHEDULE)
                for k in SERVICE_KERNELS}
    if not all(launches[k] for k in PHASE8_KERNELS):
        raise AssertionError(f"sanitized leg: kernels never launched: {launches}")
    unheld = [name for name, stack in held.calls
              if "FactorizedService._cycle_lock" not in stack]
    if unheld:
        raise AssertionError(f"sanitized leg: {len(unheld)} kernel calls outside the "
                             f"cycle lock: {sorted(set(unheld))}")
    theta_err, errs = [], []
    for w, oracle in enumerate(oracles):
        got, want = run["windows"][w]["tickets"], clean["windows"][w]["tickets"]
        check_window(f"sanitized leg, window {w + 1}", windows[w], got, oracle, theta_err)
        errs += [same_result(f"sanitized leg window {w + 1} read {i} vs unsanitized", r,
                             a.result(), b.result(), ORACLE_RTOL, oracle)
                 for i, (r, a, b) in enumerate(zip(windows[w], got, want))]
    acquisitions = dict(sorted(san.acquisitions.items()))
    card = card_line()
    log(f"phase 9 leg 3 (sanitized): {seconds:.3f}s on {card}; report empty; "
        f"acquisitions {acquisitions}; accesses {san.accesses}; launches {launches}; "
        f"{len(held.calls)} kernel calls, all under the cycle lock; vs unsanitized: "
        f"largest error {max(errs):.3e} of its scale")
    calls = service_calls(rt, run, "phase 9 leg 3")
    return dict(seconds=seconds, card=card, acquisitions=acquisitions,
                accesses=san.accesses, fields=len(san.field_stats()),
                launches=launches, launches_by_step=run["launches"],
                kernel_calls=len(held.calls),
                windows=[window_stats(w) for w in run["windows"]],
                vs_unsanitized_err=max(errs), theta_rel_err=theta_err, calls=calls)


def service_phase(rt, bundle, theta) -> tuple:
    """Phase 9: (JSON, launch counts of leg 1)."""
    t = time.perf_counter()
    leg1 = service_leg1(rt, bundle, theta)
    counts = leg1.pop("counts")
    log(f"phase 9 leg 1: {time.perf_counter() - t:.1f}s, launches {counts}")
    return leg1, counts


# -- phase 7: LM serving ---------------------------------------------------------

def plain_flash(chunked_attention):
    """A stand-in for ``ops.flash_attention`` that runs its plain version on
    the model's path, ``chunked_attention`` with arange query and key
    positions (patched in for the logits comparison only; it launches no
    kernel).  Queries and keys may differ in number (cross attention); every
    key is the model's (``kv_len`` = Sk)."""
    def run(q, k, v, *, causal, window, kv_len):
        b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
        if kv_len != sk:
            raise ValueError(f"model attention expected, got Sk {sk}, kv_len {kv_len}")
        qpos = torch.arange(sq, dtype=torch.int32, device=q.device)[None].expand(b, sq)
        kpos = torch.arange(sk, dtype=torch.int32, device=q.device)[None].expand(b, sk)
        return chunked_attention(q, k, v, qpos, kpos, causal=causal, window=window,
                                 out_dtype=q.dtype)
    return run


def lm_serve(lm, params, cfg, prompts) -> tuple:
    """Serve every prompt for LM_NEW tokens; ({uid: Result}, wall seconds)."""
    eng = lm.Engine(params, cfg, lm.ServeConfig(**LM_SERVE, seed=SEED))
    for uid, prompt in enumerate(prompts):
        eng.submit(lm.Request(uid=uid, tokens=prompt, max_new_tokens=LM_NEW))
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if sorted(r.uid for r in results) != list(range(len(prompts))):
        raise AssertionError("the engine lost a request")
    for r in results:
        if len(r.tokens) != LM_NEW or not all(0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"request {r.uid}: bad tokens {r.tokens}")
    return {r.uid: r for r in results}, wall


def count_flash(lm, what, fn, expect) -> tuple:
    """Run ``fn`` between a counter reset and a read; flash must have
    launched ``expect`` times.  Returns (``fn``'s result, {"flash": its
    launches, "flash_f32": the float32 ones among them})."""
    lm.kops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: lm.kops.launch_counts()[k] for k in ("flash", "flash_f32")}
    n = counts["flash"]
    log(f"{what}: flash launches {n} (expected {expect}), float32 {counts['flash_f32']}")
    if n != expect:
        raise AssertionError(f"{what}: flash launched {n} times, expected {expect}")
    return out, counts


def bf16_forward_check(lm, params, cfg, float32, batch, launches=None) -> dict:
    """The serving dtype end to end: bf16 forward logits at every position of
    ``batch`` through flash against the plain ``chunked_attention`` path, both
    held to the float32 model on the same weights (on the plain path too, so
    that no kernel is in the baseline).  ``float32()`` gives that model and
    its config; it is called after the bf16 logits, so it may convert
    ``params`` in place.  flash must launch ``launches`` times (default: once
    a layer).  Returns the per-position relative errors."""
    v = cfg.vocab

    def logits(p, c):
        with torch.no_grad():
            return lm.forward(p, batch, c)[0][0, :, :v]

    kern, counts = count_flash(lm, "bf16 forward", functools.partial(logits, params, cfg),
                               cfg.n_layers if launches is None else launches)
    with mock.patch.object(lm.kops, "flash_attention", plain_flash(lm.chunked_attention)):
        plain, _ = count_flash(lm, "bf16 forward, plain path",
                               functools.partial(logits, params, cfg), 0)
        params32, cfg32 = float32()
        full, _ = count_flash(lm, "float32 forward, plain path",
                              functools.partial(logits, params32, cfg32), 0)

    def rel(a, b):  # per position ‖a − b‖ / ‖b‖
        return (a - b).norm(dim=-1) / b.norm(dim=-1)

    k_p, k_32, p_32 = rel(kern, plain), rel(kern, full), rel(plain, full)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    for what, r in (("flash vs plain", k_p), ("flash vs float32", k_32),
                    ("plain vs float32", p_32)):
        log(f"bf16 forward logits {what}: per-position relative error median "
            f"{float(r.median()):.3e} max {float(r.max()):.3e}")
    log(f"bf16 forward: flash and plain argmax agree at {agree:.4f} of "
        f"{kern.shape[0]} positions")
    if not bool(torch.isfinite(kern).all()):
        raise AssertionError("bf16 forward logits through flash are not finite")
    for stat in ("max", "mean"):
        got, base = float(getattr(k_32, stat)()), float(getattr(p_32, stat)())
        if not got <= BF16_FAR_RATIO * base:
            raise AssertionError(
                f"bf16 forward: flash {stat} error vs float32 {got:.3e} over "
                f"{BF16_FAR_RATIO} x the plain path's {base:.3e}")
    if not float(k_p.max()) <= BF16_NEAR_RATIO * float(p_32.max()):
        raise AssertionError(
            f"bf16 forward: flash vs plain path {float(k_p.max()):.3e} over "
            f"{BF16_NEAR_RATIO} x the plain path's distance from float32")
    return {what: dict(median=float(r.median()), max=float(r.max()), mean=float(r.mean()))
            for what, r in (("flash_vs_plain", k_p), ("flash_vs_float32", k_32),
                            ("plain_vs_float32", p_32))} | dict(argmax_agree=agree,
                                                                  launches=counts)


def greedy_ties(lm, params32, cfg32, prompts, res32) -> list:
    """Each request's greedy tokens held to a teacher-forced full forward
    of its prompt and tokens: every pick must be the oracle's top logit, or
    within NEAR_TIE of it (a near-tie, returned as (uid, step, gap))."""
    ties = []
    for uid, prompt in enumerate(prompts):
        gen = res32[uid].tokens
        seq = torch.tensor([prompt + gen[:-1]], device="cuda")
        with torch.no_grad():
            logits, _ = lm.forward(params32, {"tokens": seq}, cfg32)
        steps = logits[0, len(prompt) - 1 :, : cfg32.vocab]
        top = steps.max(dim=-1).values
        picked = steps[torch.arange(len(gen), device="cuda"), torch.tensor(gen, device="cuda")]
        gap = (top - picked).cpu().numpy()
        for t in np.nonzero(gap > 0)[0]:
            ties.append((uid, int(t), float(gap[t])))
            if not gap[t] < NEAR_TIE:
                raise AssertionError(
                    f"request {uid} step {t}: engine picked {gen[t]}, "
                    f"{gap[t]:.3e} under the oracle's top logit")
    return ties


def lm_phase(lm) -> dict:
    cfg = lm.get_config(LM_ARCH)
    t = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, {n_params} parameters, {time.perf_counter() - t:.2f}s to draw")
    rng = np.random.RandomState(SEED)
    prompts = [
        [int(x) for x in rng.randint(1, cfg.vocab, size=rng.randint(LM_PROMPT[0], LM_PROMPT[1] + 1))]
        for _ in range(LM_REQUESTS)
    ]
    log(f"prompt lengths {[len(p) for p in prompts]}")
    per_prefill = cfg.n_layers
    # warm-up (cuBLAS handles, allocator): one short request, uncounted
    warm = lm.Engine(params, cfg, lm.ServeConfig(**LM_SERVE))
    warm.submit(lm.Request(uid=0, tokens=prompts[0][:2_100], max_new_tokens=2))
    warm.run()
    del warm

    # the serving path, bf16
    torch.cuda.reset_peak_memory_stats()
    (res, wall), launches = count_flash(
        lm, "bf16 serve", functools.partial(lm_serve, lm, params, cfg, prompts),
        per_prefill * LM_REQUESTS)
    gen_tokens = sum(len(r.tokens) for r in res.values())
    lat = sorted(r.latency_s for r in res.values())
    log(f"bf16 serve: {len(res)} requests, {gen_tokens} tokens in {wall:.3f}s "
        f"({gen_tokens / wall:.1f} tok/s); latency p50 {lat[len(lat) // 2]:.3f}s "
        f"p100 {lat[-1]:.3f}s; max_memory_allocated={torch.cuda.max_memory_allocated()}")
    toks = np.zeros((1, LM_SERVE["prefill_len"]), np.int64)
    toks[0, : len(prompts[0])] = prompts[0]
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    prefill = functools.partial(lm.prefill, params, batch, cfg, LM_SERVE["max_len"])
    prefill_ms = time_ms(prefill, reps=5)
    cache = lm.init_cache(cfg, LM_SERVE["slots"], LM_SERVE["max_len"])
    step = torch.ones((LM_SERVE["slots"], 1), dtype=torch.long, device="cuda")
    decode = functools.partial(lm.decode_step, params, step, cache, 3_000, cfg)
    decode_ms = time_ms(decode)
    log(f"bf16 prefill of {LM_SERVE['prefill_len']} tokens {prefill_ms:.3f} ms; decode step "
        f"({LM_SERVE['slots']} slots, {LM_SERVE['max_len']}-slot cache) {decode_ms:.3f} ms")
    # device time of one prefill and one decode step, against their
    # unprofiled CUDA-event times above (the profiler's own host cost
    # would inflate a profiled wall time)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for what, fn, ms in (("prefill", prefill, prefill_ms), ("decode step", decode, decode_ms)):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        ops = device_ops(prof)
        busy = sum(us for _, us in ops) / 1e3
        flash_ms = sum(us for name, us in ops if "flash_" in name) / 1e3
        log(f"bf16 {what}: device busy {busy:.3f} ms of {ms:.3f} ms (idle share "
            f"{1 - busy / ms:.4f}); flash {flash_ms:.3f} ms; {sum(1 for _ in ops)} kernel kinds")
        for name, us in ops[:6]:
            log(f"  device {us / 1e3:10.3f} ms  {name[:90]}")
    del cache

    # the same weights in float32: greedy tokens against the full-forward oracle
    cfg32 = dataclasses.replace(cfg, dtype_name="float32", param_dtype_name="float32")
    params32 = copy.deepcopy(params).float()
    (res32, wall32), _ = count_flash(
        lm, "float32 serve", functools.partial(lm_serve, lm, params32, cfg32, prompts),
        per_prefill * LM_REQUESTS)
    same = sum(a == b for u in res for a, b in zip(res[u].tokens, res32[u].tokens))
    log(f"float32 serve: {wall32:.3f}s; bf16 and float32 agree on {same} of "
        f"{gen_tokens} tokens")

    ties, _ = count_flash(
        lm, "float32 oracle forwards",
        functools.partial(greedy_ties, lm, params32, cfg32, prompts, res32),
        per_prefill * LM_REQUESTS)
    log(f"float32 greedy tokens vs full-forward oracle: {LM_REQUESTS * LM_NEW - len(ties)} "
        f"of {LM_REQUESTS * LM_NEW} equal; near-ties {ties}")

    # the prefill's last logits: flash vs the plain chunked path, on the card
    kernel_logits, _ = lm.prefill(params32, batch, cfg32, LM_SERVE["max_len"])
    with mock.patch.object(lm.kops, "flash_attention", plain_flash(lm.chunked_attention)):
        (plain_logits, _), _ = count_flash(
            lm, "float32 prefill, plain path",
            functools.partial(lm.prefill, params32, batch, cfg32, LM_SERVE["max_len"]), 0)
    err = float((kernel_logits - plain_logits).abs().max())
    scale = float(plain_logits.abs().max())
    log(f"float32 prefill last logits, flash vs chunked_attention: max_abs_err={err:.3e} "
        f"tol={LOGIT_RTOL * scale:.3e}")
    if not (torch.isfinite(kernel_logits).all() and err <= LOGIT_RTOL * scale):
        raise AssertionError(f"prefill logits: flash vs plain path {err} > {LOGIT_RTOL * scale}")
    bf16_forward_check(lm, params, cfg, lambda: (params32, cfg32), batch)
    return launches


# -- phase 10: distribution at world size 1 -------------------------------------

DIST_KERNELS = ("gram", "multi_segment_gram")
# sharded vs factorized cofactors, of the largest: both float32 sums of the
# 18.6 M rows, in two orders (the kernels' blocks against the engine's
# nodes); the same bound as every float32-vs-float32 cofactor check here
DIST_RTOL = ORACLE_RTOL
DIST_PSUM_TREE = {"w": (576, 1_536), "b": (576,)}  # an MLP weight and a norm scale


class SyncTimers(Timers):
    """Timers that count the device work of the callables too: the device
    is synchronised before and after each call."""

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                return out
            finally:
                self.seconds[name] += time.perf_counter() - t0
        return timed


def dist_call(rt, what: str, fn) -> tuple:
    """(fn(), its seconds by step): the kernels and the all-reduces (each
    synchronised), and the rest — slicing and padding the rows on the host,
    the copies to and from the card, the pair counts' scatter."""
    with SyncTimers((rt.kops, DIST_KERNELS), (rt.dist, ("all_reduce",))) as tm:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    kernels = sum(tm.seconds[k] for k in DIST_KERNELS)
    sec = dict(total=total, kernels=kernels, all_reduce=tm.seconds["all_reduce"],
               host_and_copies=total - kernels - tm.seconds["all_reduce"])
    log(f"{what}: {total:.3f}s (kernels {kernels:.4f}s, all_reduce "
        f"{tm.seconds['all_reduce']:.4f}s, host slicing, copies and scatter "
        f"{sec['host_and_copies']:.3f}s)")
    return out, sec


def dist_calls(rt, calls, outputs) -> dict:
    """Each captured ``gram`` / ``multi_segment_gram`` call of phase 10: its
    own output and a second call against the plain version in float64 on
    the same values (KERNEL_RTOL of the largest), timed per call and back
    to back beside the plain version, the bound and, for gram, ``x.T @ x``."""
    kops, ref = rt.kops, rt.ref
    rows = {name: [] for name in DIST_KERNELS}
    for (name, args, _), out in zip(calls, outputs):
        x = args[0]
        m, k = x.shape
        if name == "gram":
            kern = functools.partial(kops.gram, x)
            plain = functools.partial(ref.gram_ref, x)
            want, own, groups = [ref.gram_ref(x.double())], [out], None
            b, by = bound_ms(m * k * 4 + k * k * 4, m * k * (k + 1))
            library = time_ms(functools.partial(library_gram, x))
        else:
            ids, groups = args[1], [int(g) for g in args[2]]
            kern = functools.partial(kops.multi_segment_gram, x, ids, groups)
            plain = functools.partial(ref.multi_segment_gram_ref, x, ids, groups)
            want, own = ref.multi_segment_gram_ref(x.double(), ids, groups), out
            b, by = gram_bound(x, len(groups), sum(groups))
            library = None
        again = kern()
        again = again if isinstance(again, list) else [again]
        err_own, scale = max_err([g.double() for g in own], want)
        err, _ = max_err([g.double() for g in again], want)
        tol = KERNEL_RTOL * max(1.0, scale)
        if not max(err, err_own) <= tol:
            raise AssertionError(f"phase 10 {name} M {m} K {k}: error {max(err, err_own)} > {tol}")
        del want, again
        row = dict(rows=m, k=k, groups=groups, max_abs_err=max(err, err_own), tol=tol,
                   ms=time_ms(kern), ms_back_to_back=time_ms_back_to_back(kern),
                   plain_ms=time_ms(plain, reps=3), bound_ms=b, bound_by=by,
                   library_ms=library)
        log(f"  {name} M {m} K {k} G {groups}: ms={row['ms']:.4f} back-to-back "
            f"{row['ms_back_to_back']:.4f} plain_ms={row['plain_ms']:.4f} bound_ms={b:.4f} "
            f"({by}) library_ms={library} max_abs_err={row['max_abs_err']:.3e} tol={tol:.3e}")
        rows[name].append(row)
    return rows


def dist_checks(rt, mesh, inp) -> dict:
    D = rt.distributed
    x, cols, x_cont, ids = inp["x"], inp["cols"], inp["x_cont"], inp["ids"]
    cont, doms, cat = inp["cont"], inp["domains"], list(CAT)
    last = inp["date"] == inp["date"].max()
    rest = ~last
    log(f"phase 10: {x.shape[0]} rows ({int(last.sum())} of the last date), continuous "
        f"{cols}, categorical {cat} over {cont}")
    seconds, errs = {}, {}
    rt.kops.reset_launch_counts()
    with Capture(rt.kops, DIST_KERNELS, results=True) as cap:
        cof, seconds["sharded_cofactors"] = dist_call(
            rt, "sharded_cofactors", functools.partial(D.sharded_cofactors, x, cols, mesh))
        errs["sharded_cofactors"] = within(
            "sharded_cofactors vs phase 4's factorized", cof.matrix(),
            inp["cofactors"].matrix(), DIST_RTOL)
        cats, seconds["sharded_cat_cofactors"] = dist_call(
            rt, "sharded_cat_cofactors",
            functools.partial(D.sharded_cat_cofactors, x_cont, ids, cont, cat, doms, mesh))
        errs["sharded_cat_cofactors"] = within(
            "sharded_cat_cofactors vs phase 4's factorized", cats.matrix(),
            inp["cat_cofactors"].matrix(), DIST_RTOL)
        base, seconds["base_cofactors"] = dist_call(
            rt, "sharded_cofactors (all but the last date)",
            functools.partial(D.sharded_cofactors, x[rest], cols, mesh))
        inc, seconds["incremental_sharded_cofactors"] = dist_call(
            rt, "incremental_sharded_cofactors (the last date)",
            functools.partial(D.incremental_sharded_cofactors, base, x[last], mesh))
        errs["incremental_sharded_cofactors"] = within(
            "incremental vs whole sharded cofactors", inc.matrix(), cof.matrix(), DIST_RTOL)
        cbase, seconds["base_cat_cofactors"] = dist_call(
            rt, "sharded_cat_cofactors (all but the last date)",
            functools.partial(D.sharded_cat_cofactors, x_cont[rest], ids[rest], cont, cat,
                              doms, mesh))
        cinc, seconds["incremental_sharded_cat_cofactors"] = dist_call(
            rt, "incremental_sharded_cat_cofactors (the last date)",
            functools.partial(D.incremental_sharded_cat_cofactors, cbase, x_cont[last],
                              ids[last], mesh))
        errs["incremental_sharded_cat_cofactors"] = within(
            "incremental vs whole sharded categorical cofactors", cinc.matrix(),
            cats.matrix(), DIST_RTOL)
    torch.cuda.synchronize()
    counts = {k: rt.kops.launch_counts()[k] for k in DIST_KERNELS}
    log(f"phase 10 launches={counts}; errors of the largest {errs} (tol {DIST_RTOL})")
    missing = [k for k in DIST_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched in phase 10: {missing}")

    # compressed_psum on the card's group of one: the int8 gather of one
    # rank is the plain round trip
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tree = {k: torch.randn(shape, device="cuda", generator=gen) for k, shape in DIST_PSUM_TREE.items()}
    got, got_err = rt.comp.compressed_psum(tree, rt.comp.init_error_state(tree), ("data",), mesh)
    same, same_err = rt.comp.compress_decompress(tree, rt.comp.init_error_state(tree))
    for k in tree:
        if not (torch.equal(got[k], same[k]) and torch.equal(got_err[k], same_err[k])):
            raise AssertionError(f"compressed_psum at world size 1, leaf {k}: not the round trip")
    log("compressed_psum at world size 1 equals compress_decompress on every leaf")
    calls = dist_calls(rt, cap.calls, cap.outputs)
    return dict(rows=int(x.shape[0]), last_date_rows=int(last.sum()), seconds=seconds,
                errors=errs, tol=DIST_RTOL, launches=counts, calls=calls,
                compressed_psum="equal")


def dist_phase(rt, inp) -> dict:
    """Phase 10: a world of one rank on NCCL (a ``FileStore`` rendezvous in
    a scratch directory of the checkout), a ``("data",)`` mesh of 1."""
    from torch.distributed.device_mesh import init_device_mesh

    with tempfile.TemporaryDirectory(prefix=".smoke-dist-", dir=ROOT) as d:
        rt.dist.init_process_group(
            "nccl", store=rt.dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
            return dist_checks(rt, mesh, inp)
        finally:
            rt.dist.destroy_process_group()


# -- phase 11: LM training --------------------------------------------------------

# 10 steps (20 until phase 11's 4,096-token and mesh legs needed the
# smoke's time, 30 until phase 12 did), checkpoint at 5
TRAIN_STEPS, TRAIN_CKPT_STEP, TRAIN_COMPRESS_STEPS = 10, 5, 5
TRAIN_ARGV = ["--arch", LM_ARCH, "--batch", "8", "--seq", "128", "--dtype", "float32",
              "--device", "cuda", "--seed", str(SEED)]
# one step on the card against the same step on the CPU, float32 both (TF32
# off): the loss is a mean over 1,024 tokens of a 49,152-way log-sum-exp and
# the grad norm a sum over 134.5 M squares, each float32 sums in another
# order (~1e-6 relative); a parameter moves by lr·m̂/(√v̂ + eps) under AdamW,
# at most about the learning rate a step, so two right updates differ by a
# small part of it, 1e-2·lr (near-zero grads carry most of the difference:
# there the update's slope in g is lr/eps); the moments of each leaf to
# 1e-4 of its largest
TRAIN_LOSS_RTOL = 1e-5
TRAIN_NORM_RTOL = 1e-4
TRAIN_PARAM_ATOL_LR = 1e-2  # of the peak learning rate
TRAIN_MOMENT_RTOL = 1e-4
# the resumed run against the uninterrupted one from the same checkpointed
# state and batches: the card's embedding backward adds with atomics, so
# grads differ in their last bits and the difference grows over 15 steps
TRAIN_RESUME_RTOL = 1e-4


def leaf_errors(tr, got, want) -> list:
    """(max |got − want|, max |want|) of each leaf, on the CPU."""
    out = []
    for a, b in zip(tr.tree_leaves(got), tr.tree_leaves(want)):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        out.append((float((a - b).abs().max()), float(b.abs().max())))
    return out


def compare_step(tr, n, card, cm, host, hm, hp) -> dict:
    """Step ``n`` on the card against the same step on the CPU."""
    loss, hloss = float(cm["loss"]), float(hm["loss"])
    norm, hnorm = float(cm["grad_norm"]), float(hm["grad_norm"])
    loss_err, norm_err = abs(loss - hloss) / abs(hloss), abs(norm - hnorm) / abs(hnorm)
    param_err = max(e for e, _ in leaf_errors(tr, card.params, host.params))
    moment_err = max(e / s for e, s in leaf_errors(tr, card.opt_state, host.opt_state) if s)
    row = dict(step=n, loss=loss, cpu_loss=hloss, loss_rel_err=loss_err, grad_norm=norm,
               cpu_grad_norm=hnorm, grad_norm_rel_err=norm_err, param_max_abs_err=param_err,
               param_atol=TRAIN_PARAM_ATOL_LR * hp.peak_lr, moment_max_rel_err=moment_err,
               cpu_capability=torch.backends.cpu.get_cpu_capability())
    log(f"step {n} card vs CPU: loss {loss:.6f} / {hloss:.6f} (rel {loss_err:.2e}), grad_norm "
        f"{norm:.6f} / {hnorm:.6f} (rel {norm_err:.2e}), params max |Δ| {param_err:.3e} "
        f"(atol {row['param_atol']:.1e}), moments {moment_err:.2e} of the largest; CPU "
        f"capability {row['cpu_capability']}")
    if not (loss_err <= TRAIN_LOSS_RTOL and norm_err <= TRAIN_NORM_RTOL
            and param_err <= row["param_atol"] and moment_err <= TRAIN_MOMENT_RTOL):
        raise AssertionError(f"training step {n}: the card and the CPU disagree: {row}")
    return row


def step_stats(history, batch_tokens: int) -> dict:
    """Median step ms over the steps after the first (which builds cuBLAS
    handles and grows the allocator) and tokens/s at that median."""
    secs = [h["sec"] for h in history[1:]]
    med = statistics.median(secs)
    return dict(steps=len(history), step_ms_median=med * 1e3, step_ms_max=max(secs) * 1e3,
                first_step_ms=history[0]["sec"] * 1e3, tokens_per_s=batch_tokens / med)


def train_phase(tr) -> dict:
    argv = TRAIN_ARGV + ["--steps", str(TRAIN_STEPS)]
    args, cfg, hp, pipe = tr.setup(argv)
    tokens = args.batch * args.seq
    t = time.perf_counter()
    state = tr.init_state(args.seed, cfg, hp, device="cuda")
    n_params = sum(p.numel() for p in tr.tree_leaves(state.params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.param_dtype} params "
        f"and activations, {n_params} parameters, microbatches {cfg.microbatches}, "
        f"{cfg.optimizer}, peak lr {hp.peak_lr}, warmup {hp.warmup_steps}, "
        f"{time.perf_counter() - t:.2f}s to draw")

    # step 2 on the card and, from a copy of the same state, on the CPU: the
    # first step with a learning rate (warmup_cosine gives 0 at step 0, so
    # step 1 moves no parameter)
    step = tr.make_train_step(cfg, hp)
    state, _ = step(state, pipe.batch_at(0))
    host = tr.tree_map(lambda x: x.to("cpu"), state)
    batch = pipe.batch_at(1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    host, hm = step(host, batch)
    cpu_s = time.perf_counter() - t
    check = dict(compare_step(tr, 2, state, m, host, hm, hp), card_s=card_s, cpu_s=cpu_s)
    del state, host

    with tempfile.TemporaryDirectory(prefix=".smoke-train-", dir=ROOT) as d:
        a, b = os.path.join(d, "a"), os.path.join(d, "b")
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        whole = tr.run(argv + ["--checkpoint-dir", a, "--checkpoint-every",
                               str(TRAIN_CKPT_STEP)], log=log)
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in whole.history]
        if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"training: {len(losses)} steps, losses {losses}")
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        if not last5 < first5:
            raise AssertionError(f"training: loss did not fall ({first5} -> {last5})")
        ckpt = f"step_{TRAIN_CKPT_STEP:06d}"
        if tr.latest_step(a) != TRAIN_STEPS or not os.path.isdir(os.path.join(a, ckpt)):
            raise AssertionError(f"training: checkpoints {sorted(os.listdir(a))}")
        # resume from the async checkpoint alone, in a fresh state
        os.makedirs(b)
        os.rename(os.path.join(a, ckpt), os.path.join(b, ckpt))
        shutil.rmtree(a)
        with open(os.path.join(b, "LATEST"), "w") as f:
            f.write(ckpt)
        resumed = tr.run(argv + ["--checkpoint-dir", b, "--checkpoint-every",
                                 str(TRAIN_CKPT_STEP)], log=log)
    if resumed.resumed_from != TRAIN_CKPT_STEP or [h["step"] for h in resumed.history] != list(
            range(TRAIN_CKPT_STEP, TRAIN_STEPS)):
        raise AssertionError(f"resume: from {resumed.resumed_from}, steps "
                             f"{[h['step'] for h in resumed.history]}")
    again = np.array([h["loss"] for h in resumed.history])
    resume_err = float(np.max(np.abs(again - losses[TRAIN_CKPT_STEP:]) /
                              np.abs(losses[TRAIN_CKPT_STEP:])))
    param_err = max(e for e, _ in leaf_errors(tr, resumed.state.params, whole.state.params))
    log(f"resumed at step {TRAIN_CKPT_STEP}: losses within {resume_err:.3e} of the "
        f"uninterrupted run's (rtol {TRAIN_RESUME_RTOL}); final params max |Δ| {param_err:.3e}")
    if not resume_err <= TRAIN_RESUME_RTOL:
        raise AssertionError(f"resume: losses {again} vs {losses[TRAIN_CKPT_STEP:]}")
    del resumed

    squeezed = tr.run(TRAIN_ARGV + ["--steps", str(TRAIN_COMPRESS_STEPS), "--compress-grads"],
                      log=log)
    closs = [h["loss"] for h in squeezed.history]
    if (len(closs) != TRAIN_COMPRESS_STEPS or not np.all(np.isfinite(closs))
            or not np.mean(closs[-3:]) < closs[0]):
        raise AssertionError(f"compressed-gradient training: losses {closs}")
    stats = step_stats(whole.history, tokens)
    # one more step of the trained state, profiled on the device alone (the
    # host-side trace of a step's ~100 k ops would cost tens of seconds):
    # device busy against the unprofiled median, and the kernels, copies and
    # fills the device ran
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(whole.state, pipe.batch_at(TRAIN_STEPS))
        torch.cuda.synchronize()
    ops = device_ops(prof)
    busy = sum(us for _, us in ops) / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU
                   and e.self_device_time_total > 0)
    stats.update(device_busy_ms=busy, idle_share=1 - busy / stats["step_ms_median"],
                 device_ops=launches,
                 top_device_ops=[(name[:80], us / 1e3) for name, us in ops[:6]])
    log(f"a profiled step: device busy {busy:.1f} ms of the {stats['step_ms_median']:.1f} ms "
        f"median (idle share {stats['idle_share']:.3f}), {launches} device kernels, copies "
        f"and fills")
    for name, us in ops[:6]:
        log(f"  device {us / 1e3:10.3f} ms  {name[:90]}")
    del prof
    log(f"training: {TRAIN_STEPS} steps in {wall:.1f}s, step {stats['step_ms_median']:.1f} ms "
        f"(median), {stats['tokens_per_s']:.0f} tokens/s, loss {first5:.4f} -> {last5:.4f} "
        f"(means of the first and last 5), peak memory {peak}")
    return dict(arch=cfg.name, params=n_params, batch=args.batch, seq=args.seq,
                microbatches=cfg.microbatches, dtype=str(cfg.param_dtype), card_vs_cpu=check,
                losses=losses, loss_first5=first5, loss_last5=last5, wall_s=wall,
                max_memory_allocated=peak, **stats,
                resume=dict(from_step=TRAIN_CKPT_STEP, loss_max_rel_err=resume_err,
                            rtol=TRAIN_RESUME_RTOL, final_param_max_abs_err=param_err),
                compressed=dict(losses=closs, **step_stats(squeezed.history, tokens)))


# phase 11's legs over the 2,048-token threshold and on a mesh: one float32
# step of 1 x 4,096 tokens held to the plain chunked path on the card, a
# bf16 run at 4 x 4,096 in 4 microbatches, and --mesh 1x1 against no mesh
LONG_TRAIN_ARGV = ["--arch", LM_ARCH, "--batch", "1", "--seq", "4096", "--microbatches", "1",
                   "--dtype", "float32", "--device", "cuda", "--seed", str(SEED), "--steps", "1"]
# kernels vs the plain chunked path, float32 both: the loss a mean over 4,095
# tokens of 49,152-way log-sum-exps, attention's sums in other orders
LONG_LOSS_RTOL = 1e-6
LONG_NORM_RTOL = 1e-5
LONG_LEAF_RTOL = 1e-4  # of each leaf's largest gradient
# 6 steps (10 until PR 25): ten steps of the wgmma backward's step (0.906 s,
# host-bound) would cost more than PR 25's six of 1.370 s did
BF16_TRAIN_STEPS = 6
BF16_TRAIN_ARGV = ["--arch", LM_ARCH, "--batch", "4", "--seq", "4096", "--microbatches", "4",
                   "--device", "cuda", "--seed", str(SEED), "--steps", str(BF16_TRAIN_STEPS)]
MESH_TRAIN_STEPS = 3
# one rank on NCCL: the same sums, DTensor around them
MESH_RTOL = 1e-5


def plain_flash_fn(chunked_attention):
    """A stand-in for ``ops.flash_attention_fn`` that runs its plain version,
    ``chunked_attention`` over arange positions, under activation
    checkpointing (else autograd would keep every chunk's probabilities: ~72
    GB at 30 layers of 4,096 tokens).  Launches no kernel."""
    plain = plain_flash(chunked_attention)

    def run(q, k, v, *, causal, window, kv_len):
        return torch.utils.checkpoint.checkpoint(
            functools.partial(plain, causal=causal, window=window, kv_len=kv_len),
            q, k, v, use_reentrant=False)
    return run


def tree_grads(tr, cfg, params, batch) -> tuple:
    """(loss, grads by leaf) of the train step's loss on ``batch``, as its
    ``grad_fn`` differentiates: ``functional_call`` over the tree's views."""
    leaves = [p.detach().requires_grad_(True) for p in tr.tree_leaves(params)]
    views = tr.tree_views(tr.tree_unflatten(params, leaves), cfg)
    with torch.enable_grad():
        loss, _ = torch.func.functional_call(
            tr.TreeLoss(cfg), {f"model.{n}": t for n, t in views.items()}, (batch,))
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), grads


def long_step_leg(tr) -> dict:
    """One float32 microbatch of 1 x 4,096 tokens at full width and depth:
    loss and gradients through the kernels (flash and flash_bwd exactly
    once a layer, counted from zero) against the same step through the
    plain ``chunked_attention`` on the card (no kernel launched); then the
    step once more under the profiler, which must show flash_bwd's kernels
    and flash's, its 3xTF32 ``flash_tf32_kernel`` by name."""
    args, cfg, hp, pipe = tr.setup(LONG_TRAIN_ARGV)
    state = tr.init_state(args.seed, cfg, hp, device="cuda")
    batch = pipe.batch_at(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.kops.reset_launch_counts()
    t = time.perf_counter()
    loss, grads = tree_grads(tr, cfg, state.params, batch)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t
    counts = tr.kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    launches = {name: counts[name] for name in ("flash", "flash_bwd", "flash_f32")}
    log(f"1 x 4,096 float32 step: launches {launches} (expected {cfg.n_layers} each), "
        f"{kernel_s:.2f}s, peak memory {peak}")
    if launches != {"flash": cfg.n_layers, "flash_bwd": cfg.n_layers,
                    "flash_f32": cfg.n_layers}:
        raise AssertionError(f"1 x 4,096 step: launches {launches}, expected "
                             f"{cfg.n_layers} of flash and of flash_bwd")
    tr.kops.reset_launch_counts()
    with mock.patch.object(tr.attention.ops, "flash_attention_fn",
                           plain_flash_fn(tr.attention.chunked_attention)):
        t = time.perf_counter()
        ploss, pgrads = tree_grads(tr, cfg, state.params, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
    if any(tr.kops.launch_counts().values()):
        raise AssertionError(f"the plain step launched {tr.kops.launch_counts()}")
    norm = float(torch.sqrt(sum(g.double().square().sum() for g in grads)))
    pnorm = float(torch.sqrt(sum(g.double().square().sum() for g in pgrads)))
    loss_err, norm_err = abs(loss - ploss) / abs(ploss), abs(norm - pnorm) / pnorm
    leaf_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(grads, pgrads))
    row = dict(tokens=4096, loss=loss, plain_loss=ploss, loss_rel_err=loss_err,
               loss_rtol=LONG_LOSS_RTOL, grad_norm=norm, plain_grad_norm=pnorm,
               grad_norm_rel_err=norm_err, grad_norm_rtol=LONG_NORM_RTOL,
               leaf_max_rel_err=leaf_err, leaf_rtol=LONG_LEAF_RTOL, launches=launches,
               kernel_s=kernel_s, plain_s=plain_s, max_memory_allocated=peak)
    log(f"1 x 4,096 float32 step, kernels vs plain chunked_attention: loss {loss:.7f} / "
        f"{ploss:.7f} (rel {loss_err:.2e}), grad norm {norm:.6f} / {pnorm:.6f} (rel "
        f"{norm_err:.2e}), leaves {leaf_err:.2e} of their largest; {kernel_s:.2f}s vs "
        f"{plain_s:.2f}s")
    if not (loss_err <= LONG_LOSS_RTOL and norm_err <= LONG_NORM_RTOL
            and leaf_err <= LONG_LEAF_RTOL):
        raise AssertionError(f"1 x 4,096 step: kernels and plain path disagree: {row}")
    del grads, pgrads
    # the same loss and gradients once more, the device traced alone: the
    # device ms of flash_bwd's kernels and of flash's in the float32 step
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tree_grads(tr, cfg, state.params, batch)
        torch.cuda.synchronize()
    ops = device_ops(prof)
    row.update(device_busy_ms=sum(us for _, us in ops) / 1e3,
               flash_bwd_device_ms=sum(us for n, us in ops if _BWD_KERNELS.search(n)) / 1e3,
               flash_device_ms=sum(us for n, us in ops if _FWD_KERNELS.search(n)) / 1e3)
    log(f"1 x 4,096 float32 step, profiled: device busy {row['device_busy_ms']:.1f} ms, "
        f"flash_bwd {row['flash_bwd_device_ms']:.1f} ms, flash {row['flash_device_ms']:.1f} ms "
        f"on the device")
    row["flash_kernels"] = sorted({n[:80] for n, _ in ops if _FWD_KERNELS.search(n)})
    log(f"1 x 4,096 float32 step, flash's kernels in the profile: {row['flash_kernels']}")
    if not row["flash_bwd_device_ms"] > 0:
        raise AssertionError("1 x 4,096 float32 step: no flash_bwd kernel in the profile")
    if not row["flash_device_ms"] > 0:
        raise AssertionError("1 x 4,096 float32 step: no flash kernel in the profile")
    if not any(_TF32_FWD_KERNEL.search(n) for n, _ in ops):  # head dim 64: the 3xTF32 kernel
        raise AssertionError("1 x 4,096 float32 step: no flash_tf32_kernel in the profile")
    del state
    return row


def bf16_train_leg(tr, dry) -> dict:
    """smollm-135m in the config's bf16 at 4 x 4,096 tokens in 4
    microbatches through ``launch.train``: the loss must fall; step ms,
    tokens/s and peak memory; flash and flash_bwd launch once a layer a
    microbatch; then the dry run ``dry`` (:func:`start_dryrun`) of the
    same step beside them."""
    _, cfg, _, _ = tr.setup(BF16_TRAIN_ARGV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.kops.reset_launch_counts()
    t = time.perf_counter()
    res = tr.run(BF16_TRAIN_ARGV, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = tr.kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * 4 * BF16_TRAIN_STEPS
    launches = {name: counts[name] for name in ("flash", "flash_bwd", "flash_f32")}
    losses = [h["loss"] for h in res.history]
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    stats = step_stats(res.history, 4 * 4096)
    log(f"bf16 4 x 4,096, microbatches 4: {len(losses)} steps in {wall:.1f}s, step "
        f"{stats['step_ms_median']:.1f} ms (median), {stats['tokens_per_s']:.0f} tokens/s, "
        f"loss {first:.4f} -> {last:.4f} (means of the first and last 3), peak memory "
        f"{peak}, launches {launches} (expected {want} each)")
    if launches != {"flash": want, "flash_bwd": want, "flash_f32": 0}:
        raise AssertionError(f"bf16 4 x 4,096: launches {launches}, expected {want} each")
    if len(losses) != BF16_TRAIN_STEPS or not np.all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"bf16 4 x 4,096: losses {losses}")
    profiled = profiled_train_step(tr, res.state, stats["step_ms_median"])
    estimate = dryrun_estimate(dry, stats["step_ms_median"], peak)
    return dict(dtype=str(cfg.dtype), batch=4, seq=4096, microbatches=4, losses=losses,
                loss_first3=first, loss_last3=last, wall_s=wall, max_memory_allocated=peak,
                launches=launches, profiled_step=profiled, dry_run=estimate, **stats)


def start_dryrun() -> types.SimpleNamespace:
    """Start the dry run of the bf16 step (``python -m
    repro_torch.launch.dryrun --mesh host``: smollm-135m, ``train_4k`` at a
    batch of 4, the config's 4 microbatches, one device, on meta tensors)
    in a host subprocess that sees no card, so its process state never
    meets this one's NCCL group.  It runs beside phases 1–11 (its ~20 s of
    host time off the smoke's path); :func:`dryrun_estimate` waits for it,
    and an exit before that stops it."""
    out = Path(tempfile.mkdtemp(prefix=".smoke-dryrun-", dir=ROOT))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    with open(out / "log.txt", "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", LM_ARCH,
             "--shape", "train_4k", "--mesh", "host", "--batch", "4", "--out", str(out)],
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    job = types.SimpleNamespace(proc=proc, out=out, t0=time.perf_counter())
    atexit.register(stop_dryrun, job)
    return job


# the sharded program on the production meshes (tests/test_torch_dryrun_cells.py's
# cells, on this host's torch): name -> (arch, shape, multi-pod, config
# overrides, count the unsharded program too); xlstm's train cell runs its
# microbatch loop once (the sLSTM's 4,096 steps on meta tensors take most
# of a minute a pass)
MESH_CELLS = {
    "smollm-135m train_4k pod16x16": ("smollm-135m", "train_4k", False, {"n_layers": 2}, True),
    "smollm-135m prefill_32k pod16x16": ("smollm-135m", "prefill_32k", False,
                                         {"n_layers": 2}, True),
    "smollm-135m decode_32k pod16x16": ("smollm-135m", "decode_32k", False,
                                        {"n_layers": 2}, True),
    "smollm-135m decode_32k pod2x16x16": ("smollm-135m", "decode_32k", True,
                                          {"n_layers": 2}, False),
    "qwen2-moe-a2.7b train_4k pod16x16": ("qwen2-moe-a2.7b", "train_4k", False,
                                          {"n_layers": 1}, False),
    "xlstm-1.3b decode_32k pod16x16": ("xlstm-1.3b", "decode_32k", False, {"n_layers": 8},
                                       False),
    "xlstm-1.3b train_4k pod16x16": ("xlstm-1.3b", "train_4k", False,
                                     {"n_layers": 8, "microbatches": 1}, False),
}
MESH_FLOPS_SLACK = 1.1  # a smollm device on pod16x16: at most 1.1 x its data shard's share
MESH_TRAIN_PEAK = 24e9  # the smollm train step's estimate of a rank's peak, bytes
_MESH_SCRIPT = r"""
import json, sys
from repro_torch.launch import dryrun
out = {}
for name, (arch, shape, multi_pod, cfg, cost) in json.loads(sys.argv[1]).items():
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, verbose=False, cfg_overrides=cfg,
                          cost_pass=cost, flops_scope="per_shard")
    out[name] = {k: rec.get(k) for k in ("status", "error", "mesh", "memory", "cost",
                                         "lower_s", "compile_s")}
    print(name, rec["status"], flush=True)
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""


def start_mesh_cells() -> types.SimpleNamespace:
    """Start the dry run of ``MESH_CELLS`` (fake process groups of 256 and 512
    ranks, meta tensors) in a host subprocess that sees no card; it runs
    beside the phases, and :func:`mesh_cells` waits for it."""
    out = Path(tempfile.mkdtemp(prefix=".smoke-mesh-", dir=ROOT))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    with open(out / "log.txt", "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", _MESH_SCRIPT, json.dumps(MESH_CELLS), str(out / "cells.json")],
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    job = types.SimpleNamespace(proc=proc, out=out, t0=time.perf_counter())
    atexit.register(stop_dryrun, job)
    return job


def mesh_cells(job) -> dict:
    """The records of :func:`start_mesh_cells`: every cell ``ok``, each
    smollm-135m cell on ``pod16x16`` at most MESH_FLOPS_SLACK times its data
    shard's share of the unsharded program, and the smollm train step's
    peak estimate at most MESH_TRAIN_PEAK; raises otherwise."""
    t = time.perf_counter()
    try:
        rc = job.proc.wait(timeout=900)
        waited = time.perf_counter() - t
        path = job.out / "cells.json"
        if rc != 0 or not path.exists():
            raise AssertionError(f"mesh cells: rc {rc}: "
                                 f"{(job.out / 'log.txt').read_text()[-3000:]}")
        recs = json.loads(path.read_text())
    finally:
        stop_dryrun(job)
    out = dict(torch=torch.__version__, waited_s=waited, cells={})
    for name, rec in recs.items():
        if rec["status"] != "ok":
            raise AssertionError(f"mesh cell {name}: {rec['status']}: {rec.get('error')}")
        cost, mem = rec["cost"], rec["memory"]
        row = dict(flops=cost["flops"], peak_bytes=mem["peak_bytes"],
                   argument_bytes=mem["argument_size_in_bytes"],
                   count_s=rec["compile_s"])
        if name.startswith("smollm-135m") and name.endswith(" pod16x16"):
            row["flops_unsharded"] = cost["flops_unsharded"]
            row["share"] = cost["flops"] / (cost["flops_unsharded"] / 16)
            if row["share"] > MESH_FLOPS_SLACK:
                raise AssertionError(f"mesh cell {name}: {row['share']:.3f} x its share")
        if name == "smollm-135m train_4k pod16x16" and mem["peak_bytes"] > MESH_TRAIN_PEAK:
            raise AssertionError(f"mesh cell {name}: peak {mem['peak_bytes']:.0f} B")
        out["cells"][name] = row
        log(f"mesh cell {name}: ok, flops/device {cost['flops']:.4e}"
            + (f" ({row['share']:.3f} x its data shard's share)" if "share" in row else "")
            + f", peak {mem['peak_bytes'] / 1e9:.2f} GB, counted in {rec['compile_s']:.1f}s")
    log(f"mesh cells on torch {torch.__version__}: all ok within bounds (waited {waited:.1f}s)")
    return out


def stop_dryrun(job) -> None:
    if job.proc.poll() is None:
        job.proc.kill()
        job.proc.wait()
    shutil.rmtree(job.out, ignore_errors=True)


def dryrun_estimate(job, step_ms: float, peak: int) -> dict:
    """The dry run's per-device memory and FLOP count of the bf16 step
    (:func:`start_dryrun`) beside the measured peak and the step's
    model-FLOPs share; its status must be ``ok``."""
    t = time.perf_counter()
    try:
        rc = job.proc.wait(timeout=600)
        waited = time.perf_counter() - t
        paths = list(job.out.glob("*.json"))
        if rc != 0 or len(paths) != 1:
            raise AssertionError(f"dry run: rc {rc}, records {paths}: "
                                 f"{(job.out / 'log.txt').read_text()[-2000:]}")
        rec = json.loads(paths[0].read_text())
    finally:
        stop_dryrun(job)
    if rec["status"] != "ok":
        raise AssertionError(f"dry run of the bf16 step: status {rec['status']}: "
                             f"{rec.get('error')}")
    est = rec["memory"]["peak_bytes"]
    flops, model = rec["cost"]["flops"], rec["roofline"]["model_flops"]
    share = model / (step_ms / 1e3 * HW.peak_flops_bf16)
    row = dict(build_s=rec["lower_s"], count_s=rec["compile_s"], waited_s=waited,
               memory_estimate=est, memory=rec["memory"], max_memory_allocated=peak,
               memory_ratio=est / peak, counted_flops=flops, model_flops=model,
               flops_ratio=flops / model, step_ms=step_ms, model_flops_share=share,
               coll_by_kind=rec["cost"]["coll_by_kind"], card=card_line())
    log(f"bf16 4 x 4,096 step, dry run (build {rec['lower_s']:.1f}s + count "
        f"{rec['compile_s']:.1f}s on the host beside phases 1-11; waited {waited:.1f}s): "
        f"memory estimate {est:.0f} B vs max_memory_allocated {peak} B (ratio "
        f"{est / peak:.4f}); counted FLOPs {flops:.6e} vs model_flops {model:.6e} (ratio "
        f"{flops / model:.4f}); model FLOPs / (step {step_ms:.1f} ms x "
        f"{HW.peak_flops_bf16:.3e}) = {share:.4f}; {row['card']}")
    return row


# the backward's kernels by name in a profiler trace (demangled or not):
# the wgmma kernel, its pre-pass and finish pass (bf16), or the scalar ones;
# the forward's apart
_BWD_KERNELS = re.compile(r"(?:::|\d)(?:bwd_bf16_kernel|rows_kernel|finish_kernel|dkdv_kernel|"
                          r"dq_kernel|delta_kernel|dkdv_tf32_kernel|dq_tf32_kernel|"
                          r"split_kernel)(?:<|\(|I|E)")
_FWD_KERNELS = re.compile(r"(?:::|\d)(?:flash_bf16_kernel|flash_tf32_kernel|fwd_split_kernel|"
                          r"flash_f32_kernel)(?:<|\(|I|E)")
# the float32 forward's 3xTF32 kernel (head dims up to 128)
_TF32_FWD_KERNEL = re.compile(r"(?:::|\d)flash_tf32_kernel(?:<|\(|I|E)")


def profiled_train_step(tr, state, step_ms: float) -> dict:
    """One more step of the bf16 4 x 4,096 run from its final state, on the
    device alone under the profiler: device busy ms against the run's
    median (unprofiled) step ms, and the device ms of flash_bwd's kernels
    and of flash's inside it."""
    _, cfg, hp, pipe = tr.setup(BF16_TRAIN_ARGV)
    step = tr.make_train_step(cfg, hp)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, _ = step(state, pipe.batch_at(BF16_TRAIN_STEPS))
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t) * 1e3
    ops = device_ops(prof)
    busy = sum(us for _, us in ops) / 1e3
    bwd = sum(us for name, us in ops if _BWD_KERNELS.search(name)) / 1e3
    fwd = sum(us for name, us in ops if _FWD_KERNELS.search(name)) / 1e3
    row = dict(wall_ms=step_ms, profiled_wall_ms=profiled_wall_ms, device_busy_ms=busy,
               idle_share=1 - busy / step_ms, flash_bwd_device_ms=bwd,
               flash_device_ms=fwd, device_ops=device_op_count(prof),
               top_device_ops=[(name[:80], us / 1e3) for name, us in ops[:6]])
    log(f"bf16 4 x 4,096 step, profiled: wall {step_ms:.1f} ms (the run's median; profiled "
        f"{profiled_wall_ms:.1f}), device busy {busy:.1f} ms (idle share "
        f"{row['idle_share']:.4f}), flash_bwd {bwd:.1f} ms, flash {fwd:.1f} ms on the device, "
        f"{row['device_ops']} device kernels, copies and fills")
    for name, us in ops[:6]:
        log(f"  device {us / 1e3:10.3f} ms  {name[:90]}")
    if not bwd > 0:
        raise AssertionError("bf16 step: no flash_bwd kernel in the profiled step")
    return row


def mesh_leg(tr) -> dict:
    """``launch.train --mesh 1x1`` on a NCCL group of one (the run starts and
    ends it) against the same run without a mesh: losses and grad norms of
    its first three steps, and every leaf of the final state, within 1e-5
    (relative; leaves of their largest)."""
    argv = TRAIN_ARGV + ["--steps", str(MESH_TRAIN_STEPS)]
    plain = tr.run(argv, log=log)
    t = time.perf_counter()
    meshed = tr.run(argv + ["--mesh", "1x1"], log=log)
    wall = time.perf_counter() - t
    if tr.dist.is_initialized():
        raise AssertionError("--mesh 1x1 left its process group up")
    hist = [(h["loss"], h["grad_norm"]) for h in meshed.history]
    want = [(h["loss"], h["grad_norm"]) for h in plain.history]
    hist_err = max(max(abs(a - c) / abs(c), abs(b - d) / abs(d))
                   for (a, b), (c, d) in zip(hist, want))
    leaf_err = 0.0
    for a, b in zip(tr.tree_leaves(meshed.state), tr.tree_leaves(plain.state)):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        if b.numel():
            scale = max(float(b.abs().max()), 1e-30)
            leaf_err = max(leaf_err, float((a.double() - b.double()).abs().max()) / scale)
    row = dict(steps=MESH_TRAIN_STEPS, losses=[h[0] for h in hist],
               plain_losses=[h[0] for h in want], history_max_rel_err=hist_err,
               state_leaf_max_rel_err=leaf_err, rtol=MESH_RTOL, wall_s=wall,
               step_s=[h["sec"] for h in meshed.history],
               plain_step_s=[h["sec"] for h in plain.history])
    log(f"--mesh 1x1 (NCCL) vs no mesh, {MESH_TRAIN_STEPS} steps: losses and grad norms "
        f"within {hist_err:.2e}, state within {leaf_err:.2e} of each leaf's largest; step "
        f"seconds {row['step_s']} vs {row['plain_step_s']}")
    if len(hist) != MESH_TRAIN_STEPS or not (hist_err <= MESH_RTOL and leaf_err <= MESH_RTOL):
        raise AssertionError(f"--mesh 1x1: {row}")
    return row


# -- phase 12: the MoE, Mamba and xLSTM mixers -------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"  # phase 7's traffic (LM_SERVE, LM_NEW, LM_PROMPT)
MOE_REQUESTS = 4  # 8 until phase 13 needed the smoke's time
MOE_REPLICA_LAYERS = 4  # the float32 replica's depth at full width (11.6 GB)
MOE_OUT_RTOL = 1e-5  # a layer's output, card vs CPU, float32, of the largest
MOE_TIE = 1e-6  # k-th and (k+1)-th router probabilities this close: a near-tie
MOE_FLASH_SHAPE = ("qwen2-moe-a2.7b prefill", 1, 4096, 4096, 16, 16, 128, True, None, None,
                   BF16, True)
XLSTM_ARCH = "xlstm-1.3b"
# 1 request (4 until PR 25, 2 until PR 26): cut for the smoke's time
XLSTM_REQUESTS, XLSTM_NEW = 1, 32
XLSTM_PROMPT = (2_048, 4_096)  # lengths multiples of xlstm_chunk (256): the reference's domain
XLSTM_CHECK = (2_048, 256)  # float32: prefill, then teacher-forced decode steps
XLSTM_RTOL = 1e-4  # decode logits vs the full forward, of max |logit|
MAMBA_ARCH = "jamba-1.5-large-398b"
MAMBA_LEN, MAMBA_DECODE = 4_095, 64  # not a multiple of mamba_chunk (128)
MAMBA_RTOL = 1e-4  # decoded outputs vs the full apply, float32, of the largest
# mamba_apply's peak over what it starts from, in [B, chunk, d_inner, N]
# float32 working sets (a single-chunk fallback would take 32 for each of
# its [B, S, d_inner, N] tensors)
MAMBA_PEAK_CHUNKS = 16
JAMBA_SMOKE = dict(slots=2, prefill_len=64, max_len=128)
JAMBA_SMOKE_REQUESTS, JAMBA_SMOKE_NEW, JAMBA_SMOKE_PROMPT = 4, 8, (20, 60)


def route_log(moe, sink: list, host: bool = False):
    """Patch ``moe.route`` (where the MoE layers look it up) to record each
    dispatch plan: on the host (the probabilities, capacity, selection,
    positions and keep mask) or as device counts (pairs, dropped)."""
    real = moe.route

    def route(probs, k, cap):
        out = real(probs, k, cap)
        if host:
            sink.append(dict(probs=probs.detach().cpu(), cap=cap, sel=out[1].cpu(),
                             pos=out[2].cpu(), keep=out[3].cpu()))
        else:
            sink.append(dict(tokens=probs.shape[0] * probs.shape[1], pairs=out[3].numel(),
                             dropped=(~out[3]).sum()))
        return out
    return mock.patch.object(moe, "route", route)


def device_op_count(prof) -> int:
    return sum(e.count for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU and e.self_device_time_total > 0)


def profiled_step(fn, ms: float, what: str) -> dict:
    """One call of ``fn`` under the profiler, on the device alone (a host
    trace of its thousands of ops would cost seconds): device busy against
    the unprofiled ``ms``, and the device kernels, copies and fills."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = device_ops(prof)
    busy = sum(us for _, us in ops) / 1e3
    n = device_op_count(prof)
    log(f"{what}: device busy {busy:.3f} ms of {ms:.3f} ms (idle share "
        f"{1 - busy / ms:.4f}), {n} device kernels, copies and fills")
    for name, us in ops[:5]:
        log(f"  device {us / 1e3:10.3f} ms  {name[:90]}")
    return dict(device_busy_ms=busy, idle_share=1 - busy / ms, device_ops=n,
                top_device_ops=[(name[:80], us / 1e3) for name, us in ops[:5]])


def serve_stats(what, res, wall, peak) -> dict:
    n = sum(len(r.tokens) for r in res.values())
    lat = sorted(r.latency_s for r in res.values())
    out = dict(requests=len(res), tokens=n, wall_s=wall, tokens_per_s=n / wall,
               latency_p50_s=lat[len(lat) // 2], latency_p100_s=lat[-1],
               max_memory_allocated=peak)
    log(f"{what}: {len(res)} requests, {n} tokens in {wall:.3f}s ({n / wall:.1f} tok/s); "
        f"latency p50 {out['latency_p50_s']:.3f}s p100 {lat[-1]:.3f}s; "
        f"max_memory_allocated={peak}")
    return out


def to_float32(module) -> None:
    """Every parameter of ``module`` cast to float32 in place, one at a
    time (so the bf16 and float32 copies never coexist whole)."""
    with torch.no_grad():
        for p in module.parameters():
            p.data = p.data.float()
    torch.cuda.empty_cache()


def moe_dispatch_check(lm, params, cfg, batch) -> dict:
    """Each MoE layer of one float32 prefill at the serving capacity: the
    plain dispatch recomputed on the CPU from the card's own router
    probabilities must equal the card's (selection, positions, keep); the
    layer's output must equal the CPU float32 layer's on the same input
    (within MOE_OUT_RTOL of the largest) on every token where the two
    devices' selections agree, and a token whose selection differs must be
    a near-tie (k-th and (k+1)-th probabilities within MOE_TIE)."""
    e, k = cfg.moe_experts, cfg.moe_topk
    layers, plans = [], []
    real_apply = lm.moe.moe_apply

    def apply(mod, x, c, capacity_factor=None):
        out = real_apply(mod, x, c, capacity_factor=capacity_factor)
        layers.append((mod, x.detach().cpu(), out[0].detach().cpu(), capacity_factor))
        return out

    with mock.patch.object(lm.moe, "moe_apply", apply), route_log(lm.moe, plans, host=True):
        lm.prefill(params, batch, cfg, LM_SERVE["max_len"])
    if len(layers) != len(plans) or len(layers) != lm.num_moe_layers(cfg):
        raise AssertionError(f"MoE dispatch: {len(layers)} layers, {len(plans)} plans")
    out = []
    for i, ((mod, x, y, cf), card) in enumerate(zip(layers, plans)):
        t = time.perf_counter()
        g, n = card["probs"].shape[:2]
        cap = lm.moe.capacity(n, k, e, cf)
        _, sel, pos, keep = lm.moe.route(card["probs"], k, cap)
        for name, got in (("sel", sel), ("pos", pos), ("keep", keep)):
            if card["cap"] != cap or not torch.equal(got, card[name]):
                raise AssertionError(f"MoE layer {i}: the card's {name} differs from the "
                                     f"plain dispatch on its own probabilities")
        top = card["probs"].topk(k + 1, dim=-1).values
        near = (top[..., k - 1] - top[..., k] < MOE_TIE).reshape(-1)
        # the CPU float32 layer on the same input, its own router included
        host = lm.moe.MoE(cfg, device="cpu")
        host.load_state_dict({n_: v.cpu() for n_, v in mod.state_dict().items()})
        cpu_plans = []
        with route_log(lm.moe, cpu_plans, host=True), torch.no_grad():
            want, _ = real_apply(host, x, cfg, capacity_factor=cf)
        del host
        cpu = cpu_plans[0]
        sel_diff = (cpu["sel"] != card["sel"]).any(-1).reshape(-1)
        keep_diff = (cpu["keep"] != card["keep"]).any(-1).reshape(-1)
        if bool((sel_diff & ~near).any()) or (bool(keep_diff.any()) and not bool(sel_diff.any())):
            raise AssertionError(f"MoE layer {i}: the CPU's selection differs from the card's "
                                 f"away from a near-tie")
        agree = ~(sel_diff | keep_diff)
        y, want = y.reshape(-1, y.shape[-1]), want.reshape(-1, want.shape[-1])
        scale = float(want.abs().max())
        err = float((y[agree] - want[agree]).abs().max())
        dropped = int((~keep).sum())
        row = dict(layer=i, tokens=n, capacity=cap, dropped_pairs=dropped,
                   dropped_share=dropped / keep.numel(), max_abs_err=err, scale=scale,
                   rtol=MOE_OUT_RTOL, near_ties=int(near.sum()),
                   selection_differs=int(sel_diff.sum()), compared=int(agree.sum()),
                   cpu_s=time.perf_counter() - t)
        log(f"MoE layer {i}: dispatch equal to the CPU's on the card's probabilities "
            f"(capacity {cap}, {dropped} of {keep.numel()} pairs dropped); output vs CPU "
            f"float32 max_abs_err={err:.3e} (scale {scale:.3e}, rtol {MOE_OUT_RTOL}) over "
            f"{row['compared']} tokens; near-ties {row['near_ties']}, selection differs at "
            f"{row['selection_differs']}; {row['cpu_s']:.1f}s")
        if not err <= MOE_OUT_RTOL * scale:
            raise AssertionError(f"MoE layer {i}: card vs CPU {err} > {MOE_OUT_RTOL} · {scale}")
        out.append(row)
    return dict(layers=out)


def moe_leg(lm, gen) -> tuple:
    """qwen2-moe-a2.7b at full width and depth behind the engine (phase 7's
    traffic), flash on every prefill; then its checks.  Returns (the leg's
    JSON, the serving run's flash launches as ``count_flash`` counts them,
    flash's row at this shape)."""
    cfg = lm.get_config(MOE_ARCH)
    t = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, {cfg.moe_experts} experts top-"
        f"{cfg.moe_topk} (ff {cfg.moe_ff}, shared {cfg.moe_shared_ff}), vocab {cfg.vocab}, "
        f"{cfg.dtype}, {n_params} parameters, {time.perf_counter() - t:.2f}s to draw")
    rng = np.random.RandomState(SEED)
    prompts = [
        [int(x) for x in rng.randint(1, cfg.vocab, size=rng.randint(LM_PROMPT[0], LM_PROMPT[1] + 1))]
        for _ in range(MOE_REQUESTS)
    ]
    log(f"prompt lengths {[len(p) for p in prompts]}")
    flash_row = flash_case(lm.ref, lm.kops, gen, MOE_FLASH_SHAPE)
    warm = lm.Engine(params, cfg, lm.ServeConfig(**LM_SERVE))
    warm.submit(lm.Request(uid=0, tokens=prompts[0][:2_100], max_new_tokens=2))
    warm.run()
    del warm

    torch.cuda.reset_peak_memory_stats()
    routes = []
    with route_log(lm.moe, routes):
        (res, wall), launches = count_flash(
            lm, "qwen2-moe bf16 serve", functools.partial(lm_serve, lm, params, cfg, prompts),
            cfg.n_layers * MOE_REQUESTS)
    serve = serve_stats("qwen2-moe bf16 serve", res, wall, torch.cuda.max_memory_allocated())
    n = cfg.n_layers
    pre = [c for c in routes if c["tokens"] == LM_SERVE["prefill_len"]]
    if len(pre) != n * MOE_REQUESTS:
        raise AssertionError(f"{len(pre)} prefill dispatches, expected {n * MOE_REQUESTS}")
    shares = [sum(float(c["dropped"]) for c in pre[i : i + n]) / sum(c["pairs"] for c in pre[i : i + n])
              for i in range(0, len(pre), n)]
    decode_dropped = sum(float(c["dropped"]) for c in routes if c["tokens"] != LM_SERVE["prefill_len"])
    log(f"dropped (token, pick) pairs a prefill ({n} layers, pads routed): "
        f"{[f'{s:.4f}' for s in shares]}; dropped in decode steps: {decode_dropped:.0f}")
    serve.update(dropped_share_per_prefill=shares, decode_dropped_pairs=decode_dropped)
    del routes

    toks = np.zeros((1, LM_SERVE["prefill_len"]), np.int64)
    toks[0, : len(prompts[0])] = prompts[0]
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    prefill = functools.partial(lm.prefill, params, batch, cfg, LM_SERVE["max_len"])
    serve["prefill_ms"] = time_ms(prefill, reps=3, warmup=1)
    cache = lm.init_cache(cfg, LM_SERVE["slots"], LM_SERVE["max_len"])
    step = torch.ones((LM_SERVE["slots"], 1), dtype=torch.long, device="cuda")
    decode = functools.partial(lm.decode_step, params, step, cache, 3_000, cfg)
    serve["decode_step_ms"] = time_ms(decode, reps=5)
    log(f"qwen2-moe bf16 prefill of {LM_SERVE['prefill_len']} tokens {serve['prefill_ms']:.3f} ms; "
        f"decode step ({LM_SERVE['slots']} slots) {serve['decode_step_ms']:.3f} ms")
    serve["decode_step_profiled"] = profiled_step(decode, serve["decode_step_ms"],
                                                  "qwen2-moe bf16 decode step")
    del cache, decode

    # flash vs the plain path in bf16 at full depth, dropless: at 1.25 a
    # router probability that rounds otherwise shifts the capacity positions
    # of every later pick of its expert, and the per-position errors would
    # measure that cascade, not attention
    free = dict(moe_capacity=float(cfg.moe_experts), moe_capacity_serve=float(cfg.moe_experts))

    def float32():
        to_float32(params)
        return params, dataclasses.replace(cfg, dtype_name="float32", param_dtype_name="float32",
                                           **free)
    bf16 = bf16_forward_check(lm, params, dataclasses.replace(cfg, **free), float32, batch)
    bf16["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"peak device memory through the float32 forward at full depth: "
        f"{bf16['max_memory_allocated']}")

    # the float32 replica: the first layers of the same weights
    del params.blocks[MOE_REPLICA_LAYERS:]
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype_name="float32", param_dtype_name="float32",
                                n_layers=MOE_REPLICA_LAYERS)
    t = time.perf_counter()
    dispatch = moe_dispatch_check(lm, params, cfg32, batch)
    dispatch["seconds"] = time.perf_counter() - t
    # greedy tokens vs the full-forward oracle: dropless (a capacity factor
    # of E gives every expert room for every token), since at 1.25 the
    # padded prefill and the unpadded oracle drop different pairs
    cfg_free = dataclasses.replace(cfg32, **free)
    (res32, wall32), _ = count_flash(
        lm, "float32 replica serve (dropless)",
        functools.partial(lm_serve, lm, params, cfg_free, prompts), MOE_REPLICA_LAYERS * MOE_REQUESTS)
    ties, _ = count_flash(lm, "float32 replica oracle forwards",
                          functools.partial(greedy_ties, lm, params, cfg_free, prompts, res32),
                          MOE_REPLICA_LAYERS * MOE_REQUESTS)
    log(f"float32 replica ({MOE_REPLICA_LAYERS} layers): greedy tokens vs full-forward oracle: "
        f"{MOE_REQUESTS * LM_NEW - len(ties)} of {MOE_REQUESTS * LM_NEW} equal; near-ties {ties}")
    del params
    torch.cuda.empty_cache()
    return (dict(arch=cfg.name, params=n_params, serve=serve, bf16_forward=bf16,
                 dispatch=dispatch, replica=dict(layers=MOE_REPLICA_LAYERS, wall_s=wall32,
                                                 near_ties=ties)),
            launches, flash_row)


def xlstm_leg(lm) -> dict:
    """xlstm-1.3b at full width and depth behind the engine's exact-length
    prefill; then float32 prefill + teacher-forced decode against the full
    forward."""
    cfg = lm.get_config(XLSTM_ARCH)
    t = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    kinds = [b.mixer for b in cfg.pattern] * cfg.n_periods
    log(f"{cfg.name}: {cfg.n_layers} layers ({kinds.count('slstm')} sLSTM, "
        f"{kinds.count('mlstm')} mLSTM), d_model {cfg.d_model}, {cfg.n_heads} heads, vocab "
        f"{cfg.vocab}, {cfg.dtype}, {n_params} parameters, {time.perf_counter() - t:.2f}s to draw")
    rng = np.random.RandomState(SEED)
    step = cfg.xlstm_chunk
    lens = rng.randint(XLSTM_PROMPT[0] // step, XLSTM_PROMPT[1] // step + 1, XLSTM_REQUESTS) * step
    prompts = [[int(x) for x in rng.randint(1, cfg.vocab, size=n)] for n in lens]
    log(f"prompt lengths {[len(p) for p in prompts]}")
    scfg = lm.ServeConfig(**LM_SERVE, seed=SEED)
    warm = lm.Engine(params, cfg, scfg)
    warm.submit(lm.Request(uid=0, tokens=prompts[0][:step], max_new_tokens=2))
    warm.run()
    del warm

    torch.cuda.reset_peak_memory_stats()
    eng = lm.Engine(params, cfg, scfg)
    for uid, prompt in enumerate(prompts):
        eng.submit(lm.Request(uid=uid, tokens=prompt, max_new_tokens=XLSTM_NEW))
    torch.cuda.synchronize()
    t = time.perf_counter()
    with SyncTimers((lm.xl, ("slstm_apply", "mlstm_apply"))) as timers:
        results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    res = {r.uid: r for r in results}
    if sorted(res) != list(range(len(prompts))) or any(
            len(r.tokens) != XLSTM_NEW or not all(0 <= x < cfg.vocab for x in r.tokens)
            for r in results):
        raise AssertionError(f"xlstm serve: bad results {[(r.uid, r.tokens) for r in results]}")
    serve = serve_stats("xlstm bf16 serve", res, wall, torch.cuda.max_memory_allocated())
    del eng
    serve["prefill_s"] = {k: v for k, v in timers.seconds.items()}
    serve["prefill_tokens"] = int(sum(lens))
    cache = lm.init_cache(cfg, LM_SERVE["slots"], LM_SERVE["max_len"])
    tok = torch.ones((LM_SERVE["slots"], 1), dtype=torch.long, device="cuda")
    decode = functools.partial(lm.decode_step, params, tok, cache, 3_000, cfg)
    serve["decode_step_ms"] = time_ms(decode, reps=5)
    log(f"xlstm bf16 prefill of {serve['prefill_tokens']} tokens: sLSTM "
        f"{timers.seconds['slstm_apply']:.3f}s, mLSTM {timers.seconds['mlstm_apply']:.3f}s; "
        f"decode step ({LM_SERVE['slots']} slots) {serve['decode_step_ms']:.3f} ms")
    serve["decode_step_profiled"] = profiled_step(decode, serve["decode_step_ms"],
                                                  "xlstm bf16 decode step")
    del cache, decode

    # float32: prefill n0 tokens, decode n1 more teacher-forced, each step
    # against the full forward at n0 + n1 on its position
    to_float32(params)
    cfg32 = dataclasses.replace(cfg, dtype_name="float32", param_dtype_name="float32")
    n0, n1 = XLSTM_CHECK
    seq = torch.from_numpy(rng.randint(1, cfg.vocab, size=(1, n0 + n1))).cuda()
    t = time.perf_counter()
    with torch.no_grad():
        full = lm.forward(params, {"tokens": seq}, cfg32)[0][0, :, : cfg.vocab]
    last, cache = lm.prefill(params, {"tokens": seq[:, :n0]}, cfg32, LM_SERVE["max_len"])
    errs = [float((last[0, : cfg.vocab] - full[n0 - 1]).abs().max())]
    for i in range(n0, n0 + n1):
        logits, cache = lm.decode_step(params, seq[:, i : i + 1], cache, i, cfg32)
        errs.append(float((logits[0, : cfg.vocab] - full[i]).abs().max()))
    scale = float(full[n0 - 1 :].abs().max())
    check = dict(prefill=n0, decode=n1, max_abs_err=max(errs), scale=scale, rtol=XLSTM_RTOL,
                 seconds=time.perf_counter() - t)
    log(f"xlstm float32: prefill {n0} + {n1} teacher-forced decode steps vs the full forward "
        f"at {n0 + n1}: max_abs_err={max(errs):.3e} (scale {scale:.3e}, rtol {XLSTM_RTOL}); "
        f"{check['seconds']:.1f}s")
    if not (max(errs) <= XLSTM_RTOL * scale and bool(torch.isfinite(full).all())):
        raise AssertionError(f"xlstm decode vs forward: {max(errs)} > {XLSTM_RTOL} · {scale}")
    del params, full, cache
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, params=n_params, prompt_lengths=[int(n) for n in lens],
                serve=serve, float32_check=check)


def mamba_leg(lm) -> dict:
    """One Mamba mixer at jamba-1.5-large's full width: an apply over a
    length that is not a multiple of the chunk and 64 decode steps from its
    cache (bf16, timed, peak memory), then float32 decode vs the full
    apply; last, jamba's smoke config end to end, card vs CPU."""
    cfg = lm.get_config(MAMBA_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mod = lm.mb.mamba_init(cfg, gen)
    n_params = sum(p.numel() for p in mod.parameters())
    total = MAMBA_LEN + MAMBA_DECODE
    x = torch.randn(1, total, cfg.d_model, device="cuda", generator=gen)
    xb = x.to(cfg.dtype)
    log(f"Mamba at {MAMBA_ARCH} width: d_model {cfg.d_model}, d_inner {cfg.mamba_d_inner}, "
        f"d_state {cfg.mamba_d_state}, dt_rank {cfg.mamba_dt_rank}, conv {cfg.mamba_d_conv}, "
        f"chunk {cfg.mamba_chunk}, {cfg.dtype}, {n_params} parameters")
    with torch.no_grad():
        lm.mb.mamba_apply(mod, xb[:, : cfg.mamba_chunk], cfg)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        _, cache = lm.mb.mamba_apply(mod, xb[:, :MAMBA_LEN], cfg, return_state=True)
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
        t = time.perf_counter()
        for i in range(MAMBA_LEN, total):
            _, cache = lm.mb.mamba_decode(mod, xb[:, i : i + 1], cache, cfg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t) / MAMBA_DECODE * 1e3
    working = cfg.mamba_chunk * cfg.mamba_d_inner * cfg.mamba_d_state * 4
    log(f"Mamba bf16 apply over {MAMBA_LEN} tokens {apply_s:.3f}s, peak {peak} bytes over its "
        f"inputs = {peak / working:.2f} x the [1, {cfg.mamba_chunk}, {cfg.mamba_d_inner}, "
        f"{cfg.mamba_d_state}] float32 working set (bound {MAMBA_PEAK_CHUNKS}); decode "
        f"{decode_ms:.3f} ms a step")
    if not peak <= MAMBA_PEAK_CHUNKS * working:
        raise AssertionError(f"mamba_apply peak {peak} over {MAMBA_PEAK_CHUNKS} x {working}")
    to_float32(mod)
    cfg32 = dataclasses.replace(cfg, dtype_name="float32", param_dtype_name="float32")
    with torch.no_grad():
        full = lm.mb.mamba_apply(mod, x, cfg32)[:, MAMBA_LEN:]
        _, cache = lm.mb.mamba_apply(mod, x[:, :MAMBA_LEN], cfg32, return_state=True)
        steps = []
        for i in range(MAMBA_LEN, total):
            y, cache = lm.mb.mamba_decode(mod, x[:, i : i + 1], cache, cfg32)
            steps.append(y)
    got = torch.cat(steps, dim=1)
    err, scale = float((got - full).abs().max()), float(full.abs().max())
    log(f"Mamba float32: {MAMBA_DECODE} decode steps after {MAMBA_LEN} tokens vs the apply at "
        f"{total}: max_abs_err={err:.3e} (scale {scale:.3e}, rtol {MAMBA_RTOL})")
    if not (err <= MAMBA_RTOL * scale and bool(torch.isfinite(got).all())):
        raise AssertionError(f"mamba decode vs apply: {err} > {MAMBA_RTOL} · {scale}")
    del mod, x, xb, full, got, cache
    torch.cuda.empty_cache()

    # jamba's smoke config end to end: the card's greedy tokens vs the CPU's
    scfg = lm.get_config(MAMBA_ARCH, smoke=True)
    params = lm.init_params(scfg, seed=SEED, device="cuda")
    host = copy.deepcopy(params).cpu()
    rng = np.random.RandomState(SEED)
    prompts = [[int(v) for v in rng.randint(1, scfg.vocab, size=rng.randint(*JAMBA_SMOKE_PROMPT))]
               for _ in range(JAMBA_SMOKE_REQUESTS)]
    got = {}
    for where, p in (("card", params), ("host", host)):
        eng = lm.Engine(p, scfg, lm.ServeConfig(**JAMBA_SMOKE, seed=SEED))
        for uid, prompt in enumerate(prompts):
            eng.submit(lm.Request(uid=uid, tokens=prompt, max_new_tokens=JAMBA_SMOKE_NEW))
        got[where] = {r.uid: r.tokens for r in eng.run()}
    log(f"jamba smoke ({scfg.n_layers} layers: {[b.mixer + '+' + b.ffn for b in scfg.pattern]}) "
        f"through the engine: card tokens {'equal' if got['card'] == got['host'] else 'DIFFER'} "
        f"to the CPU's over {JAMBA_SMOKE_REQUESTS} requests")
    if got["card"] != got["host"] or len(got["card"]) != JAMBA_SMOKE_REQUESTS:
        raise AssertionError(f"jamba smoke: card {got['card']} vs CPU {got['host']}")
    return dict(arch=cfg.name, params=n_params, length=MAMBA_LEN, apply_s=apply_s,
                peak_bytes=peak, working_set_bytes=working, peak_rtol_chunks=MAMBA_PEAK_CHUNKS,
                decode_ms=decode_ms, float32_check=dict(max_abs_err=err, scale=scale,
                                                         rtol=MAMBA_RTOL),
                jamba_smoke=dict(requests=JAMBA_SMOKE_REQUESTS, tokens_equal=True))


LAUNCH_SERVE_ARGS = ["--requests", "4", "--max-new", "8"]  # its defaults otherwise


def launch_serve_full(lm, arch: str) -> float:
    """``launch.serve --arch <arch>`` at full size on the card; its wall
    seconds."""
    t = time.perf_counter()
    if lm.launch_serve(["--arch", arch] + LAUNCH_SERVE_ARGS) != 0:
        raise AssertionError(f"launch.serve --arch {arch} failed")
    torch.cuda.empty_cache()
    return time.perf_counter() - t


def mixers_phase(lm) -> tuple:
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 12 starts with {torch.cuda.memory_allocated()} bytes allocated on the card")
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    moe, launches, flash_row = moe_leg(lm, gen)
    moe["launch_serve_s"] = launch_serve_full(lm, MOE_ARCH)
    log(f"phase 12 leg 1 (qwen2-moe): {time.perf_counter() - t:.1f}s")
    t2 = time.perf_counter()
    xlstm = xlstm_leg(lm)
    xlstm["launch_serve_s"] = launch_serve_full(lm, XLSTM_ARCH)
    log(f"phase 12 leg 2 (xlstm): {time.perf_counter() - t2:.1f}s")
    t3 = time.perf_counter()
    mamba = mamba_leg(lm)
    log(f"phase 12 leg 3 (Mamba, jamba smoke): {time.perf_counter() - t3:.1f}s")
    seconds = time.perf_counter() - t
    log(f"phase 12: {seconds:.1f}s")
    return dict(moe=moe, xlstm=xlstm, mamba=mamba, seconds=seconds), launches, flash_row


# -- phase 13: whisper-medium and llava-next-mistral-7b -------------------------------

WHISPER_ARCH = "whisper-medium"
# 4 requests of 1,500 stub frames (input_specs' shape) and a 64-token prompt,
# 128 greedy new tokens (positions up to 192, inside the released model's 448)
WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_NEW = 4, 64, 128
# the bf16 forward's decoder tokens: the repo's prefill_32k shape cut to
# 4,096, as phase 7 cuts it; self and cross attention both take flash there
WHISPER_FORWARD = 4_096
LLAVA_ARCH = "llava-next-mistral-7b"
# 2 requests of 2,880 patch embeddings + 1,216 text tokens (4,096
# positions), 32 greedy new tokens
LLAVA_REQUESTS, LLAVA_TEXT, LLAVA_NEW = 2, 1_216, 32
LLAVA_CPU_LAYERS = 2  # the first layers, float32, card vs CPU,
LLAVA_CPU_TEXT = 64  # over the patch prefix and a row's first tokens (2,944 positions)
LLAVA_CPU_RTOL = 1e-5  # a layer's attention or MLP on the card's input, of the largest
DECODE_LOGIT_RTOL = 1e-4  # decode-step logits vs the full forward, float32, of max |logit|


def generate(lm, params, cfg, batch, n_new: int) -> dict:
    """``prefill`` of ``batch`` (tokens, and frames or patches), then greedy
    ``decode_step`` s to ``n_new`` tokens a row (the first from the prefill's
    logits), every row at the same position: the tokens ``[B, n_new]``, each
    step's logits (float32, on the card) and the seconds of the prefill and
    of the decode steps."""
    v = cfg.vocab
    start = batch["tokens"].shape[1] + cfg.n_patches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, batch, cfg, start + n_new)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps, toks = [], []
    for i in range(n_new):
        steps.append(logits[:, :v])
        toks.append(steps[-1].argmax(-1))
        if i + 1 < n_new:
            logits, cache = lm.decode_step(params, toks[-1][:, None], cache, start + i, cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tokens = torch.stack(toks, 1)
    if not bool(((tokens >= 0) & (tokens < v)).all()):
        raise AssertionError(f"{cfg.name}: generated tokens out of the vocabulary")
    return dict(tokens=tokens, logits=torch.stack(steps, 1), prefill_s=t1 - t0,
                decode_s=t2 - t1)


def oracle_check(lm, params32, cfg32, batch, got, what: str, launches: int) -> dict:
    """float32 decode against one teacher-forced full forward of each row's
    prompt and generated tokens (with its frames or patches; flash must
    launch ``launches`` times): every step's logits within
    DECODE_LOGIT_RTOL of the forward's largest, every greedy pick the
    forward's top logit or within NEAR_TIE of it (a near-tie, returned)."""
    toks, n_new = got["tokens"], got["tokens"].shape[1]
    seq = torch.cat([batch["tokens"], toks[:, :-1]], dim=1)

    def forward():
        with torch.no_grad():
            return lm.forward(params32, dict(batch, tokens=seq), cfg32)[0]
    logits, _ = count_flash(lm, f"{what} oracle forward", forward, launches)
    first = cfg32.n_patches + batch["tokens"].shape[1] - 1
    want = logits[:, first : first + n_new, : cfg32.vocab]
    err = float((got["logits"] - want).abs().max())
    scale = float(want.abs().max())
    log(f"{what}: decode-step logits vs the full forward: max_abs_err={err:.3e} "
        f"tol={DECODE_LOGIT_RTOL * scale:.3e}")
    if not err <= DECODE_LOGIT_RTOL * scale:
        raise AssertionError(f"{what}: decode logits {err} off the forward's "
                             f"(tol {DECODE_LOGIT_RTOL * scale})")
    top = want.max(dim=-1).values
    gap = (top - want.gather(-1, toks[..., None])[..., 0]).cpu().numpy()
    ties = [(int(b), int(t), float(gap[b, t])) for b, t in zip(*np.nonzero(gap > 0))]
    for b, t, g in ties:
        if not g < NEAR_TIE:
            raise AssertionError(f"{what}: row {b} step {t} picked {int(toks[b, t])}, "
                                 f"{g:.3e} under the forward's top logit")
    log(f"{what}: greedy tokens vs the full forward: {toks.numel() - len(ties)} of "
        f"{toks.numel()} the top logit; near-ties {ties}")
    return dict(max_abs_err=err, scale=scale, rtol=DECODE_LOGIT_RTOL, near_ties=ties)


def encdec_serve(lm, params, cfg, batch, n_new: int, launches: int, what: str) -> tuple:
    """One short warm-up, then ``generate`` counted (flash must launch
    ``launches`` times, all in the prefill) and timed: prefill ms,
    decode-step ms, tokens/s and peak memory; the decode step also
    profiled.  Returns (its JSON, what ``generate`` returned)."""
    generate(lm, params, cfg, {k: t[:1] for k, t in batch.items()}, 2)
    torch.cuda.reset_peak_memory_stats()
    got, counts = count_flash(lm, what, functools.partial(generate, lm, params, cfg, batch,
                                                          n_new), launches)
    peak = torch.cuda.max_memory_allocated()
    rows, n = got["tokens"].shape
    wall = got["prefill_s"] + got["decode_s"]
    start = batch["tokens"].shape[1] + cfg.n_patches
    prefill = functools.partial(lm.prefill, params, batch, cfg, start + n_new)
    prefill_ms = time_ms(prefill, reps=3, warmup=1)
    _, cache = prefill()
    decode = functools.partial(lm.decode_step, params, got["tokens"][:, :1], cache, start, cfg)
    decode_ms = time_ms(decode, reps=5)
    out = dict(requests=rows, new_tokens=n, wall_s=wall, tokens_per_s=rows * n / wall,
               prefill_s=got["prefill_s"], decode_s=got["decode_s"], prefill_ms=prefill_ms,
               decode_step_ms=decode_ms, max_memory_allocated=peak, launches=counts)
    log(f"{what}: {rows} requests x {n} tokens in {wall:.3f}s ({rows * n / wall:.1f} tok/s; "
        f"prefill {got['prefill_s']:.3f}s, {n - 1} decode steps {got['decode_s']:.3f}s); "
        f"prefill {prefill_ms:.3f} ms, decode step {decode_ms:.3f} ms; "
        f"max_memory_allocated={peak}")
    out["decode_step_profiled"] = profiled_step(decode, decode_ms, f"{what} decode step")
    del cache
    return out, got


def float32_of(params, cfg):
    """``float32()`` for ``bf16_forward_check``: the weights cast in place."""
    def run():
        to_float32(params)
        return params, dataclasses.replace(cfg, dtype_name="float32", param_dtype_name="float32")
    return run


def whisper_leg(lm, gen) -> tuple:
    """whisper-medium at full width and depth (24 + 24 layers, bf16): 4
    requests served through prefill / decode_step (at 1,500 frames and a
    64-token prompt every attention is dense: no kernel), encode timed; the
    bf16 forward at 4,096 decoder tokens, flash 48 times (24 self, 24
    cross), against the plain path and the float32 model; then the float32
    replica's greedy tokens and decode logits (the cross cache) against the
    full forward.  Returns (the leg's JSON, the forward's flash launches:
    ``count_flash``'s counts)."""
    cfg = lm.get_config(WHISPER_ARCH)
    t = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{cfg.name}: {cfg.n_layers} decoder + {cfg.enc_layers} encoder layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, vocab "
        f"{cfg.vocab}, {cfg.n_frames} frames, {cfg.dtype}, {n_params} parameters, "
        f"{time.perf_counter() - t:.2f}s to draw")
    rng = np.random.RandomState(SEED + 13)
    frames = torch.randn(WHISPER_REQUESTS, cfg.n_frames, cfg.d_model, device="cuda",
                         generator=gen)
    tokens = torch.from_numpy(rng.randint(1, cfg.vocab, (WHISPER_REQUESTS, WHISPER_PROMPT)))
    batch = dict(tokens=tokens.cuda(), frames=frames)
    serve, got = encdec_serve(lm, params, cfg, batch, WHISPER_NEW, 0, "whisper bf16 serve")
    serve["encode_ms"] = time_ms(functools.partial(lm.encode, params, frames, cfg), reps=5)
    log(f"whisper bf16 encode of {WHISPER_REQUESTS} x {cfg.n_frames} frames "
        f"{serve['encode_ms']:.3f} ms")

    launches = 2 * cfg.n_layers
    long = dict(tokens=torch.from_numpy(rng.randint(1, cfg.vocab, (1, WHISPER_FORWARD))).cuda(),
                frames=frames[:1])
    bf16 = bf16_forward_check(lm, params, cfg, float32_of(params, cfg), long, launches)
    cfg32 = dataclasses.replace(cfg, dtype_name="float32", param_dtype_name="float32")
    got32, _ = count_flash(lm, "whisper float32 replica",
                           functools.partial(generate, lm, params, cfg32, batch, WHISPER_NEW), 0)
    same = int((got32["tokens"] == got["tokens"]).sum())
    log(f"whisper: bf16 and float32 agree on {same} of {got['tokens'].numel()} tokens")
    oracle = oracle_check(lm, params, cfg32, batch, got32, "whisper float32 replica", 0)
    del params
    torch.cuda.empty_cache()
    return (dict(arch=cfg.name, params=n_params, serve=serve, bf16_forward=bf16,
                 replica=dict(prefill_s=got32["prefill_s"], decode_s=got32["decode_s"],
                              bf16_tokens_equal=same, **oracle)),
            bf16["launches"])


def unrotate(lm, k, cfg, device) -> torch.Tensor:
    """Cached keys ``[B, S, KH, hd]`` (positions 0..S-1) rotated back by
    RoPE's tables as ``device`` computes them."""
    k = k.to(device)
    pos = torch.arange(k.shape[1], device=device)[None]
    cos, sin = lm.layers.rotary_embedding(pos, cfg.head_dim, cfg.rope_theta)
    return lm.layers.apply_rotary(k, cos, -sin)


def llava_cpu_check(lm, params, cfg32, batch) -> dict:
    """The first LLAVA_CPU_LAYERS layers of the float32 weights (the rest
    dropped), one row's prefill on the card (its patch prefix and first
    LLAVA_CPU_TEXT tokens: flash once a layer) with each
    layer's attention and MLP captured: each again on the CPU on the card's
    own input (the attention through ``chunked_attention``), its output and
    the attention's cached K (before RoPE) and V within LLAVA_CPU_RTOL of
    the largest, cached positions equal (as phase 12 holds each MoE
    layer)."""
    del params.blocks[LLAVA_CPU_LAYERS:]
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg32, n_layers=LLAVA_CPU_LAYERS)
    one = dict(tokens=batch["tokens"][:1, :LLAVA_CPU_TEXT], patches=batch["patches"][:1])
    max_len = LLAVA_CPU_TEXT + cfg.n_patches
    real_attn, real_mlp = lm.attn.attention_prefill, lm.layers.mlp_apply
    calls = []

    def attention_prefill(mod, x, c, n, **kw):
        out, cache = real_attn(mod, x, c, n, **kw)
        calls.append(("attention", mod, x.cpu(), dict(out=out.cpu(), **{
            k: t.cpu() for k, t in cache.items()}), kw))
        return out, cache

    def mlp_apply(mod, x, kind):
        out = real_mlp(mod, x, kind)
        calls.append(("mlp", mod, x.cpu(), dict(out=out.cpu()), kind))
        return out

    with mock.patch.object(lm.attn, "attention_prefill", attention_prefill), \
            mock.patch.object(lm.layers, "mlp_apply", mlp_apply):
        count_flash(lm, f"llava float32, first {LLAVA_CPU_LAYERS} layers, card",
                    functools.partial(lm.prefill, params, one, cfg, max_len), LLAVA_CPU_LAYERS)
    if [c[0] for c in calls] != ["attention", "mlp"] * LLAVA_CPU_LAYERS:
        raise AssertionError(f"llava card vs CPU: captured {[c[0] for c in calls]}")
    t = time.perf_counter()
    rows = []
    for i, (kind, mod, x, card, extra) in enumerate(calls):
        host = copy.deepcopy(mod).cpu()
        with torch.inference_mode():
            if kind == "attention":
                out, cache = real_attn(host, x, cfg, max_len, **extra)
                want = dict(out=out, **cache)
            else:
                want = dict(out=real_mlp(host, x, extra))
        del host
        errs = {}
        if kind == "attention":
            # K is cached after RoPE, whose float32 angles pos · θ^(-2i/d)
            # the two devices round apart (1.7e-4 of the largest K at 4,095
            # positions): each K is held after its own device's inverse
            # rotation, and the rotated K's error is reported
            errs["k_rotated"] = float((card["k"] - want["k"]).abs().max()
                                      / want["k"].abs().max())
            card["k"] = unrotate(lm, card["k"], cfg, "cuda").cpu()
            want["k"] = unrotate(lm, want["k"], cfg, "cpu")
        for name, w in want.items():
            if name == "pos":
                if not torch.equal(card[name], w):
                    raise AssertionError(f"llava layer {i // 2} {kind}: cached positions differ")
                continue
            errs[name] = within(f"llava layer {i // 2} {kind} {name}, card vs CPU",
                                card[name].float(), w.float(), LLAVA_CPU_RTOL)
        rows.append(dict(layer=i // 2, part=kind, rel_err=errs))
        log(f"llava float32 layer {i // 2} {kind} on the card's input, card vs CPU over "
            f"{max_len} positions: errors of the largest {errs} (tol {LLAVA_CPU_RTOL})")
    cpu_s = time.perf_counter() - t
    log(f"llava card vs CPU: {len(rows)} sublayers, CPU {cpu_s:.3f}s")
    return dict(layers=LLAVA_CPU_LAYERS, positions=max_len, cpu_s=cpu_s, sublayers=rows,
                rtol=LLAVA_CPU_RTOL)


def llava_leg(lm, gen) -> tuple:
    """llava-next-mistral-7b at full width and depth (32 layers, bf16): 2
    requests of 2,880 patch embeddings + 1,216 tokens through prefill /
    decode_step, flash 32 times a prefill; the bf16 forward at 4,096
    positions against the plain path and the float32 model; the float32
    replica (full depth) against the full forward; then its first layers on
    the card against the CPU.  Returns (the leg's JSON, the serving
    prefill's flash launches: ``count_flash``'s counts)."""
    cfg = lm.get_config(LLAVA_ARCH)
    t = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, vocab {cfg.vocab}, "
        f"{cfg.n_patches} patches, {cfg.dtype}, {n_params} parameters, "
        f"{time.perf_counter() - t:.2f}s to draw")
    rng = np.random.RandomState(SEED + 14)
    patches = torch.randn(LLAVA_REQUESTS, cfg.n_patches, cfg.d_model, device="cuda",
                          generator=gen)
    tokens = torch.from_numpy(rng.randint(1, cfg.vocab, (LLAVA_REQUESTS, LLAVA_TEXT)))
    batch = dict(tokens=tokens.cuda(), patches=patches)
    launches = cfg.n_layers
    serve, got = encdec_serve(lm, params, cfg, batch, LLAVA_NEW, launches, "llava bf16 serve")

    one = {k: t[:1] for k, t in batch.items()}
    bf16 = bf16_forward_check(lm, params, cfg, float32_of(params, cfg), one)
    bf16["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    cfg32 = dataclasses.replace(cfg, dtype_name="float32", param_dtype_name="float32")
    got32, _ = count_flash(lm, "llava float32 replica",
                           functools.partial(generate, lm, params, cfg32, batch, LLAVA_NEW),
                           launches)
    same = int((got32["tokens"] == got["tokens"]).sum())
    log(f"llava: bf16 and float32 agree on {same} of {got['tokens'].numel()} tokens")
    oracle = oracle_check(lm, params, cfg32, batch, got32, "llava float32 replica", launches)
    cpu = llava_cpu_check(lm, params, cfg32, batch)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return (dict(arch=cfg.name, params=n_params, serve=serve, bf16_forward=bf16,
                 replica=dict(prefill_s=got32["prefill_s"], decode_s=got32["decode_s"],
                              bf16_tokens_equal=same, **oracle),
                 cpu_check=cpu),
            serve["launches"])


def encdec_phase(lm) -> tuple:
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    whisper, n_whisper = whisper_leg(lm, gen)
    log(f"phase 13 leg 1 (whisper-medium): {time.perf_counter() - t:.1f}s")
    t2 = time.perf_counter()
    llava, n_llava = llava_leg(lm, gen)
    log(f"phase 13 leg 2 (llava-next-mistral-7b): {time.perf_counter() - t2:.1f}s")
    seconds = time.perf_counter() - t
    log(f"phase 13: {seconds:.1f}s")
    launches = dict(whisper_forward=n_whisper, llava_prefill=n_llava)
    return dict(whisper=whisper, llava=llava, seconds=seconds), launches


def lm_namespace() -> types.SimpleNamespace:
    """The LM substrate's entry points that phases 7, 12 and 13 drive."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import attention as lm_attention
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import mamba as lm_mamba
    from repro_torch.models import model as lm_model
    from repro_torch.models import moe as lm_moe
    from repro_torch.models import xlstm as lm_xlstm
    from repro_torch.models.attention import chunked_attention
    from repro_torch.serve import Engine, Request, ServeConfig

    return types.SimpleNamespace(
        get_config=get_config, init_params=lm_model.init_params,
        init_cache=lm_model.init_cache, prefill=lm_model.prefill, encode=lm_model.encode,
        decode_step=lm_model.decode_step, forward=lm_model.forward,
        chunked_attention=chunked_attention, Engine=Engine, Request=Request,
        ServeConfig=ServeConfig, kops=kops, ref=ref, moe=lm_moe, mb=lm_mamba, xl=lm_xlstm,
        num_moe_layers=lm_model.num_moe_layers, launch_serve=launch_serve.main,
        attn=lm_attention, layers=lm_layers,
    )


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device available")
    sys.stdout.reconfigure(line_buffering=True)
    from repro_torch.core import (
        VERSIONS,
        AggregateQuery,
        Cofactors,
        FactorizedEngine,
        Relation,
        Store,
        cofactors_factorized,
        cofactors_grouped,
        cofactors_materialized,
        cofactors_streaming,
        compute_scale_factors,
        design_matrix,
        linear_regression,
        rescale_theta,
        solve_cofactor,
    )
    from repro_torch.core import (
        GLMConfig,
        compressed_design_factorized,
        fit_glm,
        glm_regression,
    )
    from repro_torch.core import distributed
    from repro_torch.core import factorize as fz
    from repro_torch.core import regression
    from repro_torch.core import glm
    from repro_torch.core import polynomial as poly
    from repro_torch.core.glm import glm_predict_raw
    from repro_torch.core.polynomial import expand_monomials, polynomial_cofactors
    from repro_torch.data import favorita_like, fd_star_schema
    from repro_torch.analysis import LockSanitizer
    from repro_torch.kernels import _build, ops as kops, ref
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import moments as mom
    from repro_torch.kernels import segment_gram as sg
    from repro_torch.kernels import segment_view as sv
    from repro_torch.launch import train as launch_train
    from repro_torch.train import compression, init_state, make_train_step
    from repro_torch.models import attention as lm_attention
    from repro_torch.models import model as lm_model
    from repro_torch.train._tree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.train.train_step import _TreeLoss as TreeLoss
    from repro_torch.train.checkpoint import latest_step
    from repro_torch.serve import (
        FactorizedService,
        FaultInjector,
        InjectedFault,
        RetryPolicy,
        ServiceStopped,
    )

    rt = types.SimpleNamespace(
        VERSIONS=VERSIONS, AggregateQuery=AggregateQuery,
        FactorizedEngine=FactorizedEngine, Relation=Relation, Store=Store,
        compute_scale_factors=compute_scale_factors,
        cofactors_factorized=cofactors_factorized,
        cofactors_grouped=cofactors_grouped,
        cofactors_materialized=cofactors_materialized,
        cofactors_streaming=cofactors_streaming, design_matrix=design_matrix,
        linear_regression=linear_regression, fz=fz,
        favorita_like=favorita_like, fd_star_schema=fd_star_schema, kops=kops,
        sv=sv, ref=ref, GLMConfig=GLMConfig,
        compressed_design_factorized=compressed_design_factorized,
        fit_glm=fit_glm, glm_regression=glm_regression,
        glm_predict_raw=glm_predict_raw, expand_monomials=expand_monomials,
        polynomial_cofactors=polynomial_cofactors, glm=glm, poly=poly,
        Cofactors=Cofactors, solve_cofactor=solve_cofactor, rescale_theta=rescale_theta,
        FactorizedService=FactorizedService, FaultInjector=FaultInjector,
        InjectedFault=InjectedFault, RetryPolicy=RetryPolicy, ServiceStopped=ServiceStopped,
        LockSanitizer=LockSanitizer, regression=regression, distributed=distributed,
        dist=torch.distributed, comp=compression,
    )
    tr = types.SimpleNamespace(
        setup=launch_train.setup, run=launch_train.run, init_state=init_state,
        make_train_step=make_train_step, tree_leaves=tree_leaves, tree_map=tree_map,
        latest_step=latest_step, tree_unflatten=tree_unflatten, TreeLoss=TreeLoss,
        tree_views=lm_model.tree_views, attention=lm_attention, kops=kops,
        dist=torch.distributed,
    )
    lm = lm_namespace()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    dry = start_dryrun()  # phase 11's dry run, on the host beside phases 1-11
    cells = start_mesh_cells()  # the production meshes, on the host beside every phase
    log("phase 1: build")
    seconds = _build.build()
    log(f"build seconds: {seconds:.2f}")
    for name in _build.SOURCES:
        ptxas = _build.library_path(name).with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line:
                    print(f"  {name}: {line.strip()}")

    log("phase 2: kernels vs plain versions")
    rows = kernel_phase(ref, sv, sg, mom, kops, kflash)

    bundle = favorita(rt)
    log("phase 3: main path")
    counts3, traversal = main_path(rt, bundle)
    for name in PHASE3_KERNELS:
        rows[name]["launches"] = counts3[name]
    for name in ("segment_view", "segment_reduce"):
        rows[name]["main_path"] = dict(
            nodes=[{k: v for k, v in nd.items() if k != "kernel"}
                   for nd in traversal["nodes"] if nd["kernel"] == name],
            per_traversal=traversal["per_traversal"][name],
        )
    rows["segment_reduce"]["main_path"]["split_us"] = traversal["transactions_split"]
    rows["moments"]["main_path"] = dict(phase3=traversal["moments"])

    log("phase 4: categorical regression and cofactor baselines")
    counts4, views4, grams, dist_inputs = categorical_phase(rt, bundle)
    for name in PHASE4_KERNELS[len(PHASE3_KERNELS):]:
        rows[name]["launches"] = counts4[name]
    for name in PHASE4_KERNELS:
        rows[name]["launches_by_phase"] = dict(phase3=counts3[name], phase4=counts4[name])
    # segment_view1 on its own paths: the degree-1 batch (phase 3) and the
    # categorical factorized leg's g: queries (phase 4)
    rows["segment_view1"]["main_path"] = {
        phase: dict(nodes=[{k: v for k, v in nd.items() if k != "kernel"}
                           for nd in got["nodes"]],
                    per_traversal=got["per_traversal"].get("segment_view1"))
        for phase, got in (("phase3", traversal["degree1"]), ("phase4", views4))}
    for name, got in grams.items():
        rows[name]["main_path"] = dict(phase4=got)

    log("phase 5: incremental maintenance")
    ingest = ingest_phase(rt, bundle)
    # phase 8 runs here, on phase 3's 18.6 M-row store
    log("phase 8: GLM and polynomial")
    glm_poly, counts8 = phase8(rt, bundle)
    # phase 9 too, on a fresh store over phase 3's relations
    log("phase 9: the factorized service")
    service, counts9 = service_phase(rt, bundle, traversal["theta_closed"])
    del bundle
    ingest_oracle(rt)
    t = time.perf_counter()
    service["oracle"] = service_oracle(rt, traversal["theta_closed"])
    service["oracle"]["seconds"] = time.perf_counter() - t
    log(f"phase 9 legs 2 and 3 (oracle cell, faults, sanitized): "
        f"{service['oracle']['seconds']:.1f}s")
    # the drains, phase 8 and phase 9 (its first and its sanitized leg)
    # are slices' paths: their launches join the main path's
    for phase, got in (("phase5", ingest["launches"]), ("phase8", counts8),
                       ("phase9", counts9),
                       ("phase9_sanitized", service["oracle"]["sanitized"]["launches"])):
        for name, n in got.items():
            if name == "flash_f32":  # a share of flash's count, no kernel of its own
                continue
            rows[name]["launches"] += n
            rows[name]["launches_by_phase"][phase] = n
    rows["segment_reduce"]["ingest"] = dict(
        merges=[{k: v for k, v in nd.items() if k != "kernel"} for nd in ingest["merges"]])
    rows["segment_reduce"]["polynomial"] = glm_poly["polynomial"]["calls"]
    sanitized = service["oracle"]["sanitized"]
    for key, legs in (("service", service), ("sanitized", sanitized)):
        for name in SERVICE_KERNELS:
            rows[name][key] = {
                step: [{k: v for k, v in nd.items() if k != "kernel"}
                       for nd in got["nodes"] if nd["kernel"] == name]
                for step, got in legs["calls"].items()}
        legs["calls"] = {step: got["per_kernel"] for step, got in legs["calls"].items()}
    for name in PHASE8_KERNELS:
        rows[name]["glm_compression"] = {
            leg: [{k: v for k, v in nd.items() if k != "kernel"}
                  for nd in got["calls"] if nd["kernel"] == name]
            for leg, got in glm_poly["glm"].items()}

    log("phase 6: float64 oracle")
    oracle_phase(rt)
    fd_oracle(rt)

    log("phase 7: LM serving")
    counts7 = lm_phase(lm)
    launches7 = counts7["flash"]
    rows["flash"]["launches"] = launches7

    log("phase 10: distribution at world size 1")
    distribution = dist_phase(rt, dist_inputs)
    del dist_inputs
    for name in DIST_KERNELS:
        rows[name]["launches"] += distribution["launches"][name]
        rows[name]["launches_by_phase"]["phase10"] = distribution["launches"][name]
        rows[name]["distribution"] = distribution["calls"][name]
    distribution["calls"] = {k: len(v) for k, v in distribution["calls"].items()}

    log("phase 11: LM training")
    training = train_phase(tr)
    log("phase 11: one float32 step of 1 x 4,096 tokens, kernels vs the plain path")
    training["long_step"] = long_step_leg(tr)
    log("phase 11: bf16 at 4 x 4,096 tokens, microbatches 4")
    training["bf16_4k"] = bf16_train_leg(tr, dry)
    log("phase 11: --mesh 1x1 on NCCL")
    training["mesh_1x1"] = mesh_leg(tr)
    launches11 = {name: training["long_step"]["launches"][name]
                  + training["bf16_4k"]["launches"][name] for name in ("flash", "flash_bwd")}
    rows["flash_bwd"]["launches"] = launches11["flash_bwd"]
    rows["flash_bwd"]["launches_by_phase"] = dict(
        phase11=dict(long_step=training["long_step"]["launches"]["flash_bwd"],
                     bf16_4k=training["bf16_4k"]["launches"]["flash_bwd"]))
    rows["flash"]["launches"] += launches11["flash"]

    log("phase 12: the MoE, Mamba and xLSTM mixers")
    mixers, counts12, flash12 = mixers_phase(lm)
    launches12 = counts12["flash"]
    rows["flash"]["launches"] += launches12
    rows["flash"]["phase12"] = flash12

    log("phase 13: whisper-medium and llava-next-mistral-7b")
    encdec, counts13 = encdec_phase(lm)
    launches13 = {leg: c["flash"] for leg, c in counts13.items()}
    rows["flash"]["launches"] += sum(launches13.values())
    rows["flash"]["launches_by_phase"] = dict(phase7=launches7, phase11=launches11["flash"],
                                              phase12=launches12, phase13=launches13)
    # the float32 forwards among them, read from the same counted runs
    rows["flash"]["f32_launches_by_phase"] = dict(
        phase7=counts7["flash_f32"],
        phase11={leg: training[leg]["launches"]["flash_f32"] for leg in ("long_step", "bf16_4k")},
        phase12=counts12["flash_f32"],
        phase13={leg: c["flash_f32"] for leg, c in counts13.items()})
    log(f"flash float32 launches of the main path by phase: "
        f"{rows['flash']['f32_launches_by_phase']}")

    log("the sharded program on the production meshes (dry run, this host's torch)")
    meshes = mesh_cells(cells)

    print(json.dumps({"phase8": glm_poly}))
    print(json.dumps({"mesh_cells": meshes}))
    print(json.dumps({"service": service}))
    print(json.dumps({"distribution": distribution}))
    print(json.dumps({"training": training}))
    print(json.dumps({"mixers": mixers}))
    print(json.dumps({"encoder_decoder": encdec}))
    print(json.dumps({"kernels": [rows[n] for n in ALL_KERNELS]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
