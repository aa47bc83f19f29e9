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
   CTAs a tile, entry split, chunks) is held equal to its mirror, and
   segment_gram must take one launch at K = 6, G = 4,100.  Also gram at
   K = 130, forced segment_gram group chunking, chunking by the plan at
   K = 40, G = 4,000, a float64 and a K = 313 grouped Gram, the
   multi_segment_gram per-column fallback, and flash at the serving
   path's shape (bf16 and float32),
   olmo-1b's and mixtral's head layouts (the latter windowed), non-causal
   ragged lengths and the head dims 8 to 256.
3. Main path: ``favorita_like(1684, 54, 4100, 0.05, seed=0)`` (18,641,880
   sales rows) through ``linear_regression`` v1 (BGD) and closed form, both
   with the moments kernel, then one degree-1 aggregate batch.  Launch
   counters are zeroed just before and read just after; every kernel must
   have launched.  The degree-1 batch is checked against float64 sums of
   the fact table.  The arguments of the profiled closed-form traversal's
   ``segment_view`` and ``segment_blocks`` calls are captured, and each
   call runs again: against its plain version, path A bitwise equal across
   two calls, one float64 call per path, timed per call and back to back
   beside its bound and its device time in the profiled traversal; then
   the host/device split of one regroup at transactions against
   ``index_add_``.  The degree-1 batch runs profiled, and its
   ``segment_view`` calls are captured and run again the same way.
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
   version and is timed beside its bound.
5. Oracle: the torch engine on the card against the port's float64 numpy
   engine on the 410-item bundle (1,864,188 sales rows), for the continuous
   and the categorical closed form; and the FD leg on ``fd_star_schema``
   (8 categorical keys, each determining a second one): FD-reduced equals
   full at 1e-10 on the numpy engine and predicts alike through the
   float32 ``multi_segment_gram`` kernel.
6. LM serving: smollm-135m at its full published width and depth (30
   layers, d_model 576, 9 query / 3 KV heads, vocab 49,152, bf16; random
   weights from a seeded generator) behind the continuous-batching
   ``Engine`` (4 slots, prompts padded to 4,096 tokens, a 4,160-slot
   cache) answers 8 requests of 2,049–4,096 prompt tokens and 32 new tokens
   each.  Counters are zeroed before and read after: the flash kernel must
   have launched exactly 30 times per prefill.  Then the same weights in
   float32 serve the same requests; their greedy tokens must be those of
   the full-forward oracle (one teacher-forced forward per request, which
   also runs flash 30 times), except at reported near-ties (top logit within
   1e-3 of the engine's pick), and a prefill's last logits must match the
   plain ``chunked_attention`` path on the card within 1e-4 of the largest.
   Last, the bf16 model's forward logits at all 4,096 positions through
   flash are held to the plain path in bf16 and, beside it, to the float32
   model (flash may be no farther from float32 than the plain path is).

The last lines are the kernels JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SEED = 0
N_SALES = 18_641_880  # favorita_like(1684, 54, 4100, 0.05) fact rows
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, off the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense tensor cores
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
GRAM_WIDE = (1_000_000, 130)  # the reference's widest gram test, scaled up
# the kernels each path must launch: phase 3 (the continuous main path)
# and phase 4 (all seven)
PHASE3_KERNELS = ("segment_view", "segment_view1", "segment_reduce", "moments")
PHASE4_KERNELS = PHASE3_KERNELS + ("gram", "segment_gram", "multi_segment_gram")
ALL_KERNELS = PHASE4_KERNELS + ("flash",)  # phase 6 launches flash
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
# phase 6: smollm-135m behind the engine
LM_ARCH = "smollm-135m"
LM_SERVE = dict(slots=4, prefill_len=4_096, max_len=4_160)
LM_REQUESTS, LM_NEW, LM_PROMPT = 8, 32, (2_049, 4_096)
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


def gram_plan_check(sg) -> None:
    """The grouped Grams' launch plan (CTAs a tile, entries a CTA, stages, rows,
    groups a launch holds, chunks, shared memory): the Python mirror
    (``kernels/segment_gram.py:plan``, which the CPU tests check) must equal
    the library's own at every width, group count, type and column count
    below (the main path's among them)."""
    n = 0
    for k in (1, 2, 3, 4, 5, 6, 7, 8, 9, 40, 130, 221, 313):
        for total in (1, 54, 4_100, 4_154, 17_200, 90_936):
            for elem in (4, 8):
                for n_seg in (1, 2, 16):
                    got, want = sg.kernel_plan(k, total, elem, n_seg), sg.plan(k, total, elem, n_seg)
                    if got != want:
                        raise AssertionError(
                            f"segment_gram plan {(k, total, elem, n_seg)}: {got} != {want}")
                    n += 1
    log(f"{'segment_gram':15s} plans of {n} shapes as mirrored; K 6, G 4,100: "
        f"{sg.plan(6, 4_100, 4)}; K 4, G 54 + 4,100: {sg.plan(4, 4_154, 4, 2)}")


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
    b, by = bound_ms(m * 4 + 8, 2 * m)
    rows["moments"] = dict(
        name="moments", route="cuda",
        source="src/repro_torch/csrc/moments.cu",
        replaces="src/repro/kernels/moments.py:41 moments_kernel_call",
        shape=dict(column="date", rows=m),
        max_abs_err=err, tol=tol,
        ms=time_ms(kern), plain_ms=time_ms(plain),
        bound_ms=b, bound_by=by, library_ms=None,
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
        ms_back_to_back=time_ms_back_to_back(kern), launches_per_call=n_launch,
        plan=sg.plan(6, g_item, 4), also=other,
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
        ms_back_to_back=time_ms_back_to_back(kern), plan=sg.plan(4, sum(groups), 4, 2),
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
FLASH_SHAPES = [
    ("smollm-135m prefill", 1, 4096, 4096, 9, 3, 64, True, None, None, BF16, True),
    ("smollm-135m prefill", 1, 4096, 4096, 9, 3, 64, True, None, None, F32, True),
    ("olmo-1b heads", 1, 4096, 4096, 16, 16, 128, True, None, None, BF16, True),
    ("mixtral heads, window 1024", 1, 4096, 4096, 32, 8, 128, True, 1024, None, BF16, True),
    ("non-causal ragged", 2, 1000, 3001, 8, 2, 64, False, None, None, BF16, True),
    ("non-causal ragged", 2, 1000, 3001, 8, 2, 64, False, None, None, F32, True),
    ("non-causal, kv_len 2,777 of 3,001", 2, 1000, 3001, 8, 2, 64, False, None, 2777, BF16, True),
    ("non-causal, kv_len 0", 2, 1000, 3001, 8, 2, 64, False, None, 0, BF16, False),
    ("causal 1,111 tokens, head dim 128", 1, 1111, 1111, 4, 1, 128, True, None, None, BF16, True),
    ("head dim 8", 1, 300, 300, 2, 1, 8, True, None, None, BF16, False),
    ("head dim 40, window 50", 1, 300, 300, 2, 1, 40, True, 50, None, BF16, False),
    ("head dim 40, window 50", 1, 300, 300, 2, 1, 40, True, 50, None, F32, False),
    ("head dim 256", 1, 333, 333, 2, 2, 256, True, None, None, BF16, False),
    ("head dim 256", 1, 333, 333, 2, 2, 256, True, None, None, F32, False),
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
    ``also``.  First the bf16 instantiation the library reports for every
    head dim must be the one ``kernels/flash.py`` mirrors (and the CPU tests
    check)."""
    for d in range(8, 257, 8):
        got, want = kflash.kernel_bf16_geometry(d), kflash.bf16_geometry(d)
        if got != want:
            raise AssertionError(f"flash bf16 geometry at head dim {d}: {got} != {want}")
    log(f"{'flash':15s} bf16 geometry of head dims 8-256 as mirrored: "
        f"{sorted({tuple(kflash.bf16_geometry(d).values()) for d in (16, 32, 64, 128, 256)})}")
    out = []
    for what, b, sq, sk, h, kh, d, causal, window, kv_len, dt, timed in FLASH_SHAPES:
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
            s = q.element_size()
            nbytes = 2 * b * sq * h * d * s + 2 * b * kv_len * kh * d * s
            flops = 4 * d * h * b * visible_pairs(sq, kv_len, causal, window)
            bnd, by = bound_ms(nbytes, flops, BF16_FLOPS if dt == BF16 else FP32_FLOPS)
            lib = library_attention(q, k, v, causal, window, kv_len)
            row.update(
                ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=bnd, bound_by=by,
                library_ms=time_ms(lib), ms_back_to_back=time_ms_back_to_back(kern),
                library_ms_back_to_back=time_ms_back_to_back(lib),
            )
            row["pct_of_bound"] = 100 * bnd / row["ms"]
            log(f"{'flash':15s} {name:34s} ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"bound_ms={bnd:.4f} ({by}, {row['pct_of_bound']:.1f} %) "
                f"library_ms={row['library_ms']:.4f}; back to back "
                f"{row['ms_back_to_back']:.4f} vs library {row['library_ms_back_to_back']:.4f}")
        out.append(row)
        del q, k, v, got, want, diff
    main = out[0]
    return dict(
        name="flash", route="cuda", source="src/repro_torch/csrc/flash.cu",
        replaces="src/repro/kernels/flash.py:106 flash_kernel_call",
        **main, also=out[1:],
    )


# -- phase 3: the main path ---------------------------------------------------

class HostTimers:
    """Wall seconds spent in the engine's host-side structure work (joins,
    group keys, group ids), by patching the names the engine module calls."""

    NAMES = ("join_keys", "sort_merge_join", "group_key")

    def __init__(self, fz, kops):
        self.fz, self.kops = fz, kops
        self.seconds = {n: 0.0 for n in self.NAMES + ("group_ids_device",)}

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t0
        return timed

    def __enter__(self):
        self.saved = {n: getattr(self.fz, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(self.fz, n, self._wrap(n, fn))
        self.saved_gid = self.kops.group_ids_device
        self.kops.group_ids_device = self._wrap("group_ids_device", self.saved_gid)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.fz, n, fn)
        self.kops.group_ids_device = self.saved_gid


class Capture:
    """The arguments of every call of ``names`` (by default the engine's
    ``segment_view`` and ``segment_blocks``), by patching the names the
    engine module calls (as HostTimers does).  The tensors are kept, not
    copied (~1.3 GB on the card for one closed-form traversal of the 18.6
    M-row bundle)."""

    NAMES = ("segment_view", "segment_blocks")

    def __init__(self, kops, names=NAMES):
        self.kops, self.names, self.calls = kops, names, []

    def _wrap(self, name, fn):
        def captured(*args, **kwargs):
            self.calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
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
    bundle = rt.favorita_like(1684, 54, 4100, 0.05, seed=SEED)
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
    with HostTimers(rt.fz, rt.kops) as timers:
        for version in ("v1", "closed"):
            cfg = dataclasses.replace(
                rt.VERSIONS[version], backend="torch", device="cuda",
                use_kernel=True,
            )
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
        # 200,000 small steps would swamp the trace)
        activities = [
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]
        # (the segment kernels' arguments are captured in this run, after
        # the peak memory of the path is read)
        peak = torch.cuda.max_memory_allocated()
        with torch.profiler.profile(activities=activities) as prof, \
                Capture(rt.kops) as cap:
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
        # one degree-1 batch: every feature node through segment_view1
        cols = feats + [label]
        factors = results["closed"].factors
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
    del cap, cap1

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
    seg = torch.as_tensor(args[-2], device=args[0].device)
    seg = seg if seg.dtype == torch.int32 else seg.to(torch.int32)
    kw = dict(degree=kwargs.get("degree", 2), order=kwargs.get("order"))
    blocks = [cast(t.contiguous()) if t is not None else None for t in args[:-2]]
    kern_fn, plain_fn = ((sv.segment_view, ref.segment_view_ref) if name == "segment_view"
                         else (sv.segment_blocks, ref.segment_blocks_ref))
    return (functools.partial(kern_fn, *blocks, seg, int(args[-1]), **kw),
            functools.partial(plain_fn, *blocks, seg, int(args[-1]), degree=kw["degree"]))


def main_path_kernels(rt, calls, device_ms, split: bool = True) -> dict:
    """Each captured call of the closed-form traversal again, on its own
    arguments: kernel vs plain version (KERNEL_RTOL), path A bitwise equal
    across two calls, one float64 call per (kernel, path) within F64_RTOL;
    timed per call and back to back, beside its plain version, its bound
    and its device time in the profiled traversal; with ``split``, the
    host/device split of the regroup at transactions."""
    sv, ref = rt.sv, rt.ref
    rows, f64_done = [], set()
    log(f"main path's own segment ids: {len(calls)} captured calls")
    for (name, args, kwargs), dev_ms in zip(calls, device_ms):
        nd = call_node(sv, name, args, kwargs)
        kern, plain = call_pair(sv, ref, name, args, kwargs)
        got = kern()
        err, scale = max_err(got, plain())
        tol = KERNEL_RTOL * max(1.0, scale)
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
    a, b = got.matrix(), want.matrix()
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    log(f"{what}: max_abs_err={err:.3e} tol={ORACLE_RTOL * scale:.3e}")
    if not err <= ORACLE_RTOL * scale:
        raise AssertionError(f"{what}: {err} > {ORACLE_RTOL * scale}")
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
    for leg, fact in (("factorized", True), ("materialized", False)):
        cfg = cfgs[leg] = dataclasses.replace(
            rt.VERSIONS["closed"], backend="torch", device="cuda",
            categorical=CAT, factorized=fact, use_kernel=not fact,
        )
        with (cap_multi if leg == "materialized" else contextlib.nullcontext()):
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
    del joined, x, one, stream

    # after the counts: the factorized leg again, profiled, for its
    # degree-1 calls (the g: queries) on their own arguments
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
    return counts, views, grams


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


# -- phase 5: the float64 oracle ------------------------------------------------

def oracle_phase(rt) -> None:
    bundle = rt.favorita_like(1684, 54, 410, 0.05, seed=SEED)
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

    # the categorical closed form: torch on the card vs the float64 engine
    cat = {}
    for backend in ("numpy", "torch"):
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


# -- phase 6: LM serving ---------------------------------------------------------

def plain_flash(chunked_attention):
    """A stand-in for ``ops.flash_attention`` that runs its plain version on
    the model's path, ``chunked_attention`` with arange positions (patched
    in for the logits comparison only; it launches no kernel)."""
    def run(q, k, v, *, causal, window, kv_len):
        b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
        if not sq == sk == kv_len:
            raise ValueError(f"prefill attention expected, got Sq {sq}, Sk {sk}, kv_len {kv_len}")
        pos = torch.arange(sq, dtype=torch.int32, device=q.device)[None].expand(b, sq)
        return chunked_attention(q, k, v, pos, pos, causal=causal, window=window,
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
    launched ``expect`` times.  Returns (``fn``'s result, launches)."""
    lm.kops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    n = lm.kops.launch_counts()["flash"]
    log(f"{what}: flash launches {n} (expected {expect})")
    if n != expect:
        raise AssertionError(f"{what}: flash launched {n} times, expected {expect}")
    return out, n


def bf16_forward_check(lm, params, cfg, params32, cfg32, batch) -> None:
    """The serving dtype end to end: bf16 forward logits at every position of
    ``batch`` through flash against the plain ``chunked_attention`` path, both
    held to the float32 model on the same weights (on the plain path too, so
    that no kernel is in the baseline)."""
    v = cfg.vocab

    def logits(p, c):
        return lm.forward(p, batch, c)[0][0, :, :v]

    kern, _ = count_flash(lm, "bf16 forward", functools.partial(logits, params, cfg),
                          cfg.n_layers)
    with mock.patch.object(lm.kops, "flash_attention", plain_flash(lm.chunked_attention)):
        plain, _ = count_flash(lm, "bf16 forward, plain path",
                               functools.partial(logits, params, cfg), 0)
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


def lm_phase(lm) -> int:
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

    def oracle():
        ties = []
        for uid, prompt in enumerate(prompts):
            gen = res32[uid].tokens
            seq = torch.tensor([prompt + gen[:-1]], device="cuda")
            logits, _ = lm.forward(params32, {"tokens": seq}, cfg32)
            steps = logits[0, len(prompt) - 1 :, : cfg.vocab]
            top = steps.max(dim=-1).values
            picked = steps[torch.arange(LM_NEW, device="cuda"), torch.tensor(gen, device="cuda")]
            gap = (top - picked).cpu().numpy()
            for t in np.nonzero(gap > 0)[0]:
                ties.append((uid, int(t), float(gap[t])))
                if not gap[t] < NEAR_TIE:
                    raise AssertionError(
                        f"request {uid} step {t}: engine picked {gen[t]}, "
                        f"{gap[t]:.3e} under the oracle's top logit")
        return ties
    ties, _ = count_flash(lm, "float32 oracle forwards", oracle, per_prefill * LM_REQUESTS)
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
    bf16_forward_check(lm, params, cfg, params32, cfg32, batch)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device available")
    sys.stdout.reconfigure(line_buffering=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (
        VERSIONS,
        AggregateQuery,
        FactorizedEngine,
        cofactors_factorized,
        cofactors_grouped,
        cofactors_materialized,
        cofactors_streaming,
        compute_scale_factors,
        design_matrix,
        linear_regression,
    )
    from repro_torch.core import factorize as fz
    from repro_torch.data import favorita_like, fd_star_schema
    from repro_torch.kernels import _build, ops as kops, ref
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import moments as mom
    from repro_torch.kernels import segment_gram as sg
    from repro_torch.kernels import segment_view as sv
    from repro_torch.configs import get_config
    from repro_torch.models import model as lm_model
    from repro_torch.models.attention import chunked_attention
    from repro_torch.serve import Engine, Request, ServeConfig

    rt = types.SimpleNamespace(
        VERSIONS=VERSIONS, AggregateQuery=AggregateQuery,
        FactorizedEngine=FactorizedEngine,
        compute_scale_factors=compute_scale_factors,
        cofactors_factorized=cofactors_factorized,
        cofactors_grouped=cofactors_grouped,
        cofactors_materialized=cofactors_materialized,
        cofactors_streaming=cofactors_streaming, design_matrix=design_matrix,
        linear_regression=linear_regression, fz=fz,
        favorita_like=favorita_like, fd_star_schema=fd_star_schema, kops=kops,
        sv=sv, ref=ref,
    )
    lm = types.SimpleNamespace(
        get_config=get_config, init_params=lm_model.init_params,
        init_cache=lm_model.init_cache, prefill=lm_model.prefill,
        decode_step=lm_model.decode_step, forward=lm_model.forward,
        chunked_attention=chunked_attention, Engine=Engine, Request=Request,
        ServeConfig=ServeConfig, kops=kops,
    )
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

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

    log("phase 4: categorical regression and cofactor baselines")
    counts4, views4, grams = categorical_phase(rt, bundle)
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
    del bundle

    log("phase 5: float64 oracle")
    oracle_phase(rt)
    fd_oracle(rt)

    log("phase 6: LM serving")
    rows["flash"]["launches"] = lm_phase(lm)

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
