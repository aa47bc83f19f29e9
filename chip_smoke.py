#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, in order; any failed check raises and the script exits non-zero:

1. Report the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; build every CUDA kernel from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once).
2. Kernel phase: hold each kernel against its plain PyTorch version on the
   card at the shapes the main path gives it, and time both with CUDA
   events (median of repeated launches); also gram at K = 130, forced
   segment_gram group chunking and the multi_segment_gram per-column
   fallback.
3. Main path: ``favorita_like(1684, 54, 4100, 0.05, seed=0)`` (18,641,880
   sales rows) through ``linear_regression`` v1 (BGD) and closed form, both
   with the moments kernel, then one degree-1 aggregate batch.  Launch
   counters are zeroed just before and read just after; every kernel must
   have launched.  The degree-1 batch is checked against float64 sums of
   the fact table.
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
   launched.
5. Oracle: the torch engine on the card against the port's float64 numpy
   engine on the 410-item bundle (1,864,188 sales rows), for the continuous
   and the categorical closed form; and the FD leg on ``fd_star_schema``
   (8 categorical keys, each determining a second one): FD-reduced equals
   full at 1e-10 on the numpy engine and predicts alike through the
   float32 ``multi_segment_gram`` kernel.

The last lines are the kernels JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
N_SALES = 18_641_880  # favorita_like(1684, 54, 4100, 0.05) fact rows
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, off the tensor cores
# kernel vs plain: both sum in float32 in run-dependent orders (atomics);
# the rounding error of a sum of n terms is ~sqrt(n)·2^-24·Σ|terms|, under
# 1e-5 of the largest sum at the ≤ 10^4 terms per group these shapes have
KERNEL_RTOL = 1e-4
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


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
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
    dev = "cuda"
    c = torch.rand(m, device=dev, generator=gen) + 0.5
    x = torch.randn(m, device=dev, generator=gen)
    l = torch.randn(m, k, device=dev, generator=gen)
    q = torch.randn(m, k, k, device=dev, generator=gen)
    if g == m:  # one row per group, in no order (first feature nodes)
        seg = torch.randperm(m, device=dev, generator=gen)
    else:
        seg = torch.randint(0, g, (m,), device=dev, generator=gen)
    return c, x, l, q, seg.to(torch.int32)


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


def kernel_phase(ref, sv, mom, kops) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}

    def check(name, node, got, expect):
        err, scale = max_err(got, expect)
        tol = KERNEL_RTOL * max(1.0, scale)
        log(f"{name:15s} {node:13s} max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"{name} at {node}: error {err} > {tol}")
        return err, tol

    for degree, name in ((2, "segment_view"), (1, "segment_view1")):
        for node, m, k, g in FEATURE_NODES:
            c, x, l, q, seg = view_inputs(m, k, g, gen)
            qq = q if degree == 2 else None
            args = (c, x, l, qq, seg, g)
            kern = functools.partial(sv.segment_view, *args, degree=degree)
            plain = functools.partial(ref.segment_view_ref, *args, degree=degree)
            err, tol = check(name, node, kern(), plain())
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
                shape=dict(node=node, rows=m, k=k, groups=g, degree=degree),
                max_abs_err=err, tol=tol,
                ms=time_ms(kern), plain_ms=time_ms(plain),
                bound_ms=b, bound_by=by, library_ms=None,
            )
    for node, m, g in REGROUP_NODES:
        c, _, l, q, seg = view_inputs(m, 0, g, gen)
        kern = functools.partial(sv.segment_blocks, c, l, q, seg, g, degree=2)
        plain = functools.partial(ref.segment_blocks_ref, c, l, q, seg, g, degree=2)
        err, tol = check("segment_reduce", node, kern(), plain())
        if node == TIMED_REGROUP_NODE:
            lib = functools.partial(
                library_segment_sum, c[:, None].contiguous(), seg.long(), g
            )
            b, by = bound_ms(m * 8 + g * 4, m)
            rows["segment_reduce"] = dict(
                name="segment_reduce", route="cuda",
                source="src/repro_torch/csrc/segment_view.cu",
                replaces="src/repro/kernels/segment_view.py:212 segment_reduce_kernel_call",
                shape=dict(node=node, rows=m, width=1, groups=g),
                max_abs_err=err, tol=tol,
                ms=time_ms(kern), plain_ms=time_ms(plain),
                bound_ms=b, bound_by=by, library_ms=time_ms(lib),
            )
    rows.update(gram_family(ref, kops, gen, check))
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


def gram_family(ref, kops, gen, check) -> dict:
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
    err, tol = check("segment_gram", "item K=6", (kern(),), (want,))
    budget = 32 * 1024  # forces 11 chunks of at most 390 groups
    errc, tolc = check("segment_gram", "item chunked",
                       (kops.segment_gram(u, item, g_item, smem_budget=budget),), (want,))
    del want
    b, by = bound_ms(m * 6 * s + m * 4 + g_item * 36 * s, m * 21 * 2)
    rows["segment_gram"] = dict(
        name="segment_gram", route="cuda",
        source="src/repro_torch/csrc/segment_gram.cu",
        replaces="src/repro/kernels/segment_gram.py:65 segment_gram_kernel_call",
        shape=dict(rows=m, k=6, groups=g_item), max_abs_err=max(err, errc), tol=tol,
        ms=time_ms(kern), plain_ms=time_ms(plain, reps=3),
        bound_ms=b, bound_by=by, library_ms=None,
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
    )
    return rows


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
        with torch.profiler.profile(activities=activities) as prof:
            rt.linear_regression(store, vorder, feats, label, cfg)
            torch.cuda.synchronize()
        busy = device_busy_ms(prof) / 1e3
        ours = sum(
            us for name, us in device_ops(prof)
            if "segment_rows<" in name or "moments_kernel<" in name
        ) / 1e6
        log(f"closed device_busy={busy:.3f}s (port kernels {ours:.3f}s) of "
            f"{wall:.3f}s unprofiled wall: idle_share={1 - busy / wall:.4f}")
        for name, us in device_ops(prof)[:12]:
            log(f"  device {us / 1e3:10.3f} ms  {name[:100]}")
        # one degree-1 batch: every feature node through segment_view1
        cols = feats + [label]
        factors = results["closed"].factors
        eng = rt.FactorizedEngine(
            store, vorder, cols, scale=factors, device="cuda"
        )
        t = time.perf_counter()
        blk = eng.run_batch([rt.AggregateQuery("deg1", (), 1)])["deg1"]
        log(f"degree-1 batch: {time.perf_counter() - t:.3f}s")
    torch.cuda.synchronize()
    counts = rt.kops.launch_counts()
    log(f"passes={store.passes} node_visits={store.node_visits} "
          f"launches={counts} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    log("host seconds: " + " ".join(
        f"{k}={v:.3f}" for k, v in timers.seconds.items()))
    missing = [k for k in PHASE3_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

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
    return counts


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

    res = {}
    for leg, fact in (("factorized", True), ("materialized", False)):
        cfg = dataclasses.replace(
            rt.VERSIONS["closed"], backend="torch", device="cuda",
            categorical=CAT, factorized=fact, use_kernel=not fact,
        )
        r = timed(f"categorical {leg}",
                  functools.partial(rt.linear_regression, store, vorder, feats, label, cfg))
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
    groups = timed("cofactors_grouped by item_nbr", functools.partial(
        rt.cofactors_grouped, x, joined.column("item_nbr"), n_items, cols, device="cuda"))
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
    return counts


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
    from repro_torch.kernels import moments as mom
    from repro_torch.kernels import segment_view as sv

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
    )
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
    rows = kernel_phase(ref, sv, mom, kops)

    bundle = favorita(rt)
    log("phase 3: main path")
    counts = main_path(rt, bundle)
    for name in PHASE3_KERNELS:
        rows[name]["launches"] = counts[name]

    log("phase 4: categorical regression and cofactor baselines")
    counts = categorical_phase(rt, bundle)
    for name in PHASE4_KERNELS[len(PHASE3_KERNELS):]:
        rows[name]["launches"] = counts[name]
    del bundle

    log("phase 5: float64 oracle")
    oracle_phase(rt)
    fd_oracle(rt)

    print(json.dumps({"kernels": [rows[n] for n in PHASE4_KERNELS]}))
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
