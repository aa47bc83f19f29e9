#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, in order; any failed check raises and the script exits non-zero:

1. Report the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; build every CUDA kernel from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once).
2. Kernel phase: hold each kernel against its plain PyTorch version on the
   card at the shapes the main path gives it, and time both with CUDA
   events (median of repeated launches).
3. Main path: ``favorita_like(1684, 54, 4100, 0.05, seed=0)`` (18,641,880
   sales rows) through ``linear_regression`` v1 (BGD) and closed form, both
   with the moments kernel, then one degree-1 aggregate batch.  Launch
   counters are zeroed just before and read just after; every kernel must
   have launched.  The degree-1 batch is checked against float64 sums of
   the fact table.
4. Oracle: the torch engine on the card against the port's float64 numpy
   engine on the 410-item bundle (1,864,188 sales rows).

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


def kernel_phase(ref, sv, mom) -> dict:
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


def main_path(rt) -> dict:
    t0 = time.perf_counter()
    bundle = rt.favorita_like(1684, 54, 4100, 0.05, seed=SEED)
    store, vorder = bundle.store, bundle.vorder
    feats, label = bundle.features, bundle.label
    n = store.get("SalesF").num_rows
    log(f"data: {n} sales rows, {store.total_rows()} rows in all, "
          f"{time.perf_counter() - t0:.2f}s to generate")
    if n != N_SALES:
        raise AssertionError(f"expected {N_SALES} sales rows, got {n}")

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
    missing = [k for k, v in counts.items() if v == 0]
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


# -- phase 4: the float64 oracle ------------------------------------------------

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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device available")
    sys.stdout.reconfigure(line_buffering=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (
        VERSIONS,
        AggregateQuery,
        FactorizedEngine,
        compute_scale_factors,
        cofactors_factorized,
        linear_regression,
    )
    from repro_torch.core import factorize as fz
    from repro_torch.data import favorita_like
    from repro_torch.kernels import _build, ops as kops, ref
    from repro_torch.kernels import moments as mom
    from repro_torch.kernels import segment_view as sv

    rt = types.SimpleNamespace(
        VERSIONS=VERSIONS, AggregateQuery=AggregateQuery,
        FactorizedEngine=FactorizedEngine,
        compute_scale_factors=compute_scale_factors,
        cofactors_factorized=cofactors_factorized,
        linear_regression=linear_regression, fz=fz,
        favorita_like=favorita_like, kops=kops,
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
    rows = kernel_phase(ref, sv, mom)

    log("phase 3: main path")
    counts = main_path(rt)
    for name, row in rows.items():
        row["launches"] = counts[name]

    log("phase 4: float64 oracle")
    oracle_phase(rt)

    order = ("segment_view", "segment_view1", "segment_reduce", "moments")
    print(json.dumps({"kernels": [rows[n] for n in order]}))
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
