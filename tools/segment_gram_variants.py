#!/usr/bin/env python3
"""Ablation of the grouped Gram kernels (``csrc/segment_gram.cu``) on one
GPU, at phase 2's shapes and on phase 4's own arguments.

    python3 tools/segment_gram_variants.py OLD_CU OLD_PY     # from the repo root

``OLD_CU`` / ``OLD_PY`` are the earlier design's ``csrc/segment_gram.cu``
and its ``kernels/segment_gram.py`` wrapper (from ``git show REV:PATH``,
kept under a gitignored directory): one copy of every band, the lanes of
a warp that share a group merged (``__match_any_sync`` and a shuffle
tree) before their lowest adds two compare-and-swaps at a time, the group
counts copied to the device on each call.

The script builds, at once and with the port's ``nvcc`` flags, into
``chiprun_out/segment_gram_variants/``:

* ``new``            the checkout's ``csrc/segment_gram.cu`` (the port's build)
* ``old``            ``OLD_CU``, driven through ``OLD_PY``
* ``OLD_CU`` edited by :data:`OLD_EDITS`, timing only but ``old_rows256``:
  what the earlier design spends besides its adds

  - ``old_loads_only``        the ring, its mbarrier waits and the flush alone
  - ``old_adds_off``          also ids, products, match_any and the shuffle tree
  - ``old_adds_off_no_match`` ids and products, without the merging
  - ``old_flush_off`` / ``old_expand_off``  no global adds / no expand kernel
  - ``old_rows256`` / ``old_loads_only_rows256``  stages of up to 256 rows

* the checkout's source edited by :data:`EDITS` (old text, new text), driven
  through the checkout's wrapper (edited too where the plan changes):

  - ``one_copy`` / ``copies8``  the hot bands in 1 / at most 8 copies, not 16
  - ``merge_hot``      the hot bands' lanes of a group merged first
  - ``odd_stride``     every band at an odd stride, no rotation
  - ``no_rotation``    one-copy bands' entries not rotated across the banks
  - ``atomicAdd``      every add through atomicAdd (no compare-and-swaps)
  - ``cas_retry``      a lost compare-and-swap swaps again, not atomicAdd
  - ``batch2`` / ``batch4``  two / four compare-and-swaps in flight a lane
  - ``cluster_launch`` each crew (the CTAs that read the same tiles) a
                       thread-block cluster, co-scheduled, in place of a
                       plain grid
  - ``loads_only``     timing only: the ring, its waits and the flush
  - ``no_loads``       timing only: each team adds its first tile over and
                       over (the adds without the memory's waits)
  - ``flush_off``      timing only: no global adds (the flush's cost)
  - ``adds_off``       timing only: no shared adds (loads, ids and flush)

It prints each arm's ptxas registers and spills at K = 6 and K = 4 and the
atomic and bulk-copy instructions of their SASS (``cuobjdump -sass``), then
builds and runs ``tools/smem_add_rates.cu`` (the rates of the shared-memory
add forms, and their SASS).  Inputs: phase 2's shapes (18,641,880 rows;
segment_gram at K = 6, G = 4,100; multi_segment_gram at K = 4 over store and
item, random ids) and the captured arguments of phase 4's
``cofactors_grouped`` (segment_gram by item) and of the categorical
materialized leg (multi_segment_gram by store and item), in the join's row
order.  Each arm is held to the plain version (``KERNEL_RTOL``; the timing-
only arms are not) and timed with CUDA events (median of single calls and
the mean of calls queued back to back) in two rounds, the second in reverse
order.  Results also go to ``chiprun_out/segment_gram_variants/results.json``;
the last line is the card's name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import importlib.util
import json
import re
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import (  # noqa: E402
    VERSIONS,
    cofactors_grouped,
    compute_scale_factors,
    design_matrix,
    linear_regression,
)
from repro_torch.data import favorita_like  # noqa: E402
from repro_torch.kernels import _build, ops as kops, ref  # noqa: E402

OUT = ROOT / "chiprun_out" / "segment_gram_variants"
WRAPPER = ROOT / "src/repro_torch/kernels/segment_gram.py"
RATES = ROOT / "tools/smem_add_rates.cu"
TIMING_ONLY = ("loads_only", "no_loads", "flush_off", "adds_off", "old_loads_only", "old_adds_off",
               "old_adds_off_no_match", "old_flush_off", "old_expand_off",
               "old_loads_only_rows256")

_CAS_FIRST = """  U old[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    old[u] = (pend >> u & 1) ? reinterpret_cast<volatile U*>(a)[at[u]] : U(0);
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if ((pend >> u & 1) &&
        atomicCAS(a + at[u], old[u], Bits<T>::of(Bits<T>::to(old[u]) + p[u])) ==
            old[u])
      pend &= ~(1u << u);
"""
_FALLBACK = """#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if (pend >> u & 1) atomicAdd(acc + at[u], p[u]);
"""
_GRID = """  // as many whole crews as run at once, and no more than there are tiles
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, (size_t)p.smem)) != cudaSuccess)
    return (int)err;
  int64_t n_cr = (int64_t)sms * per_sm / p.split;
  if (n_cr < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = a.m / p.rows;
  if (n_cr > tiles) n_cr = tiles > 1 ? tiles : 1;
  kern<<<(unsigned)(n_cr * p.split), kThreads, (size_t)p.smem, s>>>(a);
  return (int)cudaGetLastError();
"""
_CLUSTER = [(_GRID, """  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as run at once, and no more than there are tiles
  int n_cr = 0;
  err = cudaOccupancyMaxActiveClusters(&n_cr, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (n_cr < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = a.m / p.rows;
  if (n_cr > tiles) n_cr = tiles > 1 ? (int)tiles : 1;
  cfg.gridDim = dim3(n_cr * p.split);
  return (int)cudaLaunchKernelEx(&cfg, kern, a);
""")]

_ADDS_OFF = ("  cas_add(acc, at, p, pend);\n}\n\n// Entries [t0, t1)",
             "  if (ln.base < -(1 << 30)) cas_add(acc, at, p, pend);\n}\n\n// Entries [t0, t1)")
_NO_MATCH = ("    ln.peers = __match_any_sync(kFull, gid);\n"
             "    ln.merge = __any_sync(kFull, ln.valid && ln.peers != (1u << ln.lane));\n",
             "    ln.peers = 1u << ln.lane;\n    ln.merge = false;\n")
_LOADS_ONLY = ("      add_rows<T, KC>(a, acc, xs + r * a.k, ids + r * a.n_seg,\n"
               "                      r0 + tid < a.rows, t0, t1, i0, j0);\n", "      (void)r;\n")
_ROWS256 = {"cu": [("constexpr int kMaxRows = 128;", "constexpr int kMaxRows = 256;")],
            "py": [("_MAX_ROWS = 128", "_MAX_ROWS = 256")]}

# the hot bands' lanes of a group sum their products (match_any and a
# shuffle tree, as the earlier design did on every band) before the lowest adds
_MERGE_HOT = [(
    "  int rot, e;  // entry t lies at slot (t - t0 + rot) mod e of the group\n  bool valid;\n};\n",
    "  int rot, e;  // entry t lies at slot (t - t0 + rot) mod e of the group\n"
    "  bool valid, merge, leader;\n  unsigned peers;\n};\n"), (
    """  unsigned pend = 0;
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if ((on >> u & 1) && p[u] != T(0)) pend |= 1u << u;
  cas_add(acc, at, p, pend);""", """  T q[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) q[u] = p[u];
  if (ln.merge) {  // warp-uniform
    const int lane = threadIdx.x & 31;
    int rank = __popc(ln.peers & ((1u << lane) - 1));
    unsigned above = ln.peers & (0xfffffffeu << lane);
    while (__any_sync(kFull, above)) {
      const int next = __ffs(above);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const T o = __shfl_sync(kFull, q[u], (next - 1) & 31);
        if (next) q[u] += o;
      }
      above &= ~__ballot_sync(kFull, rank & 1);
      rank >>= 1;
    }
  }
  unsigned pend = 0;
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if (ln.leader && (on >> u & 1) && q[u] != T(0)) pend |= 1u << u;
  cas_add(acc, at, q, pend);"""), (
    "    int copy = 0;\n    ln.step = 1;\n",
    """    ln.peers = 1u << (threadIdx.x & 31);
    ln.merge = false;
    ln.leader = ln.valid;
    if (a.hot >> c & 1) {
      ln.peers = __match_any_sync(kFull, ln.valid ? s : -1);
      ln.merge = __any_sync(kFull, ln.valid && ln.peers != (1u << (threadIdx.x & 31)));
      ln.leader = ln.valid && __ffs(ln.peers) - 1 == (int)(threadIdx.x & 31);
    }
    int copy = 0;
    ln.step = 1;
""")]

#: The earlier design's source (``OLD_CU``, its wrapper ``OLD_PY``) edited, for the
#: breakdown of what it spends besides the shared adds: name -> {"cu":
#: edits of OLD_CU, "py": edits of OLD_PY}
OLD_EDITS = {
    # the ring and its mbarrier waits, the flush of zeros and expand_sym
    "old_loads_only": {"cu": [_LOADS_ONLY]},
    # the same with ids, products, match_any and reduce_peers: "adds off"
    "old_adds_off": {"cu": [_ADDS_OFF]},
    # ids and products, without match_any and reduce_peers
    "old_adds_off_no_match": {"cu": [_ADDS_OFF, _NO_MATCH]},
    "old_flush_off": {"cu": [(
        "      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)\n",
        "      if (v.x == -1234.5f)\n")]},
    "old_expand_off": {"cu": [(
        "  expand_sym<T><<<(unsigned)blocks, 256, 0, s>>>(",
        "  if (blocks < 0) expand_sym<T><<<(unsigned)blocks, 256, 0, s>>>(")]},
    # stages of up to 256 rows: twice the bytes in flight where rows are narrow
    "old_rows256": _ROWS256,
    "old_loads_only_rows256": {"cu": _ROWS256["cu"] + [_LOADS_ONLY], "py": _ROWS256["py"]},
}

#: name -> {"cu": edits of the kernel source, "py": edits of its wrapper},
#: each edit (old text, new text)
EDITS = {
    # what each choice of the shipped design buys
    "one_copy": {"cu": [("constexpr int kMaxCopies = 16;", "constexpr int kMaxCopies = 1;")],
                 "py": [("_MAX_COPIES = 16", "_MAX_COPIES = 1")]},
    "copies8": {"cu": [("constexpr int kMaxCopies = 16;", "constexpr int kMaxCopies = 8;")],
                "py": [("_MAX_COPIES = 16", "_MAX_COPIES = 8")]},
    "merge_hot": {"cu": _MERGE_HOT},
    "odd_stride": {"cu": [(
        "      a.stride[c] = step > 1 ? (p.entries | 1) : p.entries;\n",
        "      a.stride[c] = p.entries | 1;\n"), (
        "    n += hot(groups[c]) && copies > 1 ? groups[c] * (e | 1) * copies\n"
        "                                      : groups[c] * e;\n",
        "    n += hot(groups[c]) && copies > 1 ? groups[c] * (e | 1) * copies\n"
        "                                      : groups[c] * (e | 1);\n"), (
        "    const int64_t most = (avail - 3) / (e > 0 ? e : 1);\n",
        "    const int64_t most = (avail - 3) / (e | 1);\n"), (
        "    int64_t len = (total < most ? total : most) * e;\n",
        "    int64_t len = (total < most ? total : most) * (e | 1);\n")],
        "py": [(
            "    return sum(g * (e | 1) * copies if g <= _HOT_GROUPS and copies > 1 else g * e\n",
            "    return sum(g * (e | 1) * copies if g <= _HOT_GROUPS and copies > 1 else g * (e | 1)\n"), (
            "        most = (avail - 3) // max(e, 1)\n", "        most = (avail - 3) // (e | 1)\n"), (
            "        copies, n = 1, min(total, most) * e\n",
            "        copies, n = 1, min(total, most) * (e | 1)\n")]},
    "no_rotation": {"cu": [
        ("    ln.rot = ln.valid ? (s >> a.rot_shift) & a.rot_mask : 0;\n", "    ln.rot = 0;\n"),
        ("    q += (g >> a.rot_shift) & a.rot_mask;\n", "    q += 0;\n")]},
    "atomicAdd": {"cu": [(_CAS_FIRST, "")]},
    "cas_retry": {"cu": [(_FALLBACK, """  while (pend) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (pend >> u & 1) {
        const U got =
            atomicCAS(a + at[u], old[u], Bits<T>::of(Bits<T>::to(old[u]) + p[u]));
        if (got == old[u])
          pend &= ~(1u << u);
        else
          old[u] = got;
      }
    }
  }
""")]},
    "batch2": {"cu": [("constexpr int kBatch = 1;", "constexpr int kBatch = 2;")]},
    "batch4": {"cu": [("constexpr int kBatch = 1;", "constexpr int kBatch = 4;")]},
    "cluster_launch": {"cu": _CLUSTER},
    # timing only
    "loads_only": {"cu": [_LOADS_ONLY]},
    # each team adds its first tile over and over: the adds without the
    # memory's waits
    "no_loads": {"cu": [
        ("    mbar_wait(full, turn & 1);\n", "    if (turn == 0) mbar_wait(full, 0);\n"),
        ("    if (tid == 0 && tile + step < n_full) load(tile + step);\n", "")]},
    "flush_off": {"cu": [(
        "      if (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f || v[3] != 0.f)\n",
        "      if (v[0] == -1234.5f)\n")]},
    "adds_off": {"cu": [_ADDS_OFF]},
}


class LibBuild:
    """Stands in for ``kernels._build`` in a wrapper module: its functions
    come from one library file."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))

    def function(self, lib_name, symbol, argtypes):
        fn = getattr(self.lib, symbol)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return fn


def load_wrapper(path: Path, name: str, lib: Path):
    """A copy of a wrapper module bound to library ``lib``."""
    spec = importlib.util.spec_from_file_location(f"repro_torch.kernels.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = LibBuild(lib)
    return mod


def edited(name: str, kind: str, edits, base: str = None) -> str:
    """``base`` (by default the checkout's kernel source or wrapper) with
    ``edits`` made."""
    if base is None:
        base = (_build.CSRC / "segment_gram.cu" if kind == "cu" else WRAPPER).read_text()
    text = base
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in the {kind} source once")
        text = text.replace(old, new)
    return text


def sources(old_cu: Path) -> dict:
    out = {"new": (_build.CSRC / "segment_gram.cu").read_text(), "old": old_cu.read_text()}
    for name, files in EDITS.items():
        out[name] = edited(name, "cu", files["cu"])
    for name, files in OLD_EDITS.items():
        out[name] = edited(name, "cu", files["cu"], base=out["old"])
    return out


def build(item) -> tuple:
    name, text = item
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    cmd = [_build._nvcc(), *_build.FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return name, proc.returncode, proc.stdout + proc.stderr


def ptxas_lines(log: str) -> list:
    """ptxas' registers and spills of the K = 6 and K = 4 float kernels (the
    first design's cached kernel where that is the source)."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Function properties for" in line and re.search(
                r"gram_rowsIfLi[46]E|segment_gram_rowsIfLb1E", line):
            what = re.search(r"(gram_rowsIfLi[46]E|segment_gram_rowsIfLb1E)", line).group(1)
            out.append(f"{what}: {lines[i + 1].strip()}; {lines[i + 2].strip()}")
    return out


def sass_ops(binary: Path, pattern: str) -> dict:
    """{kernel: {opcode: count}} of the atomic, reduction, bulk-copy and
    shared-store instructions in the SASS of the kernels whose names match
    ``pattern``."""
    sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
                           str(binary)], capture_output=True, text=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if re.search(pattern, m.group(1)) else None
            continue
        if cur:
            for op in re.findall(r"\b((?:ATOMS|ATOM|RED|REDG|UBLKCP|MATCH|STS)\.?[A-Z0-9_.]*)", line):
                out.setdefault(cur, collections.Counter())[op] += 1
    return {k: dict(v) for k, v in out.items()}


def inputs() -> list:
    """(what, kernel, x, ids, groups): phase 2's shapes, then phase 4's
    captured calls."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    m = cs.N_SALES
    u = torch.cat([torch.ones(m, 1, device="cuda"),
                   torch.rand(m, 5, device="cuda", generator=gen)], 1)
    item = torch.randint(0, 4_100, (m,), device="cuda", generator=gen, dtype=torch.int32)
    store = torch.randint(0, 54, (m,), device="cuda", generator=gen, dtype=torch.int32)
    out = [("phase 2, K 6, item, random ids", "segment_gram", u, item, 4_100),
           ("phase 2, K 4, store + item, random ids", "multi_segment_gram",
            u[:, :4].contiguous(), torch.stack([store, item], 1).contiguous(), [54, 4_100])]
    bundle = cs.favorita(types.SimpleNamespace(favorita_like=favorita_like))
    store_, feats, label = bundle.store, bundle.features, bundle.label
    cfg = dataclasses.replace(VERSIONS["closed"], backend="torch", device="cuda",
                              categorical=cs.CAT, factorized=False, use_kernel=True)
    with cs.Capture(kops, ("multi_segment_gram",)) as cap_m:
        linear_regression(store_, bundle.vorder, feats, label, cfg)
    joined = store_.materialize_join()
    factors = compute_scale_factors(store_, feats, label, use_kernel=True, device="cuda")
    cols = feats + [label]
    x = design_matrix(joined, cols, scale=factors)
    with cs.Capture(kops, ("segment_gram",)) as cap_s:
        cofactors_grouped(x, joined.column("item_nbr"), store_.attr_domain("item_nbr"),
                          cols, device="cuda")
    torch.cuda.synchronize()
    for what, cap in (("phase 4, cofactors_grouped by item", cap_s),
                      ("phase 4, categorical materialized leg", cap_m)):
        for name, args, _ in cap.calls:
            ids = torch.as_tensor(args[1], device="cuda")
            ids = (ids if ids.dtype == torch.int32 else ids.to(torch.int32)).contiguous()
            out.append((what, name, args[0], ids, args[2]))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("segment_gram_variants.py: no CUDA device available")
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    old_cu, old_py = Path(sys.argv[1]), Path(sys.argv[2])
    OUT.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    cs.log(f"card: {card}")
    libs, report = {}, dict(card=card, ptxas={}, sass={})
    with ThreadPoolExecutor(len(EDITS) + len(OLD_EDITS) + 3) as pool:
        rates = pool.submit(subprocess.run, [_build._nvcc(), *_build.FLAGS[:5], "-o",
                                             str(OUT / "rates"), str(RATES)],
                            capture_output=True, text=True)
        for name, rc, log in pool.map(build, sources(old_cu).items()):
            (OUT / f"{name}.log").write_text(log)
            if rc:
                raise SystemExit(f"{name} did not build:\n{log}")
            libs[name] = OUT / f"{name}.so"
            report["ptxas"][name] = ptxas_lines(log)
            report["sass"][name] = sass_ops(libs[name], r"gram_rowsIfLi[46]E|segment_gram_rowsIfLb1E")
            cs.log(f"{name}: {report['ptxas'][name]}")
            cs.log(f"{name} SASS: {report['sass'][name]}")
        if rates.result().returncode:
            raise SystemExit(f"smem_add_rates.cu did not build:\n{rates.result().stderr}")
    got = subprocess.run([str(OUT / "rates")], capture_output=True, text=True, timeout=300)
    report["rates"] = got.stdout.splitlines()
    report["rates_sass"] = sass_ops(OUT / "rates", r"adds")
    for line in report["rates"]:
        cs.log(f"shared-memory adds: {line}")
    cs.log(f"shared-memory adds, SASS: {report['rates_sass']}")

    arms = {"new": load_wrapper(WRAPPER, "_sg_new", libs["new"]),
            "old": load_wrapper(old_py, "_sg_old", libs["old"])}
    for edits, wrapper in ((EDITS, WRAPPER), (OLD_EDITS, old_py)):
        for name, files in edits.items():
            path = wrapper
            if "py" in files:
                path = OUT / f"{name}.py"
                path.write_text(edited(name, "py", files["py"], base=wrapper.read_text()))
            arms[name] = load_wrapper(path, f"_sg_{name}", libs[name])

    report["inputs"] = []
    for what, kernel, x, ids, groups in inputs():
        if kernel == "segment_gram":
            calls = {n: functools.partial(mod.segment_gram, x, ids, groups)
                     for n, mod in arms.items()}
            want = [ref.segment_gram_ref(x, ids, groups)]
        else:
            calls = {n: functools.partial(mod.multi_segment_gram, x, ids, groups)
                     for n, mod in arms.items()}
            want = ref.multi_segment_gram_ref(x, ids, groups)
        n_seg = 1 if kernel == "segment_gram" else len(groups)
        total = groups if kernel == "segment_gram" else sum(groups)
        row = dict(what=what, kernel=kernel, rows=x.shape[0], k=x.shape[1], groups=groups,
                   bound_ms=cs.gram_bound(x, n_seg, total)[0], arms={})
        for arm, fn in calls.items():
            out = fn()
            err, scale = cs.max_err(out if isinstance(out, list) else [out], want)
            if arm not in TIMING_ONLY and not err <= cs.KERNEL_RTOL * max(1.0, scale):
                raise AssertionError(f"{what} {arm}: error {err}")
            row["arms"][arm] = dict(max_abs_err=err, ms=[], ms_back_to_back=[])
            del out
        del want
        for order in (list(calls), list(calls)[::-1]):
            for arm in order:
                r = row["arms"][arm]
                r["ms"].append(cs.time_ms(calls[arm], reps=20))
                r["ms_back_to_back"].append(cs.time_ms_back_to_back(calls[arm], launches=20))
        for arm, r in row["arms"].items():
            cs.log(f"{what:42s} {arm:22s} ms {r['ms'][0]:.4f} / {r['ms'][1]:.4f}  back to "
                   f"back {r['ms_back_to_back'][0]:.4f} / {r['ms_back_to_back'][1]:.4f}  "
                   f"bound {row['bound_ms']:.4f}  max_abs_err {r['max_abs_err']:.3e}"
                   + ("  (timing only)" if arm in TIMING_ONLY else ""))
        report["inputs"].append(row)
    (OUT / "results.json").write_text(json.dumps(report, indent=1))
    print(card)


if __name__ == "__main__":
    main()
