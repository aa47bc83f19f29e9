#!/usr/bin/env python3
"""Ablation of the grouped Gram kernels (``csrc/segment_gram.cu``) on one
GPU, at phase 2's shapes and on phase 4's own arguments.

    python3 tools/segment_gram_variants.py OLD_CU OLD_PY     # from the repo root

``OLD_CU`` / ``OLD_PY`` are an earlier ``csrc/segment_gram.cu`` and its
``kernels/segment_gram.py`` wrapper of the first design's interface (from
``git show REV:PATH``, kept under a gitignored directory): one block of 512
threads per SM adding each row with ``atomicAdd`` into a ``[G, K(K+1)/2]``
shared accumulator of at most 192 KiB, which the ``ops`` layer of that
design (:func:`old_segment_gram`) fits by chunking the groups, ids rebased
per chunk.

The script builds, at once and with the port's ``nvcc`` flags, into
``chiprun_out/segment_gram_variants/``:

* ``new``            the checkout's ``csrc/segment_gram.cu`` (the port's build)
* ``old``            ``OLD_CU``, driven through ``OLD_PY`` and the old chunking
* the checkout's source edited by :data:`EDITS` (old text, new text), driven
  through the checkout's wrapper (``second_pass`` also edits the wrapper):

  - ``atomicAdd``      every add through atomicAdd (no compare-and-swaps)
  - ``cas_retry``      a lost compare-and-swap swaps again, not atomicAdd
  - ``no_match_any``   no combining of a warp's rows that share a group
  - ``cluster_launch`` each crew (the CTAs that read the same tiles) a
                       thread-block cluster, co-scheduled, in place of a
                       plain grid
  - ``split_groups``   the crew's CTAs split the groups, each holding
                       every entry of its range, not the triangle entries
  - ``multicast``      on a cluster launch, each CTA of the cluster loads a
                       slice of every tile and multicasts it to all, in
                       place of each CTA loading every tile itself
                       (cluster-wide empty barriers)
  - ``second_pass``    each CTA stores its sums, and a second kernel adds
                       the crews' slabs, in place of global atomics
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
TIMING_ONLY = ("flush_off", "adds_off")

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
_FLUSH = """  T* dst = a.compact + rank * a.slab;
  if constexpr (sizeof(T) == 4) {
    for (int64_t e = 4 * threadIdx.x; e < a.slab; e += 4 * kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(acc + e);
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
        atomicAdd(reinterpret_cast<float4*>(dst + e), v);
    }
  } else {
    for (int64_t e = threadIdx.x; e < a.slab; e += kThreads)
      if (acc[e] != T(0)) atomicAdd(dst + e, acc[e]);
  }"""
_LOAD = """  auto load = [&](int64_t tile) {
    mbar_expect_tx(full, stage_bytes);
    bulk_load(smem_u32(stage), a.x + tile * a.rows * a.k, x_bytes, full);
    bulk_load(smem_u32(stage + x_bytes), a.segs + tile * a.rows * a.n_seg,
              stage_bytes - x_bytes, full);
  };
  int64_t tile = cr + n_cr * team;
  if (tid == 0 && tile < n_full) load(tile);
  for (uint32_t turn = 0; tile < n_full; ++turn, tile += step) {"""
_REFILL = """    team_sync(1 + team, team_size);  // the team is done with the stage
    if (tid == 0 && tile + step < n_full) load(tile + step);
  }"""
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

#: name -> {"cu": edits of the kernel source, "py": edits of its wrapper},
#: each edit (old text, new text)
EDITS = {
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
    "no_match_any": {"cu": [(
        "    ln.peers = __match_any_sync(kFull, gid);\n"
        "    ln.merge = __any_sync(kFull, ln.valid && ln.peers != (1u << ln.lane));\n",
        "    ln.peers = 1u << ln.lane;\n    ln.merge = false;\n")]},
    "cluster_launch": {"cu": _CLUSTER},
    "split_groups": {"cu": [
        ("    const int64_t e = (nt + c - 1) / c;\n", "    const int64_t e = nt;\n"),
        ("    const int64_t most = (avail - 3) / (e > 0 ? e : 1);\n",
         "    const int64_t most = (avail - 3) / (e > 0 ? e : 1) * c;\n"),
        ("             kBarBytes + ring + (g * e + 3) / 4 * 4 * elem};",
         "             kBarBytes + ring + ((g + c - 1) / c * e + 3) / 4 * 4 * elem};"),
        ("  const int t0 = rank * a.entries;\n", "  const int t0 = 0;\n"),
        ("    if (!__any_sync(kFull, ln.valid)) continue;  // warp-uniform\n"
         "    const int gid = ln.valid ? (int)(__ldg(a.bands + a.n_seg + c) + s) : -1;\n",
         "    const int64_t total = __ldg(a.bands + 2 * a.n_seg - 1) + __ldg(a.bands + a.n_seg - 1);\n"
         "    const int64_t gpc = (total + a.split - 1) / a.split;\n"
         "    const int64_t g0 = (blockIdx.x % a.split) * gpc;\n"
         "    int gid = ln.valid ? (int)(__ldg(a.bands + a.n_seg + c) + s) : -1;\n"
         "    if (gid < g0 || gid >= g0 + gpc) { ln.valid = false; gid = -1; }\n"
         "    if (!__any_sync(kFull, ln.valid)) continue;  // warp-uniform\n"),
        ("    ln.base = gid * a.entries;\n", "    ln.base = (gid - (int)g0) * a.entries;\n"),
        ("    out[idx] = compact[(t / e) * slab + g * e + t % e];\n",
         "    const int64_t gpc = slab / e;\n"
         "    out[idx] = compact[(g / gpc) * slab + (g % gpc) * e + t];\n"),
        ("  const int64_t slab = (total * p.entries + 3) / 4 * 4;\n",
         "  const int64_t slab = ((total + p.split - 1) / p.split * p.entries + 3) / 4 * 4;\n"),
    ]},
    "multicast": {"cu": _CLUSTER + [
        ("      rows = kRingBytes / stages / row_bytes / 4 * 4;\n"
         "      if (rows > kMaxRows) rows = kMaxRows;\n"
         "      if (rows >= 4) break;\n",
         "      rows = kRingBytes / stages / row_bytes / (4 * c) * (4 * c);\n"
         "      if (rows > kMaxRows) rows = kMaxRows / (4 * c) * (4 * c);\n"
         "      if (rows >= 4 * c) break;\n"),
        ("    if (rows < 4) continue;  // a row wider than the ring\n",
         "    if (rows < 4 * c) continue;\n"),
        ("__device__ __forceinline__ void team_sync(int id, int threads) {\n",
         """__device__ __forceinline__ void bulk_load_mc(uint32_t dst, const void* src,
                                             int bytes, uint32_t bar,
                                             uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void arrive_remote(uint32_t bar, int cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\\n"
               : "=r"(remote) : "r"(bar), "r"(cta));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\\n"
               ::"r"(remote) : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 22)) __trap();
    asm volatile(
        "{\\n.reg .pred p;\\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\\n"
        "selp.u32 %0, 1, 0, p;\\n}\\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\\n"
               "barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");
}

__device__ __forceinline__ void team_sync(int id, int threads) {
"""),
        ("    for (int s = 0; s < a.stages; ++s) mbar_init(smem_u32(bars + s), 1);\n",
         "    for (int s = 0; s < a.stages; ++s) {\n"
         "      mbar_init(smem_u32(bars + s), 1);\n"
         "      mbar_init(smem_u32(bars + a.stages + s), a.split);\n"
         "    }\n"),
        ("    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: \"memory\");\n"
         "  }\n  __syncthreads();\n",
         "    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: \"memory\");\n"
         "  }\n  __syncthreads();\n  cluster_sync();\n"),
        (_LOAD, """  const uint32_t empty = smem_u32(bars + a.stages + team);
  const uint16_t mask = (uint16_t)((1u << a.split) - 1);
  const int slice = a.rows / a.split, r_first = rank * slice;
  auto load = [&](int64_t tile, uint32_t turn) {
    if (turn > 0) mbar_wait_cluster(empty, (turn - 1) & 1);
    mbar_expect_tx(full, stage_bytes);
    const int64_t row = tile * a.rows + r_first;
    bulk_load_mc(smem_u32(stage) + r_first * a.k * (int)sizeof(T),
                 a.x + row * a.k, slice * a.k * (int)sizeof(T), full, mask);
    bulk_load_mc(smem_u32(stage + x_bytes) + r_first * a.n_seg * 4,
                 a.segs + row * a.n_seg, slice * a.n_seg * 4, full, mask);
  };
  int64_t tile = cr + n_cr * team;
  if (tid == 0 && tile < n_full) load(tile, 0);
  for (uint32_t turn = 0; tile < n_full; ++turn, tile += step) {"""),
        (_REFILL, """    team_sync(1 + team, team_size);  // the team is done with the stage
    if (tid == 0) {
      for (int r = 0; r < a.split; ++r) arrive_remote(empty, r);
      if (tile + step < n_full) load(tile + step, turn + 1);
    }
  }"""),
        ("  __syncthreads();\n\n  T* dst = a.compact + rank * a.slab;\n",
         "  __syncthreads();\n  cluster_sync();\n\n  T* dst = a.compact + rank * a.slab;\n"),
    ]},
    "second_pass": {
        "cu": [
            (_FLUSH, """  T* dst = a.compact + (cr * a.split + rank) * a.slab;
  if constexpr (sizeof(T) == 4) {
    for (int64_t e = 4 * threadIdx.x; e < a.slab; e += 4 * kThreads)
      *reinterpret_cast<float4*>(dst + e) = *reinterpret_cast<const float4*>(acc + e);
  } else {
    for (int64_t e = threadIdx.x; e < a.slab; e += kThreads) dst[e] = acc[e];
  }"""),
            ("// out[g, i, j] = the sum of entry t", """// the crews' slabs summed into the first: compact[i] += Σ compact[p n + i]
template <typename T>
__global__ void sum_slabs(T* compact, int64_t n, int parts) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    T s = compact[i];
    for (int p = 1; p < parts; ++p) s += compact[p * n + i];
    compact[i] = s;
  }
}

int last_crews = 1;

// out[g, i, j] = the sum of entry t"""),
            ("  kern<<<(unsigned)(n_cr * p.split), kThreads, (size_t)p.smem, s>>>(a);\n",
             "  last_crews = (int)n_cr;\n"
             "  kern<<<(unsigned)(n_cr * p.split), kThreads, (size_t)p.smem, s>>>(a);\n"),
            ("  const int64_t n = total * k * k;\n  int64_t blocks",
             "  if (m > 0) sum_slabs<T><<<132 * 8, 256, 0, s>>>(compact, p.split * slab,\n"
             "                                               last_crews);\n"
             "  const int64_t n = total * k * k;\n  int64_t blocks"),
        ],
        "py": [("    compact = torch.zeros(p[\"split\"] * slab, dtype=x.dtype, device=x.device)",
                "    compact = torch.zeros(132 * p[\"split\"] * slab, dtype=x.dtype, device=x.device)")],
    },
    "flush_off": {"cu": [(
        "      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)\n",
        "      if (v.x == -1234.5f)\n")]},
    "adds_off": {"cu": [(
        "  cas_add(acc, at, p, pend);\n}\n\n// Entries [t0, t1)",
        "  if (ln.base < -(1 << 30)) cas_add(acc, at, p, pend);\n}\n\n// Entries [t0, t1)")]},
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


def edited(name: str, kind: str, edits) -> str:
    """The checkout's kernel source or wrapper with ``edits`` made."""
    text = (_build.CSRC / "segment_gram.cu" if kind == "cu" else WRAPPER).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in the {kind} source once")
        text = text.replace(old, new)
    return text


def sources(old_cu: Path) -> dict:
    out = {"new": (_build.CSRC / "segment_gram.cu").read_text(), "old": old_cu.read_text()}
    for name, files in EDITS.items():
        out[name] = edited(name, "cu", files["cu"])
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
    """{kernel: {opcode: count}} of the atomic, reduction and bulk-copy
    instructions in the SASS of the kernels whose names match ``pattern``."""
    sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
                           str(binary)], capture_output=True, text=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if re.search(pattern, m.group(1)) else None
            continue
        if cur:
            for op in re.findall(r"\b((?:ATOMS|ATOM|RED|REDG|UBLKCP|MATCH)\.?[A-Z0-9_.]*)", line):
                out.setdefault(cur, collections.Counter())[op] += 1
    return {k: dict(v) for k, v in out.items()}


def old_segment_gram(mod, x, seg, g):
    """The first design's ops layer: groups chunked so that each
    ``[G_chunk, K(K+1)/2]`` accumulator fits its 192 KiB, ids rebased."""
    k = x.shape[1]
    g_chunk = min(g, mod.SMEM_ACC_BYTES // (k * (k + 1) // 2 * x.element_size()))
    if g_chunk >= g:
        return mod.segment_gram(x, seg, g)
    outs = []
    for g0 in range(0, g, g_chunk):
        gn = min(g_chunk, g - g0)
        inside = (seg >= g0) & (seg < g0 + gn)
        outs.append(mod.segment_gram(x, torch.where(inside, seg - g0, -1).to(torch.int32), gn))
    return torch.cat(outs, dim=0)


def old_multi_segment_gram(mod, x, segs, groups):
    k = x.shape[1]
    if sum(groups) * k * (k + 1) // 2 * x.element_size() > mod.SMEM_ACC_BYTES:
        return [old_segment_gram(mod, x, segs[:, i].contiguous(), g)
                for i, g in enumerate(groups)]
    return mod.multi_segment_gram(x, segs, groups)


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
    with ThreadPoolExecutor(len(EDITS) + 3) as pool:
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

    old = load_wrapper(old_py, "_sg_old", libs["old"])
    arms = {"new": load_wrapper(WRAPPER, "_sg_new", libs["new"])}
    for name, files in EDITS.items():
        path = WRAPPER
        if "py" in files:
            path = OUT / f"{name}.py"
            path.write_text(edited(name, "py", files["py"]))
        arms[name] = load_wrapper(path, f"_sg_{name}", libs[name])

    report["inputs"] = []
    for what, kernel, x, ids, groups in inputs():
        if kernel == "segment_gram":
            calls = {n: functools.partial(mod.segment_gram, x, ids, groups)
                     for n, mod in arms.items()}
            calls["old (first design, chunked)"] = functools.partial(old_segment_gram, old, x, ids,
                                                              groups)
            want = [ref.segment_gram_ref(x, ids, groups)]
        else:
            calls = {n: functools.partial(mod.multi_segment_gram, x, ids, groups)
                     for n, mod in arms.items()}
            calls["old (first design, chunked)"] = functools.partial(old_multi_segment_gram, old, x,
                                                              ids, groups)
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
