#!/usr/bin/env python3
"""Ablation of the segment_view (degrees 2 and 1) and segment_blocks kernels
on one GPU, on the main path's own inputs.

    python3 tools/segment_view_variants.py OLD_CU OLD_PY     # from the repo root

``OLD_CU`` / ``OLD_PY`` are an earlier ``csrc/segment_view.cu`` and its
``kernels/segment_view.py`` wrapper with the same interface as the first
design's (from ``git show REV:PATH``, kept under a gitignored directory):
one per-row atomic kernel into a zeroed compact ``[G, W]`` output,
expanded in PyTorch (the port's first design; for degree 1, the kernel the
degree-1 paths A and C replaced).

The script builds, at once and with the port's ``nvcc`` flags, into
``chiprun_out/segment_view_variants/``:

* ``new``            the checkout's ``csrc/segment_view.cu`` (the port's build)
* ``old``            ``OLD_CU``, driven through ``OLD_PY``
* ``no_match_any``   path C without the warp's combining of rows that share
                     a segment
* ``scalar_red``     path C adding float32 sums one at a time, not four
* ``scatter``        path A with one thread per row storing by its id, in
                     place of one thread per group gathering its row
* ``sorted``         ``tools/segment_view_sorted.cu``: a segmented reduce in
                     group order, one warp per group, no atomics

Each of ``no_match_any``, ``scalar_red`` and ``scatter`` is the checkout's
source with the edits of :data:`EDITS` (old text, new text), driven through
the checkout's wrapper; ``raw_stream`` is the checkout's wrapper edited to
take the current stream's handle from ``torch._C._cuda_getCurrentRawStream``
in place of ``torch.cuda.current_stream``.  Path A's nodes also run
without ``order``, that is through path C.

It then captures the arguments of every ``segment_view`` and
``segment_blocks`` call of one closed-form ``linear_regression`` traversal of
``chip_smoke.py``'s 18.6 M-row Favorita bundle, of its degree-1 batch (phase
3) and the degree-1 ``segment_view`` calls of the categorical factorized leg
(phase 4, the ``g:`` queries) and, node by node, holds each
arm that applies to the node's path to the plain version (``KERNEL_RTOL``)
and times it with CUDA events (median of single calls and the mean of calls
queued back to back), in two rounds, the second in reverse order.  Last, the
host/device split of one ``segment_blocks`` call at transactions through the
new wrapper, the ``raw_stream`` one, the old one and ``index_add_``, in
turns.  Results also go to ``chiprun_out/segment_view_variants/results.json``;
the last line is the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import importlib.util
import json
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
    AggregateQuery,
    FactorizedEngine,
    linear_regression,
)
from repro_torch.data import favorita_like  # noqa: E402
from repro_torch.kernels import _build, ops as kops, ref  # noqa: E402
from repro_torch.kernels import segment_view as sv  # noqa: E402

OUT = ROOT / "chiprun_out" / "segment_view_variants"
WRAPPER = ROOT / "src/repro_torch/kernels/segment_view.py"
#: name -> (file edited: "cu" the kernel source, "py" its wrapper, and the
#: edits, each (old text, new text))
EDITS = {
    "no_match_any": ("cu", [(
        "    const unsigned peers = __match_any_sync(kFull, valid ? s : -1);\n"
        "    const bool merge = __any_sync(kFull, valid && peers != (1u << lane));\n",
        "    const unsigned peers = 1u << lane;\n    const bool merge = false;\n")]),
    "scalar_red": ("cu", [(
        "void add4(float* p, const float (&v)[4], int) {\n"
        "  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));",
        "void add4(float* p, const float (&v)[4], int n) {\n"
        "  for (int t = 0; t < 4 && t < n; ++t) atomicAdd(p + t, v[t]);")]),
    "scatter": ("cu", [(
        "    const int64_t row = order[i], s = i;\n",
        "    const int64_t row = i, s = in.seg[i];\n    if (s < 0 || s >= g) continue;\n")]),
    "raw_stream": ("py", [(
        "torch.cuda.current_stream(like.get_device()).cuda_stream",
        "torch._C._cuda_getCurrentRawStream(like.get_device())")]),
}
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


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
    text = (_build.CSRC / "segment_view.cu" if kind == "cu" else WRAPPER).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in the {kind} source once")
        text = text.replace(old, new)
    return text


def sources(old_cu: Path) -> dict:
    out = {"old": old_cu.read_text(),
           "sorted": (ROOT / "tools" / "segment_view_sorted.cu").read_text()}
    for name, (kind, edits) in EDITS.items():
        if kind == "cu":
            out[name] = edited(name, kind, edits)
    return out


def build(item) -> tuple:
    name, text = item
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    cmd = [_build._nvcc(), *_build.FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return name, proc.returncode, proc.stdout + proc.stderr


def group_starts(seg, g):
    """[G + 1]: the first sorted row of each group, and the row count."""
    starts = torch.zeros(g + 1, dtype=torch.int64, device=seg.device)
    starts[1:] = torch.cumsum(torch.bincount(seg.long(), minlength=g), 0)
    return starts


def sorted_arm(fn, c, x, l, q, seg, g, setup: bool):
    """The sorted segmented reduce as a call without arguments.  The sort by
    segment id is made here, once, and not timed (the engine's device
    grouping sorts the keys already); the group starts, which the engine
    does not build, are built once, or in every call when ``setup``."""
    order = torch.sort(seg, stable=True).indices.to(torch.int32)
    starts = group_starts(seg, g)
    k = l.shape[1]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        st = group_starts(seg, g) if setup else starts
        out = [c.new_empty(shape) for shape in ((g,), (g, k + 1), (g, k + 1, k + 1))]
        err = fn(c.data_ptr(), x.data_ptr(), l.data_ptr(), q.data_ptr(), order.data_ptr(),
                 st.data_ptr(), g, k, *[t.data_ptr() for t in out], stream)
        if err:
            raise RuntimeError(f"sorted reduce: cudaError_t {err}")
        return out
    return run


def arms(nd, wrappers, sorted_fn, name, args, kwargs) -> dict:
    """Every variant that applies to this node's path, as calls without
    arguments."""
    new_kern, _ = cs.call_pair(sv, ref, name, args, kwargs)
    out = {f"new ({nd['path']})": new_kern}
    out["old (per-row atomics)"] = cs.call_pair(wrappers["old"], ref, name, args, kwargs)[0]
    if nd["path"] == "one_row":
        out["A off: path C (no order)"] = cs.call_pair(
            sv, ref, name, args, dict(kwargs, order=None))[0]
        out["A scattering by id"] = cs.call_pair(wrappers["scatter"], ref, name,
                                                 args, kwargs)[0]
    if nd["path"] == "atomic":
        out["C without match_any"] = cs.call_pair(wrappers["no_match_any"], ref, name,
                                                  args, kwargs)[0]
        out["C with scalar atomics"] = cs.call_pair(wrappers["scalar_red"], ref, name,
                                                    args, kwargs)[0]
        if nd["payload"] == "view":
            c, x, l, q, seg = new_kern.args[:5]
            for setup in (False, True):
                out["sorted reduce" + (", starts per call" if setup else "")] = sorted_arm(
                    sorted_fn, c, x, l, q, seg, nd["groups"], setup)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("segment_view_variants.py: no CUDA device available")
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    old_cu, old_py = Path(sys.argv[1]), Path(sys.argv[2])
    OUT.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    cs.log(f"card: {card}")
    _build.build(["segment_view"])
    libs = {}
    with ThreadPoolExecutor(len(EDITS) + 2) as pool:
        for name, rc, log in pool.map(build, sources(old_cu).items()):
            (OUT / f"{name}.log").write_text(log)
            regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
            cs.log(f"{name}: nvcc exit {rc}; {regs}")
            if rc:
                raise SystemExit(f"{name} did not build:\n{log}")
            libs[name] = OUT / f"{name}.so"
    old = load_wrapper(old_py, "_sv_old", libs["old"])
    wrappers = {"old": types.SimpleNamespace(  # the old wrappers take no order
        segment_view=lambda *a, order=None, **kw: old.segment_view(*a, **kw),
        segment_blocks=lambda *a, order=None, **kw: old.segment_blocks(*a, **kw),
    )}
    for name, (kind, edits) in EDITS.items():
        if kind == "cu":
            wrappers[name] = load_wrapper(WRAPPER, f"_sv_{name}", libs[name])
        else:
            path = OUT / f"{name}.py"
            path.write_text(edited(name, kind, edits))
            wrappers[name] = load_wrapper(path, f"_sv_{name}", _build.library_path("segment_view"))
    sorted_fn = LibBuild(libs["sorted"]).function(
        "sorted", "segment_view2_sorted_f32", [_P] * 6 + [_I64, _I32] + [_P] * 4)

    bundle = cs.favorita(types.SimpleNamespace(favorita_like=favorita_like))
    cfg = dataclasses.replace(VERSIONS["closed"], backend="torch", device="cuda",
                              use_kernel=True)
    with cs.Capture(kops) as cap:
        r = linear_regression(bundle.store, bundle.vorder, bundle.features, bundle.label, cfg)
        torch.cuda.synchronize()
    # the degree-1 calls: the degree-1 batch (phase 3) and the categorical
    # factorized leg's g: queries (phase 4)
    eng = FactorizedEngine(bundle.store, bundle.vorder, bundle.features + [bundle.label],
                           scale=r.factors, device="cuda")
    with cs.Capture(kops) as cap1:
        eng.run_batch([AggregateQuery("deg1", (), 1)])
    cat = dataclasses.replace(cfg, categorical=cs.CAT, factorized=True, use_kernel=False)
    with cs.Capture(kops) as cap4:
        linear_regression(bundle.store, bundle.vorder, bundle.features, bundle.label, cat)
        torch.cuda.synchronize()
    del bundle, eng
    calls = cap.calls + [c for c in cap1.calls + cap4.calls
                         if cs.call_node(sv, *c)["kernel"] == "segment_view1"]
    cs.log(f"captured {len(calls)} calls")
    results = []
    for name, args, kwargs in calls:
        nd = cs.call_node(sv, name, args, kwargs)
        _, plain = cs.call_pair(sv, ref, name, args, kwargs)
        want = plain()
        variants = arms(nd, wrappers, sorted_fn, name, args, kwargs)
        row = dict(node=nd["node"], kernel=nd["kernel"], path=nd["path"], rows=nd["rows"],
                   k=nd["k"], groups=nd["groups"], bound_ms=cs.node_bound(sv, nd)[0], arms={})
        for arm, fn in variants.items():
            err, scale = cs.max_err(fn(), want)
            if not err <= cs.KERNEL_RTOL * max(1.0, scale):
                raise AssertionError(f"{nd['node']} {arm}: error {err}")
            row["arms"][arm] = dict(max_abs_err=err, ms=[], ms_back_to_back=[])
        del want
        for order in (list(variants), list(variants)[::-1]):
            for arm in order:
                r = row["arms"][arm]
                r["ms"].append(cs.time_ms(variants[arm], reps=20))
                r["ms_back_to_back"].append(cs.time_ms_back_to_back(variants[arm], launches=50))
        for arm, r in row["arms"].items():
            cs.log(f"{nd['kernel']:14s} {nd['node']:12s} {arm:26s} ms "
                   f"{r['ms'][0]:.4f} / {r['ms'][1]:.4f}  back to back "
                   f"{r['ms_back_to_back'][0]:.4f} / {r['ms_back_to_back'][1]:.4f}  "
                   f"bound {row['bound_ms']:.4f}  max_abs_err {r['max_abs_err']:.3e}")
        results.append(row)
    name, args, kwargs = cs.regroup_args(sv, calls)
    seg = torch.as_tensor(args[-2], device="cuda").long()
    split = cs.host_device_split({
        "new": cs.call_pair(sv, ref, name, args, kwargs)[0],
        "new, raw stream handle": cs.call_pair(wrappers["raw_stream"], ref, name, args,
                                               kwargs)[0],
        "old (per-row atomics)": cs.call_pair(wrappers["old"], ref, name, args, kwargs)[0],
        "index_add_": functools.partial(cs.library_segment_sum,
                                        args[0][:, None].contiguous(), seg, int(args[-1])),
    })
    for arm, row in split.items():
        cs.log(f"split at {cs.TIMED_REGROUP_NODE}, {arm}: " + " ".join(
            f"{key}={v:.2f}" for key, v in row.items()))
    (OUT / "results.json").write_text(json.dumps(
        dict(card=card, nodes=results, split_us=split), indent=1))
    print(card)


if __name__ == "__main__":
    main()
