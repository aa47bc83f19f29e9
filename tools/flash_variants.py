#!/usr/bin/env python3
"""Compare design variants of the flash forward on one GPU.

    python3 tools/flash_variants.py [--dtype bfloat16|float32] [SPEC ...]   # from the repo root

Each SPEC names one build of ``src/repro_torch/csrc/flash.cu``:

    name                     the checkout's source as it is
    name:path                another source with the same C interface,
                             the ``lse`` pointer after ``out`` included (an
                             older commit's: ``git show REV:src/repro_torch/
                             csrc/flash.cu > path``, with that commit's
                             ``hopper.cuh`` beside it, which the build then
                             finds first; sources written before the
                             forward took ``lse`` lack it, and in float32
                             those written before it took a workspace)
    name=OLD=>NEW[@@OLD=>NEW...]   the checkout's source with each OLD text
                             replaced by NEW (a tile size, a stage count,
                             a switch)
    NAME                     in float32, an arm of ``ARMS`` below (the
                             measured design choices); no SPEC at all runs
                             them all

All variants are built at once with the port's ``nvcc`` flags (and
``csrc`` on the include path, for ``hopper.cuh``) into
``chiprun_out/flash_variants/``, their ptxas register and spill counts
printed, then each is held to the plain version at the phase-2 shapes of
``chip_smoke.py`` in the dtype (relative error of the whole output, which
must stay under 1e-2 in bf16 and under FLASH_NORM_RTOL, 1e-5, in float32;
arms in ``TIMING_ONLY`` drop work on purpose and are timed regardless) and
timed with CUDA events: the median of 20 single calls and the mean of 50
calls queued back to back, beside ``scaled_dot_product_attention`` on the
same inputs and the bound ``chip_smoke.py`` gives the kernel
(:func:`chip_smoke.flash_bound`: in float32 up to head dim 128 that of
3xTF32 on the tensor cores, the scalar one beside it).  Two
rounds, the second in reverse order, so that drift on the card shows.
The last line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash as kflash  # noqa: E402

OUT = ROOT / "chiprun_out" / "flash_variants"
# (what, B, Sq, Sk, H, KH, D, causal, window): chip_smoke.py's timed shapes
SHAPES = {
    torch.bfloat16: [
        ("smollm", 1, 4096, 4096, 9, 3, 64, True, None),
        ("olmo", 1, 4096, 4096, 16, 16, 128, True, None),
        ("mixtral w1024", 1, 4096, 4096, 32, 8, 128, True, 1024),
        ("non-causal 1000x3001", 2, 1000, 3001, 8, 2, 64, False, None),
        ("d256", 1, 4096, 4096, 4, 4, 256, True, None),
    ],
    torch.float32: [
        ("smollm", 1, 4096, 4096, 9, 3, 64, True, None),
        ("olmo", 1, 4096, 4096, 16, 16, 128, True, None),
        ("non-causal 1000x3001", 2, 1000, 3001, 8, 2, 64, False, None),
        ("whisper cross", 1, 4096, 1500, 16, 16, 64, False, None),
    ],
}
TOLERANCE = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
_P, _I = ctypes.c_void_p, ctypes.c_int

_BK = "static constexpr int kBK = DP >= 128 ? 32 : 64;"
_LIVE = "const bool live = tile >= wfirst && tile < wlast;"
#: the measured design choices of the float32 (3xTF32) kernel, as edits of
#: the checkout's flash.cu
ARMS = {
    "final": "",
    # key tiles: 32 keys at head dim 64, 16 at 128
    "bk_32_at_64": f"{_BK}=>static constexpr int kBK = 32;",
    "bk_16_at_128": f"{_BK}=>static constexpr int kBK = DP >= 128 ? 16 : 64;",
    # P·V on a whole key tile's fragments at once (64 keys at DP <= 64)
    "pv_whole": "constexpr int kPC = kPV;=>constexpr int kPC = kBK;",
    # the bf16 kernel's producer warpgroup (384 threads, registers moved
    # to the consumers by setmaxnreg)
    "producer_warpgroup": "@@".join((
        "constexpr int kThreadsTf32 = kConsumers + 32;=>constexpr int kThreadsTf32 = kThreads16;",
        "    // ---- producer warp: one thread issues every load ----\n"
        "=>    // ---- producer warp: one thread issues every load ----\n"
        '    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(kProducerRegs));\n',
        "  // ---- consumer warpgroups: 64 query rows each ----\n  const int wg"
        "=>  // ---- consumer warpgroups: 64 query rows each ----\n"
        '  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));\n'
        "  const int wg")),
    # every warpgroup computes every key tile its block walks
    "no_warpgroup_skip": f"{_LIVE}=>const bool live = wg < q_wgs;",
    # timing only (wrong by design): the pre-pass alone, no main kernel;
    # the most that splitting Q and K inside the kernel could save
    "prepass_only": ("flash_tf32_kernel<DP><<<grid, kThreadsTf32, G::kSmem, stream>>>(maps, a);"
                     "=>if (a.sq < 0) flash_tf32_kernel<DP><<<grid, kThreadsTf32, G::kSmem, "
                     "stream>>>(maps, a);"),
}
#: arms timed although they fail the check (they drop work on purpose)
TIMING_ONLY = {"prepass_only"}


def variant_sources(specs, arms=ARMS) -> dict:
    base = (_build.CSRC / "flash.cu").read_text()
    out = {}
    for spec in specs:
        if spec in arms:
            spec = f"{spec}={arms[spec]}" if arms[spec] else spec
        name, _, subs = spec.partition("=")
        name, _, path = name.partition(":")
        text = Path(path).read_text() if path else base
        for sub in filter(None, subs.split("@@")):
            old, new = sub.split("=>")
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        out[name] = text
    return out


def source_dirs(specs) -> dict:
    """The directory of each ``name:path`` spec's source, by name: another
    commit's ``flash.cu`` is built against the ``hopper.cuh`` beside it."""
    out = {}
    for spec in specs:
        name, _, path = spec.partition("=")[0].partition(":")
        if path:
            out[name] = Path(path).resolve().parent
    return out


def build(item, dirs=None) -> tuple:
    name, text = item
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    include = (dirs or {}).get(name)
    inc = ["-I", str(include)] if include else []
    cmd = [_build._nvcc(), *_build.FLAGS, *inc, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return name, proc.returncode, proc.stdout + proc.stderr


def ptxas_report(log: str, kernel: str = "flash_bf16_kernel") -> list:
    """(instantiation, registers, spill stores, spill loads) of ``kernel``."""
    pat = (kernel + r"ILi(\d+)E[^\n]*\n\s+\d+ bytes stack frame, (\d+) bytes "
           r"spill stores, (\d+) bytes spill loads\n[^\n]*Used (\d+) registers")
    return [(int(dp), int(r), int(st), int(ld))
            for dp, st, ld, r in re.findall(pat, log)]


def events_ms(fn, reps=20) -> tuple:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    single = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        single.append(start.elapsed_time(stop))
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        fn()
    stop.record()
    stop.synchronize()
    return statistics.median(single), start.elapsed_time(stop) / 50


def bound_call(lib, dtype, q, k, v, out, dims, stream):
    """The variant's forward on these tensors and dims, as a call without
    arguments returning its cudaError_t; in float32 with a workspace
    allocated in each call, as the wrapper does."""
    # no row log-sum-exp (a null lse pointer), as serving calls the forward
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0)
    if dtype == torch.bfloat16:
        return lambda: lib.flash_attention_bf16(*head, *dims, stream)
    fn = lib.flash_attention_f32
    fn.argtypes, fn.restype = [_P] * 6 + [_I] * 9 + [_P], _I
    lib.flash_f32_workspace.argtypes, lib.flash_f32_workspace.restype = [_I] * 6 + [_P], _I
    n = ctypes.c_longlong()
    if lib.flash_f32_workspace(*dims[:6], ctypes.addressof(n)):
        raise RuntimeError("flash_f32_workspace failed")

    def call():
        work = torch.empty(n.value, dtype=torch.float32, device="cuda")
        return fn(*head, work.data_ptr() if n.value else 0, *dims, stream)
    return call


def bounds_ms(b, sq, sk, h, kh, d, causal, window, dtype) -> dict:
    """``chip_smoke.py``'s bound of the forward at one shape, for the kernel
    the library instantiates at head dim ``d``."""
    work = cs.flash_work(b, sq, sk, h, kh, d, causal, window, dtype.itemsize)
    tf32 = dtype == torch.float32 and kflash.f32_geometry(d)["wgmma"] == 1
    return cs.flash_bound(*work, dtype, tf32)


def sdpa(q, k, v, causal, window):
    """``scaled_dot_product_attention`` on [B, H, S, D] copies (the
    yardstick, as in ``chip_smoke.py``)."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = dict(is_causal=causal)
    if window is not None:
        i = torch.arange(q.shape[1], device=q.device)[:, None]
        j = torch.arange(k.shape[1], device=q.device)[None, :]
        kw = dict(attn_mask=(j > i - window) & ((j <= i) if causal else True))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("specs", nargs="*")
    args = parser.parse_args()
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants.py: no CUDA device available")
    OUT.mkdir(parents=True, exist_ok=True)
    specs = args.specs or (list(ARMS) if dtype == torch.float32 else ["final"])
    sources = variant_sources(specs)
    dirs = source_dirs(specs)
    kernel = "flash_bf16_kernel" if dtype == torch.bfloat16 else "flash_tf32_kernel"
    libs = {}
    with ThreadPoolExecutor(len(sources) or 1) as pool:
        for name, rc, log in pool.map(lambda item: build(item, dirs), sources.items()):
            (OUT / f"{name}.log").write_text(log)
            print(f"{name}: nvcc exit {rc}; (DP, registers, spill stores, spill loads) "
                  f"{ptxas_report(log, kernel) or ptxas_report(log, 'flash_f32_kernel')}",
                  flush=True)
            if rc == 0:
                lib = ctypes.CDLL(str(OUT / f"{name}.so"))
                lib.flash_attention_bf16.argtypes = [_P] * 5 + [_I] * 9 + [_P]
                lib.flash_attention_bf16.restype = _I
                libs[name] = lib
            else:
                print(log[-4000:], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for what, b, sq, sk, h, kh, d, causal, window in SHAPES[dtype]:
        q, k, v = (torch.randn(b, s, n, d, device="cuda", generator=gen).to(dtype)
                   for s, n in ((sq, h), (sk, kh), (sk, kh)))
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, kv_len=sk)
        dims = (b, sq, sk, h, kh, d, int(causal), window or 0, sk)
        cases.append((what, dims, q, k, v, want.float(), sdpa(q, k, v, causal, window)))
        bnd = bounds_ms(b, sq, sk, h, kh, d, causal, window, dtype)
        scalar = (f", scalar {bnd['scalar_bound_ms']:.4f} ms ({bnd['scalar_bound_by']})"
                  if "scalar_bound_ms" in bnd else "")
        print(f"bound {what}: {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}){scalar}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for rnd, names in enumerate((list(libs), list(libs)[::-1])):
        cells = []
        for case in cases:
            single, queued = events_ms(case[6])
            cells.append(f"{case[0]}: {single:.4f} / {queued:.4f} ms")
        print(f"round {rnd} SDPA: " + " | ".join(cells), flush=True)
        for name in names:
            cells = []
            for what, dims, q, k, v, want, _ in cases:
                out = torch.empty_like(q)
                call = bound_call(libs[name], dtype, q, k, v, out, dims, stream)
                err = call()
                torch.cuda.synchronize()
                rel = float((out.float() - want).norm() / want.norm())
                if err or not (rel < TOLERANCE[dtype] or name in TIMING_ONLY):
                    cells.append(f"{what}: FAILED (cudaError_t {err}, error {rel:.3g})")
                    continue
                single, queued = events_ms(call)
                cells.append(f"{what}: {single:.4f} / {queued:.4f} ms (error {rel:.3g})")
            print(f"round {rnd} {name}: " + " | ".join(cells), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(out.stdout.strip())


if __name__ == "__main__":
    main()
