#!/usr/bin/env python3
"""Compare design variants of the bf16 flash backward on one GPU.

    python3 tools/flash_bwd_variants.py [SPEC ...]      # from the repo root

Each SPEC names one build of ``src/repro_torch/csrc/flash_bwd.cu``, as
``tools/flash_variants.py`` names the forward's:

    name                     the checkout's source as it is
    name:path                another source with the same C interface
                             (``flash_backward_bf16`` and
                             ``flash_bwd_workspace``)
    name=OLD=>NEW[@@OLD=>NEW...]   the checkout's source with each OLD text
                             replaced by NEW
    NAME                     an arm of ``ARMS`` below (the measured
                             design choices); no SPEC at all runs them all

All variants are built at once with the port's ``nvcc`` flags (and
``csrc`` on the include path, for ``hopper.cuh``) into
``chiprun_out/flash_bwd_variants/``, the ptxas registers and spills of
their ``wgmma`` kernel printed, then each is held to the plain
``flash_backward_ref`` at the training shapes of ``chip_smoke.py``'s
``FLASH_BWD_TIMED`` (the relative error of each of dq, dk, dv must stay
under 1e-2) and timed with CUDA events, the zeroed workspace allocated in
each call as the wrapper does: the median of 20 single calls and the mean
of 20 calls queued back to back.  Two rounds, the second in reverse order,
so that drift on the card shows; SDPA's backward on the same inputs in
each round.  The last line is the card's name and power limit.
"""

from __future__ import annotations

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

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash as kflash  # noqa: E402

OUT = ROOT / "chiprun_out" / "flash_bwd_variants"
# (what, B, Sq, Sk, H, KH, D, causal, window): chip_smoke.py's timed
# backward shapes (smollm-135m's, 16 x 128 as qwen2-moe's and olmo-1b's,
# llava's)
SHAPES = [
    ("smollm", 1, 4096, 4096, 9, 3, 64, True, None),
    ("16x128", 1, 4096, 4096, 16, 16, 128, True, None),
    ("llava", 1, 4096, 4096, 32, 8, 128, True, None),
]
_P, _I = ctypes.c_void_p, ctypes.c_int

_STAGES = "static constexpr int kStages = 3;"
#: the measured design choices, as edits of the checkout's source
ARMS = {
    "final": "",
    # the ring of query stages
    "stages_2": f"{_STAGES}=>static constexpr int kStages = 2;",
    "stages_2_at_128": f"{_STAGES}=>static constexpr int kStages = DP >= 128 ? 2 : 3;",
    "stages_4_at_64": f"{_STAGES}=>static constexpr int kStages = DP >= 128 ? 3 : 4;",
    # dQ by each warpgroup over its own 64 keys, every tile (twice the
    # atomics), after a barrier of its own
    "dq_per_warpgroup": "@@".join((
        'if (wg != (i & 1)) {\n'
        '        asm volatile("bar.arrive %0, %1;\\n" ::"r"(bar_id), "n"(kThreads16)\n'
        '                     : "memory");\n'
        '        continue;\n'
        '      }\n'
        '      asm volatile("bar.sync %0, %1;\\n" ::"r"(bar_id), "n"(kThreads16)\n'
        '                   : "memory");'
        '=>asm volatile("bar.sync %0, 128;\\n" ::"r"(bar_id + 2 * wg) : "memory");',
        "T::issue_dq(acc, ds_all, k_s, p);=>T::issue_dq(acc, ds, k_wg, p);",
        "for (int kt = 0; kt < kBK / 16; ++kt) {\n      const uint64_t da = smem_desc<128>("
        "=>for (int kt = 0; kt < kKeysWG / 16; ++kt) {\n      const uint64_t da = smem_desc<128>(",
    )),
    # timing only (wrong by design): dQ's atomics never issued
    "no_dq_atomics": ("atomicAdd(reinterpret_cast<float2*>(row + col),"
                      "=>if (acc[0] == 1234.5f) atomicAdd(reinterpret_cast<float2*>(row + col),"),
}
#: arms timed although they fail the check (they drop work on purpose)
TIMING_ONLY = {"no_dq_atomics"}


def variant_sources(specs) -> dict:
    base = (_build.CSRC / "flash_bwd.cu").read_text()
    out = {}
    for spec in specs:
        if spec in ARMS:
            spec = f"{spec}={ARMS[spec]}" if ARMS[spec] else spec
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


def build(item) -> tuple:
    name, text = item
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    cmd = [_build._nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return name, proc.returncode, proc.stdout + proc.stderr


def ptxas_report(log: str) -> list:
    """(DP, registers, spill stores, spill loads) of the wgmma kernel."""
    pat = (r"bwd_bf16_kernelILi(\d+)E[^\n]*\n\s+\d+ bytes stack frame, (\d+) bytes "
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
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return statistics.median(single), start.elapsed_time(stop) / reps


def bound_call(lib, case, stream):
    """The variant's backward on one case's tensors, as a call without
    arguments returning (cudaError_t, dq, dk, dv)."""
    dims, q, k, v, o, g, lse = case[1:8]
    b, sq, sk, h, kh, d = dims[:6]
    n = ctypes.c_longlong()
    if lib.flash_bwd_workspace(1, b, sq, sk, h, kh, d, ctypes.addressof(n)):
        raise RuntimeError("flash_bwd_workspace failed")

    def call():
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        work = torch.zeros(n.value, dtype=torch.float32, device="cuda")
        err = lib.flash_backward_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
            lse.data_ptr(), work.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *dims, stream)
        return err, dq, dk, dv
    return call


def sdpa_backward(q, k, v, g, causal):
    """SDPA's backward on [B, H, S, D] copies (the yardstick, as in
    ``chip_smoke.py``)."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    gt = g.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants.py: no CUDA device available")
    OUT.mkdir(parents=True, exist_ok=True)
    sources = variant_sources(sys.argv[1:] or list(ARMS))
    libs = {}
    with ThreadPoolExecutor(len(sources) or 1) as pool:
        for name, rc, log in pool.map(build, sources.items()):
            (OUT / f"{name}.log").write_text(log)
            print(f"{name}: nvcc exit {rc}; (DP, registers, spill stores, spill loads) "
                  f"{ptxas_report(log)}", flush=True)
            if rc == 0:
                lib = ctypes.CDLL(str(OUT / f"{name}.so"))
                lib.flash_backward_bf16.argtypes = [_P] * 10 + [_I] * 9 + [_P]
                lib.flash_backward_bf16.restype = _I
                lib.flash_bwd_workspace.argtypes = [_I] * 7 + [_P]
                lib.flash_bwd_workspace.restype = _I
                libs[name] = lib
            else:
                print(log[-4000:], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for what, b, sq, sk, h, kh, d, causal, window in SHAPES:
        q, k, v, g = (torch.randn(b, s, n, d, device="cuda", generator=gen).bfloat16()
                      for s, n in ((sq, h), (sk, kh), (sk, kh), (sq, h)))
        kw = dict(causal=causal, window=window, kv_len=sk)
        o, lse = kflash.flash_attention(q, k, v, with_lse=True, **kw)
        want = [w.float() for w in ref.flash_backward_ref(q, k, v, o, g, **kw)]
        dims = (b, sq, sk, h, kh, d, int(causal), window or 0, sk)
        cases.append((what, dims, q, k, v, o, g, lse, want, sdpa_backward(q, k, v, g, causal)))
    stream = torch.cuda.current_stream().cuda_stream
    for rnd, names in enumerate((list(libs), list(libs)[::-1])):
        cells = []
        for case in cases:
            single, queued = events_ms(case[9])
            cells.append(f"{case[0]}: {single:.4f} / {queued:.4f} ms")
        print(f"round {rnd} SDPA backward: " + " | ".join(cells), flush=True)
        for name in names:
            cells = []
            for case in cases:
                call = bound_call(libs[name], case, stream)
                err, *got = call()
                torch.cuda.synchronize()
                rel = max(float((a.float() - w).norm() / w.norm()) for a, w in zip(got, case[8]))
                if err or not (rel < 1e-2 or name in TIMING_ONLY):
                    cells.append(f"{case[0]}: FAILED (cudaError_t {err}, error {rel:.3g})")
                    continue
                single, queued = events_ms(call)
                cells.append(f"{case[0]}: {single:.4f} / {queued:.4f} ms"
                             + (f" (timing only, error {rel:.3g})" if name in TIMING_ONLY else ""))
            print(f"round {rnd} {name}: " + " | ".join(cells), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(out.stdout.strip())


if __name__ == "__main__":
    main()
