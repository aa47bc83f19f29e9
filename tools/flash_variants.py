#!/usr/bin/env python3
"""Compare design variants of the bf16 flash kernel on one GPU.

    python3 tools/flash_variants.py SPEC [SPEC ...]      # from the repo root

Each SPEC names one build of ``src/repro_torch/csrc/flash.cu``:

    name                     the checkout's source as it is
    name:path                another source with the same C interface,
                             the ``lse`` pointer after ``out`` included (an
                             older commit's: ``git show REV:src/repro_torch/
                             csrc/flash.cu > path``; sources written before
                             the forward took ``lse`` lack it)
    name=OLD=>NEW[@@OLD=>NEW...]   the checkout's source with each OLD text
                             replaced by NEW (a tile size, a stage count,
                             a switch)

All variants are built at once with the port's ``nvcc`` flags (and
``csrc`` on the include path, for ``hopper.cuh``) into
``chiprun_out/flash_variants/``, their ptxas register and spill counts
printed, then each is held to the plain version at the phase-2 shapes of
``chip_smoke.py`` (relative error of the whole output, which must stay
under 1e-2) and timed with CUDA events: the median of 20 single calls and
the mean of 50 calls queued back to back.  Two rounds, the second in
reverse order, so that drift on the card shows.  The last line is the
card's name and power limit.
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

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ref  # noqa: E402

OUT = ROOT / "chiprun_out" / "flash_variants"
# (what, B, Sq, Sk, H, KH, D, causal, window): chip_smoke.py's timed bf16 shapes
SHAPES = [
    ("smollm", 1, 4096, 4096, 9, 3, 64, True, None),
    ("olmo", 1, 4096, 4096, 16, 16, 128, True, None),
    ("mixtral w1024", 1, 4096, 4096, 32, 8, 128, True, 1024),
    ("non-causal 1000x3001", 2, 1000, 3001, 8, 2, 64, False, None),
    ("d256", 1, 4096, 4096, 4, 4, 256, True, None),
]
_P, _I = ctypes.c_void_p, ctypes.c_int


def variant_sources(specs) -> dict:
    base = (_build.CSRC / "flash.cu").read_text()
    out = {}
    for spec in specs:
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
    """(instantiation, registers, spill stores, spill loads) of the bf16 kernel."""
    pat = (r"flash_bf16_kernelILi(\d+)E[^\n]*\n\s+\d+ bytes stack frame, (\d+) bytes "
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


def bound_call(fn, q, k, v, out, dims, stream):
    """``fn`` on these tensors and dims, as a call without arguments."""
    # no row log-sum-exp (a null lse pointer), as serving calls the forward
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0, *dims, stream)
    return lambda: fn(*args)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants.py: no CUDA device available")
    OUT.mkdir(parents=True, exist_ok=True)
    sources = variant_sources(sys.argv[1:])
    libs = {}
    with ThreadPoolExecutor(len(sources) or 1) as pool:
        for name, rc, log in pool.map(build, sources.items()):
            (OUT / f"{name}.log").write_text(log)
            print(f"{name}: nvcc exit {rc}; (DP, registers, spill stores, spill loads) "
                  f"{ptxas_report(log)}", flush=True)
            if rc == 0:
                fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_bf16
                fn.argtypes, fn.restype = [_P] * 5 + [_I] * 9 + [_P], _I
                libs[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for what, b, sq, sk, h, kh, d, causal, window in SHAPES:
        q, k, v = (torch.randn(b, s, n, d, device="cuda", generator=gen).bfloat16()
                   for s, n in ((sq, h), (sk, kh), (sk, kh)))
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, kv_len=sk)
        cases.append((what, (b, sq, sk, h, kh, d, int(causal), window or 0, sk), q, k, v,
                      want.float()))
    stream = torch.cuda.current_stream().cuda_stream
    for rnd, names in enumerate((list(libs), list(libs)[::-1])):
        for name in names:
            cells = []
            for what, dims, q, k, v, want in cases:
                out = torch.empty_like(q)
                call = bound_call(libs[name], q, k, v, out, dims, stream)
                err = call()
                torch.cuda.synchronize()
                rel = float((out.float() - want).norm() / want.norm())
                if err or not rel < 1e-2:
                    cells.append(f"{what}: FAILED (cudaError_t {err}, error {rel:.3g})")
                    continue
                single, queued = events_ms(call)
                cells.append(f"{what}: {single:.4f} / {queued:.4f} ms")
            print(f"round {rnd} {name}: " + " | ".join(cells), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(out.stdout.strip())


if __name__ == "__main__":
    main()
