"""Build and load the port's CUDA kernels at first use.

Each source ``repro_torch/csrc/<name>.cu`` exposes a plain C interface and
compiles with ``nvcc`` alone into a shared library (no PyTorch headers, so a
build takes seconds), which the wrappers load with ``ctypes``.  Libraries
go to ``repro_torch/csrc/build/``, named by a hash of the source, of the
``csrc/*.cuh`` headers it includes (``#include "name.cuh"``, followed
through the headers) and of the flags, so an edited source or header never
loads a stale build.  ``build`` starts one
``nvcc`` per missing library, all at once, and waits for every one.

Kernels may first run on any thread (the factorized service launches them
from its drain worker): ``function`` builds and loads under one lock, and
``build`` names its temporary outputs by process and thread, so two callers
never write one file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

__all__ = [
    "BUILD_DIR",
    "SOURCES",
    "build",
    "function",
    "library_path",
    "nvcc_command",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES: Tuple[str, ...] = (
    "segment_view", "moments", "gram", "segment_gram", "flash", "flash_bwd",
)
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # first build and load of a library


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels build only "
            "where the CUDA toolkit is installed"
        )
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"/]+\.cuh)"', re.M)


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    ``csrc`` headers it includes (each once, in include order) and the
    flags."""
    digest = hashlib.sha1()
    todo, seen = [f"{name}.cu"], set()
    while todo:
        text = (CSRC / todo.pop(0)).read_bytes()
        digest.update(text)
        for header in _INCLUDE.findall(text):
            header = header.decode()
            if header not in seen and (CSRC / header).exists():
                seen.add(header)
                todo.append(header)
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> list:
    return [nvcc, *FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every library of ``names`` not built yet, one ``nvcc`` per
    source running in parallel; ptxas' register/shared-memory report goes
    to ``<library>.log``.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(
            f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
        )
        cmd = nvcc_command(name, tmp, nvcc=_nvcc())
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(lib_name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of library ``lib_name`` (built and loaded
    on first use), typed ``argtypes -> int`` (a ``cudaError_t``)."""
    lib = _libs.get(lib_name)
    if lib is None:
        with _load_lock:
            lib = _libs.get(lib_name)
            if lib is None:
                path = library_path(lib_name)
                if not path.exists():
                    build()
                lib = _libs[lib_name] = ctypes.CDLL(str(path))
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn
