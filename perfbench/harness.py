"""Run one cell of ``BENCHMARK.json`` once and print its result line.

The cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<mix>.json``, whose ``runner`` names ``runners/<kind>.py``);
its limits are ``limits/<cell>.json``; each metric is read by
``metrics/<metric>.py``.  The runner builds the port's system, warms it up,
measures for ``--seconds``, and judges what the timed path produced against
``reference/``.  The last line of standard output is one JSON object; the
last lines of standard error are each compared number beside its limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names no process of the benchmark may hold: JAX and the
#: JAX package the port was made from (``repro_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot measure this cell here (exit code 2, no result)."""


@dataclasses.dataclass
class Run:
    """What a runner is given."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    #: the port's model config in place of ``config["port_config"]`` (tests)
    port_config: Any = None
    #: applied to the port's modules before the run (tests plant faults)
    patch: Optional[Callable] = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise Refused(f"{path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise Refused(f"no workload {name!r} in BENCHMARK.json")


def cell_files(cell: dict, base: Path = HERE) -> tuple:
    """(config, traffic, limits) of a cell, found by name."""
    config = load_json(base / "configs" / f"{cell['config']}.json")
    traffic = load_json(base / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(base / "limits" / f"{cell['name']}.json")
    return config, traffic, limits


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics this cell reports: with ``trace`` the per-layer ones
    whose ``workloads`` list it, else its end-to-end ones (an end-to-end
    metric without ``workloads`` is every cell's)."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def read_metrics(specs: List[dict], obs: dict, base: Path = HERE) -> Dict[str, dict]:
    out = {}
    for spec in specs:
        reader = load_module(base / "metrics" / f"{spec['name']}.py",
                             f"perfbench_metric_{len(out)}")
        value = reader.read(obs)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def forbidden_modules(names=None) -> List[str]:
    """The modules of ``names`` (default: ``sys.modules``) whose top-level
    name, the part before the first dot, is one of ``FORBIDDEN``."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """``name, power limit`` of the card by ``nvidia-smi`` (empty if absent)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def execute(run: Run, bench: dict) -> dict:
    """Run the cell and return the result object (also what tests read)."""
    kind = run.traffic["runner"]
    if not (HERE / "runners" / f"{kind}.py").exists():
        raise Refused(f"no runner {kind!r}")
    runner = importlib.import_module(f"perfbench.runners.{kind}")
    outcome = runner.run(run)
    checks = outcome["checks"]
    correct = outcome["failed"] == 0 and all(c["ok"] for c in checks.values())
    obs = outcome["obs"]
    metrics = read_metrics(metrics_for(bench, run.name, run.trace), obs)
    device = outcome["device"]
    result = {"correct": bool(correct), "attempted": int(outcome["attempted"]),
              "failed": int(outcome["failed"]), "metrics": metrics, "device": device}
    trace = obs.get("trace")
    if run.trace and trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    card = card_line() if run.device == "cuda" else ""
    result["notes"] = dict(outcome.get("notes", {}), card=card)
    result["checks"] = {n: {"value": c["value"], "limit": c["limit"]} for n, c in checks.items()}
    return result


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def setup_environment(root: Path = ROOT) -> None:
    """Caches inside the checkout, at fixed paths; the port importable."""
    cache = root / ".perfbench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        raise Refused(f"the port is not here: {src / 'repro_torch'} is missing")
    for p in (str(src), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        bench = benchmark()
        cell = find_cell(bench, args.workload)
        config, traffic, limits = cell_files(cell)
        setup_environment()
        import torch

        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False: this benchmark runs on the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{cell['name']} needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} visible")
        run = Run(name=cell["name"], cell=cell, config=config, traffic=traffic, limits=limits,
                  seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device="cuda", t_start=t_start)
        result = execute(run, bench)
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
