"""The benchmark's cells on the card, at their own sizes: a short run of
each is correct and reports its metrics, and the control fails one of its
numbers.  Each test decides inside itself whether a card is present and
skips, with the reason, where none is."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import calibrate, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in harness.benchmark()["workloads"]]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cell, trace):
    _need_card()
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed", str(2**31 + 77),
         "--seconds", "4", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    want = {m["name"] for m in harness.metrics_for(harness.benchmark(), cell, bool(trace))}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_number_on_the_card(cell):
    _need_card()
    harness.setup_environment()
    entry = harness.find_cell(harness.benchmark(), cell)
    config, traffic, limits = harness.cell_files(entry)
    run = harness.Run(name=cell, cell=entry, config=config, traffic=traffic, limits=limits,
                      seed=2**31 + 78, seconds=8.0, trace=False, device="cuda",
                      t_start=time.perf_counter())
    got = calibrate.control(run)
    assert any(got[n] > limit for n, limit in limits.items() if n in got), (got, limits)
