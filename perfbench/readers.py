"""Arithmetic the metric readers share (``metrics/<name>.py`` each call one
of these with what the runner observed).  A reader returns None where the
run has nothing for it to read, and the metric is then left out."""

from __future__ import annotations

import re
import statistics
from typing import Optional

from . import counts

def _function(name: str) -> str:
    """The bare function name of a demangled kernel name."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"^(?:void\s+)?([\w:]+)", name.strip())
    return m.group(1).split("::")[-1] if m else name


def device_seconds(obs: dict, functions) -> float:
    trace = obs.get("trace") or {}
    return sum(t for n, t in trace.get("device_s", {}).items() if _function(n) in functions)


def roofline(obs: dict, which: str, functions) -> Optional[float]:
    """% of the roofline of the attention kernels' device time in the
    traced window: the least time of every call there (``flash_work`` /
    ``flash_bwd_work`` of its shape at the bf16 peak and the memory's rate)
    over the time the device spent in the device ``functions`` (the
    kernels' names in the trace, which the metric's reader gives)."""
    calls = (obs.get("traced_flash") or {}).get(which) or []
    spent = device_seconds(obs, functions)
    if not calls or spent <= 0:
        return None
    work = counts.flash_work if which == "fwd" else counts.flash_bwd_work
    bound = sum(counts.bound_s(*work(*shape)) for shape in calls)
    return 100.0 * bound / spent


def idle(obs: dict) -> Optional[float]:
    trace = obs.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def median_ms(obs: dict, span: str) -> Optional[float]:
    vals = (obs.get("spans") or {}).get(span)
    return 1e3 * statistics.median(vals) if vals else None


def quantile(vals, q: float) -> Optional[float]:
    """The ``q`` quantile of ``vals`` by linear interpolation between order
    statistics (numpy's default), over every value."""
    if not vals:
        return None
    v = sorted(vals)
    x = q * (len(v) - 1)
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def rate(obs: dict, key: str) -> Optional[float]:
    """A count of the window over the window's seconds."""
    if obs.get("window_s", 0) <= 0 or key not in obs:
        return None
    return obs[key] / obs["window_s"]


def mfu(obs: dict) -> Optional[float]:
    """% of the card's bf16 peak: the model FLOPs of the window's work over
    its seconds."""
    if obs.get("window_s", 0) <= 0 or not obs.get("model_flops"):
        return None
    return 100.0 * obs["model_flops"] / obs["window_s"] / counts.BF16_FLOPS
