"""Spans, and the reading of a ``torch.profiler`` trace of the card.

``Spans`` keeps the runner's own host-clock spans in memory.  ``profile``
traces a region (CPU and CUDA activities; the region is marked by a
``perfbench.traced_window`` range) and ``summarize`` reduces the trace to
what the metrics read: the window's length, the union of the device's busy
intervals inside it, device time by operation name, and the idle gaps
labelled by the innermost host operation running at each gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

WINDOW = "perfbench.traced_window"


class Spans:
    """Named host-clock spans (seconds), kept in memory."""

    def __init__(self) -> None:
        self.spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        if sync:
            sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                sync()
            self.spans[name].append(time.perf_counter() - t0)


@contextlib.contextmanager
def profile():
    """Trace the body; yields a holder whose ``prof`` is set on exit."""
    import torch

    holder = type("Traced", (), {"prof": None})()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield holder
            torch.cuda.synchronize()
    holder.prof = prof


def _times(ev):
    """(start, end) in seconds of a kineto event."""
    if hasattr(ev, "start_ns"):
        s = ev.start_ns() * 1e-9
        return s, s + ev.duration_ns() * 1e-9
    s = ev.start_us() * 1e-6
    return s, s + ev.duration_us() * 1e-6


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, top: int = 10) -> Optional[dict]:
    """The traced window's ``window_s``, ``busy_s`` (union of device
    intervals in it), ``device_s`` by operation name, the ``top`` device
    operations and the ``top`` idle-gap labels by summed seconds, and the
    ``gap_s`` between device operations.  None if the trace holds no
    window or no device operation."""
    import torch

    events = prof.profiler.kineto_results.events()
    cpu_type = torch.autograd.DeviceType.CPU
    window = None
    device, host = [], []
    for ev in events:
        name = ev.name()
        if ev.device_type() == cpu_type:
            s, e = _times(ev)
            if name == WINDOW:
                window = (s, e)
            elif e > s and not name.startswith(("cu", "Activity Buffer")):
                host.append((s, e, name))  # runtime calls are labelled by their op
        elif name != WINDOW and not name.startswith("Activity Buffer"):
            # (the window's range is mirrored on the device's timeline)
            s, e = _times(ev)
            if e > s:
                device.append((s, e, name))
    if window is None or not device:
        return None
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in inside])
    busy_s = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in inside:
        by_name[n] += e - s
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i], edges[i + 1]))
    host.sort()
    starts = [s for s, _, _ in host]
    by_gap: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        # innermost (latest-starting) host operation covering the middle
        label = "host idle"
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(-1, last - 2000), -1):
            hs, he, hn = host[j]
            if he >= mid:
                label = hn
                break
        by_gap[label] += e - s
    return {
        "window_s": w1 - w0,
        "busy_s": busy_s,
        "device_s": dict(by_name),
        "device_ops": sorted(([n, t] for n, t in by_name.items()), key=lambda r: -r[1])[:top],
        "idle_gaps": sorted(([n, t] for n, t in by_gap.items()), key=lambda r: -r[1])[:top],
    }
