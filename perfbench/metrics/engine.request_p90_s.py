"""engine.request_p90_s: 90th percentile of Result.latency_s over every request completed in the window (a tail of a backlog-driven cell)."""

from perfbench import readers


def read(obs):
    return readers.quantile(obs.get("latencies"), 0.9)
