"""Render the dry run's tables from the sweep JSONs (PyTorch port of the
JAX package's ``launch/report.py``).

    PYTHONPATH=src python -m repro_torch.launch.report [--dir benchmarks/results/dryrun_torch]

Reads every record the dry-run wrote and emits the two markdown tables plus
a bottleneck summary.  Keeping this separate from the dry-run means the
tables are always regenerable from the recorded artifacts.  The tables are
the reference's; the "next lever" hints name the H100's units.  In the
port's records ``lower_s`` is the seconds that building a cell's placed
inputs took and ``compile_s`` those of its counting run.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

__all__ = ["load_records", "dryrun_table", "roofline_table", "summary", "main"]

_ARCH_ORDER = [
    "whisper-medium", "smollm-135m", "deepseek-67b", "olmo-1b",
    "granite-20b", "xlstm-1.3b", "qwen2-moe-a2.7b", "mixtral-8x7b",
    "llava-next-mistral-7b", "jamba-1.5-large-398b",
]
_SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_records(directory: str, tag: str = "") -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        stem = os.path.basename(path)[: -len(".json")]
        if tag:
            if not stem.endswith(f"_{tag}"):
                continue
        elif any(
            stem.endswith(f"_{t}") for t in ("hc1", "hc2", "hc3")
        ):  # hillclimb variants excluded from baseline tables
            continue
        with open(path) as f:
            recs.append(json.load(f))
    key = lambda r: (
        _ARCH_ORDER.index(r["arch"]) if r["arch"] in _ARCH_ORDER else 99,
        _SHAPE_ORDER.index(r["shape"]) if r["shape"] in _SHAPE_ORDER else 99,
        r["mesh"],
    )
    return sorted(recs, key=key)


def _gb(x) -> str:
    return f"{x / 1e9:.2f}" if x is not None else "—"


def dryrun_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | lower s | compile s | "
        "args GB/dev | temp GB/dev | temp adj GB/dev | overrides |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | skipped "
                f"(sub-quadratic rule) | — | — | — | — | — | — |"
            )
            continue
        if r["status"] == "error":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | **ERROR** "
                f"| — | — | — | — | — | — |"
            )
            continue
        mem = r.get("memory", {})
        ov = ",".join(f"{k}→{v}" for k, v in
                      (r.get("rule_overrides") or {}).items()) or "baseline"
        lines.append(
            "| {arch} | {shape} | {mesh} | ok | {lo:.1f} | {co:.1f} | "
            "{a} | {t} | {ta} | {ov} |".format(
                arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                lo=r.get("lower_s", 0), co=r.get("compile_s", 0),
                a=_gb(mem.get("argument_size_in_bytes")),
                t=_gb(mem.get("temp_size_in_bytes")),
                ta=_gb(mem.get("temp_adjusted_bytes")),
                ov=ov,
            )
        )
    return "\n".join(lines)


_HINTS = {
    "compute": "compute-bound: gains need better tensor-core utilization "
               "(layout, fusion) or fewer redundant FLOPs (remat policy)",
    "memory": "HBM3-bound: cut bytes/step — wider fusion, bf16 carries, "
              "larger per-card batch to amortize weight streaming",
    "collective": "NVLink-bound: reshard to remove the dominant collective "
                  "or overlap it with compute (async collectives)",
}


def roofline_table(recs: List[Dict], mesh: str = "pod16x16") -> str:
    lines = [
        "| arch | shape | t_comp s | t_mem s | t_coll s | bottleneck | "
        "MODEL_FLOPS | useful | roofline frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh or r["status"] != "ok":
            continue
        t = r["roofline"]
        lines.append(
            "| {arch} | {shape} | {tc:.3e} | {tm:.3e} | {tl:.3e} | {b} | "
            "{mf:.2e} | {u:.2f} | {fr:.2f} | {hint} |".format(
                arch=r["arch"], shape=r["shape"],
                tc=t["t_compute"], tm=t["t_memory"], tl=t["t_collective"],
                b=t["bottleneck"], mf=t["model_flops"],
                u=t["useful_ratio"], fr=t["roofline_fraction"],
                hint=_HINTS[t["bottleneck"]],
            )
        )
    return "\n".join(lines)


def summary(recs: List[Dict]) -> str:
    ok = [r for r in recs if r["status"] == "ok"]
    skipped = [r for r in recs if r["status"] == "skipped"]
    err = [r for r in recs if r["status"] == "error"]
    out = [
        f"cells: {len(ok)} ok, {len(skipped)} skipped (per assignment), "
        f"{len(err)} errors",
    ]
    bn: Dict[str, int] = {}
    for r in ok:
        if r["mesh"] == "pod16x16":
            b = r["roofline"]["bottleneck"]
            bn[b] = bn.get(b, 0) + 1
    out.append(f"single-pod bottlenecks: {bn}")
    for r in err:
        out.append(f"ERROR {r['arch']} {r['shape']} {r['mesh']}: "
                   f"{r.get('error', '?')}")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="benchmarks/results/dryrun_torch")
    p.add_argument("--tag", default="")
    p.add_argument("--mesh", default="pod16x16")
    args = p.parse_args(argv)
    recs = load_records(args.dir, args.tag)
    print("## Dry-run\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod 16x16)\n")
    print(roofline_table(recs, args.mesh))
    print("\n## Summary\n")
    print(summary(recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
