"""``python -m repro_torch.analysis`` — run the static concurrency checks.

Usage::

    python -m repro_torch.analysis [paths ...] [--baseline FILE]
                                   [--write-baseline FILE] [--verbose]

With no paths, scans ``src/repro_torch`` (resolved relative to the repository
root, i.e. the directory containing this package's ``src`` tree).

Baseline ratchet
----------------
``--baseline FILE`` loads a committed JSON file of finding fingerprints
(rule | file | scope | detail — no line numbers, so unrelated edits don't
churn it).  Findings whose fingerprint appears in the baseline are reported
as *ratcheted* and do not fail the run; any new fingerprint fails with exit
code 1.  ``--write-baseline FILE`` writes the current finding set and exits
0 — use it once to ratchet legacy debt, never to paper over a regression.

Exit codes: 0 clean (or all findings ratcheted), 1 new findings, 2 usage
or I/O error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Iterable, List, Sequence

from . import cow, lockcheck
from .contracts import Contracts, DEFAULT_CONTRACTS
from .lockcheck import Finding

BASELINE_VERSION = 1


def collect(paths: Iterable[Path],
            contracts: Contracts = DEFAULT_CONTRACTS) -> List[Finding]:
    """All static findings (lockcheck + cow) over the given roots."""
    findings: List[Finding] = []
    for root in paths:
        findings.extend(lockcheck.check_paths(root, contracts))
        findings.extend(cow.check_paths(root, contracts))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.detail))
    return findings


def load_baseline(path: Path) -> set:
    data = json.loads(path.read_text())
    if not isinstance(data, dict) or "fingerprints" not in data:
        raise ValueError(f"{path}: not a baseline file")
    return set(data["fingerprints"])


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    payload = {
        "version": BASELINE_VERSION,
        "fingerprints": sorted({f.fingerprint for f in findings}),
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


def _default_root() -> Path:
    # .../src/repro_torch/analysis/cli.py -> .../src/repro_torch
    return Path(__file__).resolve().parent.parent


def main(argv: Sequence[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static concurrency-contract checker "
                    "(lock order, guarded-by, COW discipline).")
    parser.add_argument("paths", nargs="*", type=Path,
                        help="files or directories to scan "
                             "(default: the repro_torch source tree)")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="committed fingerprint baseline; "
                             "ratchets pre-existing findings")
    parser.add_argument("--write-baseline", type=Path, default=None,
                        help="write current findings as the new baseline "
                             "and exit 0")
    parser.add_argument("--verbose", action="store_true",
                        help="also list ratcheted (baselined) findings")
    args = parser.parse_args(argv)

    roots = args.paths or [_default_root()]
    for root in roots:
        if not root.exists():
            print(f"error: no such path: {root}", file=sys.stderr)
            return 2

    try:
        findings = collect(roots)
    except SyntaxError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.write_baseline is not None:
        write_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding(s) "
              f"({len({f.fingerprint for f in findings})} fingerprint(s)) "
              f"to {args.write_baseline}")
        return 0

    baseline = set()
    if args.baseline is not None:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            print(f"error: cannot read baseline: {exc}", file=sys.stderr)
            return 2

    new = [f for f in findings if f.fingerprint not in baseline]
    old = [f for f in findings if f.fingerprint in baseline]

    if args.verbose and old:
        print(f"-- {len(old)} ratcheted finding(s) (in baseline):")
        for f in old:
            print(f"   {f.render()}")
    if new:
        print(f"-- {len(new)} NEW finding(s):")
        for f in new:
            print(f"   {f.render()}")
        print(f"\n{len(new)} new concurrency-contract violation(s); "
              f"fix them or (for deliberate patterns) annotate the line "
              f"with `# lockcheck: <reason>`.")
        return 1
    tag = f", {len(old)} ratcheted" if old else ""
    print(f"analysis clean: {len(findings)} finding(s) total{tag}.")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via __main__
    sys.exit(main())
