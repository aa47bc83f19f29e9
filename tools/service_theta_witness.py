#!/usr/bin/env python3
"""The factorized service's float32 train on the CPU, against its float64
one: whether the reference's float32 service leaves the coefficients the
data barely determine as far from float64 as the port's does.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/service_theta_witness.py --impl jax
    PYTHONPATH=src python3 tools/service_theta_witness.py --impl torch

Both packages' services train ``chip_smoke.py``'s phase-9 pool
(``SERVICE_POOL``: overlapping subsets of Favorita's eight features, label
``unit_sales``, ridge 0.006) on ``favorita_like(1684, 54, ITEMS, 0.05,
seed=0)``, once on the float64 numpy engine and once on the float32 one
(``backend="jax"`` in the reference, ``backend="torch", device="cpu"`` in
the port), one package a process.  A train takes the unscaled cofactors of
one coalesced traversal and rescales them lazily (§4.2's
``Cofactors.rescale``, a cancelling difference), as
``linear_regression(VERSIONS["closed"], use_cache=True)`` does with float64
cofactors.  For each subset it prints the float32 θ's relative error per
coefficient, how many exceed the smoke's THETA_RTOL (1e-3), the error of
θ in the scaled coordinates over its largest coefficient (the smoke holds
it to THETA_RTOL), and the largest gap between the two models' predictions
on every join row over the largest prediction (the smoke's PRED_RTOL is
1e-4).  Beside each coefficient's error it prints its float32 sensitivity:
the first-order change of the coefficient, over its size, when every
unscaled cofactor carries one float32 rounding (2^-24 of the magnitude it
sums), carried through the rescale and the solve (a first-order bound;
its first entry is the scaled intercept's).  Every feature coefficient
over THETA_RTOL has a sensitivity over it too.  Then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as sm  # noqa: E402  (the pool and the float64 join sums)


def sensitivity(oracle, feats, theta64) -> np.ndarray:
    """|Δθ_j| / |θ_j| to first order, in the scaled coordinates, when each
    unscaled cofactor C_ij is off by 2^-24 · Σ|x_i x_j|."""
    j = oracle._idx(list(feats) + [sm.SERVICE_LABEL])
    x1 = np.column_stack([np.ones(len(oracle.x)), oracle.x[:, j]])
    mag = np.abs(x1).T @ np.abs(x1)
    a = np.eye(len(j) + 1)  # [1, x] → [1, (x − avg) / max]
    a[0, 1:] = -oracle.avg[j] / oracle.mx[j]
    a[1:, 1:] /= oracle.mx[j]
    d_c = np.abs(a).T @ (2.0 ** -24 * mag) @ np.abs(a)
    conv = oracle.scaled(theta64, feats)
    p = len(feats) + 1
    m = oracle.cz[np.ix_([0] + [1 + i for i in j], [0] + [1 + i for i in j])]
    inv = np.linalg.inv(m[:p, :p] + sm.SERVICE_RIDGE * np.eye(p))
    return np.abs(inv) @ (d_c[:p] @ np.abs(conv)) / np.abs(conv[:p])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--items", type=int, default=410)
    args = ap.parse_args()
    pkg = "repro" if args.impl == "jax" else "repro_torch"
    data = importlib.import_module(f"{pkg}.data")
    serve = importlib.import_module(f"{pkg}.serve")
    store_mod = importlib.import_module(f"{pkg}.core.store")
    bundle = data.favorita_like(1684, 54, args.items, 0.05, seed=0)
    fp32 = ({"backend": "jax"} if args.impl == "jax"
            else {"backend": "torch", "device": "cpu"})
    theta = {}
    for name, kw in (("float64", {"backend": "numpy"}), ("float32", fp32)):
        svc = serve.FactorizedService(store_mod.Store(bundle.store.relations()), **kw)
        tickets = [svc.train("t", bundle.vorder, list(f), sm.SERVICE_LABEL,
                             ridge=sm.SERVICE_RIDGE) for f in sm.SERVICE_POOL]
        t = time.perf_counter()
        svc.run()
        print(f"{args.impl} {name}: {len(tickets)} trains in {time.perf_counter() - t:.3f}s")
        theta[name] = [tk.result().theta for tk in tickets]
    oracle = sm.Oracle64(bundle.store)
    rows = []
    for feats, a, b in zip(sm.SERVICE_POOL, theta["float32"], theta["float64"]):
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-12)
        want = oracle.predict(b, feats)
        pred = float(np.abs(oracle.predict(a, feats) - want).max() / np.abs(want).max())
        sa, sb = oracle.scaled(a, feats), oracle.scaled(b, feats)
        scaled = float(np.abs(sa - sb).max() / np.abs(sb).max())
        sens = sensitivity(oracle, feats, b)
        over = int((rel > sm.THETA_RTOL).sum())
        print(f"  {feats}: rel err {np.array2string(rel[:-1], precision=2)}; float32 "
              f"sensitivity {np.array2string(sens, precision=2)}; {over} over THETA_RTOL; "
              f"scaled θ {scaled:.3e}; predictions {pred:.3e}")
        rows.append(dict(features=list(feats), theta64=b.tolist(), rel_err=rel.tolist(),
                         sensitivity=sens.tolist(), over=over, scaled_err=scaled,
                         pred_err=pred))
    print(json.dumps(dict(impl=args.impl, rows=oracle.x.shape[0], trains=rows)))


if __name__ == "__main__":
    main()
