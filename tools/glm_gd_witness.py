#!/usr/bin/env python3
"""GLM GD on the CPU, on the chip smoke's oracle-cell design: whether the
plain float32 accumulation stalls short of IRLS in the reference as it
does in the port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/glm_gd_witness.py --impl jax
    PYTHONPATH=src python3 tools/glm_gd_witness.py --impl torch

The design is the categorical-only compression of
``favorita_like(1684, 54, 410, 0.05, seed=0)`` (1,864,188 sales rows,
store_nbr × item_nbr = 22,140 groups, 465 parameters; label
``onpromotion``, logistic, ridge 1e-3), as ``chip_smoke.py``'s phase 8
builds it on the card.  ``--impl jax`` runs the JAX reference package
(its GD on the CPU), ``--impl torch`` the PyTorch port with
``device="cpu"`` (its ``index_add_`` adds in a fixed order there); one
package a process.  For each ``gd_accum`` it prints the iterations,
``converged``, the penalized NLL and the largest gap between GD's and
IRLS's predicted probabilities (the reference's own test bound is 5e-3),
then one JSON line with the same numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import time

import numpy as np

CAT, LABEL, RIDGE = ["store_nbr", "item_nbr"], "onpromotion", 1e-3
MAX_ITER = 100_000  # the reference's default cap


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--items", type=int, default=410)
    args = ap.parse_args()
    pkg = "repro" if args.impl == "jax" else "repro_torch"
    glm = importlib.import_module(f"{pkg}.core.glm")
    data = importlib.import_module(f"{pkg}.data")
    bundle = data.favorita_like(1684, 54, args.items, 0.05, seed=0)
    design = glm.compressed_design_factorized(
        bundle.store, bundle.vorder, [], CAT, LABEL, backend="numpy")
    base = glm.GLMConfig(family="logistic", ridge=RIDGE)
    if args.impl == "torch":
        base = dataclasses.replace(base, device="cpu")
    irls = glm.fit_glm(design, base)
    want = glm.glm_predict_raw(irls.theta, design.cont, design.cat_ids, design, "logistic")
    rows = bundle.store.get("SalesF").num_rows
    print(f"{args.impl}: {rows} sales rows, {design.num_rows} groups, "
          f"{design.num_params} parameters; IRLS nll={irls.nll!r}")
    out = dict(impl=args.impl, rows=rows, groups=design.num_rows,
               params=design.num_params, irls_nll=irls.nll, gd={})
    for accum in ("fp32", "pairs"):
        cfg = dataclasses.replace(base, solver="gd", gd_accum=accum, gd_max_iter=MAX_ITER)
        t = time.perf_counter()
        res = glm.fit_glm(design, cfg)
        sec = time.perf_counter() - t
        pred = glm.glm_predict_raw(res.theta, design.cont, design.cat_ids, design, "logistic")
        err = float(np.abs(pred - want).max())
        print(f"  GD {accum}: iterations={res.iterations} converged={res.converged} "
              f"nll={res.nll!r} (IRLS + {res.nll - irls.nll:.6g}) "
              f"pred max_abs_err={err:.4e} {sec:.2f}s")
        out["gd"][accum] = dict(iterations=res.iterations, converged=res.converged,
                                nll=res.nll, pred_err=err, seconds=sec)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
