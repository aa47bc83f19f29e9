"""Shared helpers of the port's factorized-service parity tests
(``test_torch_serve_*.py``).

Each scenario takes one package's surface (``pkg``) and returns a record of
what it observed: request results, ``cache_info()`` with its tenant map,
quarantine records, fired faults, ticket outcomes.  ``twin`` runs the
scenario once on the JAX package and once on the port and holds the two
records to each other: the numpy backends at 1e-12, the port's torch
backend (float32, on the CPU) against the reference's jax backend at 1e-5,
and every integer, key and name exactly.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import repro.analysis as RAN
import repro.core.factorize as RFZ
import repro.core.regression as RREG
import repro.core.relation as RREL
import repro.core.store as RST
import repro.core.variable_order as RVO
import repro.data.synthetic as RS
import repro.serve as RSV
import repro_torch.analysis as PAN
import repro_torch.core.factorize as PFZ
import repro_torch.core.regression as PREG
import repro_torch.core.relation as PREL
import repro_torch.core.store as PST
import repro_torch.core.variable_order as PVO
import repro_torch.data.synthetic as PS
import repro_torch.serve as PSV

FP32 = dict(argnames="fp32", argvalues=[False, True], ids=["numpy", "fp32"])


def pkg(ref: bool, fp32: bool) -> types.SimpleNamespace:
    """One package's surface.  ``bk`` holds the engine keywords of the
    backend under test, ``svc`` the service's; ``fp32_backend`` is the name
    a request gives the float32 engine (``"jax"`` / ``"torch"``)."""
    fz, reg, rel, st, vo, data, sv, analysis = (
        (RFZ, RREG, RREL, RST, RVO, RS, RSV, RAN) if ref
        else (PFZ, PREG, PREL, PST, PVO, PS, PSV, PAN)
    )
    fp32_backend = "jax" if ref else "torch"
    if fp32:
        bk = {"backend": "jax"} if ref else {"backend": "torch", "device": "cpu"}
    else:
        bk = {"backend": "numpy"}
    if ref:  # the reference service defaults to numpy
        svc = dict(bk) if fp32 else {}
    else:  # the port's defaults to torch on the card: name the host
        svc = {"backend": bk["backend"], "device": "cpu"}
    return types.SimpleNamespace(
        ref=ref, fp32=fp32, bk=bk, svc=svc, fp32_backend=fp32_backend,
        fz=fz, reg=reg, sv=sv, data=data, analysis=analysis,
        Store=st.Store, Relation=rel.Relation, VariableOrder=vo.VariableOrder,
        FactorizedEngine=fz.FactorizedEngine, AggregateQuery=fz.AggregateQuery,
        BatchPart=fz.BatchPart, Service=lambda store, **kw: sv.FactorizedService(
            store, **{**svc, **kw}),
    )


def host(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def value(v):
    """A comparable record of one request's result."""
    if isinstance(v, dict):  # aggregates: {name: AggregateBlock}
        return {
            name: {
                "keys": {a: host(c) for a, c in blk.keys.items()},
                "count": host(blk.count), "lin": host(blk.lin),
                "quad": host(blk.quad), "features": list(blk.features),
            }
            for name, blk in v.items()
        }
    if hasattr(v, "theta_conv"):  # TrainResult
        return {"theta": v.theta, "theta_conv": v.theta_conv,
                "features": list(v.features), "label": v.label}
    if hasattr(v, "sse"):  # ScoreResult
        return {"sse": float(v.sse), "count": float(v.count)}
    if hasattr(v, "matrix"):  # Cofactors
        return {"matrix": v.matrix(), "features": list(v.features)}
    if hasattr(v, "num_rows"):  # Relation (an append's result)
        return {"rows": int(v.num_rows)}
    raise TypeError(f"no record for {type(v)}")


def outcome(ticket):
    """A ticket's value record, or the name of the error it failed with."""
    assert ticket.done, "wedged ticket"
    try:
        return value(ticket.result())
    except Exception as err:  # noqa: BLE001 - the error type is the record
        return {"error": type(err).__name__}


def quarantine(svc):
    """Quarantine records without the error messages' text (the class name
    stays)."""
    out = []
    for rec in svc.quarantined():
        rec = dict(rec)
        rec["error"] = rec["error"].split("(", 1)[0]
        out.append(rec)
    return out


def info(svc):
    """``cache_info()`` (tenant map, coalescing and robustness counters,
    the store's counters) and the quarantine records."""
    out = dict(svc.cache_info())
    out["quarantine"] = quarantine(svc)
    return out


def same(got, want, rtol, path="obs"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            same(got[k], want[k], rtol, f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, path
        if want.dtype.kind in "iub" or got.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
            np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                                       err_msg=path)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=rtol, abs=rtol), path
    else:
        assert got == want, path


def twin(scenario, fp32=False, **kw):
    """Run ``scenario`` on both packages; their records must agree."""
    want = scenario(pkg(True, fp32), **kw)
    got = scenario(pkg(False, fp32), **kw)
    same(got, want, 1e-5 if fp32 else 1e-12)
    return got


def tight(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


def tenant_sums_audit(info, fields=("passes", "node_visits")):
    """Per-tenant shares sum to the store totals exactly."""
    tenants = info["tenants"].values()
    for field in fields:
        assert sum(t[field] for t in tenants) == info[field], field
    assert sum(t["vc_hits"] for t in tenants) == info["view_cache_hits"]
    assert sum(t["vc_misses"] for t in tenants) == info["view_cache_misses"]
