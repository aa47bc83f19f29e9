"""PyTorch port, degree-d polynomial aggregates, held against the JAX
package's ``repro.core.polynomial`` on the same numpy-seeded relations.

Both sides compute in float64 (the port's aggregates are float64 tensors,
on the CPU here): degrees 1–3 of ``polynomial_cofactors`` (aggregates up to
degree 6) and ``polynomial_aggregates`` equal the reference's at 1e-12 of
the largest aggregate, with the same monomials in the same order.  Degree 1
equals the quadratic engine over the sorted features plus the label at
1e-10 of its largest entry, and degree 2 the flat oracle of
``benchmarks/bench_polynomial.py`` (the materialized join expanded to
monomial columns, one Gram) at rtol 1e-7.
"""

import numpy as np
import pytest
import torch

import repro.core.polynomial as RP
import repro.data.synthetic as RS
import repro_torch.core.factorize as PF
import repro_torch.core.polynomial as PP
import repro_torch.data.synthetic as PS
from repro_torch.core.cofactor import design_matrix
from repro_torch.core.variable_order import INTERCEPT
from repro_torch.kernels import ops as kops

BUNDLES = [
    ("figure1", lambda m: m.figure1_schema()),
    ("favorita", lambda m: m.favorita_like(n_dates=8, n_stores=4, n_items=6, seed=3)),
] + [
    (f"acyclic{s}", lambda m, s=s: m.random_acyclic_schema(s))
    for s in (0, 1, 2, 7, 13, 42)
]
IDS = [name for name, _ in BUNDLES]
REL = 1e-12


def _pair(make):
    return make(PS), make(RS)


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("make", [m for _, m in BUNDLES], ids=IDS)
def test_polynomial_cofactors_match_reference(make, degree):
    pb, rb = _pair(make)
    got = PP.polynomial_cofactors(
        pb.store, pb.vorder, pb.features, pb.label, degree, device="cpu"
    )
    want = RP.polynomial_cofactors(
        rb.store, rb.vorder, rb.features, rb.label, degree
    )
    assert got.features == want.features
    assert got.count == want.count
    scale = np.abs(want.matrix()).max()
    np.testing.assert_allclose(got.matrix(), want.matrix(), rtol=0,
                               atol=REL * scale)


@pytest.mark.parametrize("make", [m for _, m in BUNDLES[:3]], ids=IDS[:3])
def test_polynomial_aggregates_match_reference(make):
    pb, rb = _pair(make)
    feats = pb.features + [pb.label]
    got = PP.polynomial_aggregates(pb.store, pb.vorder, feats, 4, device="cpu")
    want = RP.polynomial_aggregates(rb.store, rb.vorder, feats, 4)
    assert list(got) == list(want)
    scale = max(abs(v) for v in want.values())
    for mono, v in want.items():
        assert abs(got[mono] - v) <= REL * scale, mono
    assert PP.expand_monomials(feats, 3) == RP.expand_monomials(feats, 3)


@pytest.mark.parametrize("make", [m for _, m in BUNDLES], ids=IDS)
def test_degree1_matches_quadratic_engine(make):
    """The degree-d engine at d = 1 equals the degree-≤2 cofactor engine
    over the same monomials (sorted features, then the label)."""
    pb, _ = _pair(make)
    cols = sorted(pb.features) + [pb.label]
    quad = PF.cofactors_factorized(pb.store, pb.vorder, cols, backend="numpy")
    poly = PP.polynomial_cofactors(
        pb.store, pb.vorder, pb.features, pb.label, 1, device="cpu"
    )
    want = quad.matrix()
    np.testing.assert_allclose(poly.matrix(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_degree2_matches_flat_oracle():
    """``bench_polynomial``'s flat pass: the materialized join expanded to
    monomial features, then one Gram."""
    pb = PS.favorita_like(16, 4, 8)
    cols = pb.features + [pb.label]
    z = design_matrix(pb.store.materialize_join(), cols)
    col_of = {c: i for i, c in enumerate(cols)}
    monos = PP.expand_monomials(pb.features, 2)
    exp = [np.ones(z.shape[0])]
    for mono in monos:
        v = np.ones(z.shape[0])
        for name in mono:
            v = v * z[:, col_of[name]]
        exp.append(v)
    exp.append(z[:, col_of[pb.label]])
    zz = np.stack(exp, axis=1)
    fact = PP.polynomial_cofactors(
        pb.store, pb.vorder, pb.features, pb.label, 2, device="cpu"
    ).matrix()
    np.testing.assert_allclose(fact, zz.T @ zz, rtol=1e-7, atol=1e-5)


def test_each_group_by_is_one_segment_blocks_call(monkeypatch):
    """Every aggregated-out node sums all of its view's monomials in ONE
    ``segment_blocks`` call (float64, count block plus an [N, W] block),
    passing each group's row where every group has one."""
    pb = PS.favorita_like(n_dates=8, n_stores=4, n_items=6, seed=3)
    calls = []
    real = kops.segment_blocks

    def spy(c, l, q, seg, num, **kw):
        calls.append((c.dtype, None if l is None else l.shape[1],
                      c.shape[0], num, kw.get("order") is not None))
        return real(c, l, q, seg, num, **kw)

    monkeypatch.setattr(kops, "segment_blocks", spy)
    PP.polynomial_aggregates(pb.store, pb.vorder, pb.features + [pb.label], 3,
                             device="cpu")
    variables = []

    def walk(node):
        if not node.is_relation and node.name != INTERCEPT:
            variables.append(node.name)
        for ch in node.children:
            walk(ch)

    walk(pb.vorder)
    assert len(calls) == len(variables)
    assert all(dtype == torch.float64 for dtype, *_ in calls)
    widths = {w for _, w, *_ in calls}
    # the item_nbr node: 3 features below it → C(3+3, 3) - 1 monomials
    assert 19 in widths
    # one row a group (every fact row its own (date, store, item)) → order
    assert any(unique and m == num for _, _, m, num, unique in calls)
    assert all(not unique or m == num for _, _, m, num, unique in calls)


def test_rejects_degree_and_missing_gpu():
    pb = PS.figure1_schema()
    with pytest.raises(ValueError, match="degree"):
        PP.polynomial_aggregates(pb.store, pb.vorder, pb.features, 0,
                                 device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PP.polynomial_cofactors(pb.store, pb.vorder, pb.features, pb.label, 1)
