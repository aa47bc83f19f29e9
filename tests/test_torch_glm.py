"""PyTorch port, GLMs over the compressed factorized join, held against the
JAX package on the same numpy-seeded relations (each of
``tests/test_glm.py``'s tests mirrored, plus the FD-reduced GLM of
``test_fd.py`` and ``test_property.py``).

Tolerances:
* compressed designs — the numpy and the float32 torch compression — equal
  the reference's exactly, group order included (counts and label sums
  are integers far inside float32's exact range);
* IRLS θ (host float64 on both sides, the same loop) at 1e-12;
* GD (float32: torch here, the reference's JAX ``lax.while_loop``) held by
  its predictions against IRLS's at 5e-3, the reference's own bound;
* the padded two-float pairwise tree equal to the reference's bitwise;
* GD's float32 objective against the reference's float64 host gradient
  within 1e-5 of the magnitudes each entry sums.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.glm as RG
import repro.data.synthetic as RS
import repro_torch.core.categorical as PC
import repro_torch.core.glm as PG
import repro_torch.data.synthetic as PS

CONT = ["transactions", "dcoilwtico"]
CAT = ["store_nbr", "item_nbr"]
LABEL = "onpromotion"  # 0/1 — a true Bernoulli target in the schema
FAV = dict(n_dates=8, n_stores=4, n_items=6, seed=3)
F64 = dict(rtol=1e-12, atol=1e-12)
GD_PRED_ATOL = 5e-3
GD_GRAD_RTOL = 1e-5  # of the magnitudes a float32 sum adds
CAT2 = ["c0", "c1", "d0", "d1"]
STAR = dict(n_cat=2, domain=12, dep_domain=4, n_rows=400, seed=5)
IRLS = dict(family="logistic", ridge=1e-3)


def _configs(**kw):
    """The same GLM configuration in both packages (the port's on the CPU)."""
    return PG.GLMConfig(**kw, device="cpu"), RG.GLMConfig(**kw)


@pytest.fixture(scope="module")
def bundles():
    return PS.favorita_like(**FAV), RS.favorita_like(**FAV)


@pytest.fixture(scope="module")
def designs(bundles):
    pb, rb = bundles
    return (
        PG.compressed_design_factorized(pb.store, pb.vorder, CONT, CAT, LABEL),
        RG.compressed_design_factorized(rb.store, rb.vorder, CONT, CAT, LABEL),
    )


@pytest.fixture(scope="module")
def onehot(bundles):
    pb, _ = bundles
    joined = pb.store.materialize_join()
    doms = {c: pb.store.attr_domain(c) for c in CAT}
    x, _ = PC.onehot_design_matrix(joined, CONT, CAT, doms)
    y = joined.column(LABEL).astype(np.float64)
    return x, y


def _assert_design_equal(got, want):
    for name in ("cont", "cat_ids", "counts", "ysum"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.cont_names == want.cont_names
    assert got.cat_names == want.cat_names
    assert got.domains == want.domains
    assert got.label == want.label
    assert got.param_names() == want.param_names()


def _predict(res, design):
    return PG.glm_predict_raw(
        res.theta, design.cont, design.cat_ids, design, res.config.family
    )


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_compression_paths_agree(bundles, designs, backend):
    pb, rb = bundles
    _, want = designs
    got = PG.compressed_design_factorized(
        pb.store, pb.vorder, CONT, CAT, LABEL, backend=backend,
        use_view_cache=False, device="cpu",
    )
    _assert_design_equal(got, want)
    mat = PG.compressed_design_materialized(pb.store, CONT, CAT, LABEL)
    _assert_design_equal(
        mat, RG.compressed_design_materialized(rb.store, CONT, CAT, LABEL)
    )
    joined = pb.store.materialize_join()
    assert got.total_rows == joined.num_rows
    assert got.num_rows == mat.num_rows
    np.testing.assert_allclose(sorted(got.counts), sorted(mat.counts))
    np.testing.assert_allclose(sorted(got.ysum), sorted(mat.ysum))


@pytest.mark.parametrize("family", ["logistic", "poisson"])
def test_compressed_irls_matches_onehot_oracle(designs, onehot, family):
    """Compressed GLM == dense one-hot within 1e-5, and == the reference's
    compressed fit at 1e-12."""
    pd, rd = designs
    x, y = onehot
    pcfg, rcfg = _configs(family=family, ridge=1e-3)
    compressed = PG.fit_glm(pd, pcfg)
    dense = PG.fit_glm_onehot(x, y, pcfg)
    assert compressed.converged and dense.converged
    np.testing.assert_allclose(
        compressed.theta, dense.theta, rtol=1e-5, atol=1e-5
    )
    ref = RG.fit_glm(rd, rcfg)
    assert compressed.iterations == ref.iterations
    np.testing.assert_allclose(compressed.theta, ref.theta, **F64)
    assert compressed.nll == pytest.approx(ref.nll, rel=1e-12)


def test_gd_solver_agrees_on_predictions(designs):
    """The float32 GD path reaches the same model as IRLS up to float32
    resolution — compared on predictions, which are insensitive to the
    near-collinear one-hot/intercept direction — and so does the
    reference's JAX GD on the same design."""
    pd, rd = designs
    pcfg, rcfg = _configs(**IRLS)
    irls = PG.fit_glm(pd, pcfg)
    p_irls = _predict(irls, pd)
    gd_kw = dict(solver="gd", gd_max_iter=20_000)
    gd = PG.fit_glm(pd, dataclasses.replace(pcfg, **gd_kw))
    ref_gd = RG.fit_glm(rd, dataclasses.replace(rcfg, **gd_kw))
    np.testing.assert_allclose(_predict(gd, pd), p_irls, atol=GD_PRED_ATOL)
    np.testing.assert_allclose(_predict(ref_gd, pd), p_irls, atol=GD_PRED_ATOL)
    assert gd.names == ref_gd.names


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_glm_regression_pipeline(bundles, backend):
    pb, rb = bundles
    pcfg, rcfg = _configs(**IRLS)
    res = PG.glm_regression(
        pb.store, pb.vorder, CONT, CAT, LABEL, pcfg, backend=backend
    )
    assert res.converged
    assert res.names[0] == "intercept"
    assert len(res.names) == res.theta.shape[0]
    res_mat = PG.glm_regression(
        pb.store, None, CONT, CAT, LABEL, pcfg, factorized=False
    )
    np.testing.assert_allclose(res.theta, res_mat.theta, rtol=1e-8, atol=1e-8)
    ref = RG.glm_regression(rb.store, rb.vorder, CONT, CAT, LABEL, rcfg)
    assert res.names == ref.names
    np.testing.assert_allclose(res.theta, ref.theta, **F64)
    with pytest.raises(ValueError, match="variable order"):
        PG.glm_regression(pb.store, None, CONT, CAT, LABEL, pcfg)


def test_predictions_in_range(designs):
    pd, rd = designs
    pcfg, rcfg = _configs(**IRLS)
    res = PG.fit_glm(pd, pcfg)
    mu = _predict(res, pd)
    assert np.all((mu > 0) & (mu < 1))
    # the fit separates promoted rows better than the base rate
    base = pd.ysum.sum() / pd.total_rows
    pred_rate = (pd.counts @ mu) / pd.total_rows
    np.testing.assert_allclose(pred_rate, base, atol=0.05)
    ref = RG.fit_glm(rd, rcfg)
    want = RG.glm_predict_raw(ref.theta, rd.cont, rd.cat_ids, rd, "logistic")
    np.testing.assert_allclose(mu, want, **F64)
    np.testing.assert_allclose(
        PG.glm_predict_raw(res.theta, pd.cont, pd.cat_ids, pd, "poisson"),
        RG.glm_predict_raw(ref.theta, rd.cont, rd.cat_ids, rd, "poisson"),
        **F64,
    )


def test_unknown_family_and_solver_rejected(designs):
    pd, _ = designs
    with pytest.raises(ValueError, match="family"):
        PG.fit_glm(pd, PG.GLMConfig(family="probit"))
    with pytest.raises(ValueError, match="family"):
        PG.fit_glm(pd, PG.GLMConfig(family="probit", solver="gd", device="cpu"))
    with pytest.raises(ValueError, match="solver"):
        PG.fit_glm(pd, PG.GLMConfig(solver="adam"))
    with pytest.raises(ValueError, match="family"):
        PG.glm_predict_raw(np.zeros(pd.num_params), pd.cont, pd.cat_ids, pd,
                           "probit")


def test_continuous_only_glm(bundles):
    """No categorical features: compression still works (groups by the
    continuous tuple) and matches the dense fit and the reference."""
    pb, rb = bundles
    design = PG.compressed_design_factorized(
        pb.store, pb.vorder, CONT, [], LABEL
    )
    assert design.cat_ids.shape[1] == 0
    _assert_design_equal(
        design,
        RG.compressed_design_factorized(rb.store, rb.vorder, CONT, [], LABEL),
    )
    joined = pb.store.materialize_join()
    x = np.stack([joined.column(f).astype(float) for f in CONT], axis=1)
    y = joined.column(LABEL).astype(np.float64)
    pcfg, _ = _configs(**IRLS)
    a = PG.fit_glm(design, pcfg)
    b = PG.fit_glm_onehot(x, y, pcfg)
    np.testing.assert_allclose(a.theta, b.theta, rtol=1e-6, atol=1e-6)
    gd = PG.fit_glm(design, dataclasses.replace(pcfg, solver="gd",
                                                 gd_max_iter=20_000))
    np.testing.assert_allclose(_predict(gd, design), _predict(a, design),
                               atol=GD_PRED_ATOL)


def _pairs_design():
    rng = np.random.default_rng(0)
    G, k = 8192, 3
    cont = rng.normal(0, 1.0, (G, k))
    counts = rng.integers(5, 60, G).astype(np.float64)
    eta = 0.8 + 0.5 * cont[:, 0] - 0.3 * cont[:, 1] + 0.1 * cont[:, 2]
    ysum = rng.binomial(
        counts.astype(int), 1.0 / (1.0 + np.exp(-eta))
    ).astype(np.float64)
    return PG.CompressedDesign(
        cont=cont,
        cat_ids=np.zeros((G, 0), dtype=np.int64),
        counts=counts,
        ysum=ysum,
        cont_names=["a", "b", "c"],
        cat_names=[],
        domains={},
        label="y",
    )


def test_gd_pairs_accumulation_beats_fp32_at_fixed_budget():
    """Mixed-precision GD: two-float (hi, lo) accumulation of the NLL and
    gradient reductions resolves descent far below the fp32 NLL floor, so
    at an identical iteration budget the "pairs" path lands much closer to
    the IRLS optimum than plain fp32."""
    design = _pairs_design()

    def final_nll(res):
        _, _, nll = PG._family_stats(
            "logistic", design.linpred(res.theta), design.counts, design.ysum
        )
        return nll + PG._penalty(res.config, res.theta)

    budget = dict(
        family="logistic", ridge=1e-3, solver="gd",
        gd_max_iter=1500, gd_eps=0.0, device="cpu",
    )
    irls = final_nll(PG.fit_glm(design, PG.GLMConfig(family="logistic",
                                                     ridge=1e-3)))
    f32 = final_nll(PG.fit_glm(design, PG.GLMConfig(**budget)))
    prs = final_nll(PG.fit_glm(design, PG.GLMConfig(**budget, gd_accum="pairs")))
    # fp32 stalls at its NLL floor; pairs closes >90% of the remaining gap
    assert prs < f32
    assert (prs - irls) < 0.1 * (f32 - irls)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 1000, 1023, 1024, 1025, 8191])
def test_pairwise_sum2_equals_reference_bitwise(n):
    """The port pads once to a power of two; the reference pads each odd
    level with a zero: the same pairs, so the same bits."""
    v = np.random.default_rng(n).normal(0, 1e3, (n, 3)).astype(np.float32)
    v[::7] *= 1e-6  # terms of mixed magnitudes: lo carries real bits
    rh, rl = RG._pairwise_sum2(jnp.asarray(v))
    ph, pl = PG._pairwise_sum2(torch.from_numpy(v))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    s, e = PG._two_sum(torch.tensor(1e8, dtype=torch.float32),
                       torch.tensor(1.5, dtype=torch.float32))
    assert float(s) + float(e) == 1e8 + 1.5


def test_gd_accum_rejected(designs):
    pd, _ = designs
    with pytest.raises(ValueError, match="gd_accum"):
        PG.fit_glm(pd, PG.GLMConfig(solver="gd", gd_accum="fp16", device="cpu"))


@pytest.mark.parametrize("family", ["logistic", "poisson"])
@pytest.mark.parametrize("accum", ["fp32", "pairs"])
def test_gd_objective_matches_reference_float64(designs, accum, family):
    """GD's float32 objective at one θ in its scaled coordinates: the
    gradient (the categorical part an ``index_add_``) equals the
    reference's float64 host gradient entry by entry within GD_GRAD_RTOL of
    the magnitudes the entry sums, and the NLL pair its float64 NLL."""
    pd, rd = designs
    pcfg, _ = _configs(family=family, ridge=1e-3, solver="gd", gd_accum=accum)
    nll_grad, avg, mx = PG._gd_objective(pd, pcfg)
    ts = np.random.default_rng(7).normal(0, 0.3, pd.num_params).astype(np.float32)
    hi, lo, g = nll_grad(torch.from_numpy(ts))
    ts = ts.astype(np.float64)
    scaled = dataclasses.replace(rd, cont=(rd.cont - avg) / mx)
    oid = rd.offset_ids()
    grad_eta, _, nll = RG._family_stats(family, scaled.linpred(ts), rd.counts, rd.ysum)
    want = RG._grad_theta(scaled, grad_eta, oid)
    mag = RG._grad_theta(dataclasses.replace(scaled, cont=np.abs(scaled.cont)),
                         np.abs(grad_eta), oid)
    want[1:] += 1e-3 * ts[1:]
    mag[1:] += 1e-3 * np.abs(ts[1:])
    err = np.abs(g.double().numpy() - want)
    assert np.all(err <= GD_GRAD_RTOL * mag), float(np.max(err / mag))
    nll += 0.5 * 1e-3 * float(ts[1:] @ ts[1:])
    assert float(hi) + float(lo) == pytest.approx(nll, rel=GD_GRAD_RTOL)


def test_gd_and_torch_compression_need_a_gpu_by_default(bundles, designs):
    """The new entry points run on ``cuda`` unless told otherwise; without
    a GPU they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    pb, _ = bundles
    pd, _ = designs
    with pytest.raises(RuntimeError, match="device='cpu'|device='cuda'"):
        PG.fit_glm(pd, PG.GLMConfig(solver="gd"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PG.compressed_design_factorized(
            pb.store, pb.vorder, CONT, CAT, LABEL, backend="torch"
        )
    # IRLS and the numpy compression are host paths: no device needed
    assert PG.fit_glm(pd, PG.GLMConfig(**IRLS)).converged


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_fd_reduced_glm_equals_full(backend):
    """``test_fd.py``'s identity in the port: the FD-reduced logistic fit
    equals the full one (θ at 1e-10, penalized NLL at 1e-8), and both equal
    the reference's."""
    pb, rb = PS.fd_star_schema(**STAR), RS.fd_star_schema(**STAR)
    assert pb.store.infer_fds() == rb.store.infer_fds()
    pcfg, rcfg = _configs(family="logistic", ridge=1e-3, tol=1e-14)
    out = {}
    for fds in (False, True):
        out[fds] = PG.glm_regression(
            pb.store, pb.vorder, ["x"], CAT2, "promo", pcfg,
            backend=backend, use_fds=fds,
        )
        ref = RG.glm_regression(
            rb.store, rb.vorder, ["x"], CAT2, "promo", rcfg,
            backend="numpy", use_fds=fds,
        )
        assert out[fds].names == ref.names
        np.testing.assert_allclose(out[fds].theta, ref.theta, rtol=0,
                                   atol=1e-10)
    full, red = out[False], out[True]
    assert full.names == red.names
    assert len(red.theta) == len(full.theta)
    np.testing.assert_allclose(red.theta, full.theta, rtol=0, atol=1e-10)
    assert abs(red.nll - full.nll) < 1e-8


@pytest.mark.parametrize(
    "params",
    [
        dict(seed=0, n_cat=1, domain=3, dep_domain=2, n_rows=10),
        dict(seed=17, n_cat=2, domain=5, dep_domain=3, n_rows=33),
        dict(seed=4242, n_cat=2, domain=8, dep_domain=4, n_rows=60),
        dict(seed=9999, n_cat=1, domain=8, dep_domain=2, n_rows=47),
    ],
)
def test_fd_property_glm_reduced_equals_full(params):
    """The GLM half of ``test_property.py``'s FD property, at fixed draws
    of its strategy: on a random join with planted FDs (and whatever
    accidental FDs the tiny data satisfies), the reduced logistic IRLS fit
    equals the full one at 1e-10 with the same layout, as the reference's
    does."""
    pb, rb = PS.fd_star_schema(**params), RS.fd_star_schema(**params)
    n_cat = params["n_cat"]
    cat = [f"c{i}" for i in range(n_cat)] + [f"d{i}" for i in range(n_cat)]
    inferred = pb.store.infer_fds()
    assert inferred == rb.store.infer_fds()
    assert {(f"c{i}", f"d{i}") for i in range(n_cat)} <= set(inferred)
    assert not pb.store.fd_reduction(cat).is_trivial
    pcfg, rcfg = _configs(family="logistic", ridge=1e-3, tol=1e-14)
    gf, gr = (
        PG.glm_regression(pb.store, pb.vorder, ["x"], cat, "promo", pcfg,
                          backend="numpy", use_fds=fds)
        for fds in (False, True)
    )
    assert gf.names == gr.names
    np.testing.assert_allclose(gr.theta, gf.theta, rtol=0, atol=1e-10)
    ref = RG.glm_regression(rb.store, rb.vorder, ["x"], cat, "promo", rcfg,
                            backend="numpy", use_fds=True)
    assert gr.names == ref.names
    np.testing.assert_allclose(gr.theta, ref.theta, rtol=0, atol=1e-10)
