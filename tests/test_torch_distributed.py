"""PyTorch port, distribution (``core/distributed.py``): union
commutativity as data parallelism over a ``torch.distributed`` mesh, held
against the JAX package.

* World size 1, in this process: a gloo group of one rank through a
  ``FileStore`` and a ``("data",)`` ``DeviceMesh`` of 1, against the
  reference at ``jax.make_mesh((1,), ("data",))``, and the reference's own
  callers of ``distributed.py`` twinned (``test_categorical.py``,
  ``test_cofactor.py``, ``test_fd.py``, ``test_incremental.py``,
  ``test_view_cache.py``).
* World sizes 2 and 4, one ``torch.multiprocessing.spawn`` a world size for
  the whole module (``torch_dist_worker``): ``(2,)`` and ``(4,)`` meshes, a
  ``(2, 2)`` ``("pod", "data")`` mesh sharded over both dims and over
  ``data`` alone, on 103 rows (so the last shard is padded), against the
  reference's float64 host oracles (``partitioned_cofactors_host``,
  ``cat_cofactors_from_arrays``); every rank must hold the same result.

Tolerances: float64 host paths 1e-12; the mesh paths sum in float32 (the
kernels' plain versions on the CPU), so rtol 1e-5 / atol 1e-4 of entries up
to ~1e3 where the reference's own tests allow 1e-4 / 1e-2; counts are
integers below 2^24, so exact.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro.core.categorical as RC
import repro.core.distributed as RD
import repro_torch.core as P
import repro_torch.core.distributed as D
import repro_torch.data.synthetic as PS
import torch_dist_worker as W
from repro.core import cofactors_streaming as r_streaming
from repro.core import design_matrix as r_design_matrix
from repro.core.fd import expand_cat_cofactors as r_expand
from repro.core.store import Store as RStore
from repro.data import synthetic as RS

F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-4)
CONT = ["transactions", "unit_sales"]
CAT = ["store_nbr", "item_nbr"]
FAV = dict(n_dates=8, n_stores=4, n_items=6, seed=3)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A gloo group of one rank and its ``("data",)`` mesh; destroyed after
    the module."""
    path = str(tmp_path_factory.mktemp("dist") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(path, 1), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1,), ("data",))


@pytest.fixture(scope="module")
def arrays():
    """(x, ids, domains) of the same favorita_like join, once per package."""
    out = []
    for syn in (PS, RS):
        b = syn.favorita_like(**FAV)
        joined = b.store.materialize_join()
        x = np.stack([joined.column(f).astype(float) for f in CONT], axis=1)
        ids = np.stack([joined.column(c).astype(np.int64) for c in CAT], axis=1)
        out.append((x, ids, {c: b.store.attr_domain(c) for c in CAT}))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    return out[0]


def _same_cofactors(got, want, tol):
    assert got.features == want.features
    assert got.count == want.count
    np.testing.assert_allclose(got.lin, want.lin, **tol)
    np.testing.assert_allclose(got.quad, want.quad, **tol)


def _same_cat(got, want, tol):
    assert list(got.cont) == list(want.cont) and list(got.cat) == list(want.cat)
    assert got.domains == want.domains
    assert got.count == want.count
    np.testing.assert_allclose(got.matrix(), want.matrix(), **tol)
    for key, coo in want.cat_cat.items():
        np.testing.assert_array_equal(got.cat_cat[key].rows, coo.rows)
        np.testing.assert_array_equal(got.cat_cat[key].cols, coo.cols)


# ---------------------------------------------------------------------------
# The reference's callers of distributed.py, twinned (world size 1)
# ---------------------------------------------------------------------------

def test_sharded_cat_cofactors_match_host(arrays, mesh, jmesh):
    """Twin of test_categorical.py::test_sharded_cat_cofactors_match_host."""
    x, ids, doms = arrays
    sh = D.sharded_cat_cofactors(x, ids, CONT, CAT, doms, mesh)
    host = P.cat_cofactors_from_arrays(x, ids, CONT, CAT, doms)
    np.testing.assert_allclose(sh.matrix(), host.matrix(), rtol=1e-4, atol=1e-2)
    _same_cat(sh, RD.sharded_cat_cofactors(x, ids, CONT, CAT, doms, jmesh), F32)
    half = x.shape[0] // 2
    base = P.cat_cofactors_from_arrays(x[:half], ids[:half], CONT, CAT, doms)
    inc = D.incremental_sharded_cat_cofactors(base, x[half:], ids[half:])
    np.testing.assert_allclose(inc.matrix(), host.matrix(), rtol=1e-9)
    rbase = RC.cat_cofactors_from_arrays(x[:half], ids[:half], CONT, CAT, doms)
    _same_cat(inc, RD.incremental_sharded_cat_cofactors(rbase, x[half:], ids[half:]), F64)
    same = D.incremental_sharded_cat_cofactors(
        inc, np.zeros((0, 2)), np.zeros((0, 2), dtype=np.int64)
    )
    assert same is inc


def test_incremental_fold_grows_domains(arrays, mesh):
    """Twin of test_categorical.py::test_incremental_fold_grows_domains:
    unseen ids grow the blocks; too-small domains and negative ids (the
    padding sentinel) fail loudly with the reference's message."""
    x, ids, doms = arrays
    base = P.cat_cofactors_from_arrays(x, ids, CONT, CAT, doms)
    x_new = np.array([[100.0, 9.0], [200.0, 8.0]])
    ids_new = np.array([[doms[CAT[0]] + 1, 0], [0, doms[CAT[1]]]], dtype=np.int64)
    grown = D.incremental_sharded_cat_cofactors(base, x_new, ids_new)
    big = {CAT[0]: doms[CAT[0]] + 2, CAT[1]: doms[CAT[1]] + 1}
    whole = P.cat_cofactors_from_arrays(
        np.concatenate([x, x_new]), np.concatenate([ids, ids_new]), CONT, CAT, big
    )
    assert grown.domains == big
    np.testing.assert_allclose(grown.matrix(), whole.matrix(), **F64)
    rbase = RC.cat_cofactors_from_arrays(x, ids, CONT, CAT, doms)
    _same_cat(grown, RD.incremental_sharded_cat_cofactors(rbase, x_new, ids_new), F64)
    # the mesh path grows the domains alike
    grown_mesh = D.incremental_sharded_cat_cofactors(base, x_new, ids_new, mesh=mesh)
    assert grown_mesh.domains == big
    np.testing.assert_allclose(grown_mesh.matrix(), whole.matrix(), rtol=1e-4, atol=1e-2)
    with pytest.raises(ValueError, match="outside domain"):
        P.cat_cofactors_from_arrays(x_new, ids_new, CONT, CAT, doms)
    with pytest.raises(ValueError, match="outside domain"):
        D.sharded_cat_cofactors(x_new, ids_new, CONT, CAT, doms, mesh)
    ids_neg = np.array([[-1, 0]], dtype=np.int64)
    with pytest.raises(ValueError, match="outside domain") as port:
        D.sharded_cat_cofactors(x_new[:1], ids_neg, CONT, CAT, doms, mesh)
    with pytest.raises(ValueError, match="outside domain") as ref:
        RD.sharded_cat_cofactors(x_new[:1], ids_neg, CONT, CAT, doms,
                                 jax.make_mesh((1,), ("data",)))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("parts", [1, 3, 7])
def test_commutativity_with_union(parts):
    """Twin of test_cofactor.py::test_commutativity_with_union: the host
    oracle over a disjoint partition equals the whole and the reference's."""
    p, r = PS.favorita_like(**FAV), RS.favorita_like(**FAV)
    cols = p.features + [p.label]
    z = P.design_matrix(p.store.materialize_join(), cols)
    np.testing.assert_array_equal(z, r_design_matrix(r.store.materialize_join(), cols))
    whole = D.partitioned_cofactors_host(z, cols, 1)
    split = D.partitioned_cofactors_host(z, cols, parts)
    np.testing.assert_allclose(whole.quad, split.quad, rtol=1e-12)
    np.testing.assert_allclose(whole.lin, split.lin, rtol=1e-12)
    assert whole.count == split.count
    _same_cofactors(split, RD.partitioned_cofactors_host(z, cols, parts), F64)


def test_sharded_cat_cofactors_fd_reduction(mesh, jmesh):
    """Twin of test_fd.py::test_sharded_cat_cofactors_fd_reduction on the
    same FD star schema (FDs inferred from the data)."""
    cat2 = ["c0", "c1", "d0", "d1"]
    out = []
    for syn, sharded, m in ((PS, D.sharded_cat_cofactors, mesh),
                            (RS, RD.sharded_cat_cofactors, jmesh)):
        store = syn.fd_star_schema(n_cat=2, domain=12, dep_domain=4, n_rows=400,
                                   seed=5).store
        store.infer_fds()
        joined = store.materialize_join()
        x = np.stack([joined.column(f).astype(np.float64) for f in ["x", "y"]], axis=1)
        ids = np.stack([joined.column(c).astype(np.int64) for c in cat2], axis=1)
        doms = {c: store.attr_domain(c) for c in cat2}
        red = store.fd_reduction(cat2)
        reduced = sharded(x, ids, ["x", "y"], cat2, doms, m, fd=red)
        assert list(reduced.cat) == red.kept
        full = sharded(x, ids, ["x", "y"], cat2, doms, m)
        out.append((reduced, full, red))
    (p_red, p_full, p_fd), (r_red, r_full, r_fd) = out
    assert p_fd.kept == r_fd.kept and sorted(p_fd.dropped) == sorted(r_fd.dropped)
    assert p_fd.dropped  # the schema's FDs make the reduction non-trivial
    expanded = P.expand_cat_cofactors(p_red, p_fd)
    np.testing.assert_allclose(expanded.matrix(), p_full.matrix(), rtol=5e-4, atol=1e-2)
    _same_cat(p_red, r_red, F32)
    _same_cat(p_full, r_full, F32)
    np.testing.assert_allclose(
        expanded.matrix(), r_expand(r_red, r_fd).matrix(), rtol=1e-5, atol=1e-4
    )


def test_incremental_sharded_cofactors_host_path():
    """Twin of test_incremental.py::test_incremental_sharded_cofactors_host_path."""
    rng = np.random.default_rng(0)
    z = rng.normal(size=(40, 3))
    delta = rng.normal(size=(9, 3))
    base = P.cofactors_streaming(z, ["a", "b", "c"], chunk_rows=40, use_kernel=False,
                                 device="cpu")
    out = D.incremental_sharded_cofactors(base, delta)
    full = np.concatenate([z, delta], 0)
    np.testing.assert_allclose(out.quad, full.T @ full, rtol=1e-6, atol=1e-4)
    # both bases are float32 products (the reference's plain jnp one too)
    rbase = r_streaming(z, ["a", "b", "c"], chunk_rows=40, use_kernel=False)
    _same_cofactors(out, RD.incremental_sharded_cofactors(rbase, delta), F32)
    same = D.incremental_sharded_cofactors(out, np.zeros((0, 3)))
    assert same is out


def _delta_for(rel, rng, n_rows: int):
    """test_view_cache.py's delta: random rows with ``rel``'s attributes."""
    keys = {a: rng.integers(0, int(rel.domains[a]), n_rows).astype(np.int32)
            for a in rel.keys}
    values = {a: rng.normal(0, 2.0, n_rows) for a in rel.values}
    return keys, values


def test_sharded_fold_agrees_with_store_maintenance(mesh, jmesh):
    """Twin of test_view_cache.py::test_sharded_fold_agrees_with_store_maintenance:
    a delta folded through ``incremental_sharded_cat_cofactors`` (host fp64
    and the mesh) lands on the store's maintained entry, in both packages."""
    from repro.core.relation import Relation as RRelation
    from repro_torch.core.store import Store

    cont, cat = ["x", "y"], ["c0", "c1"]
    folded = []
    for syn, store_cls, rel_cls, fold, m in (
        (PS, Store, P.Relation, D.incremental_sharded_cat_cofactors, mesh),
        (RS, RStore, RRelation, RD.incremental_sharded_cat_cofactors, jmesh),
    ):
        b = syn.many_cat_schema(n_cat=2, domain=6, n_rows=250, seed=10)
        off_store = store_cls(b.store.relations(), view_cache_bytes=0)
        base_on = b.store.cat_cofactors(b.vorder, cont, cat)
        base_off = off_store.cat_cofactors(b.vorder, cont, cat)
        np.testing.assert_allclose(base_on.matrix(), base_off.matrix(), rtol=0, atol=0)
        keys, values = _delta_for(b.store.get("Fact"), np.random.default_rng(3), 30)
        delta = rel_cls.from_columns("delta", keys, values)
        x_delta = np.stack([values["x"], values["y"]], axis=1).astype(np.float64)
        ids_delta = np.stack([keys["c0"], keys["c1"]], axis=1).astype(np.int64)
        folded_host = fold(base_on, x_delta, ids_delta)
        folded_mesh = fold(base_on, x_delta, ids_delta, mesh=m)
        b.store.append("Fact", delta)
        off_store.append("Fact", delta)
        maintained_on = b.store.cat_cofactors(b.vorder, cont, cat)
        maintained_off = off_store.cat_cofactors(b.vorder, cont, cat)
        np.testing.assert_allclose(maintained_on.matrix(), maintained_off.matrix(),
                                   rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(folded_host.matrix(), maintained_on.matrix(),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(folded_mesh.matrix(), maintained_on.matrix(),
                                   rtol=1e-4, atol=1e-2)
        folded.append((folded_host, folded_mesh))
    _same_cat(folded[0][0], folded[1][0], F64)
    _same_cat(folded[0][1], folded[1][1], F32)


# ---------------------------------------------------------------------------
# Every function at world size 1 against the reference
# ---------------------------------------------------------------------------

def test_sharded_gram_matches_reference(mesh, jmesh):
    z = np.random.default_rng(1).normal(size=(57, 5)).astype(np.float32)
    got = D.sharded_gram(torch.from_numpy(z), mesh, ("data",))
    want = RD.sharded_gram(jax.numpy.asarray(z), jmesh, ("data",))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_sharded_cofactors_matches_reference(arrays, mesh, jmesh):
    x = arrays[0]
    got = D.sharded_cofactors(x, CONT, mesh)
    _same_cofactors(got, RD.sharded_cofactors(x, CONT, jmesh), F32)
    _same_cofactors(got, D.partitioned_cofactors_host(x, CONT, 1), F32)


def test_incremental_sharded_cofactors_mesh_matches_reference(arrays, mesh, jmesh):
    x = arrays[0]
    split = x.shape[0] // 3
    base = D.partitioned_cofactors_host(x[:split], CONT, 1)
    got = D.incremental_sharded_cofactors(base, x[split:], mesh)
    rbase = RD.partitioned_cofactors_host(x[:split], CONT, 1)
    _same_cofactors(got, RD.incremental_sharded_cofactors(rbase, x[split:], jmesh), F32)
    _same_cofactors(got, D.partitioned_cofactors_host(x, CONT, 1), F32)


def test_incremental_sharded_cat_cofactors_mesh_matches_reference(arrays, mesh, jmesh):
    x, ids, doms = arrays
    split = x.shape[0] // 3
    base = P.cat_cofactors_from_arrays(x[:split], ids[:split], CONT, CAT, doms)
    rbase = RC.cat_cofactors_from_arrays(x[:split], ids[:split], CONT, CAT, doms)
    got = D.incremental_sharded_cat_cofactors(base, x[split:], ids[split:], mesh)
    want = RD.incremental_sharded_cat_cofactors(rbase, x[split:], ids[split:], jmesh)
    _same_cat(got, want, F32)


def test_cuda_mesh_needs_nccl(mesh):
    """A CUDA tensor reduced over a gloo group raises rather than leave the
    card (checked on the group this process has)."""
    with pytest.raises(ValueError, match="NCCL"):
        D._groups(mesh, ("data",), torch.device("cuda", 0))


# ---------------------------------------------------------------------------
# World sizes 2 and 4 on gloo against the float64 host oracles
# ---------------------------------------------------------------------------

CASES = ["rows", "gram", "cofactors", "incremental", "cat", "cat_fd", "cat_incremental"]


@pytest.fixture(scope="module")
def spawned():
    """{world size: results by rank}: one spawn a world size for the module."""
    return {world: W.spawn(world, CASES) for world in (2, 4)}


def _ranks(spawned, case, mesh_name):
    world = W.MESHES[mesh_name][0]
    results = [r[(case, mesh_name)] for r in spawned[world]]
    return results


def _oracle(case):
    inp = W.case_inputs()
    x, ids, split = inp["x"], inp["ids"], inp["split"]
    if case in ("cofactors", "incremental"):
        return RD.partitioned_cofactors_host(x, W.CONT, 1)
    if case == "cat":
        return RC.cat_cofactors_from_arrays(x, ids, W.CONT, W.CAT, W.DOMAINS)
    if case == "cat_fd":
        kept = [0, 1]
        return RC.cat_cofactors_from_arrays(x, ids[:, kept], W.CONT, ["a", "b"],
                                            {c: W.DOMAINS[c] for c in "ab"})
    if case == "cat_incremental":
        grown = dict(W.DOMAINS, b=W.DOMAINS["b"] + 3)
        return RC.cat_cofactors_from_arrays(
            x, np.concatenate([ids[:split], inp["grown"]]), W.CONT, W.CAT, grown)
    raise ValueError(case)


MESH_NAMES = list(W.MESHES)


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
def test_row_blocks_follow_the_partition_spec(spawned, mesh_name):
    """Rank r holds the r-th contiguous block of the padded rows, shards
    numbered row-major over the data axes; ranks that differ only along
    other dims hold the same block."""
    world, shape, names, axes = W.MESHES[mesh_name]
    shards = int(np.prod([shape[names.index(a)] for a in axes]))
    per = -(-W.M_ROWS // shards)
    coords = np.array(np.unravel_index(np.arange(world), shape)).T
    for rank, got in enumerate(_ranks(spawned, "rows", mesh_name)):
        index = 0
        for a in axes:
            index = index * shape[names.index(a)] + coords[rank][names.index(a)]
        lo = min(index * per, W.M_ROWS)
        assert got == (lo, min(lo + per, W.M_ROWS), per)


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
def test_sharded_gram_sums_every_shard(spawned, mesh_name):
    x = W.case_inputs()["x"]
    u = np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)
    for got in _ranks(spawned, "gram", mesh_name):
        np.testing.assert_allclose(got, u.T @ u, **F32)


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", ["cofactors", "incremental"])
def test_sharded_cofactors_match_host_oracle(spawned, mesh_name, case):
    results = _ranks(spawned, case, mesh_name)
    for got in results:
        _same_cofactors(got, _oracle(case), F32)
        np.testing.assert_array_equal(got.quad, results[0].quad)


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", ["cat", "cat_fd", "cat_incremental"])
def test_sharded_cat_cofactors_match_host_oracle(spawned, mesh_name, case):
    results = _ranks(spawned, case, mesh_name)
    for got in results:
        _same_cat(got, _oracle(case), F32)
        np.testing.assert_array_equal(got.matrix(), results[0].matrix())
    if case == "cat_fd":
        full = _oracle("cat")
        expanded = P.expand_cat_cofactors(results[0], W.fd_reduction())
        np.testing.assert_allclose(expanded.matrix(), full.matrix(), **F32)
