"""PyTorch port, logical-axis sharding (``sharding.py``, ``launch/policy.py``,
``launch/mesh.py``, ``compat.py``), held against the JAX package.

The first part resolves every leaf of every config at full size against
the reference, exactly: parameters (the port's ``abstract_params`` tree of
``meta`` tensors against ``jax.eval_shape`` of the reference's), AdamW and
adafactor states, decode caches and ``input_specs`` batches, under every
preset of both kinds (``baseline`` is TRAIN_RULES / SERVE_RULES) on the
production meshes ``(16, 16)`` and ``(2, 16, 16)``.  Resolution reads only
axis names and sizes, so a stand-in mesh serves both packages (the
reference's own tests use the same ``FakeMesh``).  The second part twins
``tests/test_sharding.py`` on the port, and the last runs DTensor
placements and ``constrain`` on a gloo group of one rank.
"""

import dataclasses
import functools

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro import sharding as jshd
from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.configs import input_specs as jax_input_specs
from repro.launch import policy as jpolicy
from repro.models import model as JM
from repro.train import TrainHParams as JHParams
from repro.train import init_state as jax_init_state
from repro_torch import compat
from repro_torch import sharding as shd
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import policy
from repro_torch.models import model as PM
from repro_torch.train import TrainHParams
from repro_torch.train._tree import tree_paths
from repro_torch.train.train_step import abstract_state

P = shd.PartitionSpec


class FakeMesh:
    """Only .shape (axis name -> size) is consulted by ShardingPolicy.spec."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESHES = {
    "single_pod": dict(data=16, model=16),
    "multi_pod": dict(pod=2, data=16, model=16),
}
KINDS = [(kind, preset) for kind in ("train", "serve") for preset in policy.PRESETS]
OPTIMIZERS = ("adamw", "adafactor")


def _policies(mesh_name):
    """(port policy, reference policy) for every kind and preset."""
    axes = MESHES[mesh_name]
    return [(policy.make_policy(FakeMesh(**axes), kind, preset),
             jpolicy.make_policy(FakeMesh(**axes), kind, preset)) for kind, preset in KINDS]


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): (p, tuple(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_specs(tree, jtree, table, jtable, mesh_name):
    """Every leaf of the port's ``tree`` resolves as the same leaf of the
    reference's ``jtree`` does, under every policy; returns the leaf count."""
    jleaves = _jax_leaves(jtree)
    leaves = {path: tuple(x.shape) for path, x in tree_paths(tree)}
    assert leaves == {k: shape for k, (_, shape) in jleaves.items()}
    for pol, jpol in _policies(mesh_name):
        specs = dict(tree_paths(shd.tree_logical_specs(tree, pol, table)))
        for key, (jpath, shape) in jleaves.items():
            want = jpol.spec(jshd._leaf_logical(jpath, len(shape), jtable), shape)
            assert tuple(specs[key].spec) == tuple(want), (key, shape, pol.rules._rules)
    return len(leaves)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jax_config(arch)
    return jax.eval_shape(lambda: JM.init_params(jax.random.key(0), cfg))


@functools.lru_cache(maxsize=None)
def _jax_state(arch, optimizer):
    cfg = dataclasses.replace(jax_config(arch), optimizer=optimizer)
    return jax.eval_shape(lambda: jax_init_state(jax.random.key(0), cfg, JHParams()))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_reference(arch, mesh_name):
    cfg = get_config(arch)
    tree = PM.param_tree(PM.abstract_params(cfg), cfg)
    assert _same_specs(tree, _jax_params(arch), shd.PARAM_AXES, jshd.PARAM_AXES,
                       mesh_name) > 0


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_state_specs_equal_reference(arch, optimizer, mesh_name):
    """AdamW's mu / nu and adafactor's factored vr / vc and unfactored v
    follow their parameters, as the reference's do."""
    cfg = dataclasses.replace(get_config(arch), optimizer=optimizer)
    state = abstract_state(cfg, TrainHParams())
    assert _same_specs(state, _jax_state(arch, optimizer), shd.PARAM_AXES,
                       jshd.PARAM_AXES, mesh_name) > 0


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_and_batch_specs_equal_reference(arch, mesh_name):
    """Decode caches at every decode shape the config runs, and the
    ``input_specs`` batch of every shape."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    for shape in cfg.runnable_shapes():
        if shape.kind == "decode":
            cache = PM.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
            jcache = jax.eval_shape(
                lambda: JM.init_cache(jcfg, shape.global_batch, shape.seq_len))
            _same_specs(cache, jcache, shd.CACHE_AXES, jshd.CACHE_AXES, mesh_name)
        jbatch = jax_input_specs(jcfg, shape)
        _same_specs(input_specs(cfg, SHAPES[shape.name]), jbatch, shd.BATCH_AXES,
                    jshd.BATCH_AXES, mesh_name)


# -- twins of tests/test_sharding.py -------------------------------------------

POL = shd.ShardingPolicy(FakeMesh(data=16, model=16), shd.TRAIN_RULES)
POL_POD = shd.ShardingPolicy(FakeMesh(pod=2, data=16, model=16), shd.TRAIN_RULES)
POL_SERVE = shd.ShardingPolicy(FakeMesh(data=16, model=16), shd.SERVE_RULES)


def test_batch_spans_pod_and_data_on_multipod():
    assert POL_POD.spec(("batch", "seq"), (256, 4096)) == P(("pod", "data"))
    assert POL.spec(("batch", "seq"), (256, 4096)) == P("data")


def test_divisibility_fallback_replicates():
    assert POL.spec(("fsdp", "heads", "head_dim"), (576, 9, 64)) == P("data")
    assert POL.spec(("fsdp", "heads", "head_dim"), (8192, 64, 128)) == P("data", "model")


def test_duplicate_mesh_axis_dedup():
    assert POL.spec(("expert", "fsdp", "ffn"), (16, 8192, 24576)) == P("model", "data")
    assert POL.spec(("expert", "fsdp", "ffn"), (60, 2048, 1408)) == P(None, "data", "model")


def test_serve_rules_differ_from_train():
    assert POL_SERVE.spec(("fsdp", "ffn"), (4096, 14336)) == P(None, "model")
    assert POL_SERVE.spec(
        ("batch", "kv_seq", "kv_heads", "head_dim"), (128, 32768, 8, 128)
    ) == P("data", "model")


def test_rule_override():
    rules = shd.AxisRules(shd.SERVE_RULES).override(kv_seq=("data", "model"))
    pol = shd.ShardingPolicy(FakeMesh(data=16, model=16), rules)
    assert pol.spec(("batch", "kv_seq"), (1, 524288)) == P(None, ("data", "model"))


def _one_policy(rules=shd.TRAIN_RULES):
    return shd.ShardingPolicy(FakeMesh(data=1, model=1), rules)


def test_leaf_logical_param_paths():
    cfg = get_config("mixtral-8x7b", smoke=True)
    tree = PM.param_tree(PM.abstract_params(cfg), cfg)
    flat = dict(tree_paths(shd.param_specs(tree, _one_policy())))
    wq = [v for k, v in flat.items() if "wq" in k][0]
    assert wq.spec[0] is None  # periods axis replicated
    assert flat["['embed']"].spec == P("model", "data")  # vocab x fsdp


def test_optimizer_state_specs_follow_params():
    cfg = get_config("deepseek-67b", smoke=True)  # adafactor
    flat = dict(tree_paths(shd.state_specs(abstract_state(cfg), _one_policy())))
    assert [k for k in flat if "w_gate" in k and "vr" in k]
    assert [k for k in flat if "w_gate" in k and "vc" in k]


def test_constrain_noop_without_policy():
    x = torch.zeros((4, 4))
    assert shd.active_policy() is None
    assert shd.constrain(x, ("batch", "seq")) is x
    assert shd.logical_spec(("batch", "seq"), (4, 4)) == P()


def test_tree_specs_unknown_leaves_replicate():
    tree = {"mystery": torch.empty((3, 5), device="meta")}
    specs = shd.tree_logical_specs(tree, _one_policy(), shd.PARAM_AXES)
    assert specs["mystery"].spec == P()


# -- placements, the mesh and constrain on a real DeviceMesh ------------------------

def test_specs_become_placements_major_axis_first():
    """A dim split over ``("pod", "data")`` is ``Shard(d)`` on both mesh
    dims; unnamed axes replicate."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh(pod=2, data=16, model=16)
    got = shd.NamedSharding(mesh, POL_POD.spec(("batch", "seq", "vocab"), (256, 4096, 32000)))
    assert got.placements == (Shard(0), Shard(0), Shard(2))
    assert shd.NamedSharding(mesh, P()).placements == (Replicate(),) * 3
    with pytest.raises(NotImplementedError, match="order"):
        shd.NamedSharding(mesh, P(("data", "pod"))).placements


def test_hw_holds_the_h100_constants():
    assert (pmesh.HW.peak_flops_bf16, pmesh.HW.peak_flops_fp32, pmesh.HW.hbm_bw) == (
        989e12, 67e12, 3.35e12)
    assert pmesh.production_shape() == ((16, 16), ("data", "model"))
    assert pmesh.production_shape(True) == ((2, 16, 16), ("pod", "data", "model"))


@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """A gloo group of one rank (destroyed after the module)."""
    path = str(tmp_path_factory.mktemp("dist") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(path, 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_meshes_need_the_world_they_name(group1):
    mesh = pmesh.make_host_mesh(1, 1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="256 ranks"):
        pmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        pmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="2 ranks"):
        pmesh.make_host_mesh(2, 1, device="cpu")


def test_constrain_applies_on_real_mesh(group1):
    """Under a policy on a DeviceMesh, ``constrain`` redistributes a DTensor
    to the resolved placements and leaves a plain tensor (a local shard)
    alone; the values do not change."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    pol = policy.make_policy(mesh, "train")
    x = distribute_tensor(torch.arange(16.0).reshape(4, 4), mesh, [Replicate(), Replicate()])
    with shd.use_policy(pol):
        y = shd.constrain(x, ("batch", "vocab"))
        plain = torch.ones(4, 4)
        assert shd.constrain(plain, ("batch", "seq")) is plain
    assert shd.active_policy() is None
    assert tuple(y.placements) == (Shard(0), Shard(1)) and y.shape == (4, 4)
    assert torch.equal(y.full_tensor(), x.full_tensor())
    placed = shd.distribute_tree({"tokens": torch.ones(2, 3), "n": 3},
                                 shd.batch_specs({"tokens": torch.ones(2, 3), "n": 3}, pol))
    assert tuple(placed["tokens"].placements) == (Shard(0), Replicate()) and placed["n"] == 3


def test_compat_local_map_runs_on_local_shards(group1):
    from torch.distributed.tensor import Shard, distribute_tensor

    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    x = distribute_tensor(torch.arange(6.0).reshape(2, 3), mesh, [Shard(0)])
    double = compat.local_map(lambda t: t * 2, out_placements=[Shard(0)],
                              in_placements=([Shard(0)],), device_mesh=mesh)
    assert torch.equal(double(x).full_tensor(), torch.arange(6.0).reshape(2, 3) * 2)
