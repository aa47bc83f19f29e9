"""PyTorch port, the sharded program on the production meshes: each cell
places what the reference's rules place (``src/repro/sharding.py``) and
does only its own shard's work.

The cells run in one subprocess (each brings up a fake process group of
256 or 512 ranks and destroys it; the group is process state, so it never
meets this process's), at full width and the fewest layers each config's
pattern allows: smollm-135m at 2 layers (``train_4k``, ``prefill_32k`` and
``decode_32k`` on ``pod16x16``, ``decode_32k`` on ``pod2x16x16``),
qwen2-moe-a2.7b at 1 (``train_4k``: 60 experts that the 16-way ``model``
axis does not divide, so they stay whole) and xlstm-1.3b at 8, one period
(``decode_32k``, and ``train_4k`` with its microbatch loop cut from 4 to 1:
the sLSTM recurrence's 4,096 steps on meta tensors take most of a minute a
pass).  Each record must be ``ok`` and its argument bytes the local shards
that the rules give.  On ``pod16x16`` a smollm device counts at most 1.1
times its data shard's share of the program (``flops_unsharded / 16``: 9
query heads leave ``model`` nothing to split in attention), and the train
step's estimate of a rank's peak is at most 24 GB (the loss on each rank's
own vocabulary block).  One MLP block alone on the fake ``pod16x16`` group
counts exactly ``1/(data·model)`` of its unsharded FLOPs and gathers its
weights along ``d`` alone, never along ``d_ff``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch import sharding as shd
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.models import model as PM
from repro_torch.train._tree import tree_paths
from repro_torch.train.train_step import abstract_state

# name -> (arch, shape, multi-pod, config overrides, count the unsharded program)
CELLS = {
    "smollm-135m train_4k pod16x16": ("smollm-135m", "train_4k", False, {"n_layers": 2}, True),
    "smollm-135m prefill_32k pod16x16": ("smollm-135m", "prefill_32k", False,
                                         {"n_layers": 2}, True),
    "smollm-135m decode_32k pod16x16": ("smollm-135m", "decode_32k", False,
                                        {"n_layers": 2}, True),
    "smollm-135m decode_32k pod2x16x16": ("smollm-135m", "decode_32k", True,
                                          {"n_layers": 2}, False),
    "qwen2-moe-a2.7b train_4k pod16x16": ("qwen2-moe-a2.7b", "train_4k", False,
                                          {"n_layers": 1}, False),
    "xlstm-1.3b decode_32k pod16x16": ("xlstm-1.3b", "decode_32k", False, {"n_layers": 8},
                                       False),
    "xlstm-1.3b train_4k pod16x16": ("xlstm-1.3b", "train_4k", False,
                                     {"n_layers": 8, "microbatches": 1}, False),
}
SMOLLM_POD1 = [c for c in CELLS if c.startswith("smollm-135m") and c.endswith(" pod16x16")]
FLOPS_SLACK = 1.1
TRAIN_PEAK = 24e9
# one smollm-135m MLP block: [B, S, d] rows through d_ff
MLP = dict(b=64, s=4096, d=576, ff=1536)
REL = 1e-9

_SCRIPT = r"""
import json, sys
sys.path.insert(0, {src!r})
import torch
from repro_torch import compat, sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import MLP, mlp_apply
out = {{}}
for name, (arch, shape, multi_pod, cfg, cost) in {cells!r}.items():
    out[name] = dryrun.run_cell(arch, shape, multi_pod=multi_pod, verbose=False,
                                cfg_overrides=cfg, cost_pass=cost, flops_scope="per_shard")
m = {mlp!r}
with dryrun.fake_group(256):
    mesh = make_production_mesh(device="cpu")
    pol = shd.ShardingPolicy(mesh, shd.TRAIN_RULES)
    block = MLP(m["d"], m["ff"], "swiglu", torch.bfloat16, device="meta")
    placed = {{}}
    for name, p in block.named_parameters():
        spec = pol.sharding(shd._leaf_logical([name], p.dim(), shd.PARAM_AXES), p.shape)
        placed[name] = torch.distributed.tensor.distribute_tensor(
            p.detach(), mesh, spec.placements, src_data_rank=None)
        setattr(block, name, torch.nn.Parameter(placed[name], requires_grad=False))
    x = torch.empty((m["b"], m["s"], m["d"]), dtype=torch.bfloat16, device="meta")
    x = torch.distributed.tensor.distribute_tensor(
        x, mesh, pol.sharding(("batch", "seq", "embed"), x.shape).placements,
        src_data_rank=None)
    counter = dryrun.StepCounter([x] + list(placed.values()))
    with shd.use_policy(pol), compat.implicit_replication(), counter:
        y = shd.constrain(mlp_apply(block, x, "swiglu"), ("batch", "seq", "embed"))
    out["mlp"] = dict(flops=counter.flops, coll=dict(counter.by_kind),
                      out_local=list(y._local_tensor.shape))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    script = _SCRIPT.format(src=src, cells=CELLS, mlp=MLP)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=1200)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


class FakeMesh:
    """Only .shape (axis name -> size) is consulted by ShardingPolicy.spec."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESH_AXES = {False: dict(data=16, model=16), True: dict(pod=2, data=16, model=16)}


def _local_bytes(tree, specs_fn, policy) -> int:
    """Each leaf's bytes divided by the sizes of the mesh axes its spec
    splits it over."""
    sizes = shd.mesh_axes(policy.mesh)
    total = 0
    for (_, leaf), (_, sharding) in zip(tree_paths(tree), tree_paths(specs_fn(tree, policy))):
        split = 1
        for entry in sharding.spec:
            for axis in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
                split *= sizes[axis]
        assert leaf.numel() % split == 0
        total += leaf.numel() // split * leaf.element_size()
    return total


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_ok(records, cell):
    rec = records[cell]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == cell.rsplit(" ", 1)[1]
    assert rec["cost"]["flops"] > 0 and rec["memory"]["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_argument_bytes_are_the_local_shards(records, cell):
    arch, shape_name, multi_pod, overrides, _ = CELLS[cell]
    cfg, shape = dataclasses.replace(get_config(arch), **overrides), SHAPES[shape_name]
    if shape.kind == "train":
        policy = shd.ShardingPolicy(FakeMesh(**MESH_AXES[multi_pod]), shd.TRAIN_RULES)
        want = _local_bytes(abstract_state(cfg), shd.state_specs, policy) + \
            _local_bytes(input_specs(cfg, shape), shd.batch_specs, policy)
    else:
        policy = shd.ShardingPolicy(FakeMesh(**MESH_AXES[multi_pod]), shd.SERVE_RULES)
        params = PM.param_tree(PM.abstract_params(cfg), cfg)
        want = _local_bytes(params, shd.param_specs, policy)
        if shape.kind == "prefill":
            want += _local_bytes(input_specs(cfg, shape), shd.batch_specs, policy)
        else:
            cache = PM.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
            token = {"token": input_specs(cfg, shape)["token"]}
            want += _local_bytes(cache, shd.cache_specs, policy) + \
                _local_bytes(token, shd.batch_specs, policy)
    assert records[cell]["memory"]["argument_size_in_bytes"] == want


@pytest.mark.parametrize("cell", SMOLLM_POD1)
def test_no_rank_does_another_shards_work(records, cell):
    cost = records[cell]["cost"]
    assert cost["flops"] <= FLOPS_SLACK * cost["flops_unsharded"] / 16, cost


def test_train_peak_fits(records):
    mem = records["smollm-135m train_4k pod16x16"]["memory"]
    assert mem["peak_bytes"] <= TRAIN_PEAK, mem


def test_mlp_block_splits_d_ff(records):
    """The block's three products on each rank's rows and d_ff slice:
    exactly 1/(16·16) of 3 · 2·B·S·d·d_ff; its weights gathered along d
    alone (three [d, d_ff/16] bf16 all-gathers over data), and the output
    reduced over model into each rank's rows."""
    got = records["mlp"]
    b, s, d, ff = MLP["b"], MLP["s"], MLP["d"], MLP["ff"]
    want = 3 * 2 * b * s * d * ff / (16 * 16)
    assert got["flops"] == pytest.approx(want, rel=REL)
    assert got["coll"].get("all-gather", 0) == 3 * d * (ff // 16) * 2
    assert got["coll"].get("all-reduce", 0) + got["coll"].get("reduce-scatter", 0) > 0
    assert got["out_local"] == [b // 16, s, d]
