"""PyTorch port, the multi-pod dry run (``launch/dryrun.py``).

The cells run in one subprocess (each brings up a fake process group of
256 or 512 ranks and destroys it; the group is process state, so it never
meets this process's): smollm-135m at 2 layers, ``train_4k`` and
``decode_32k`` on ``pod16x16`` and ``decode_32k`` on ``pod2x16x16``, and
``calibrate()``.  Each record must be ``ok`` and carry the keys that
``report`` reads, and both packages' ``report`` modules must render it
alike.  Its FLOPs are held to a hand count of the program's matmuls
(``cost.flops_unsharded``, the same program on one device: every
projection, the head, and attention as ``ref.flash_attention_ref`` /
``flash_backward_ref`` compute it, 1e-9 relative), and the per-device
count, which DTensor's redistributions and replicated work can only
raise, must be at least its share.  A train cell counts gradient
collectives.  Argument bytes must equal the local shards' bytes,
computed here from the sharding rules on a stand-in mesh.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.launch import report as jreport
from repro_torch import sharding as shd
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.launch import report
from repro_torch.models import model as PM
from repro_torch.train._tree import tree_paths
from repro_torch.train.train_step import abstract_state

ARCH, LAYERS = "smollm-135m", 2
CELLS = {
    "train_4k pod16x16": ("train_4k", False),
    "decode_32k pod16x16": ("decode_32k", False),
    "decode_32k pod2x16x16": ("decode_32k", True),
}
REL = 1e-9

_SCRIPT = r"""
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch import dryrun
scope = dryrun.calibrate()
out = {{"calibrate": scope}}
for name, (shape, multi_pod) in {cells!r}.items():
    out[name] = dryrun.run_cell({arch!r}, shape, multi_pod=multi_pod, verbose=False,
                                cfg_overrides={{"n_layers": {layers}}},
                                flops_scope=scope["flops_scope"])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    script = _SCRIPT.format(src=src, cells=CELLS, arch=ARCH, layers=LAYERS)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _cfg():
    return dataclasses.replace(get_config(ARCH), n_layers=LAYERS)


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


def _hand_flops(cfg, shape) -> float:
    """Matmul FLOPs of the cell's program on one device."""
    d, h, kh, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    pv = PM.padded_vocab(cfg)
    layer = 2 * d * h * hd + 2 * 2 * d * kh * hd + 2 * h * hd * d + 3 * 2 * d * ff
    head = 2 * d * pv
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        # every projection and the head forward, then dX and dW; attention
        # (dense, every score) forward two products, backward five
        return 3.0 * b * s * (cfg.n_layers * layer + head) + \
            cfg.n_layers * 14.0 * b * h * s * s * hd
    # one token against every slot of a seq_len cache: scores and values
    return b * (cfg.n_layers * layer + head) + cfg.n_layers * 4.0 * b * h * s * hd


def test_calibrate_measures_a_scope(records):
    cal = records["calibrate"]
    assert cal["flops_scope"] in ("per_shard", "global")
    assert cal["unsharded_flops"] == cal["expected"] == 2.0 * 1024 ** 3
    # rank-local counting: a data shard of 16 does a sixteenth
    assert cal["flops_scope"] == "per_shard"
    assert cal["sharded_flops"] == cal["expected"] / 16


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_record_ok_with_report_keys(records, cell):
    rec = records[cell]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == ("pod2x16x16" if CELLS[cell][1] else "pod16x16")
    for key in ("lower_s", "compile_s", "rule_overrides", "memory", "roofline", "cost"):
        assert key in rec
    for key in ("argument_size_in_bytes", "temp_size_in_bytes", "temp_adjusted_bytes"):
        assert rec["memory"][key] >= 0
    for key in ("t_compute", "t_memory", "t_collective", "bottleneck", "model_flops",
                "useful_ratio", "roofline_fraction"):
        assert key in rec["roofline"]
    assert rec["roofline"]["flops_scope"] == records["calibrate"]["flops_scope"]
    # both packages' report render it alike (the hint column names units)
    recs = [rec]
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert report.summary(recs) == jreport.summary(recs)
    strip = lambda t: [line.rsplit("|", 2)[0] for line in t.splitlines()]  # noqa: E731
    assert strip(report.roofline_table(recs, rec["mesh"])) == \
        strip(jreport.roofline_table(recs, rec["mesh"]))
    assert len(report.roofline_table(recs, rec["mesh"]).splitlines()) == 3


@pytest.mark.parametrize("cell", ["train_4k pod16x16", "decode_32k pod16x16"])
def test_flops_equal_hand_count(records, cell):
    rec = records[cell]
    want = _hand_flops(_cfg(), SHAPES[CELLS[cell][0]])
    assert rec["cost"]["flops_unsharded"] == pytest.approx(want, rel=REL)
    # each device's count is at least its share of the program's
    assert rec["cost"]["flops"] * rec["chips"] >= rec["cost"]["flops_unsharded"]
    assert rec["roofline"]["hlo_flops"] == rec["cost"]["flops"]


def test_train_cell_counts_gradient_collectives(records):
    coll = records["train_4k pod16x16"]["cost"]["coll_by_kind"]
    # FSDP: weights gathered before use, gradients reduce-scattered
    assert coll.get("all-gather", 0) > 0
    assert coll.get("reduce-scatter", 0) + coll.get("all-reduce", 0) > 0
    assert records["train_4k pod16x16"]["roofline"]["coll_bytes"] > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_argument_bytes_are_the_local_shards(records, cell):
    shape_name, multi_pod = CELLS[cell]
    cfg, shape = _cfg(), SHAPES[shape_name]
    if shape.kind == "train":
        policy = shd.ShardingPolicy(FakeMesh(**MESH_AXES[multi_pod]), shd.TRAIN_RULES)
        want = _local_bytes(abstract_state(cfg), shd.state_specs, policy) + \
            _local_bytes(input_specs(cfg, shape), shd.batch_specs, policy)
    else:
        policy = shd.ShardingPolicy(FakeMesh(**MESH_AXES[multi_pod]), shd.SERVE_RULES)
        params = PM.param_tree(PM.abstract_params(cfg), cfg)
        cache = PM.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        token = {"token": input_specs(cfg, shape)["token"]}
        want = _local_bytes(params, shd.param_specs, policy) + \
            _local_bytes(cache, shd.cache_specs, policy) + \
            _local_bytes(token, shd.batch_specs, policy)
    assert records[cell]["memory"]["argument_size_in_bytes"] == want
