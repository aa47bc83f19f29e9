"""PyTorch port, roofline terms (``launch/roofline.py``), held against the
JAX package's: model FLOPs of every (arch × shape) cell and the traversal
node's bytes and FLOPs exactly, the terms' arithmetic at the H100's
constants (the twin of ``tests/test_roofline.py``), and the collective
counter that stands in for the reference's HLO parser: exact result bytes
of known DTensor redistributions on a fake group of 256 ranks, brought up
and destroyed in a subprocess (the group is process state)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.launch import roofline as jroof
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import roofline as roof
from repro_torch.launch.mesh import HW

CELLS = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]


@pytest.mark.parametrize("arch, shape", CELLS)
def test_model_flops_equals_reference(arch, shape):
    assert roof.model_flops(ARCHS[arch], SHAPES[shape]) == \
        jroof.model_flops(JARCHS[arch], JSHAPES[shape])


GRID = [(n, k, g, deg, b) for n in (1, 1000, 65536) for k in (0, 2, 7)
        for g in (1, 32) for deg in (1, 2) for b in (4, 8)]


@pytest.mark.parametrize("n, k, g, degree, dtype_bytes", GRID)
def test_traversal_node_terms_equal_reference(n, k, g, degree, dtype_bytes):
    got = roof.traversal_node_terms(n, k, g, degree=degree, dtype_bytes=dtype_bytes)
    want = jroof.traversal_node_terms(n, k, g, degree=degree, dtype_bytes=dtype_bytes)
    for name in ("packed_width", "bytes_in", "bytes_fused", "bytes_unfused", "flops_fused",
                 "arith_intensity", "predicted_speedup"):
        assert getattr(got, name) == getattr(want, name), name
    # the time terms differ only by the card's bandwidth
    assert got.t_memory_fused * HW.hbm_bw == pytest.approx(want.bytes_fused, rel=1e-15)


def test_traversal_node_terms_refuses_degree3():
    with pytest.raises(ValueError):
        roof.traversal_node_terms(10, 2, 2, degree=3)


def test_traversal_node_terms_achieved():
    t = roof.traversal_node_terms(65536, 4, 256)
    sec = t.t_memory_fused
    np.testing.assert_allclose(t.achieved_fraction(sec), 1.0)
    np.testing.assert_allclose(t.achieved_gbs(sec) * 1e9, HW.hbm_bw)
    assert t.achieved_fraction(0.0) == 0.0
    assert t.to_json()["predicted_speedup"] == t.predicted_speedup


def test_hw_constants_are_the_h100s():
    assert HW.peak_flops_bf16 == 989e12
    assert HW.hbm_bw == 3.35e12
    assert HW.nvlink_bw == 450e9


def test_total_collective_weights_allreduce_2x():
    per_kind = {"all-reduce": 100, "all-gather": 100}
    assert roof.total_collective_bytes(per_kind) == 300.0 == \
        jroof.total_collective_bytes(per_kind)


def test_roofline_terms_math():
    t = roof.RooflineTerms(
        arch="a", shape="s", mesh="m", chips=256,
        hlo_flops=989e12,          # per-shard == 1 second of compute
        hlo_bytes=3.35e12,         # == 1 second of HBM
        coll_bytes=450e9,          # == 1 second of NVLink
        coll_by_kind={},
        model_flops=989e12 * 256,  # exactly the useful amount
    )
    np.testing.assert_allclose(t.t_compute, 1.0)
    np.testing.assert_allclose(t.t_memory, 1.0)
    np.testing.assert_allclose(t.t_collective, 1.0)
    np.testing.assert_allclose(t.useful_ratio, 1.0)
    np.testing.assert_allclose(t.roofline_fraction, 1.0)
    t2 = roof.RooflineTerms(
        arch="a", shape="s", mesh="m", chips=4,
        hlo_flops=4.0, hlo_bytes=8e20, coll_bytes=0.0,
        coll_by_kind={}, model_flops=16.0,
    )
    assert t2.bottleneck == "memory"
    assert t2.roofline_fraction < 1e-6
    g = roof.RooflineTerms(
        arch="a", shape="s", mesh="m", chips=4, hlo_flops=8.0, hlo_bytes=0.0,
        coll_bytes=0.0, coll_by_kind={}, model_flops=8.0, flops_scope="global")
    assert g.flops_per_device == 2.0 and g.global_flops == 8.0 and g.useful_ratio == 1.0


def test_roofline_terms_from_counted_cost():
    cfg, shape = ARCHS["smollm-135m"], SHAPES["train_4k"]
    per_kind = {"all-gather": 10, "all-reduce": 5}
    t = roof.roofline_terms(cfg, shape, "pod16x16", 256,
                            {"flops": 3.0, "bytes accessed": 7.0}, per_kind,
                            {"peak_bytes": 11.0})
    assert (t.hlo_flops, t.hlo_bytes, t.coll_bytes) == (3.0, 7.0, 20.0)
    assert t.coll_by_kind == per_kind and t.per_device_hbm_peak == 11.0
    assert t.model_flops == roof.model_flops(cfg, shape)
    j = t.to_json()
    assert j["bottleneck"] == t.bottleneck and j["flops_scope"] == "per_shard"


_COUNTER_SCRIPT = r"""
import json, sys
sys.path.insert(0, {src!r})
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.roofline import collective_bytes

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
try:
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    x = torch.empty(1024, 512, dtype=torch.float32, device="meta")
    rows = distribute_tensor(x, mesh, [Shard(0), Replicate()], src_data_rank=None)
    part = DTensor.from_local(x, mesh, [Partial(), Replicate()], run_check=False)
    out = {{
        "gather": collective_bytes(lambda: rows.redistribute(mesh, [Replicate(), Replicate()])),
        "reduce": collective_bytes(lambda: part.redistribute(mesh, [Replicate(), Replicate()])),
        "scatter": collective_bytes(lambda: part.redistribute(mesh, [Shard(0), Replicate()])),
        "local": collective_bytes(lambda: rows * 2.0 + rows),
    }}
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_collective_counter_exact_bytes():
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    run = subprocess.run([sys.executable, "-c", _COUNTER_SCRIPT.format(src=src)],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    full, shard = 1024 * 512 * 4, 1024 // 16 * 512 * 4
    assert got["gather"] == {"all-gather": full}  # each rank's result: the whole
    assert got["reduce"] == {"all-reduce": full}
    assert got["scatter"] == {"reduce-scatter": shard}  # each rank's result: its rows
    assert got["local"] == {}


SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _modules(package: str) -> set:
    root = os.path.join(SRC, package)
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files if f.endswith(".py")}


def test_every_reference_module_has_a_counterpart():
    assert _modules("repro") <= _modules("repro_torch")


def test_launch_package_exports_the_references():
    from repro import launch as jlaunch
    from repro_torch import launch

    assert launch.__all__ == jlaunch.__all__
    assert launch.HW is HW and launch.roofline is roof


@pytest.mark.parametrize("module", sorted(_modules("repro_torch")))
def test_port_module_imports_neither_jax_nor_repro(module):
    import ast

    with open(os.path.join(SRC, "repro_torch", module)) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module]
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
