"""PyTorch port, pipeline parallelism (``train/pipeline.py``): the looped
GPipe schedule over ``pod`` on gloo groups, held against the JAX package.

Dense: smollm smoke (2 periods, one a stage), B 4, S 16, 2 microbatches,
on ``("pod", "data")`` meshes ``(2, 1)`` and ``(2, 2)`` (one
``torch_dist_worker.spawn_pipeline`` a world size).  The oracle is the
reference's sequential ``model.loss_fn`` and ``jax.grad`` on the same
weights (``convert.params_from_jax``), in this process; the bounds are
``tests/test_pipeline.py``'s: the loss at rtol 2e-5, every gradient at
1e-4 absolute.  On ``(2, 2)`` each data shard sees half the rows and the
loss is the mean of the shards' (the reference's ``pmean``), equal to the
sequential mean here because every label counts.

MoE: qwen2-moe smoke on ``(2, 1)``, the loss only, against the reference's
own ``make_pp_loss_for_mesh`` run in a subprocess with 2 host devices (as
``tests/test_pipeline.py`` runs it): the bubble ticks' router aux enters
both losses alike, so the sequential loss is not the oracle there.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch_dist_worker as W
from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.train.pipeline import pipeline_loss_fn

B, S, MICRO = 4, 16, 2
LOSS_RTOL, GRAD_ATOL = 2e-5, 1e-4
DENSE = "smollm-135m"
MOE = "qwen2-moe-a2.7b"
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}

_MOE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import pickle, sys
sys.path.insert(0, {src!r})
import jax, numpy as np
from repro import sharding as shd
from repro.configs import get_config
from repro.models import model
from repro.train.pipeline import make_pp_loss_for_mesh

cfg = get_config({arch!r}, smoke=True)
mesh = jax.make_mesh((2, 1), ("pod", "data"))
policy = shd.ShardingPolicy(mesh, shd.TRAIN_RULES)
key = jax.random.key(0)
params = model.init_params(key, cfg)
batch = {{"tokens": jax.random.randint(key, ({b}, {s}), 0, cfg.vocab),
          "labels": jax.random.randint(jax.random.key(1), ({b}, {s}), 0, cfg.vocab)}}
batch_abs = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch)
fn, (psh, bsh) = make_pp_loss_for_mesh(cfg, mesh, policy, batch_abs, microbatches={m})
with mesh:
    loss = float(jax.jit(fn)(jax.device_put(params, psh), jax.device_put(batch, bsh)))
with open({out!r}, "wb") as f:
    pickle.dump(dict(loss=loss, params=jax.tree.map(np.asarray, params),
                     batch=jax.tree.map(np.asarray, batch)), f)
"""


def _dense_inputs():
    cfg = jax_config(DENSE, smoke=True)
    key = jax.random.key(0)
    params = JM.init_params(key, cfg)
    batch = {"tokens": jax.random.randint(key, (B, S), 0, cfg.vocab),
             "labels": jax.random.randint(jax.random.key(1), (B, S), 0, cfg.vocab)}
    loss, grads = jax.value_and_grad(lambda p: JM.loss_fn(p, batch, cfg)[0])(params)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    oracle = {jax.tree_util.keystr(path): np.asarray(g, np.float64) for path, g in flat}
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, batch),
            float(loss), oracle)


def _moe_reference(tmp_path):
    out = str(tmp_path / "moe.pkl")
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    script = _MOE_SCRIPT.format(src=src, arch=MOE, b=B, s=S, m=MICRO, out=out)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, env=env)
    assert run.returncode == 0, run.stderr[-2000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' results: the dense oracle, the reference's pipelined
    MoE loss, and the port's runs (one spawn a world size)."""
    tree, batch, loss, oracle = _dense_inputs()
    moe = _moe_reference(tmp_path_factory.mktemp("pipeline"))
    two = W.spawn_pipeline(2, [
        ("dense 2x1", (DENSE, MESHES["2x1"], tree, batch, MICRO)),
        ("moe 2x1", (MOE, MESHES["2x1"], moe["params"], moe["batch"], MICRO)),
    ])
    four = W.spawn_pipeline(4, [("dense 2x2", (DENSE, MESHES["2x2"], tree, batch, MICRO))])
    return dict(loss=loss, oracle=oracle, moe_loss=moe["loss"], port={**two, **four})


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dense_loss_matches_sequential(runs, mesh):
    got = runs["port"][f"dense {mesh}"]["loss"]
    np.testing.assert_allclose(got, runs["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dense_grads_match_sequential(runs, mesh):
    grads = runs["port"][f"dense {mesh}"]["grads"]
    assert sorted(grads) == sorted(runs["oracle"])
    errs = {path: float(np.max(np.abs(g.astype(np.float64) - runs["oracle"][path])))
            for path, g in grads.items()}
    assert max(errs.values()) < GRAD_ATOL, errs
    # the tied embedding's gradient is stage 0's lookup plus the last
    # stage's head: a sum over pod, far above the bound
    assert np.abs(runs["oracle"]["['embed']"]).max() > 100 * GRAD_ATOL


def test_moe_loss_matches_reference_pipeline(runs):
    np.testing.assert_allclose(runs["port"]["moe 2x1"]["loss"], runs["moe_loss"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch, stages", [
    ("whisper-medium", 2),  # an encoder
    ("llava-next-mistral-7b", 2),  # a patch prefix
    ("smollm-135m", 3),  # 2 periods on 3 stages
])
def test_out_of_scope_raises(arch, stages):
    cfg = get_config(arch, smoke=True)
    with pytest.raises(ValueError):
        pipeline_loss_fn({}, {}, cfg, stages=stages, microbatches=1)
