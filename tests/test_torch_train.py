"""PyTorch port, training substrate (``train/``, ``data/tokens.py``,
``models.model.loss_fn``, ``launch/train.py``), held against the JAX
package.

The first part twins each test of ``tests/test_train.py`` on the port (same
names, the CPU, numpy-seeded inputs where the reference draws from a JAX
key).  The second holds the port to the reference on the same numbers:
token batches bit for bit; the schedule, clipping and int8 quantization at
1e-6; five optimizer steps on one tree (rtol 1e-5 / atol 1e-6: float32
updates in another order); ``loss_fn`` and one ``make_train_step`` step from
a state carried by ``convert.state_from_jax`` (loss and grad norm rtol
1e-5, parameters and optimizer state atol 1e-6: the same float32 sums in
other orders through a two-layer model); checkpoints read across packages
exactly.  ``compressed_psum`` runs on a gloo group of one rank here and of
two ranks spawned (``torch_dist_worker``).
"""

import dataclasses
import os
import shutil
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro.models.model as JM
import repro.train as JT
import torch_dist_worker as W
from repro.configs import get_config as jax_config
from repro.data.tokens import TokenPipeline as JPipeline
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import optim as joptim
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import model as PM
from repro_torch.train import (
    Checkpointer,
    LoopConfig,
    TrainHParams,
    TrainState,
    init_state,
    make_train_step,
    run_loop,
)
from repro_torch.train import compression as comp
from repro_torch.train import optim
from repro_torch.train._tree import tree_leaves, tree_map, tree_paths
from repro_torch.train.checkpoint import latest_step, restore, save

CPU = "cpu"
F32 = dict(rtol=1e-5, atol=1e-6)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# optimizers (twins of test_train.py)
# ---------------------------------------------------------------------------

def quad_loss(p):
    return torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["b"] + 1.0) ** 2)


def _quad_grad(p):
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        g = torch.autograd.grad(quad_loss(leaves), [leaves["b"], leaves["w"]])
    return {"b": g[0], "w": g[1]}


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizers_descend_quadratic(name):
    params = {"w": torch.zeros((4, 8)), "b": torch.zeros((8,))}
    opt = optim.make_optimizer(name, lambda s: torch.tensor(0.1), weight_decay=0.0)
    state = opt.init(params)
    for step in range(200):
        upd, state = opt.update(_quad_grad(params), state, params, torch.tensor(step))
        params = tree_map(lambda p, u: p + u, params, upd)
    start = {"w": torch.zeros((4, 8)), "b": torch.zeros((8,))}
    assert float(quad_loss(params)) < 0.1 * float(quad_loss(start))


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros((64, 128)), "v": torch.zeros((64,))}
    st = optim.adafactor(lambda s: 0.01).init(params)
    assert set(st["v"]["w"]) == {"vr", "vc"}
    assert st["v"]["w"]["vr"].shape == (64,)
    assert st["v"]["w"]["vc"].shape == (128,)
    assert set(st["v"]["v"]) == {"v"}  # vectors stay unfactored


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    np.testing.assert_allclose(float(optim.global_norm(clipped)), 1.0, rtol=1e-5)


def test_warmup_cosine_shape():
    sched = optim.warmup_cosine(1e-3, 1000, warmup_steps=100)
    assert float(sched(torch.tensor(0))) == 0.0
    np.testing.assert_allclose(float(sched(torch.tensor(100))), 1e-3, rtol=1e-5)
    assert float(sched(torch.tensor(1000))) < 2e-4


# ---------------------------------------------------------------------------
# gradient compression (twins)
# ---------------------------------------------------------------------------

def test_quantize_roundtrip_bounds():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32)) * 5
    q, scale = comp.quantize_int8(x)
    err = torch.abs(comp.dequantize_int8(q, scale) - x)
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_telescopes():
    """Mean compressed update over many steps converges to the true mean
    gradient — the error-feedback guarantee."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=256).astype(np.float32))
    err = {"g": torch.zeros(256)}
    total = torch.zeros(256)
    n = 200
    for _ in range(n):
        out, err = comp.compress_decompress({"g": g}, err)
        total = total + out["g"]
    np.testing.assert_allclose((total / n).numpy(), g.numpy(), atol=1e-3)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A gloo group of one rank and its ``("data",)`` mesh."""
    path = str(tmp_path_factory.mktemp("dist") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(path, 1), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_compressed_psum_matches_mean(mesh1):
    """A 1-rank mesh: the gathered int8 mean is the plain mean, and the
    feedback plus the dequantized output reconstruct the input; equal to
    ``compress_decompress`` and to the reference's shard_map form."""
    gw = np.random.default_rng(1).normal(size=(8, 8)).astype(np.float32)
    g = {"w": torch.from_numpy(gw)}
    out, err = comp.compressed_psum(g, comp.init_error_state(g), ("data",), mesh1)
    np.testing.assert_allclose(out["w"].numpy(), gw, atol=0.05)
    np.testing.assert_allclose((out["w"] + err["w"]).numpy(), gw, atol=1e-6)
    same, same_err = comp.compress_decompress(g, comp.init_error_state(g))
    assert torch.equal(out["w"], same["w"]) and torch.equal(err["w"], same_err["w"])

    from functools import partial

    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map

    @partial(shard_map, mesh=jax.make_mesh((1,), ("data",)),
             in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")))
    def fn(gs, es):
        return jcomp.compressed_psum(gs, es, ("data",))

    jout, jerr = fn({"w": jnp.asarray(gw)}, {"w": jnp.zeros((8, 8))})
    np.testing.assert_allclose(out["w"].numpy(), np.asarray(jout["w"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(err["w"].numpy(), np.asarray(jerr["w"]), rtol=1e-6, atol=1e-7)


def test_compressed_psum_two_ranks_match_mean():
    """Two gloo ranks with their own grads: every rank gets the mean of the
    ranks' int8 round trips (one common scale, the larger), within a
    quantum of the plain mean, and keeps its own residual."""
    ranks = W.spawn(2, ["compressed_psum"])
    got = [r[("compressed_psum", "ws2")] for r in ranks]
    for key in ("w", "b"):
        grads = [g[key][0] for g in got]
        scale = max(np.abs(g).max() for g in grads) / 127.0
        q = [np.clip(np.round(g / np.float32(scale)), -127, 127) for g in grads]
        want = (q[0] + q[1]) * np.float32(scale) / 2
        for rank, (g, out, err) in enumerate(got[i][key] for i in range(2)):
            np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(out, np.mean(grads, axis=0), atol=scale)
            np.testing.assert_allclose(err, g - q[rank] * np.float32(scale), atol=1e-6)


def test_training_with_compression_converges():
    cfg = get_config("smollm-135m", smoke=True)
    hp = TrainHParams(peak_lr=1e-3, total_steps=20, warmup_steps=1, compress_grads=True)
    state = init_state(0, cfg, hp, device=CPU)
    assert state.err is not None
    step = make_train_step(cfg, hp)
    pipe = TokenPipeline(cfg.vocab, 32, 4, seed=0)
    losses = []
    for i in range(10):
        state, m = step(state, pipe.batch_at(i % 2))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# checkpointing (twins)
# ---------------------------------------------------------------------------

def _tiny_state():
    cfg = get_config("smollm-135m", smoke=True)
    hp = TrainHParams(total_steps=10)
    return cfg, hp, init_state(0, cfg, hp, device=CPU)


def test_checkpoint_roundtrip_exact():
    cfg, hp, state = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        save(d, 3, state)
        assert latest_step(d) == 3
        restored, step = restore(d, state)
        assert step == 3
        for a, b in zip(tree_leaves(state), tree_leaves(restored)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_np(a), _np(b))


def test_checkpoint_atomicity_crash_midwrite():
    """A stale tmp dir (simulated crash) must not shadow the good ckpt."""
    cfg, hp, state = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, state)
        os.makedirs(os.path.join(d, ".tmp-step_000002"))  # crashed save
        assert latest_step(d) == 1
        restored, step = restore(d, state)
        assert step == 1


def test_checkpoint_retention_gc():
    cfg, hp, state = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        for s in (1, 2, 3, 4):
            ck.save_sync(s, state)
        names = sorted(n for n in os.listdir(d) if n.startswith("step_"))
        assert names == ["step_000003", "step_000004"]


def test_checkpoint_async_overlap_and_wait():
    cfg, hp, state = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=3)
        ck.save_async(5, state)
        ck.wait()
        assert latest_step(d) == 5


def test_restore_shape_mismatch_raises():
    cfg, hp, state = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, state)
        bad = tree_map(
            lambda x: torch.empty(tuple(x.shape[:1]) + (99,), dtype=x.dtype, device="meta")
            if x.dim() >= 1 else x,
            state,
        )
        with pytest.raises((ValueError, KeyError)):
            restore(d, bad)


# ---------------------------------------------------------------------------
# loop: watchdog, NaN guard, resume (twins)
# ---------------------------------------------------------------------------

def test_loop_resume_continues_from_checkpoint():
    cfg, hp, state = _tiny_state()
    step = make_train_step(cfg, hp)
    pipe = TokenPipeline(cfg.vocab, 32, 4, seed=0)
    with tempfile.TemporaryDirectory() as d:
        lc = LoopConfig(total_steps=4, checkpoint_dir=d, checkpoint_every=2, log_every=100)
        run_loop(state, step, pipe.batches(), lc, log=lambda s: None)
        lc2 = LoopConfig(total_steps=8, checkpoint_dir=d, checkpoint_every=2, log_every=100)
        r = run_loop(init_state(0, cfg, hp, device=CPU), step, pipe.batches(), lc2,
                     log=lambda s: None)
        assert r.resumed_from == 4
        assert int(r.state.step) == 8


def test_loop_watchdog_flags_straggler():
    """An eager step runs a few hundred ops; with every intra-op thread of
    the machine it is as slow as its busiest core, and beside other test
    processes its time swings by tens of times, so the EMA would follow the
    machine's load, not the step.  One thread keeps the step's own time."""
    cfg, hp, state = _tiny_state()
    inner = make_train_step(cfg, hp)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inner(state, TokenPipeline(cfg.vocab, 32, 4, seed=0).batch_at(0))  # warm
        calls = {"n": 0}

        def slow_step(st, b):
            calls["n"] += 1
            if calls["n"] == 9:
                time.sleep(1.0)  # synthetic straggler step
            return inner(st, b)

        pipe = TokenPipeline(cfg.vocab, 32, 4, seed=0)
        lc = LoopConfig(total_steps=10, log_every=100, watchdog_factor=3.0, watchdog_warmup=3)
        r = run_loop(state, slow_step, pipe.batches(), lc, log=lambda s: None)
    finally:
        torch.set_num_threads(threads)
    assert r.straggler_steps >= 1


def test_loop_nan_guard_saves_postmortem():
    cfg, hp, state = _tiny_state()

    def nan_step(st, b):
        return TrainState(st.params, st.opt_state, st.step + 1, st.err), {
            "loss": torch.tensor(float("nan"))
        }

    pipe = TokenPipeline(cfg.vocab, 32, 4, seed=0)
    with tempfile.TemporaryDirectory() as d:
        lc = LoopConfig(total_steps=5, checkpoint_dir=d, log_every=100)
        with pytest.raises(FloatingPointError):
            run_loop(state, nan_step, pipe.batches(), lc, log=lambda s: None)
        assert latest_step(d) is not None


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 3, 17])
def test_token_batches_equal_reference(step):
    for kw in (dict(vocab=512, seq_len=32, global_batch=4, seed=0),
               dict(vocab=49152, seq_len=128, global_batch=8, seed=5)):
        got, want = TokenPipeline(**kw).batch_at(step), JPipeline(**kw).batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    shard = TokenPipeline(vocab=512, seq_len=16, global_batch=8, seed=1)
    np.testing.assert_array_equal(
        shard.batch_at(2, shard=1, num_shards=2)["tokens"],
        JPipeline(vocab=512, seq_len=16, global_batch=8, seed=1).batch_at(
            2, shard=1, num_shards=2)["tokens"])


def test_schedule_clip_quantize_equal_reference():
    sched = optim.warmup_cosine(3e-4, 1000, warmup_steps=30)
    jsched = joptim.warmup_cosine(3e-4, 1000, warmup_steps=30)
    for s in (0, 1, 29, 30, 31, 500, 999, 1000, 1500):
        np.testing.assert_allclose(float(sched(torch.tensor(s, dtype=torch.int32))),
                                   float(jsched(jnp.asarray(s, jnp.int32))), rtol=1e-6)
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(7, 3)).astype(np.float32) * 4,
            "b": rng.normal(size=(11,)).astype(np.float32)}
    clipped, norm = optim.clip_by_global_norm(tree_map(torch.from_numpy, tree), 1.0)
    jclipped, jnorm = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jclipped[k]), rtol=1e-6)
    q, scale = comp.quantize_int8(torch.from_numpy(tree["a"]))
    jq, jscale = jcomp.quantize_int8(jnp.asarray(tree["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-6)


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizer_steps_equal_reference(name):
    """Five steps of each optimizer on the same tree with the same grads:
    updates and state at float32 tolerance, adafactor's state shapes equal
    (a stacked 3-D leaf factors over its last two dims, as in the
    reference)."""
    rng = np.random.default_rng(7)
    shapes = {"w": (3, 4, 8), "m": (4, 8), "v": (8,), "s": (1, 5)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    sched = optim.warmup_cosine(1e-2, 20, warmup_steps=2)
    jsched = joptim.warmup_cosine(1e-2, 20, warmup_steps=2)
    opt = optim.make_optimizer(name, sched, weight_decay=0.1)
    jopt = joptim.make_optimizer(name, jsched, weight_decay=0.1)
    p, jp = tree_map(torch.from_numpy, params), jax.tree.map(jnp.asarray, params)
    st, jst = opt.init(p), jopt.init(jp)
    for step in range(5):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        upd, st = opt.update(tree_map(torch.from_numpy, g), st, p,
                             torch.tensor(step, dtype=torch.int32))
        jupd, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp,
                                jnp.asarray(step, jnp.int32))
        p = tree_map(lambda a, u: a + u, p, upd)
        jp = jax.tree.map(lambda a, u: a + u, jp, jupd)
    for a, b in zip(tree_leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    jleaves = jax.tree.leaves(jst)
    assert [tuple(x.shape) for x in tree_leaves(st)] == [x.shape for x in jleaves]
    for a, b in zip(tree_leaves(st), jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def _smoke_pair(name="smollm-135m", **overrides):
    jcfg = dataclasses.replace(jax_config(name, smoke=True), **overrides)
    pcfg = dataclasses.replace(get_config(name, smoke=True), **overrides)
    return jcfg, pcfg


def test_loss_fn_equals_reference():
    jcfg, pcfg = _smoke_pair()
    jparams = JM.init_params(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), pcfg, device=CPU)
    batch = JPipeline(pcfg.vocab, 32, 4, seed=0).batch_at(0)
    batch["labels"][0, :5] = -1  # masked positions
    jloss, jm = JM.loss_fn(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    loss, m = PM.loss_fn(model, batch, pcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("ce", "aux", "ntok"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    # the port's tree layout is the reference's
    tree = PM.param_tree(model, pcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    assert [p for p, _ in tree_paths(tree)] == [
        jax.tree_util.keystr(p) for p, _ in jflat]
    for (_, a), (_, b) in zip(tree_paths(tree), jflat):
        np.testing.assert_array_equal(a.numpy(), b)


def _carried(jcfg, pcfg, hp_kw):
    """The reference's state after one step, and the port's copy of it."""
    hp = JT.TrainHParams(**hp_kw)
    jstate = JT.init_state(jax.random.key(0), jcfg, hp)
    jstep = jax.jit(JT.make_train_step(jcfg, hp))
    pipe = JPipeline(jcfg.vocab, 32, 4, seed=0)
    jstate, _ = jstep(jstate, pipe.batch_at(0))
    return jstate, jstep, state_from_jax(jax.tree.map(np.asarray, jstate), pcfg, CPU)


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("compress", [False, True])
def test_train_step_equals_reference(micro, compress):
    """One step from a carried mid-run state: loss, grad norm, parameters,
    optimizer state and the compression residual."""
    jcfg, pcfg = _smoke_pair(microbatches=micro)
    hp_kw = dict(peak_lr=1e-3, total_steps=20, warmup_steps=1, compress_grads=compress)
    jstate, jstep, state = _carried(jcfg, pcfg, hp_kw)
    for a, b in zip(tree_leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    batch = JPipeline(jcfg.vocab, 32, 4, seed=0).batch_at(1)
    jnew, jm = jstep(jstate, batch)
    new, m = make_train_step(pcfg, TrainHParams(**hp_kw))(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["ntok"]), float(jm["ntok"]), rtol=0)
    assert int(new.step) == int(jnew.step) == 2
    assert (new.err is None) == (not compress)
    for a, b in zip(tree_leaves(new), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    # the input state is left as it was
    for a, b in zip(tree_leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "xlstm-1.3b", "jamba-1.5-large-398b"])
def test_mixer_train_step_equals_reference(name):
    """One step of the MoE, recurrent and hybrid smoke configs from a state
    carried by ``state_from_jax`` (the router, expert, Mamba and xLSTM
    leaves in the reference's layouts and dtypes; the router aux in the
    loss): loss, grad norm, parameters and optimizer state."""
    jcfg, pcfg = _smoke_pair(name)
    hp_kw = dict(peak_lr=1e-3, total_steps=20, warmup_steps=1)
    jstate, jstep, state = _carried(jcfg, pcfg, hp_kw)
    for a, b in zip(tree_leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    batch = JPipeline(jcfg.vocab, 32, 4, seed=0).batch_at(1)
    jnew, jm = jstep(jstate, batch)
    new, m = make_train_step(pcfg, TrainHParams(**hp_kw))(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    for a, b in zip(tree_leaves(new), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_checkpoints_cross_packages():
    """A checkpoint of either package restores into the other's state of
    the same config, leaf for leaf (the same paths and files)."""
    jcfg, pcfg = _smoke_pair()
    jstate, _, state = _carried(jcfg, pcfg, dict(total_steps=10))
    with tempfile.TemporaryDirectory() as d:
        save(os.path.join(d, "port"), 1, state)
        jckpt.save(os.path.join(d, "ref"), 1, jstate)
        back, _ = jckpt.restore(os.path.join(d, "port"), jstate)
        got, _ = restore(os.path.join(d, "ref"), state)
    for a, b, c in zip(jax.tree.leaves(back), tree_leaves(got), tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), _np(c))
        np.testing.assert_array_equal(_np(b), _np(c))


def test_launch_train_smoke_cpu_and_resume():
    """``python -m repro_torch.launch.train --smoke --device cpu``, then a
    run resumed from its step-3 checkpoint reads the token stream from step
    3 on and repeats the uninterrupted run's losses."""
    logs = []
    argv = ["--smoke", "--device", "cpu", "--steps", "6", "--batch", "4", "--seq", "32",
            "--checkpoint-every", "3"]
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "a"), os.path.join(d, "b")
        whole = launch_train.run(argv + ["--checkpoint-dir", a], log=logs.append)
        assert [h["step"] for h in whole.history] == list(range(6))
        assert int(whole.state.step) == 6 and latest_step(a) == 6
        os.makedirs(b)
        shutil.copytree(os.path.join(a, "step_000003"), os.path.join(b, "step_000003"))
        with open(os.path.join(b, "LATEST"), "w") as f:
            f.write("step_000003")
        resumed = launch_train.run(argv + ["--checkpoint-dir", b], log=logs.append)
    assert resumed.resumed_from == 3
    np.testing.assert_allclose([h["loss"] for h in resumed.history],
                               [h["loss"] for h in whole.history[3:]], rtol=1e-6)
    assert launch_train.main(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                              "--seq", "16", "--compress-grads"]) == 0
    assert any("[train] loss" in line for line in logs)


def test_launch_train_mesh_raises():
    """``--mesh 1x1`` on the CPU (over the group that is up, else a gloo
    group of one that the run starts and ends) trains and equals the run without a mesh: losses and grad
    norms at 1e-6, the final state at 1e-6 of each leaf's largest (one
    rank: the same sums, DTensor around them).  A mesh the world cannot
    hold raises."""
    argv = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32",
            "--dtype", "float32", "--lr", "1e-3"]
    up = dist.is_initialized()  # the module's group of one, if a test started it
    plain = launch_train.run(argv, log=lambda s: None)
    meshed = launch_train.run(argv + ["--mesh", "1x1"], log=lambda s: None)
    assert dist.is_initialized() == up  # a group the run started, it ended
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in meshed.history],
                                   [h[key] for h in plain.history], rtol=1e-6)
    for (path, a), b in zip(tree_paths(meshed.state), tree_leaves(plain.state)):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        scale = max(float(b.abs().max()), 1e-30) if b.numel() else 1.0
        assert float((a - b).abs().max() if b.numel() else 0.0) <= 1e-6 * scale, path
    with pytest.raises(ValueError, match="2 ranks"):
        launch_train.main(["--smoke", "--device", "cpu", "--mesh", "1x2"])


def test_long_sequence_under_grad_raises():
    """Over the 2,048-token threshold attention takes the flash Function
    under grad: a 2,049-token forward is differentiable and its gradient
    equals the plain path's (autograd through ``chunked_attention``; loss
    1e-6 relative, each weight's gradient 1e-5 of its largest).  Explicit
    positions there raise: the kernels derive them from indices."""
    import repro_torch.models.attention as PA

    cfg = get_config("smollm-135m", smoke=True)
    model = PM.init_params(cfg, device=CPU)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (1, 2049)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    for p in model.parameters():
        p.requires_grad_(True)

    def grads():
        loss, _ = PM.loss_fn(model, batch, cfg)
        return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))

    loss, got = grads()

    def plain(q, k, v, *, causal, window, kv_len):
        pos = torch.arange(q.shape[1])[None].expand(q.shape[0], -1)
        kpos = torch.arange(k.shape[1])[None].expand(k.shape[0], -1)
        return PA.chunked_attention(q, k, v, pos, kpos, causal=causal, window=window,
                                    out_dtype=q.dtype)

    orig = PA.ops.flash_attention_fn
    PA.ops.flash_attention_fn = plain
    try:
        want_loss, want = grads()
    finally:
        PA.ops.flash_attention_fn = orig
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    with torch.no_grad():
        logits, _ = PM.forward(model, batch, cfg)
    assert logits.shape[1] == 2049 and not logits.requires_grad
    q = torch.zeros(1, 2049, 4, 16, requires_grad=True)
    with pytest.raises(ValueError, match="positions"):
        PA._long_attention(q, q, q, torch.zeros(1, 2049), None, causal=True, window=None,
                           out_dtype=q.dtype)


def test_serving_runs_without_grad():
    """``prefill`` and ``decode_step`` run under inference mode whatever the
    weights' ``requires_grad``; ``forward`` is differentiable."""
    cfg = get_config("smollm-135m", smoke=True)
    model = PM.init_params(cfg, device=CPU)
    assert not any(p.requires_grad for p in model.parameters())
    for p in model.parameters():
        p.requires_grad_(True)
    toks = {"tokens": np.arange(1, 9, dtype=np.int32)[None]}
    logits, cache = PM.prefill(model, toks, cfg, 16)
    assert not logits.requires_grad and torch.is_inference(logits)
    step_logits, _ = PM.decode_step(model, np.array([[3]], np.int32), cache, 8, cfg)
    assert not step_logits.requires_grad and torch.is_inference(step_logits)
    full, _ = PM.forward(model, toks, cfg)
    full[0, -1].sum().backward()
    assert model.embed.grad is not None
    np.testing.assert_allclose(full[0, -1].detach().numpy(), logits[0].numpy(),
                               rtol=1e-5, atol=1e-5)
