"""PyTorch port, sharded training: ``launch.train --mesh`` on gloo groups of
1, 2 and 4 ranks against the same run without a mesh.

Each world size is one ``torch.multiprocessing.spawn`` (``torch_dist_worker
.spawn_train``) running ``launch.train.run`` on every rank at the meshes
``(1, 1)``, ``(2, 1)``, ``(1, 2)`` and ``(2, 2)`` that fit it, for the
smollm, qwen2-moe and xlstm smoke configs in float32 (qwen2-moe with two
microbatches, so each one's grads are pinned to their parameters'
placements; xlstm's sLSTM and mLSTM loops on each rank's batch rows),
three steps with a checkpoint after each (the state after
step 1 is read from its checkpoint, gathered from the shards); the 4-rank
group also trains at
2,304 tokens, over the 2,048-token threshold, so the flash Function runs on
each rank's DTensor shards (batch over ``data``, heads over ``model``).
The oracle is ``launch.train.run`` of the same flags without ``--mesh`` in
the test process.

Bounds: loss and grad norm at every step within 1e-5 relative; after one
step (no parameter moves: the schedule's rate is 0 at step 0) every leaf,
and after three every optimizer moment, within 1e-5 of its leaf's largest
value (the same float32 sums in other orders: partial sums over ``model``,
an all-reduce over ``data``).  Parameters after three steps are held to
1e-5 of their leaf's largest value where the gradient stands well above
float32 rounding (the first moment at least ``MU_FLOOR`` of the leaf's
largest), and everywhere to 1e-2 of the learning rate, absolutely, as
``chip_smoke.py`` holds the card to the CPU: AdamW moves an element by
lr·m̂/(√v̂ + ε), which for a gradient at the level of the other run's
rounding (1e-7 of the leaf's largest gradient) is any value up to lr, so
two right steps differ there by a part of lr, not by a part of the
parameter.
"""

import numpy as np
import pytest

import torch_dist_worker as W
from repro_torch.launch import train as launch_train

MESHES = {1: ["1x1"], 2: ["2x1", "1x2"], 4: ["2x2"]}
ARCHS = {"smollm-135m": [], "qwen2-moe-a2.7b": ["--microbatches", "2"], "xlstm-1.3b": []}
# three steps on every mesh, xlstm on one rank alone (bitwise the unsharded
# run there): its recurrences carry a split batch's float32 reorderings
# through three AdamW steps to ~2e-5 of the grad norm at 2 and 4 ranks,
# as splitting the unsharded batch in two microbatches takes it to ~6e-6
THREE_STEPS = [(arch, mesh) for arch in ARCHS for ms in MESHES.values() for mesh in ms
               if arch != "xlstm-1.3b" or mesh == "1x1"]
BASE = ["--smoke", "--device", "cpu", "--dtype", "float32", "--batch", "4", "--seq", "32",
        "--lr", "1e-3"]
LR = 1e-3
LONG = ["--smoke", "--device", "cpu", "--dtype", "float32", "--batch", "2", "--seq", "2304",
        "--lr", "1e-3", "--arch", "smollm-135m", "--steps", "2"]
RTOL = 1e-5
# a parameter element whose first moment is at least this share of its
# leaf's largest moved by a gradient far above float32 rounding
MU_FLOOR = 1e-3


def _argv(arch):
    return BASE + ["--arch", arch, "--steps", "3"] + ARCHS[arch]


def _runs(world):
    runs = [(f"{arch} {mesh}", _argv(arch) + ["--mesh", mesh])
            for mesh in MESHES[world] for arch in ARCHS]
    if world == 4:
        runs.append(("long 2x2", LONG + ["--mesh", "2x2"]))
    return runs


@pytest.fixture(scope="module")
def sharded():
    """{run name: rank 0's history, final state and step-1 checkpoint}, all
    world sizes."""
    out = {}
    for world in MESHES:
        out.update(W.spawn_train(world, _runs(world)))
    return out


@pytest.fixture(scope="module")
def unsharded():
    """{arch or "long": the same run without a mesh}."""
    out = {arch: W.train_result(_argv(arch)) for arch in ARCHS}
    out["long"] = W.train_result(LONG)
    return out


def _same(got, want, history, *, params_atol=None):
    """The first ``history`` steps' (loss, grad norm) within RTOL; each leaf
    within RTOL of its largest value, or, where ``params_atol`` is given,
    parameters within it and within RTOL of their largest value where
    their first moment is at least MU_FLOOR of its leaf's largest."""
    for (loss, norm), (wloss, wnorm) in zip(got["history"][:history], want["history"][:history]):
        assert abs(loss - wloss) <= RTOL * abs(wloss)
        assert abs(norm - wnorm) <= RTOL * abs(wnorm)
    assert got["state"].keys() == want["state"].keys()
    for path, w in want["state"].items():
        g = got["state"][path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        err = float(np.max(np.abs(g.astype(np.float64) - w))) if w.size else 0.0
        if params_atol is not None and path.startswith(".params"):
            assert err <= params_atol, (path, err)
            mu = np.abs(want["state"][".opt_state['mu']" + path[len(".params"):]])
            sure = mu >= MU_FLOOR * mu.max()
            sure_err = float(np.max(np.abs(g[sure].astype(np.float64) - w[sure])))
            assert sure_err <= RTOL * float(np.max(np.abs(w))), (path, sure_err)
        else:
            assert err <= RTOL * float(np.max(np.abs(w))), (path, err)


def _step1(run):
    return dict(history=run["history"], state=run["step1"])


@pytest.mark.parametrize("mesh", [m for ms in MESHES.values() for m in ms])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_sharded_step_equals_unsharded(sharded, unsharded, arch, mesh):
    """The state after step 1, from the run's step-1 checkpoint (full
    tensors gathered from the shards)."""
    _same(_step1(sharded[f"{arch} {mesh}"]), _step1(unsharded[arch]), 1)


@pytest.mark.parametrize("arch,mesh", THREE_STEPS)
def test_three_sharded_steps_equal_unsharded(sharded, unsharded, arch, mesh):
    run = sharded[f"{arch} {mesh}"]
    assert len(run["history"]) == 3
    _same(run, unsharded[arch], 3, params_atol=1e-2 * LR)


def test_flash_on_shards_over_the_threshold(sharded, unsharded):
    """2,304 tokens on the 2x2 mesh: q, k and v split over batch (data) and
    heads (model), the flash Function on each rank's shards."""
    _same(sharded["long 2x2"], unsharded["long"], 2, params_atol=1e-2 * LR)


def test_mesh_must_match_the_world():
    with pytest.raises(ValueError, match="2 ranks, the process group has 1"):
        launch_train.run(_argv("smollm-135m") + ["--mesh", "2x1"], log=lambda s: None)
    with pytest.raises(ValueError, match="DxM"):
        launch_train.setup(["--mesh", "2by1"])
