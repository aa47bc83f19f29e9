"""Each fault a cell can have, planted under the timed path, turns
``correct`` false; the control (the reference one precision down, in the
port's place) fails one of the cell's numbers.  The rest of a run is driven
as on the card, at smoke size on the CPU: in float32, where a sound run
matches the reference to rounding (tight limits), and, for the control, in
the cell's own bf16 against the cell's own limits."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import calibrate, faults, harness
from perfbench import weights as wmod
from perfbench.tests import smoke

BENCH = harness.benchmark()
F32 = {"dtype_name": "float32", "param_dtype_name": "float32"}
TIGHT = {"train": {"loss_gap": 1e-4, "grad_norm_gap": 1e-4, "grad_leaf_gap": 1e-4,
                   "update_leaf_gap": 1e-4},
         "serve": {"served_logit_gap": 1e-3, "route_margin": 1e-3, "drop_mismatch": 0}}
FAULTS = [("train", "state_unchanged"), ("train", "half_batch"), ("train", "half_batch_warm"),
          ("serve", "token_altered"), ("serve", "cache_unchanged"),
          ("serve", "weights_in_place")]


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_sound_run_is_correct_at_tight_limits(kind):
    res = harness.execute(smoke.make_run(kind, limits=TIGHT[kind], **F32), BENCH)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("kind,fault", FAULTS)
def test_planted_fault_turns_correct_false(kind, fault):
    with faults.planted(fault):
        res = harness.execute(smoke.make_run(kind, limits=TIGHT[kind], **F32), BENCH)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_control_fails_a_number(kind):
    run = smoke.make_run(kind)
    got = calibrate.control(run)
    assert any(got[name] > limit for name, limit in run.limits.items()), (got, run.limits)


def test_sound_in_place_update_stays_correct(monkeypatch):
    """A step that writes its update into the parameters it was given (as a
    fused optimizer does) is sound: the port trains a copy of the drawn
    weights, so the reference still starts from the drawn ones."""
    from repro_torch.train import train_step as ts

    make = ts.make_train_step

    def make_in_place(*a, **k):
        step = make(*a, **k)

        def in_place(state, batch):
            new, metrics = step(state, batch)
            old, now = wmod.flatten(state.params), wmod.flatten(new.params)
            with torch.no_grad():
                for n, t in old.items():
                    t.copy_(now[n])
            return dataclasses.replace(new, params=state.params), metrics
        return in_place

    monkeypatch.setattr(ts, "make_train_step", make_in_place)
    res = harness.execute(smoke.make_run("train", limits=TIGHT["train"], **F32), BENCH)
    assert res["correct"] is True, res["checks"]
    assert {"replay_loss_gap", "replay_update_leaf_gap"} <= set(res["checks"])


def test_only_the_compared_requests_are_recorded(monkeypatch):
    """The serving runner keeps the expert picks of the requests it will
    compare, drawn before the window from its first batches, and no
    others."""
    from perfbench import port

    seen = []
    orig = port.Calls.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        seen.append(self)
    monkeypatch.setattr(port.Calls, "__init__", spy)
    run = smoke.make_run("serve", limits=TIGHT["serve"], seconds=1e-9, **F32)
    run.traffic.update(batch_requests=2, check_requests=3)
    res = harness.execute(run, BENCH)
    assert res["correct"] is True, res["checks"]
    calls = seen[-1]
    assert len(calls.keep) == 3 and calls.keep <= {0, 1, 2, 3}
    assert set(calls.prefill_routes) == calls.keep
    assert res["notes"]["checked_requests"] == 3 and res["notes"]["run_calls"] >= 2


def test_changed_drawn_weights_turn_correct_false(monkeypatch):
    """Were the drawn weights the reference starts from changed during the
    run (here: drawn differently the second time), the training runner's
    bitwise comparison after the window reads it."""
    draw, seen = wmod.draw, [0]

    def drifting(config, seed, device):
        seen[0] += 1
        out = draw(config, seed, device)
        if seen[0] > 1:
            name = next(iter(out))
            out[name] = out[name] * 1.5
        return out

    monkeypatch.setattr(wmod, "draw", drifting)
    res = harness.execute(smoke.make_run("train", limits=TIGHT["train"], **F32), BENCH)
    assert res["checks"]["weights_changed"]["value"] == 1
    assert res["correct"] is False, res["checks"]
