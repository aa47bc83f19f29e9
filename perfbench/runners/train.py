"""The training runner: the port's ``train_step`` (``repro_torch.train``) on
the benchmark's seeded weights and tokens.

Set-up builds one state and one step function, and drives them through the
traffic's ``first_steps`` steps on batches whose rows all differ (this warms
up every shape and builds the kernels).  The port trains a copy of the
drawn weights, so whatever it does to its own tensors, in place or not, the
drawn ones stay as the reference takes them; after the window they are
drawn again from the seed and must match bitwise.  The window then calls the
same step on the same state until ``--seconds`` have passed, each step
ended by a synchronise.  After the window the state is freed, and the same
step function, warmed by the window, replays the first steps on a fresh
copy of the weights, so that the path a steady-state step takes is compared
too.  The plain reference follows the first steps from the drawn weights
and the same batches; for the set-up steps and for the replay alike, each
step's loss, the first step's gradient norm before clipping, each leaf's
norm of the first clipped gradient as AdamW's first moment holds it, and
each leaf's norm of its change over the first steps are compared.
"""

from __future__ import annotations

import contextlib
import dataclasses
import resource
import statistics
import time

import torch

from perfbench import counts, port, tracing
from perfbench import weights as wmod
from perfbench.reference import train as ref_train


def batches(traffic: dict, vocab: int, seed: int, device: str):
    """An endless stream of ``{"tokens", "labels"}`` batches of
    ``traffic["batch"]`` rows of ``traffic["seq"]`` tokens, seeded."""
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    b, s = traffic["batch"], traffic["seq"]
    while True:
        ids = torch.randint(0, vocab, (b, s + 1), generator=gen, device=device)
        yield {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def _leaf_norms(flat: dict, scale: float = 1.0) -> dict:
    return {n: float(t.float().norm()) * scale for n, t in flat.items()}


def first_steps(step, state, batches: list, flat0: dict, b1: float):
    """Drive ``step`` from ``state`` through ``batches`` (``(tokens,
    labels)``, handed over as copies); returns the state and the numbers
    the reference is compared on."""
    got = {"losses": []}
    for i, (tokens, labels) in enumerate(batches):
        state, m = step(state, {"tokens": tokens.clone(), "labels": labels.clone()})
        got["losses"].append(float(m["loss"]))
        if i == 0:
            got["grad_norm"] = float(m["grad_norm"])
            got["grad_leaf"] = _leaf_norms(wmod.flatten(state.opt_state["mu"]), 1.0 / (1.0 - b1))
    now = wmod.flatten(state.params)
    got["update_leaf"] = {n: float((now[n].float() - flat0[n].float()).norm()) for n in flat0}
    return state, got


def run(run) -> dict:
    if run.patch:
        run.patch()
    from repro_torch.train.optim import make_optimizer, warmup_cosine
    from repro_torch.train.train_step import TrainHParams, TrainState, make_train_step

    dev, traffic, hp = run.device, run.traffic, run.traffic["hparams"]
    cfg = dataclasses.replace(port.model_config(run), microbatches=traffic["microbatches"])
    t_import = time.perf_counter()
    flat0 = wmod.draw(run.config, run.seed, dev)
    port.sync(dev)
    t_weights = time.perf_counter()
    hparams = TrainHParams(peak_lr=hp["peak_lr"], total_steps=hp["total_steps"],
                           warmup_steps=hp["warmup_steps"], weight_decay=hp["weight_decay"],
                           clip_norm=hp["clip_norm"])
    opt = make_optimizer(cfg.optimizer, warmup_cosine(hp["peak_lr"], hp["total_steps"],
                                                      hp["warmup_steps"], hp["final_frac"]),
                         weight_decay=hp["weight_decay"])

    def fresh_state():
        params = wmod.nest({n: t.clone() for n, t in flat0.items()})
        return TrainState(params=params, opt_state=opt.init(params),
                          step=torch.zeros((), dtype=torch.int32, device=dev))

    state = fresh_state()
    step = make_train_step(cfg, hparams)
    feed = batches(traffic, cfg.vocab, run.seed, dev)
    flash = port.FlashCalls()
    launches0 = port.launches()
    first = []
    for _ in range(traffic["first_steps"]):
        b = next(feed)
        first.append((b["tokens"].clone(), b["labels"].clone()))
    port.sync(dev)
    t_built = time.perf_counter()

    with flash.installed():
        # set-up: the first steps, on the state the window goes on training
        state, prog = first_steps(step, state, first, flat0, hp["b1"])
        port.sync(dev)
        setup_s = time.perf_counter() - run.t_start
        setup_parts = {"imports": t_import - run.t_start, "weights": t_weights - t_import,
                       "state": t_built - t_weights,
                       "first_steps": run.t_start + setup_s - t_built}

        # the window; with --trace 1 a block of steps is traced and left out
        # of the window's numbers (the profiler slows the host)
        n_steps, losses, traced, window_s, step_s = 0, [], None, 0.0, []
        traced_steps = 0
        host0 = _host()
        while n_steps == 0 or window_s < run.seconds:
            profiling = run.trace and n_steps == 1 and not traced_steps and dev == "cuda"
            cm = tracing.profile() if profiling else contextlib.nullcontext()
            t0 = time.perf_counter()
            with cm as holder:
                flash.recording = profiling
                for _ in range(traffic["trace_steps"] if profiling else 1):
                    b = next(feed)
                    t1 = time.perf_counter()
                    state, m = step(state, b)
                    port.sync(dev)
                    if not profiling:
                        step_s.append(time.perf_counter() - t1)
                    losses.append(m["loss"])
                flash.recording = False
            if profiling:
                traced = tracing.summarize(holder.prof)
                traced_steps = traffic["trace_steps"]
                del holder
            else:
                window_s += time.perf_counter() - t0
                n_steps += 1
    host = {k: v - host0[k] for k, v in _host().items()}
    device = port.device_info(dev)
    loss_vals = torch.stack(losses).float().cpu()
    failed = int((~torch.isfinite(loss_vals)).sum())
    del state, m, b, losses
    port.free(dev)

    # the warmed step replays the first steps on a fresh copy of the weights
    state, late = first_steps(step, fresh_state(), first, flat0, hp["b1"])
    launched = {k: v - launches0.get(k, 0) for k, v in port.launches().items()}
    del state, step
    port.free(dev)

    # the drawn weights, drawn again from the seed, are still bitwise what
    # the reference starts from
    again = wmod.draw(run.config, run.seed, dev)
    changed = sum(not torch.equal(again[n], flat0[n]) for n in flat0)
    del again

    # the reference follows the first steps from the drawn weights and batches
    t_ref = time.perf_counter()
    want = ref_train.train_steps(run.config, hp, flat0, first, mode="fp32")
    ref_s = time.perf_counter() - t_ref
    checks = compare(prog, want, run.limits)
    checks.update(compare(late, want, run.limits, prefix="replay_"))
    steps_all = 2 * traffic["first_steps"] + n_steps + traced_steps
    expect = (cfg.n_layers * traffic["microbatches"] * steps_all
              if dev == "cuda" and counts.uses_flash(traffic["seq"], traffic["seq"]) else 0)
    checks["flash_launches"] = _exact(launched.get("flash", 0), expect)
    checks["flash_bwd_launches"] = _exact(launched.get("flash_bwd", 0), expect)
    checks["weights_changed"] = _exact(changed, 0)

    tokens = n_steps * traffic["batch"] * traffic["seq"]
    obs = {
        "setup_s": setup_s, "window_s": window_s, "tokens_trained": tokens,
        "model_flops": n_steps * counts.train_flops(run.config, traffic["batch"], traffic["seq"]),
        "spans": {"train.step": step_s}, "trace": traced, "traced_flash": flash.calls,
    }
    notes = {"steps": n_steps, "traced_steps": traced_steps, "reference_s": ref_s,
             "still_leaves": ref_train.still_leaves(want["grad_leaf"]),
             "first_losses": prog["losses"], "replay_losses": late["losses"],
             "reference_losses": want["losses"], "step_ms_median": 1e3 * statistics.median(step_s),
             "setup_parts": setup_parts, "window_host": host}
    return {"attempted": n_steps + traced_steps, "failed": failed, "checks": checks, "obs": obs,
            "device": device, "notes": notes}


def compare(prog: dict, want: dict, limits: dict, prefix: str = "") -> dict:
    """The numbers compared, each with its limit and verdict (named with
    ``prefix``; the limits are the same)."""
    skip = ref_train.still_leaves(want["grad_leaf"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"]))
    gnorm = abs(prog["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    gleaf, _ = ref_train.leaf_gaps(prog["grad_leaf"], want["grad_leaf"])
    uleaf, _ = ref_train.leaf_gaps(prog["update_leaf"], want["update_leaf"], skip)
    out = {}
    for name, value in (("loss_gap", loss), ("grad_norm_gap", gnorm),
                        ("grad_leaf_gap", gleaf), ("update_leaf_gap", uleaf)):
        out[prefix + name] = {"value": value, "limit": limits[name],
                              "ok": bool(value == value and value <= limits[name])}
    return out


def _host() -> dict:
    """The process's CPU seconds, involuntary context switches and the
    main thread's CPU seconds: read around the window, they show whether
    the host held a run back."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "thread_s": time.thread_time(),
            "nivcsw": ru.ru_nivcsw}


def _exact(value: int, expect: int) -> dict:
    return {"value": value, "limit": expect, "ok": value == expect}
