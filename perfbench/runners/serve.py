"""The serving runner: the port's continuous-batching ``Engine``
(``repro_torch.serve.engine``) on the benchmark's seeded weights, driven
through its public ``submit`` / ``run`` only.

The request stream comes from the seed.  Every batch of
``traffic["batch_requests"]`` requests holds the same prompt lengths
(evenly spread over ``[prompt_min, prompt_max]``), in an order and with
token ids drawn from the seed, so each seed offers the same work.  Set-up
builds the engine, serves one warm-up request of the longest prompt, and
draws from the seed the ``traffic["check_requests"]`` requests that will
be compared, among the first batches (which every window serves), the
longest prompt among them.  The window queues a batch, calls ``run`` (which
drains the queue), and does so again until ``--seconds`` have passed and
those first batches are served; every
request ``run`` returned counts, over the summed wall time of those calls.
The runner counts every ``models.model.decode_step`` call; with ``--trace
1`` it also times each ``models.model.prefill`` (synchronised on both sides)
and traces the second ``run`` call on the device, leaving that call out of
the window's numbers.

Once the window has closed and the engine and its weights are freed, the
weights are drawn again from the seed (so nothing the port did to its own
tensors reaches the reference), and the compared requests are run through
the plain reference, following the expert picks the port made for them
(recorded in the window for those requests alone), which are checked by
themselves; see :func:`judge`.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import math
import random
import resource
import time

import torch

from perfbench import counts, port, tracing
from perfbench import weights as wmod
from perfbench.reference.decoder import Decoder, moe_capacity, route_margin, strict


def lengths(traffic: dict) -> list:
    """The prompt lengths of one batch: evenly spread, each batch alike."""
    n, lo, hi = traffic["batch_requests"], traffic["prompt_min"], traffic["prompt_max"]
    return [lo + ((2 * i + 1) * (hi - lo + 1)) // (2 * n) for i in range(n)]


def requests(traffic: dict, vocab: int, seed: int):
    """Endless batches of ``(uid, prompt)``: each batch's lengths shuffled
    and its token ids drawn (1 .. vocab - 1) from the seed."""
    rng = random.Random(int(seed))
    gen = torch.Generator().manual_seed(int(seed) ^ 0x7E57)
    uid = 0
    while True:
        lens = lengths(traffic)
        rng.shuffle(lens)
        batch = []
        for n in lens:
            batch.append((uid, torch.randint(1, vocab, (n,), generator=gen).tolist()))
            uid += 1
        yield batch


def run(run) -> dict:
    if run.patch:
        run.patch()
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    dev, traffic = run.device, run.traffic
    cfg = port.model_config(run)
    t_import = time.perf_counter()
    flat = wmod.draw(run.config, run.seed, dev)
    params = port.transformer(flat, cfg)
    port.sync(dev)
    t_weights = time.perf_counter()
    scfg = ServeConfig(slots=traffic["slots"], prefill_len=traffic["prefill_len"],
                       max_len=traffic["max_len"], temperature=0.0, seed=int(run.seed) % 2**63)
    engine = Engine(params, cfg, scfg)
    new = traffic["new_tokens"]
    stream = requests(traffic, cfg.vocab, run.seed)
    ahead = [next(stream) for _ in range(math.ceil(traffic["check_requests"]
                                                   / traffic["batch_requests"]))]
    first = {uid: toks for batch in ahead for uid, toks in batch}
    check = sample(first, traffic["check_requests"], run.seed)
    spans = tracing.Spans()
    flash = port.FlashCalls()
    port.sync(dev)
    t_built = time.perf_counter()

    # set-up: one request of the longest prompt warms every shape
    engine.submit(Request(uid=-1, tokens=[1] * traffic["prompt_max"], max_new_tokens=new))
    engine.run()
    port.sync(dev)
    launches0 = port.launches()
    setup_s = time.perf_counter() - run.t_start
    setup_parts = {"imports": t_import - run.t_start, "weights": t_weights - t_import,
                   "engine": t_built - t_weights, "warm_up": run.t_start + setup_s - t_built}

    moe = bool(run.config.get("num_experts"))
    calls = port.Calls(keep=check if moe else (), spans=spans if run.trace else None,
                       sync=lambda: port.sync(dev))
    prompts, results, counted, window_s, traced, n_calls = {}, [], [], 0.0, None, 0
    decode_calls, per_call = 0, []
    with flash.installed(), calls.installed():
        for batch in itertools.chain(ahead, stream):
            if n_calls >= len(ahead) and window_s >= run.seconds:
                break
            for uid, toks in batch:
                prompts[uid] = toks
                engine.submit(Request(uid=uid, tokens=toks, max_new_tokens=new))
            # the decode steps of the compared requests are recorded in the
            # calls that serve them; with --trace 1 the second call is
            # traced, and left out of the window's numbers (the profiler
            # slows the host)
            calls.recording = moe and any(uid in calls.keep for uid, _ in batch)
            profiling = run.trace and n_calls == 1 and dev == "cuda"
            cm = tracing.profile() if profiling else contextlib.nullcontext()
            d0, h0 = calls.decode_calls, _host()
            t0 = time.perf_counter()
            with cm as holder:
                flash.recording = profiling
                got = engine.run()
                port.sync(dev)
                flash.recording = False
            dt = time.perf_counter() - t0
            calls.recording = False
            results.extend(got)
            n_calls += 1
            if profiling:
                traced = tracing.summarize(holder.prof)
                del holder
            else:
                window_s += dt
                counted.extend(got)
                decode_calls += calls.decode_calls - d0
                per_call.append(dict({k: v - h0[k] for k, v in _host().items()}, wall_s=dt))
    launched = {k: v - launches0.get(k, 0) for k, v in port.launches().items()}
    device = port.device_info(dev)
    del engine, params, flat
    port.free(dev)

    done = {r.uid: r for r in results if len(r.tokens) == new}
    failed = len(prompts) - len(done)
    t_ref = time.perf_counter()
    flat = wmod.draw(run.config, run.seed, dev)
    got_checks = judge(run, flat, prompts, done, calls, check)
    ref_s = time.perf_counter() - t_ref
    checks = {}
    for name, value in got_checks.items():
        if name in run.limits:
            limit = run.limits[name]
            checks[name] = {"value": value, "limit": limit,
                            "ok": bool(value == value and value <= limit)}
    if "unmatched" in got_checks:  # requests whose picks the recorder could not find
        checks["unmatched"] = {"value": got_checks["unmatched"], "limit": 0,
                               "ok": got_checks["unmatched"] == 0}
    expect = (cfg.n_layers * len(prompts) if dev == "cuda"
              and counts.uses_flash(traffic["prefill_len"], traffic["prefill_len"]) else 0)
    checks["flash_launches"] = {"value": launched.get("flash", 0), "limit": expect,
                                "ok": launched.get("flash", 0) == expect}

    window = [r for r in counted if len(r.tokens) == new]
    gen_tokens = sum(len(r.tokens) for r in window)
    obs = {
        "setup_s": setup_s, "window_s": window_s, "tokens_generated": gen_tokens,
        "latencies": [r.latency_s for r in window],
        "model_flops": sum(counts.serve_flops(run.config, r.prompt_len, len(r.tokens))
                           for r in window),
        "spans": dict(spans.spans), "trace": traced, "traced_flash": flash.calls,
        "decode_calls": decode_calls if run.trace else None,
    }
    notes = {"requests": len(done), "window_requests": len(window), "run_calls": n_calls,
             "checked_tokens": got_checks["tokens"], "checked_requests": got_checks["requests"],
             "reference_s": ref_s, "decode_calls": decode_calls, "setup_parts": setup_parts,
             "calls": per_call}
    return {"attempted": len(prompts), "failed": failed, "checks": checks, "obs": obs,
            "device": device, "notes": notes}


def _host() -> dict:
    """The process's CPU seconds, the main thread's, involuntary context
    switches and garbage collections: read around each call, they show
    whether the host held a call back."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "thread_s": time.thread_time(),
            "nivcsw": ru.ru_nivcsw, "gc": sum(g["collections"] for g in gc.get_stats())}


def sample(prompts: dict, n: int, seed: int) -> list:
    """``n`` uids of ``prompts`` drawn from the seed, the longest prompt's
    first."""
    uids = sorted(prompts)
    if not uids:
        return []
    longest = max(uids, key=lambda u: (len(prompts[u]), -u))
    rest = [u for u in uids if u != longest]
    random.Random(int(seed) ^ 0xC4EC).shuffle(rest)
    return [longest] + rest[: max(n - 1, 0)]


def judge(run, flat: dict, prompts: dict, done: dict, calls, check: list,
          mode: str = "") -> dict:
    """The numbers compared over the served tokens of the requests of
    ``check`` that completed.  The float32 reference follows the port's
    expert picks (``calls``): the served tokens' widest gap below the
    reference's best logit
    (``served_logit_gap``); how far each pick is from a top-k of the
    reference's router probabilities (``route_margin``, near-ties > 0);
    and the kept picks that the capacity rule, applied to the port's own
    picks, contradicts (``drop_mismatch``).  With ``mode="fp8"`` the
    control takes the port's place: its own first token at each served
    position, and its own top-k, are read against the float32 reference."""
    traffic = run.traffic
    uids = [u for u in check if u in done]
    moe = bool(run.config.get("num_experts"))
    cap = moe_capacity(traffic["prefill_len"], run.config.get("num_experts_per_tok", 1),
                       max(run.config.get("num_experts", 1), 1),
                       run.config.get("as_run", {}).get("serve_capacity_factor", 1.0))
    ref = Decoder(run.config, flat, "fp32")
    low = Decoder(run.config, flat, mode) if mode else None
    out = {"served_logit_gap": float("-inf"), "tokens": 0, "requests": 0}
    if moe:
        out.update(route_margin=float("-inf"), drop_mismatch=0, unmatched=0)
    with strict():
        for uid in uids:
            p, s = prompts[uid], done[uid].tokens
            routes = None
            if moe:
                try:
                    routes = calls.routes(uid, p, s)
                except LookupError:
                    out["unmatched"] += 1
                    continue
            want = ref.served(p, s, traffic["prefill_len"], cap, routes)
            logits = want["logits"]
            if low is not None:
                lo = low.served(p, s, traffic["prefill_len"], cap, routes)
                toks = lo["logits"].argmax(-1)
            else:
                toks = torch.as_tensor(s, device=logits.device)
            gap = logits.max(-1).values - logits.gather(-1, toks[:, None])[:, 0]
            out["served_logit_gap"] = max(out["served_logit_gap"], float(gap.max()))
            if moe:
                mine = want["info"]["prefill"] + want["info"]["decode"]
                picks = ((lo["info"]["prefill"] + lo["info"]["decode"]) if low is not None
                         else mine)
                for m, pk in zip(mine, picks):
                    sel = pk["own"] if low is not None else m["sel"]
                    out["route_margin"] = max(out["route_margin"], route_margin(sel, m["probs"]))
                    out["drop_mismatch"] += m.get("mismatch", 0)
            out["tokens"] += len(s)
            out["requests"] += 1
    if not out["requests"]:
        out["served_logit_gap"] = float("nan")
    return out
