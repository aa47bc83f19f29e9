"""Serving CLI: ``python -m repro_torch.launch.serve --arch smollm-135m``.

Boots the continuous-batching engine with random weights (a
``torch.Generator`` seeded with ``--seed``) and drives a synthetic request
trace through it (prompt lengths drawn from a seeded distribution),
reporting throughput and per-request latency.  Runs on the card unless
``--device cpu`` is given.  whisper-medium and llava-next-mistral-7b need
frames / patches besides the tokens, which the engine's requests do not
carry: for them it raises ``ValueError`` before drawing any weight.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.engine import check_servable

__all__ = ["main"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prefill-len", type=int, default=32)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    check_servable(cfg)
    params = model_lib.init_params(cfg, seed=args.seed, device=args.device)
    eng = Engine(
        params,
        cfg,
        ServeConfig(
            slots=args.slots,
            prefill_len=args.prefill_len,
            max_len=args.max_len,
            temperature=args.temperature,
            seed=args.seed,
        ),
    )
    rng = np.random.RandomState(args.seed)
    for uid in range(args.requests):
        plen = int(rng.randint(4, args.prefill_len))
        toks = [int(t) for t in rng.randint(1, cfg.vocab, size=plen)]
        eng.submit(Request(uid=uid, tokens=toks, max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    results = eng.run()
    dt = time.perf_counter() - t0
    gen = sum(len(r.tokens) for r in results)
    lat = sorted(r.latency_s for r in results)
    print(
        f"[serve] {cfg.name} on {eng.device}: {len(results)} requests, {gen} "
        f"tokens in {dt:.2f}s ({gen/dt:.1f} tok/s); "
        f"p50 latency {lat[len(lat)//2]*1e3:.0f} ms, "
        f"p100 {lat[-1]*1e3:.0f} ms"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
