"""Faults planted under the timed path, for the tests that show each one
turns ``correct`` false, and the control (the reference in the precision
below the configuration's, put in the port's place).  Nothing here runs in
a benchmark run."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name: str):
    """Patch the port so that the fault ``name`` happens, for the body."""
    from repro_torch.models import model as model_lib
    from repro_torch.serve import engine as engine_mod
    from repro_torch.train import train_step as ts

    saved = []

    def put(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    make = ts.make_train_step
    if name == "state_unchanged":  # a step that returns its state as it was
        def make_unchanged(*a, **k):
            step = make(*a, **k)

            def unchanged(state, batch):
                _, metrics = step(state, batch)
                return state, metrics
            return unchanged
        put(ts, "make_train_step", make_unchanged)
    elif name == "half_batch":  # half the rows left out, the mean over the rest
        def make_half(*a, **k):
            step = make(*a, **k)

            def half(state, batch):
                n = len(batch["tokens"]) // 2
                return step(state, {key: v[:n] for key, v in batch.items()})
            return half
        put(ts, "make_train_step", make_half)
    elif name == "half_batch_warm":  # half the rows left out from the fourth call on
        def make_half_warm(*a, **k):
            step, seen = make(*a, **k), [0]

            def half_warm(state, batch):
                seen[0] += 1
                if seen[0] > 3:
                    n = len(batch["tokens"]) // 2
                    batch = {key: v[:n] for key, v in batch.items()}
                return step(state, batch)
            return half_warm
        put(ts, "make_train_step", make_half_warm)
    elif name == "weights_in_place":  # the engine scales its matrices in place
        init = engine_mod.Engine.__init__

        def scaled(self, params, *a, **k):
            init(self, params, *a, **k)
            for p in params.parameters():
                if p.dim() >= 2:
                    p.data.mul_(1.5)
        put(engine_mod.Engine, "__init__", scaled)
    elif name == "token_altered":  # the sampled token changed where it is produced
        sample = engine_mod.Engine._sample

        def altered(self, logits):
            return (sample(self, logits) + 1) % self.cfg.vocab
        put(engine_mod.Engine, "_sample", altered)
    elif name == "cache_unchanged":  # a decode step that leaves its cache as it was
        decode = model_lib.decode_step

        def stale(params, token, cache, cur_pos, cfg):
            logits, _ = decode(params, token, cache, cur_pos, cfg)
            return logits, cache
        put(model_lib, "decode_step", stale)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
