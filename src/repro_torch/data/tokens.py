"""Synthetic LM token pipeline (a copy of the JAX package's ``data/tokens.py``:
numpy only, so its batches are bit-identical to the reference's).

Deterministic, seekable, host-side generator producing ``{tokens, labels}``
batches (plus frame/patch stubs for the audio/vlm archs).  Design points a
production input pipeline needs and this one honours:

* **deterministic resume** — ``batch_at(step)`` is a pure function of
  (seed, step): a restarted job re-reads exactly the batches it would have
  seen, with no shared iterator state to checkpoint;
* **shard-addressable** — ``batch_at(step, shard, num_shards)`` slices the
  global batch so each data-parallel host loads only its rows;
* **learnable structure** — tokens come from a Zipf-weighted order-2 Markov
  chain, so cross-entropy falls well below the uniform floor and e2e
  training examples show real learning curves (a uniform stream would pin
  loss at ln V).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_frames: int = 0  # whisper stub frontend
    n_patches: int = 0  # llava stub frontend
    d_model: int = 0  # embed dim for the stubs
    branch: int = 32  # Markov successors per state

    def __post_init__(self) -> None:
        rng = np.random.RandomState(self.seed)
        # order-2 Markov chain: state = (prev % 256) -> `branch` successors
        # with Zipf weights.  256 states keeps the table tiny but the
        # structure rich enough to be learnable.
        self._succ = rng.randint(
            0, self.vocab, size=(256, self.branch)
        ).astype(np.int64)
        w = 1.0 / np.arange(1, self.branch + 1) ** 1.1
        self._w = (w / w.sum()).astype(np.float64)

    def _rows(self, step: int, rows: np.ndarray) -> np.ndarray:
        """Token matrix [len(rows), seq_len+1] for the given global rows."""
        out = np.empty((len(rows), self.seq_len + 1), dtype=np.int64)
        for i, r in enumerate(rows):
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + step * 131 + int(r)) % (2**31 - 1)
            )
            toks = np.empty(self.seq_len + 1, dtype=np.int64)
            toks[0] = rng.randint(self.vocab)
            draws = rng.choice(self.branch, size=self.seq_len, p=self._w)
            jitter = rng.rand(self.seq_len) < 0.05  # 5% noise tokens
            noise = rng.randint(0, self.vocab, size=self.seq_len)
            for t in range(self.seq_len):
                state = toks[t] % 256
                toks[t + 1] = (
                    noise[t] if jitter[t] else self._succ[state, draws[t]]
                )
            out[i] = toks
        return out

    def batch_at(
        self, step: int, shard: int = 0, num_shards: int = 1
    ) -> Dict[str, np.ndarray]:
        assert self.global_batch % num_shards == 0
        per = self.global_batch // num_shards
        rows = np.arange(shard * per, (shard + 1) * per)
        toks = self._rows(step, rows)
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        rng = np.random.RandomState((self.seed + 7) * 2654435761 % (2**31 - 1) + step)
        if self.n_frames:
            batch["frames"] = rng.randn(per, self.n_frames, self.d_model).astype(
                np.float32
            )
        if self.n_patches:
            batch["patches"] = rng.randn(
                per, self.n_patches, self.d_model
            ).astype(np.float32)
        return batch

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
