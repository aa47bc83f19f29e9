"""Batched serving engine: continuous batching over prefill + decode steps.

PyTorch port of the JAX package's ``serve/engine.py``, with the same
semantics.  The step functions come from ``repro_torch.models.model``
(``prefill`` / ``decode_step``); this module adds the scheduling layer:

* **slot-based continuous batching** — a fixed decode batch of ``slots``;
  finished sequences free their slot, queued requests are prefilled into
  the vacant slot's cache lines (``index_copy_`` on the batch axis);
* attention-only architectures prefill one shape: prompts are
  right-padded to ``prefill_len``, and the pad K/V stays masked until real
  tokens overwrite its slots (pad tokens are routed through MoE layers and
  take capacity, as in the reference);
* architectures with a recurrent mixer (Mamba, mLSTM, sLSTM) prefill at
  the prompt's exact length, since pad tokens would run through the
  recurrence; the first new token is sampled from the prefill logits;
* greedy / temperature sampling (an explicit ``torch.Generator`` on the
  engine's device, seeded from ``ServeConfig.seed``);
* per-request max-token and EOS stopping.

The engine runs where its weights are: on the card, unless the caller drew
them on the CPU.  Its requests are token prompts only, as the reference's
are, so it refuses the configs whose prefill needs a modality input
besides the tokens (whisper's ``frames``, llava's ``patches``):
:func:`check_servable` raises ``ValueError`` for them, and they are served
through ``models.model.prefill`` / ``decode_step`` directly.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from ..models import model as model_lib

__all__ = ["Request", "Result", "ServeConfig", "Engine", "check_servable"]


@dataclasses.dataclass
class Request:
    uid: int
    tokens: List[int]  # prompt
    max_new_tokens: int = 16
    eos: Optional[int] = None


@dataclasses.dataclass
class Result:
    uid: int
    tokens: List[int]  # generated continuation
    prompt_len: int
    latency_s: float


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4  # decode batch size
    prefill_len: int = 64  # prefill shape (prompts right-padded)
    max_len: int = 256  # KV-cache capacity
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0


def check_servable(cfg) -> None:
    """Raise ``ValueError`` for a config the engine cannot serve: one whose
    prefill needs encoder frames or image patches, which a token request
    does not carry."""
    need = [name for name, on in (("frames", cfg.is_encoder_decoder),
                                  ("patches", bool(cfg.n_patches))) if on]
    if need:
        raise ValueError(
            f"{cfg.name}: its prefill needs batch[{need[0]!r}] besides the tokens, "
            "and the engine's requests carry tokens only; serve it through "
            "models.model.prefill(params, batch, cfg, max_len) and decode_step"
        )


def _leaves(cache):
    """The cache's tensors, in a fixed order."""
    return [
        t
        for blk in cache["periods"].values()
        for t in blk["mixer"].values()
    ]


class Engine:
    """Continuous-batching engine around one model (``params``, a
    ``Transformer``); it runs on the weights' device."""

    def __init__(self, params, cfg, scfg: ServeConfig) -> None:
        check_servable(cfg)
        self.device = params.device
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self._queue: Deque[Request] = deque()
        self._results: List[Result] = []
        self._gen = torch.Generator(device=self.device).manual_seed(scfg.seed)

        # slot bookkeeping (host side)
        self._slot_req: List[Optional[Request]] = [None] * scfg.slots
        self._slot_pos: np.ndarray = np.zeros(scfg.slots, np.int64)
        self._slot_new: List[List[int]] = [[] for _ in range(scfg.slots)]
        self._slot_t0: List[float] = [0.0] * scfg.slots
        self._last_tok = np.zeros(scfg.slots, np.int64)

        self.cache = model_lib.init_cache(cfg, scfg.slots, scfg.max_len, self.device)
        # recurrent mixers carry state: right-padding would push pad tokens
        # through the recurrence, so those architectures prefill at the
        # prompt's exact length
        self.exact_prefill = any(b.mixer != "attn" for b in cfg.pattern)

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def run(self) -> List[Result]:
        """Drive to completion; returns results in finish order."""
        with torch.inference_mode():
            while self._queue or any(r is not None for r in self._slot_req):
                self._admit()
                self._decode_tick()
        out, self._results = self._results, []
        return out

    # -- internals -----------------------------------------------------------
    def _admit(self) -> None:
        for slot in range(self.scfg.slots):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            self._slot_t0[slot] = time.perf_counter()
            if self.exact_prefill:
                toks = np.asarray([req.tokens], np.int64)
            else:
                toks = np.zeros((1, self.scfg.prefill_len), np.int64)
                toks[0, : len(req.tokens)] = req.tokens
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            logits, cache1 = model_lib.prefill(self.params, batch, self.cfg, self.scfg.max_len)
            # place the prefilled cache lines into this slot
            idx = torch.tensor([slot], device=self.device)
            for full, one in zip(_leaves(self.cache), _leaves(cache1)):
                full.index_copy_(1, idx, one)
            self._slot_req[slot] = req
            self._slot_new[slot] = []
            if self.exact_prefill:
                # the recurrence consumed the prompt once; the first new
                # token comes straight from the prefill logits
                tok0 = int(self._sample(logits)[0])
                self._slot_pos[slot] = len(req.tokens)
                self._last_tok[slot] = tok0
                self._slot_new[slot].append(tok0)
                if req.max_new_tokens <= 1 or tok0 == req.eos:
                    self._finish_slot(slot)
            else:
                # attention caches are idempotent under re-write: the first
                # decode tick re-emits the last prompt token's KV and samples
                # the next token; pad KV entries stay masked until real
                # tokens overwrite their slots.
                self._slot_pos[slot] = len(req.tokens) - 1
                self._last_tok[slot] = req.tokens[-1]

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        logits = logits[:, : self.cfg.vocab]  # drop padded vocab tail
        if self.scfg.temperature <= 0.0:
            return logits.argmax(dim=-1).cpu().numpy()
        probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].cpu().numpy()

    def _decode_tick(self) -> None:
        active = [s for s in range(self.scfg.slots) if self._slot_req[s] is not None]
        if not active:
            return
        # the decode step is batch-uniform in cur_pos; slots may differ ->
        # run per distinct position group, in ascending order
        positions = {int(self._slot_pos[s]) for s in active}
        for pos in sorted(positions):
            group = [s for s in active if int(self._slot_pos[s]) == pos]
            toks = torch.from_numpy(self._last_tok[:, None].copy()).to(self.device)
            logits, new_cache = model_lib.decode_step(
                self.params, toks, self.cache, pos, self.cfg
            )
            # only the group's slots advance; the others keep their rows
            idx = torch.tensor(group, device=self.device)
            for old, new in zip(_leaves(self.cache), _leaves(new_cache)):
                old.index_copy_(1, idx, new.index_select(1, idx))
            nxt = self._sample(logits)
            for s in group:
                self._advance_slot(s, int(nxt[s]))

    def _advance_slot(self, slot: int, tok: int) -> None:
        req = self._slot_req[slot]
        self._slot_new[slot].append(tok)
        self._slot_pos[slot] += 1
        self._last_tok[slot] = tok
        if len(self._slot_new[slot]) >= req.max_new_tokens or (
            req.eos is not None and tok == req.eos
        ):
            self._finish_slot(slot)

    def _finish_slot(self, slot: int) -> None:
        req = self._slot_req[slot]
        self._results.append(
            Result(
                uid=req.uid,
                tokens=list(self._slot_new[slot]),
                prompt_len=len(req.tokens),
                latency_s=time.perf_counter() - self._slot_t0[slot],
            )
        )
        self._slot_req[slot] = None
