"""What the runners take from the port (``repro_torch``): its model config,
checked against the configuration file's widths; its weights loaded with the
benchmark's own tensors; its attention-kernel calls and launch counters."""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch


def model_config(run):
    """The port's config of ``run.config["port_config"]`` (or the one a
    test gives), refused unless every width is the configuration file's."""
    if run.port_config is not None:
        cfg = run.port_config
    else:
        from repro_torch.configs import get_config

        cfg = get_config(run.config["port_config"])
    c, as_run = run.config, run.config.get("as_run", {})
    want = {
        "d_model": c["hidden_size"], "n_layers": c["num_hidden_layers"],
        "n_heads": c["num_attention_heads"], "n_kv_heads": c["num_key_value_heads"],
        "head_dim": c["head_dim"], "vocab": c["vocab_size"],
        "tie_embeddings": c["tie_word_embeddings"],
        "rope_theta": as_run.get("rope_theta", c["rope_theta"]),
        "dtype_name": c["dtype"], "param_dtype_name": c["dtype"],
    }
    if c.get("num_experts"):
        want.update(moe_experts=c["num_experts"], moe_topk=c["num_experts_per_tok"],
                    moe_ff=c["moe_intermediate_size"],
                    moe_shared_ff=c["shared_expert_intermediate_size"],
                    moe_capacity_serve=as_run["serve_capacity_factor"])
    else:
        want.update(d_ff=c["intermediate_size"])
    bad = {k: (getattr(cfg, k), v) for k, v in want.items() if getattr(cfg, k) != v}
    if bad:
        raise ValueError(f"the port's {cfg.name} differs from the configuration file: {bad}")
    return cfg


def transformer(flat: Dict[str, torch.Tensor], cfg):
    """The port's ``Transformer`` whose parameters are views of ``flat``
    (the port's stacked tree by dotted name; layer ``i`` is index ``i``)."""
    from torch import nn

    from repro_torch.models import model as model_lib

    params = model_lib.Transformer(cfg, device="meta")
    for name, _ in list(params.named_parameters()):
        path, period = model_lib.tree_path(name, cfg)
        t = flat[".".join(path)]
        t = t if period is None else t[period]
        *owner, leaf = name.split(".")
        mod = params.get_submodule(".".join(owner)) if owner else params
        mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
    return params


class FlashCalls:
    """Shapes of the port's flash calls while ``recording``:
    ``{"fwd": [...], "bwd": [...]}``, each ``(b, sq, kv_len, h, kh, d,
    causal, window, element size)``; a differentiable call is a forward
    and, later, a backward of the same shape."""

    def __init__(self) -> None:
        self.recording = False
        self.calls: Dict[str, List[tuple]] = {"fwd": [], "bwd": []}

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.kernels import ops

        saved = ops.flash_attention, ops.flash_attention_fn

        def shape(q, k, causal, window, kv_len):
            b, sq, h, d = q.shape
            return (b, sq, kv_len if kv_len is not None else k.shape[1], h, k.shape[2], d,
                    bool(causal), window, q.element_size())

        def fwd(q, k, v, *, causal=True, window=None, kv_len=None):
            if self.recording:
                self.calls["fwd"].append(shape(q, k, causal, window, kv_len))
            return saved[0](q, k, v, causal=causal, window=window, kv_len=kv_len)

        def fwd_bwd(q, k, v, *, causal=True, window=None, kv_len=None):
            if self.recording:
                s = shape(q, k, causal, window, kv_len)
                self.calls["fwd"].append(s)
                self.calls["bwd"].append(s)
            return saved[1](q, k, v, causal=causal, window=window, kv_len=kv_len)

        ops.flash_attention, ops.flash_attention_fn = fwd, fwd_bwd
        try:
            yield self
        finally:
            ops.flash_attention, ops.flash_attention_fn = saved


def launches() -> Dict[str, int]:
    """The port's flash launch counters (``kernels/flash.py``)."""
    from repro_torch.kernels import flash

    return dict(flash.launches)


def device_info(device: str, count: int = 1) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def free(device: str) -> None:
    import gc

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


class Calls:
    """The engine's calls of ``models.model.prefill`` / ``decode_step``, and
    the expert picks (``models.moe.route``) each made, while installed.

    Prefill ``i`` of the window is the ``i``-th request submitted (the
    engine admits in order); the picks of the prefills in ``keep`` are
    kept, and, while ``recording``, every decode call's, with its position
    and input tokens, so that the reference can follow the port's routing
    afterwards.  Every decode call is counted (``decode_calls``).  ``sync``
    times each prefill between two synchronises (spans)."""

    def __init__(self, keep=(), spans=None, sync=None) -> None:
        self.keep = set(keep)
        self.spans, self.sync = spans, sync
        self.recording = False
        self.prefills = 0
        self.decode_calls = 0
        self.prefill_routes: Dict[int, list] = {}
        self.decodes: List[dict] = []
        self._into = None

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.models import model as model_lib
        from repro_torch.models import moe

        saved = model_lib.prefill, model_lib.decode_step, moe.route

        def prefill(*a, **k):
            i = self.prefills
            self.prefills += 1
            self._into = self.prefill_routes.setdefault(i, []) if i in self.keep else None
            try:
                if self.spans is None:
                    return saved[0](*a, **k)
                with self.spans.span("model.prefill", self.sync):
                    return saved[0](*a, **k)
            finally:
                self._into = None

        def decode_step(params, token, cache, cur_pos, cfg):
            self.decode_calls += 1
            if self.recording:
                entry = {"pos": int(cur_pos), "tokens": token, "after": self.prefills,
                         "routes": []}
                self.decodes.append(entry)
                self._into = entry["routes"]
            try:
                return saved[1](params, token, cache, cur_pos, cfg)
            finally:
                self._into = None

        def route(probs, k, cap):
            out = saved[2](probs, k, cap)
            if self._into is not None:
                self._into.append((out[1], out[3]))  # picks, kept
            return out

        model_lib.prefill, model_lib.decode_step, moe.route = prefill, decode_step, route
        try:
            yield self
        finally:
            model_lib.prefill, model_lib.decode_step, moe.route = saved

    def routes(self, index: int, prompt: list, served: list) -> dict:
        """The picks of request ``index`` (its prefill's, ``(sel [T, k],
        keep [T, k])`` a layer, and ``sel [n, k]`` a layer of its decode
        steps), found by the steps' positions and input tokens in one slot
        row; raises ``LookupError`` if they are not all there."""
        if index not in self.prefill_routes:
            raise LookupError(f"prefill {index} was not recorded")
        pre = [(s[0], kp[0]) for s, kp in self.prefill_routes[index]]
        inputs = [prompt[-1], *served[:-1]]
        steps, start = [], index + 1
        rows = None
        for i, tok in enumerate(inputs):
            pos = len(prompt) - 1 + i
            for j, d in enumerate(self.decodes):
                if d["after"] < start or d["pos"] != pos or (steps and j <= steps[-1][0]):
                    continue
                hit = {r for r, t in enumerate(d["tokens"][:, 0].tolist()) if t == tok}
                hit = hit if rows is None else hit & rows
                if hit:
                    rows = hit
                    steps.append((j, d))
                    break
            else:
                raise LookupError(f"decode step at {pos} of prefill {index} not found")
        row = min(rows)
        layers = len(steps[0][1]["routes"])
        dec = [torch.stack([d["routes"][layer][0][0, row] for _, d in steps])
               for layer in range(layers)]
        return {"prefill": pre, "decode": dec}
