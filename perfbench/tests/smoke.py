"""Smoke-size stand-ins of the benchmark's cells, for CPU tests: the port's
smoke configs in bf16, configuration files written from them, and traffic
cut to a few short requests or rows."""

from __future__ import annotations

import copy
import dataclasses
import json
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def port_config(name: str, **over):
    from repro_torch.configs import get_config

    cfg = get_config(name, smoke=True)
    over = {"dtype_name": "bfloat16", "param_dtype_name": "bfloat16", **over}
    return dataclasses.replace(cfg, **over)


def config_file(cfg, like: str) -> dict:
    """A configuration file for the port's ``cfg``, shaped as ``like``'s."""
    from repro_torch.models import model as model_lib

    base = json.loads((HERE / "configs" / f"{like}.json").read_text())
    c = copy.deepcopy(base)
    c.update(hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
             num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
             head_dim=cfg.head_dim, vocab_size=cfg.vocab, rope_theta=cfg.rope_theta,
             dtype=cfg.dtype_name)
    c["as_run"] = dict(c["as_run"], rope_theta=cfg.rope_theta)
    if cfg.moe_experts:
        c.update(num_experts=cfg.moe_experts, num_experts_per_tok=cfg.moe_topk,
                 moe_intermediate_size=cfg.moe_ff,
                 shared_expert_intermediate_size=cfg.moe_shared_ff)
        c["as_run"]["serve_capacity_factor"] = cfg.moe_capacity_serve
    else:
        c["intermediate_size"] = cfg.d_ff
    tree = model_lib.param_tree(model_lib.abstract_params(cfg), cfg)
    weights = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                old = base["weights"][prefix + k]
                spec = {"shape": list(v.shape), "dtype": str(v.dtype).split(".")[-1]}
                if old.get("init") == "ones":
                    spec["init"] = "ones"
                else:
                    fan_in = v.shape[-2] if prefix + k != "embed" else None
                    if k == "wo":
                        fan_in = v.shape[-3] * v.shape[-2]
                    elif k in ("wq", "wk", "wv"):
                        fan_in = v.shape[1]
                    elif k in ("we_gate", "we_up", "we_down"):
                        fan_in = v.shape[-2]
                    spec["std"] = 0.02 if fan_in is None else fan_in ** -0.5
                weights[prefix + k] = spec

    walk(tree)
    c["weights"] = {n: weights[n] for n in base["weights"]}
    return c


TRAIN = {"runner": "train", "batch": 4, "seq": 32, "microbatches": 2, "first_steps": 3,
         "trace_steps": 2, "hparams": {"peak_lr": 3e-3, "total_steps": 100, "warmup_steps": 2,
                                       "final_frac": 0.1, "weight_decay": 0.1, "clip_norm": 1.0,
                                       "b1": 0.9, "b2": 0.95, "eps": 1e-8}}
SERVE = {"runner": "serve", "slots": 2, "prefill_len": 48, "max_len": 52, "prompt_min": 9,
         "prompt_max": 48, "new_tokens": 4, "batch_requests": 4, "check_requests": 4}


def make_run(kind: str, seed: int = 2**31 + 11, seconds: float = 0.0, limits=None,
             patch=None, **over):
    from perfbench import harness

    if kind == "train":
        cfg = port_config("smollm-135m", **over)
        config, traffic, cell = config_file(cfg, "smollm-135m"), TRAIN, "smollm-135m.train-4k"
    else:
        cfg = port_config("qwen2-moe-a2.7b", moe_capacity_serve=1.25, **over)
        config, traffic, cell = config_file(cfg, "qwen2-moe-a2.7b"), SERVE, \
            "qwen2-moe-a2.7b.serve-long"
    if limits is None:
        limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    return harness.Run(name=cell, cell={"name": cell, "chips": 1}, config=config,
                       traffic=copy.deepcopy(traffic), limits=limits, seed=seed,
                       seconds=seconds, trace=False, device="cpu",
                       t_start=time.perf_counter(), port_config=cfg, patch=patch)
