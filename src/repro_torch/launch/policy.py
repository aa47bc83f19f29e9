"""Per-(arch × shape) sharding policies — thin façade over
``repro_torch.sharding`` (PyTorch port of the JAX package's
``launch/policy.py``).

The logical-axis machinery lives in ``repro_torch.sharding`` (model code
imports it without touching the launch layer); this module re-exports it
for launcher-side use and owns the *named* policy presets.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..sharding import (
    SERVE_RULES,
    TRAIN_RULES,
    AxisRules,
    ShardingPolicy,
    batch_specs,
    cache_specs,
    constrain,
    param_specs,
    state_specs,
    tree_logical_specs,
    use_policy,
)

__all__ = [
    "AxisRules",
    "PRESETS",
    "SERVE_RULES",
    "ShardingPolicy",
    "TRAIN_RULES",
    "batch_specs",
    "cache_specs",
    "constrain",
    "make_policy",
    "param_specs",
    "state_specs",
    "tree_logical_specs",
    "use_policy",
]

#: Named rule-set variants.  Keys are preset names; values are overrides
#: applied to the kind's base rules.
PRESETS: Dict[str, Dict] = {
    "baseline": {},
    # decode long-context: spread the KV cache over data too (batch=1 cells)
    "kv_data_model": {"kv_seq": ("data", "model")},
    # training: put sequence (context) parallel over model instead of TP
    "seq_over_model": {"seq": "model", "ffn": None, "heads": None},
    # training: pure FSDP (no TP)
    "fsdp_only": {"heads": None, "ffn": None, "vocab": None, "expert": None},
    # serving: replicate weights fully, shard batch only
    "replicated_weights": {"heads": None, "ffn": None, "vocab": None},
}


def make_policy(mesh, kind: str, preset: str = "baseline",
                extra: Optional[Dict] = None) -> ShardingPolicy:
    base = TRAIN_RULES if kind == "train" else SERVE_RULES
    rules = AxisRules(base).override(**PRESETS.get(preset, {}))
    if extra:
        rules = rules.override(**extra)
    return ShardingPolicy(mesh, rules)
