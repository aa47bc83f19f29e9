"""The benchmark's harness on the CPU: discovery by name, the contract's
shape of BENCHMARK.json and of the result line, the frozen counts, the MFU
arithmetic, the reference against the port's CPU path, and the check on
imported modules."""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import chip_smoke
from perfbench import counts, harness, readers, tracing
from perfbench import weights as wmod
from perfbench.reference import train as ref_train
from perfbench.reference.decoder import Decoder, moe_capacity, route_margin, strict
from perfbench.tests import smoke

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + METRICS
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS), m["name"]


@pytest.mark.parametrize("metric", [m for m in METRICS if "roofline" in m])
def test_roofline_readers_name_kernels_the_port_defines(metric):
    """Each roofline reader's kernel names are device functions of the
    port's CUDA sources, as the trace would name them."""
    reader = harness.load_module(ROOT / "perfbench" / "metrics" / f"{metric}.py", "r")
    sources = "".join(p.read_text() for p in (ROOT / "src/repro_torch/csrc").glob("*.cu"))
    for name in reader.KERNELS:
        assert re.search(rf"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?{name}\s*\(",
                         sources), name


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in harness.metrics_for(BENCH, cell, False)}
    layers = harness.metrics_for(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = harness.find_cell(BENCH, cell)
    config, traffic, limits = harness.cell_files(entry)
    assert (harness.HERE / "runners" / f"{traffic['runner']}.py").exists()
    assert config["weights"] and limits
    assert config["reduced"] == next(c for c in BENCH["configs"]
                                     if c["name"] == entry["config"])["reduced"]


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    mod = harness.load_module(harness.HERE / "metrics" / f"{metric}.py", "m")
    assert mod.read({}) is None  # nothing to read: left out, never 0


@pytest.mark.parametrize("shape", [
    (1, 4096, 4096, 9, 3, 64, True, None, 2),
    (4, 4096, 4096, 9, 3, 64, True, None, 2),
    (1, 4096, 4096, 16, 16, 128, True, None, 2),
    (2, 1000, 3001, 8, 2, 64, False, None, 4),
    (1, 4096, 4096, 32, 8, 128, True, 1024, 2),
    (1, 333, 200, 2, 2, 256, True, None, 4),
])
def test_frozen_counts_match_chip_smoke(shape):
    assert counts.flash_work(*shape) == chip_smoke.flash_work(*shape)
    b, sq, kv, h, kh, d, causal, window, size = shape
    assert counts.visible_pairs(sq, kv, causal, window) == chip_smoke.visible_pairs(
        sq, kv, causal, window)
    nbytes, ops = counts.flash_bwd_work(*shape)
    assert ops == 2.5 * 4 * d * h * b * chip_smoke.visible_pairs(sq, kv, causal, window)
    assert nbytes == 4 * b * sq * h * d * size + 4 * b * kv * kh * d * size + 2 * b * h * sq * 4


def test_frozen_counts_by_hand():
    assert counts.visible_pairs(4, 4, True) == 10
    assert counts.visible_pairs(4, 4, False) == 16
    assert counts.visible_pairs(5, 5, True, 2) == 9
    assert counts.visible_pairs(3, 2, True) == 5
    assert counts.flash_work(1, 2, 2, 1, 1, 4, True, None, 2) == (2 * 2 * 4 * 2 * 2, 4 * 4 * 3)
    assert counts.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert counts.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert counts.uses_flash(2049, 2049) and not counts.uses_flash(2048, 2048)


def test_mfu_arithmetic_by_hand():
    smol = harness.load_json(harness.HERE / "configs" / "smollm-135m.json")
    per_layer = 576 * 576 * 2 + 576 * 192 * 2 + 3 * 576 * 1536
    assert counts.layer_weights(smol) == per_layer
    dense = 6 * (30 * per_layer + 576 * 49152) * 16 * 4096
    attn = 3 * 4 * 64 * 9 * 30 * 16 * (4096 * 4097 // 2)
    assert counts.train_flops(smol, 16, 4096) == dense + attn
    assert counts.train_flops(smol, 16, 4096) / 65536 == pytest.approx(1.2317e9, rel=1e-4)
    qwen = harness.load_json(harness.HERE / "configs" / "qwen2-moe-a2.7b.json")
    layer = 4 * 2048 * 2048 + 2048 * 60 + 4 * 3 * 2048 * 1408 + 3 * 2048 * 5632
    assert counts.layer_weights(qwen) == layer
    n = 3000 + 3
    want = 2 * 24 * layer * n + 2 * 2048 * 151936 * 4 + 4 * 128 * 16 * 24 * n * (n + 1) // 2
    assert counts.serve_flops(qwen, 3000, 4) == want
    obs = {"window_s": 2.0, "model_flops": 989e12}
    assert readers.mfu(obs) == pytest.approx(50.0)


def test_quantile_and_rate():
    vals = list(range(1, 101))
    assert readers.quantile(vals, 0.5) == pytest.approx(statistics.median(vals))
    assert readers.quantile(vals, 0.9) == pytest.approx(90.1)
    assert readers.quantile([], 0.9) is None
    assert readers.rate({"window_s": 4.0, "tokens_trained": 10.0}, "tokens_trained") == 2.5


def test_roofline_reader_from_trace_names():
    shape = (4, 4096, 4096, 9, 3, 64, True, None, 2)
    bound = counts.bound_s(*counts.flash_work(*shape))
    obs = {"trace": {"device_s": {"void flash_bf16_kernel<64>(CUtensorMap, Args)": 4 * bound,
                                  "ampere_bf16_gemm": 1.0},
                     "window_s": 2.0, "busy_s": 1.5},
           "traced_flash": {"fwd": [shape, shape], "bwd": []}}
    assert readers.roofline(obs, "fwd", ("flash_bf16_kernel",)) == pytest.approx(50.0)
    assert readers.roofline(obs, "fwd", ("flash_tf32_kernel",)) is None
    assert readers.roofline(obs, "bwd", ("bwd_bf16_kernel",)) is None
    assert readers.idle(obs) == pytest.approx(25.0)


class _Ev:
    def __init__(self, name, dev, s, e):
        self._n, self._d, self._s, self._e = name, dev, s, e

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


def test_trace_summary_union_and_gap_labels():
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = [_Ev(tracing.WINDOW, cpu, 0, 100), _Ev(tracing.WINDOW, gpu, 0, 100),
           _Ev("aten::mm", cpu, 5, 30),
           _Ev("aten::copy_", cpu, 40, 70), _Ev("cudaLaunchKernel", cpu, 41, 45),
           _Ev("k1", gpu, 10, 20), _Ev("k2", gpu, 15, 40), _Ev("k1", gpu, 60, 90),
           _Ev("k3", gpu, 95, 120)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    s = tracing.summarize(prof)
    ns = 1e-9
    assert s["window_s"] == pytest.approx(100 * ns)
    assert s["busy_s"] == pytest.approx((30 + 30 + 5) * ns)
    assert s["device_s"]["k1"] == pytest.approx(40 * ns)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(10 * ns)  # 0-10, middle 5: inside mm
    assert gaps["aten::copy_"] == pytest.approx(20 * ns)  # 40-60
    assert gaps["host idle"] == pytest.approx(5 * ns)  # 90-95


def test_forbidden_modules_compares_whole_top_level_names():
    allowed = ["repro_torch", "repro_torch.models", "jaxtyping", "reprox", "torch"]
    banned = ["repro", "repro.core", "jax", "jax.numpy", "jaxlib", "flax"]
    assert harness.forbidden_modules(allowed) == []
    assert harness.forbidden_modules(allowed + banned) == sorted(banned)


def test_weights_seeded_and_shaped():
    cfg = smoke.port_config("qwen2-moe-a2.7b")
    config = smoke.config_file(cfg, "qwen2-moe-a2.7b")
    a = wmod.draw(config, 2**31 + 3, "cpu")
    b = wmod.draw(config, 2**31 + 3, "cpu")
    c = wmod.draw(config, 7, "cpu")
    assert list(a) == list(config["weights"])
    for n, spec in config["weights"].items():
        assert list(a[n].shape) == spec["shape"] and str(a[n].dtype) == "torch." + spec["dtype"]
        assert torch.equal(a[n], b[n])
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["final_norm.scale"], torch.ones_like(a["final_norm.scale"]))


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_offers_every_seed_the_same_work(cell):
    from perfbench.runners import serve, train  # noqa: F401

    _, traffic, _ = harness.cell_files(harness.find_cell(BENCH, cell))
    if traffic["runner"] == "serve":
        one, two = (next(serve.requests(traffic, 1000, s)) for s in (1, 2**31 + 9))
        assert sorted(len(p) for _, p in one) == sorted(len(p) for _, p in two)
        assert [len(p) for _, p in one] != [len(p) for _, p in two] or one != two
        assert all(traffic["prompt_min"] <= len(p) <= traffic["prompt_max"] for _, p in one)
        assert all(0 < t < 1000 for _, p in one for t in p)
    else:
        small = dict(traffic, batch=2, seq=8)
        one, two = (next(train.batches(small, 1000, s, "cpu")) for s in (1, 2**31 + 9))
        assert one["tokens"].shape == two["tokens"].shape == (2, 8)
        assert not torch.equal(one["tokens"], two["tokens"])
        assert torch.equal(one["tokens"][:, 1:], one["labels"][:, :-1])


F32 = {"dtype_name": "float32", "param_dtype_name": "float32"}
TIGHT = {"train": {"loss_gap": 1e-4, "grad_norm_gap": 1e-4, "grad_leaf_gap": 1e-4,
                   "update_leaf_gap": 1e-4},
         "serve": {"served_logit_gap": 1e-3, "route_margin": 1e-3, "drop_mismatch": 0}}


def test_result_line_shape_and_checks_last():
    run = smoke.make_run("train", limits=TIGHT["train"], **F32)
    res = harness.execute(run, BENCH)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "train_tokens_per_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(res))


def test_traced_result_reports_per_layer_metrics_it_can_read():
    run = smoke.make_run("serve", limits=TIGHT["serve"], **F32)
    run.trace = True
    res = harness.execute(run, BENCH)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"served_logit_gap", "route_margin", "drop_mismatch",
                                  "unmatched", "flash_launches"}
    # on the CPU there is no device trace: those metrics are left out
    assert set(res["metrics"]) == {"engine.tokens_per_decode_call", "engine.request_p90_s",
                                   "model.prefill_ms_p50", "serve_mfu"}
    assert res["metrics"]["engine.tokens_per_decode_call"]["value"] >= 1.0


def test_train_reference_matches_the_port_in_float32():
    """The reference follows the port's first steps to float32 rounding."""
    run = smoke.make_run("train", dtype_name="float32", param_dtype_name="float32")
    res = harness.execute(run, BENCH)
    for name in ("loss_gap", "grad_norm_gap", "grad_leaf_gap", "update_leaf_gap"):
        assert res["checks"][name]["value"] < 5e-5, (name, res["checks"][name])


def test_serve_reference_matches_the_port_logits_in_float32():
    """The reference's served logits (the padded prefill routed at
    capacity, dropping picks, then one position a step) equal the port's
    prefill and decode steps' logits, on its own routing and on the
    port's picks alike, and the port's picks are a top-k."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe

    from perfbench import port

    cfg = smoke.port_config("qwen2-moe-a2.7b", dtype_name="float32", param_dtype_name="float32",
                            moe_capacity_serve=1.25, moe_experts=16, moe_topk=4, d_model=128)
    config = smoke.config_file(cfg, "qwen2-moe-a2.7b")
    flat = wmod.draw(config, 5, "cpu")
    params = port.transformer(flat, cfg)
    p_len, prompt, new = 512, list(range(3, 300)), [7, 9, 11, 13]
    toks = torch.zeros((1, p_len), dtype=torch.long)
    toks[0, : len(prompt)] = torch.tensor(prompt)
    picks, orig = [], moe.route

    def route(probs, k, cap):
        out = orig(probs, k, cap)
        picks.append((out[1][0], out[3][0]))
        return out
    moe.route = route
    try:
        _, cache = model_lib.prefill(params, {"tokens": toks}, cfg, p_len + 4)
        got, steps = [], []
        for i, t in enumerate([prompt[-1]] + new[:-1]):
            n = len(picks)
            logits, cache = model_lib.decode_step(params, torch.tensor([[t]]), cache,
                                                  len(prompt) - 1 + i, cfg)
            got.append(logits[0, : cfg.vocab])
            steps.append([s[0] for s, _ in picks[n:]])
    finally:
        moe.route = orig
    pre = picks[: cfg.n_layers]
    assert not all(bool(k.all()) for _, k in pre)  # the prefill dropped picks
    cap = moe_capacity(p_len, cfg.moe_topk, cfg.moe_experts, 1.25)
    routes = {"prefill": pre, "decode": [torch.stack([s[i] for s in steps])
                                         for i in range(cfg.n_layers)]}
    ref = Decoder(config, flat)
    with strict():
        own = ref.served(prompt, new, p_len, cap)
        forced = ref.served(prompt, new, p_len, cap, routes)
    for want in (own, forced):
        err = (torch.stack(got) - want["logits"]).abs().max().item()
        assert err < 1e-4 * want["logits"].abs().max().item()
    info = forced["info"]["prefill"] + forced["info"]["decode"]
    assert sum(m.get("mismatch", 0) for m in info) == 0
    assert max(route_margin(m["sel"], m["probs"]) for m in info) < 1e-5


def test_learning_rate_matches_the_port_schedule():
    from repro_torch.train.optim import warmup_cosine

    hp = smoke.TRAIN["hparams"]
    sched = warmup_cosine(hp["peak_lr"], hp["total_steps"], hp["warmup_steps"], hp["final_frac"])
    for step in (0, 1, 2, 3, 50, 99, 150):
        assert ref_train.learning_rate(hp, step) == pytest.approx(float(sched(step)), rel=1e-6)


def test_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cell would run")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


def test_refused_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_run_loads_neither_jax_nor_the_jax_package(kind, tmp_path):
    """A whole run (here at smoke size on the CPU) leaves no module of JAX
    or of the JAX package in ``sys.modules``: only ``repro_torch``."""
    code = (
        "import sys; from perfbench import harness; from perfbench.tests import smoke\n"
        f"run = smoke.make_run({kind!r}, limits=None, dtype_name='float32', "
        "param_dtype_name='float32')\n"
        "harness.execute(run, harness.benchmark())\n"
        "assert 'repro_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
                               "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
