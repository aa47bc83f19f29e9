"""PyTorch port, serving engine: the same requests over the same weights give
the JAX engine's greedy tokens, exactly.

The JAX package draws the weights and the port loads them through
``params_from_jax`` (smoke configs, float32).  The cases are those of the
reference's ``tests/test_serve.py`` (one request against the full-forward
oracle, continuous batching with more requests than slots, EOS stopping)
plus one request padded to a 2,304-token prefill, which takes the chunked
attention path.  The reference's four cache families (``tests/test_serve.py``
``FAMILIES``: full attention, the sliding-window ring, recurrent, hybrid
with MoE) and qwen2-moe run the same cases; architectures with a recurrent
mixer take the exact-length prefill, and a padded MoE prefill whose pad
tokens take expert capacity (dropping real tokens' picks) gives the
reference's tokens at the same ``prefill_len``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
import repro.serve as JS
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as PM
from repro_torch.models import moe as PMOE
from repro_torch.serve import Engine, Request, ServeConfig

KEY = jax.random.key(0)
# the reference's FAMILIES, plus the shared-expert MoE
FAMILIES = ["smollm-135m", "mixtral-8x7b", "xlstm-1.3b", "jamba-1.5-large-398b",
            "qwen2-moe-a2.7b"]


def _models(name="smollm-135m", **overrides):
    jcfg = dataclasses.replace(jax_config(name, smoke=True), **overrides)
    pcfg = dataclasses.replace(get_config(name, smoke=True), **overrides)
    jparams = JM.init_params(KEY, jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, pcfg, jparams, params_from_jax(tree, pcfg, device="cpu")


def _serve_both(name, scfg, requests, **overrides):
    """{uid: tokens} from the JAX engine and from the port's."""
    jcfg, pcfg, jparams, model = _models(name, **overrides)
    jeng = JS.Engine(jparams, jcfg, scfg)
    peng = Engine(model, pcfg, ServeConfig(**dataclasses.asdict(scfg)))
    for r in requests:
        jeng.submit(JS.Request(r.uid, list(r.tokens), r.max_new_tokens, r.eos))
        peng.submit(r)
    want = {r.uid: r.tokens for r in jeng.run()}
    got = {r.uid: r.tokens for r in peng.run()}
    return got, want, (model, pcfg)


def _greedy(model, cfg, prompt, n_new):
    """The full-forward oracle of the reference's serve tests, on the port
    (MoE layers at the serving capacity factor)."""
    cfg = dataclasses.replace(cfg, moe_capacity=cfg.moe_capacity_serve)
    toks = list(prompt)
    for _ in range(n_new):
        logits, _ = PM.forward(model, {"tokens": torch.tensor([toks])}, cfg)
        toks.append(int(logits[0, -1, : cfg.vocab].argmax()))
    return toks[len(prompt):]


@pytest.mark.parametrize("name", ["olmo-1b"] + FAMILIES)
def test_engine_matches_reference_and_full_forward(name):
    prompt = [int(t) for t in np.random.RandomState(0).randint(1, 512, 7)]
    got, want, (model, cfg) = _serve_both(
        name, JS.ServeConfig(slots=2, prefill_len=8, max_len=32),
        [Request(uid=0, tokens=prompt, max_new_tokens=5)],
    )
    assert got == want
    assert got[0] == _greedy(model, cfg, prompt, 5)


def test_engine_continuous_batching_matches_reference():
    rng = np.random.RandomState(1)
    reqs = []
    for uid in range(5):  # more requests than slots -> queueing
        plen = int(rng.randint(3, 8))
        prompt = [int(t) for t in rng.randint(1, 512, plen)]
        reqs.append(Request(uid=uid, tokens=prompt, max_new_tokens=int(rng.randint(2, 6))))
    got, want, _ = _serve_both(
        "smollm-135m", JS.ServeConfig(slots=2, prefill_len=8, max_len=64), reqs
    )
    assert len(got) == 5 and got == want


def test_engine_eos_stops_early_like_reference():
    jcfg, pcfg, jparams, model = _models()
    first = int(jnp.argmax(JM.forward(jparams, {"tokens": jnp.asarray([[1, 2, 3]])}, jcfg)[0][0, -1, : jcfg.vocab]))
    got, want, _ = _serve_both(
        "smollm-135m", JS.ServeConfig(slots=1, prefill_len=8, max_len=32),
        [Request(uid=0, tokens=[1, 2, 3], max_new_tokens=10, eos=first)],
    )
    assert got == want == {0: [first]}


def test_engine_long_prefill_matches_reference():
    """A 2,100-token prompt right-padded to 2,304: the prefill takes the
    chunked path and the pad K/V stays masked until decode overwrites it."""
    prompt = [int(t) for t in np.random.RandomState(2).randint(1, 512, 2100)]
    got, want, _ = _serve_both(
        "smollm-135m", JS.ServeConfig(slots=2, prefill_len=2304, max_len=2320),
        [Request(uid=0, tokens=prompt, max_new_tokens=4)],
    )
    assert got == want and len(got[0]) == 4


def test_engine_temperature_sampling_is_seeded():
    _, cfg, _, model = _models()
    runs = []
    for _ in range(2):
        eng = Engine(
            model, cfg,
            ServeConfig(slots=2, prefill_len=8, max_len=32, temperature=1.0, seed=4),
        )
        eng.submit(Request(uid=0, tokens=[1, 2, 3], max_new_tokens=6))
        (res,) = eng.run()
        runs.append(res.tokens)
    assert runs[0] == runs[1] and len(runs[0]) == 6
    assert all(0 <= t < cfg.vocab for t in runs[0])


def test_launch_serve_runs_on_cpu(capsys):
    assert launch_serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                              "--max-new", "2"]) == 0
    assert "3 requests, 6 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("entry", ["engine", "launch"])
def test_serving_defaults_to_cuda(entry):
    """Without a GPU the default device raises; it never falls back.  The
    engine runs on its weights' device, which is the card by default."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("smollm-135m", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "engine":
            Engine(PM.init_params(cfg), cfg, ServeConfig())
        else:
            launch_serve.main(["--smoke"])


@pytest.mark.parametrize("name", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_exact_prefill_continuous_batching_matches_reference(name):
    """Recurrent mixers prefill each prompt at its own length; more
    requests than slots, mixed lengths and budgets (one of a single token,
    which the prefill's own logits answer)."""
    rng = np.random.RandomState(3)
    reqs = [Request(uid=uid, tokens=[int(t) for t in rng.randint(1, 512, int(rng.randint(3, 16)))],
                    max_new_tokens=1 if uid == 2 else int(rng.randint(2, 6)))
            for uid in range(5)]
    got, want, (model, cfg) = _serve_both(
        name, JS.ServeConfig(slots=2, prefill_len=8, max_len=64), reqs)
    assert len(got) == 5 and got == want and len(got[2]) == 1
    eng = Engine(model, cfg, ServeConfig(slots=2, prefill_len=8, max_len=64))
    assert eng.exact_prefill


def test_exact_prefill_eos_on_the_first_token_like_reference():
    jcfg, pcfg, jparams, model = _models("xlstm-1.3b")
    first = int(jnp.argmax(JM.forward(jparams, {"tokens": jnp.asarray([[1, 2, 3]])}, jcfg)[0][0, -1, : jcfg.vocab]))
    got, want, _ = _serve_both(
        "xlstm-1.3b", JS.ServeConfig(slots=1, prefill_len=8, max_len=32),
        [Request(uid=0, tokens=[1, 2, 3], max_new_tokens=10, eos=first),
         Request(uid=1, tokens=[4, 5, 6, 7], max_new_tokens=3)])
    assert got == want and got[0] == [first]


def test_padded_moe_prefill_routes_pads_like_reference(monkeypatch):
    """qwen2-moe at serving capacity factor 0.25 and a 512-token padded
    prefill: the pads take expert slots and real tokens' picks are dropped,
    as in the reference, whose tokens the port reproduces."""
    dropped = []
    real_route = PMOE.route

    def counting(probs, k, cap):
        out = real_route(probs, k, cap)
        dropped.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(PMOE, "route", counting)
    prompt = [int(t) for t in np.random.RandomState(4).randint(1, 512, 40)]
    got, want, _ = _serve_both(
        "qwen2-moe-a2.7b", JS.ServeConfig(slots=2, prefill_len=512, max_len=560),
        [Request(uid=0, tokens=prompt, max_new_tokens=4)], moe_capacity_serve=0.25)
    assert got == want and len(got[0]) == 4
    assert max(dropped) > 0
