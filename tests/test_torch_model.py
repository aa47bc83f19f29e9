"""PyTorch port, LM assembly: the reference's weights loaded through
``params_from_jax`` give the reference's logits and caches.

Both packages get the same weights (the JAX package draws them, the port
loads them) and the same numpy-seeded tokens.  Smoke configs are float32:
logits and cached K/V agree within 1e-4 (float32 sums in other orders
through two layers), cached positions exactly.  A short sequence takes the
dense attention path; one of 2,304 tokens (over the 2,048 threshold) the
chunked online-softmax path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
from repro.configs import get_config as jax_config
from repro_torch.configs import Block, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import model as PM

TOL = 1e-4


def _pair(name, **overrides):
    """(JAX config, port config, JAX params, port model) for a smoke arch."""
    jcfg = dataclasses.replace(jax_config(name, smoke=True), **overrides)
    pcfg = dataclasses.replace(get_config(name, smoke=True), **overrides)
    jparams = JM.init_params(jax.random.key(0), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, pcfg, jparams, params_from_jax(tree, pcfg, device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _caches_equal(pc, jc):
    for blk, c in jc["periods"].items():
        for name in ("k", "v"):
            _close(pc["periods"][blk]["mixer"][name], c["mixer"][name])
        np.testing.assert_array_equal(
            pc["periods"][blk]["mixer"]["pos"].numpy(), np.asarray(c["mixer"]["pos"])
        )


@pytest.mark.parametrize(
    "name,batch,seq",
    [
        ("smollm-135m", 2, 12),
        ("smollm-135m", 1, 2304),
        ("olmo-1b", 2, 12),
        ("olmo-1b", 1, 2304),
    ],
)
def test_forward_prefill_decode_match_reference(name, batch, seq):
    jcfg, pcfg, jparams, model = _pair(name)
    rng = np.random.default_rng(seq)
    toks = rng.integers(1, pcfg.vocab, (batch, seq)).astype(np.int32)
    max_len = seq + 4

    jlogits, _ = JM.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    plogits, aux = PM.forward(model, {"tokens": torch.from_numpy(toks)}, pcfg)
    assert plogits.dtype == torch.float32 and float(aux) == 0.0
    _close(plogits, jlogits)

    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, max_len)
    pl, pc = PM.prefill(model, {"tokens": torch.from_numpy(toks)}, pcfg, max_len)
    _close(pl, jl)
    _caches_equal(pc, jc)

    nxt = rng.integers(1, pcfg.vocab, (batch, 1)).astype(np.int32)
    jd, jc2 = JM.decode_step(jparams, jnp.asarray(nxt), jc, jnp.asarray(seq, jnp.int32), jcfg)
    pd, pc2 = PM.decode_step(model, torch.from_numpy(nxt), pc, seq, pcfg)
    _close(pd, jd)
    _caches_equal(pc2, jc2)
    _caches_equal(pc, jc)  # the step wrote into a copy


@pytest.mark.parametrize("seq", [10, 24])
def test_sliding_window_ring_cache_matches_reference(seq):
    """mixtral's attention (window 16) with its MoE swapped for an MLP:
    prefill keeps the last 16 positions rolled to slot p % 16, and decode
    steps wrap the ring, exactly as in the reference."""
    jcfg, pcfg, jparams, model = _pair("mixtral-8x7b", pattern=(Block("attn", "mlp"),))
    assert pcfg.window == 16
    toks = np.random.default_rng(seq).integers(1, pcfg.vocab, (2, seq)).astype(np.int32)
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 40)
    pl, pc = PM.prefill(model, {"tokens": torch.from_numpy(toks)}, pcfg, 40)
    _close(pl, jl)
    _caches_equal(pc, jc)
    assert pc["periods"]["b0"]["mixer"]["k"].shape[2] == 16
    for step in range(3):
        tok = np.full((2, 1), 7 + step, np.int32)
        jd, jc = JM.decode_step(jparams, jnp.asarray(tok), jc, jnp.asarray(seq + step, jnp.int32), jcfg)
        pd, pc = PM.decode_step(model, torch.from_numpy(tok), pc, seq + step, pcfg)
        _close(pd, jd)
        _caches_equal(pc, jc)


def test_init_cache_matches_reference_layout():
    cfg = get_config("smollm-135m", smoke=True)
    jc = JM.init_cache(jax_config("smollm-135m", smoke=True), 3, 20)
    pc = PM.init_cache(cfg, 3, 20, device="cpu")
    for name, t in jc["periods"]["b0"]["mixer"].items():
        got = pc["periods"]["b0"]["mixer"][name]
        assert tuple(got.shape) == t.shape
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(t, np.float32))


def test_init_params_is_seeded_with_reference_layouts():
    cfg = get_config("smollm-135m", smoke=True)
    a = PM.init_params(cfg, seed=3, device="cpu")
    b = PM.init_params(cfg, seed=3, device="cpu")
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    jp = JM.init_params(jax.random.key(0), jax_config("smollm-135m", smoke=True))
    assert tuple(a.embed.shape) == jp["embed"].shape
    assert tuple(a.blocks[0].mixer.wo.shape) == jp["periods"]["b0"]["mixer"]["wo"].shape[1:]


def test_params_from_jax_casts_matrices_to_param_dtype():
    jcfg = jax_config("smollm-135m", smoke=True)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True), param_dtype_name="bfloat16")
    model = params_from_jax(tree, cfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.final_norm.scale.dtype == torch.float32
    bad = dict(tree, embed=tree["embed"][:, :3])
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize(
    "name",
    ["mixtral-8x7b", "xlstm-1.3b", "jamba-1.5-large-398b", "qwen2-moe-a2.7b",
     "whisper-medium", "llava-next-mistral-7b"],
)
def test_unported_parts_raise_not_implemented(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PM.Transformer(get_config(name, smoke=True), device="cpu")


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "params_from_jax"])
def test_model_defaults_to_cuda(entry):
    """Without a GPU the default device raises; it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("smollm-135m", smoke=True)
    calls = {
        "init_params": lambda: PM.init_params(cfg),
        "init_cache": lambda: PM.init_cache(cfg, 1, 8),
        "params_from_jax": lambda: params_from_jax({}, cfg),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
