"""PyTorch port, LM assembly: the reference's weights loaded through
``params_from_jax`` give the reference's logits and caches.

Both packages get the same weights (the JAX package draws them, the port
loads them) and the same numpy-seeded tokens.  Smoke configs are float32:
logits and cached K/V agree within 1e-4 (float32 sums in other orders
through two layers), cached positions exactly.  A short sequence takes the
dense attention path; one of 2,304 tokens (over the 2,048 threshold) the
chunked online-softmax path.  The MoE, xLSTM and hybrid (Mamba +
attention + MoE) configs run the same forward / prefill / decode checks
with every cache leaf compared, and qwen2-moe's ``loss_fn`` (cross entropy
plus the router aux) and its gradients agree within 1e-5 relative.
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
        assert set(pc["periods"][blk]["mixer"]) == set(c["mixer"])
        for name, t in c["mixer"].items():
            got = pc["periods"][blk]["mixer"][name]
            if name == "pos":
                np.testing.assert_array_equal(got.numpy(), np.asarray(t))
            else:
                _close(got, t)


@pytest.mark.parametrize(
    "name,batch,seq",
    [
        ("smollm-135m", 2, 12),
        ("smollm-135m", 1, 2304),
        ("olmo-1b", 2, 12),
        ("olmo-1b", 1, 2304),
        ("qwen2-moe-a2.7b", 2, 12),
        ("qwen2-moe-a2.7b", 1, 2304),
        ("mixtral-8x7b", 2, 24),
        ("xlstm-1.3b", 2, 32),
        ("xlstm-1.3b", 1, 7),
        ("jamba-1.5-large-398b", 2, 12),
        ("jamba-1.5-large-398b", 1, 133),
    ],
)
def test_forward_prefill_decode_match_reference(name, batch, seq):
    jcfg, pcfg, jparams, model = _pair(name)
    rng = np.random.default_rng(seq)
    toks = rng.integers(1, pcfg.vocab, (batch, seq)).astype(np.int32)
    max_len = seq + 4

    jlogits, jaux = JM.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    plogits, aux = PM.forward(model, {"tokens": torch.from_numpy(toks)}, pcfg)
    assert plogits.dtype == torch.float32 and aux.dtype == torch.float32
    _close(plogits, jlogits)
    if PM.num_moe_layers(pcfg):
        assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    else:
        assert float(aux) == float(jaux) == 0.0

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


@pytest.mark.parametrize("name", ["mixtral-8x7b", "xlstm-1.3b", "jamba-1.5-large-398b",
                                  "qwen2-moe-a2.7b"])
def test_every_mixer_and_moe_config_builds(name):
    """The four configs with a non-attention mixer or an MoE feed-forward
    build at full size on the meta device (no memory) and at smoke size."""
    cfg = get_config(name)
    model = PM.Transformer(cfg, device="meta")
    kinds = {(b.mixer_kind, b.ffn_kind) for b in model.blocks}
    assert kinds == {(b.mixer, b.ffn) for b in cfg.pattern}
    n = sum(p.numel() for p in model.parameters())
    assert abs(n - cfg.param_counts()["total"]) <= 0.02 * n, (n, cfg.param_counts())
    PM.Transformer(get_config(name, smoke=True), device="cpu")


@pytest.mark.parametrize("capacity", [4.0, 0.25])
def test_row_local_moe_model_matches_reference(capacity):
    """``moe_row_local`` routes each batch row on its own in forward,
    prefill and decode, dropless and dropping, as the reference does."""
    jcfg, pcfg, jparams, model = _pair(
        "qwen2-moe-a2.7b", moe_row_local=True, moe_capacity=capacity,
        moe_capacity_serve=capacity)
    toks = np.random.default_rng(9).integers(1, pcfg.vocab, (2, 300)).astype(np.int32)
    jl, jaux = JM.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    pl, aux = PM.forward(model, {"tokens": torch.from_numpy(toks)}, pcfg)
    _close(pl, jl)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 304)
    pl, pc = PM.prefill(model, {"tokens": torch.from_numpy(toks)}, pcfg, 304)
    _close(pl, jl)
    _caches_equal(pc, jc)
    nxt = np.full((2, 1), 3, np.int32)
    jd, _ = JM.decode_step(jparams, jnp.asarray(nxt), jc, jnp.asarray(300, jnp.int32), jcfg)
    pd, _ = PM.decode_step(model, torch.from_numpy(nxt), pc, 300, pcfg)
    _close(pd, jd)


def test_num_moe_layers_matches_reference():
    for name in ("qwen2-moe-a2.7b", "mixtral-8x7b", "jamba-1.5-large-398b", "xlstm-1.3b",
                 "smollm-135m"):
        assert PM.num_moe_layers(get_config(name)) == JM.num_moe_layers(jax_config(name))


def _tree_grads_close(got: dict, want: dict, path=""):
    for key, w in want.items():
        if isinstance(w, dict):
            _tree_grads_close(got[key], w, f"{path}/{key}")
            continue
        g = got[key].detach().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, path + key
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= 1e-5 * scale, (path + "/" + key, scale)


class _Loss(torch.nn.Module):
    """``loss_fn`` of a model, for a stateless call over tree views."""

    def __init__(self, model, cfg):
        super().__init__()
        self.model, self.cfg = model, cfg

    def forward(self, batch):
        return PM.loss_fn(self.model, batch, self.cfg)


def test_loss_aux_and_grads_match_reference_moe():
    """qwen2-moe-smoke's loss (cross entropy + router_aux · aux / layers),
    its aux and every gradient leaf of the stacked tree, against the
    reference's."""
    jcfg, pcfg, jparams, model = _pair("qwen2-moe-a2.7b")
    rng = np.random.default_rng(5)
    toks = rng.integers(1, pcfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, pcfg.vocab, (2, 16)).astype(np.int32)
    labels[0, :3] = -1
    (jloss, jm), jgrads = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, jcfg)
    tree = PM.param_tree(model, pcfg)
    for leaf in jax.tree.leaves(tree):
        leaf.requires_grad_(True)
    views = {f"model.{n}": t for n, t in PM.tree_views(tree, pcfg).items()}
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    loss, m = torch.func.functional_call(_Loss(model, pcfg), views, (batch,))
    loss.backward()
    assert PM.num_moe_layers(pcfg) == 2
    for key in ("loss", "ce", "aux", "ntok"):
        want = float(jm[key])
        assert abs(float(m[key].detach()) - want) <= 1e-5 * abs(want), key
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(m["loss"]) > float(m["ce"])  # the aux term is in the loss
    _tree_grads_close(jax.tree.map(lambda t: t.grad, tree), jgrads)


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b", "xlstm-1.3b"])
def test_param_tree_is_the_reference_tree(name):
    """``param_tree`` lays the new leaves out as the reference stacks them,
    and ``tree_views`` maps them back onto the model's parameters."""
    jcfg, pcfg, jparams, model = _pair(name)
    tree = PM.param_tree(model, pcfg)
    jtree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tree)) == jax.tree.structure(
        jax.tree.map(lambda t: 0, jtree))
    for (path, got), want in zip(jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree.leaves(jtree)):
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.float().numpy(), want)
    views = PM.tree_views(tree, pcfg)
    named = dict(model.named_parameters())
    assert set(views) == set(named)
    for n, v in views.items():
        assert torch.equal(v, named[n]), n
