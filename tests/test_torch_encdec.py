"""PyTorch port, whisper's encoder and cross attention and llava's patch
prefix, held against the JAX package on the same numpy-seeded inputs.

Both packages get the same weights (the JAX package draws them, the port
loads them through ``params_from_jax``) and the same frames, patches and
tokens.  Smoke configs are float32: layer outputs agree within 1e-5 and
model logits, losses and cached K/V within ``TOL`` (1e-4, as in
``test_torch_model.py``: float32 sums in other orders through a few
layers), cached positions exactly, gradients within 1e-5 of each leaf's
largest.  Attention of more than 2,048 queries or keys takes the chunked
online-softmax path (the flash kernel on the card), in both directions
here: 2,304 decoder positions over 16 frames, and 12 over 2,304 frames
(the encoder then runs chunked too).  whisper's smoke table of learned
positions holds 128 rows, so the long decoder cases raise ``max_pos`` in
both packages alike.  ``input_specs`` and ``abstract_params`` are held to
the reference's shapes and dtypes, the engine refuses both configs, and
one training step of each smoke config through ``launch.train``'s setup
equals the reference's step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as JOPS
import repro.models.attention as JA
import repro.models.model as JM
import repro.train as JT
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import input_specs as jax_input_specs
from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.kernels import ops as POPS
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as PA
from repro_torch.models import model as PM
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import make_train_step
from repro_torch.train._tree import tree_leaves, tree_paths

TOL = 1e-4
LAYER_TOL = 1e-5
WHISPER, LLAVA = "whisper-medium", "llava-next-mistral-7b"


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


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _batch(cfg, rng, b, s):
    """Tokens (+ whisper's frames, llava's patches) as numpy arrays."""
    batch = {"tokens": rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = _randn(rng, (b, cfg.n_frames, cfg.d_model))
    if cfg.n_patches:
        batch["patches"] = _randn(rng, (b, cfg.n_patches, cfg.d_model))
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _caches_equal(pc, jc):
    for blk, c in jc["periods"].items():
        assert set(pc["periods"][blk]) == set(c)
        for part, leaves in c.items():
            assert set(pc["periods"][blk][part]) == set(leaves)
            for name, t in leaves.items():
                got = pc["periods"][blk][part][name]
                assert tuple(got.shape) == t.shape, (blk, part, name)
                if name == "pos":
                    np.testing.assert_array_equal(got.numpy(), np.asarray(t))
                else:
                    _close(got, t)


def _attention_pair(name, seed=1):
    """One attention layer's weights in both packages."""
    jcfg, pcfg = jax_config(name, smoke=True), get_config(name, smoke=True)
    jp = JA.attention_init(jax.random.key(seed), jcfg, cross=True)
    pp = PA.attention_init(pcfg, device="cpu")
    for n in ("wq", "wk", "wv", "wo"):
        getattr(pp, n).data.copy_(torch.from_numpy(np.array(jp[n])))
    return jcfg, pcfg, jp, pp


# ---------------------------------------------------------------------------
# attention: cross attention, its cache and its decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk", [(12, 16), (2304, 16), (12, 2304)])
def test_attention_apply_kv_states_matches_reference(sq, sk):
    """Cross attention on the dense path and on the chunked path in both
    directions (queries over keys, keys over queries), with llava's GQA
    heads and RoPE config: RoPE is skipped and every key is visible, so
    ``causal=True`` changes nothing."""
    jcfg, pcfg, jp, pp = _attention_pair(LLAVA)
    assert pcfg.pos == "rope" and pcfg.n_heads != pcfg.n_kv_heads
    rng = np.random.default_rng(sq + sk)
    x, enc = _randn(rng, (2, sq, pcfg.d_model)), _randn(rng, (2, sk, pcfg.d_model))
    want = JA.attention_apply(jp, jnp.asarray(x), jcfg, causal=False, kv_states=jnp.asarray(enc))
    for causal in (False, True):
        got = PA.attention_apply(pp, torch.from_numpy(x), pcfg, causal=causal,
                                 kv_states=torch.from_numpy(enc))
        assert tuple(got.shape) == (2, sq, pcfg.d_model)
        _close(got, want, LAYER_TOL)


def test_long_attention_takes_key_positions_of_their_own_length():
    """The chunked branch on the CPU runs ``chunked_attention`` with query
    positions of Sq and key positions of Sk (arange each), and a whole-key
    chunk for cross attention, as the reference does."""
    rng = np.random.default_rng(3)
    q, k, v = _randn(rng, (1, 40, 4, 16)), _randn(rng, (1, 24, 2, 16)), _randn(rng, (1, 24, 2, 16))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = PA._long_attention(tq, tk, tv, None, None, causal=False, window=None,
                             out_dtype=torch.float32, k_chunk=24)
    pos = lambda n: jnp.arange(n, dtype=jnp.int32)[None]
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos(40), pos(24),
                                causal=False, window=None, out_dtype=jnp.float32, k_chunk=24)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_more_queries_than_keys(dtype):
    """The flash entry point at cross attention's layout, more queries than
    keys (whisper: 4,096 over 1,500), non-causal with ``kv_len`` = Sk,
    against the reference's Pallas kernel in interpret mode (bf16 at the
    reference's own flash tolerance, 4e-2)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(8)
    q, k, v = _randn(rng, (1, 72, 4, 16)), _randn(rng, (1, 24, 4, 16)), _randn(rng, (1, 24, 4, 16))
    want = JOPS.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=False,
                                bq=16, bk=16)
    got = POPS.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                               causal=False, kv_len=24)
    tol = LAYER_TOL if dtype == "float32" else 4e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_cross_kv_matches_reference():
    jcfg, pcfg, jp, pp = _attention_pair(WHISPER)
    enc = _randn(np.random.default_rng(4), (2, pcfg.n_frames, pcfg.d_model))
    want = JA.cross_kv(jp, jnp.asarray(enc))
    got = PA.cross_kv(pp, torch.from_numpy(enc))
    assert set(got) == set(want) == {"k", "v"}
    for n in want:
        assert tuple(got[n].shape) == want[n].shape == (2, pcfg.n_frames, pcfg.n_kv_heads,
                                                         pcfg.head_dim)
        _close(got[n], want[n], LAYER_TOL)


def test_cross_attention_decode_matches_reference():
    """One query over the cached encoder K / V, and the same query through
    ``attention_apply(kv_states=)`` (the prefill's path) alike."""
    jcfg, pcfg, jp, pp = _attention_pair(WHISPER)
    rng = np.random.default_rng(5)
    x, enc = _randn(rng, (3, 1, pcfg.d_model)), _randn(rng, (3, pcfg.n_frames, pcfg.d_model))
    jckv = JA.cross_kv(jp, jnp.asarray(enc))
    want = JA.cross_attention_decode(jp, jnp.asarray(x), jckv, jcfg)
    got = PA.cross_attention_decode(pp, torch.from_numpy(x),
                                    PA.cross_kv(pp, torch.from_numpy(enc)), pcfg)
    _close(got, want, LAYER_TOL)
    full = PA.attention_apply(pp, torch.from_numpy(x), pcfg, kv_states=torch.from_numpy(enc))
    _close(full, want, LAYER_TOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_frames", [16, 2304])
def test_encode_matches_reference(n_frames):
    """whisper's encoder over 16 frames (dense) and 2,304 (chunked,
    non-causal)."""
    jcfg, pcfg, jparams, model = _pair(WHISPER, n_frames=n_frames)
    frames = _randn(np.random.default_rng(n_frames), (1, n_frames, pcfg.d_model))
    want = JM.encode(jparams, jnp.asarray(frames), jcfg)
    got = PM.encode(model, torch.from_numpy(frames), pcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize(
    "name,batch,seq,overrides",
    [
        (WHISPER, 2, 12, {}),
        (WHISPER, 1, 2304, dict(max_pos=4096)),
        (WHISPER, 1, 12, dict(n_frames=2304)),
        (LLAVA, 2, 12, {}),
        (LLAVA, 1, 2296, {}),
    ],
)
def test_forward_prefill_decode_match_reference(name, batch, seq, overrides):
    """Logits, prefill caches (the cross K / V included) and three decode
    steps, whose positions continue after llava's patch prefix; the input
    cache is left as it was."""
    jcfg, pcfg, jparams, model = _pair(name, **overrides)
    rng = np.random.default_rng(seq + batch)
    inputs = _batch(pcfg, rng, batch, seq)
    total = seq + pcfg.n_patches
    max_len = total + 4

    jlogits, jaux = JM.forward(jparams, _jax(inputs), jcfg)
    plogits, aux = PM.forward(model, _torch(inputs), pcfg)
    assert tuple(plogits.shape) == jlogits.shape == (batch, total, PM.padded_vocab(pcfg))
    _close(plogits, jlogits)
    assert float(aux) == float(jaux) == 0.0

    jl, jc = JM.prefill(jparams, _jax(inputs), jcfg, max_len)
    pl, pc = PM.prefill(model, _torch(inputs), pcfg, max_len)
    _close(pl, jl)
    _caches_equal(pc, jc)
    assert ("cross" in pc["periods"]["b0"]) == pcfg.is_encoder_decoder

    for step in range(3):
        nxt = rng.integers(1, pcfg.vocab, (batch, 1)).astype(np.int32)
        pos = total + step
        jd, jc2 = JM.decode_step(jparams, jnp.asarray(nxt), jc, jnp.asarray(pos, jnp.int32), jcfg)
        pd, pc2 = PM.decode_step(model, torch.from_numpy(nxt), pc, pos, pcfg)
        _close(pd, jd)
        _caches_equal(pc2, jc2)
        _caches_equal(pc, jc)  # the step wrote into a copy
        jc, pc = jc2, pc2


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


@pytest.mark.parametrize("name", [WHISPER, LLAVA])
def test_loss_and_grads_match_reference(name):
    """``loss_fn`` with frames (every encoder leaf gets its gradient through
    the cross attention) and with patches (the prefix carries no labels;
    ``mm_proj`` gets its gradient), over the stacked tree's views."""
    jcfg, pcfg, jparams, model = _pair(name)
    rng = np.random.default_rng(6)
    inputs = _batch(pcfg, rng, 2, 16)
    labels = rng.integers(0, pcfg.vocab, (2, 16)).astype(np.int32)
    labels[0, :3] = -1
    inputs["labels"] = labels
    (jloss, jm), jgrads = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        jparams, _jax(inputs), jcfg)
    tree = PM.param_tree(model, pcfg)
    for leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    views = {f"model.{n}": t for n, t in PM.tree_views(tree, pcfg).items()}
    loss, m = torch.func.functional_call(_Loss(model, pcfg), views, (_torch(inputs),))
    loss.backward()
    for key in ("loss", "ce", "ntok"):
        want = float(jm[key])
        assert abs(float(m[key].detach()) - want) <= 1e-5 * abs(want), key
    assert float(m["ntok"]) == 29.0
    grads = {k: v for k, v in jax.tree.map(lambda t: t.grad, tree).items()}
    _tree_grads_close(grads, jgrads)


@pytest.mark.parametrize("name", [WHISPER, LLAVA])
def test_param_tree_is_the_reference_tree(name):
    """``params_from_jax`` loads the encoder, cross and ``mm_proj`` leaves;
    ``param_tree`` lays them out as the reference stacks them (the encoder
    over ``enc_layers``), and ``tree_views`` maps them back."""
    jcfg, pcfg, jparams, model = _pair(name)
    tree = PM.param_tree(model, pcfg)
    jtree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in tree_paths(tree)] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (path, got), (_, want) in zip(tree_paths(tree), jflat):
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.float().numpy(), want)
    if pcfg.is_encoder_decoder:
        assert tree["encoder"]["layers"]["attn"]["wq"].shape[0] == pcfg.enc_layers
        assert "cross" in tree["periods"]["b0"] and "cross_norm" in tree["periods"]["b0"]
    else:
        assert tuple(tree["mm_proj"].shape) == (pcfg.d_model, pcfg.d_model)
    views = PM.tree_views(tree, pcfg)
    named = dict(model.named_parameters())
    assert set(views) == set(named)
    for n, v in views.items():
        assert torch.equal(v, named[n]), n


@pytest.mark.parametrize("name", [WHISPER, LLAVA])
def test_full_config_builds_with_its_frontend(name):
    """Both configs build at full size on the meta device (no memory) with
    the reference's number of weights (``param_counts`` leaves whisper's
    cross attention and position table out), and at smoke size on the
    CPU."""
    cfg = get_config(name)
    model = PM.Transformer(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(JM.abstract_params(jax_config(name))))
    assert hasattr(model, "encoder") == cfg.is_encoder_decoder
    assert hasattr(model, "mm_proj") == bool(cfg.n_patches)
    PM.check_supported(cfg)
    PM.Transformer(get_config(name, smoke=True), device="cpu")


def test_every_config_is_supported():
    for name in ARCHS:
        PM.check_supported(get_config(name))
        PM.check_supported(get_config(name, smoke=True))


# ---------------------------------------------------------------------------
# input_specs and abstract_params
# ---------------------------------------------------------------------------

CELLS = [(a, s) for a, cfg in JARCHS.items() for s in JSHAPES if s not in cfg.skip_shapes]


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def test_runnable_cells_are_33():
    assert len(CELLS) == 33  # 40 cells - 7 long_500k skips


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    want = jax_input_specs(jax_config(arch), JSHAPES[shape])
    got = input_specs(get_config(arch), SHAPES[shape])
    assert list(got) == list(want)
    for k, spec in want.items():
        assert got[k].is_meta, k
        assert tuple(got[k].shape) == spec.shape, k
        assert _dtype_name(got[k].dtype) == _dtype_name(spec.dtype), k


def test_input_specs_batch_override_and_prefix_error():
    got = input_specs(get_config(LLAVA), SHAPES["train_4k"], batch_override=3)
    want = jax_input_specs(jax_config(LLAVA), JSHAPES["train_4k"], batch_override=3)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert got["tokens"].shape == (3, 4096 - 2880)
    short = dataclasses.replace(SHAPES["train_4k"], seq_len=2880)
    with pytest.raises(ValueError, match="exceeds"):
        input_specs(get_config(LLAVA), short)
    with pytest.raises(ValueError, match="exceeds"):
        jax_input_specs(jax_config(LLAVA), dataclasses.replace(JSHAPES["train_4k"], seq_len=2880))


@pytest.mark.parametrize("name", [WHISPER, LLAVA, "qwen2-moe-a2.7b"])
def test_abstract_params_match_eval_shape(name):
    """``abstract_params`` at full size allocates nothing (every parameter on
    the meta device), and its tree has the reference's paths, shapes and
    dtypes."""
    model = PM.abstract_params(get_config(name))
    assert all(p.is_meta for p in model.parameters())
    tree = PM.param_tree(model, get_config(name))
    jflat = jax.tree_util.tree_flatten_with_path(JM.abstract_params(jax_config(name)))[0]
    assert [p for p, _ in tree_paths(tree)] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (path, got), (_, want) in zip(tree_paths(tree), jflat):
        assert got.is_meta, path
        assert tuple(got.shape) == want.shape, path
        assert _dtype_name(got.dtype) == _dtype_name(want.dtype), path


# ---------------------------------------------------------------------------
# serving and training entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [WHISPER, LLAVA])
def test_engine_refuses_frontend_configs(name):
    """The engine's requests carry tokens only (as the reference's), so it
    refuses a config whose prefill needs frames or patches, naming
    ``prefill`` / ``decode_step`` instead; ``launch.serve`` refuses before
    it draws any weight."""
    cfg = get_config(name, smoke=True)
    model = PM.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="prefill.*decode_step"):
        Engine(model, cfg, ServeConfig())
    with pytest.raises(ValueError, match="prefill.*decode_step"):
        launch_serve.main(["--arch", name, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("name", [WHISPER, LLAVA])
def test_launch_train_step_matches_reference(name):
    """``launch.train --arch <name> --smoke --device cpu``: one step of its
    config, hyperparameters and token pipeline (frames / patches included)
    from a reference state carried by ``state_from_jax`` equals the
    reference's step; then the CLI itself trains two steps."""
    argv = ["--arch", name, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "32", "--lr", "1e-3"]
    args, cfg, hp, pipe = launch_train.setup(argv)
    jcfg = jax_config(name, smoke=True)
    jhp = JT.TrainHParams(**dataclasses.asdict(hp))
    jstate = JT.init_state(jax.random.key(0), jcfg, jhp)
    state = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    batch = pipe.batch_at(0)
    assert ("frames" in batch) == cfg.is_encoder_decoder
    assert ("patches" in batch) == bool(cfg.n_patches)
    jnew, jm = jax.jit(JT.make_train_step(jcfg, jhp))(jstate, batch)
    new, m = make_train_step(cfg, hp)(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    jleaves = jax.tree.leaves(jnew)
    assert len(tree_leaves(new)) == len(jleaves)
    for a, b in zip(tree_leaves(new), jleaves):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    logs = []
    result = launch_train.run(argv, log=logs.append)
    assert [h["step"] for h in result.history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in result.history)
    assert any(cfg.name in line for line in logs)
