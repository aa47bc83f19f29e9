"""PyTorch port, xLSTM mixers: the reference's weights and inputs give the
reference's mLSTM and sLSTM outputs, decode caches and decode steps.

xlstm's smoke config (d_model 64, 2 heads, xlstm_chunk 16), float32,
within 1e-5 of the largest.  mLSTM takes the reference's domain of lengths:
up to the chunk, or a multiple of it; any other length raises
``ValueError`` naming ``xlstm_chunk``, where the reference asserts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.xlstm as JXL
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.models import xlstm as PXL
from torch_mixer_twin import close, inputs, load

RTOL = 1e-5
ARCH = "xlstm-1.3b"
KINDS = {
    "mlstm": (JXL.mlstm_init, JXL.mlstm_apply, JXL.mlstm_decode, JXL.init_mlstm_cache,
              PXL.MLSTM, PXL.mlstm_apply, PXL.mlstm_decode, PXL.init_mlstm_cache),
    "slstm": (JXL.slstm_init, JXL.slstm_apply, JXL.slstm_decode, JXL.init_slstm_cache,
              PXL.SLSTM, PXL.slstm_apply, PXL.slstm_decode, PXL.init_slstm_cache),
}


def pair(kind, seed=0):
    jcfg, pcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    j_init, *_, p_cls, _, _, _ = KINDS[kind]
    jparams = j_init(jax.random.key(seed), jcfg)
    return jcfg, pcfg, jparams, load(p_cls(pcfg, device="cpu"), jparams)


# lengths in the reference's domain at chunk 16: shorter than, equal to and
# multiples of the chunk
@pytest.mark.parametrize("seq", [7, 16, 48])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_apply_and_state_match_reference(kind, seq):
    jcfg, pcfg, jparams, module = pair(kind)
    _, j_apply, _, _, _, p_apply, _, _ = KINDS[kind]
    x = inputs(pcfg, 2, seq)
    want, wcache = j_apply(jparams, jnp.asarray(x), jcfg, return_state=True)
    got, gcache = p_apply(module, torch.from_numpy(x), pcfg, return_state=True)
    close(got, want, RTOL, "out")
    assert set(gcache) == set(wcache)
    for name, t in wcache.items():
        close(gcache[name], t, RTOL, name)
    close(p_apply(module, torch.from_numpy(x), pcfg), want, RTOL, "no state")


@pytest.mark.parametrize("seq,steps", [(16, 6), (32, 3), (9, 4)])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_prefill_then_decode_matches_apply_and_reference(kind, seq, steps):
    """Prefill S tokens, decode t more: each step equals the full apply at
    S + t on its position (a length in the reference's domain), and the
    reference's decode step."""
    jcfg, pcfg, jparams, module = pair(kind)
    _, j_apply, j_decode, _, _, p_apply, p_decode, _ = KINDS[kind]
    total = seq + steps if kind == "slstm" or seq + steps <= 16 else 48
    x = inputs(pcfg, 2, total)
    full = p_apply(module, torch.from_numpy(x), pcfg)
    close(full, j_apply(jparams, jnp.asarray(x), jcfg), RTOL, "full")
    _, cache = p_apply(module, torch.from_numpy(x[:, :seq]), pcfg, return_state=True)
    _, jcache = j_apply(jparams, jnp.asarray(x[:, :seq]), jcfg, return_state=True)
    for t in range(seq, seq + steps):
        xt = x[:, t : t + 1]
        y, cache = p_decode(module, torch.from_numpy(xt), cache, pcfg)
        jy, jcache = j_decode(jparams, jnp.asarray(xt), jcache, jcfg)
        close(y, full[:, t : t + 1], RTOL, f"step {t} vs apply")
        close(y, jy, RTOL, f"step {t} vs reference")
        for name, v in jcache.items():
            close(cache[name], v, RTOL, f"step {t} {name}")


@pytest.mark.parametrize("seq", [17, 24, 40])
def test_mlstm_refuses_lengths_the_reference_refuses(seq):
    jcfg, pcfg, jparams, module = pair("mlstm")
    x = inputs(pcfg, 1, seq)
    with pytest.raises(AssertionError):
        JXL.mlstm_apply(jparams, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="xlstm_chunk"):
        PXL.mlstm_apply(module, torch.from_numpy(x), pcfg)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_init_cache_matches_reference(kind):
    jcfg, pcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    want = KINDS[kind][3](jcfg, 3)
    got = KINDS[kind][7](pcfg, 3, "cpu")
    assert set(got) == set(want)
    for name, t in want.items():
        assert tuple(got[name].shape) == t.shape and not got[name].any()
        assert got[name].dtype == (pcfg.dtype if name == "conv" else torch.float32)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_weights_keep_reference_layouts_and_dtypes(kind):
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), param_dtype_name="bfloat16")
    jtree = KINDS[kind][0](jax.random.key(0), jax_config(ARCH, smoke=True))
    module = KINDS[kind][4](cfg, torch.Generator().manual_seed(0))
    assert {n for n, _ in module.named_parameters()} == set(jtree)
    f32 = {"conv_w", "conv_b", "w_gates", "gate_bias", "h_scale", "r", "bias"}
    for name, p in module.named_parameters():
        assert tuple(p.shape) == jtree[name].shape, name
        assert p.dtype == (torch.float32 if name in f32 else torch.bfloat16), name
    for name in ("gate_bias", "bias", "h_scale", "conv_b"):
        if name in jtree:
            np.testing.assert_array_equal(getattr(module, name).numpy(), np.asarray(jtree[name]))


@pytest.mark.parametrize("heads,hd,seed", [(2, 32, 0), (4, 512, 1), (3, 8, 2)])
def test_recurrence_equals_block_diag_bitwise(heads, hd, seed):
    """sLSTM's ``[d, 4d]`` recurrence matrix, built by a select that DTensor
    shards, is ``torch.block_diag(*r)`` bit for bit on plain tensors (the
    signs of its zeros too)."""
    rng = np.random.default_rng(seed)
    r = torch.from_numpy(rng.standard_normal((heads, hd, 4 * hd)).astype(np.float32))
    params = PXL.SLSTM.__new__(PXL.SLSTM)
    torch.nn.Module.__init__(params)
    params.r = torch.nn.Parameter(r, requires_grad=False)
    got, want = PXL._recurrence(params), torch.block_diag(*r)
    assert got.shape == want.shape == (heads * hd, heads * 4 * hd)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
