"""PyTorch port, Mamba mixer: the reference's weights and inputs give the
reference's outputs, decode caches and decode steps.

jamba's smoke config (d_model 64, d_inner 128, d_state 8), float32, within
1e-5 of the largest.  The reference chunks only lengths that are multiples
of ``mamba_chunk`` and runs any other length as one chunk; the port chunks
every length with a shorter last chunk, so lengths equal to, a multiple of,
and not a multiple of the chunk (and shorter than it) are all held to the
reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba as JMB
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.models import mamba as PMB
from torch_mixer_twin import close, inputs, load

RTOL = 1e-5
ARCH = "jamba-1.5-large-398b"


def pair(chunk=None):
    jcfg, pcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    if chunk is not None:
        jcfg = dataclasses.replace(jcfg, mamba_chunk=chunk)
        pcfg = dataclasses.replace(pcfg, mamba_chunk=chunk)
    jparams = JMB.mamba_init(jax.random.key(0), jcfg)
    return jcfg, pcfg, jparams, load(PMB.Mamba(pcfg, device="cpu"), jparams)


# (chunk, seq): equal to the chunk, a multiple, not a multiple, shorter; the
# config's own chunk (128) at a multiple and at a length the reference
# runs as one chunk
LENGTHS = [(8, 8), (8, 32), (8, 21), (8, 5), (128, 256), (128, 200)]


@pytest.mark.parametrize("chunk,seq", LENGTHS)
def test_apply_and_state_match_reference(chunk, seq):
    jcfg, pcfg, jparams, module = pair(chunk)
    x = inputs(pcfg, 2, seq)
    want, wcache = JMB.mamba_apply(jparams, jnp.asarray(x), jcfg, return_state=True)
    got, gcache = PMB.mamba_apply(module, torch.from_numpy(x), pcfg, return_state=True)
    close(got, want, RTOL, "out")
    assert set(gcache) == set(wcache) == {"conv", "h"}
    for name in ("conv", "h"):
        close(gcache[name], wcache[name], RTOL, name)
        assert gcache[name].dtype == torch.float32
    close(PMB.mamba_apply(module, torch.from_numpy(x), pcfg), want, RTOL, "no state")


@pytest.mark.parametrize("chunk,seq,steps", [(8, 21, 6), (8, 16, 5), (128, 12, 4)])
def test_prefill_then_decode_matches_apply_and_reference(chunk, seq, steps):
    """Prefill S tokens, decode t more: each step equals the full apply at
    S + t on its position, and the reference's decode step."""
    jcfg, pcfg, jparams, module = pair(chunk)
    x = inputs(pcfg, 2, seq + steps)
    full = PMB.mamba_apply(module, torch.from_numpy(x), pcfg)
    _, cache = PMB.mamba_apply(module, torch.from_numpy(x[:, :seq]), pcfg, return_state=True)
    _, jcache = JMB.mamba_apply(jparams, jnp.asarray(x[:, :seq]), jcfg, return_state=True)
    for t in range(seq, seq + steps):
        xt = x[:, t : t + 1]
        y, cache = PMB.mamba_decode(module, torch.from_numpy(xt), cache, pcfg)
        jy, jcache = JMB.mamba_decode(jparams, jnp.asarray(xt), jcache, jcfg)
        close(y, full[:, t : t + 1], RTOL, f"step {t} vs apply")
        close(y, jy, RTOL, f"step {t} vs reference")
        for name in ("conv", "h"):
            close(cache[name], jcache[name], RTOL, f"step {t} {name}")


def test_init_cache_matches_reference():
    jcfg, pcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    want = JMB.init_mamba_cache(jcfg, 3)
    got = PMB.init_mamba_cache(pcfg, 3, "cpu")
    for name, t in want.items():
        assert tuple(got[name].shape) == t.shape and not got[name].any()
        assert got[name].dtype == (torch.float32 if name == "h" else pcfg.dtype)


def test_weights_keep_reference_layouts_and_dtypes():
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), param_dtype_name="bfloat16")
    jtree = JMB.mamba_init(jax.random.key(0), jax_config(ARCH, smoke=True))
    module = PMB.mamba_init(cfg, torch.Generator().manual_seed(0))
    assert {n for n, _ in module.named_parameters()} == set(jtree)
    for name, p in module.named_parameters():
        assert tuple(p.shape) == jtree[name].shape, name
        want = torch.bfloat16 if jtree[name].ndim == 2 and name not in ("conv_w", "A_log") else torch.float32
        assert p.dtype == want, name
    # the reference's deterministic leaves, and dt in [1e-3, 0.1]
    for name in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(getattr(module, name).numpy(), np.asarray(jtree[name]), rtol=1e-6)
    dt = torch.nn.functional.softplus(module.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)


def test_working_set_is_one_chunk():
    """The port never builds a [B, S, d_inner, N] tensor: the largest
    intermediate of a 64-token apply at chunk 8 spans one chunk."""
    _, pcfg, _, module = pair(8)
    x = torch.from_numpy(inputs(pcfg, 1, 64))
    seen = []
    real = PMB._scan
    PMB._scan = lambda a, b: (seen.append(tuple(a.shape)), real(a, b))[1]
    try:
        PMB.mamba_apply(module, x, pcfg)
    finally:
        PMB._scan = real
    assert seen and all(s[1] <= 8 for s in seen), seen
