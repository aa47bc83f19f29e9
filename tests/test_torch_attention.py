"""PyTorch port, attention layer: the flash kernel's plain version, the
chunked online-softmax path and the shared layers, held against the JAX
package on the same numpy-seeded inputs.

Tolerances: float32 paths at 1e-5 (the same float32 arithmetic in another
summation order; the Pallas kernel runs in interpret mode with 16-wide
blocks, its plain version takes one dense softmax), bf16 at 4e-2 (the
reference's own flash tolerance: one bf16 rounding of p and of the output),
the layers at 1e-6.  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` phase 2); here its wrapper's refusals and build command
are checked.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as JOPS
import repro.models.attention as JA
import repro.models.layers as JL
import repro_torch.models.attention as PA
import repro_torch.models.layers as PL
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import ops as POPS

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# the four shapes of the reference's flash sweep
FLASH_SHAPES = [
    (2, 64, 64, 4, 2, 32, True, None),   # GQA causal
    (1, 48, 48, 2, 2, 16, True, 16),     # sliding window
    (2, 24, 72, 3, 1, 64, False, None),  # MQA, non-causal, ragged blocks
    (1, 16, 128, 4, 4, 128, True, None), # long kv, wide head
]


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,window", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_version_matches_pallas(b, sq, sk, h, kh, d, causal, window, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(sq * 7 + d)
    q, k, v = _randn(rng, (b, sq, h, d)), _randn(rng, (b, sk, kh, d)), _randn(rng, (b, sk, kh, d))
    want = JOPS.flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal=causal, window=window, bq=16, bk=16,
    )
    got = POPS.flash_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), causal=causal, window=window,
    )
    assert got.dtype == tdt and tuple(got.shape) == (b, sq, h, d)
    tol = 1e-5 if dtype == "float32" else 4e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def test_flash_plain_version_kv_len_and_empty_rows():
    """Keys at or past ``kv_len`` are invisible; a row that sees no key is 0
    (the reference's ``kv_len`` padding bound)."""
    rng = np.random.default_rng(3)
    q, k, v = _randn(rng, (1, 20, 2, 16)), _randn(rng, (1, 30, 1, 16)), _randn(rng, (1, 30, 1, 16))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = POPS.flash_attention(tq, tk, tv, causal=False, kv_len=11)
    want = POPS.flash_attention(tq, tk[:, :11], tv[:, :11], causal=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    empty = POPS.flash_attention(tq, tk, tv, causal=False, kv_len=0)
    assert not empty.any()


@pytest.mark.parametrize(
    "causal,window", [(True, None), (True, 8), (False, None), (False, 12)]
)
def test_chunked_attention_matches_reference(causal, window):
    """Empty slots (-1) are skipped, positions differ per row, and windows
    band the mask, exactly as in the reference's recurrence."""
    rng = np.random.default_rng(11)
    b, sq, sk, h, kh, d = 2, 32, 48, 4, 2, 16
    q, k, v = _randn(rng, (b, sq, h, d)), _randn(rng, (b, sk, kh, d)), _randn(rng, (b, sk, kh, d))
    qpos = np.stack([np.arange(sq) + 16, np.arange(sq) + 10]).astype(np.int32)
    kpos = np.stack([np.arange(sk), np.arange(sk)]).astype(np.int32)
    kpos[0, 5:9] = -1
    kpos[1, 30:] = -1
    kw = dict(causal=causal, window=window, q_chunk=8, k_chunk=16)
    want = JA.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(kpos), out_dtype=jnp.float32, **kw,
    )
    got = PA.chunked_attention(
        *map(torch.from_numpy, (q, k, v, qpos, kpos)), out_dtype=torch.float32, **kw
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_matches_reference(window):
    """One decode step against a cache holding empty slots, full and ring
    (window 4 over 6 slots); the input cache is left as it was."""
    jcfg = dataclasses.replace(jax_config("smollm-135m", smoke=True), window=window)
    pcfg = dataclasses.replace(get_config("smollm-135m", smoke=True), window=window)
    jp = JA.attention_init(jax.random.key(1), jcfg)
    pp = PA.attention_init(pcfg, device="cpu")
    for name in ("wq", "wk", "wv", "wo"):
        getattr(pp, name).data.copy_(torch.from_numpy(np.array(jp[name])))
    rng = np.random.default_rng(2)
    x = _randn(rng, (2, 1, pcfg.d_model))
    cache = {
        "k": _randn(rng, (2, 6, pcfg.n_kv_heads, pcfg.head_dim)),
        "v": _randn(rng, (2, 6, pcfg.n_kv_heads, pcfg.head_dim)),
        "pos": np.array([[6, 7, 2, 3, -1, -1], [6, 1, 2, 3, 4, 5]], np.int32),
    }
    jout, jc = JA.attention_decode(
        jp, jnp.asarray(x), {n: jnp.asarray(a) for n, a in cache.items()},
        jnp.asarray(8, jnp.int32), jcfg, window=window,
    )
    pc_in = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    pout, pc = PA.attention_decode(pp, torch.from_numpy(x), pc_in, 8, pcfg, window=window)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(pc[name].numpy(), np.asarray(jc[name]), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(pc_in[name].numpy(), cache[name])


def _layer_case(name, rng):
    x = _randn(rng, (2, 5, 24))
    scale = _randn(rng, (24,)) + 1.0
    bias = _randn(rng, (24,))
    tx = torch.from_numpy(x)
    if name == "rms_norm":
        return JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)), PL.rms_norm(tx, torch.from_numpy(scale))
    if name == "layer_norm":
        return (
            JL.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)),
            PL.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias)),
        )
    if name == "np_ln":
        return JL.apply_norm(jnp.asarray(x), {}, "np_ln"), PL.apply_norm(tx, PL.Norm(24, "np_ln"), "np_ln")
    if name in ("swiglu", "gelu"):
        m = PL.MLP(24, 40, name, torch.float32, torch.Generator().manual_seed(0))
        params = {k: jnp.asarray(p.detach().numpy()) for k, p in m.named_parameters()}
        return JL.mlp_apply(params, jnp.asarray(x), name), m(tx)
    if name == "rotary":
        xr = _randn(rng, (2, 5, 3, 16))
        pos = np.array([[0, 1, 2, 3, 4], [7, 9, 100, 2047, 4000]], np.int32)
        jc, js = JL.rotary_embedding(jnp.asarray(pos), 16, 10_000.0)
        pc, ps = PL.rotary_embedding(torch.from_numpy(pos), 16, 10_000.0)
        return (
            JL.apply_rotary(jnp.asarray(xr), jc, js),
            PL.apply_rotary(torch.from_numpy(xr), pc, ps),
        )
    if name == "sinusoidal":
        return JL.sinusoidal_positions(12, 16), PL.sinusoidal_positions(12, 16)
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["rms_norm", "layer_norm", "np_ln", "swiglu", "gelu", "rotary", "sinusoidal"]
)
def test_layers_match_reference(name):
    want, got = _layer_case(name, np.random.default_rng(5))
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_truncated_normal_is_seeded_and_truncated():
    a = PL.truncated_normal((4000,), torch.float32, 0.5, torch.Generator().manual_seed(1))
    b = PL.truncated_normal((4000,), torch.float32, 0.5, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 1.0 and 0.3 < float(a.std()) < 0.5


@pytest.mark.parametrize("d", [4, 12, 264, 512])
def test_flash_refuses_head_dims(d):
    q = torch.zeros(1, 8, 2, d)
    with pytest.raises(ValueError, match="head dim"):
        POPS.flash_attention(q, q, q)


@pytest.mark.parametrize(
    "dtypes",
    [(torch.float16,) * 3, (torch.float64,) * 3, (torch.bfloat16, torch.float32, torch.float32)],
)
def test_flash_refuses_dtypes(dtypes):
    q, k, v = (torch.zeros(1, 8, 2, 16, dtype=dt) for dt in dtypes)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        POPS.flash_attention(q, k, v)


@pytest.mark.parametrize(
    "q_shape,k_shape,kw",
    [
        ((1, 8, 3, 16), (1, 8, 2, 16), {}),          # H not a multiple of KH
        ((1, 8, 2, 16), (2, 8, 2, 16), {}),          # batch differs
        ((1, 8, 2, 16), (1, 8, 2, 16), {"kv_len": 9}),
        ((1, 8, 2, 16), (1, 8, 2, 16), {"window": 0}),
    ],
)
def test_flash_refuses_shapes(q_shape, k_shape, kw):
    with pytest.raises(ValueError):
        POPS.flash_attention(torch.zeros(q_shape), torch.zeros(k_shape), torch.zeros(k_shape), **kw)


def test_flash_builds_for_sm90a_and_counts():
    assert "flash" in _build.SOURCES
    cmd = _build.nvcc_command("flash", _build.library_path("flash"))
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1].endswith("csrc/flash.cu")
    POPS.reset_launch_counts()
    q = torch.zeros(1, 8, 2, 16)
    POPS.flash_attention(q, q, q)  # CPU: the plain version, no launch
    assert POPS.launch_counts()["flash"] == 0
