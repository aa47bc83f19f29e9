"""PyTorch port, the flash backward: ``ops.flash_attention_fn`` (an autograd
function whose backward is the ``flash_bwd`` kernel on the card) and its
plain version ``ref.flash_backward_ref``, held against the JAX package on
the same numpy-seeded inputs.

The reference's Pallas flash kernel has no backward; the reference trains
through its chunked recurrence (``chunked_attention`` under
``jax.checkpoint``), so its gradient is ``jax.vjp`` of that.  Here the
Function's CPU path (the plain forward, then ``flash_backward_ref``) and
``flash_backward_ref`` alone give dq, dk and dv within 1e-5 of each
gradient's largest entry of both ``jax.vjp`` of the reference's
``chunked_attention`` and torch autograd through the port's plain
``chunked_attention`` (float32: the same sums in other orders).  Key
lengths below Sk are the reference's empty slots (position -1).  In bf16
the gradients are held to the float32 gradients of the same (rounded)
inputs at the flash kernel's bf16 bound, ``chip_smoke.py``'s ``FLASH_TOL``
(|a - b| <= 4e-2·(1 + |b|)), float32 at 1e-4.  The model's ``loss_fn``
over 2,304 tokens (over the 2,048-token threshold) takes the Function
under autograd: its loss and every parameter's gradient equal
``jax.grad`` of the reference's for the smollm and qwen2-moe smoke
configs (loss 1e-5 relative, each leaf 1e-4 of its largest: float32 sums
through two layers and the head).  The CUDA kernel runs only on the card
(``chip_smoke.py`` phase 2 holds it to ``flash_backward_ref``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro.models.model as JM
import repro_torch.models.attention as PA
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as POPS
from repro_torch.kernels import ref as PREF
from repro_torch.models import model as PM
from repro_torch.train._tree import tree_leaves, tree_unflatten
from repro_torch.train.train_step import _TreeLoss

FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}  # chip_smoke.py's

# (b, sq, sk, h, kh, d, causal, window, kv_len)
CASES = {
    "causal": (2, 40, 40, 4, 2, 64, True, None, None),
    "window": (1, 48, 48, 4, 2, 64, True, 7, None),
    "kv_len": (2, 24, 40, 4, 2, 64, False, None, 29),
    "non-causal sq < sk": (1, 24, 56, 4, 2, 64, False, None, None),
    "non-causal sq > sk": (1, 56, 24, 4, 2, 64, False, None, None),
    "gqa kh 1": (1, 32, 32, 4, 1, 64, True, None, None),
    "head dim 8": (1, 32, 32, 4, 2, 8, True, None, None),
    "head dim 128": (1, 32, 32, 4, 2, 128, True, 9, None),
}


def _inputs(case, seed=0):
    b, sq, sk, h, kh, d, *_ = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d), (b, sq, h, d))]


def _masks(case):
    _, sq, sk, *_, causal, window, kv_len = CASES[case]
    return dict(causal=causal, window=window), sk if kv_len is None else kv_len


def _positions(case):
    b, sq, sk = CASES[case][:3]
    _, kv_len = _masks(case)
    qpos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq)).copy()
    kpos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    kpos[:, kv_len:] = -1  # keys past kv_len: the reference's empty slots
    return qpos, kpos


def _jax_grads(case, q, k, v, g):
    masks, _ = _masks(case)
    qpos, kpos = _positions(case)

    def f(q, k, v):
        return JA.chunked_attention(q, k, v, jnp.asarray(qpos), jnp.asarray(kpos),
                                    out_dtype=jnp.float32, q_chunk=8, k_chunk=8, **masks)

    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch_chunked_grads(case, q, k, v, g):
    masks, _ = _masks(case)
    qpos, kpos = map(torch.from_numpy, _positions(case))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = PA.chunked_attention(qt, kt, vt, qpos, kpos, out_dtype=torch.float32,
                               q_chunk=8, k_chunk=8, **masks)
    out.backward(torch.from_numpy(g))
    return [x.grad.numpy() for x in (qt, kt, vt)]


def _function_grads(case, q, k, v, g, dtype=torch.float32):
    masks, kv_len = _masks(case)
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    out = POPS.flash_attention_fn(qt, kt, vt, kv_len=kv_len, **masks)
    out.backward(torch.from_numpy(g).to(dtype))
    return out.detach(), [x.grad for x in (qt, kt, vt)]


def _close(got, want, rtol=1e-5):
    for a, b in zip(got, want):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else a
        assert np.all(np.isfinite(a))
        scale = max(float(np.max(np.abs(b))), 1e-30)
        assert float(np.max(np.abs(a - b))) <= rtol * scale


@pytest.mark.parametrize("case", list(CASES))
def test_function_gradients_equal_jax_vjp(case):
    q, k, v, g = _inputs(case)
    want_out, want = _jax_grads(case, q, k, v, g)
    out, got = _function_grads(case, q, k, v, g)
    _close([out], [want_out])
    _close(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_ref_equals_torch_autograd_of_chunked(case):
    """``flash_backward_ref`` on the forward's own output, against autograd
    through the plain ``chunked_attention`` (and, through it, the Function's
    CPU path, which calls it)."""
    q, k, v, g = _inputs(case)
    masks, kv_len = _masks(case)
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    out = PREF.flash_attention_ref(qt, kt, vt, kv_len=kv_len, **masks)
    got = PREF.flash_backward_ref(qt, kt, vt, out, gt, kv_len=kv_len, **masks)
    _close(got, _torch_chunked_grads(case, q, k, v, g))


def test_fully_masked_rows_get_zero_gradients():
    """Window 3 over keys cut at kv_len 5: rows 7.. see no key.  Their
    outputs and dq, and the gradients of keys past kv_len, are exactly 0,
    never NaN; the reference's vjp agrees."""
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((1, 12, 2, 16), (1, 12, 1, 16), (1, 12, 1, 16), (1, 12, 2, 16)))
    masks = dict(causal=True, window=3)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = POPS.flash_attention_fn(qt, kt, vt, kv_len=5, **masks)
    out.backward(torch.from_numpy(g))
    for t in (out, qt.grad, kt.grad, vt.grad):
        assert torch.isfinite(t).all()
    assert not out[:, 7:].any() and not qt.grad[:, 7:].any()
    assert not kt.grad[:, 5:].any() and not vt.grad[:, 5:].any()
    assert bool((qt.grad[:, 1:6].abs().amax(dim=-1) > 1e-4).all())  # rows seeing 2 keys
    kpos = np.arange(12, dtype=np.int32)[None].copy()
    kpos[:, 5:] = -1
    qpos = np.arange(12, dtype=np.int32)[None]

    def f(q, k, v):
        return JA.chunked_attention(q, k, v, jnp.asarray(qpos), jnp.asarray(kpos),
                                    out_dtype=jnp.float32, q_chunk=4, k_chunk=4, **masks)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    _close([qt.grad, kt.grad, vt.grad], [np.asarray(x) for x in vjp(jnp.asarray(g))])


@pytest.mark.parametrize("case", ["causal", "window", "kv_len", "non-causal sq > sk"])
def test_bf16_gradients_within_flash_tolerance(case):
    """bf16 q, k, v, dO through the Function against float32 on the same
    (rounded) values."""
    q, k, v, g = (torch.from_numpy(x).bfloat16() for x in _inputs(case))
    _, got = _function_grads(case, *(x.float().numpy() for x in (q, k, v, g)),
                             dtype=torch.bfloat16)
    _, want = _function_grads(case, *(x.float().numpy() for x in (q, k, v, g)))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert bool((((a.float() - b).abs()) <= FLASH_TOL[torch.bfloat16] * (1 + b.abs())).all())


FLASH_ROW_RTOL = {torch.bfloat16: 2e-2}  # chip_smoke.py's
FLASH_NORM_RTOL = {torch.bfloat16: 1e-2}


def _rounded_backward(q, k, v, out, dout, *, causal, window, kv_len):
    """dq, dk, dv as the bf16 wgmma kernel rounds them: float32 products of
    the bf16 inputs, P and dS rounded to bf16 before dV = Pᵀ dO, dK = dSᵀ Q
    and dQ = dS K, float32 sums, the results rounded to bf16."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g, scale = h // kh, d**-0.5
    i, j = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    mask = j < kv_len
    if causal:
        mask = mask & (j <= i)
    if window is not None:
        mask = mask & (j > i - window)
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    dq, dk, dv = (torch.empty(t.shape) for t in (q, k, v))
    for kv in range(kh):
        heads = slice(kv * g, (kv + 1) * g)
        qf, of, gf = (t[:, :, heads].float().transpose(1, 2) for t in (q, out, dout))
        kf, vf = k[:, :, kv].float()[:, None], v[:, :, kv].float()[:, None]
        s = torch.where(mask, qf @ kf.transpose(-1, -2) * scale, -torch.inf)
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        p = torch.where(mask & (lse > -torch.inf), torch.exp(s - lse), 0.0)
        ds = p * (gf @ vf.transpose(-1, -2) - (gf * of).sum(-1, keepdim=True))
        dv[:, :, kv] = (bf(p).transpose(-1, -2) @ gf).sum(1)
        dk[:, :, kv] = (bf(ds).transpose(-1, -2) @ qf).sum(1) * scale
        dq[:, :, heads] = (bf(ds) @ kf * scale).transpose(1, 2)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 200)])
def test_bf16_rounded_p_and_ds_within_phase2_bounds(causal, window):
    """The bf16 kernel rounds P and dS to bf16 before their products; at a
    causal 1,024-token, 4 / 2 x 64 case and a window case that rounding
    stays inside phase 2's three bf16 bounds against ``flash_backward_ref``
    (elementwise FLASH_TOL, per row FLASH_ROW_RTOL, whole FLASH_NORM_RTOL)."""
    rng = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
                  for s in ((1, 1024, 4, 64), (1, 1024, 2, 64), (1, 1024, 2, 64),
                            (1, 1024, 4, 64)))
    kw = dict(causal=causal, window=window, kv_len=1024)
    out = PREF.flash_attention_ref(q, k, v, **kw)
    want = PREF.flash_backward_ref(q, k, v, out, g, **kw)
    got = _rounded_backward(q, k, v, out, g, **kw)
    dt = torch.bfloat16
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        diff = a - b
        assert bool((diff.abs() <= FLASH_TOL[dt] * (1 + b.abs())).all())
        floor = 64**0.5 * float(b.square().mean().sqrt())
        assert float((diff.norm(dim=-1) / (b.norm(dim=-1) + floor)).max()) <= FLASH_ROW_RTOL[dt]
        assert float(diff.norm() / b.norm()) <= FLASH_NORM_RTOL[dt]


def test_function_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 2, 12, requires_grad=True)
    with pytest.raises(ValueError, match="head dim"):
        POPS.flash_attention_fn(q, q, q)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        POPS.flash_attention_fn(*(torch.zeros(1, 8, 2, 16, dtype=torch.float64),) * 3)


# -- loss_fn over the threshold --------------------------------------------------

LONG = 2_304


@pytest.mark.parametrize("name", ["smollm-135m", "qwen2-moe-a2.7b"])
def test_loss_grad_over_the_threshold_equals_reference(name):
    """One row of 2,304 tokens (random labels, five masked): attention takes
    the chunked branch in both packages, the Function here."""
    jcfg = jax_config(name, smoke=True)
    pcfg = get_config(name, smoke=True)
    jparams = JM.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, pcfg.vocab, (1, LONG)).astype(np.int32)
    labels = rng.integers(0, pcfg.vocab, (1, LONG)).astype(np.int32)
    labels[0, :5] = -1
    batch = {"tokens": tokens, "labels": labels}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg), has_aux=True)(jparams)

    model = params_from_jax(jax.tree.map(np.asarray, jparams), pcfg, device="cpu")
    tree = PM.param_tree(model, pcfg)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tree)]
    # as make_train_step differentiates: functional_call over the tree's views
    views = PM.tree_views(tree_unflatten(tree, leaves), pcfg)
    loss, _ = torch.func.functional_call(
        _TreeLoss(pcfg), {f"model.{n}": t for n, t in views.items()}, (batch,))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        jg = np.asarray(jg, np.float32)
        assert g.shape == jg.shape
        assert float((g - torch.from_numpy(jg)).abs().max()) <= 1e-4 * max(
            float(np.max(np.abs(jg))), 1e-30)
