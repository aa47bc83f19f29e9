"""PyTorch port, MoE feed-forward: the reference's weights and inputs give the
reference's dispatch, outputs and aux loss.

The JAX package draws each smoke config's MoE weights and the port loads
them; inputs come from numpy seeds.  Two regimes: dropless (a short
sequence at the smoke configs' capacity factor 4.0) and dropping (1,024
routed tokens at capacity factor 0.25, where every expert's slots overflow:
the test asserts that pairs are dropped).  The dispatch is held exactly:
the port's ``route``, fed the reference's own router probabilities (read
off its ``top_k`` call), gives the reference's selection, slot-major
positions and keep mask (read off its ``stack`` and ``where`` calls).
Outputs agree within 1e-5 of the largest, the aux loss within 1e-6
relative (float32 sums in other orders).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JMOE
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.models import moe as PMOE
from torch_mixer_twin import inputs, load

OUT_RTOL = 1e-5
AUX_RTOL = 1e-6
ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b", "jamba-1.5-large-398b"]
# (batch, seq, capacity factor): dropless / dropping
REGIMES = {"dropless": (2, 24, None), "dropping": (2, 512, 0.25)}


def pair(name, seed=0):
    jcfg, pcfg = jax_config(name, smoke=True), get_config(name, smoke=True)
    jparams = JMOE.moe_init(jax.random.key(seed), jcfg)
    return jcfg, pcfg, jparams, load(PMOE.MoE(pcfg, device="cpu"), jparams)


class Spy:
    """Stands in for the reference module's ``jax`` / ``jnp`` and records
    what its router and dispatch computed (eager, so the values are
    concrete)."""

    def __init__(self):
        self.got = {}
        spy = self

        def top_k(x, k):
            out = jax.lax.top_k(x, k)
            spy.got["probs"], spy.got["sel"] = np.array(x), np.array(out[1])
            return out

        def stack(xs, axis=0):
            out = jnp.stack(xs, axis=axis)
            spy.got["pos"] = np.asarray(out)
            return out

        def where(c, *a):
            spy.got["keep"] = np.asarray(c)
            return jnp.where(c, *a)

        self.jax = types.SimpleNamespace(
            lax=types.SimpleNamespace(top_k=top_k), nn=jax.nn, random=jax.random)
        self.jnp = types.SimpleNamespace(**{
            n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("__")})
        self.jnp.stack, self.jnp.where = stack, where


def run_reference(fn_name, jparams, x, jcfg, cf, monkeypatch):
    spy = Spy()
    monkeypatch.setattr(JMOE, "jax", spy.jax)
    monkeypatch.setattr(JMOE, "jnp", spy.jnp)
    out, aux = getattr(JMOE, fn_name)(jparams, jnp.asarray(x), jcfg, capacity_factor=cf)
    monkeypatch.undo()
    return np.asarray(out), float(aux), spy.got


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("fn_name", ["moe_apply", "moe_apply_row_local"])
@pytest.mark.parametrize("name", ARCHS)
def test_dispatch_matches_reference_exactly(name, fn_name, regime, monkeypatch):
    b, s, cf = REGIMES[regime]
    jcfg, pcfg, jparams, _ = pair(name)
    x = inputs(pcfg, b, s)
    _, _, got = run_reference(fn_name, jparams, x, jcfg, cf, monkeypatch)
    e, k = pcfg.moe_experts, pcfg.moe_topk
    groups = 1 if fn_name == "moe_apply" else b
    t = b * s // groups
    cap = PMOE.capacity(t, k, e, pcfg.moe_capacity if cf is None else cf)
    probs = torch.from_numpy(got["probs"]).reshape(groups, t, e)
    _, sel, pos, keep = PMOE.route(probs, k, cap)
    np.testing.assert_array_equal(sel.numpy().reshape(got["sel"].shape), got["sel"])
    np.testing.assert_array_equal(pos.numpy().reshape(got["pos"].shape), got["pos"])
    np.testing.assert_array_equal(keep.numpy().reshape(got["keep"].shape), got["keep"])
    dropped = int((~keep).sum())
    assert (dropped > 0) == (regime == "dropping"), dropped


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("fn_name", ["moe_apply", "moe_apply_row_local"])
@pytest.mark.parametrize("name", ARCHS)
def test_output_and_aux_match_reference(name, fn_name, regime, monkeypatch):
    b, s, cf = REGIMES[regime]
    jcfg, pcfg, jparams, module = pair(name)
    x = inputs(pcfg, b, s)
    want, want_aux, _ = run_reference(fn_name, jparams, x, jcfg, cf, monkeypatch)
    out, aux = getattr(PMOE, fn_name)(module, torch.from_numpy(x), pcfg, capacity_factor=cf)
    assert out.shape == (b, s, pcfg.d_model) and out.dtype == torch.float32
    scale = float(np.abs(want).max())
    assert float(np.abs(out.numpy() - want).max()) <= OUT_RTOL * scale
    assert abs(float(aux) - want_aux) <= AUX_RTOL * abs(want_aux)


def test_row_local_equals_global_when_dropless():
    """In the dropless regime the two dispatches compute the same outputs."""
    _, pcfg, _, module = pair("qwen2-moe-a2.7b")
    x = torch.from_numpy(inputs(pcfg, 3, 20))
    a, _ = PMOE.moe_apply(module, x, pcfg)
    b, _ = PMOE.moe_apply_row_local(module, x, pcfg)
    torch.testing.assert_close(a, b, rtol=0, atol=OUT_RTOL * float(a.abs().max()))


@pytest.mark.parametrize("t,k,e,cf", [
    (1, 2, 6, 4.0), (24, 2, 6, 4.0), (1_024, 2, 6, 0.25), (4_096, 4, 60, 1.25),
    (4, 4, 60, 1.25), (4_100, 2, 16, 1.25), (300, 2, 8, 100.0)])
def test_capacity_is_the_reference_formula(t, k, e, cf):
    want = JMOE._round_up(max(int(t * k / e * cf), 1), 128)
    assert PMOE.capacity(t, k, e, cf) == min(want, JMOE._round_up(t, 128))


def test_weights_keep_reference_layouts_and_dtypes():
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", smoke=True), param_dtype_name="bfloat16")
    jtree = JMOE.moe_init(jax.random.key(0), jax_config("qwen2-moe-a2.7b", smoke=True))
    module = PMOE.moe_init(cfg, torch.Generator().manual_seed(0))
    names = {n for n, _ in module.named_parameters()}
    assert names == {"router", "we_gate", "we_up", "we_down",
                     "shared.w_gate", "shared.w_up", "shared.w_down"}
    for name, p in module.named_parameters():
        leaf = jtree
        for key in name.split("."):
            leaf = leaf[key]
        assert tuple(p.shape) == leaf.shape, name
        assert p.dtype == (torch.float32 if name == "router" else torch.bfloat16), name
    # fan-in scaled: we_down draws over its ff inputs
    assert float(module.we_down.float().std()) < float(module.we_gate.float().std())
