"""Shared helpers of the port's mixer parity tests: load a reference
parameter dict into a port module, and draw numpy-seeded inputs."""

import numpy as np
import torch


def load(module, tree):
    """Copy a reference parameter dict into a port module, leaf by leaf
    (shapes must match; each leaf is cast to the parameter's dtype)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = tree
            for key in name.split("."):
                leaf = leaf[key]
            arr = np.array(leaf, np.float32)
            assert arr.shape == tuple(p.shape), name
            p.copy_(torch.from_numpy(arr))
    return module


def inputs(cfg, b, s, seed=1):
    """``[b, s, d_model]`` float32 standard normals from a numpy seed."""
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def close(got, want, rtol, what=""):
    """max |got − want| ≤ rtol · max |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} · {scale:.3e}"
