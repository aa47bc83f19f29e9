"""Architecture assembly: ``ModelConfig`` -> weights / forward / prefill /
decode (PyTorch port of the JAX package's ``models/model.py``).

The depth is the config's block pattern repeated ``n_periods`` times; here
the blocks are an ``nn.ModuleList`` run in a Python loop (layer ``i`` is
block ``i % len(pattern)`` of period ``i // len(pattern)``).  Mixers GQA
attention (full and sliding-window), Mamba, mLSTM and sLSTM;
feed-forwards a dense MLP (SwiGLU / GELU), MoE (top-k capacity dispatch)
or none; RMS / Layer / non-parametric LayerNorm, RoPE, learned or no
positions, tied or separate LM head.  Modality frontends are stubs, as in
the reference: whisper's encoder (``enc_layers`` LayerNorm / GELU blocks
over precomputed frame embeddings, ``batch["frames"] [B, n_frames, d]``)
feeds cross attention in every decoder block, and llava's precomputed
patch embeddings (``batch["patches"] [B, n_patches, d]``) are projected by
``mm_proj`` into a prefix ahead of the tokens.  Activations carry the
reference's ``sharding.constrain`` annotations at the same places (no-ops
without an active policy; under one, a DTensor is redistributed to the
resolved placements).

Public entry points (``params`` is a :class:`Transformer`)::

    init_params(cfg, seed, device)              -> Transformer
    abstract_params(cfg)                        -> Transformer on "meta"
    encode(params, frames, cfg)                 -> encoder states
    forward(params, batch, cfg)                 -> (logits, aux_loss)
    loss_fn(params, batch, cfg)                 -> (loss, metrics)
    prefill(params, batch, cfg, max_len)        -> (last_logits, cache)
    init_cache(cfg, batch, max_len, device)     -> cache
    decode_step(params, token, cache, pos, cfg) -> (logits, cache)

A llava batch's positions run over the patch prefix and the tokens, so its
decode steps continue from ``n_patches + text length``.

``forward`` and ``loss_fn`` are differentiable: they run under whatever
grad mode the caller sets, and the weights' ``requires_grad`` (False as
built) belongs to the caller.  The serving entry points, ``prefill`` and
``decode_step``, run under ``torch.inference_mode``.  Training keeps the
weights in the reference's parameter tree (``param_tree``: one tensor a
block position and weight, stacked over periods, so optimizer state,
clipping and compression see the reference's leaves) and runs the model on
per-layer views of it (``tree_views``).

Caches keep the reference's structure: ``{"periods": {"b<i>": {"mixer":
{...}}}}`` with leaves stacked over periods (``[n_periods, B, ...]``):
attention ``{"k", "v", "pos"}``, Mamba ``{"conv", "h"}``, mLSTM ``{"conv",
"S", "n"}``, sLSTM ``{"h", "c", "n"}``; an encoder-decoder's blocks also
hold ``"cross": {"k", "v"}`` (``[n_periods, B, n_frames, KH, hd]``, written
by ``prefill``, carried through ``decode_step``).  Logits are float32
``[.., padded_vocab]``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..sharding import CACHE_AXES, constrain, constrain_tree, is_dtensor, pinned, sum_over
from . import attention as attn
from . import mamba as mb
from . import moe as moe_mod
from . import xlstm as xl
from .layers import (
    MLP,
    Norm,
    apply_norm,
    dense_init,
    embed_init,
    mlp_apply,
    sinusoidal_positions,
    truncated_normal,
)

__all__ = [
    "EncoderLayer",
    "Transformer",
    "TransformerBlock",
    "abstract_params",
    "check_supported",
    "decode_step",
    "encode",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "num_moe_layers",
    "padded_vocab",
    "param_tree",
    "prefill",
    "resolve_device",
    "tree_path",
    "tree_views",
]

def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def padded_vocab(cfg) -> int:
    """Vocab padded to a 256 multiple, as the reference pads it."""
    return _round_up(cfg.vocab, 256)


def num_moe_layers(cfg) -> int:
    return cfg.n_periods * sum(1 for b in cfg.pattern if b.ffn == "moe")


def resolve_device(device) -> torch.device:
    """``device`` as a torch device, ``"cuda"`` resolved to the current card
    (so it compares equal to a tensor's device); the CUDA default raises
    without a GPU (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the LM runs on device='cuda' by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a position scheme the port does not
    run (every config of ``configs/`` runs)."""
    if cfg.pos not in ("rope", "learned", "none"):
        raise NotImplementedError(f"{cfg.name}: {cfg.pos} decoder positions are not ported")


_MIXERS = {
    "attn": attn.attention_init,
    "mamba": mb.mamba_init,
    "mlstm": xl.mlstm_init,
    "slstm": xl.slstm_init,
}


class TransformerBlock(nn.Module):
    """One (mixer, feed-forward) position of the depth pattern."""

    def __init__(self, cfg, blk, generator=None, device=None) -> None:
        super().__init__()
        if blk.mixer not in _MIXERS:
            raise ValueError(f"unknown mixer {blk.mixer}")
        if blk.ffn not in ("mlp", "moe", "none"):
            raise ValueError(f"unknown ffn {blk.ffn}")
        self.mixer_kind, self.ffn_kind = blk.mixer, blk.ffn
        self.mixer_norm = Norm(cfg.d_model, cfg.norm, device)
        self.mixer = _MIXERS[blk.mixer](cfg, generator, device)
        if cfg.is_encoder_decoder:
            self.cross_norm = Norm(cfg.d_model, cfg.norm, device)
            self.cross = attn.attention_init(cfg, generator, device)
        if blk.ffn != "none":
            self.ffn_norm = Norm(cfg.d_model, cfg.norm, device)
        if blk.ffn == "mlp":
            self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, cfg.param_dtype, generator, device)
        elif blk.ffn == "moe":
            self.ffn = moe_mod.moe_init(cfg, generator, device)


class EncoderLayer(nn.Module):
    """One block of whisper's encoder: LayerNorm, non-causal self attention,
    LayerNorm, GELU MLP."""

    def __init__(self, cfg, generator=None, device=None) -> None:
        super().__init__()
        self.attn_norm = Norm(cfg.d_model, "ln", device)
        self.attn = attn.attention_init(cfg, generator, device)
        self.mlp_norm = Norm(cfg.d_model, "ln", device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, "gelu", cfg.param_dtype, generator, device)


class Encoder(nn.Module):
    """``enc_layers`` :class:`EncoderLayer` s and a final LayerNorm."""

    def __init__(self, cfg, generator=None, device=None) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, generator, device) for _ in range(cfg.enc_layers)
        )
        self.final_norm = Norm(cfg.d_model, "ln", device)


class Transformer(nn.Module):
    """The weights of one model; layouts as the reference's parameter tree
    (``embed [pv, d]``, ``lm_head [d, pv]``, ``pos_embed [max_pos, d]``,
    ``mm_proj [d, d]``; ``encoder.layers.<i>`` is layer ``i`` of the
    reference's stacked ``encoder.layers``).  ``generator=None`` leaves the
    matrices uninitialised (for loading)."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        check_supported(cfg)
        if generator is not None:
            device = generator.device
        pv, d, dt = padded_vocab(cfg), cfg.d_model, cfg.param_dtype
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg, cfg.pattern[i % len(cfg.pattern)], generator, device)
            for i in range(cfg.n_layers)
        )
        self.embed = embed_init(pv, d, dt, generator, device)
        self.final_norm = Norm(d, cfg.norm, device)
        if not cfg.tie_embeddings:
            self.lm_head = dense_init(d, pv, dt, generator, device=device)
        if cfg.pos == "learned":
            self.pos_embed = truncated_normal((cfg.max_pos, d), dt, 0.02, generator, device)
        if cfg.is_encoder_decoder:
            self.encoder = Encoder(cfg, generator, device)
        if cfg.n_patches:
            self.mm_proj = dense_init(d, d, dt, generator, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg, seed: int = 0, device="cuda") -> Transformer:
    """Random weights for ``cfg`` on ``device`` (the card unless the caller
    asks for the CPU), drawn from a ``torch.Generator`` seeded with
    ``seed``.  The same seed gives other numbers than the reference's
    ``jax.random`` key; ``repro_torch.convert.params_from_jax`` loads
    the reference's weights instead."""
    dev = resolve_device(device)
    return Transformer(cfg, torch.Generator(device=dev).manual_seed(seed))


def abstract_params(cfg) -> Transformer:
    """The :class:`Transformer` of ``cfg`` on the ``meta`` device: every
    parameter has its shape and dtype and no memory (the reference's
    ``jax.eval_shape`` of ``init_params``; ``param_tree`` of it gives the
    reference's stacked tree of shapes)."""
    return Transformer(cfg, device="meta")


def _layers(cfg):
    """(period, block name) of each layer, in depth order."""
    n = len(cfg.pattern)
    for i in range(cfg.n_layers):
        yield i // n, f"b{i % n}"


def _lookup(params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``: a lookup (not indexing, whose
    backward DTensor cannot shard, and whose sharding rules differ by torch
    version) on the whole table (a vocab-sharded lookup cannot take
    batch-sharded ids), so the rows follow the ids' batch placement; for
    plain tensors ``embed[tokens]``."""
    return torch.nn.functional.embedding(tokens, constrain(params.embed, (None, None)))


def _embed_inputs(params: Transformer, batch, cfg):
    """Token embedding, after llava's projected patch prefix, plus learned
    positions over the whole sequence, in ``cfg.dtype``: ``[B, S, d]``."""
    tokens = constrain(torch.as_tensor(batch["tokens"], device=params.device).long(),
                       ("batch", "seq"))
    x = _lookup(params, tokens)
    if cfg.n_patches:
        patches = torch.as_tensor(batch["patches"], device=params.device).to(cfg.dtype)
        x = torch.cat([patches @ params.mm_proj.to(cfg.dtype), x.to(cfg.dtype)], dim=1)
    if cfg.pos == "learned":
        x = x + params.pos_embed[: x.shape[1]][None]
    return constrain(x.to(cfg.dtype), ("batch", "seq", "embed"))


def encode(params: Transformer, frames, cfg) -> torch.Tensor:
    """Encoder states ``[B, n_frames, d]`` of the stub frame embeddings
    ``frames [B, n_frames, d]``: sinusoidal positions added, then
    ``enc_layers`` blocks of non-causal self attention and a GELU MLP."""
    x = torch.as_tensor(frames, device=params.device).to(cfg.dtype)
    pos = torch.from_numpy(sinusoidal_positions(x.shape[1], cfg.d_model))
    x = constrain(x + pos.to(x.device, cfg.dtype)[None], ("batch", "seq", "embed"))
    for lp in params.encoder.layers:
        y = apply_norm(x, lp.attn_norm, "ln")
        x = x + attn.attention_apply(lp.attn, y, cfg, causal=False)
        y = apply_norm(x, lp.mlp_norm, "ln")
        x = constrain(x + mlp_apply(lp.mlp, y, "gelu"), ("batch", "seq", "embed"))
    return apply_norm(x, params.encoder.final_norm, "ln")


def _enc_states(params: Transformer, batch, cfg) -> Optional[torch.Tensor]:
    return encode(params, batch["frames"], cfg) if cfg.is_encoder_decoder else None


def _cross(blk: TransformerBlock, x: torch.Tensor, ckv: Dict, cfg) -> torch.Tensor:
    """The block's cross attention over the encoder's K / V ``ckv``, with
    its residual."""
    h = apply_norm(x, blk.cross_norm, cfg.norm)
    return x + _like(attn.cross_attention(blk.cross, h, ckv, cfg), x)


def _head(params: Transformer, x: torch.Tensor, cfg, seq="seq") -> torch.Tensor:
    """Final logits in float32 (bf16 operands upcast: exact products,
    float32 sums, as ``preferred_element_type=float32``), placed as the
    rules place them: each rank's batch rows against its vocab shard (the
    weight gathered along ``d``, FSDP's gather before use)."""
    x = constrain(x, ("batch", seq, "embed"))
    if cfg.tie_embeddings:
        w = constrain(params.embed, ("vocab", None)).T
    else:
        w = constrain(params.lm_head, (None, "vocab"))
    return constrain(x.float() @ w.float(), ("batch", seq, "vocab"))


def _ffn(blk: TransformerBlock, x: torch.Tensor, cfg, capacity_factor=None):
    """The block's feed-forward with its residual: ``(x, MoE aux or None)``.
    An MoE layer routes at ``capacity_factor`` (None: ``cfg.moe_capacity``)."""
    if blk.ffn_kind == "none":
        return x, None
    h = apply_norm(x, blk.ffn_norm, cfg.norm)
    if blk.ffn_kind == "mlp":
        return x + _like(blk.ffn(h), x), None
    moe_fn = moe_mod.moe_apply_row_local if cfg.moe_row_local else moe_mod.moe_apply
    out, aux = moe_fn(blk.ffn, h, cfg, capacity_factor=capacity_factor)
    return x + _like(out, x), aux


def _like(y, x):
    """A block's branch output ``y`` placed as the residual stream ``x``
    (batch over the batch axes, ``d`` whole), so that the residual add
    keeps each rank's own rows: a sum over a sharded contraction resolves
    here, where the reference's rules place the stream.  No-op for plain
    tensors."""
    if not is_dtensor(y) or not is_dtensor(x):
        return y
    return pinned(y, x.placements)


def _mixer_apply(blk: TransformerBlock, h: torch.Tensor, cfg) -> torch.Tensor:
    if blk.mixer_kind == "attn":
        return attn.attention_apply(blk.mixer, h, cfg, causal=True, window=cfg.window)
    if blk.mixer_kind == "mamba":
        return mb.mamba_apply(blk.mixer, h, cfg)
    if blk.mixer_kind == "mlstm":
        return xl.mlstm_apply(blk.mixer, h, cfg)
    return xl.slstm_apply(blk.mixer, h, cfg)


def forward(params: Transformer, batch, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits ``[B, S, padded_vocab]`` (float32) and the MoE
    aux loss summed over the MoE layers (float32; 0 without one)."""
    x = _embed_inputs(params, batch, cfg)
    enc = _enc_states(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.blocks:
        x = x + _like(_mixer_apply(blk, apply_norm(x, blk.mixer_norm, cfg.norm), cfg), x)
        if enc is not None:
            x = _cross(blk, x, attn.cross_kv(blk.cross, enc), cfg)
        x, a = _ffn(blk, x, cfg)
        if a is not None:
            aux = aux + a
        # the block boundary (what the reference's remat'd scan saves)
        x = constrain(x, ("batch", "act_seq", "embed"))
    x = apply_norm(x, params.final_norm, cfg.norm)
    return _head(params, x, cfg), aux


def loss_fn(params: Transformer, batch, cfg):
    """Mean next-token cross entropy plus ``router_aux · aux / n`` over the
    ``n`` MoE layers (if any).  ``labels`` are already aligned to
    predict-next; positions with label < 0 are masked out, and llava's
    patch prefix carries no labels.  Returns ``(loss, metrics)``, metrics
    ``loss`` / ``ce`` / ``aux`` / ``ntok`` as float32 scalars."""
    logits, aux = forward(params, batch, cfg)
    if cfg.n_patches:
        logits = logits[:, cfg.n_patches :]
    labels = constrain(torch.as_tensor(batch["labels"], device=logits.device).long(),
                       ("batch", "seq"))
    if is_dtensor(logits):
        nll_sum, count = _sharded_nll(logits, labels)
    else:
        nll_sum, count = _token_nll(logits, labels)
    ntok = torch.clamp(count, min=1.0)
    ce = nll_sum / ntok
    nm = num_moe_layers(cfg)
    total = ce + cfg.router_aux * aux / nm if nm else ce
    metrics = {"loss": total, "ce": ce, "aux": aux, "ntok": ntok}
    return total, metrics


def _token_nll(logits: torch.Tensor, labels: torch.Tensor):
    """(Σ nll over the labelled tokens, their count) of float32 logits
    ``[B, S, V]`` and labels ``[B, S]`` (< 0: masked)."""
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - tgt) * mask).sum(), mask.sum()


def _sharded_nll(logits, labels):
    """:func:`_token_nll` of DTensor logits on each rank's own block
    ``[B/ranks, S, V/shards]``: the row max, the sum of exponentials and
    the target's logit, each reduced over the mesh dims that split the
    vocabulary, so no rank holds a whole row.  Returns DTensor scalars,
    partial sums over the mesh dims that split the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from ..compat import local_map

    mesh = logits.device_mesh
    vocab = [i for i, p in enumerate(logits.placements) if p == Shard(2)]
    groups = [mesh.get_group(i) for i in vocab if mesh.size(i) > 1]
    shape, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    v0, vl = offset[2], shape[2]
    tokens = tuple(Partial() if isinstance(p, Shard) and p.dim < 2 else Replicate()
                   for p in logits.placements)
    label_placements = tuple(
        Replicate() if i in vocab else p for i, p in enumerate(logits.placements))

    def local(x, y):
        if not groups:  # whole rows on every rank
            return _token_nll(x, y)
        # the row max needs no gradient: log Σ exp(x - m) + m for any m
        m = x.detach().amax(dim=-1)
        for g in groups:
            torch.distributed.all_reduce(m, op=torch.distributed.ReduceOp.MAX, group=g)
        logz = torch.log(sum_over(torch.exp(x - m[..., None]).sum(-1), groups)) + m
        idx = y - v0
        mine = (idx >= 0) & (idx < vl)
        tgt = torch.gather(x, -1, idx.clamp(0, vl - 1)[..., None])[..., 0]
        tgt = sum_over(torch.where(mine, tgt, torch.zeros_like(tgt)), groups)
        mask = (y >= 0).float()
        return ((logz - tgt) * mask).sum(), mask.sum()

    return local_map(local, out_placements=(tokens, tokens),
                     in_placements=(tuple(logits.placements), label_placements),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels)


def tree_path(name: str, cfg) -> Tuple[Tuple[str, ...], Optional[int]]:
    """Where the :class:`Transformer` parameter ``name`` lives in the
    reference's parameter tree: (its key path, the index it is stacked at,
    or None for an unstacked leaf).  Layer ``i`` is period ``i //
    len(pattern)`` of block ``b{i % len(pattern)}``; encoder layer ``i`` is
    index ``i`` of ``encoder.layers``."""
    path = name.split(".")
    if path[0] == "blocks":
        layer, n = int(path[1]), len(cfg.pattern)
        return ("periods", f"b{layer % n}", *path[2:]), layer // n
    if path[:2] == ["encoder", "layers"]:
        return ("encoder", "layers", *path[3:]), int(path[2])
    return tuple(path), None


def param_tree(params: Transformer, cfg) -> Dict:
    """The weights as the reference's parameter tree: nested dicts, each
    block position's weights stacked over periods (``[n_periods, ...]``).
    A copy, detached from ``params``."""
    stacks: Dict[Tuple[str, ...], list] = {}
    tree: Dict = {}
    for name, p in params.named_parameters():
        path, period = tree_path(name, cfg)
        if period is None:
            _put(tree, path, p.detach().clone())
        else:
            stacks.setdefault(path, []).append((period, p.detach()))
    for path, layers in stacks.items():
        _put(tree, path, torch.stack([p for _, p in sorted(layers, key=lambda t: t[0])]))
    return tree


def _put(tree: Dict, path: Tuple[str, ...], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def tree_views(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """``{parameter name: tensor}`` of a :class:`Transformer` over the
    reference-layout ``tree``: each stacked leaf (``periods``,
    ``encoder.layers``) unbound into its layers' views (no copy;
    differentiable back to the stacked leaf), for
    ``torch.func.functional_call``."""
    n = len(cfg.pattern)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: Tuple[str, ...]) -> None:
        for key, sub in node.items():
            if isinstance(sub, Mapping):
                walk(sub, path + (key,))
            elif path[:1] == ("periods",):
                block, rest = int(path[1][1:]), ".".join(path[2:] + (key,))
                for period, view in enumerate(sub.unbind(0)):
                    out[f"blocks.{period * n + block}.{rest}"] = view
            elif path[:2] == ("encoder", "layers"):
                rest = ".".join(path[2:] + (key,))
                for layer, view in enumerate(sub.unbind(0)):
                    out[f"encoder.layers.{layer}.{rest}"] = view
            else:
                out[".".join(path + (key,))] = sub

    walk(tree, ())
    return out


def _stack_cache(cfg, layer_caches) -> Dict:
    """Per-layer caches (``{"mixer": {...}}``, plus ``"cross"`` with an
    encoder) → the reference's structure, leaves stacked over periods."""
    n = len(cfg.pattern)
    return {
        "periods": {
            f"b{bi}": {
                part: {
                    name: torch.stack([c[part][name] for c in layer_caches[bi::n]])
                    for name in layer_caches[bi][part]
                }
                for part in layer_caches[bi]
            }
            for bi in range(n)
        }
    }


def _mixer_prefill(blk: TransformerBlock, h: torch.Tensor, cfg, max_len: int):
    if blk.mixer_kind == "attn":
        return attn.attention_prefill(blk.mixer, h, cfg, max_len, window=cfg.window)
    if blk.mixer_kind == "mamba":
        return mb.mamba_apply(blk.mixer, h, cfg, return_state=True)
    if blk.mixer_kind == "mlstm":
        return xl.mlstm_apply(blk.mixer, h, cfg, return_state=True)
    return xl.slstm_apply(blk.mixer, h, cfg, return_state=True)


def prefill(params: Transformer, batch, cfg, max_len: int):
    """Returns (last-position logits ``[B, pv]``, decode cache).  MoE layers
    route at ``cfg.moe_capacity_serve``."""
    with torch.inference_mode():
        x = _embed_inputs(params, batch, cfg)
        enc = _enc_states(params, batch, cfg)
        caches = []
        for blk in params.blocks:
            h, c = _mixer_prefill(blk, apply_norm(x, blk.mixer_norm, cfg.norm), cfg, max_len)
            x, cache = x + _like(h, x), {"mixer": constrain_tree(c, CACHE_AXES)}
            if enc is not None:
                cache["cross"] = attn.cross_kv(blk.cross, enc)
                x = _cross(blk, x, cache["cross"], cfg)
            x, _ = _ffn(blk, x, cfg, cfg.moe_capacity_serve)
            x = constrain(x, ("batch", "seq", "embed"))
            caches.append(cache)
        x = apply_norm(x[:, -1:], params.final_norm, cfg.norm)
        return _head(params, x, cfg, None)[:, 0], _stack_cache(cfg, caches)


def _init_block_cache(cfg, blk, batch: int, max_len: int, device) -> Dict:
    if blk.mixer == "attn":
        return attn.init_kv_cache(cfg, batch, max_len, window=cfg.window, device=device)
    if blk.mixer == "mamba":
        return mb.init_mamba_cache(cfg, batch, device)
    if blk.mixer == "mlstm":
        return xl.init_mlstm_cache(cfg, batch, device)
    if blk.mixer == "slstm":
        return xl.init_slstm_cache(cfg, batch, device)
    raise ValueError(f"unknown mixer {blk.mixer}")


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> Dict:
    """Fresh (empty) decode cache for ``batch`` rows (an encoder-decoder's
    cross K / V zero until ``prefill`` writes them)."""
    check_supported(cfg)
    dev = resolve_device(device)

    def stacked(layer: Dict) -> Dict:
        return {name: t[None].repeat((cfg.n_periods,) + (1,) * t.dim())
                for name, t in layer.items()}

    periods = {}
    for bi, blk in enumerate(cfg.pattern):
        periods[f"b{bi}"] = {"mixer": stacked(_init_block_cache(cfg, blk, batch, max_len, dev))}
        if cfg.is_encoder_decoder:
            shape = (cfg.n_periods, batch, cfg.n_frames, cfg.n_kv_heads, cfg.head_dim)
            periods[f"b{bi}"]["cross"] = {
                name: torch.zeros(shape, dtype=cfg.dtype, device=dev) for name in ("k", "v")
            }
    return {"periods": periods}


_DECODE = {"mamba": mb.mamba_decode, "mlstm": xl.mlstm_decode, "slstm": xl.slstm_decode}


def decode_step(params: Transformer, token, cache: Dict, cur_pos: int, cfg):
    """token ``[B, 1]`` ints, ``cur_pos`` an int (same for every row) ->
    (logits ``[B, pv]`` float32, new cache).  ``cache`` is left as it was:
    attention layers write into one copy of their K/V (a DTensor cache:
    into new tensors, restacked), recurrent layers return new states, and
    the cross K / V (which no step writes) are carried over as they are.
    MoE layers route at ``cfg.moe_capacity_serve``."""
    with torch.inference_mode():
        # the cache as the rules place it (batch, and the sequence over
        # model), whatever placements it arrives with
        cache = constrain_tree(cache, CACHE_AXES)
        kinds = [blk.mixer for blk in cfg.pattern]
        new = {
            "periods": {
                b: {"mixer": {n: t if is_dtensor(t) else t.clone()
                              for n, t in c["mixer"].items()}}
                for (b, c), kind in zip(cache["periods"].items(), kinds) if kind == "attn"
            }
        }
        states = {f"b{bi}": [] for bi in range(len(kinds))}
        tokens = constrain(torch.as_tensor(token, device=params.device).long(), ("batch", None))
        x = _lookup(params, tokens).to(cfg.dtype)
        if cfg.pos == "learned":
            x = x + params.pos_embed[cur_pos][None, None]
        x = constrain(x, ("batch", None, "embed"))
        for (period, name), blk in zip(_layers(cfg), params.blocks):
            h = apply_norm(x, blk.mixer_norm, cfg.norm)
            if blk.mixer_kind == "attn":
                layer = {n: t[period] for n, t in new["periods"][name]["mixer"].items()}
                y = attn.decode_into(blk.mixer, h, layer, cur_pos, cfg, window=cfg.window)
                if is_dtensor(layer["k"]):  # not written in place: restacked below
                    states[name].append(layer)
            else:
                layer = {n: t[period] for n, t in cache["periods"][name]["mixer"].items()}
                y, state = _DECODE[blk.mixer_kind](blk.mixer, h, layer, cfg)
                states[name].append(state)
            x = x + _like(y, x)
            if cfg.is_encoder_decoder:
                ckv = {n: t[period] for n, t in cache["periods"][name]["cross"].items()}
                h = apply_norm(x, blk.cross_norm, cfg.norm)
                x = x + _like(attn.cross_attention_decode(blk.cross, h, ckv, cfg), x)
            x, _ = _ffn(blk, x, cfg, cfg.moe_capacity_serve)
            x = constrain(x, ("batch", None, "embed"))
        for name, per_period in states.items():
            if not per_period:
                continue
            new["periods"][name] = {
                "mixer": {n: torch.stack([st[n] for st in per_period]) for n in per_period[0]}
            }
        for name, c in cache["periods"].items():
            if "cross" in c:
                new["periods"][name]["cross"] = c["cross"]
        # the blocks in init_cache's order: the engine pairs leaves by position
        new["periods"] = {f"b{bi}": new["periods"][f"b{bi}"] for bi in range(len(kinds))}
        x = apply_norm(x, params.final_norm, cfg.norm)
        return _head(params, x, cfg, None)[:, 0], new
