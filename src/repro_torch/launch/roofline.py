"""Roofline terms of a dry-run cell (PyTorch port of the JAX package's
``launch/roofline.py``).

Three terms per (arch × shape × mesh), in seconds (the reference's
formulas, at the H100's constants of ``launch.mesh.HW``):

    compute    = FLOPs        / (chips × peak_FLOP/s)
    memory     = bytes        / (chips × HBM_bw)
    collective = collective_B / (chips × link_bw)

XLA's HLO text has no counterpart in torch: :class:`CollectiveBytes` is a
``TorchDispatchMode`` that sees each rank-local collective of a program
(the ``_c10d_functional`` ops that DTensor's redistributions and
``torch.distributed._functional_collectives`` issue, and point-to-point
``c10d`` sends) and sums each op's **result bytes** by kind, under the
reference's key names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``all-to-all``; ``collective-permute`` for point-to-point).  Under a
DTensor the results are each rank's shards, as the reference's
post-partitioning shapes are.  :func:`roofline_terms` takes that dict
where the reference takes the HLO text.

MODEL_FLOPS uses the classic 6·N·D (dense) / 6·N_active·D (MoE) estimate
per training step, or 2·N·D per generated token for decode — the "useful
compute" yardstick the roofline table compares counted FLOPs against.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .mesh import HW

__all__ = [
    "CollectiveBytes",
    "RooflineTerms",
    "TraversalNodeTerms",
    "collective_bytes",
    "roofline_terms",
    "model_flops",
    "skip_dispatch",
    "traversal_node_terms",
]

#: collective op name (any of the namespaces below) -> the reference's kind.
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def _collective_kind(func) -> Optional[str]:
    """The reference's kind of the aten-level op ``func``, or None if it is
    not a collective (``wait_tensor`` and the autograd wrappers are not)."""
    if func.namespace not in _NAMESPACES:
        return None
    return _KINDS.get(func._overloadpacket.__name__)


def _result_bytes(func, args, out) -> int:
    """Bytes of an op's result tensors (a send's: the tensors it sends)."""
    leaves = args[0] if func._overloadpacket.__name__ == "send" else out
    if isinstance(leaves, torch.Tensor):
        leaves = [leaves]
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


_SUBCLASSES: list = []


def skip_dispatch(types) -> Tuple[bool, bool]:
    """``(defer, shadow)`` for a mode that counts rank-local work: defer a
    DTensor op (return ``NotImplemented``, so the DTensor runs its local ops
    with the mode still on), and do not count what DTensor's sharding
    propagation runs on the global shapes: an op on fake tensors, or any op
    dispatched from inside the propagation's code (the meta tensors that
    its fake mode makes, and torch 2.13's decomposition-based propagation,
    for ops with no rule of their own such as ``einsum``, which traces on
    plain meta stand-ins)."""
    if not _SUBCLASSES:
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        _SUBCLASSES.extend((DTensor, FakeTensor))
    dtensor, fake = _SUBCLASSES
    if any(issubclass(t, dtensor) for t in types):
        return True, False
    return False, any(issubclass(t, fake) for t in types) or _in_propagation()


#: the modules of DTensor's sharding propagation (the second only in torch
#: versions with decomposition-based propagation)
_PROPAGATION = tuple(os.path.join("distributed", "tensor", name)
                     for name in ("_sharding_prop.py", "_decompositions.py"))


def _in_propagation() -> bool:
    """Whether the op being dispatched was called from DTensor's sharding
    propagation (a frame of its modules on the stack)."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename.endswith(_PROPAGATION):
            return True
        frame = frame.f_back
    return False


class CollectiveBytes(TorchDispatchMode):
    """Counts each rank-local collective's result bytes by kind while on
    (``by_kind``)."""

    def __init__(self) -> None:
        super().__init__()
        self.by_kind: Dict[str, int] = {}

    def add(self, func, args, out) -> None:
        kind = _collective_kind(func)
        if kind is not None:
            self.by_kind[kind] = self.by_kind.get(kind, 0) + _result_bytes(func, args, out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        defer, shadow = skip_dispatch(types)
        if defer:
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not shadow:
            self.add(func, args, out)
        return out


def collective_bytes(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Sum result-shape bytes of every collective that ``fn(*args,
    **kwargs)`` issues on this rank, by kind (the counterpart of parsing
    the partitioned HLO: an op's result size ~= bytes moved per chip for
    ring all-gather / reduce-scatter; all-reduce moves ~2× its payload —
    accounted for in :func:`total_collective_bytes`)."""
    with CollectiveBytes() as mode:
        fn(*args, **kwargs)
    return dict(mode.by_kind)


def total_collective_bytes(per_kind: Dict[str, int]) -> float:
    """Weighted wire bytes: ring all-reduce = reduce-scatter + all-gather
    (2× payload); the others move ~1× their result."""
    tot = 0.0
    for kind, b in per_kind.items():
        tot += 2.0 * b if kind == "all-reduce" else float(b)
    return tot


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # as the dry run counted them (see flops_scope)
    hlo_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, int]
    model_flops: float
    per_device_hbm_peak: Optional[float] = None
    #: calibrated semantics of the FLOP count (dryrun --calibrate):
    #: "per_shard" = numbers are already per device.
    flops_scope: str = "per_shard"

    @property
    def _div(self) -> float:
        return float(self.chips) if self.flops_scope == "global" else 1.0

    @property
    def flops_per_device(self) -> float:
        return self.hlo_flops / self._div

    @property
    def bytes_per_device(self) -> float:
        return self.hlo_bytes / self._div

    @property
    def global_flops(self) -> float:
        return self.flops_per_device * self.chips

    @property
    def t_compute(self) -> float:
        # == FLOPs_global / (chips × peak): evaluated per device
        return self.flops_per_device / HW.peak_flops_bf16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HW.hbm_bw

    @property
    def t_collective(self) -> float:
        # coll_bytes are already per-shard (rank-local results)
        return self.coll_bytes / HW.nvlink_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.global_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute-term share of the bound: T_comp / max(all terms)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t else 0.0

    def to_json(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_by_kind": self.coll_by_kind,
            "model_flops": self.model_flops,
            "flops_scope": self.flops_scope,
            "flops_per_device": self.flops_per_device,
            "global_flops": self.global_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "per_device_hbm_peak": self.per_device_hbm_peak,
        }


@dataclasses.dataclass
class TraversalNodeTerms:
    """Analytic bytes/FLOPs for ONE factorized-traversal feature node —
    the fused ``segment_view`` pass vs the unfused extend-then-group pair
    (``repro_torch.core.factorize``).  Shapes: ``n_rows`` view rows with
    blocks (c [N], l [N, k], q [N, k, k]), reduced to ``num_groups`` groups
    at ``degree`` ∈ {1, 2}; ``dtype_bytes`` per element, int32 segment ids.

    The fused kernel reads each input block once and writes only the
    ``[G, k+2, k+2]`` packed output — the extended ``[N, k+1, k+1]``
    tensor never round-trips through memory.  The unfused path writes it
    (extend) and reads it back (group), which is where the predicted
    speedup (a pure byte ratio — both paths are bandwidth-bound, the
    FLOP/byte intensity is far below any machine balance point) comes
    from.  ``achieved_fraction(seconds)`` turns a measured node time into
    the fraction of the HBM bandwidth bound.
    """

    n_rows: int
    k: int
    num_groups: int
    degree: int = 2
    dtype_bytes: int = 4

    def _block_elems(self, k: int) -> int:
        """Elements per row of (c, l[, q]) blocks with k features."""
        return 1 + k + (k * k if self.degree == 2 else 0)

    @property
    def packed_width(self) -> int:
        w = self.k + 2
        return w * w if self.degree == 2 else w

    @property
    def bytes_in(self) -> float:
        """Input blocks + feature column + int32 segment ids."""
        n, b = self.n_rows, self.dtype_bytes
        return n * (self._block_elems(self.k) + 1) * b + n * 4

    @property
    def bytes_fused(self) -> float:
        return self.bytes_in + self.num_groups * self.packed_width * self.dtype_bytes

    @property
    def bytes_unfused(self) -> float:
        """Extend writes the [N, k+1(, k+1)] blocks, group reads them back
        and writes the grouped result — two extra N-sized round-trips."""
        n, b = self.n_rows, self.dtype_bytes
        ext = self._block_elems(self.k + 1)
        return (
            self.bytes_in
            + 2.0 * n * ext * b  # write + re-read of the extended blocks
            + n * b  # re-read of c by the group stage
            + self.num_groups * ext * b
        )

    @property
    def flops_fused(self) -> float:
        """Assembly muls (x·c, x²·c, x·l) + one add per packed cell."""
        n = self.n_rows
        muls = n * (self.k + 2) if self.degree == 2 else n * 1
        return muls + n * self.packed_width

    @property
    def arith_intensity(self) -> float:
        return self.flops_fused / self.bytes_fused if self.bytes_fused else 0.0

    @property
    def t_memory_fused(self) -> float:
        return self.bytes_fused / HW.hbm_bw

    @property
    def t_memory_unfused(self) -> float:
        return self.bytes_unfused / HW.hbm_bw

    @property
    def predicted_speedup(self) -> float:
        """Bandwidth-bound fused-over-unfused node throughput ratio."""
        return self.bytes_unfused / self.bytes_fused if self.bytes_fused else 0.0

    def achieved_gbs(self, seconds: float) -> float:
        return self.bytes_fused / seconds / 1e9 if seconds > 0 else 0.0

    def achieved_fraction(self, seconds: float) -> float:
        """Measured node time → fraction of the HBM bandwidth bound."""
        return self.t_memory_fused / seconds if seconds > 0 else 0.0

    def to_json(self) -> Dict:
        return {
            "n_rows": self.n_rows,
            "k": self.k,
            "num_groups": self.num_groups,
            "degree": self.degree,
            "dtype_bytes": self.dtype_bytes,
            "bytes_fused": self.bytes_fused,
            "bytes_unfused": self.bytes_unfused,
            "flops_fused": self.flops_fused,
            "arith_intensity": self.arith_intensity,
            "t_memory_fused": self.t_memory_fused,
            "predicted_speedup": self.predicted_speedup,
        }


def traversal_node_terms(
    n_rows: int,
    k: int,
    num_groups: int,
    degree: int = 2,
    dtype_bytes: int = 4,
) -> TraversalNodeTerms:
    """Per-node traversal accounting for the roofline audit: bytes/FLOPs
    of one fused extend-and-group node from its view shape and degree."""
    if degree not in (1, 2):
        raise ValueError(f"degree must be 1 or 2, got {degree}")
    return TraversalNodeTerms(
        n_rows=int(n_rows),
        k=int(k),
        num_groups=int(num_groups),
        degree=int(degree),
        dtype_bytes=int(dtype_bytes),
    )


def model_flops(cfg, shape) -> float:
    """Analytic 'useful FLOPs' for one step of this cell."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    if shape.kind == "train":
        return 6.0 * n_active * tokens  # fwd + bwd
    return 2.0 * n_active * tokens  # inference fwd only


def roofline_terms(
    cfg,
    shape,
    mesh_name: str,
    chips: int,
    cost: Dict[str, float],
    coll_by_kind: Dict[str, int],
    memory_stats: Optional[Dict] = None,
) -> RooflineTerms:
    """The terms of one cell from its counted ``cost`` (``flops``,
    ``bytes accessed``) and :class:`CollectiveBytes`' ``coll_by_kind``."""
    per_kind = dict(coll_by_kind)
    return RooflineTerms(
        arch=cfg.name,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=float(cost.get("flops", 0.0)),
        hlo_bytes=float(cost.get("bytes accessed", 0.0)),
        coll_bytes=total_collective_bytes(per_kind),
        coll_by_kind=per_kind,
        model_flops=model_flops(cfg, shape),
        per_device_hbm_peak=(memory_stats or {}).get("peak_bytes"),
    )
