"""The store layer's public READ contract, as an explicit Protocol.

``Store`` and ``StoreSnapshot`` duck-type the same read surface; every
``FactorizedEngine`` runs against either interchangeably.

The contract is *reads only*: anything here is safe against a snapshot
frozen at an old version.  Mutations (``append`` / ``put`` / ``add_fd``)
and maintenance state (the view cache, the pending-delta log) are
``Store``-only and deliberately absent.

``flush`` sits on the read surface because draining pending deltas is a
*read-side* concern under lazy maintenance: a reader that wants warm
caches folds the log first.  On a stale ``StoreSnapshot`` it is a no-op
(the snapshot's frozen catalog needs no cache maintenance); on a current
one it forwards to the parent store.
"""

from __future__ import annotations

from typing import (
    TYPE_CHECKING,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    runtime_checkable,
)

import numpy as np

if TYPE_CHECKING:  # typing-only: avoid import cycles at runtime
    from .factorize import Cofactors
    from .fd import FDReduction, FunctionalDependency
    from .relation import Relation
    from .variable_order import VariableOrder

__all__ = ["StoreReads"]


@runtime_checkable
class StoreReads(Protocol):
    """What a reader (engine, solver) may ask of a store-like.

    Implemented by :class:`repro_torch.core.store.Store` and
    :class:`repro_torch.core.store.StoreSnapshot`.
    """

    # -- catalog ---------------------------------------------------------------
    def get(self, name: str) -> "Relation":
        """The relation stored under ``name`` (KeyError if absent)."""
        ...

    def names(self) -> List[str]:
        """Names of all cataloged relations."""
        ...

    def relations(self) -> List["Relation"]:
        """All cataloged relations."""
        ...

    def total_rows(self) -> int:
        """Sum of row counts over the catalog."""
        ...

    def attr_domain(self, attr: str) -> int:
        """Dictionary-domain size of a key attribute."""
        ...

    # -- dictionary encodings --------------------------------------------------
    def attr_encoding(
        self, rel_name: str, attr: str, override: Optional["Relation"] = None
    ) -> np.ndarray:
        """int32 ids of a relation's column under the store's append-only
        attribute dictionary."""
        ...

    def attr_values_array(self, attr: str) -> np.ndarray:
        """id → value translation array of an attribute's dictionary."""
        ...

    # -- statistics ------------------------------------------------------------
    def column_moments(self, col: str) -> Tuple[float, float, int]:
        """(sum, max|x|, count) of ``col`` over the relations holding it."""
        ...

    # -- functional dependencies -----------------------------------------------
    def fds(self) -> List["FunctionalDependency"]:
        """The FD catalog."""
        ...

    def fd_reduction(self, cat: Sequence[str]) -> "FDReduction":
        """FD reduction plan of a categorical attribute list."""
        ...

    # -- aggregates ------------------------------------------------------------
    def sufficient_stats(
        self,
        vorder: "VariableOrder",
        features: Sequence[str],
        label: Optional[str] = None,
        categorical: Sequence[str] = (),
        backend: Optional[str] = None,
        refresh: bool = False,
        reduce_fds: bool = False,
        device="cuda",
    ):
        """Sufficient statistics (cofactors) for a regression over the
        factorized join — the single read entry point; see
        ``Store.sufficient_stats``."""
        ...

    def cofactors(
        self,
        vorder: "VariableOrder",
        features: Sequence[str],
        backend: str = "torch",
        refresh: bool = False,
        device="cuda",
    ) -> "Cofactors":
        """Continuous-only sufficient statistics (thin wrapper)."""
        ...

    def cat_cofactors(
        self,
        vorder: "VariableOrder",
        cont: Sequence[str],
        cat: Sequence[str],
        backend: str = "numpy",
        refresh: bool = False,
        reduce_fds: bool = False,
        device="cuda",
    ):
        """Categorical sufficient statistics (thin wrapper)."""
        ...

    def materialize_join(
        self, names: Optional[Sequence[str]] = None
    ) -> "Relation":
        """The flat natural join — the noPre baseline path."""
        ...

    # -- consistency -----------------------------------------------------------
    def snapshot(self) -> "StoreReads":
        """An immutable read view at the current version (snapshots
        return themselves)."""
        ...

    @property
    def live_version(self) -> int:
        """The live store's current catalog version (a snapshot reaches
        through to its parent)."""
        ...

    def flush(self, names: Optional[Sequence[str]] = None) -> Dict[str, int]:
        """Fold pending appends into the caches (lazy maintenance);
        no-op and zero-stats on an already-clean or frozen view."""
        ...

    def cache_info(self) -> Dict[str, int]:
        """Cache, counter and pending-delta report of the live store."""
        ...
