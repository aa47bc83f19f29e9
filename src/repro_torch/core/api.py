"""The store layer's public READ contract, as an explicit Protocol.

``Store`` and ``StoreSnapshot`` duck-type the same read surface; every
``FactorizedEngine`` runs against either interchangeably.  This port's
store carries the catalog, dictionary, statistics and functional-dependency
reads; the result caches and pending-delta log of the JAX package are not
part of it yet, so they are absent here.
"""

from __future__ import annotations

from typing import (
    TYPE_CHECKING,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    runtime_checkable,
)

import numpy as np

if TYPE_CHECKING:  # typing-only: avoid import cycles at runtime
    from .fd import FDReduction, FunctionalDependency
    from .relation import Relation

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
    def attr_encoding(self, rel_name: str, attr: str) -> np.ndarray:
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
