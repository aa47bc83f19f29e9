"""Synthetic relational datasets (the paper's evaluation data)."""

from .synthetic import (
    SchemaBundle,
    favorita_like,
    figure1_schema,
    random_acyclic_schema,
)

__all__ = [
    "SchemaBundle",
    "favorita_like",
    "figure1_schema",
    "random_acyclic_schema",
]
