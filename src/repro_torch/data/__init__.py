"""Synthetic relational datasets (the paper's evaluation data)."""

from .synthetic import (
    SchemaBundle,
    favorita_like,
    fd_star_schema,
    figure1_schema,
    many_cat_schema,
    random_acyclic_schema,
)

__all__ = [
    "SchemaBundle",
    "favorita_like",
    "fd_star_schema",
    "figure1_schema",
    "many_cat_schema",
    "random_acyclic_schema",
]
