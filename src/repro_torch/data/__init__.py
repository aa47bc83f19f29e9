"""Synthetic relational datasets (the paper's evaluation data) and the LM
token pipeline."""

from .synthetic import (
    SchemaBundle,
    favorita_like,
    fd_star_schema,
    figure1_schema,
    many_cat_schema,
    random_acyclic_schema,
)
from .tokens import TokenPipeline

__all__ = [
    "SchemaBundle",
    "TokenPipeline",
    "favorita_like",
    "fd_star_schema",
    "figure1_schema",
    "many_cat_schema",
    "random_acyclic_schema",
]
