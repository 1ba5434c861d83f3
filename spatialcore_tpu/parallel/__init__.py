"""Multi-chip scaling: mesh construction and sharded statistics.

The reference has no distributed layer at all (SURVEY.md §2.9 — its scaling
tools are Python batching loops). Here the cell axis and the gene axis shard
over a ``jax.sharding.Mesh``: gene-sharded permutation nulls are
embarrassingly parallel (each device keeps the full fixed-degree graph and
its gene shard; identical counter-based keys keep draws bitwise equal to the
single-device result), while cell-sharded layouts let XLA insert all-gathers
over the device interconnect for the neighbor gathers.
"""

from .mesh import auto_mesh, cell_sharding, gene_sharding, replicated
from .graph import sharded_build_graph, sharded_knn
from .stats import (
    sharded_banded_getis,
    sharded_banded_lees_l,
    sharded_banded_local_geary,
    sharded_banded_local_moran,
    sharded_banded_permutation_test,
    sharded_getis_ord,
    sharded_getis_ord_2d,
    sharded_lees_l,
    sharded_lees_l_2d,
    sharded_local_geary_2d,
    sharded_local_moran,
    sharded_local_moran_2d,
    sharded_moran,
    sharded_permutation_test,
)

__all__ = [
    "auto_mesh", "gene_sharding", "cell_sharding", "replicated",
    "sharded_moran", "sharded_local_moran", "sharded_permutation_test",
    "sharded_lees_l", "sharded_getis_ord", "sharded_local_moran_2d",
    "sharded_local_geary_2d", "sharded_lees_l_2d", "sharded_getis_ord_2d",
    "sharded_banded_permutation_test", "sharded_banded_local_moran",
    "sharded_banded_local_geary", "sharded_banded_getis",
    "sharded_banded_lees_l",
    "sharded_knn", "sharded_build_graph",
]
