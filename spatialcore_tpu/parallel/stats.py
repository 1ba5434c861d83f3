"""Sharded spatial statistics: the multi-chip entry points.

Gene-sharded execution of the autocorrelation kernels: ``Z`` is placed with
its gene axis split across the mesh's ``genes`` axis, the fixed-degree graph
is replicated, and the exact single-device kernels from ``ops.moran`` run
under ``jit`` — XLA keeps every permutation draw local to its gene shard
(no collectives in the hot loop) and the counter-based keys make results
bitwise identical to the single-device run. This is the design SURVEY.md
§2.9 calls for in place of the reference's Python batching.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.graph import SpatialGraph
from ..ops.moran import (
    local_moran, moran_observed, permutation_test_global, standardize)
from .mesh import gene_sharding, replicated


def _place(graph: SpatialGraph, X: jax.Array, mesh: Mesh):
    """Device placement: graph replicated, X gene-sharded."""
    rep = replicated(mesh)
    gs = gene_sharding(mesh, ndim=2)
    graph = SpatialGraph(
        neighbor_idx=jax.device_put(graph.neighbor_idx, rep),
        neighbor_w=jax.device_put(graph.neighbor_w, rep),
        valid=jax.device_put(graph.valid, rep),
        distances=jax.device_put(graph.distances, rep))
    return graph, jax.device_put(X, gs)


def sharded_moran(
    graph: SpatialGraph,
    X: jax.Array,
    S0: float,
    mesh: Mesh,
) -> jax.Array:
    """Global Moran's I per gene, gene-sharded over the mesh."""
    graph, X = _place(graph, X, mesh)
    with mesh:
        Z, _ = jax.jit(standardize)(X)
        return jax.jit(moran_observed, static_argnames=())(graph, Z, S0)


def sharded_permutation_test(
    graph: SpatialGraph,
    X: jax.Array,
    S0: float,
    seed: int,
    n_permutations: int,
    mesh: Mesh,
    stat: str = "moran",
    alternative: str = "greater",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(p, null_mean, null_std) per gene; draws shard-local per gene shard.

    Bitwise equal to the single-device kernel: the permutation for draw p is
    keyed by (seed, draw) only, so every shard applies the same shuffle to
    its own gene columns.
    """
    graph, X = _place(graph, X, mesh)
    with mesh:
        Z, _ = jax.jit(standardize)(X)
        observed = moran_observed(graph, Z, S0)
        return permutation_test_global(
            graph, Z, S0, observed, seed=seed,
            n_permutations=n_permutations, stat=stat,
            alternative=alternative)


def sharded_banded_permutation_test(
    plan,
    Z: jax.Array,
    S0: float,
    observed: jax.Array,
    seed: int,
    n_permutations: int,
    mesh: Mesh,
    den: jax.Array | None = None,
    stat: str = "moran",
    alternative: str = "greater",
    precision: str = "bf16",
    sz: jax.Array | None = None,
    draw_offset: int = 0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Banded permutation null (ops.banded), gene-sharded over the mesh.

    The NullPlan (Hilbert order, band edges, far-edge lists — all functions
    of the graph only) is replicated; ``Z``/``observed``/``den`` shard on
    the gene axis. Every op in the draw loop — Feistel permutation, row
    gather ``Z[perm]``, band matmuls, far-edge gathers, per-gene reductions
    — acts columnwise on the gene axis, so XLA partitions the scan with
    ZERO collectives (asserted by tests/test_parallel.py's HLO inspection)
    and throughput scales linearly in the gene-shard count. Results are
    bitwise identical to the single-device kernel (counter-based draws
    shared across shards).
    """
    from ..ops.banded import NullPlan, banded_permutation_test

    rep = replicated(mesh)
    gs1 = NamedSharding(mesh, P("genes"))
    plan = NullPlan(*(jax.device_put(f, rep) if isinstance(f, jax.Array)
                      else f for f in plan))
    Z = jax.device_put(Z, gene_sharding(mesh, ndim=2))
    observed = jnp.asarray(observed)
    if observed.ndim == 2:   # fused stat="moran_geary": [2, G] stacked
        observed = jax.device_put(observed, NamedSharding(mesh, P(None, "genes")))
    else:
        observed = jax.device_put(observed, gs1)
    if den is not None:
        den = jax.device_put(den, gs1)
    if sz is not None:
        sz = jax.device_put(sz, gs1)
    with mesh:
        return banded_permutation_test(
            plan, Z, S0, observed, seed=seed,
            n_permutations=n_permutations, stat=stat,
            alternative=alternative, den=den,
            precision=precision, sz=sz, draw_offset=draw_offset)


def sharded_banded_local_moran(
    plan,
    graph: SpatialGraph,
    Z: jax.Array,
    seed: int,
    n_permutations: int,
    mesh: Mesh,
    precision: str = "int8",
    perm_method: str = "feistel",
):
    """Banded LISA nulls (default fully-integer int8), gene-sharded.

    The NullPlan and graph are replicated; ``Z`` and all four [N, G]
    outputs shard on the gene axis. Every op in the int8 draw loop — the
    shared Feistel permutation, the int8 row gather, the band einsum, the
    far-edge scatter-add, the counter update — acts columnwise on genes,
    so the scan partitions with ZERO collectives (HLO-inspected in
    tests/test_parallel.py) and LISA-null throughput scales linearly in
    the gene-shard count. Results are bitwise identical to the
    single-device kernel.
    """
    from ..ops.banded import NullPlan, banded_local_moran

    rep = replicated(mesh)
    plan = NullPlan(*(jax.device_put(f, rep) if isinstance(f, jax.Array)
                      else f for f in plan))
    graph, Z = _place(graph, Z, mesh)
    with mesh:
        return banded_local_moran(plan, graph, Z, seed=seed,
                                  n_permutations=n_permutations,
                                  precision=precision,
                                  perm_method=perm_method)


def sharded_banded_local_geary(
    plan,
    graph: SpatialGraph,
    Z: jax.Array,
    seed: int,
    n_permutations: int,
    mesh: Mesh,
    precision: str = "f32",
):
    """Banded local-Geary total nulls, gene-sharded (same layout as
    :func:`sharded_banded_local_moran`: plan/graph replicated, Z and the
    [N, G] outputs on the gene axis, zero collectives per draw)."""
    from ..ops.banded import NullPlan, banded_local_geary

    rep = replicated(mesh)
    plan = NullPlan(*(jax.device_put(f, rep) if isinstance(f, jax.Array)
                      else f for f in plan))
    _, Z = _place(graph, Z, mesh)
    with mesh:
        return banded_local_geary(plan, Z, seed, n_permutations,
                                  precision=precision)


def sharded_banded_getis(
    plan,
    graph: SpatialGraph,
    X: jax.Array,
    seed: int,
    n_permutations: int,
    mesh: Mesh,
    star: bool = True,
    alternative: str = "two-sided",
    precision: str = "f32",
):
    """Banded Getis-Ord nulls, gene-sharded: the column stats, gather,
    band matmuls and counters all act columnwise — zero collectives.
    ``precision="int8"`` decides in exact integer domains, making the
    sharded p BITWISE equal to single-device at any shard width (f32
    comparisons are ulp-stable only at matching widths — XLA picks dot
    tilings per width)."""
    from ..ops.banded import NullPlan, banded_getis

    rep = replicated(mesh)
    plan = NullPlan(*(jax.device_put(f, rep) if isinstance(f, jax.Array)
                      else f for f in plan))
    _, X = _place(graph, X, mesh)
    with mesh:
        return banded_getis(plan, X, seed, n_permutations, star=star,
                            alternative=alternative, precision=precision)


def sharded_banded_lees_l(
    plan,
    graph: SpatialGraph,
    Zx: jax.Array,
    Zy: jax.Array,
    seed: int,
    n_permutations: int,
    mesh: Mesh,
    precision: str = "bf16",
    compute_cell_pvalues: bool = False,
):
    """Banded Lee's L nulls sharded over the PAIR axis (Lee's gene axis):
    Zx/Zy [N, P] split on "genes", plan replicated, zero collectives."""
    from ..ops.banded import NullPlan, banded_lees_l

    rep = replicated(mesh)
    plan = NullPlan(*(jax.device_put(f, rep) if isinstance(f, jax.Array)
                      else f for f in plan))
    gs = gene_sharding(mesh, ndim=2)
    Zx = jax.device_put(Zx, gs)
    Zy = jax.device_put(Zy, gs)
    with mesh:
        return banded_lees_l(plan, Zx, Zy, seed, n_permutations,
                             precision=precision,
                             compute_cell_pvalues=compute_cell_pvalues)


def sharded_lees_l(
    graph: SpatialGraph,
    Zx: jax.Array,
    Zy: jax.Array,
    seed: int,
    n_permutations: int,
    mesh: Mesh,
    compute_cell_pvalues: bool = False,
):
    """Lee's L for many gene pairs, pair-axis sharded over the mesh.

    ``Zx``/``Zy`` are [N, P] standardized pair columns; the pair axis maps
    onto the mesh's ``genes`` axis (each draw's shuffle is shared across
    pairs via counter-based keys, so shards never communicate).
    """
    from ..ops.lee import lees_l_pairs

    rep = replicated(mesh)
    gs = gene_sharding(mesh, ndim=2)
    graph = SpatialGraph(
        neighbor_idx=jax.device_put(graph.neighbor_idx, rep),
        neighbor_w=jax.device_put(graph.neighbor_w, rep),
        valid=jax.device_put(graph.valid, rep),
        distances=jax.device_put(graph.distances, rep))
    Zx = jax.device_put(Zx, gs)
    Zy = jax.device_put(Zy, gs)
    with mesh:
        return lees_l_pairs(graph, Zx, Zy, seed=seed,
                            n_permutations=n_permutations,
                            compute_cell_pvalues=compute_cell_pvalues)


def sharded_local_moran(
    graph: SpatialGraph,
    X: jax.Array,
    seed: int,
    n_permutations: int,
    mesh: Mesh,
):
    """LISA with permutation p-values, gene-sharded; [N, G] outputs keep
    the gene axis sharded."""
    graph, X = _place(graph, X, mesh)
    with mesh:
        Z, _ = jax.jit(standardize)(X)
        return local_moran(graph, Z, seed=seed,
                           n_permutations=n_permutations)


def sharded_local_moran_2d(
    graph: SpatialGraph,
    Z: jax.Array,
    seed: int,
    n_permutations: int,
    mesh: Mesh,
):
    """LISA with BOTH axes sharded: cells × genes over the full mesh.

    For outputs that exceed one device's memory (the north-star 1M × 5k
    f32 local-Moran field is 20 GB per output plane), the [N, G] inputs
    and all four [N, G] outputs are laid out ("cells", "genes") so each
    device holds only its
    (N/cs × G/gs) tile. Each permutation draw's row gather ``Z[perm]``
    crosses cell shards — XLA lowers it to a collective whose temp is
    bounded by the GENE shard width (an [N, G/gs] slab), so the gene axis
    caps the transient while the cell axis caps the resident footprint.

    ``Z`` must be pre-standardized (standardizing inside the cell-sharded
    region would change the reduction order of the column means and break
    the bitwise-identical-across-meshes guarantee; gathers and elementwise
    ops are order-free, so the outputs here are bitwise equal to the
    single-device kernel).
    """
    cs2 = NamedSharding(mesh, P("cells", "genes"))
    cell_rows = NamedSharding(mesh, P("cells"))
    graph = SpatialGraph(
        neighbor_idx=jax.device_put(graph.neighbor_idx, cell_rows),
        neighbor_w=jax.device_put(graph.neighbor_w, cell_rows),
        valid=jax.device_put(graph.valid, cell_rows),
        distances=jax.device_put(graph.distances, cell_rows))
    Z = jax.device_put(Z, cs2)
    with mesh:
        return local_moran(graph, Z, seed=seed,
                           n_permutations=n_permutations)


def _place_2d(graph: SpatialGraph, mesh: Mesh):
    """Cell-sharded graph rows for the cells × genes layouts."""
    cell_rows = NamedSharding(mesh, P("cells"))
    return SpatialGraph(
        neighbor_idx=jax.device_put(graph.neighbor_idx, cell_rows),
        neighbor_w=jax.device_put(graph.neighbor_w, cell_rows),
        valid=jax.device_put(graph.valid, cell_rows),
        distances=jax.device_put(graph.distances, cell_rows))


def sharded_local_geary_2d(
    graph: SpatialGraph,
    Z: jax.Array,
    seed: int,
    n_permutations: int,
    mesh: Mesh,
    null: str = "conditional",
):
    """Local Geary's C with BOTH axes sharded: cells × genes over the
    full mesh (the :func:`sharded_local_moran_2d` layout for the next
    >HBM [N, G] output family).

    ``Z`` must be pre-standardized (the :func:`sharded_local_moran_2d`
    caveat: standardizing inside the cell-sharded region would change
    the column-mean reduction order). The statistic body is gathers,
    per-row k-sums and elementwise comparisons — all order-free — so
    outputs are bitwise equal to the single-device kernel.
    """
    from ..ops.moran import local_geary

    graph = _place_2d(graph, mesh)
    Z = jax.device_put(Z, NamedSharding(mesh, P("cells", "genes")))
    with mesh:
        return local_geary(graph, Z, seed=seed,
                           n_permutations=n_permutations, null=null)


def sharded_lees_l_2d(
    graph: SpatialGraph,
    Zx: jax.Array,
    Zy: jax.Array,
    seed: int,
    n_permutations: int,
    mesh: Mesh,
    compute_cell_pvalues: bool = False,
):
    """Local Lee's L with cells × pairs sharded over the full mesh.

    ``Zx``/``Zy`` are [N, P] pre-standardized pair columns (see the
    :func:`sharded_local_moran_2d` standardization caveat). The per-cell
    L, lag, and cell p-values land ("cells", "genes")-sharded; the
    global statistic reduces over the cell axis (one collective per
    draw, outside the per-cell hot path). Per-cell outputs are bitwise
    equal to single-device; the global L's cross-shard sum agrees to
    f32 reduction tolerance.
    """
    from ..ops.lee import lees_l_pairs

    graph = _place_2d(graph, mesh)
    cs2 = NamedSharding(mesh, P("cells", "genes"))
    Zx = jax.device_put(Zx, cs2)
    Zy = jax.device_put(Zy, cs2)
    with mesh:
        return lees_l_pairs(graph, Zx, Zy, seed=seed,
                            n_permutations=n_permutations,
                            compute_cell_pvalues=compute_cell_pvalues)


def sharded_getis_ord_2d(
    graph: SpatialGraph,
    X: jax.Array,
    mesh: Mesh,
    star: bool = True,
    alternative: str = "two-sided",
    seed: int = 0,
    n_permutations: int = 0,
):
    """Getis-Ord Gi*/Gi with cells × genes sharded over the full mesh.

    Unlike the Z-input kernels, Getis-Ord computes its column moments
    from raw ``X`` inside the kernel; under cell sharding those column
    reductions become cross-shard partial sums, so G/z-scores agree
    with the single-device kernel to f32 reduction tolerance rather
    than bitwise (the gene-sharded :func:`sharded_getis_ord` keeps each
    column shard-local and stays exact — prefer it unless the [N, G]
    outputs themselves exceed one chip). Permutation p-values compare
    draws to the SAME sharded program's observed G, so they remain
    internally consistent.
    """
    from ..ops.getis import getis_ord

    graph = _place_2d(graph, mesh)
    X = jax.device_put(jnp.asarray(X),
                       NamedSharding(mesh, P("cells", "genes")))
    with mesh:
        return getis_ord(graph, X, star=star, alternative=alternative,
                         seed=seed, n_permutations=n_permutations)


def sharded_getis_ord(
    graph: SpatialGraph,
    X: jax.Array,
    mesh: Mesh,
    star: bool = True,
    alternative: str = "two-sided",
    seed: int = 0,
    n_permutations: int = 0,
):
    """Getis-Ord Gi*/Gi gene-sharded over the mesh.

    The statistic is independent per gene (column means/stds and the
    binary neighbor sums all act columnwise), so the gene axis shards
    with no collectives in the hot loop; [N, G] outputs keep the gene
    axis sharded. Permutation p-values are bitwise equal to the
    single-device kernel (identical counter-based draws); z-scores agree
    to float32 tolerance (XLA may re-tile the column reductions).
    """
    from ..ops.getis import getis_ord

    graph, X = _place(graph, X, mesh)
    with mesh:
        return getis_ord(graph, X, star=star, alternative=alternative,
                         seed=seed, n_permutations=n_permutations)
