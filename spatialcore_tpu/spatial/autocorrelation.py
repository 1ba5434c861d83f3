"""Public spatial-autocorrelation API: Moran's I, Geary's C, Lee's L.

API parity with /root/reference/src/spatialcore/spatial/autocorrelation.py
(function names, parameters, output keys), backed by the device kernel layer in
``spatialcore_tpu.ops`` instead of squidpy/sklearn/scipy:

- ``build_spatial_weights`` → fixed-degree row-normalized graph
  (reference :342-413 builds a scipy CSR via sklearn ball-tree)
- ``morans_i`` → own Moran kernel + analytic moments + seeded on-device
  permutations (reference :421-648 delegates to squidpy)
- ``gearys_c`` → same kernel family (not in the reference; BASELINE config 2)
- ``local_morans_i`` → vmapped LISA (reference :656-983 loops in Python)
- ``lees_l`` / ``lees_l_local`` → bivariate kernels (reference :991-1479)
"""

from __future__ import annotations

import time
from itertools import combinations
from typing import List, Literal, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import scipy.sparse as sp

from ..core.logging import get_logger
from ..core.metadata import update_metadata
from ..ops.moran import join_counts as _join_counts_kernel
from ..ops import (
    QUADRANT_LABELS,
    SpatialGraph,
    apply_fdr,
    build_graph,
    classify_quadrants,
    geary_analytic_moments,
    geary_observed,
    graph_moments,
    lees_l_pairs,
    local_moran,
    moran_analytic_moments,
    moran_observed,
    p_from_z,
    permutation_test_global,
    standardize,
)

logger = get_logger("spatial.autocorrelation")

GRAPH_UNS_KEY = "spatial_graph"


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def build_spatial_weights(
    adata,
    n_neighbors: int = 6,
    spatial_key: str = "spatial",
    include_self: bool = False,
    store: bool = True,
    radius: Optional[float] = None,
    k_max: Optional[int] = None,
) -> SpatialGraph:
    """Build the row-normalized fixed-degree spatial weights graph.

    Equivalent of the reference's CSR weights (each row sums to 1, binary kNN
    adjacency, self excluded unless ``include_self``); returns a
    :class:`~spatialcore_tpu.ops.SpatialGraph` whose ``to_csr()`` matches the
    reference output exactly. Passing ``radius`` (with a ``k_max`` degree
    cap) builds a radius graph instead — cells whose in-radius neighbor
    count exceeds ``k_max`` raise loudly (static shapes need a cap). When
    ``store`` is set the graph arrays are cached in
    ``adata.uns['spatial_graph']`` for ``use_existing_graph``.
    """
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found. Spatial coordinates are required.")
    coords = np.asarray(adata.obsm[spatial_key])
    n_cells = coords.shape[0]
    logger.debug(f"Building spatial weights: {n_cells:,} cells, "
                 f"{'radius=' + str(radius) if radius else 'k=' + str(n_neighbors)}")
    graph = build_graph(coords, n_neighbors=n_neighbors,
                        include_self=include_self, radius=radius, k_max=k_max)
    if store:
        adata.uns[GRAPH_UNS_KEY] = {
            "neighbor_idx": np.asarray(graph.neighbor_idx),
            "neighbor_w": np.asarray(graph.neighbor_w),
            "valid": np.asarray(graph.valid),
            "distances": np.asarray(graph.distances),
            "params": {"n_neighbors": n_neighbors, "include_self": include_self,
                       "spatial_key": spatial_key, "radius": radius,
                       "k_max": k_max},
        }
    return graph


def _load_stored_graph(adata) -> Optional[SpatialGraph]:
    g = adata.uns.get(GRAPH_UNS_KEY)
    if not isinstance(g, dict) or "neighbor_idx" not in g:
        return None
    # cache the DEVICE graph per stored-uns-entry identity: the stored
    # arrays are host numpy, and re-uploading them per statistic call is
    # ~240 MB at the reference vignette's 367k x k=50 (4 public calls x 2
    # passes would move ~2 GB of repeat uploads). Same keying/fallback
    # pattern as
    # _get_null_plan below.
    cache = getattr(adata, "_device_graph_cache", None)
    if cache is not None and cache.get("key") == id(g):
        return cache["graph"]
    sg = SpatialGraph(
        neighbor_idx=jnp.asarray(g["neighbor_idx"]),
        neighbor_w=jnp.asarray(g["neighbor_w"]),
        valid=jnp.asarray(np.asarray(g["valid"]).astype(bool)),
        distances=jnp.asarray(g["distances"]),
    )
    try:
        adata._device_graph_cache = {"key": id(g), "graph": sg}
    except (AttributeError, TypeError):   # slotted containers: skip cache
        pass
    return sg


def _get_graph_moments(adata, graph) -> dict:
    """Cliff-Ord S0/S1/S2 for this adata's graph, cached on the object.

    ``graph_moments`` runs HOST-side from the CSR export (f64 sums — the
    analytic-z accuracy requirement), which reads the [N, k] index/weight
    arrays back to the host (~150 MB at 367k x k=50). Computing them
    once per stored graph instead of once per morans_i/gearys_c call
    removes that readback from every warm call.
    """
    uns_entry = adata.uns.get(GRAPH_UNS_KEY)
    if uns_entry is None:
        return graph_moments(graph)
    key = (id(uns_entry), graph.neighbor_idx.shape)
    cache = getattr(adata, "_graph_moments_cache", None)
    if cache is not None and cache.get("key") == key:
        return cache["moments"]
    m = graph_moments(graph)
    try:
        adata._graph_moments_cache = {"key": key, "moments": m}
    except (AttributeError, TypeError):
        pass
    return m


def _get_graph(adata, n_neighbors, spatial_key, use_existing_graph) -> SpatialGraph:
    if use_existing_graph:
        g = _load_stored_graph(adata)
        if g is not None:
            params = (adata.uns.get(GRAPH_UNS_KEY) or {}).get("params") or {}
            is_radius = params.get("radius") is not None
            # a stored radius graph is allowed to differ in degree (the
            # caller opted into it), but coordinates and self-loop
            # convention must STILL match — both silently change every
            # statistic if reused across them
            mismatch = bool(params) and (
                params.get("spatial_key", spatial_key) != spatial_key
                or params.get("include_self", False)
                or (not is_radius
                    and params.get("n_neighbors") is not None
                    and params["n_neighbors"] != n_neighbors))
            if mismatch:
                # a cached graph built with different parameters would
                # silently change the statistics — rebuild instead
                logger.warning(
                    f"Stored spatial graph (n_neighbors="
                    f"{params.get('n_neighbors')}, spatial_key="
                    f"'{params.get('spatial_key')}') does not match the "
                    f"request (n_neighbors={n_neighbors}, spatial_key="
                    f"'{spatial_key}'); rebuilding.")
            else:
                logger.info("Using existing spatial graph "
                            "(use_existing_graph=True)")
                return g
        else:
            logger.warning(
                "use_existing_graph=True but no stored graph; rebuilding")
    else:
        stored = adata.uns.get(GRAPH_UNS_KEY)
        params = ((stored or {}).get("params") or {}
                  if isinstance(stored, dict) and "neighbor_idx" in stored
                  else {})
        if (params.get("n_neighbors") == n_neighbors
                and params.get("spatial_key") == spatial_key
                and not params.get("include_self", False)
                and params.get("radius") is None):
            # reference-parity default recomputes; at 1M cells that is
            # seconds of kNN plus a fresh null plan per statistic call
            logger.info(
                "Recomputing the spatial graph although a stored graph "
                "with identical parameters exists — pass "
                "use_existing_graph=True to reuse it (and the cached "
                "permutation null plan) across statistic calls.")
    return build_spatial_weights(adata, n_neighbors=n_neighbors,
                                 spatial_key=spatial_key)


# ---------------------------------------------------------------------------
# Expression extraction
# ---------------------------------------------------------------------------

def _resolve_genes(adata, genes) -> List[str]:
    if genes is None:
        return list(adata.var_names)
    if isinstance(genes, str):
        genes = [genes]
    missing = [g for g in genes if g not in adata.var_names]
    if missing:
        raise ValueError(f"Genes not found in adata.var_names: {missing[:10]}")
    return list(genes)


def _dense_expression(adata, gene_names: List[str], layer: Optional[str]) -> np.ndarray:
    if hasattr(adata, "get_matrix"):
        X = adata.get_matrix(layer)
    elif layer is None:
        X = adata.X
    else:
        # plain anndata fallback: silently computing on X instead of the
        # requested layer would change every statistic — validate loudly
        if layer not in getattr(adata, "layers", {}):
            raise ValueError(f"Layer '{layer}' not found in adata.layers")
        X = adata.layers[layer]
    idx = adata.var_names.get_indexer(gene_names)
    if isinstance(X, jax.Array):
        # device-resident X: slice on device and return the jax array —
        # every caller immediately jnp.asarray()s the result, so nothing
        # round-trips the host<->device link. This
        # is how >GB expression matrices generated on device (jax.random,
        # a previous pipeline stage) feed the stats layer at zero copy.
        sub = jnp.take(X, jnp.asarray(idx, dtype=jnp.int32), axis=1)
        if sub.dtype == jnp.float64 and jax.config.jax_enable_x64:
            return sub
        return sub.astype(jnp.float32)
    sub = X[:, idx]
    if sp.issparse(sub):
        sub = sub.toarray()
    sub = np.asarray(sub)
    # f64 validation mode: keep float64 end-to-end when x64 is enabled so
    # the 1e-6 ecosystem-agreement bar is testable (SURVEY §7 hard part 1);
    # the production mode stays f32.
    if sub.dtype == np.float64 and jax.config.jax_enable_x64:
        return sub
    return sub.astype(np.float32, copy=False)


def _concat_device_batches(batches: list) -> tuple:
    """Concatenate per-batch output tuples along the gene axis (axis 0 for
    1-D fields), freeing each field's sources as it is consumed so peak
    HBM stays near the final output set rather than 2x it (review
    finding: holding every batch through all concatenations doubled the
    [N, G] footprint at 1M cells)."""
    cols = [list(t) for t in zip(*batches)]
    batches.clear()
    outs = []
    for i, col in enumerate(cols):
        if len(col) == 1:
            outs.append(col[0])
        else:
            outs.append(jnp.concatenate(col, axis=1 if col[0].ndim > 1
                                        else 0))
        cols[i] = None
    return tuple(outs)


# ---------------------------------------------------------------------------
# Global Moran's I / Geary's C
# ---------------------------------------------------------------------------

def _auto_null_method(n_cells: int, n_genes: int,
                      n_permutations: int) -> str:
    """Resolve null_method='auto' for the global statistics.

    The banded system pays a fixed plan-build + kernel compile; it wins
    at large N only when the gene x perm volume amortizes that cost —
    at small volume (e.g. 8 genes x 99 draws) the slot path's per-draw
    gathers finish before the plan is even built. The two paths draw from
    different seeded permutation streams, so the choice is sticky per
    (shape, seed): it depends on sizes only, never on data values.
    """
    return ("banded" if n_permutations > 0
            and n_cells >= 100_000
            and n_genes * n_permutations >= 16_384
            else "slots")


def _global_autocorr(
    adata,
    stat: Literal["moran", "geary"],
    genes,
    layer,
    spatial_key,
    n_neighbors,
    n_permutations,
    seed,
    key_added,
    copy,
    use_existing_graph,
    assumption: str,
    alternative: Optional[str],
    gene_batch_size: int,
    mesh=None,
    null_method: str = "auto",
):
    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found. Spatial coordinates are required.")
    gene_names = _resolve_genes(adata, genes)
    n_cells = adata.n_obs
    if alternative is None:
        alternative = "greater" if stat == "moran" else "less"

    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph)
    moments = _get_graph_moments(adata, graph)
    S0, S1, S2 = moments["S0"], moments["S1"], moments["S2"]

    # banded null kernel for large N: one random gather + batched band
    # matmuls per draw instead of 7 gathers (ops/banded.py). Its
    # Feistel draw stream differs from the slot kernel's, so the choice is
    # sticky per (data, seed): "auto" switches on size only. Under a mesh
    # the banded path gene-shards with zero collectives in the scan
    # (parallel.stats.sharded_banded_permutation_test).
    if null_method == "auto":
        null_method = _auto_null_method(n_cells, len(gene_names),
                                        n_permutations)
    # "banded_int8": per-gene-quantized null system — exact s8xs8->s32
    # band dots, half the device bytes of bf16. Decision-level agreement
    # with f32 is pinned by tests/test_banded.py; observed I stays f32.
    null_precision = "bf16"
    if null_method == "banded_int8":
        null_method, null_precision = "banded", "int8"
    plan = None
    if null_method == "banded" and n_permutations > 0:
        from ..ops.banded import banded_permutation_test

        # reuse the adata-cached plan (one Hilbert relabel + band split
        # serves morans_i/gearys_c AND the local family; a fresh
        # build_null_plan per call costs seconds of warm time at the
        # reference vignette's k=50)
        plan = _get_null_plan(adata, graph, spatial_key)

    place_Z = None
    if mesh is not None:
        # gene-shard batches over the mesh: graph replicated, no
        # collectives in the permutation loop (parallel.stats design)
        from ..parallel.mesh import gene_sharding, replicated
        import jax as _jax

        rep = replicated(mesh)
        graph = SpatialGraph(
            neighbor_idx=_jax.device_put(graph.neighbor_idx, rep),
            neighbor_w=_jax.device_put(graph.neighbor_w, rep),
            valid=_jax.device_put(graph.valid, rep),
            distances=_jax.device_put(graph.distances, rep))
        if plan is not None:
            from ..ops.banded import NullPlan

            plan = NullPlan(*(_jax.device_put(f, rep)
                              if isinstance(f, _jax.Array) else f
                              for f in plan))
        gs = gene_sharding(mesh, ndim=2)
        n_shards = int(np.prod([mesh.shape[a] for a in ("genes",)
                                if a in mesh.shape])) or 1

        def place_Z(Xb):
            pad = (-Xb.shape[1]) % n_shards
            if pad:
                # jnp.pad: np.pad on a device-resident Xb would silently
                # read the whole batch back to host (review finding)
                Xb = jnp.pad(jnp.asarray(Xb), ((0, 0), (0, pad)))
            return _jax.device_put(jnp.asarray(Xb), gs), pad

    rows = []
    for batch_start in range(0, len(gene_names), gene_batch_size):
        batch = gene_names[batch_start:batch_start + gene_batch_size]
        Xb = _dense_expression(adata, batch, layer)
        pad = 0
        if place_Z is not None:
            Xj, pad = place_Z(Xb)
        else:
            Xj = jnp.asarray(Xb)
        Z, zero_var = standardize(Xj)
        if stat == "moran":
            observed = moran_observed(graph, Z, S0)
            expected, var = moran_analytic_moments(Z, S0, S1, S2, assumption)
        else:
            observed = geary_observed(graph, Z, S0)
            expected_scalar, var = geary_analytic_moments(Z, S0, S1, S2, assumption)
            expected = expected_scalar
        z_score = (observed - expected) / jnp.sqrt(jnp.maximum(var, 1e-30))
        p_norm = p_from_z(z_score, alternative)
        if n_permutations > 0:
            if plan is not None:
                p_sim, _, _ = banded_permutation_test(
                    plan, Z, S0, observed, seed, n_permutations,
                    stat=stat, alternative=alternative,
                    precision=null_precision)
            else:
                p_sim, _, _ = permutation_test_global(
                    graph, Z, S0, observed, seed, n_permutations,
                    stat=stat, alternative=alternative)
            p_val = p_sim
        else:
            p_val = p_norm
        observed = np.asarray(observed)[:len(batch)]
        z_score = np.asarray(z_score)[:len(batch)]
        p_val = np.asarray(p_val)[:len(batch)]
        zero_var = np.asarray(zero_var)[:len(batch)]
        for i, g in enumerate(batch):
            rows.append({
                "gene": g,
                ("I" if stat == "moran" else "C"): float(observed[i]),
                ("expected_I" if stat == "moran" else "expected_C"):
                    float(expected[i]) if np.ndim(expected) else float(expected),
                "z_score": 0.0 if zero_var[i] else float(z_score[i]),
                "p_value": 1.0 if zero_var[i] else float(p_val[i]),
            })

    results_df = pd.DataFrame(rows)
    adata.uns[key_added] = results_df
    elapsed = time.time() - start
    logger.info(f"Global {'Moran I' if stat == 'moran' else 'Geary C'} "
                f"completed in {elapsed:.1f}s")

    update_metadata(
        adata,
        function_name="morans_i" if stat == "moran" else "gearys_c",
        parameters={
            "genes": gene_names[:10], "n_genes": len(gene_names),
            "n_neighbors": n_neighbors, "n_permutations": n_permutations,
            "use_existing_graph": use_existing_graph, "seed": seed,
            "assumption": assumption, "alternative": alternative,
            "null_method": (
                ("banded_int8" if null_precision == "int8" else null_method)
                if n_permutations > 0 else "analytic"),
            "backend": "spatialcore_tpu",
        },
        outputs={"uns": key_added},
    )
    return adata


def morans_i(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 10,
    seed: int = 0,
    key_added: str = "morans_i",
    copy: bool = False,
    use_existing_graph: bool = False,
    assumption: Literal["normality", "randomization"] = "normality",
    alternative: Optional[Literal["greater", "less", "two-sided"]] = None,
    gene_batch_size: int = 512,
    mesh=None,
    null_method: str = "auto",
):
    """Global Moran's I per gene.

    Results land in ``adata.uns[key_added]`` as a DataFrame with columns
    ``gene, I, expected_I, z_score, p_value`` — the reference's output shape
    (autocorrelation.py:585-625). ``p_value`` is the seeded permutation
    p-value when ``n_permutations > 0``, else the analytic tail probability
    under ``assumption``. ``z_score`` uses the analytic variance.

    ``null_method``: "auto" picks the banded kernel at >=100k cells when
    the gene x permutation volume amortizes its fixed plan-build +
    compile cost (genes x perms >= 16,384), else the slot kernel;
    "banded_int8" additionally runs the null system in per-gene-quantized
    int8 (exact integer band dots, half the gathered bytes, decision-level
    agreement with f32). Observed I is always f32.
    """
    return _global_autocorr(
        adata, "moran", genes, layer, spatial_key, n_neighbors, n_permutations,
        seed, key_added, copy, use_existing_graph, assumption, alternative,
        gene_batch_size, mesh=mesh, null_method=null_method)


def gearys_c(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 10,
    seed: int = 0,
    key_added: str = "gearys_c",
    copy: bool = False,
    use_existing_graph: bool = False,
    assumption: Literal["normality", "randomization"] = "normality",
    alternative: Optional[Literal["greater", "less", "two-sided"]] = None,
    gene_batch_size: int = 512,
    mesh=None,
    null_method: str = "auto",
):
    """Global Geary's C per gene (BASELINE config 2 extension).

    Same output shape as :func:`morans_i` with columns
    ``gene, C, expected_C, z_score, p_value``. Default ``alternative='less'``
    (C < 1 ⇔ positive spatial autocorrelation).
    """
    return _global_autocorr(
        adata, "geary", genes, layer, spatial_key, n_neighbors, n_permutations,
        seed, key_added, copy, use_existing_graph, assumption, alternative,
        gene_batch_size, mesh=mesh, null_method=null_method)


def global_autocorrelation(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 10,
    seed: int = 0,
    keys_added: Tuple[str, str] = ("morans_i", "gearys_c"),
    copy: bool = False,
    use_existing_graph: bool = False,
    assumption: Literal["normality", "randomization"] = "normality",
    alternatives: Tuple[Optional[str], Optional[str]] = (None, None),
    gene_batch_size: int = 512,
    mesh=None,
    null_method: str = "auto",
):
    """Global Moran's I AND Geary's C per gene in ONE permutation pass.

    Computing the two statistics separately pays the per-draw random row
    gather — the main cost of the banded null kernel's draw — twice.
    Both statistics are linear
    in the same band cross-product ``Σ w_ij z_i z_j`` (Geary adds only a
    cheap ``Σ (row+col sums)·z²`` reduction), so the fused pass runs one
    gather + one set of band matmuls per draw and counts extremes for
    both: ~2x the combined throughput at large N. Results are BITWISE
    identical to separate :func:`morans_i` / :func:`gearys_c` calls with
    the same seed (the draw streams coincide).

    Writes the same two uns DataFrames the individual calls produce
    (``gene, I/C, expected, z_score, p_value``) under ``keys_added``.
    ``alternatives`` defaults to ``("greater", "less")`` — the individual
    functions' defaults. ``null_method`` as in :func:`morans_i`; below the
    banded-size threshold the fallback still shares one standardize and
    graph pass per batch. No reference counterpart (the reference computes
    global Moran only, via squidpy — autocorrelation.py:563-583).
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found. Spatial coordinates are required.")
    gene_names = _resolve_genes(adata, genes)
    n_cells = adata.n_obs
    alt_m, alt_g = alternatives
    alt_m = alt_m or "greater"
    alt_g = alt_g or "less"

    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph)
    moments = _get_graph_moments(adata, graph)
    S0, S1, S2 = moments["S0"], moments["S1"], moments["S2"]

    if null_method == "auto":
        null_method = _auto_null_method(n_cells, len(gene_names),
                                        n_permutations)
    null_precision = "bf16"
    if null_method == "banded_int8":
        null_method, null_precision = "banded", "int8"
    plan = None
    if null_method == "banded" and n_permutations > 0:
        from ..ops.banded import banded_permutation_test

        plan = _get_null_plan(adata, graph, spatial_key)

    place_Z = None
    if mesh is not None:
        from ..parallel.mesh import gene_sharding, replicated
        import jax as _jax

        rep = replicated(mesh)
        graph = SpatialGraph(
            neighbor_idx=_jax.device_put(graph.neighbor_idx, rep),
            neighbor_w=_jax.device_put(graph.neighbor_w, rep),
            valid=_jax.device_put(graph.valid, rep),
            distances=_jax.device_put(graph.distances, rep))
        if plan is not None:
            from ..ops.banded import NullPlan

            plan = NullPlan(*(_jax.device_put(f, rep)
                              if isinstance(f, _jax.Array) else f
                              for f in plan))
        gs = gene_sharding(mesh, ndim=2)
        n_shards = int(np.prod([mesh.shape[a] for a in ("genes",)
                                if a in mesh.shape])) or 1

        def place_Z(Xb):
            pad = (-Xb.shape[1]) % n_shards
            if pad:
                Xb = jnp.pad(jnp.asarray(Xb), ((0, 0), (0, pad)))
            return _jax.device_put(jnp.asarray(Xb), gs), pad

    rows_m, rows_g = [], []
    for batch_start in range(0, len(gene_names), gene_batch_size):
        batch = gene_names[batch_start:batch_start + gene_batch_size]
        Xb = _dense_expression(adata, batch, layer)
        if place_Z is not None:
            Xj, _ = place_Z(Xb)
        else:
            Xj = jnp.asarray(Xb)
        Z, zero_var = standardize(Xj)
        obs_m = moran_observed(graph, Z, S0)
        obs_g = geary_observed(graph, Z, S0)
        exp_m, var_m = moran_analytic_moments(Z, S0, S1, S2, assumption)
        exp_g, var_g = geary_analytic_moments(Z, S0, S1, S2, assumption)
        zs_m = (obs_m - exp_m) / jnp.sqrt(jnp.maximum(var_m, 1e-30))
        zs_g = (obs_g - exp_g) / jnp.sqrt(jnp.maximum(var_g, 1e-30))
        if n_permutations > 0:
            if plan is not None:
                p_both, _, _ = banded_permutation_test(
                    plan, Z, S0, jnp.stack([obs_m, obs_g]), seed,
                    n_permutations, stat="moran_geary",
                    alternative=(alt_m, alt_g), precision=null_precision)
                p_m, p_g = p_both[0], p_both[1]
            else:
                p_m, _, _ = permutation_test_global(
                    graph, Z, S0, obs_m, seed, n_permutations,
                    stat="moran", alternative=alt_m)
                p_g, _, _ = permutation_test_global(
                    graph, Z, S0, obs_g, seed, n_permutations,
                    stat="geary", alternative=alt_g)
        else:
            p_m = p_from_z(zs_m, alt_m)
            p_g = p_from_z(zs_g, alt_g)
        nb = len(batch)
        obs_m = np.asarray(obs_m)[:nb]
        obs_g = np.asarray(obs_g)[:nb]
        zs_m = np.asarray(zs_m)[:nb]
        zs_g = np.asarray(zs_g)[:nb]
        p_m = np.asarray(p_m)[:nb]
        p_g = np.asarray(p_g)[:nb]
        zero_var = np.asarray(zero_var)[:nb]
        for i, g in enumerate(batch):
            rows_m.append({
                "gene": g, "I": float(obs_m[i]),
                "expected_I": float(exp_m[i]) if np.ndim(exp_m) else float(exp_m),
                "z_score": 0.0 if zero_var[i] else float(zs_m[i]),
                "p_value": 1.0 if zero_var[i] else float(p_m[i]),
            })
            rows_g.append({
                "gene": g, "C": float(obs_g[i]) if np.ndim(obs_g) else float(obs_g),
                "expected_C": float(exp_g[i]) if np.ndim(exp_g) else float(exp_g),
                "z_score": 0.0 if zero_var[i] else float(zs_g[i]),
                "p_value": 1.0 if zero_var[i] else float(p_g[i]),
            })

    adata.uns[keys_added[0]] = pd.DataFrame(rows_m)
    adata.uns[keys_added[1]] = pd.DataFrame(rows_g)
    elapsed = time.time() - start
    logger.info(f"Fused global Moran I + Geary C completed in {elapsed:.1f}s")

    update_metadata(
        adata,
        function_name="global_autocorrelation",
        parameters={
            "genes": gene_names[:10], "n_genes": len(gene_names),
            "n_neighbors": n_neighbors, "n_permutations": n_permutations,
            "use_existing_graph": use_existing_graph, "seed": seed,
            "assumption": assumption, "alternatives": [alt_m, alt_g],
            "null_method": (
                ("banded_int8" if null_precision == "int8" else null_method)
                if n_permutations > 0 else "analytic"),
            "backend": "spatialcore_tpu",
        },
        outputs={"uns": list(keys_added)},
    )
    return adata


# ---------------------------------------------------------------------------
# Local Moran's I
# ---------------------------------------------------------------------------

def _run_compact_stream(adata, stat, names, layer, graph, plan,
                        n_permutations, fdr, alpha, seed, tile, precision,
                        X_is_device, device_keys, pair_names=None,
                        star=True, alternative="two-sided"):
    """Shared memory-bounded local-statistic runner: stream gene (or pair)
    tiles through ops.streaming.streaming_local_null and return the output
    planes — compact device-resident arrays (``device_keys`` only, lean
    fused post-pass) when the expression is a jax array, full-precision
    host numpy otherwise. Used by the ``output_mode="compact"`` paths of
    ``local_gearys_c`` / ``getis_ord_gi`` / ``lees_l_local``.
    """
    from ..ops.streaming import (
        device_local_sink, host_local_sink, streaming_local_null)

    n_cells = adata.n_obs
    if stat == "lee":
        gx, gy = pair_names
        n_items = len(gx)

        def get_tile(s, w):
            return (jnp.asarray(_dense_expression(adata, gx[s:s + w],
                                                  layer)),
                    jnp.asarray(_dense_expression(adata, gy[s:s + w],
                                                  layer)))
    else:
        n_items = len(names)

        def get_tile(s, w):
            return jnp.asarray(_dense_expression(adata, names[s:s + w],
                                                 layer))

    if X_is_device:
        sink, finalize = device_local_sink(n_items, keys=device_keys)
        stream_keys = device_keys
    else:
        sink, store = host_local_sink(n_cells, n_items)
        stream_keys = None
    streaming_local_null(
        graph, plan, get_tile, n_items, sink, stat=stat, seed=seed,
        n_permutations=n_permutations, tile=tile, fdr=fdr, alpha=alpha,
        precision=precision, keys=stream_keys, star=star,
        alternative=alternative)
    return finalize() if X_is_device else store


def _local_morans_compact(adata, gene_names, layer, graph, plan,
                          n_neighbors, n_permutations, fdr_correction,
                          alpha, seed, tile, key_added, null_precision,
                          X_is_device, start):
    """Memory-bounded LISA at scale: stream gene tiles through the banded
    int8 null operators (ops.streaming.streaming_local_null).

    Device-resident inputs keep compact device outputs (I bf16, p/p_adj
    f16, quadrant int8 — 7 bytes/cell/gene, ~7 GB at 1M x 1024 vs 24 GB
    of f32 planes; the accumulated OUTPUT footprint, not the kernel, is
    what bounds the gene width on a 16 GB chip);
    host inputs flush full-precision host arrays per tile. Dethrones the
    reference's nested Python p-value loops
    (/root/reference/src/spatialcore/spatial/autocorrelation.py:877-896)
    at workloads its batching cannot reach.
    """
    from ..ops.streaming import (
        device_local_sink, host_local_sink, streaming_local_null)

    n_cells, n_genes = adata.n_obs, len(gene_names)

    def get_tile(s, w):
        return jnp.asarray(_dense_expression(
            adata, gene_names[s:s + w], layer))

    if X_is_device:
        # keys= selects the lean fused post-pass (compact planes straight
        # from the jit; unkept planes dead-code-eliminated) — the device
        # sink's own filter would otherwise only drop them AFTER a ~20 GB
        # f32 transient per 512-gene tile
        sink, finalize = device_local_sink(
            n_genes, keys=("I", "p", "p_adj", "quadrant"))
        stream_keys = ("I", "p", "p_adj", "quadrant")
    else:
        sink, store = host_local_sink(n_cells, n_genes)
        stream_keys = None
    streaming_local_null(
        graph, plan, get_tile, n_genes, sink, stat="moran", seed=seed,
        n_permutations=n_permutations, tile=tile, fdr=fdr_correction,
        alpha=alpha, precision=null_precision, keys=stream_keys)
    out = finalize() if X_is_device else store
    for k in ("I", "p", "p_adj", "quadrant"):
        adata.obsm[f"{key_added}_{k}"] = out[k]
    elapsed = time.time() - start
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names,
        "n_neighbors": n_neighbors,
        "n_permutations": n_permutations,
        "fdr_correction": fdr_correction,
        "alpha": alpha,
        "seed": seed,
        "null": "total",
        "null_method": ("banded_int8" if null_precision == "int8"
                        else "banded"),
        "null_precision": null_precision,
        "output_mode": "compact",
        "tile": tile,
        "quadrant_labels": dict(QUADRANT_LABELS),
        "computation_time_seconds": elapsed,
    }
    logger.info(f"Local Moran's I (compact streaming) completed in "
                f"{elapsed:.1f}s")
    update_metadata(
        adata, "local_morans_i",
        parameters={"genes": gene_names[:10], "n_genes": n_genes,
                    "n_neighbors": n_neighbors,
                    "n_permutations": n_permutations,
                    "fdr_correction": fdr_correction, "alpha": alpha,
                    "seed": seed, "output_mode": "compact"},
        outputs={f"obsm_{s}": f"{key_added}_{s}"
                 for s in ("I", "p", "p_adj", "quadrant")} |
                {"uns_params": f"{key_added}_params"},
    )
    return adata


def local_morans_i(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 10,
    fdr_correction: Literal["bonferroni", "fdr_bh", "none"] = "fdr_bh",
    alpha: float = 0.05,
    seed: int = 0,
    batch_size: int = 100,
    key_added: str = "local_morans",
    copy: bool = False,
    use_existing_graph: bool = False,
    null_method: str = "auto",
    null: str = "total",
    output_mode: str = "auto",
):
    """Local Moran's I (LISA) with on-device permutation p-values.

    ``null``: "total" (reference convention) shuffles whole columns;
    "conditional" is the GeoDa/esda LISA null (cell keeps its own value,
    neighbors drawn without replacement from the other cells).

    Writes six obsm matrices + params, matching the reference's keys
    (autocorrelation.py:929-950): ``{key}_I, {key}_z, {key}_lag, {key}_p,
    {key}_p_adj, {key}_quadrant`` and ``uns[f"{key}_params"]``. Quadrant codes
    are int8 0=NS,1=HH,2=LL,3=HL,4=LH. When ``adata.X`` (or the requested
    layer) is a jax array, the six outputs are stored as device-resident
    jax arrays too — no [N, G] readback; ``np.asarray`` them on demand.

    ``null_method``: "banded" evaluates the permutation nulls through the
    banded kernel (ops/banded.py). At the default k=6 and bf16/f32 it
    only ties the direct kernel at 100-gene batches (the [N, G]
    elementwise count update dominates, not the gathers), so "auto"
    keeps the direct path there — but on HIGH-DEGREE graphs (k >= 16) at
    >= 100k cells "auto" picks the banded kernel: the direct path pays k
    issue-bound row gathers per draw, the banded one exactly one. "banded_int8" runs the
    null system in the per-gene-quantized int8 operator (exact integer
    band dots, int8 gathers, fully-integer int32 comparisons, int8
    counters for P <= 127 — draws compare against
    the observed value of the SAME quantized operator; decision-level
    agreement with the f32 path is pinned by tests/test_banded.py) —
    built for wide gene batches at large N, pair it with a bigger
    ``batch_size``. The observed I/z/lag always come from the exact
    direct kernel.

    ``output_mode``: "full" keeps the documented six f32 [N, G] obsm
    planes. "compact" routes through the streaming driver
    (ops.streaming.streaming_local_null): gene tiles flow through the
    banded int8 null operators and outputs stay memory-bounded —
    device-resident compact dtypes (``I`` bf16, ``p``/``p_adj`` f16,
    ``quadrant`` int8; ``z``/``lag`` dropped — they are deterministic
    one-lag-pass quantities) when the expression is device-resident,
    f32 host arrays flushed per tile otherwise. This is how 1M cells x
    thousands of genes of local nulls fit one chip (the six f32 planes
    are 48 GB at G=2048). "auto" picks "compact" only when the full
    outputs would exceed ~8 GB on a device-resident input and the
    banded path is active.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found. Spatial coordinates are required.")
    gene_names = _resolve_genes(adata, genes)
    n_cells, n_genes = adata.n_obs, len(gene_names)
    logger.info(f"Local Moran's I: {n_cells:,} cells × {n_genes} genes, "
                f"k={n_neighbors}, P={n_permutations}")

    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph)

    null_precision = "bf16"
    if null_method == "auto":
        # high-degree graphs at scale: the direct kernel pays k issue-bound
        # row gathers per draw, the banded kernel exactly one (+ band
        # matmuls) — at the reference vignette's k=50 that is the whole
        # cost. At the default k=6 the [N, G] count update dominates both
        # paths and the direct kernel stays. The
        # auto-selected path runs f32 so default results differ from the
        # direct kernel only in summation order, never quantization.
        k_eff = int(graph.neighbor_idx.shape[1])
        if (n_permutations > 0 and null == "total"
                and n_cells >= 100_000 and k_eff >= 16):
            null_method, null_precision = "banded", "f32"
        else:
            null_method = "slots"
    if null_method == "banded_int8":
        null_method, null_precision = "banded", "int8"
    if null not in ("total", "conditional"):
        raise ValueError(f"null must be 'total' or 'conditional', got {null!r}")
    plan = None
    if null_method == "banded" and n_permutations > 0:
        if null == "conditional":
            logger.warning("null='conditional' is not supported by the "
                           "banded path; using the direct kernel")
            null_method, null_precision = "slots", "bf16"
        else:
            from ..ops.banded import banded_local_moran

            plan = _get_null_plan(adata, graph, spatial_key)

    if output_mode not in ("auto", "full", "compact"):
        raise ValueError(f"output_mode must be 'auto', 'full' or "
                         f"'compact', got {output_mode!r}")
    X_is_device = isinstance(
        adata.layers[layer] if layer and layer in getattr(
            adata, "layers", {}) else getattr(adata, "X", None), jax.Array)
    if output_mode == "auto":
        output_mode = ("compact"
                       if plan is not None and X_is_device
                       and n_cells * n_genes * 24 > 8e9 else "full")
    if output_mode == "compact":
        if plan is None or n_permutations <= 0:
            raise ValueError(
                "output_mode='compact' streams through the banded null "
                "path — use null_method='banded'/'banded_int8' with "
                "n_permutations > 0")
        return _local_morans_compact(
            adata, gene_names, layer, graph, plan, n_neighbors,
            n_permutations, fdr_correction, alpha, seed,
            max(batch_size, 256), key_added, null_precision, X_is_device,
            start)

    # device mode: when X is a jax array (device-resident input), the six
    # [N, G] outputs stay device-resident jax arrays in obsm too — at 1M
    # cells the readback of ~GBs of obsm matrices can cost more than the
    # statistic itself, and downstream
    # on-device consumers (classification, plotting subsets) don't need it
    device_mode = False
    batches = []    # device mode: per-batch (I, z, lag, p, zero_var)
    I_all = z_all = lag_all = p_all = None
    zero_var_all = np.zeros(n_genes, bool)

    for bs in range(0, n_genes, batch_size):
        batch = gene_names[bs:bs + batch_size]
        Xb = _dense_expression(adata, batch, layer)
        if bs == 0:
            device_mode = isinstance(Xb, jax.Array)
            if not device_mode:
                I_all = np.zeros((n_cells, n_genes), np.float32)
                z_all = np.zeros_like(I_all)
                lag_all = np.zeros_like(I_all)
                p_all = np.ones_like(I_all)
        Z, zero_var = standardize(jnp.asarray(Xb))
        if plan is not None:
            # exact observed statistics from the direct kernel; banded
            # machinery only evaluates the permutation nulls
            res = banded_local_moran(plan, graph, Z, seed=seed,
                                     n_permutations=n_permutations,
                                     precision=null_precision)
        else:
            res = local_moran(graph, Z, seed, n_permutations, null=null)
        if device_mode:
            batches.append((res.local_I, res.z, res.lag, res.p_value,
                            zero_var))
        else:
            sl = slice(bs, bs + len(batch))
            I_all[:, sl] = np.asarray(res.local_I)
            z_all[:, sl] = np.asarray(res.z)
            lag_all[:, sl] = np.asarray(res.lag)
            p_all[:, sl] = np.asarray(res.p_value)
            zero_var_all[sl] = np.asarray(zero_var)

    if device_mode:
        I_all, z_all, lag_all, p_all, zv = _concat_device_batches(batches)
        I_all = jnp.where(zv[None, :], 0.0, I_all)
        z_all = jnp.where(zv[None, :], 0.0, z_all)
        lag_all = jnp.where(zv[None, :], 0.0, lag_all)
        p_all = jnp.where(zv[None, :], 1.0, p_all)
        zero_var_all = np.asarray(zv)   # [G] scalar-scale readback
    elif I_all is None:
        # zero genes requested: the loop never allocated — keep the
        # documented [N, 0] obsm outputs (review finding)
        I_all = np.zeros((n_cells, n_genes), np.float32)
        z_all = np.zeros_like(I_all)
        lag_all = np.zeros_like(I_all)
        p_all = np.ones_like(I_all)
    if zero_var_all.any():
        logger.warning(f"{int(zero_var_all.sum())} zero-variance genes set to 0/NS")
        if not device_mode:
            I_all[:, zero_var_all] = 0.0
            z_all[:, zero_var_all] = 0.0
            lag_all[:, zero_var_all] = 0.0
            p_all[:, zero_var_all] = 1.0

    out = (lambda a: a) if device_mode else np.asarray
    if n_permutations > 0:
        p_adj = out(apply_fdr(jnp.asarray(p_all), fdr_correction, axis=0,
                              n_levels=n_permutations + 1))
        quadrants = out(classify_quadrants(
            jnp.asarray(z_all), jnp.asarray(lag_all), jnp.asarray(p_adj), alpha))
    else:
        logger.warning(
            "n_permutations=0: quadrants classified by z/lag signs only, "
            "without significance filtering.")
        p_adj = p_all
        quadrants = out(classify_quadrants(
            jnp.asarray(z_all), jnp.asarray(lag_all), None, alpha))

    adata.obsm[f"{key_added}_I"] = I_all
    adata.obsm[f"{key_added}_z"] = z_all
    adata.obsm[f"{key_added}_lag"] = lag_all
    adata.obsm[f"{key_added}_p"] = p_all
    adata.obsm[f"{key_added}_p_adj"] = p_adj
    adata.obsm[f"{key_added}_quadrant"] = quadrants

    elapsed = time.time() - start
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names,
        "n_neighbors": n_neighbors,
        "n_permutations": n_permutations,
        "fdr_correction": fdr_correction,
        "alpha": alpha,
        "seed": seed,
        "null": null,
        "null_method": ("banded_int8" if null_precision == "int8"
                        else null_method),
        "null_precision": null_precision if null_method == "banded" else "f32",
        "quadrant_labels": dict(QUADRANT_LABELS),
        "computation_time_seconds": elapsed,
    }
    logger.info(f"Local Moran's I completed in {elapsed:.1f}s")

    update_metadata(
        adata, "local_morans_i",
        parameters={"genes": gene_names[:10], "n_genes": n_genes,
                    "n_neighbors": n_neighbors, "n_permutations": n_permutations,
                    "fdr_correction": fdr_correction, "alpha": alpha, "seed": seed},
        outputs={f"obsm_{s}": f"{key_added}_{s}"
                 for s in ("I", "z", "lag", "p", "p_adj", "quadrant")} |
                {"uns_params": f"{key_added}_params"},
    )
    return adata


# ---------------------------------------------------------------------------
# Lee's L
# ---------------------------------------------------------------------------

def _lees_use_banded(null_method: str, n_cells: int,
                     n_permutations: int) -> Tuple[bool, str]:
    """(use_banded, precision). Validates null_method FIRST so typos fail
    loudly even at n_permutations=0 (review finding). The auto-selected
    path runs the band matmuls in f32 — default results differ from the
    direct kernel only in float summation order, never quantization; the
    explicit 'banded' opt-in uses bf16 (faster, quantized operator);
    'banded_int8' the int8 quantized-operator system (fastest — the same
    gather row serves 2x the bf16 genes; k <= 1000)."""
    if null_method not in ("auto", "banded", "banded_int8", "direct"):
        raise ValueError("null_method must be 'auto', 'banded', "
                         f"'banded_int8' or 'direct', got {null_method!r}")
    if n_permutations <= 0 or null_method == "direct":
        return False, "f32"
    if null_method == "banded":
        return True, "bf16"
    if null_method == "banded_int8":
        return True, "int8"
    return n_cells >= 100_000, "f32"


def _get_null_plan(adata, graph, spatial_key: str):
    """Build (or reuse) the banded NullPlan for this adata's graph.

    Cached on the object (not uns — a NullPlan must not leak into h5ad
    output), keyed by the graph arrays' identity. lees_l →
    lees_l_local → local_morans_i on the same stored graph reuse one
    Hilbert relabel + band/far split instead of three (review finding).
    """
    from ..ops.banded import build_null_plan

    # key on the PERSISTENT uns graph entry (the SpatialGraph object is
    # rebuilt from it on every call, so its arrays' ids don't repeat);
    # build_spatial_weights assigns a fresh dict whenever it rebuilds
    key = (id(adata.uns.get(GRAPH_UNS_KEY)), graph.neighbor_idx.shape,
           spatial_key)
    cache = getattr(adata, "_null_plan_cache", None)
    if cache is not None and cache.get("key") == key:
        return cache["plan"]
    plan = build_null_plan(
        graph, jnp.asarray(adata.obsm[spatial_key], jnp.float32))
    try:
        adata._null_plan_cache = {"key": key, "plan": plan}
    except (AttributeError, TypeError):   # slotted containers: skip cache
        pass
    return plan


def _normalize_pairs(gene_pairs) -> Tuple[List[Tuple[str, str]], bool]:
    if isinstance(gene_pairs, tuple) and len(gene_pairs) == 2 \
            and isinstance(gene_pairs[0], str):
        return [gene_pairs], True
    return list(gene_pairs), False


def lees_l(
    adata,
    gene_pairs: Union[Tuple[str, str], List[Tuple[str, str]]],
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 199,
    seed: int = 0,
    use_existing_graph: bool = False,
    null_method: str = "auto",
) -> Union[dict, List[dict]]:
    """Global Lee's L for gene pair(s); returns dict(s), does not write adata.

    L = Σ_i z_x,i · lag(z_y)_i with two-tailed permutation p (reference
    convention, autocorrelation.py:307-332). Zero-variance pairs get
    L=0, p=1 with a warning.

    ``null_method``: "auto" routes the permutation null through the banded
    kernel at >= 100k cells (one row gather + band matmuls per draw
    instead of k gathers — at k=50 that is 50× fewer gathered rows);
    "banded"/"direct" force either path; "banded_int8" opts into the int8
    quantized-operator null (fastest; k <= 1000). The banded paths draw
    from their own seeded Feistel stream (``ops.banded.banded_lees_l``
    with ``perm_method="sort"`` reproduces the direct kernel's draws);
    either way p-values agree to Monte-Carlo tie level and the observed L
    is always the exact direct kernel.
    """
    start = time.time()
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found. Spatial coordinates are required.")
    if n_neighbors < 1:
        raise ValueError(f"n_neighbors must be >= 1, got {n_neighbors}")
    if n_permutations < 0:
        raise ValueError(f"n_permutations must be >= 0, got {n_permutations}")

    pairs, single = _normalize_pairs(gene_pairs)
    all_genes = sorted({g for p in pairs for g in p})
    missing = [g for g in all_genes if g not in adata.var_names]
    if missing:
        raise ValueError(f"Genes not found in adata.var_names: {missing}")

    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph)
    X = _dense_expression(adata, all_genes, layer)
    Z, zero_var = standardize(jnp.asarray(X))
    zero_var = np.asarray(zero_var)
    gi = {g: i for i, g in enumerate(all_genes)}

    ok_pairs = [(gx, gy) for gx, gy in pairs
                if not (zero_var[gi[gx]] or zero_var[gi[gy]])]
    use_banded, band_prec = _lees_use_banded(null_method, adata.n_obs,
                                             n_permutations)
    results_map = {}
    if ok_pairs:
        Zx = Z[:, [gi[gx] for gx, _ in ok_pairs]]
        Zy = Z[:, [gi[gy] for _, gy in ok_pairs]]
        if use_banded:
            from ..ops.banded import banded_lees_l

            res = lees_l_pairs(graph, Zx, Zy, seed, 0)   # exact observed
            plan = _get_null_plan(adata, graph, spatial_key)
            p_g, _ = banded_lees_l(plan, Zx, Zy, seed, n_permutations,
                                   precision=band_prec)
            pg = np.asarray(p_g)
        else:
            res = lees_l_pairs(graph, Zx, Zy, seed, n_permutations)
            pg = np.asarray(res.p_global)
        Lg = np.asarray(res.L_global)
        for i, (gx, gy) in enumerate(ok_pairs):
            results_map[(gx, gy)] = {"gene_x": gx, "gene_y": gy,
                                     "L": float(Lg[i]), "p_value": float(pg[i])}
    results = []
    for gx, gy in pairs:
        if (gx, gy) in results_map:
            results.append(results_map[(gx, gy)])
        else:
            logger.warning(f"Gene pair ({gx}, {gy}) has zero-variance gene — L set to 0")
            results.append({"gene_x": gx, "gene_y": gy, "L": 0.0, "p_value": 1.0})

    logger.info(f"Global Lee's L completed in {time.time() - start:.1f}s")
    return results[0] if single else results


def lees_l_local(
    adata,
    gene_pairs: Optional[Union[Tuple[str, str], List[Tuple[str, str]]]] = None,
    genes: Optional[List[str]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 199,
    compute_cell_pvalues: bool = False,
    significance_filter: bool = False,
    alpha: float = 0.05,
    seed: int = 0,
    copy: bool = False,
    use_existing_graph: bool = False,
    null_method: str = "auto",
    output_mode: str = "auto",
    key_added: str = "lees_local",
    fdr_correction: Literal["bonferroni", "fdr_bh", "none"] = "fdr_bh",
):
    """Local Lee's L per cell for gene pair(s).

    Writes ``obs[f"{gx}_{gy}_lees_l"]``, ``obs[f"{gx}_{gy}_quadrant"]``
    (categorical NS/HH/LL/HL/LH), optional ``obs[f"{gx}_{gy}_pvalue"]`` and
    ``uns[f"{gx}_{gy}_lees_l_params"]`` with quadrant counts — the
    reference's output contract (autocorrelation.py:1429-1453).

    ``null_method``: as in :func:`lees_l` — "auto" uses the banded null
    kernel at >= 100k cells (one gather per draw instead of k);
    "banded_int8" opts into the int8 quantized-operator null.

    ``output_mode``: "full" keeps the documented per-pair obs columns
    (host pandas — fine up to tens of pairs). "compact" streams pair
    tiles through the banded int8 null operators
    (ops.streaming.streaming_local_null, stat="lee"; requires the banded
    path with ``n_permutations > 0``) and writes [N, n_pairs] obsm
    planes ``{key_added}_L/_p/_p_adj/_quadrant`` + ``{key_added}_params``
    instead — device-resident compact dtypes (L bf16, p/p_adj f16,
    quadrant int8 = 7 B/cell/pair) when the expression is
    device-resident. Cell p-values are always computed on this path, and
    ``p_adj`` applies ``fdr_correction`` per pair across cells. "auto"
    picks "compact" only for device-resident inputs on the banded path
    with ``compute_cell_pvalues=True`` when the full-precision planes
    would exceed ~8 GB (the :func:`local_morans_i` rule).
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found. Spatial coordinates are required.")
    if n_permutations < 0:
        raise ValueError(f"n_permutations must be >= 0, got {n_permutations}")
    if significance_filter and not compute_cell_pvalues:
        raise ValueError("significance_filter=True requires compute_cell_pvalues=True")

    if genes is not None:
        n_pairs = len(genes) * (len(genes) - 1) // 2
        logger.warning(
            f"All-pairs mode: {len(genes)} genes = {n_pairs} pairs. "
            "Consider explicit gene_pairs for better performance.")
        pairs = list(combinations(genes, 2))
    else:
        if gene_pairs is None:
            raise ValueError("Provide gene_pairs or genes")
        pairs, _ = _normalize_pairs(gene_pairs)

    all_genes = sorted({g for p in pairs for g in p})
    missing = [g for g in all_genes if g not in adata.var_names]
    if missing:
        raise ValueError(f"Genes not found in adata.var_names: {missing}")

    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph)

    if output_mode not in ("auto", "full", "compact"):
        raise ValueError(f"output_mode must be 'auto', 'full' or "
                         f"'compact', got {output_mode!r}")
    use_banded0, band_prec0 = _lees_use_banded(null_method, adata.n_obs,
                                               n_permutations)
    X_is_device = isinstance(
        adata.layers[layer] if layer and layer in getattr(
            adata, "layers", {}) else getattr(adata, "X", None), jax.Array)
    if output_mode == "auto":
        output_mode = ("compact"
                       if use_banded0 and X_is_device
                       and compute_cell_pvalues
                       and adata.n_obs * len(pairs) * 16 > 8e9 else "full")
    if output_mode == "compact":
        if not use_banded0 or n_permutations <= 0:
            raise ValueError(
                "output_mode='compact' streams through the banded null "
                "path — use null_method='auto'/'banded'/'banded_int8' "
                "with n_permutations > 0 (and >= 100k cells for 'auto')")
        plan = _get_null_plan(adata, graph, spatial_key)
        gx_names = [p[0] for p in pairs]
        gy_names = [p[1] for p in pairs]
        out = _run_compact_stream(
            adata, "lee", None, layer, graph, plan, n_permutations,
            fdr_correction, alpha, seed, min(256, max(len(pairs), 1)),
            band_prec0, X_is_device, ("L", "p", "p_adj", "quadrant"),
            pair_names=(gx_names, gy_names))
        for k in ("L", "p", "p_adj", "quadrant"):
            adata.obsm[f"{key_added}_{k}"] = out[k]
        elapsed = time.time() - start
        adata.uns[f"{key_added}_params"] = {
            "pairs": [list(p) for p in pairs],
            "n_pairs": len(pairs), "n_neighbors": n_neighbors,
            "n_permutations": n_permutations, "seed": seed,
            "alpha": alpha, "fdr_correction": fdr_correction,
            "null_method": ("banded_int8" if band_prec0 == "int8"
                            else "banded"),
            "output_mode": "compact",
            "quadrant_labels": dict(QUADRANT_LABELS),
            "computation_time_seconds": elapsed,
        }
        logger.info(f"Local Lee's L (compact streaming) completed in "
                    f"{elapsed:.1f}s for {len(pairs)} pair(s)")
        update_metadata(
            adata, "lees_l_local",
            parameters={"gene_pairs": [list(p) for p in pairs[:10]],
                        "n_pairs": len(pairs),
                        "n_neighbors": n_neighbors,
                        "n_permutations": n_permutations,
                        "alpha": alpha, "seed": seed,
                        "output_mode": "compact"},
            outputs={f"obsm_{s}": f"{key_added}_{s}"
                     for s in ("L", "p", "p_adj", "quadrant")} |
                    {"uns_params": f"{key_added}_params"},
        )
        return adata

    X = _dense_expression(adata, all_genes, layer)
    Z, zero_var = standardize(jnp.asarray(X))
    zero_var = np.asarray(zero_var)
    gi = {g: i for i, g in enumerate(all_genes)}
    n_cells = adata.n_obs

    ok_pairs = [(gx, gy) for gx, gy in pairs
                if not (zero_var[gi[gx]] or zero_var[gi[gy]])]
    use_banded, band_prec = _lees_use_banded(null_method, adata.n_obs,
                                             n_permutations)
    if ok_pairs:
        Zx = Z[:, [gi[gx] for gx, _ in ok_pairs]]
        Zy = Z[:, [gi[gy] for _, gy in ok_pairs]]
        if use_banded:
            from ..ops.banded import banded_lees_l

            res = lees_l_pairs(graph, Zx, Zy, seed, 0)   # exact observed
            plan = _get_null_plan(adata, graph, spatial_key)
            p_g, p_l = banded_lees_l(
                plan, Zx, Zy, seed, n_permutations, precision=band_prec,
                compute_cell_pvalues=compute_cell_pvalues)
            p_global, p_local = np.asarray(p_g), np.asarray(p_l)
        else:
            res = lees_l_pairs(graph, Zx, Zy, seed, n_permutations,
                               compute_cell_pvalues=compute_cell_pvalues)
            p_global = np.asarray(res.p_global)
            p_local = np.asarray(res.p_local)
        L_local = np.asarray(res.L_local)
        L_global = np.asarray(res.L_global)
        Zx_np, lag_np = np.asarray(Zx), np.asarray(res.lag_zy)

    cat = ["NS", "HH", "LL", "HL", "LH"]
    pair_col = {p: i for i, p in enumerate(ok_pairs)}
    for gx, gy in pairs:
        key = f"{gx}_{gy}"
        if (gx, gy) not in pair_col:
            logger.warning(f"Pair ({gx}, {gy}): zero-variance gene — writing zeros")
            adata.obs[f"{key}_lees_l"] = np.zeros(n_cells, np.float32)
            adata.obs[f"{key}_quadrant"] = pd.Categorical(["NS"] * n_cells,
                                                          categories=cat)
            adata.uns[f"{key}_lees_l_params"] = {
                "gene_x": gx, "gene_y": gy, "global_L": 0.0, "global_pvalue": 1.0,
                "n_neighbors": n_neighbors, "n_permutations": n_permutations,
                "zero_variance": True,
            }
            continue
        i = pair_col[(gx, gy)]
        pv = p_local[:, i] if compute_cell_pvalues else None
        q = np.asarray(classify_quadrants(
            jnp.asarray(Zx_np[:, i]), jnp.asarray(lag_np[:, i]),
            jnp.asarray(pv) if (significance_filter and pv is not None) else None,
            alpha))
        # vectorized label/count construction: per-cell Python loops cost
        # seconds of host time per pair at 1M cells (cat order == the
        # QUADRANT_LABELS code order)
        q_codes = q.astype(np.int64)
        adata.obs[f"{key}_lees_l"] = L_local[:, i].astype(np.float32)
        adata.obs[f"{key}_quadrant"] = pd.Categorical.from_codes(
            q_codes, categories=cat)
        if compute_cell_pvalues:
            adata.obs[f"{key}_pvalue"] = p_local[:, i].astype(np.float32)
        bc = np.bincount(q_codes, minlength=len(cat))
        counts = {c: int(bc[j]) for j, c in enumerate(cat)}
        adata.uns[f"{key}_lees_l_params"] = {
            "gene_x": gx, "gene_y": gy,
            "global_L": float(L_global[i]), "global_pvalue": float(p_global[i]),
            "n_neighbors": n_neighbors, "n_permutations": n_permutations,
            "compute_cell_pvalues": compute_cell_pvalues,
            "significance_filter": significance_filter, "alpha": alpha,
            "quadrant_counts": counts,
        }

    elapsed = time.time() - start
    logger.info(f"Local Lee's L completed in {elapsed:.1f}s for {len(pairs)} pair(s)")
    update_metadata(
        adata, "lees_l_local",
        parameters={"gene_pairs": [list(p) for p in pairs[:10]],
                    "n_pairs": len(pairs), "n_neighbors": n_neighbors,
                    "n_permutations": n_permutations,
                    "compute_cell_pvalues": compute_cell_pvalues,
                    "significance_filter": significance_filter,
                    "alpha": alpha, "seed": seed},
        outputs={"obs_keys": [f"{gx}_{gy}_lees_l" for gx, gy in pairs[:5]],
                 "uns_keys": [f"{gx}_{gy}_lees_l_params" for gx, gy in pairs[:5]]},
    )
    return adata


# ---------------------------------------------------------------------------
# Join counts
# ---------------------------------------------------------------------------


def _binarize_obs_column(adata, column: str, category=None) -> np.ndarray:
    """Shared 0/1 encoding for join-count statistics (global AND local —
    one contract: bool dtype, {True, False} values, numeric >0, or an
    explicit ``category=`` label)."""
    if column not in adata.obs.columns:
        raise ValueError(f"adata.obs['{column}'] not found")
    series = adata.obs[column]
    if category is not None:
        return (series.astype(str) == str(category)).to_numpy()
    uniq = set(series.dropna().unique())
    if series.dtype == bool or uniq.issubset({True, False}):
        return series.fillna(False).astype(bool).to_numpy()
    try:
        return (series.astype(float) > 0).to_numpy()
    except (ValueError, TypeError):
        raise ValueError(
            f"Column '{column}' is not boolean or numeric; pass "
            "category=<label> to binarize.") from None


def join_count_statistics(
    adata,
    column: str,
    category=None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 999,
    seed: int = 0,
    key_added: str = "join_counts",
    use_existing_graph: bool = False,
    copy: bool = False,
):
    """Join-count autocorrelation for a binary label (BB / WW / BW joins).

    ``column`` must be boolean, or categorical with ``category`` naming the
    "black" class. Positive spatial clustering of the class shows as a
    small ``p_BB``. Results land in ``uns[key_added]``. (esda-family
    statistic; not in the reference — same kernel substrate as Moran.)
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    x = _binarize_obs_column(adata, column, category)
    frac = float(x.mean())
    if frac in (0.0, 1.0):
        raise ValueError(
            f"Column '{column}' is constant ({frac:.0%} positive); join "
            "counts need both classes present.")

    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph)
    res = _join_counts_kernel(graph, jnp.asarray(x.astype(np.float32)),
                              seed=seed, n_permutations=n_permutations)
    out = {k: float(v) for k, v in res.items()}
    out.update({"n_positive": int(x.sum()), "fraction_positive": frac,
                "n_permutations": n_permutations, "seed": seed,
                "computation_time_seconds": round(time.time() - start, 2)})
    adata.uns[key_added] = out
    logger.info(f"join counts: BB={out['BB']:.0f} (p={out['p_BB']:.4f}), "
                f"BW={out['BW']:.0f} (p={out['p_BW']:.4f})")
    update_metadata(adata, "join_count_statistics",
                    parameters={"column": column, "category": category,
                                "n_permutations": n_permutations,
                                "seed": seed},
                    outputs={"uns": key_added})
    return adata


# ---------------------------------------------------------------------------
# Local Geary's C
# ---------------------------------------------------------------------------

def local_gearys_c(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 99,
    fdr_correction: Literal["bonferroni", "fdr_bh", "none"] = "fdr_bh",
    seed: int = 0,
    batch_size: int = 100,
    key_added: str = "local_geary",
    use_existing_graph: bool = False,
    null: str = "conditional",
    copy: bool = False,
    null_method: str = "auto",
    output_mode: str = "auto",
):
    """Local Geary's C per cell × gene (Anselin's multivariate-ready LISA).

    Small C with small p = the cell sits in a coherent neighborhood for
    that gene. Outputs ``obsm[f"{key}_C"]``, ``obsm[f"{key}_p"]``,
    ``obsm[f"{key}_p_adj"]`` and ``uns[f"{key}_params"]``. ``null`` picks
    the randomization: "conditional" (GeoDa convention: each cell's own
    value held fixed, neighbor values drawn from the other cells) or
    "total" (whole-column shuffle). (Extension — ROADMAP item 6.)

    ``null_method``: with ``null="total"``, "auto" routes the permutation
    draws through the banded kernel (f32, one row gather + band matmuls
    per draw instead of k gathers) at >= 100k cells on k >= 16 graphs;
    "banded"/"direct" force either path; "banded_int8" opts into the
    fully-integer quantized-operator null (fastest; k <= 256). The
    conditional null always runs the direct kernel.

    ``output_mode``: "full" keeps the documented three f32 [N, G] obsm
    planes. "compact" streams gene tiles through the banded int8 null
    operators (ops.streaming.streaming_local_null, requires the banded
    path: ``null="total"`` with ``null_method`` banded/auto-selected and
    ``n_permutations > 0``) so outputs stay memory-bounded —
    device-resident compact dtypes (C bf16, p/p_adj f16 — 6 B/cell/gene
    vs the full mode's 12) when the expression is device-resident, f32
    host arrays flushed per tile otherwise. "auto" picks "compact" only
    when the full outputs would exceed ~8 GB on a device-resident input
    and the banded path is active (the same rule as
    :func:`local_morans_i`).
    """
    from ..ops.moran import local_geary as _local_geary_kernel

    if null_method not in ("auto", "banded", "banded_int8", "direct"):
        raise ValueError("null_method must be 'auto', 'banded', "
                         f"'banded_int8' or 'direct', got {null_method!r}")
    band_prec = "f32"
    if null_method == "banded_int8":
        null_method, band_prec = "banded", "int8"

    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found. Spatial coordinates are required.")
    gene_names = _resolve_genes(adata, genes)
    n_cells, n_genes = adata.n_obs, len(gene_names)
    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph)

    k_eff = int(graph.neighbor_idx.shape[1])
    use_banded = (null == "total" and n_permutations > 0
                  and null_method != "direct"
                  and (null_method == "banded"
                       or (n_cells >= 100_000 and k_eff >= 16)))
    if null_method == "banded" and null != "total":
        logger.warning("null='conditional' is not supported by the banded "
                       "path; using the direct kernel")
        use_banded = False
    plan = _get_null_plan(adata, graph, spatial_key) if use_banded else None

    if output_mode not in ("auto", "full", "compact"):
        raise ValueError(f"output_mode must be 'auto', 'full' or "
                         f"'compact', got {output_mode!r}")
    X_is_device = isinstance(
        adata.layers[layer] if layer and layer in getattr(
            adata, "layers", {}) else getattr(adata, "X", None), jax.Array)
    if output_mode == "auto":
        output_mode = ("compact"
                       if plan is not None and X_is_device
                       and n_cells * n_genes * 12 > 8e9 else "full")
    if output_mode == "compact":
        if plan is None or n_permutations <= 0:
            raise ValueError(
                "output_mode='compact' streams through the banded null "
                "path — use null='total' with null_method='banded'/"
                "'banded_int8' and n_permutations > 0")
        out = _run_compact_stream(
            adata, "geary", gene_names, layer, graph, plan,
            n_permutations, fdr_correction, 0.05, seed,
            max(batch_size, 256), band_prec, X_is_device,
            ("C", "p", "p_adj"))
        for k in ("C", "p", "p_adj"):
            adata.obsm[f"{key_added}_{k}"] = out[k]
        adata.uns[f"{key_added}_params"] = {
            "genes": gene_names, "n_neighbors": n_neighbors,
            "n_permutations": n_permutations, "seed": seed,
            "fdr_correction": fdr_correction, "null": null,
            "null_method": ("banded_int8" if band_prec == "int8"
                            else "banded"),
            "output_mode": "compact",
            "computation_time_seconds": round(time.time() - start, 2),
        }
        logger.info(f"Local Geary's C (compact streaming): {n_cells:,} "
                    f"cells × {n_genes} genes "
                    f"({time.time() - start:.1f}s)")
        update_metadata(adata, "local_gearys_c",
                        parameters={"n_genes": n_genes,
                                    "n_permutations": n_permutations,
                                    "seed": seed,
                                    "output_mode": "compact"},
                        outputs={"obsm": [f"{key_added}_C",
                                          f"{key_added}_p",
                                          f"{key_added}_p_adj"],
                                 "uns": f"{key_added}_params"})
        return adata

    device_mode = False
    batches = []
    C_all = p_all = None
    for bs in range(0, n_genes, batch_size):
        batch = gene_names[bs:bs + batch_size]
        Xb = _dense_expression(adata, batch, layer)
        if bs == 0:
            device_mode = isinstance(Xb, jax.Array)
            if not device_mode:
                C_all = np.zeros((n_cells, n_genes), np.float32)
                p_all = np.ones_like(C_all)
        Z, zero_var = standardize(jnp.asarray(Xb))
        if plan is not None:
            from ..ops.banded import banded_local_geary
            from ..ops.moran import LocalGearyResult

            obs = _local_geary_kernel(graph, Z, seed=seed,
                                      n_permutations=0, null=null)
            _, p_band = banded_local_geary(plan, Z, seed, n_permutations,
                                           precision=band_prec)
            res = LocalGearyResult(obs.local_C, p_band)
        else:
            res = _local_geary_kernel(graph, Z, seed=seed,
                                      n_permutations=n_permutations,
                                      null=null)
        if device_mode:
            # outputs stay device-resident (see local_morans_i)
            batches.append((jnp.where(zero_var[None, :], 0.0, res.local_C),
                            jnp.where(zero_var[None, :], 1.0, res.p_value)))
            continue
        sl = slice(bs, bs + len(batch))
        C_all[:, sl] = np.asarray(res.local_C)
        p_all[:, sl] = np.asarray(res.p_value)
        zv = np.asarray(zero_var)
        if zv.any():
            C_all[:, sl][:, zv] = 0.0
            p_all[:, sl][:, zv] = 1.0

    if device_mode:
        C_all, p_all = _concat_device_batches(batches)
    elif C_all is None:   # zero genes requested: keep [N, 0] outputs
        C_all = np.zeros((n_cells, n_genes), np.float32)
        p_all = np.ones_like(C_all)
    out = (lambda a: a) if device_mode else np.asarray
    p_adj = out(apply_fdr(jnp.asarray(p_all), fdr_correction, axis=0,
                          n_levels=n_permutations + 1)) \
        if n_permutations > 0 else p_all
    adata.obsm[f"{key_added}_C"] = C_all
    adata.obsm[f"{key_added}_p"] = p_all
    adata.obsm[f"{key_added}_p_adj"] = p_adj
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names, "n_neighbors": n_neighbors,
        "n_permutations": n_permutations, "seed": seed,
        "fdr_correction": fdr_correction, "null": null,
        "null_method": (("banded_int8" if band_prec == "int8" else "banded")
                        if plan is not None else "direct"),
        "computation_time_seconds": round(time.time() - start, 2),
    }
    logger.info(f"Local Geary's C: {n_cells:,} cells × {n_genes} genes "
                f"({time.time() - start:.1f}s)")
    update_metadata(adata, "local_gearys_c",
                    parameters={"n_genes": n_genes,
                                "n_permutations": n_permutations,
                                "seed": seed},
                    outputs={"obsm": [f"{key_added}_C", f"{key_added}_p",
                                      f"{key_added}_p_adj"],
                             "uns": f"{key_added}_params"})
    return adata


def local_join_counts(
    adata,
    column: str,
    category=None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 999,
    seed: int = 0,
    key_added: Optional[str] = None,
    use_existing_graph: bool = False,
    copy: bool = False,
):
    """Local join counts for a binary obs column (Anselin & Li 2019).

    BB_i counts same-category (1-1) neighbor joins at each positive cell;
    the conditional-permutation p flags significant local clustering of
    the binary condition. ``column`` must be boolean or numeric (>0 is
    positive), or categorical with ``category`` naming the positive class
    — the same contract as ``join_count_statistics``. Outputs
    ``obs[f"{key}_BB"]`` and ``obs[f"{key}_p"]`` (p = 1 where the cell is
    0). (Extension — ROADMAP item 6; the reference has only global join
    counts via this build's ``join_count_statistics``.)
    """
    from ..ops.moran import local_join_counts as _ljc

    start = time.time()
    if copy:
        adata = adata.copy()
    x = _binarize_obs_column(adata, column, category).astype(np.float32)
    if x.sum() == 0 or x.sum() == len(x):
        raise ValueError(
            f"obs['{column}'] must contain both 0/False and 1/True values")
    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph)
    bb, p = _ljc(graph, jnp.asarray(x), seed=seed,
                 n_permutations=n_permutations)
    key = key_added or f"{column}_local_jc"
    adata.obs[f"{key}_BB"] = np.asarray(bb)
    adata.obs[f"{key}_p"] = np.asarray(p)
    update_metadata(adata, "local_join_counts", parameters={
        "column": column, "category": category, "n_neighbors": n_neighbors,
        "n_permutations": n_permutations, "seed": seed,
        "computation_time_seconds": round(time.time() - start, 2)})
    logger.info(f"Local join counts for '{column}' "
                f"({int(x.sum()):,} positive cells)")
    return adata


def local_gearys_c_multivariate(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 999,
    seed: int = 0,
    key_added: str = "local_geary_mv",
    use_existing_graph: bool = False,
    copy: bool = False,
):
    """Multivariate local Geary (Anselin 2019): one coherence statistic per
    cell over a gene SET — small c with small p marks cells whose whole
    expression profile resembles their neighborhood.

    Outputs ``obs[key_added]`` (c_i) and ``obs[f"{key_added}_p"]``
    (one-sided conditional-permutation p). (Extension — ROADMAP item 6.)
    """
    from ..ops.moran import local_geary_multivariate as _lgm

    start = time.time()
    if copy:
        adata = adata.copy()
    gene_names = _resolve_genes(adata, genes)
    X = _dense_expression(adata, gene_names, layer)
    Z, _ = standardize(jnp.asarray(X))
    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph)
    c, p = _lgm(graph, Z, seed=seed, n_permutations=n_permutations)
    adata.obs[key_added] = np.asarray(c)
    adata.obs[f"{key_added}_p"] = np.asarray(p)
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names, "n_neighbors": n_neighbors,
        "n_permutations": n_permutations, "seed": seed,
        "computation_time_seconds": round(time.time() - start, 2)}
    update_metadata(adata, "local_gearys_c_multivariate", parameters={
        "n_genes": len(gene_names), "n_neighbors": n_neighbors,
        "n_permutations": n_permutations, "seed": seed})
    logger.info(f"Multivariate local Geary over {len(gene_names)} genes")
    return adata


# ---------------------------------------------------------------------------
# Getis-Ord Gi* hot spots
# ---------------------------------------------------------------------------

def getis_ord_gi(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    star: bool = True,
    alternative: Literal["two-sided", "greater", "less"] = "two-sided",
    n_permutations: int = 0,
    fdr_correction: Literal["bonferroni", "fdr_bh", "none"] = "fdr_bh",
    alpha: float = 0.05,
    seed: int = 0,
    batch_size: int = 100,
    key_added: str = "getis_ord",
    copy: bool = False,
    use_existing_graph: bool = False,
    null_method: str = "auto",
    output_mode: str = "auto",
):
    """Getis-Ord Gi*/Gi hot-spot z-scores per cell × gene.

    ``null_method``: "auto" routes ``n_permutations>0`` draws through the
    banded kernel (f32; one row gather + band matmuls per draw instead of
    k gathers) at >= 100k cells on k >= 16 graphs; "banded"/"direct"
    force either path; "banded_int8" opts into the int8 quantized-operator
    null (fastest — exact binary adjacency, per-gene quantized X).
    Analytic z/p always come from the exact kernel.

    The classic local hot-spot statistic (Ord & Getis 1995; esda
    ``G_Local`` analog — an extension: neither the reference nor squidpy
    ships it). Computed on RAW expression (not z-scored): hot spots are
    cells whose neighborhood sum of expression is higher than expected
    under spatial randomness; cold spots lower. Analytic normal p-values
    by default; ``n_permutations>0`` adds column-shuffle permutation
    p-values (same null convention as :func:`local_morans_i`).

    Outputs: ``obsm[f"{key}_G" / "_z" / "_p" / "_p_adj" / "_hotspot"]``
    (hotspot int8: 1 hot, −1 cold, 0 NS at ``alpha`` after FDR) and
    ``uns[f"{key}_params"]``.

    ``output_mode``: "full" keeps the documented f32 [N, G] obsm planes.
    "compact" streams gene tiles through the banded int8 null operators
    (ops.streaming.streaming_local_null; requires the banded path with
    ``n_permutations > 0``) — device-resident compact dtypes (G/z bf16,
    p/p_sim/p_adj f16, hotspot int8 = 11 B/cell/gene vs full's 24) when
    the expression is device-resident, f32 host arrays flushed per tile
    otherwise. "auto" picks "compact" only when the full outputs would
    exceed ~8 GB on a device-resident input and the banded path is
    active (the :func:`local_morans_i` rule).
    """
    from ..ops.getis import getis_ord as _getis_kernel

    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found. Spatial coordinates "
            "are required.")
    gene_names = _resolve_genes(adata, genes)
    n_cells, n_genes = adata.n_obs, len(gene_names)
    logger.info(f"Getis-Ord {'Gi*' if star else 'Gi'}: {n_cells:,} cells × "
                f"{n_genes} genes, k={n_neighbors}, P={n_permutations}")
    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph)

    if null_method not in ("auto", "banded", "banded_int8", "direct"):
        raise ValueError("null_method must be 'auto', 'banded', "
                         f"'banded_int8' or 'direct', got {null_method!r}")
    band_prec = "f32"
    if null_method == "banded_int8":
        null_method, band_prec = "banded", "int8"
    k_eff = int(graph.neighbor_idx.shape[1])
    use_banded = (n_permutations > 0 and null_method != "direct"
                  and (null_method == "banded"
                       or (n_cells >= 100_000 and k_eff >= 16)))
    plan = _get_null_plan(adata, graph, spatial_key) if use_banded else None

    if output_mode not in ("auto", "full", "compact"):
        raise ValueError(f"output_mode must be 'auto', 'full' or "
                         f"'compact', got {output_mode!r}")
    X_is_device = isinstance(
        adata.layers[layer] if layer and layer in getattr(
            adata, "layers", {}) else getattr(adata, "X", None), jax.Array)
    if output_mode == "auto":
        output_mode = ("compact"
                       if plan is not None and X_is_device
                       and n_cells * n_genes * 24 > 8e9 else "full")
    if output_mode == "compact":
        if plan is None or n_permutations <= 0:
            raise ValueError(
                "output_mode='compact' streams through the banded null "
                "path — use null_method='banded'/'banded_int8' with "
                "n_permutations > 0")
        out = _run_compact_stream(
            adata, "getis", gene_names, layer, graph, plan,
            n_permutations, fdr_correction, alpha, seed,
            max(batch_size, 256), band_prec, X_is_device,
            ("G", "z_score", "p", "p_sim", "p_adj", "hotspot"),
            star=star, alternative=alternative)
        obsm_map = {"G": "G", "z_score": "z", "p": "p", "p_sim": "p_sim",
                    "p_adj": "p_adj", "hotspot": "hotspot"}
        for k, suffix in obsm_map.items():
            adata.obsm[f"{key_added}_{suffix}"] = out[k]
        elapsed = time.time() - start
        adata.uns[f"{key_added}_params"] = {
            "genes": gene_names, "n_neighbors": n_neighbors, "star": star,
            "alternative": alternative, "n_permutations": n_permutations,
            "fdr_correction": fdr_correction, "alpha": alpha, "seed": seed,
            "null_method": ("banded_int8" if band_prec == "int8"
                            else "banded"),
            "output_mode": "compact",
            "computation_time_seconds": elapsed,
        }
        update_metadata(
            adata, "getis_ord_gi",
            parameters={"genes": gene_names[:10], "n_genes": n_genes,
                        "n_neighbors": n_neighbors, "star": star,
                        "n_permutations": n_permutations, "alpha": alpha,
                        "seed": seed, "output_mode": "compact"},
            outputs={f"obsm_{s}": f"{key_added}_{s}"
                     for s in ("G", "z", "p", "p_sim", "p_adj",
                               "hotspot")} |
                    {"uns_params": f"{key_added}_params"},
        )
        logger.info(f"Getis-Ord (compact streaming) completed in "
                    f"{elapsed:.1f}s")
        return adata

    device_mode = False
    batches = []
    G_all = z_all = p_all = psim_all = None
    for bs in range(0, n_genes, batch_size):
        batch = gene_names[bs:bs + batch_size]
        Xb = _dense_expression(adata, batch, layer)
        if bs == 0:
            device_mode = isinstance(Xb, jax.Array)
            if not device_mode:
                G_all = np.zeros((n_cells, n_genes), np.float32)
                z_all = np.zeros_like(G_all)
                p_all = np.ones_like(G_all)
                psim_all = np.ones_like(G_all)
        if plan is not None:
            from ..ops.banded import banded_getis
            from ..ops.getis import GetisOrdResult

            obs = _getis_kernel(graph, jnp.asarray(Xb), star=star,
                                alternative=alternative, seed=seed,
                                n_permutations=0)
            p_band = banded_getis(plan, jnp.asarray(Xb), seed,
                                  n_permutations, star=star,
                                  alternative=alternative,
                                  precision=band_prec)
            res = GetisOrdResult(obs.G, obs.z_score, obs.p_value, p_band)
        else:
            res = _getis_kernel(graph, jnp.asarray(Xb), star=star,
                                alternative=alternative, seed=seed,
                                n_permutations=n_permutations)
        if device_mode:
            # outputs stay device-resident (see local_morans_i)
            batches.append((res.G, res.z_score, res.p_value, res.p_sim))
            continue
        sl = slice(bs, bs + len(batch))
        G_all[:, sl] = np.asarray(res.G)
        z_all[:, sl] = np.asarray(res.z_score)
        p_all[:, sl] = np.asarray(res.p_value)
        psim_all[:, sl] = np.asarray(res.p_sim)

    if device_mode:
        G_all, z_all, p_all, psim_all = _concat_device_batches(batches)
    elif G_all is None:   # zero genes requested: keep [N, 0] outputs
        G_all = np.zeros((n_cells, n_genes), np.float32)
        z_all = np.zeros_like(G_all)
        p_all = np.ones_like(G_all)
        psim_all = np.ones_like(G_all)
    out = (lambda a: a) if device_mode else np.asarray
    p_used = psim_all if n_permutations > 0 else p_all
    # p_sim is grid-valued ((c+1)/(P+1)) -> sort-free discrete BH; the
    # P=0 analytic p is continuous and keeps the sort path
    p_adj = out(apply_fdr(jnp.asarray(p_used), fdr_correction, axis=0,
                          n_levels=(n_permutations + 1
                                    if n_permutations > 0 else 0)))
    if device_mode:
        hotspot = jnp.where(
            jnp.asarray(p_adj) < alpha,
            jnp.sign(jnp.asarray(z_all)).astype(jnp.int8),
            jnp.int8(0))
    else:
        hotspot = np.zeros_like(z_all, np.int8)
        hotspot[(z_all > 0) & (p_adj < alpha)] = 1
        hotspot[(z_all < 0) & (p_adj < alpha)] = -1

    adata.obsm[f"{key_added}_G"] = G_all
    adata.obsm[f"{key_added}_z"] = z_all
    adata.obsm[f"{key_added}_p"] = p_all
    if n_permutations > 0:
        adata.obsm[f"{key_added}_p_sim"] = psim_all
    adata.obsm[f"{key_added}_p_adj"] = p_adj
    adata.obsm[f"{key_added}_hotspot"] = hotspot

    elapsed = time.time() - start
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names, "n_neighbors": n_neighbors, "star": star,
        "alternative": alternative, "n_permutations": n_permutations,
        "fdr_correction": fdr_correction, "alpha": alpha, "seed": seed,
        "null_method": (("banded_int8" if band_prec == "int8" else "banded")
                        if plan is not None else "direct"),
        "computation_time_seconds": elapsed,
    }
    update_metadata(
        adata, "getis_ord_gi",
        parameters={"genes": gene_names[:10], "n_genes": n_genes,
                    "n_neighbors": n_neighbors, "star": star,
                    "n_permutations": n_permutations, "alpha": alpha,
                    "seed": seed},
        outputs={f"obsm_{s}": f"{key_added}_{s}"
                 for s in ("G", "z", "p", "p_adj", "hotspot")} |
                {"uns_params": f"{key_added}_params"},
    )
    logger.info(f"Getis-Ord completed in {elapsed:.1f}s")
    return adata


# ---------------------------------------------------------------------------
# Moran correlogram (distance-band profile)
# ---------------------------------------------------------------------------

def moran_correlogram(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    bands: Optional[Sequence[float]] = None,
    n_bands: int = 5,
    k_max: int = 128,
    n_permutations: int = 0,
    seed: int = 0,
    key_added: str = "moran_correlogram",
    copy: bool = False,
):
    """Global Moran's I per distance band — the spatial correlogram.

    For each band [lo, hi) a binary row-normalized weights matrix links
    cells to neighbors at that distance range (built once from a single
    capped radius search at max(bands)); I(d) profiles how far spatial
    autocorrelation reaches. Classic esda/PySAL exploratory tool — an
    extension; the reference has single-graph statistics only.

    ``bands``: band edges (len B+1). Default: ``n_bands`` equal-width
    bands up to ~3× the mean 6-NN distance. Permutations (optional) use
    the analytic z as well: each band row carries I, E[I], z, p (normal)
    and p_sim when ``n_permutations > 0``.

    All bands (statistics, Cliff-Ord moments, AND the permutation scan)
    run in ONE device dispatch (ops.moran.correlogram_kernel) instead of
    one dispatch + host CSR-moments pass + its own permutation scan per
    band.

    Output: ``uns[key_added]`` DataFrame (band_lo, band_hi, gene, I,
    z_score, p_value[, p_sim]) + ``uns[f"{key_added}_params"]``.
    """
    from ..ops.graph import radius_neighbors
    from ..ops.moran import correlogram_kernel

    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found. Spatial coordinates "
            "are required.")
    coords = np.asarray(adata.obsm[spatial_key], np.float32)[:, :2]
    n = len(coords)
    gene_names = _resolve_genes(adata, genes)

    if bands is None:
        from ..ops.graph import build_graph as _bg

        g6 = _bg(coords, n_neighbors=6)
        mean_nn = float(np.asarray(
            jnp.where(g6.valid, g6.distances, 0.0)).sum()
            / max(float(np.asarray(g6.valid).sum()), 1.0))
        hi = 3.0 * mean_nn
        bands = np.linspace(0.0, hi, n_bands + 1)
    bands = np.asarray(bands, np.float64)
    if bands.ndim != 1 or len(bands) < 2 or np.any(np.diff(bands) <= 0):
        raise ValueError("bands must be increasing edges of length >= 2")

    logger.info(f"Moran correlogram: {n:,} cells × {len(gene_names)} genes, "
                f"{len(bands) - 1} bands up to {bands[-1]:.1f}")

    idx, dist, valid = radius_neighbors(
        jnp.asarray(coords), float(bands[-1]), k_max)
    Xb = _dense_expression(adata, gene_names, layer)
    Z, zero_var = standardize(jnp.asarray(Xb))

    I_j, z_j, pn_j, ps_j, S0_j = correlogram_kernel(
        idx, dist, valid, Z, jnp.asarray(bands, jnp.float32),
        jnp.uint32(seed), n_permutations=n_permutations)
    I_np, z_np, p_np, ps_np, S0_np = (
        np.asarray(I_j), np.asarray(z_j), np.asarray(pn_j),
        np.asarray(ps_j), np.asarray(S0_j))
    zv_np = np.asarray(zero_var) if zero_var is not None else None

    rows = []
    for b in range(len(bands) - 1):
        lo, hi = float(bands[b]), float(bands[b + 1])
        if S0_np[b] <= 0:
            logger.warning(f"band [{lo:.1f}, {hi:.1f}) has no pairs; skipped")
            continue
        for gi, gname in enumerate(gene_names):
            row = {"band_lo": lo, "band_hi": hi, "gene": gname,
                   "I": float(I_np[b, gi]), "z_score": float(z_np[b, gi]),
                   "p_value": float(p_np[b, gi])}
            if n_permutations > 0:
                row["p_sim"] = float(ps_np[b, gi])
            if zv_np is not None and bool(zv_np[gi]):
                row.update(I=0.0, z_score=0.0, p_value=1.0)
            rows.append(row)

    df = pd.DataFrame(rows)
    adata.uns[key_added] = df
    elapsed = time.time() - start
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names, "bands": [float(x) for x in bands],
        "k_max": k_max, "n_permutations": n_permutations, "seed": seed,
        "computation_time_seconds": elapsed,
    }
    update_metadata(
        adata, "moran_correlogram",
        parameters={"n_genes": len(gene_names), "n_bands": len(bands) - 1,
                    "k_max": k_max, "n_permutations": n_permutations,
                    "seed": seed},
        outputs={"uns": key_added, "uns_params": f"{key_added}_params"})
    logger.info(f"Moran correlogram completed in {elapsed:.1f}s")
    return adata
