"""Neighborhood enrichment: cell-type adjacency z-scores on the graph.

Named in BASELINE.json's north star ("neighborhood-enrichment scores become
segment-sum/SpMV kernels over those W matrices"); the squidpy equivalent is
``gr.nhood_enrichment``. Edge type-pair counts are one-hot matmuls per
neighbor slot; the permutation null shuffles labels with
counter-based keys, one draw per ``lax.scan`` step (labels are [N] int32, so
thousands of draws are cheap).
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.logging import get_logger
from ..core.metadata import update_metadata
from ..core.rng import key_for

logger = get_logger("spatial.nhood")


@functools.partial(jax.jit, static_argnames=("n_types", "n_permutations"))
def _nhood_counts_and_null(neighbor_idx, valid, codes, n_types: int,
                           seed: int, n_permutations: int):
    n, k = neighbor_idx.shape

    def pair_counts(codes_):
        oh = jax.nn.one_hot(codes_, n_types, dtype=jnp.float32)   # [N, T]
        counts = jnp.zeros((n_types, n_types), jnp.float32)
        for j in range(k):
            nb = codes_[neighbor_idx[:, j]]
            oh_nb = jax.nn.one_hot(nb, n_types, dtype=jnp.float32)
            oh_nb = jnp.where(valid[:, j:j + 1], oh_nb, 0.0)
            counts = counts + oh.T @ oh_nb                         # matmul
        return counts

    observed = pair_counts(codes)
    if n_permutations == 0:
        z = jnp.zeros_like(observed)
        return observed, z, observed, jnp.zeros_like(observed)

    base = key_for(seed, "nhood_perm", 0)

    def body(carry, p):
        s1, s2 = carry
        perm = jax.random.permutation(jax.random.fold_in(base, p), n)
        c = pair_counts(codes[perm])
        return (s1 + c, s2 + c * c), None

    (s1, s2), _ = jax.lax.scan(
        body, (jnp.zeros_like(observed), jnp.zeros_like(observed)),
        jnp.arange(n_permutations))
    mean = s1 / n_permutations
    std = jnp.sqrt(jnp.maximum(s2 / n_permutations - mean ** 2, 1e-12))
    z = (observed - mean) / std
    return observed, z, mean, std


def neighborhood_enrichment(
    adata,
    cluster_key: str,
    n_permutations: int = 1000,
    seed: int = 0,
    n_neighbors: int = 6,
    spatial_key: str = "spatial",
    key_added: Optional[str] = None,
    copy: bool = False,
):
    """Type-pair adjacency enrichment over the spatial graph.

    ``uns[key_added]`` gets ``zscore`` / ``count`` / ``null_mean`` /
    ``null_std`` [T, T] arrays and the type order. Positive z = the two
    types neighbor each other more often than the random-labeling null.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if cluster_key not in adata.obs.columns:
        raise ValueError(f"adata.obs['{cluster_key}'] not found")
    from .autocorrelation import _get_graph

    graph = _get_graph(adata, n_neighbors, spatial_key,
                       use_existing_graph=True)
    labels = adata.obs[cluster_key]
    if labels.isna().any():
        raise ValueError(
            f"adata.obs['{cluster_key}'] contains null labels; drop or "
            "fill them first.")
    labels = labels.astype(str)
    types = sorted(labels.unique())
    if len(types) < 2:
        raise ValueError("neighborhood_enrichment needs ≥2 types")
    codes = jnp.asarray(
        labels.map({t: i for i, t in enumerate(types)}).to_numpy(np.int32))

    obs, z, mean, std = _nhood_counts_and_null(
        graph.neighbor_idx, graph.valid, codes, len(types), seed,
        n_permutations)

    key_added = key_added or f"{cluster_key}_nhood_enrichment"
    adata.uns[key_added] = {
        "zscore": np.asarray(z),
        "count": np.asarray(obs),
        "null_mean": np.asarray(mean),
        "null_std": np.asarray(std),
        "types": types,
        "n_permutations": n_permutations,
        "seed": seed,
    }
    logger.info(f"neighborhood_enrichment: {len(types)} types, "
                f"{n_permutations} permutations "
                f"({time.time() - start:.1f}s)")
    update_metadata(adata, "neighborhood_enrichment",
                    parameters={"cluster_key": cluster_key,
                                "n_permutations": n_permutations,
                                "seed": seed},
                    outputs={"uns": key_added})
    return adata
