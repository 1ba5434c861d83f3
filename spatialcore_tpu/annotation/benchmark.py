"""Annotation quality benchmark — the reference's seven metrics as code.

The reference's celltyping benchmark (``/root/reference/docs/celltyping/
benchmarks.md`` "Results") scores an annotation on seven metrics — gene
overlap, unassigned rate, marker CV, marker log2FC, DEG log2FC, marker
purity, contamination — but ships only the finished table; the metric
code lives in private notebooks. Here the metrics are first-class,
tested functions, so the full method-vs-method comparison is one call
(`compare_annotation_methods`) and the real-data benchmark is one
command the moment a dataset is on disk.

Exact definitions used here (documented because the reference publishes
none):

- **gene overlap** — ``|model genes ∩ panel| / |model genes|``.
- **unassigned rate** — fraction of cells labelled ``Unassigned`` or, if
  a confidence column is given, with confidence below the threshold.
- **marker CV** (lower better) — within each predicted type, the
  coefficient of variation ``std/mean`` of each of that type's canonical
  panel markers, averaged over markers, then averaged over types.
- **marker log2FC** (higher better) — ``log2((mean_in+eps)/(mean_rest+
  eps))`` per canonical marker of the type, averaged as above.
- **DEG log2FC** (higher better) — mean log2 fold change of the top
  ``n_top_degs`` Wilcoxon DEGs per type (`stats.deg.rank_genes_groups`,
  scanpy convention), averaged over types.
- **marker purity** (higher better) — share of a type's cells that
  express (count > 0) at least ``purity_fraction`` of the type's panel
  markers.
- **contamination** (lower better) — how strongly a type expresses
  *other* types' markers, relative to the owning type itself:
  ``mean_{u≠t} [ mean-expr of u's markers in t / mean-expr of u's
  markers in u ]`` (0 = perfectly clean boundaries; shared lineage
  markers push it up, matching the reference's T-cell-collapsing note).

All group reductions run on device as one-hot matmuls ([T,N]@[N,G] —
dense matmuls), not per-type Python loops; only the final [T]-sized
summaries come back to host.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np
import pandas as pd
import scipy.sparse as sp

from ..core.logging import get_logger
from ..core.metadata import update_metadata
from .confidence import UNASSIGNED
from .markers import load_canonical_markers

logger = get_logger(__name__)

_EPS = 1e-9
_CHUNK_BYTES = 512e6  # dense f32 block budget for chunked accumulation

SUMMARY_METRICS = [
    "gene_overlap",
    "unassigned_rate",
    "marker_cv",
    "marker_log2fc",
    "deg_log2fc",
    "marker_purity",
    "contamination",
]


def gene_overlap(model_genes: Sequence[str],
                 panel_genes: Sequence[str]) -> float:
    """Fraction of a model's feature genes present in the panel.

    The reference's headline 7.1%-vs-100% metric (benchmarks.md "Gene
    Overlap"): a pre-trained model carries genes the spatial panel
    lacks; a panel-trained model overlaps by construction.
    """
    model = list(dict.fromkeys(str(g) for g in model_genes))
    if not model:
        raise ValueError("model_genes is empty")
    panel = {str(g) for g in panel_genes}
    return sum(g in panel for g in model) / len(model)


def unassigned_rate(
    adata,
    cell_type_column: str = "cell_type",
    unassigned_label: str = UNASSIGNED,
    confidence_column: Optional[str] = None,
    confidence_threshold: Optional[float] = None,
) -> float:
    """Fraction of cells unassigned (by label, or below confidence)."""
    if cell_type_column not in adata.obs.columns:
        raise ValueError(f"Column '{cell_type_column}' not found in obs")
    labels = adata.obs[cell_type_column].astype(str).to_numpy()
    un = labels == str(unassigned_label)
    if confidence_column is not None:
        if confidence_column not in adata.obs.columns:
            raise ValueError(
                f"Column '{confidence_column}' not found in obs")
        thr = 0.5 if confidence_threshold is None else confidence_threshold
        conf = adata.obs[confidence_column].to_numpy(float)
        un = un | (conf < thr)
    return float(un.mean())


def _dense_f32(X) -> np.ndarray:
    if sp.issparse(X):
        X = np.asarray(X.todense())
    return np.asarray(X, np.float32)


def _marker_matrix(types: List[str], var_names: pd.Index,
                   markers: Dict[str, Sequence[str]]) -> np.ndarray:
    """[T, G] 0/1 — panel markers of each type (case-insensitive)."""
    gpos = {str(g).upper(): i for i, g in enumerate(var_names)}
    M = np.zeros((len(types), len(var_names)), np.float32)
    low = {k.lower(): v for k, v in markers.items()}
    for t, name in enumerate(types):
        for g in low.get(name.lower(), markers.get(name, [])):
            j = gpos.get(str(g).upper())
            if j is not None:
                M[t, j] = 1.0
    return M


def marker_quality_metrics(
    adata,
    cell_type_column: str = "cell_type",
    markers: Optional[Dict[str, Sequence[str]]] = None,
    unassigned_label: str = UNASSIGNED,
    min_cells: int = 10,
    purity_fraction: float = 0.5,
) -> pd.DataFrame:
    """Per-type marker CV / log2FC / purity / contamination.

    Returns a DataFrame indexed by cell type with columns ``n_cells``,
    ``n_panel_markers``, ``marker_cv``, ``marker_log2fc``,
    ``marker_purity``, ``contamination``. Types without panel markers
    (or below ``min_cells``) carry NaN metrics and are excluded from
    summary averages downstream.
    """
    if cell_type_column not in adata.obs.columns:
        raise ValueError(f"Column '{cell_type_column}' not found in obs")
    if markers is None:
        markers = load_canonical_markers()

    labels = adata.obs[cell_type_column].astype(str).to_numpy()
    counts = pd.Series(labels).value_counts()
    types = sorted(t for t, c in counts.items()
                   if t != str(unassigned_label) and c >= min_cells)
    if not types:
        raise ValueError(
            f"No cell types with >= {min_cells} cells in "
            f"'{cell_type_column}' (excluding '{unassigned_label}')")

    tindex = {t: i for i, t in enumerate(types)}
    lab_idx = np.array([tindex.get(l, -1) for l in labels], np.int32)
    M_np = _marker_matrix(types, adata.var_names, markers)
    M = jnp.asarray(M_np)
    T = len(types)
    N, G = adata.X.shape

    # Chunked device accumulation: only one dense [chunk, G] block is
    # ever materialized/shipped (≈_CHUNK_BYTES of f32), so sparse
    # full-scale inputs never densify whole and the executable compiles
    # once (the tail chunk is zero-padded; padded rows have all-zero
    # one-hot and contribute nothing to any accumulator).
    chunk = min(N, max(256, int(_CHUNK_BYTES / (4 * max(G, 1)))))
    import jax

    @jax.jit
    def _accumulate(carry, Xc, ohc, own_rows_c):
        sums, sq, total, pure = carry
        sums = sums + ohc.T @ Xc
        sq = sq + ohc.T @ (Xc * Xc)
        total = total + Xc.sum(axis=0)
        expressed = (Xc > 0).astype(jnp.float32)
        frac = (expressed * own_rows_c).sum(axis=1) / jnp.maximum(
            own_rows_c.sum(axis=1), 1.0)
        pure = pure + ohc.T @ (frac >= purity_fraction).astype(jnp.float32)
        return sums, sq, total, pure

    carry = (jnp.zeros((T, G)), jnp.zeros((T, G)), jnp.zeros((G,)),
             jnp.zeros((T,)))
    eye_T = np.eye(T, dtype=np.float32)
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        Xc = _dense_f32(adata.X[s:e])
        oh_c = np.where(lab_idx[s:e, None] >= 0,
                        eye_T[np.maximum(lab_idx[s:e], 0)], 0.0)
        own_c = M_np[np.maximum(lab_idx[s:e], 0)]
        if e - s < chunk:  # zero-pad the tail to keep one executable
            pad = chunk - (e - s)
            Xc = np.pad(Xc, ((0, pad), (0, 0)))
            oh_c = np.pad(oh_c, ((0, pad), (0, 0)))
            own_c = np.pad(own_c, ((0, pad), (0, 0)))
        carry = _accumulate(carry, jnp.asarray(Xc), jnp.asarray(oh_c),
                            jnp.asarray(own_c))
    sums, sq, total_sum, pure_counts = carry

    n_t_np = np.array([counts[t] for t in types], np.float32)
    n_t = jnp.maximum(jnp.asarray(n_t_np), 1.0)              # [T]
    mean_t = sums / n_t[:, None]
    var_t = jnp.maximum(sq / n_t[:, None] - mean_t ** 2, 0.0)
    std_t = jnp.sqrt(var_t)

    n_all = float(N)
    # mean over the REST (all cells not of type t, incl. unassigned)
    mean_rest = (total_sum[None, :] - sums) / jnp.maximum(
        n_all - n_t[:, None], 1.0)

    n_mark = jnp.maximum(M.sum(axis=1), 1.0)                # [T]
    own = M  # [T, G] own-marker mask
    # CV over own markers where the in-type mean is nonzero; a type
    # expressing NONE of its markers gets NaN (not a perfect 0 — see
    # test_markerless_and_unexpressed_edge_cases)
    valid = own * (mean_t > _EPS)
    cv_per = jnp.where(valid > 0, std_t / jnp.maximum(mean_t, _EPS), 0.0)
    n_valid = valid.sum(axis=1)
    marker_cv = jnp.where(n_valid > 0,
                          cv_per.sum(axis=1) / jnp.maximum(n_valid, 1.0),
                          jnp.nan)

    lfc_per = own * jnp.log2((mean_t + _EPS) / (mean_rest + _EPS))
    marker_log2fc = lfc_per.sum(axis=1) / n_mark

    purity = pure_counts / n_t

    # contamination: R[t, u] = mean expr of u's markers in t, compared
    # to u's own expression of them; averaged ONLY over other types
    # that actually have panel markers (a markerless type would dilute
    # the ratio toward 0 and skew cross-method comparisons)
    Mn = M / n_mark[:, None]                                # [T, G]
    R = mean_t @ Mn.T                                       # [T, U]
    self_sig = jnp.maximum(jnp.diagonal(R), _EPS)           # [U]
    ratio = R / self_sig[None, :]
    has_mark_u = (M.sum(axis=1) > 0).astype(jnp.float32)    # [U]
    off = (1.0 - jnp.eye(T)) * has_mark_u[None, :]
    n_off = off.sum(axis=1)
    contamination = jnp.where(
        n_off > 0, (ratio * off).sum(axis=1) / jnp.maximum(n_off, 1.0),
        jnp.nan)

    has_m = np.asarray(M.sum(axis=1)) > 0
    df = pd.DataFrame(
        {
            "n_cells": [int(counts[t]) for t in types],
            "n_panel_markers": np.asarray(M.sum(axis=1), int),
            "marker_cv": np.where(has_m, np.asarray(marker_cv), np.nan),
            "marker_log2fc": np.where(
                has_m, np.asarray(marker_log2fc), np.nan),
            "marker_purity": np.where(has_m, np.asarray(purity), np.nan),
            "contamination": np.where(
                has_m, np.asarray(contamination), np.nan),
        },
        index=pd.Index(types, name=cell_type_column),
    )
    if not has_m.any():
        logger.warning(
            "marker_quality_metrics: no panel markers found for any of "
            f"{len(types)} types — check marker dict / var_names")
    return df


def deg_log2fc(
    adata,
    cell_type_column: str = "cell_type",
    n_top_degs: int = 10,
    unassigned_label: str = UNASSIGNED,
    min_cells: int = 10,
) -> pd.Series:
    """Mean log2FC of each type's top Wilcoxon DEGs (effect size)."""
    from ..stats.deg import rank_genes_groups

    labels = adata.obs[cell_type_column].astype(str)
    counts = labels.value_counts()
    groups = sorted(t for t, c in counts.items()
                    if t != str(unassigned_label) and c >= min_cells)
    if len(groups) < 2:
        raise ValueError("DEG effect size needs >= 2 assigned types")
    sub = adata[np.flatnonzero(labels.isin(groups).to_numpy())]
    res = rank_genes_groups(sub, cell_type_column, groups=groups,
                            n_genes=n_top_degs, min_cells=min_cells,
                            copy=True)
    rg = res.uns["rank_genes_groups"]
    out = {g: float(np.mean(rg["logfoldchanges"][g]))
           for g in groups if g in rg["logfoldchanges"]}
    return pd.Series(out, name="deg_log2fc")


def benchmark_annotation(
    adata,
    cell_type_column: str = "cell_type",
    markers: Optional[Dict[str, Sequence[str]]] = None,
    model_genes: Optional[Sequence[str]] = None,
    confidence_column: Optional[str] = None,
    confidence_threshold: float = 0.8,
    n_top_degs: int = 10,
    unassigned_label: str = UNASSIGNED,
    min_cells: int = 10,
    purity_fraction: float = 0.5,
    key_added: str = "annotation_benchmark",
    store: bool = True,
) -> pd.Series:
    """All seven reference benchmark metrics for one annotation column.

    Returns a Series over ``SUMMARY_METRICS`` (gene_overlap NaN when no
    ``model_genes`` given); the per-type table lands in
    ``uns[key_added]`` alongside the parameters. ``store=False`` skips
    the ``uns`` write and the provenance ledger entry, leaving ``adata``
    untouched (the side-effect-free escape hatch for shared objects).
    """
    start = time.time()
    per_type = marker_quality_metrics(
        adata, cell_type_column, markers=markers,
        unassigned_label=unassigned_label, min_cells=min_cells,
        purity_fraction=purity_fraction)
    try:
        degs = deg_log2fc(adata, cell_type_column, n_top_degs=n_top_degs,
                          unassigned_label=unassigned_label,
                          min_cells=min_cells)
        per_type = per_type.join(degs)
    except ValueError as e:
        logger.warning(f"benchmark_annotation: DEG step skipped ({e})")
        per_type["deg_log2fc"] = np.nan

    summary = pd.Series(
        {
            "gene_overlap": (gene_overlap(model_genes, adata.var_names)
                             if model_genes is not None else np.nan),
            "unassigned_rate": unassigned_rate(
                adata, cell_type_column,
                unassigned_label=unassigned_label,
                confidence_column=confidence_column,
                confidence_threshold=(confidence_threshold
                                      if confidence_column else None)),
            "marker_cv": float(per_type["marker_cv"].mean()),
            "marker_log2fc": float(per_type["marker_log2fc"].mean()),
            "deg_log2fc": float(per_type["deg_log2fc"].mean()),
            "marker_purity": float(per_type["marker_purity"].mean()),
            "contamination": float(per_type["contamination"].mean()),
        },
        name=cell_type_column,
    )[SUMMARY_METRICS]

    params = {
        "cell_type_column": cell_type_column,
        "confidence_column": confidence_column,
        "confidence_threshold": confidence_threshold,
        "n_top_degs": n_top_degs,
        "purity_fraction": purity_fraction,
        "min_cells": min_cells,
    }
    if store:
        adata.uns[key_added] = {
            "summary": {k: float(v) for k, v in summary.items()},
            "per_type": per_type.reset_index().to_dict(orient="list"),
            "params": params,
        }
        update_metadata(
            adata, "benchmark_annotation",
            parameters=params,
            outputs={"uns": key_added})
    logger.info(
        f"benchmark_annotation[{cell_type_column}]: "
        + ", ".join(f"{k}={v:.3f}" for k, v in summary.items()
                    if np.isfinite(v))
        + f" ({time.time() - start:.1f}s)")
    return summary


def compare_annotation_methods(
    adata,
    cell_type_columns: Sequence[str],
    method_names: Optional[Sequence[str]] = None,
    confidence_columns: Optional[Sequence[Optional[str]]] = None,
    model_genes_per_method: Optional[Sequence[Optional[Sequence[str]]]] = None,
    **kwargs,
) -> pd.DataFrame:
    """The reference's Results table: metrics × methods.

    ``cell_type_columns`` are obs columns holding competing annotations
    (e.g. a pre-trained model's output vs the panel-trained pipeline's);
    returns a DataFrame with one column per method, rows =
    ``SUMMARY_METRICS`` — the same shape the reference publishes
    (benchmarks.md "Results"). For a grouped-bar figure feed
    ``table.T.rename_axis("method").reset_index()`` to
    `plotting.plot_method_comparison`.
    """
    if len(cell_type_columns) < 2:
        raise ValueError("Need >= 2 annotation columns to compare")
    if "key_added" in kwargs:
        raise ValueError(
            "key_added is derived per method as "
            "'annotation_benchmark_<column>'; it cannot be overridden here")
    if "model_genes" in kwargs:
        raise ValueError(
            "pass model_genes_per_method (one entry per column) instead "
            "of model_genes")
    names = list(method_names or cell_type_columns)
    if len(names) != len(cell_type_columns):
        raise ValueError("method_names length mismatch")
    confs = list(confidence_columns or [None] * len(cell_type_columns))
    if len(confs) != len(cell_type_columns):
        raise ValueError(
            f"confidence_columns has {len(confs)} entries for "
            f"{len(cell_type_columns)} annotation columns — pass one per "
            "column (None where a method has no confidence)")
    mgenes = list(model_genes_per_method
                  or [None] * len(cell_type_columns))
    if len(mgenes) != len(cell_type_columns):
        raise ValueError(
            "model_genes_per_method length must match cell_type_columns")
    cols = {}
    for name, col, conf, mg in zip(names, cell_type_columns, confs,
                                   mgenes):
        cols[name] = benchmark_annotation(
            adata, col, confidence_column=conf, model_genes=mg,
            key_added=f"annotation_benchmark_{col}", **kwargs)
    table = pd.DataFrame(cols)
    table.index.name = "metric"
    return table
