"""Cell-type annotation with trained models (single or ensemble).

Parity with ``annotate_celltypist``
(/root/reference/src/spatialcore/annotation/annotate.py:253-708): model
loading, the 25% gene-overlap gate (:155-187), subset-and-renormalize
(:461-514), optional cell batching, multi-model max-confidence ensembling
(:596-621), and the CellxGene-standard output columns + decision-score
matrix. Models here are spatialcore_tpu ``CellTypeModel`` artifacts (JAX LR)
rather than CellTypist pickles; scoring runs jit-compiled on device.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import pandas as pd
import scipy.sparse as sp

from ..core.compat import param_aliases
from ..core.logging import get_logger
from ..core.metadata import update_metadata
from .confidence import ConfidenceMethod, transform_confidence
from .model import CellTypeModel

logger = get_logger("annotation.annotate")

DEFAULT_MODELS_DIR = Path.home() / ".spatialcore_tpu" / "models"

# Tissue → suggested model artifact names (train locally or drop into
# DEFAULT_MODELS_DIR; parity with the reference's pretrained-model presets,
# annotate.py:40-123, minus the network download).
TISSUE_MODEL_PRESETS: Dict[str, List[str]] = {
    "lung": ["lung_airway", "lung_parenchyma", "immune_global"],
    "liver": ["liver", "immune_global"],
    "brain": ["brain_cortex", "brain_glia"],
    "heart": ["heart", "immune_global"],
    "kidney": ["kidney", "immune_global"],
    "breast": ["breast", "immune_global"],
    "colon": ["intestine_colon", "immune_global"],
    "intestine": ["intestine_colon", "immune_global"],
    "pancreas": ["pancreas", "immune_global"],
    "skin": ["skin", "immune_global"],
    "blood": ["immune_blood", "immune_global"],
    "bone_marrow": ["immune_bone_marrow", "immune_global"],
    "lymph_node": ["immune_lymphoid", "immune_global"],
    "spleen": ["immune_lymphoid", "immune_global"],
    "tonsil": ["immune_lymphoid", "immune_global"],
}


def get_models_for_tissue(tissue: str) -> List[str]:
    """Suggested model names for a tissue preset."""
    key = tissue.strip().lower().replace(" ", "_")
    if key not in TISSUE_MODEL_PRESETS:
        raise ValueError(
            f"Unknown tissue '{tissue}'. Available: "
            f"{sorted(TISSUE_MODEL_PRESETS)}")
    return TISSUE_MODEL_PRESETS[key]


def _resolve_model(m, models_dir: Path) -> CellTypeModel:
    if isinstance(m, CellTypeModel):
        return m
    from .registry import resolve_model

    return resolve_model(m, models_dir=models_dir)


def _gene_overlap(model: CellTypeModel, var_names) -> np.ndarray:
    """int32 [n_model_genes] index into var_names (−1 where absent)."""
    pos = {g: i for i, g in enumerate(var_names)}
    return np.array([pos.get(g, -1) for g in model.genes], np.int32)


def annotate_cells(
    adata,
    models: Union[str, CellTypeModel, Sequence],
    confidence_method: ConfidenceMethod = "zscore",
    min_gene_overlap_pct: float = 25.0,
    batch_size: Optional[int] = None,
    renormalize_overlap: bool = True,
    models_dir: Optional[Union[str, Path]] = None,
    store_decision_scores: bool = True,
    over_clustering: Optional[str] = None,
    copy: bool = False,
):
    """Annotate cells with one model or an ensemble (max confidence wins).

    Outputs: ``obs['cell_type']`` (final label), ``'cell_type_predicted'``,
    ``'cell_type_confidence'`` (transformed), ``'cell_type_confidence_raw'``
    (winning logit), ``'cell_type_model'`` (source model per cell), and
    ``obsm['cell_type_decision_scores']`` (+ class list in uns) for the
    model that won the most cells.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    models_dir = Path(models_dir) if models_dir else DEFAULT_MODELS_DIR
    if isinstance(models, (str, Path, CellTypeModel)):
        models = [models]
    resolved = [_resolve_model(m, models_dir) for m in models]
    if not resolved:
        raise ValueError("At least one model is required")

    X = adata.X
    var_names = list(adata.var_names)
    n = adata.n_obs
    batch = batch_size or n

    per_model = []
    for model in resolved:
        name = model.metadata.get("model_name", "model")
        gene_idx = _gene_overlap(model, var_names)
        n_overlap = int((gene_idx >= 0).sum())
        overlap_pct = 100.0 * n_overlap / model.n_genes
        if overlap_pct < min_gene_overlap_pct:
            raise ValueError(
                f"Model '{name}': only {n_overlap}/{model.n_genes} genes "
                f"({overlap_pct:.1f}%) overlap the panel — below the "
                f"{min_gene_overlap_pct}% gate. Train a panel-specific "
                "model (train_and_annotate) instead.")
        logger.info(f"Model '{name}': {n_overlap}/{model.n_genes} genes "
                    f"({overlap_pct:.1f}% overlap), {model.n_classes} types")

        scores = np.empty((n, model.n_classes), np.float32)
        present = gene_idx >= 0
        cols = gene_idx[present]
        for s in range(0, n, batch):
            xb = X[s:s + batch][:, cols]
            if sp.issparse(xb):
                xb = np.asarray(xb.todense())
            xb = np.asarray(xb, np.float32)
            if renormalize_overlap:
                counts = np.expm1(xb)
                tot = counts.sum(axis=1, keepdims=True)
                tot = np.where(tot <= 0, 1.0, tot)
                xb = np.log1p(counts / tot * 1e4)
            full = np.broadcast_to(
                model.scaler_mean[None, :], (xb.shape[0], model.n_genes)
            ).copy()
            full[:, present] = xb
            scores[s:s + batch] = model.decision_scores(full)
        conf = transform_confidence(scores, confidence_method)
        raw = scores.max(axis=1)
        pred = np.asarray(model.classes, object)[scores.argmax(axis=1)]
        per_model.append({
            "name": name, "model": model, "scores": scores,
            "conf": conf, "raw": raw, "pred": pred,
            "overlap_pct": overlap_pct,
        })

    # ensemble: max transformed confidence wins per cell
    conf_stack = np.stack([m["conf"] for m in per_model])     # [M, N]
    winner = conf_stack.argmax(axis=0)
    final_pred = np.empty(n, object)
    final_conf = np.empty(n, float)
    final_raw = np.empty(n, float)
    final_model = np.empty(n, object)
    for mi, m in enumerate(per_model):
        rows = winner == mi
        final_pred[rows] = m["pred"][rows]
        final_conf[rows] = m["conf"][rows]
        final_raw[rows] = m["raw"][rows]
        final_model[rows] = m["name"]

    adata.obs["cell_type_predicted"] = pd.Categorical(final_pred)
    final_label = final_pred
    if over_clustering is not None:
        # majority vote within precomputed clusters (the reference's
        # cluster-mode annotation, annotate.py:521) — smooths per-cell noise
        if over_clustering not in adata.obs.columns:
            raise ValueError(
                f"over_clustering column '{over_clustering}' not in obs")
        clusters = adata.obs[over_clustering].astype(str).to_numpy()
        final_label = final_pred.copy()
        for cl in pd.unique(clusters):
            rows = clusters == cl
            vals, cnts = np.unique(final_pred[rows].astype(str),
                                   return_counts=True)
            final_label[rows] = vals[cnts.argmax()]
        logger.info(f"Majority voting over '{over_clustering}' "
                    f"({len(pd.unique(clusters))} clusters)")
    adata.obs["cell_type"] = pd.Categorical(final_label)
    adata.obs["cell_type_confidence"] = final_conf
    adata.obs["cell_type_confidence_raw"] = final_raw
    adata.obs["cell_type_model"] = pd.Categorical(final_model)

    if store_decision_scores:
        # scores of the model that won the most cells
        best_mi = int(np.bincount(winner, minlength=len(per_model)).argmax())
        best = per_model[best_mi]
        adata.obsm["cell_type_decision_scores"] = best["scores"]
        adata.uns["cell_type_decision_scores_classes"] = \
            list(best["model"].classes)

    n_types = len(pd.unique(final_pred))
    logger.info(f"Annotated {n:,} cells → {n_types} types using "
                f"{len(per_model)} model(s) ({time.time() - start:.1f}s)")
    update_metadata(
        adata, "annotate_cells",
        parameters={"models": [m["name"] for m in per_model],
                    "confidence_method": confidence_method,
                    "min_gene_overlap_pct": min_gene_overlap_pct,
                    "gene_overlap_pct": [round(m["overlap_pct"], 2)
                                         for m in per_model]},
        outputs={"obs": ["cell_type", "cell_type_confidence",
                         "cell_type_model"],
                 "obsm": "cell_type_decision_scores"})
    return adata


@param_aliases(confidence_method="confidence_transform",
               models="custom_model_path")
def annotate_celltypist(
    adata,
    tissue: str = "unknown",
    ensemble_mode: bool = True,
    custom_model_path=None,
    majority_voting: bool = False,
    over_clustering: Optional[str] = None,
    min_prop: float = 0.0,
    min_gene_overlap_pct: float = 25.0,
    min_confidence: float = 0.5,
    store_decision_scores: bool = True,
    confidence_transform: ConfidenceMethod = "zscore",
    batch_size: Optional[int] = None,
    renormalize_overlap: bool = True,
    models_dir: Optional[Union[str, Path]] = None,
    copy: bool = False,
):
    """Reference-signature annotation front-end (ref annotate.py:253-708).

    Resolves models from ``custom_model_path`` (one model, a list for an
    ensemble, or a ``CellTypeModel``) or from the ``tissue`` preset table;
    ``ensemble_mode=False`` keeps only the first resolved model. Runs
    ``annotate_cells`` (max-confidence ensembling, overlap gate,
    subset-and-renormalize), then optional majority voting over
    ``over_clustering`` — a vote below ``min_prop`` of its cluster keeps
    the per-cell label, the reference's heterogeneity guard — and finally
    marks cells below ``min_confidence`` Unassigned.
    """
    from .confidence import filter_low_confidence

    if custom_model_path is not None:
        models = (list(custom_model_path)
                  if isinstance(custom_model_path, (list, tuple))
                  else [custom_model_path])
    else:
        models = get_models_for_tissue(tissue)
    if not ensemble_mode:
        models = models[:1]

    if majority_voting and over_clustering is None:
        raise ValueError(
            "majority_voting=True needs over_clustering (a precomputed "
            "cluster column in obs); on-the-fly over-clustering is a "
            "scanpy-side feature this build does not bundle")
    adata = annotate_cells(
        adata, models, confidence_method=confidence_transform,
        min_gene_overlap_pct=min_gene_overlap_pct, batch_size=batch_size,
        renormalize_overlap=renormalize_overlap, models_dir=models_dir,
        store_decision_scores=store_decision_scores,
        over_clustering=None, copy=copy)

    if majority_voting:
        clusters = adata.obs[over_clustering].astype(str).to_numpy()
        pred = adata.obs["cell_type_predicted"].astype(str).to_numpy()
        final = pred.copy()
        for cl in pd.unique(clusters):
            rows = clusters == cl
            vals, cnts = np.unique(pred[rows], return_counts=True)
            win = cnts.argmax()
            if cnts[win] / rows.sum() >= min_prop:
                final[rows] = vals[win]
        adata.obs["cell_type"] = pd.Categorical(final)
        logger.info(f"Majority voting over '{over_clustering}' "
                    f"(min_prop={min_prop})")

    if min_confidence and min_confidence > 0:
        adata = filter_low_confidence(adata, threshold=min_confidence)
    return adata


@param_aliases(adata="query_genes")
def get_model_gene_overlap(model_path, query_genes) -> dict:
    """Overlap stats between a model's genes and the query panel.

    ``model_path`` is a saved artifact path or a ``CellTypeModel``;
    ``query_genes`` a gene list or an AnnData (its var_names are used).
    Returns the reference's keys (training.py:732-785): n_model_genes,
    n_query_genes, n_overlap, overlap_pct, overlapping_genes,
    missing_genes.
    """
    model = (model_path if isinstance(model_path, CellTypeModel)
             else CellTypeModel.load(model_path))
    if hasattr(query_genes, "var_names"):
        query_genes = list(query_genes.var_names)
    gene_idx = _gene_overlap(model, list(query_genes))
    present = gene_idx >= 0
    n = int(present.sum())
    return {"n_model_genes": model.n_genes,
            "n_query_genes": len(query_genes),
            "n_overlap": n,
            "overlap_pct": round(100.0 * n / model.n_genes, 2),
            "overlapping_genes": [g for g, p in zip(model.genes, present)
                                  if p],
            "missing_genes": [g for g, p in zip(model.genes, present)
                              if not p]}


def get_annotation_summary(adata) -> dict:
    """Post-annotation summary: per-type counts + pipeline provenance."""
    out = dict(adata.uns.get("spatialcore_annotation", {}))
    if "cell_type" in adata.obs.columns:
        out["type_counts"] = (adata.obs["cell_type"].astype(str)
                              .value_counts().to_dict())
    if "cell_type_confidence" in adata.obs.columns:
        conf = adata.obs["cell_type_confidence"]
        out["median_confidence"] = float(conf.median())
    return out
