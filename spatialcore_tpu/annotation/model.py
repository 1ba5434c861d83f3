"""Cell-type classifier model: JAX multinomial logistic regression.

Device-native replacement for the CellTypist SGD classifier the reference
trains and loads (/root/reference/src/spatialcore/annotation/training.py:
556-729, annotate.py:532-570). The model is a plain parameter container —
genes, classes, per-gene scaler, weights — with jit-compiled batched scoring;
training lives in ``annotation.training``. Artifacts save as ``.npz`` +
sidecar JSON metadata (no pickle, loadable anywhere).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core.logging import get_logger

logger = get_logger("annotation.model")

_CLIP_Z = 10.0  # standardized-expression clip, stabilizes LR scores


@dataclass
class CellTypeModel:
    """Multinomial LR over standardized log1p expression."""

    genes: List[str]
    classes: List[str]
    W: np.ndarray                 # [G, C] float32
    b: np.ndarray                 # [C] float32
    scaler_mean: np.ndarray       # [G] float32
    scaler_std: np.ndarray        # [G] float32
    metadata: Dict = field(default_factory=dict)

    @property
    def n_genes(self) -> int:
        return len(self.genes)

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    # -- persistence ------------------------------------------------------

    def save(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        if path.suffix != ".npz":
            path = path.with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path, W=self.W.astype(np.float32), b=self.b.astype(np.float32),
            scaler_mean=self.scaler_mean.astype(np.float32),
            scaler_std=self.scaler_std.astype(np.float32),
            genes=np.array(self.genes, dtype=object),
            classes=np.array(self.classes, dtype=object))
        meta_path = path.with_suffix(".json")
        with open(meta_path, "w") as f:
            json.dump({"n_genes": self.n_genes, "n_classes": self.n_classes,
                       "classes": self.classes, **self.metadata}, f, indent=2)
        logger.info(f"Saved model → {path} ({self.n_genes} genes, "
                    f"{self.n_classes} classes)")
        return path

    @classmethod
    def load(cls, path: Union[str, Path]) -> "CellTypeModel":
        path = Path(path)
        if path.suffix != ".npz":
            path = path.with_suffix(".npz")
        with np.load(path, allow_pickle=True) as z:
            model = cls(
                genes=[str(g) for g in z["genes"]],
                classes=[str(c) for c in z["classes"]],
                W=z["W"], b=z["b"],
                scaler_mean=z["scaler_mean"], scaler_std=z["scaler_std"])
        meta_path = path.with_suffix(".json")
        if meta_path.exists():
            with open(meta_path) as f:
                model.metadata = json.load(f)
        return model

    # -- inference ----------------------------------------------------------

    def decision_scores(self, X, gene_idx: Optional[np.ndarray] = None,
                        batch_size: int = 65536) -> np.ndarray:
        """Logit scores [N, C] for log1p-normalized expression X [N, G'].

        ``gene_idx`` maps model genes into X's columns (−1 = absent, scored
        as the scaler mean, i.e. z = 0 — matching the behavior of scoring
        with only the overlapping panel genes).
        """
        W = jnp.asarray(self.W)
        b = jnp.asarray(self.b)
        mean = jnp.asarray(self.scaler_mean)
        std = jnp.asarray(self.scaler_std)
        n = X.shape[0]
        out = np.empty((n, self.n_classes), np.float32)
        for s in range(0, n, batch_size):
            xb = X[s:s + batch_size]
            if hasattr(xb, "todense"):
                xb = np.asarray(xb.todense())
            if isinstance(xb, jax.Array):
                # device-resident input stays on device (no host bounce
                # of a [65k, G] batch); absent-gene fill runs as jnp ops
                xb = xb.astype(jnp.float32)
                if gene_idx is not None:
                    cols = jnp.where(gene_idx >= 0, gene_idx, 0)
                    xb = jnp.where(jnp.asarray(gene_idx < 0)[None, :],
                                   mean[None, :], xb[:, cols])
            else:
                xb = np.asarray(xb, np.float32)
                if gene_idx is not None:
                    cols = np.where(gene_idx >= 0, gene_idx, 0)
                    xb = xb[:, cols]
                    xb[:, gene_idx < 0] = np.asarray(mean)[gene_idx < 0]
                xb = jnp.asarray(xb)
            out[s:s + batch_size] = np.asarray(
                _score_batch(xb, W, b, mean, std))
        return out

    def predict(self, X, gene_idx: Optional[np.ndarray] = None,
                batch_size: int = 65536):
        """(labels, decision_scores) for log1p expression."""
        scores = self.decision_scores(X, gene_idx, batch_size)
        idx = scores.argmax(axis=1)
        labels = np.asarray(self.classes, object)[idx]
        return labels, scores


@jax.jit
def _score_batch(xb, W, b, mean, std):
    z = (xb - mean[None, :]) / std[None, :]
    z = jnp.clip(z, -_CLIP_Z, _CLIP_Z)
    return z @ W + b
