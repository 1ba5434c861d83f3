"""Non-negative matrix factorization on device (multiplicative updates).

The reference advertises a ``spatialcore.nmf`` module that does not exist
("Coming soon", /root/reference/src/spatialcore/__init__.py:58-68 and
docs/index.md). This is a real implementation: Lee-Seung multiplicative
updates, all matmuls on device inside one ``lax.while_loop``, deterministic
counter-based init, Frobenius-loss early stopping.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from .core.logging import get_logger
from .core.metadata import update_metadata
from .core.rng import key_for

logger = get_logger("nmf")

_EPS = 1e-9


class NMFResult(NamedTuple):
    W: jax.Array           # [N, k] cell loadings
    H: jax.Array           # [k, G] gene programs
    loss: jax.Array        # final relative Frobenius loss
    n_iter: jax.Array


@functools.partial(jax.jit, static_argnames=("n_components", "max_iter"))
def nmf_fit(
    X: jax.Array,
    n_components: int,
    seed: int = 0,
    max_iter: int = 200,
    tol: float = 1e-4,
) -> NMFResult:
    """Factor non-negative X [N, G] ≈ W @ H with multiplicative updates."""
    X = jnp.asarray(X, jnp.float32)
    n, g = X.shape
    kw, kh = jax.random.split(key_for(seed, "nmf"))
    scale = jnp.sqrt(jnp.mean(X) / n_components + _EPS)
    W0 = jax.random.uniform(kw, (n, n_components), jnp.float32) * scale
    H0 = jax.random.uniform(kh, (n_components, g), jnp.float32) * scale
    x_norm = jnp.linalg.norm(X)

    def loss_of(W, H):
        return jnp.linalg.norm(X - W @ H) / jnp.maximum(x_norm, _EPS)

    def cond(state):
        _, _, prev, cur, it = state
        return (it < max_iter) & (prev - cur > tol * prev)

    def step(state):
        W, H, _, cur, it = state
        H = H * (W.T @ X) / (W.T @ W @ H + _EPS)
        W = W * (X @ H.T) / (W @ (H @ H.T) + _EPS)
        return W, H, cur, loss_of(W, H), it + 1

    state = (W0, H0, jnp.float32(jnp.inf), loss_of(W0, H0), jnp.int32(0))
    state = step(state)
    W, H, _, loss, n_iter = jax.lax.while_loop(cond, step, state)
    return NMFResult(W, H, loss, n_iter)


def run_nmf(
    adata,
    n_components: int = 10,
    layer: Optional[str] = None,
    max_iter: int = 200,
    tol: float = 1e-4,
    seed: int = 0,
    key_added: str = "nmf",
    copy: bool = False,
):
    """NMF gene programs: ``obsm['X_nmf']`` loadings, ``varm/uns`` programs.

    Requires non-negative input (use log1p-normalized or raw counts).
    Stores per-program top genes in ``uns[f"{key_added}_params"]``.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    X = adata.layers[layer] if layer else adata.X
    if sp.issparse(X):
        X = np.asarray(X.todense())
    X = np.asarray(X, np.float32)
    if (X < 0).any():
        raise ValueError("NMF requires non-negative input; X has negatives.")
    if n_components < 1 or n_components > min(X.shape):
        raise ValueError(
            f"n_components must be in [1, {min(X.shape)}], got {n_components}")

    res = nmf_fit(jnp.asarray(X), n_components, seed=seed,
                  max_iter=max_iter, tol=tol)
    W = np.asarray(res.W)
    H = np.asarray(res.H)
    adata.obsm[f"X_{key_added}"] = W
    adata.varm[f"{key_added}_components"] = H.T
    top_genes = {}
    var_names = np.asarray(adata.var_names, object)
    for c in range(n_components):
        order = np.argsort(-H[c])[:10]
        top_genes[f"program_{c + 1}"] = var_names[order].tolist()
    adata.uns[f"{key_added}_params"] = {
        "n_components": n_components,
        "final_relative_loss": float(res.loss),
        "n_iter": int(res.n_iter),
        "seed": seed,
        "top_genes": top_genes,
    }
    logger.info(f"NMF: {X.shape[0]:,}×{X.shape[1]} → {n_components} "
                f"programs, loss={float(res.loss):.4f} "
                f"({int(res.n_iter)} iters, {time.time() - start:.1f}s)")
    update_metadata(adata, "run_nmf",
                    parameters={"n_components": n_components, "seed": seed,
                                "max_iter": max_iter},
                    outputs={"obsm": f"X_{key_added}",
                             "uns": f"{key_added}_params"})
    return adata


__all__ = ["run_nmf", "nmf_fit", "NMFResult"]
