"""JAX K-Means (k-means++ init, Lloyd iterations, mini-batch variant).

Replaces the reference's sklearn KMeans/MiniBatchKMeans
(/root/reference/src/spatialcore/spatial/neighborhoods.py:440-466) with a
jit-compiled, deterministic, mesh-shardable implementation. Exact label
equality with sklearn is not a goal (the reference itself only reaches
NMI≈0.77 across implementations, SURVEY.md §6); quality is validated by
inertia and NMI/ARI in tests.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.rng import key_for


class KMeansResult(NamedTuple):
    labels: jax.Array        # int32 [N]
    centroids: jax.Array     # f32 [k, D]
    inertia: jax.Array       # f32 scalar
    n_iter: jax.Array        # int32


def _pairwise_sq(X, C):
    # [N, k]; direct form keeps f32 accuracy for small D
    return jnp.sum((X[:, None, :] - C[None, :, :]) ** 2, axis=-1)


def _plusplus_init(key, X, k):
    """k-means++ seeding: first center uniform, rest ∝ squared distance."""
    n = X.shape[0]
    k0, key = jax.random.split(key)
    first = X[jax.random.randint(k0, (), 0, n)]
    centers = jnp.zeros((k, X.shape[1]), X.dtype).at[0].set(first)
    d2 = jnp.sum((X - first) ** 2, axis=-1)

    def body(i, carry):
        centers, d2, key = carry
        key, sub = jax.random.split(key)
        probs = d2 / jnp.maximum(jnp.sum(d2), 1e-30)
        idx = jax.random.choice(sub, n, p=probs)
        c = X[idx]
        centers = centers.at[i].set(c)
        d2 = jnp.minimum(d2, jnp.sum((X - c) ** 2, axis=-1))
        return centers, d2, key

    centers, _, _ = jax.lax.fori_loop(1, k, body, (centers, d2, key))
    return centers


def _lloyd(X, centers, max_iter, tol):
    n, d = X.shape
    k = centers.shape[0]

    def cond(state):
        _, shift, it, _ = state
        return (shift > tol) & (it < max_iter)

    def step(state):
        centers, _, it, _ = state
        dist = _pairwise_sq(X, centers)
        labels = jnp.argmin(dist, axis=1)
        onehot = jax.nn.one_hot(labels, k, dtype=X.dtype)        # [N, k]
        counts = jnp.sum(onehot, axis=0)                          # [k]
        sums = onehot.T @ X                                       # [k, D] matmul
        new_centers = jnp.where(counts[:, None] > 0,
                                sums / jnp.maximum(counts[:, None], 1.0),
                                centers)
        shift = jnp.sqrt(jnp.sum((new_centers - centers) ** 2))
        inertia = jnp.sum(jnp.min(dist, axis=1))
        return new_centers, shift, it + 1, inertia

    state = (centers, jnp.float32(jnp.inf), jnp.int32(0), jnp.float32(0))
    centers, _, n_iter, _ = jax.lax.while_loop(cond, step, state)
    dist = _pairwise_sq(X, centers)
    labels = jnp.argmin(dist, axis=1).astype(jnp.int32)
    inertia = jnp.sum(jnp.min(dist, axis=1))
    return labels, centers, inertia, n_iter


@functools.partial(jax.jit, static_argnames=("k", "n_init", "max_iter"))
def kmeans(
    X: jax.Array,
    k: int,
    seed: int = 0,
    n_init: int = 10,
    max_iter: int = 300,
    tol: float = 1e-6,
) -> KMeansResult:
    """Full-batch K-Means: best of ``n_init`` k-means++ restarts by inertia."""
    X = jnp.asarray(X, jnp.float32)

    def one(restart):
        key = key_for(seed, "kmeans", restart)
        centers0 = _plusplus_init(key, X, k)
        return _lloyd(X, centers0, max_iter, tol)

    labels, centers, inertia, n_iter = jax.lax.map(one, jnp.arange(n_init))
    best = jnp.argmin(inertia)
    return KMeansResult(labels[best], centers[best], inertia[best], n_iter[best])


@functools.partial(jax.jit,
                   static_argnames=("k", "batch_size", "n_steps", "n_init"))
def minibatch_kmeans(
    X: jax.Array,
    k: int,
    seed: int = 0,
    batch_size: int = 1024,
    n_steps: int = 100,
    n_init: int = 3,
) -> KMeansResult:
    """Mini-batch K-Means (Sculley 2010): per-center count learning rates."""
    X = jnp.asarray(X, jnp.float32)
    n = X.shape[0]

    def one(restart):
        key = key_for(seed, "mbkmeans", restart)
        init_key, key = jax.random.split(key)
        # k-means++ on a subsample for cheap good seeding
        sub = jax.random.choice(init_key, n, (min(n, 10 * batch_size),),
                                replace=False)
        centers = _plusplus_init(key, X[sub], k)
        counts = jnp.zeros((k,), jnp.float32)

        def step(carry, s):
            centers, counts = carry
            bkey = jax.random.fold_in(key, s)
            idx = jax.random.randint(bkey, (batch_size,), 0, n)
            B = X[idx]
            labels = jnp.argmin(_pairwise_sq(B, centers), axis=1)
            onehot = jax.nn.one_hot(labels, k, dtype=jnp.float32)
            bcounts = jnp.sum(onehot, axis=0)
            bsums = onehot.T @ B
            new_counts = counts + bcounts
            lr = bcounts / jnp.maximum(new_counts, 1.0)
            bmeans = bsums / jnp.maximum(bcounts[:, None], 1.0)
            centers = centers + lr[:, None] * jnp.where(
                bcounts[:, None] > 0, bmeans - centers, 0.0)
            return (centers, new_counts), None

        (centers, _), _ = jax.lax.scan(step, (centers, counts),
                                       jnp.arange(n_steps))
        dist = _pairwise_sq(X, centers)
        labels = jnp.argmin(dist, axis=1).astype(jnp.int32)
        inertia = jnp.sum(jnp.min(dist, axis=1))
        return labels, centers, inertia

    labels, centers, inertia = jax.lax.map(one, jnp.arange(n_init))
    best = jnp.argmin(inertia)
    return KMeansResult(labels[best], centers[best], inertia[best],
                        jnp.int32(n_steps))
