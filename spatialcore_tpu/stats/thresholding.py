"""Pure JAX threshold-detection kernels (no container dependencies).

Behavioral parity with /root/reference/src/spatialcore/stats/_thresholding.py:
five metagene aggregators (:27-99), the KS-style background-deviation
threshold (:102-198), and the 2/3-component GMM threshold (:201-344). The
reference uses numpy + scipy.stats.norm + sklearn GaussianMixture; here every
kernel is jit-compiled JAX — the GMM is a vmapped EM over ``n_init`` restarts
with counter-based deterministic seeding, so the whole fit runs as one XLA
program on the device.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.stats import norm

from ..core.rng import key_for

MetageneMethod = (
    "shifted_geometric_mean", "geometric_mean", "arithmetic_mean",
    "median", "minimum",
)


# ---------------------------------------------------------------------------
# Metagene scores
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("method",))
def compute_metagene_score(
    feature_values: jax.Array,
    method: str = "shifted_geometric_mean",
    pseudocount: float = 0.1,
) -> jax.Array:
    """Aggregate [N, F] features into a joint-elevation score per cell.

    Multiplicative methods (geometric / shifted-geometric / minimum) are high
    only when ALL markers are elevated — the property the reference designs
    for (_thresholding.py:27-45). ``shifted_geometric_mean`` is
    exp(mean(log(x + c))) - c with pseudocount c.
    """
    X = jnp.asarray(feature_values, jnp.float32)
    if X.ndim == 1:
        X = X[:, None]
    if method == "shifted_geometric_mean":
        return jnp.exp(jnp.mean(jnp.log(X + pseudocount), axis=1)) - pseudocount
    if method == "geometric_mean":
        return jnp.exp(jnp.mean(jnp.log(jnp.maximum(X, 1e-30)), axis=1)) * \
            jnp.all(X > 0, axis=1)
    if method == "arithmetic_mean":
        return jnp.mean(X, axis=1)
    if method == "median":
        return jnp.median(X, axis=1)
    if method == "minimum":
        return jnp.min(X, axis=1)
    raise ValueError(f"Unknown metagene method '{method}'. "
                     f"Choose one of {MetageneMethod}.")


# ---------------------------------------------------------------------------
# KS-style threshold
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("background_quantile",))
def _ks_core(scores: jax.Array, background_quantile: float):
    s = jnp.sort(scores)
    n = s.shape[0]
    bg_n = max(int(n * background_quantile), 10)
    bg = s[:bg_n]
    bg_mean = jnp.mean(bg)
    bg_std = jnp.std(bg)

    # zero-variance fallbacks: IQR/1.35, then 10% of range (floored)
    q25 = jnp.quantile(s, 0.25)
    q75 = jnp.quantile(s, 0.75)
    iqr = q75 - q25
    range_std = jnp.maximum((s[-1] - s[0]) * 0.1, 1e-6)
    bg_std = jnp.where(bg_std >= 1e-10, bg_std,
                       jnp.where(iqr > 1e-10, iqr / 1.35, range_std))

    ecdf = jnp.arange(1, n + 1, dtype=jnp.float32) / n
    expected = norm.cdf(s, loc=bg_mean, scale=bg_std)
    D = ecdf - expected
    threshold = s[jnp.argmax(D)]
    # sanity floor: threshold must sit above the background mean
    p90 = jnp.quantile(s, 0.9)
    threshold = jnp.where(threshold <= bg_mean, p90, threshold)

    score_range = jnp.maximum(s[-1] - threshold, 1e-10)
    deviation = jnp.clip((scores - threshold) / score_range, 0.0, 1.0)
    return threshold, deviation, bg_mean, bg_std


def threshold_ks(
    scores,
    background_quantile: float = 0.5,
) -> Tuple[float, np.ndarray, Dict]:
    """Threshold where the empirical CDF maximally exceeds a background
    normal fitted to the lower ``background_quantile`` of the data.

    Returns (threshold, deviation_scores in [0,1], params). Matches the
    reference algorithm (_thresholding.py:102-198): ≥10 background samples,
    IQR fallback for zero-variance background, P90 sanity floor.
    """
    scores = jnp.asarray(scores, jnp.float32)
    thr, dev, bg_mean, bg_std = _ks_core(scores, background_quantile)
    params = {
        "background_mean": float(bg_mean),
        "background_std": float(bg_std),
        "background_quantile": background_quantile,
    }
    return float(thr), np.asarray(dev), params


# ---------------------------------------------------------------------------
# 1D Gaussian mixture EM
# ---------------------------------------------------------------------------


class GMM1D(NamedTuple):
    """Fitted 1D Gaussian mixture (component order as fitted)."""

    means: jax.Array     # [K]
    stds: jax.Array      # [K]
    weights: jax.Array   # [K]
    log_lik: jax.Array   # scalar


def _log_prob(x, means, stds, weights):
    # [N, K] log(w_k * N(x; mu_k, sigma_k))
    return (jnp.log(weights)[None, :]
            + norm.logpdf(x[:, None], loc=means[None, :],
                          scale=stds[None, :]))


def _em_fit(x, means0, stds0, weights0, max_iter: int, tol: float,
            min_std: float):
    def cond(state):
        _, _, _, prev_ll, ll, it = state
        return (jnp.abs(ll - prev_ll) > tol) & (it < max_iter)

    def step(state):
        means, stds, weights, _, ll_prev, it = state
        lp = _log_prob(x, means, stds, weights)
        ll = jnp.mean(jax.scipy.special.logsumexp(lp, axis=1))
        resp = jax.nn.softmax(lp, axis=1)                        # [N, K]
        nk = jnp.sum(resp, axis=0) + 1e-10
        means = jnp.sum(resp * x[:, None], axis=0) / nk
        var = jnp.sum(resp * (x[:, None] - means[None, :]) ** 2, axis=0) / nk
        stds = jnp.sqrt(jnp.maximum(var, min_std ** 2))
        weights = nk / x.shape[0]
        return means, stds, weights, ll_prev, ll, it + 1

    state = (means0, stds0, weights0, jnp.float32(-jnp.inf),
             jnp.float32(jnp.inf), jnp.int32(0))
    # one manual first step to give ll a real value
    state = step(state)
    means, stds, weights, _, ll, _ = jax.lax.while_loop(
        cond, step, state)
    lp = _log_prob(x, means, stds, weights)
    ll = jnp.mean(jax.scipy.special.logsumexp(lp, axis=1))
    return means, stds, weights, ll


@functools.partial(jax.jit,
                   static_argnames=("n_components", "n_init", "max_iter"))
def fit_gmm1d(
    x: jax.Array,
    n_components: int = 2,
    seed: int = 42,
    n_init: int = 10,
    max_iter: int = 200,
    tol: float = 1e-4,
) -> GMM1D:
    """Fit a 1D GMM by EM, best of ``n_init`` deterministic restarts.

    Restart r initializes means at random data points (counter-based key
    (seed, "gmm", r)), stds at the global std, weights uniform — then runs EM
    to convergence. The best restart by mean log-likelihood wins, mirroring
    sklearn's ``n_init=10`` protocol (reference _thresholding.py:271-277)
    without host round-trips.
    """
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    gstd = jnp.maximum(jnp.std(x), 1e-6)
    min_std = 1e-4

    def one(r):
        key = key_for(seed, "gmm", r)
        idx = jax.random.choice(key, n, (n_components,), replace=False)
        means0 = x[idx]
        stds0 = jnp.full((n_components,), gstd)
        weights0 = jnp.full((n_components,), 1.0 / n_components)
        return _em_fit(x, means0, stds0, weights0, max_iter, tol, min_std)

    means, stds, weights, ll = jax.lax.map(one, jnp.arange(n_init))
    best = jnp.argmax(ll)
    return GMM1D(means[best], stds[best], weights[best], ll[best])


def gmm_posterior(scores, model: GMM1D) -> jax.Array:
    """Posterior responsibilities [N, K] under a fitted model (for reuse on
    the full dataset after subsampled fitting, reference classify.py:749-795).
    """
    scores = jnp.asarray(scores, jnp.float32)
    lp = _log_prob(scores, model.means, model.stds, model.weights)
    return jax.nn.softmax(lp, axis=1)


def threshold_gmm(
    scores,
    probability_cutoff: float = 0.3,
    n_components: int = 2,
    seed: int = 42,
    n_init: int = 10,
) -> Tuple[float, np.ndarray, np.ndarray, Dict]:
    """GMM threshold separating low/high populations.

    2-component: threshold where P(high|x) crosses 0.5 on a 1000-point grid
    between the component means (midpoint fallback). 3-component "trimodal
    spatial" mode: components sorted by mean, threshold = midpoint(background,
    first signal), P(high) = sum of non-background posteriors. Returns
    (threshold, cluster_labels, probability_high, params) with the fitted
    model under ``params["gmm_model"]`` for posterior reuse.
    """
    scores_j = jnp.asarray(scores, jnp.float32)
    model = fit_gmm1d(scores_j, n_components=n_components, seed=seed,
                      n_init=n_init)
    means = np.asarray(model.means)
    stds = np.asarray(model.stds)
    order = np.argsort(means)

    post_all = np.asarray(gmm_posterior(scores_j, model))

    if n_components == 2:
        high = int(np.argmax(means))
        low = 1 - high
        grid = jnp.linspace(float(means[low]), float(means[high]), 1000)
        pg = np.asarray(gmm_posterior(grid, model))[:, high]
        crossings = np.where(np.diff(np.sign(pg - 0.5)))[0]
        if crossings.size:
            threshold = float(np.asarray(grid)[crossings[0]])
        else:
            threshold = float((means[low] + means[high]) / 2)
        probability_high = post_all[:, high]
        high_component = high
    else:
        threshold = float((means[order[0]] + means[order[1]]) / 2)
        probability_high = post_all[:, order[1:]].sum(axis=1)
        high_component = int(order[1])

    cluster_labels = (probability_high > probability_cutoff).astype(int)
    params = {
        "gmm_means": means.tolist(),
        "gmm_stds": stds.tolist(),
        "gmm_weights": np.asarray(model.weights).tolist(),
        "n_components": n_components,
        "sorted_component_indices": order.tolist(),
        "high_component_idx": high_component,
        "probability_cutoff": probability_cutoff,
        "gmm_model": model,
    }
    return threshold, cluster_labels, probability_high, params
