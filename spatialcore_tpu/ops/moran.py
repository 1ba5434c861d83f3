"""Moran's I and Geary's C kernels: observed stats, analytic moments, and
vmapped permutation nulls.

Replaces the reference's squidpy delegation
(/root/reference/src/spatialcore/spatial/autocorrelation.py:563-583) and its
pure-Python local-Moran hot loops (:845-899). All permutation work runs as
``vmap`` over counter-based-PRNG shuffles with p-values accumulated in a
``lax.scan`` over permutation chunks — never a Python loop over cells.

Estimator conventions (match squidpy/esda):
    I   = (n / S0) · zᵀ W z / zᵀz
    E[I]  = −1/(n−1)
    C   = (n−1) Σ_ij w_ij (x_i−x_j)² / (2 S0 Σ z²),  E[C] = 1
    VarN / VarR : Cliff & Ord (1981) normality / randomization formulas.
    p_sim two-tailed or one-sided: (#extreme + 1)/(P + 1).
Local Moran (reference convention, unit-variance z): I_i = z_i · lag_i.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.rng import key_for
from .graph import SpatialGraph, spatial_lag

# ---------------------------------------------------------------------------
# Standardization
# ---------------------------------------------------------------------------


def standardize(X: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Per-column z-scores with population std; returns (Z, zero_var mask).

    Zero-variance columns get std=1 (z all zeros), matching the reference's
    zero-variance handling (autocorrelation.py:825-830). float64 inputs stay
    float64 when ``jax_enable_x64`` is on — the CPU validation mode for the
    1e-6 ecosystem-agreement bar (SURVEY.md §7 hard part 1).
    """
    X = jnp.asarray(X)
    if X.dtype not in (jnp.float32, jnp.float64):
        X = X.astype(jnp.float32)
    mean = jnp.mean(X, axis=0, keepdims=True)
    # shifted two-pass variance: the one-pass E[X²]−mean² form cancels
    # catastrophically in f32 for high-mean low-variance genes (mean/std
    # beyond ~3e3 lost ALL significant bits and misflagged zero-variance);
    # Xc is needed for Z anyway, so this costs nothing extra
    Xc = X - mean
    var = jnp.mean(Xc * Xc, axis=0, keepdims=True)
    zero = var[0] <= 0
    std = jnp.sqrt(jnp.where(var > 0, var, 1.0))
    return Xc / std, zero


# ---------------------------------------------------------------------------
# Global statistics
# ---------------------------------------------------------------------------


def moran_observed(graph: SpatialGraph, Z: jax.Array, S0: float) -> jax.Array:
    """Global Moran's I per gene for standardized Z [N, G]."""
    n = Z.shape[0]
    lag = spatial_lag(graph, Z)
    num = jnp.sum(Z * lag, axis=0)
    den = jnp.sum(Z * Z, axis=0)
    den = jnp.where(den > 0, den, 1.0)
    return (n / S0) * num / den


def geary_observed(graph: SpatialGraph, Z: jax.Array, S0: float) -> jax.Array:
    """Global Geary's C per gene for standardized Z [N, G].

    C = (n−1) Σ_ik w_ik (z_i − z_{nbr(i,k)})² / (2 S0 Σ z²); scale-invariant,
    so standardized Z gives the same value as raw x.
    """
    n = Z.shape[0]
    k = graph.neighbor_idx.shape[1]
    sequence = Z.size > 50_000_000
    num = jnp.zeros((Z.shape[1],), jnp.float32)
    for j in range(k):
        diff = Z - Z[graph.neighbor_idx[:, j]]
        num = num + jnp.sum(graph.neighbor_w[:, j:j + 1] * diff * diff, axis=0)
        if sequence:
            num = jax.lax.optimization_barrier(num)
    den = jnp.sum(Z * Z, axis=0)
    den = jnp.where(den > 0, den, 1.0)
    return (n - 1) * num / (2.0 * S0 * den)


# ---------------------------------------------------------------------------
# Analytic moments (Cliff & Ord)
# ---------------------------------------------------------------------------


def moran_analytic_moments(Z: jax.Array, S0: float, S1: float, S2: float,
                           assumption: str = "randomization"):
    """(E[I], Var[I]) per gene under normality or randomization."""
    n = Z.shape[0]
    EI = -1.0 / (n - 1)
    if assumption == "normality":
        var = (n * n * S1 - n * S2 + 3 * S0 * S0) / (S0 * S0 * (n * n - 1)) - EI ** 2
        return EI, jnp.full((Z.shape[1],), var, jnp.float32)
    # randomization: depends on kurtosis b2 per gene
    z2 = jnp.sum(Z * Z, axis=0)
    z4 = jnp.sum(Z ** 4, axis=0)
    b2 = n * z4 / jnp.where(z2 > 0, z2 * z2, 1.0)
    num = (n * ((n * n - 3 * n + 3) * S1 - n * S2 + 3 * S0 * S0)
           - b2 * ((n * n - n) * S1 - 2 * n * S2 + 6 * S0 * S0))
    den = (n - 1) * (n - 2) * (n - 3) * S0 * S0
    return EI, num / den - EI ** 2


def geary_analytic_moments(Z: jax.Array, S0: float, S1: float, S2: float,
                           assumption: str = "randomization"):
    """(E[C]=1, Var[C]) per gene under normality or randomization."""
    n = Z.shape[0]
    if assumption == "normality":
        var = ((2 * S1 + S2) * (n - 1) - 4 * S0 * S0) / (2 * (n + 1) * S0 * S0)
        return 1.0, jnp.full((Z.shape[1],), var, jnp.float32)
    z2 = jnp.sum(Z * Z, axis=0)
    z4 = jnp.sum(Z ** 4, axis=0)
    b2 = n * z4 / jnp.where(z2 > 0, z2 * z2, 1.0)
    nd = n * (n - 2) * (n - 3) * S0 * S0
    t1 = (n - 1) * S1 * (n * n - 3 * n + 3 - (n - 1) * b2)
    t2 = -0.25 * (n - 1) * S2 * (n * n + 3 * n - 6 - (n * n - n + 2) * b2)
    t3 = S0 * S0 * (n * n - 3 - (n - 1) ** 2 * b2)
    return 1.0, (t1 + t2 + t3) / nd


def p_from_z(z: jax.Array, alternative: str = "greater") -> jax.Array:
    """Normal-tail p-value from a z-score."""
    from jax.scipy.stats import norm

    if alternative == "greater":
        return 1.0 - norm.cdf(z)
    if alternative == "less":
        return norm.cdf(z)
    return 2.0 * (1.0 - norm.cdf(jnp.abs(z)))


# ---------------------------------------------------------------------------
# Permutation nulls (global)
# ---------------------------------------------------------------------------


def _perm_stat_global(graph, Z, S0, perm, stat: str, den=None):
    """Null statistic for one permutation, reduction-fused per neighbor slot.

    The [N, G] spatial lag is never materialized: each neighbor slot does
    gather → multiply → reduce straight to [G] (with a free [G]-sized
    barrier between slots), cutting per-draw HBM traffic ~1.6× vs the
    lag-accumulator formulation. The denominator Σz² is permutation-
    invariant and passed in precomputed.
    """
    n = Z.shape[0]
    if den is None:
        den = jnp.sum(Z * Z, axis=0)
        den = jnp.where(den > 0, den, 1.0)
    Zp = Z[perm]
    num = jnp.zeros((Z.shape[1],), jnp.float32)
    for j in range(graph.neighbor_idx.shape[1]):
        pidx = perm[graph.neighbor_idx[:, j]]        # composite index [N]
        w = graph.neighbor_w[:, j:j + 1]
        if stat == "moran":
            num = num + jnp.sum(w * Zp * Z[pidx], axis=0)
        else:
            diff = Zp - Z[pidx]
            num = num + jnp.sum(w * diff * diff, axis=0)
        num = jax.lax.optimization_barrier(num)
    if stat == "moran":
        return (n / S0) * num / den
    return (n - 1) * num / (2.0 * S0 * den)


@functools.partial(jax.jit, static_argnames=("stat", "n_permutations",
                                             "chunk", "alternative",
                                             "null_dtype"))
def permutation_test_global(
    graph: SpatialGraph,
    Z: jax.Array,
    S0: float,
    observed: jax.Array,
    seed: int,
    n_permutations: int,
    stat: str = "moran",
    chunk: int = 1,
    alternative: str = "greater",
    null_dtype: str = "float32",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Monte-Carlo permutation p-values for a global statistic.

    Shuffles are shared across genes (one permutation per draw, applied to
    all columns — the reference's batching trick, autocorrelation.py:877-884)
    but each draw has its own counter-based key ⇒ bitwise reproducible for a
    given (seed, draw index) regardless of device layout.

    One ``lax.scan`` step per draw: peak temps stay at O(N·G) no matter how
    many permutations run, so 1M cells × 5k genes × 1k draws fits HBM.
    ``chunk`` is accepted for API compatibility but ignored.
    """
    del chunk
    n, G = Z.shape
    base = key_for(seed, "perm_global", 0)
    den = jnp.sum(Z * Z, axis=0)
    den = jnp.where(den > 0, den, 1.0)
    # bf16 null mode: gathers move half the bytes; per-slot accumulation
    # stays f32. Null values then carry ~3-digit precision — fine for
    # Monte-Carlo counting, not for the observed statistic (kept f32).
    Zg = Z.astype(jnp.bfloat16) if null_dtype == "bfloat16" else Z

    # a few concurrent draws hide gather latency as long as the vmapped
    # [c, N, G] temps stay well under device memory
    c = max(1, min(4, int(5.4e8 // max(n * G, 1))))
    while n_permutations % c:
        c -= 1

    def body(carry, step):
        count, s1, s2 = carry

        def one(p):
            key = jax.random.fold_in(base, step * c + p)
            perm = jax.random.permutation(key, n)
            return _perm_stat_global(graph, Zg, S0, perm, stat, den=den)

        if c == 1:
            vals = one(jnp.int32(0))[None, :]        # [1, G], no vmap —
            # a unit-batch vmap re-batches the slot gathers and regresses
            # fusion
        else:
            vals = jax.vmap(one)(jnp.arange(c))      # [c, G]
        if alternative == "greater":
            extreme = vals >= observed[None, :]
        elif alternative == "less":
            extreme = vals <= observed[None, :]
        else:
            extreme = jnp.abs(vals) >= jnp.abs(observed)[None, :]
        return (count + jnp.sum(extreme, axis=0, dtype=jnp.int32),
                s1 + vals.sum(axis=0),
                s2 + (vals * vals).sum(axis=0)), None

    # accumulate in Z's float dtype: hard-coded f32 crashed the scan
    # ("carry input/output must have equal types") in the documented f64
    # validation mode (x64 + float64 X)
    acc_dt = jnp.result_type(Z.dtype, jnp.float32)
    init = (jnp.zeros((G,), jnp.int32), jnp.zeros((G,), acc_dt),
            jnp.zeros((G,), acc_dt))
    (count, s1, s2), _ = jax.lax.scan(body, init,
                                      jnp.arange(n_permutations // c))
    P = n_permutations
    p = (count + 1.0) / (P + 1.0)
    mean = s1 / P
    var = jnp.maximum(s2 / P - mean ** 2, 0.0)
    return p, mean, jnp.sqrt(var)


# ---------------------------------------------------------------------------
# Local Moran (LISA)
# ---------------------------------------------------------------------------


def _conditional_draw_indices(key, n: int, k: int):
    """Per-slot GeoDa conditional-permutation draw indices (one draw).

    ``out[j][i]`` is the cell whose value fills neighbor slot ``j`` of
    cell ``i``: a shared global permutation with cell i's own position
    excluded via the ``+1+u_j`` offset in permuted space (``u`` drawn
    without replacement from ``[0, n-1)``) — uniform over OTHER cells'
    values, conditional on i's own. Single implementation shared by
    local Moran / local Geary / local join counts / multivariate Geary
    (the draw-key scheme must stay in lock-step across them).
    """
    perm = jax.random.permutation(key, n)
    inv = jnp.argsort(perm)
    u = jax.random.choice(jax.random.fold_in(key, 1), n - 1, (k,),
                          replace=False)
    return [perm[(inv + 1 + u[j]) % n] for j in range(k)]



class LocalMoranResult(NamedTuple):
    local_I: jax.Array   # [N, G]
    z: jax.Array         # [N, G]
    lag: jax.Array       # [N, G]
    p_value: jax.Array   # [N, G] permutation two-tailed (ones if P=0)


@functools.partial(jax.jit,
                   static_argnames=("n_permutations", "chunk", "null"))
def local_moran(
    graph: SpatialGraph,
    Z: jax.Array,
    seed: int,
    n_permutations: int = 0,
    chunk: int = 8,
    null: str = "total",
) -> LocalMoranResult:
    """Local Moran's I with permutation p-values, fully on-device.

    I_i = z_i · (Wz)_i. Two-tailed p per cell:
    (#{|I_perm| ≥ |I_obs|} + 1)/(P + 1). The reference computes this with a
    nested Python loop over cells×genes (autocorrelation.py:888-896) — its
    worst bottleneck; here each draw is one fused scan step with O(N·G)
    peak memory. ``chunk`` is accepted for API compatibility but ignored.

    ``null``: ``"total"`` (default; the reference's convention) shuffles
    whole z columns, permuting both z_i and its neighbors.
    ``"conditional"`` is the GeoDa/esda LISA convention — each cell keeps
    its OWN z_i and its k neighbor slots draw uniformly WITHOUT
    replacement from the other n−1 cells, built exactly per draw with the
    same offset scheme as :func:`local_geary`.
    """
    del chunk
    if null not in ("total", "conditional"):
        raise ValueError(
            f"null must be 'total' or 'conditional', got {null!r}")
    n, G = Z.shape
    k = graph.neighbor_idx.shape[1]
    lag = spatial_lag(graph, Z)
    I_obs = Z * lag

    if n_permutations == 0:
        return LocalMoranResult(I_obs, Z, lag, jnp.ones_like(I_obs))

    abs_obs = jnp.abs(I_obs)
    base = key_for(seed, "perm_local", 0)

    def body(count, p):
        key = jax.random.fold_in(base, p)
        perm = jax.random.permutation(key, n)
        if null == "total":
            Zp = Z[perm]
            Ip = Zp * spatial_lag(graph, Zp)
        else:
            draws = _conditional_draw_indices(key, n, k)
            lag_p = jnp.zeros_like(Z)
            sequence = n * G > 50_000_000
            for j in range(k):
                lag_p = lag_p + graph.neighbor_w[:, j:j + 1] * Z[draws[j]]
                if sequence:
                    # stop XLA batching the k gathers into one [N, k, G]
                    # temp (OOMs at scale; same guard as spatial_lag)
                    lag_p = jax.lax.optimization_barrier(lag_p)
            Ip = Z * lag_p
        extreme = jnp.abs(Ip) >= abs_obs
        return count + extreme.astype(jnp.int32), None

    count, _ = jax.lax.scan(body, jnp.zeros((n, G), jnp.int32),
                            jnp.arange(n_permutations))
    p = (count + 1.0) / (n_permutations + 1.0)
    return LocalMoranResult(I_obs, Z, lag, p)


# ---------------------------------------------------------------------------
# Local Geary's C
# ---------------------------------------------------------------------------


class LocalGearyResult(NamedTuple):
    local_C: jax.Array   # [N, G]
    p_value: jax.Array   # [N, G] one-sided (low C = positive autocorr)


@functools.partial(jax.jit, static_argnames=("n_permutations", "null"))
def local_geary(
    graph: SpatialGraph,
    Z: jax.Array,
    seed: int = 0,
    n_permutations: int = 0,
    null: str = "conditional",
) -> LocalGearyResult:
    """Local Geary's C (Anselin 1995/2019): c_i = Σ_j w_ij (z_i − z_j)².

    Small c_i = the cell resembles its neighbors (positive local
    autocorrelation). Permutation p is one-sided on the low tail,
    (#{c_perm ≤ c_obs} + 1)/(P + 1), one scan step per draw.

    ``null`` selects the randomization scheme:

    * ``"conditional"`` (default; the GeoDa/esda convention) — each cell
      keeps its OWN value and its k neighbor slots are filled with values
      drawn uniformly WITHOUT replacement from the other n−1 cells. Built
      exactly (not approximately) per draw: with a uniform permutation π
      and k distinct shared offsets u_j ∈ [0, n−2], the draw for cell i is
      π[(π⁻¹[i] + 1 + u_j) mod n] — never i, distinct across j, and
      uniform over non-i cells.
    * ``"total"`` — whole-column shuffle applied to both sides (the
      total-randomization null the reference's local stats use).
    """
    n, G = Z.shape
    k = graph.neighbor_idx.shape[1]

    def local_c(Zv, perm=None):
        c = jnp.zeros_like(Zv)
        for j in range(k):
            idx = graph.neighbor_idx[:, j]
            if perm is not None:
                nb = Zv[perm[idx]]
                me = Zv[perm]
            else:
                nb = Zv[idx]
                me = Zv
            d = me - nb
            c = c + graph.neighbor_w[:, j:j + 1] * d * d
        return c

    c_obs = local_c(Z)
    if n_permutations == 0:
        return LocalGearyResult(c_obs, jnp.ones_like(c_obs))

    base = key_for(seed, "perm_local_geary", 0)

    def body(count, p):
        key = jax.random.fold_in(base, p)
        perm = jax.random.permutation(key, n)
        if null == "total":
            cp = local_c(Z, perm=perm)
        else:
            draws = _conditional_draw_indices(key, n, k)
            cp = jnp.zeros_like(Z)
            sequence = Z.shape[0] * Z.shape[1] > 50_000_000
            for j in range(k):
                d = Z - Z[draws[j]]
                cp = cp + graph.neighbor_w[:, j:j + 1] * d * d
                if sequence:
                    # same [N, k, G]-temp guard as spatial_lag
                    cp = jax.lax.optimization_barrier(cp)
        return count + (cp <= c_obs).astype(jnp.int32), None

    count, _ = jax.lax.scan(body, jnp.zeros((n, G), jnp.int32),
                            jnp.arange(n_permutations))
    p = (count + 1.0) / (n_permutations + 1.0)
    return LocalGearyResult(c_obs, p)


# ---------------------------------------------------------------------------
# Join counts (binary autocorrelation)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_permutations",))
def join_counts(
    graph: SpatialGraph,
    x: jax.Array,
    seed: int = 0,
    n_permutations: int = 999,
):
    """Join-count statistics for a binary variable over the graph.

    Counts directed joins on the binary adjacency (w > 0):
    BB = Σ w̄_ij x_i x_j, WW = Σ w̄_ij (1−x_i)(1−x_j), BW = rest. The null
    permutes labels with counter-based keys (one scan step per draw);
    returns observed counts and one-sided pseudo p-values
    (#{BB_perm ≥ BB}+1)/(P+1) for BB clustering (and WW), BW anti-
    clustering tested as #{BW_perm ≤ BW}.
    """
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    adj = (graph.neighbor_w > 0).astype(jnp.float32)   # binary, masked

    def counts(xv):
        bb = jnp.float32(0)
        ww = jnp.float32(0)
        k = graph.neighbor_idx.shape[1]
        for j in range(k):
            xn = xv[graph.neighbor_idx[:, j]]
            a = adj[:, j]
            bb = bb + jnp.sum(a * xv * xn)
            ww = ww + jnp.sum(a * (1 - xv) * (1 - xn))
        total = jnp.sum(adj)
        return bb, ww, total - bb - ww

    bb_obs, ww_obs, bw_obs = counts(x)
    base = key_for(seed, "join_counts", 0)

    def body(carry, p):
        c_bb, c_ww, c_bw = carry
        perm = jax.random.permutation(jax.random.fold_in(base, p), n)
        bb, ww, bw = counts(x[perm])
        return (c_bb + (bb >= bb_obs).astype(jnp.int32),
                c_ww + (ww >= ww_obs).astype(jnp.int32),
                c_bw + (bw <= bw_obs).astype(jnp.int32)), None

    (c_bb, c_ww, c_bw), _ = jax.lax.scan(
        body, (jnp.int32(0), jnp.int32(0), jnp.int32(0)),
        jnp.arange(n_permutations))
    P = n_permutations
    return {
        "BB": bb_obs, "WW": ww_obs, "BW": bw_obs,
        "p_BB": (c_bb + 1.0) / (P + 1.0),
        "p_WW": (c_ww + 1.0) / (P + 1.0),
        "p_BW": (c_bw + 1.0) / (P + 1.0),
    }


# ---------------------------------------------------------------------------
# Quadrants
# ---------------------------------------------------------------------------

QUADRANT_LABELS = {0: "NS", 1: "HH", 2: "LL", 3: "HL", 4: "LH"}


def classify_quadrants(
    z: jax.Array,
    lag: jax.Array,
    p_values: Optional[jax.Array] = None,
    alpha: float = 0.05,
) -> jax.Array:
    """LISA quadrant codes (int8): 0=NS, 1=HH, 2=LL, 3=HL, 4=LH.

    Matches the reference's coding (autocorrelation.py:219-265): sign(z) ×
    sign(lag) picks the quadrant; cells with p ≥ alpha are forced to NS.
    Exact zeros in z or lag are NS.
    """
    hh = (z > 0) & (lag > 0)
    ll = (z < 0) & (lag < 0)
    hl = (z > 0) & (lag < 0)
    lh = (z < 0) & (lag > 0)
    q = (jnp.where(hh, 1, 0) + jnp.where(ll, 2, 0)
         + jnp.where(hl, 3, 0) + jnp.where(lh, 4, 0)).astype(jnp.int8)
    if p_values is not None:
        q = jnp.where(p_values >= alpha, jnp.int8(0), q)
    return q


# ---------------------------------------------------------------------------
# Local join counts / multivariate local Geary (Anselin & Li 2019)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_permutations",))
def local_join_counts(
    graph: SpatialGraph,
    x: jax.Array,
    seed: int = 0,
    n_permutations: int = 999,
):
    """Local join counts for a binary variable (Anselin & Li 2019).

    BB_i = x_i · Σ_j ā_ij x_j over the binary adjacency — the number of
    1-1 joins at cell i, defined where x_i = 1. The null is the
    conditional permutation (x_i held fixed, neighbor values drawn
    uniformly without replacement from the other cells — the same exact
    construction as ``local_geary``); one-sided
    p = (#{BB_perm ≥ BB_obs}+1)/(P+1) where x_i = 1, p = 1 elsewhere.
    Returns (BB [N] float32, p [N] float32).
    """
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    k = graph.neighbor_idx.shape[1]
    adj = (graph.neighbor_w > 0).astype(jnp.float32)

    def bb(neigh_vals):
        # neigh_vals: [k] callables? compute with provided per-slot values
        s = jnp.zeros((n,), jnp.float32)
        for j in range(k):
            s = s + adj[:, j] * neigh_vals[j]
        return x * s

    obs = bb([x[graph.neighbor_idx[:, j]] for j in range(k)])
    if n_permutations == 0:
        return obs, jnp.ones_like(obs)

    base = key_for(seed, "perm_local_jc", 0)

    def body(count, p):
        key = jax.random.fold_in(base, p)
        draws = _conditional_draw_indices(key, n, k)
        vals = [x[draws[j]] for j in range(k)]
        bp = bb(vals)
        return count + (bp >= obs).astype(jnp.int32), None

    count, _ = jax.lax.scan(body, jnp.zeros((n,), jnp.int32),
                            jnp.arange(n_permutations))
    p = (count + 1.0) / (n_permutations + 1.0)
    p = jnp.where(x > 0, p, 1.0)
    return obs, p


@functools.partial(jax.jit, static_argnames=("n_permutations",))
def local_geary_multivariate(
    graph: SpatialGraph,
    Z: jax.Array,
    seed: int = 0,
    n_permutations: int = 999,
):
    """Multivariate local Geary (Anselin 2019): c_i = mean_v Σ_j w_ij
    (z_vi − z_vj)² over the variable set.

    One conditional-permutation null (shared draws across variables, the
    standard construction); one-sided low-tail p. Returns (c [N], p [N]).
    """
    n, G = Z.shape
    k = graph.neighbor_idx.shape[1]

    def cstat(neigh):
        c = jnp.zeros((n,), jnp.float32)
        for j in range(k):
            d = Z - neigh[j]
            c = c + graph.neighbor_w[:, j] * jnp.sum(d * d, axis=1)
        return c / G

    obs = cstat([Z[graph.neighbor_idx[:, j]] for j in range(k)])
    if n_permutations == 0:
        return obs, jnp.ones_like(obs)

    base = key_for(seed, "perm_local_geary_mv", 0)

    def body(count, p):
        key = jax.random.fold_in(base, p)
        draws = _conditional_draw_indices(key, n, k)
        neigh = [Z[draws[j]] for j in range(k)]
        cp = cstat(neigh)
        return count + (cp <= obs).astype(jnp.int32), None

    count, _ = jax.lax.scan(body, jnp.zeros((n,), jnp.int32),
                            jnp.arange(n_permutations))
    return obs, (count + 1.0) / (n_permutations + 1.0)


# ---------------------------------------------------------------------------
# Distance-band correlogram — all bands in one dispatch
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_permutations",))
def correlogram_kernel(
    idx: jax.Array,      # [N, K] radius-neighbor indices (one shared search)
    dist: jax.Array,     # [N, K] neighbor distances
    valid: jax.Array,    # [N, K] slot validity
    Z: jax.Array,        # [N, G] standardized expression
    edges: jax.Array,    # [B+1] increasing band boundaries
    seed,
    n_permutations: int = 0,
):
    """Moran's I over every distance band in ONE device dispatch.

    Replaces the per-band Python loop (one dispatch + a host-side CSR
    moments pass + its own permutation scan PER BAND): band masks derive from
    one shared radius search, Cliff-Ord S0/S1/S2 come from on-device
    gathers (band membership is symmetric, so w_ji = 1/deg_j is a gather
    of the neighbor's band degree — no CSR transpose needed), and ONE
    permutation scan shares each draw's shuffle across all bands (same
    draw stream as :func:`permutation_test_global`, so per-band p_sim
    agrees with running that kernel per band with this seed up to f32
    summation-order effects on exactly-tied draws). Each draw costs K row
    gathers TOTAL instead of K per band.

    Returns ``(I_obs [B,G], z [B,G], p_norm [B,G], p_sim [B,G], S0 [B])``;
    bands with no pairs have S0 = 0 and I = 0, p = 1.
    """
    n, K = idx.shape
    G = Z.shape[1]
    B = edges.shape[0] - 1

    bid = jnp.searchsorted(edges, dist, side="right") - 1        # [N, K]
    in_band = valid & (bid >= 0) & (bid < B) & (dist < edges[-1])
    bid = jnp.where(in_band, bid, B).astype(jnp.int32)           # B = none

    def _col(a, k):
        return jax.lax.dynamic_index_in_dim(a, k, axis=1, keepdims=False)

    # per-cell per-band degree [N, B+1] (fori_loop over slots keeps both
    # the temps AND the compiled graph at O(N·B), not O(N·B·K))
    def _deg_slot(k, acc):
        return acc + jax.nn.one_hot(_col(bid, k), B + 1, dtype=jnp.float32)

    degNB = jax.lax.fori_loop(0, K, _deg_slot,
                              jnp.zeros((n, B + 1), jnp.float32))
    deg = degNB[:, :B]                                           # [N, B]
    invdeg = jnp.where(deg > 0, 1.0 / jnp.maximum(deg, 1.0), 0.0)
    has = (deg > 0).astype(jnp.float32)                          # [N, B]

    # row-normalized weight of edge (i, k): 1/deg_i in its band
    wt = jnp.take_along_axis(
        jnp.concatenate([invdeg, jnp.zeros((n, 1))], axis=1),
        bid, axis=1)                                             # [N, K]

    # Cliff-Ord sums per band.  S0 = #rows with pairs (rows sum to 1);
    # S1 = Σ_i 1/deg_i + Σ_edges 1/(deg_i·deg_j);  S2 = Σ_i (1 + col_i)²
    # with col_i = Σ_{j∈band(i)} 1/deg_j (symmetry of band membership).
    S0 = jnp.sum(has, axis=0)                                    # [B]

    def _mom_slot(k, carry):
        cross_inv, col = carry
        inv_j = invdeg[_col(idx, k)]                             # [N, B]
        sel = jax.nn.one_hot(_col(bid, k), B + 1,
                             dtype=jnp.float32)[:, :B]           # [N, B]
        return (cross_inv + jnp.sum(sel * invdeg * inv_j, axis=0),
                col + sel * inv_j)

    cross_inv, col = jax.lax.fori_loop(
        0, K, _mom_slot, (jnp.zeros((B,), jnp.float32),
                          jnp.zeros((n, B), jnp.float32)))
    S1 = jnp.sum(invdeg * has, axis=0) + cross_inv               # [B]
    S2 = jnp.sum((has + col) ** 2, axis=0)                       # [B]

    den = jnp.sum(Z * Z, axis=0)
    den = jnp.where(den > 0, den, 1.0)                           # [G]

    def band_num(Zrow, Znbr_of_idx):
        """num[b, g] = Σ_i w(i,k∈b) z_i z_nbr for each band."""
        # carry dtype follows Z: a hard-coded f32 carry crashed the
        # fori_loop under x64 + float64 Z (f64 validation mode)
        acc_dt = jnp.result_type(Zrow.dtype, jnp.float32)

        def slot(k, num):
            cross = (Zrow * Znbr_of_idx(_col(idx, k))
                     * _col(wt, k).astype(Zrow.dtype)[:, None])  # [N, G]
            sel = jax.nn.one_hot(_col(bid, k), B + 1,
                                 dtype=cross.dtype)[:, :B]       # [N, B]
            return num + jnp.einsum("nb,ng->bg", sel, cross)

        return jax.lax.fori_loop(0, K, slot,
                                 jnp.zeros((B, G), acc_dt))

    num_obs = band_num(Z, lambda ik: Z[ik])
    S0_safe = jnp.where(S0 > 0, S0, 1.0)
    I_obs = (n / S0_safe[:, None]) * num_obs / den[None, :]      # [B, G]

    # analytic randomization moments (per band × gene kurtosis).
    # ALL n-polynomial coefficients as Python floats: n*n alone
    # overflows int32 from n ≈ 46k, (n-1)(n-2)(n-3) from n ≈ 1300
    nf = float(n)
    z2 = jnp.sum(Z * Z, axis=0)
    z4 = jnp.sum(Z ** 4, axis=0)
    b2 = nf * z4 / jnp.where(z2 > 0, z2 * z2, 1.0)               # [G]
    EI = -1.0 / (nf - 1.0)
    S0b, S1b, S2b = S0_safe[:, None], S1[:, None], S2[:, None]
    numv = (nf * ((nf * nf - 3.0 * nf + 3.0) * S1b - nf * S2b
                  + 3.0 * S0b * S0b)
            - b2[None, :] * ((nf * nf - nf) * S1b - 2.0 * nf * S2b
                             + 6.0 * S0b * S0b))
    denv = (nf - 1.0) * (nf - 2.0) * (nf - 3.0) * S0b * S0b
    varI = jnp.maximum(numv / denv - EI ** 2, 1e-30)
    z_sc = (I_obs - EI) / jnp.sqrt(varI)
    p_norm = p_from_z(z_sc, "two-sided")

    empty = (S0 == 0)[:, None]
    I_obs = jnp.where(empty, 0.0, I_obs)
    z_sc = jnp.where(empty, 0.0, z_sc)
    p_norm = jnp.where(empty, 1.0, p_norm)

    if n_permutations == 0:
        return I_obs, z_sc, p_norm, jnp.ones_like(p_norm), S0

    base = key_for(seed, "perm_global", 0)

    def body(count, step):
        key = jax.random.fold_in(base, step)
        perm = jax.random.permutation(key, n)
        Zp = Z[perm]
        num_p = band_num(Zp, lambda ik: Z[perm[ik]])
        I_p = (n / S0_safe[:, None]) * num_p / den[None, :]
        extreme = jnp.abs(I_p) >= jnp.abs(I_obs)
        return count + extreme.astype(jnp.int32), None

    count, _ = jax.lax.scan(body, jnp.zeros((B, G), jnp.int32),
                            jnp.arange(n_permutations))
    p_sim = (count + 1.0) / (n_permutations + 1.0)
    p_sim = jnp.where(empty, 1.0, p_sim)
    return I_obs, z_sc, p_norm, p_sim, S0
