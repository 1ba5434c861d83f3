"""Ripley's K / L and cross-type K with permutation envelopes.

BASELINE config 3 extension (not implemented in the reference — suggested in
its docs only, /root/reference/docs/spatial/spatial_stats.md "Sparse
Markers"). Design: a uniform-grid bucket table bounds the O(N²) pair sum
to pairs within ``r_max``; a ``lax.map`` over query tiles computes candidate
distances and accumulates per-radius counts on device.

Access-pattern rules:

- never gather per-candidate rows (``coords[cand]`` is a [tile·C] random
  gather of 8-byte rows, bound by the row rate). Instead pre-gather the
  bucket tables ONCE per pass into ``[nb, C, 2]`` coordinate / ``[nb, C]``
  type tables and fetch whole bucket rows per window offset: ~25× fewer
  row gathers.
- envelope draws never touch the host: binning (sort + scatter), CSR
  uniform draws and label permutations all run on device; the per-draw
  loop costs one dispatch each.

Envelopes:

- univariate K: CSR simulations (uniform points in the bounding window),
  counter-based keys, same kernel;
- cross-type K: random-labeling permutations — distances are fixed, only
  the label table changes per draw.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.rng import key_for


class GridSpec(NamedTuple):
    """Static bucket-grid geometry, shared by every pass of one analysis."""
    mins: np.ndarray      # f32 [2]
    span: np.ndarray      # f32 [2]
    nbx: int
    nby: int
    window: int           # bucket-window radius covering r_max
    capacity: int         # padded per-bucket capacity


def make_grid_spec(coords_np: np.ndarray, r_max: float,
                   target_window: int = 2,
                   bbox=None,
                   capacity_slack: float = 1.0) -> GridSpec:
    """Choose grid geometry so a (2w+1)² window covers every pair ≤ r_max.

    ``nbx = floor(span/edge)`` keeps the bucket edge ≥ r_max/target_window,
    so ``window == target_window`` exactly (a +1 here once made the edge
    epsilon-smaller than r_max/2 and silently grew the window to 3 —
    doubling the candidate work). Capacity is the observed max bucket
    count × slack, rounded to a power of two so near-identical datasets
    share one compiled kernel.
    """
    coords_np = np.asarray(coords_np, np.float32)
    if bbox is None:
        mins = coords_np.min(axis=0)
        maxs = coords_np.max(axis=0)
    else:
        mins, maxs = (np.asarray(b, np.float32) for b in bbox)
    span = np.maximum(maxs - mins, 1e-9).astype(np.float32)
    edge = r_max / max(target_window, 1)
    nbx = int(max(1, min(span[0] / edge, 4096)))
    nby = int(max(1, min(span[1] / edge, 4096)))
    h = (span / np.array([nbx, nby], np.float32)).astype(np.float32)
    window = int(np.ceil(r_max / min(h[0], h[1]) - 1e-6))
    # observed max bucket occupancy — in the SAME float32 arithmetic the
    # device binning uses (_bin_points): f64 host floor disagreed with
    # f32 device floor on bucket-edge points, and with slack=1.0 and a
    # power-of-two max_count that one-point shift tripped the capacity
    # overflow error on data that fits
    bx = np.clip(np.floor((coords_np[:, 0] - mins[0]) / h[0]),
                 0, nbx - 1).astype(np.int64)
    by = np.clip(np.floor((coords_np[:, 1] - mins[1]) / h[1]),
                 0, nby - 1).astype(np.int64)
    max_count = int(np.bincount(bx * nby + by, minlength=nbx * nby).max())
    C = 1 << int(np.ceil(np.log2(
        max(max_count, 1) * max(capacity_slack, 1.0) + 1.0)))
    return GridSpec(mins=mins, span=span, nbx=nbx, nby=nby, window=window,
                    capacity=int(C))


@functools.partial(jax.jit, static_argnames=("nbx", "nby", "C"))
def _bin_points(coords, mins, span, nbx: int, nby: int, C: int):
    """Bucket-table build on device: sort by bucket id, scatter positions.

    Returns ``table int32 [nbx·nby, C]`` (−1 pad), per-point bucket coords,
    and the max bucket occupancy (overflowing points land in a discard
    column; callers must check ``max_count <= C``).
    """
    n = coords.shape[0]
    h = span / jnp.array([nbx, nby], jnp.float32)
    bx = jnp.clip(jnp.floor((coords[:, 0] - mins[0]) / h[0]).astype(jnp.int32),
                  0, nbx - 1)
    by = jnp.clip(jnp.floor((coords[:, 1] - mins[1]) / h[1]).astype(jnp.int32),
                  0, nby - 1)
    bucket = bx * nby + by
    order = jnp.argsort(bucket)
    sb = bucket[order]
    first = jnp.searchsorted(sb, sb, side="left")
    pos = jnp.arange(n, dtype=jnp.int32) - first.astype(jnp.int32)
    # width C+1: overflow writes go to the sliced-off discard column
    tbl = jnp.full((nbx * nby, C + 1), -1, jnp.int32)
    tbl = tbl.at[sb, jnp.minimum(pos, C)].set(order.astype(jnp.int32))
    return tbl[:, :C], bx, by, jnp.max(pos) + 1


@functools.partial(jax.jit,
                   static_argnames=("nbx", "nby", "window", "n_radii",
                                    "n_types", "tile"))
def _pair_counts(coords, table, bx, by, radii_sq, type_codes,
                 nbx: int, nby: int, window: int, n_radii: int,
                 n_types: int, tile: int = 4096):
    """Σ_{i≠j, d_ij ≤ r} per radius — overall [R] and per type pair [R,T,T].

    ``type_codes`` int32 [N] (0..n_types−1); with n_types == 1 the per-pair
    output collapses to the univariate count. Ordered pairs are counted
    (i→j and j→i), matching the K estimator's double sum.

    The bucket tables are pre-gathered once per call (``tcoords [nb,C,2]``,
    ``ttypes [nb,C]``): every window offset then fetches whole bucket rows
    — no per-candidate gathers anywhere in the tile loop.
    """
    n = coords.shape[0]
    C = table.shape[1]
    safe = jnp.maximum(table, 0)
    # invalid slots get far-away coords so d2 = huge without extra masking
    tcoords = jnp.where((table >= 0)[:, :, None], coords[safe], 3e18)
    ttypes = type_codes[safe] if n_types > 1 else None

    pad = (-n) % tile
    qc = jnp.pad(coords, ((0, pad), (0, 0)), constant_values=3e18)
    qi = jnp.pad(jnp.arange(n, dtype=jnp.int32), (0, pad),
                 constant_values=-2)
    qbx = jnp.pad(bx, (0, pad), constant_values=-10 * (window + 1))
    qby = jnp.pad(by, (0, pad), constant_values=-10 * (window + 1))
    qt = jnp.pad(type_codes, (0, pad), constant_values=0)
    n_tiles = qc.shape[0] // tile

    # window offsets as a scanned array: a Python-unrolled (2w+1)² loop
    # inside tile-map inside the envelope draw-scan made XLA compile 25
    # copies of the gather+distance block (162 s compile at 500k); one
    # scanned offset step compiles once and costs nothing at runtime
    # (each step is thousands of rows of work)
    w1 = 2 * window + 1
    offsets = jnp.stack(
        [jnp.repeat(jnp.arange(-window, window + 1), w1),
         jnp.tile(jnp.arange(-window, window + 1), w1)], axis=1)

    def one_tile(args):
        q, qid, tbx, tby, qtype = args
        if n_types > 1:
            oh_q = jax.nn.one_hot(qtype, n_types, dtype=jnp.float32)

        def off_step(carry, off):
            counts, counts_t = carry
            gx = tbx + off[0]
            gy = tby + off[1]
            ok = (gx >= 0) & (gx < nbx) & (gy >= 0) & (gy < nby)
            b = jnp.where(ok, gx * nby + gy, 0)
            cand = table[b]                          # [T, C] ids
            cc = tcoords[b]                          # [T, C, 2]
            d2 = jnp.sum((q[:, None, :] - cc) ** 2, axis=-1)
            bad = (~ok[:, None]) | (cand == qid[:, None]) | (cand < 0)
            d2 = jnp.where(bad, jnp.inf, d2)
            within = (d2[None, :, :] <= radii_sq[:, None, None])  # [R,T,C]
            # int32 carry: f32 accumulation went inexact past 2^24 pairs
            # (large radii at N>=500k reach ~4e8 pairs per tile)
            counts = counts + jnp.sum(within, axis=(1, 2),
                                      dtype=jnp.int32)
            if n_types > 1:
                # pair_sum[r,a,b] = Σ_t Σ_c within[r,t,c]·1[q_t=a]·1[c_tc=b]
                oh_c = jax.nn.one_hot(ttypes[b], n_types, dtype=jnp.float32)
                m = jnp.einsum("rtc,tcb->rtb", within.astype(jnp.float32),
                               oh_c)
                counts_t = counts_t + jnp.einsum("ta,rtb->rab", oh_q, m)
            return (counts, counts_t), None

        # counts_t stays f32 (the one-hot einsums are matmuls); its
        # per-step partials are exact well past realistic per-pair counts
        init = (jnp.zeros((n_radii,), jnp.int32),
                jnp.zeros((n_radii, n_types, n_types), jnp.float32))
        (counts, counts_t), _ = jax.lax.scan(off_step, init, offsets)
        return counts, counts_t

    c, ct = jax.lax.map(one_tile, (qc.reshape(n_tiles, tile, 2),
                                   qi.reshape(n_tiles, tile),
                                   qbx.reshape(n_tiles, tile),
                                   qby.reshape(n_tiles, tile),
                                   qt.reshape(n_tiles, tile)))
    # exact cross-tile total without int64 (x64 is off by default): split each
    # per-tile int32 into hi/lo halves, sum exactly, recombine with ONE
    # f32 rounding (vs per-step rounding error before)
    hi = jnp.sum(c // 65536, axis=0).astype(jnp.float32)
    lo = jnp.sum(c % 65536, axis=0).astype(jnp.float32)
    return hi * 65536.0 + lo, ct.sum(axis=0)


class BucketGrid(NamedTuple):
    """Back-compat host-built grid (tests/callers outside the hot paths)."""
    table: jax.Array
    bx: jax.Array
    by: jax.Array
    nbx: int
    nby: int
    window: int


def build_bucket_grid(coords_np: np.ndarray, r_max: float,
                      target_window: int = 2,
                      bbox=None,
                      min_capacity: int = 0) -> BucketGrid:
    """Bucket cells on device so a (2w+1)² window covers pairs within r_max."""
    coords_np = np.asarray(coords_np, np.float32)
    spec = make_grid_spec(coords_np, r_max, target_window=target_window,
                          bbox=bbox)
    C = max(spec.capacity, min_capacity)
    table, bx, by, mc = _bin_points(
        jnp.asarray(coords_np), jnp.asarray(spec.mins),
        jnp.asarray(spec.span), spec.nbx, spec.nby, C)
    if int(mc) > C:
        raise ValueError(
            f"bucket capacity overflow: max occupancy {int(mc)} > {C}")
    return BucketGrid(table, bx, by, spec.nbx, spec.nby, spec.window)


def _counts_pass(coords_j, spec: GridSpec, radii_sq_j, codes_j, n_types,
                 mins_j, span_j):
    """One full pass: device binning + pair counts. Returns device arrays."""
    table, bx, by, mc = _bin_points(coords_j, mins_j, span_j,
                                    spec.nbx, spec.nby, spec.capacity)
    c, ct = _pair_counts(coords_j, table, bx, by, radii_sq_j, codes_j,
                         nbx=spec.nbx, nby=spec.nby, window=spec.window,
                         n_radii=radii_sq_j.shape[0], n_types=n_types)
    return c, ct, mc


# Envelope draws run as on-device scans: one dispatch per chunk of draws
# instead of 3+ dispatches per draw: each host-side dispatch pays launch
# latency, and a Python loop of draws keeps the host in the loop.
_ENVELOPE_CHUNK = 64


@functools.partial(jax.jit, static_argnames=("nbx", "nby", "window",
                                             "n_radii", "C", "n", "n_draws"))
def _csr_sim_counts(base_key, start, mins_full, span_full, mins, span,
                    radii_sq, nbx: int, nby: int, window: int, n_radii: int,
                    C: int, n: int, n_draws: int):
    """``n_draws`` CSR draws (uniform in the bbox) → counts [S, R], mc [S].

    Draw ``s`` uses ``fold_in(base_key, start + s)`` — bitwise identical to
    the per-draw ``key_for(seed, "ripley_csr", s)`` host loop it replaces.
    """
    codes0 = jnp.zeros(n, jnp.int32)

    def body(_, s):
        key = jax.random.fold_in(base_key, s.astype(jnp.uint32))
        sim = mins_full + jax.random.uniform(key, (n, 2)) * span_full
        table, bx, by, mc = _bin_points(sim, mins, span, nbx, nby, C)
        c, _ = _pair_counts(sim, table, bx, by, radii_sq, codes0,
                            nbx=nbx, nby=nby, window=window,
                            n_radii=n_radii, n_types=1)
        return None, (c, mc)

    _, (cs, mcs) = jax.lax.scan(
        body, None, start + jnp.arange(n_draws, dtype=jnp.uint32))
    return cs, mcs


@functools.partial(jax.jit, static_argnames=("nbx", "nby", "window",
                                             "n_radii", "n_types", "n",
                                             "n_draws"))
def _label_perm_counts(base_key, start, coords, table, bx, by, codes,
                       radii_sq, nbx: int, nby: int, window: int,
                       n_radii: int, n_types: int, n: int, n_draws: int):
    """``n_draws`` random-labeling passes → counts [S, R, T, T].

    Positions (and the bucket table) are fixed; each draw shuffles labels
    with ``fold_in(base_key, start + s)`` — same stream as the host loop.
    """

    def body(_, s):
        key = jax.random.fold_in(base_key, s.astype(jnp.uint32))
        cp = codes[jax.random.permutation(key, n)]
        _, ct = _pair_counts(coords, table, bx, by, radii_sq, cp,
                             nbx=nbx, nby=nby, window=window,
                             n_radii=n_radii, n_types=n_types)
        return None, ct

    _, cts = jax.lax.scan(
        body, None, start + jnp.arange(n_draws, dtype=jnp.uint32))
    return cts


def ripley_k(
    coords: np.ndarray,
    radii: np.ndarray,
    n_simulations: int = 0,
    seed: int = 0,
    area: Optional[float] = None,
) -> dict:
    """Univariate Ripley's K(r) (no edge correction) + CSR envelopes.

    K̂(r) = A·Σ_{i≠j} 1[d_ij ≤ r] / (n(n−1));  L(r) = sqrt(K/π).
    Envelopes simulate ``n_simulations`` uniform CSR point sets in the
    bounding box with counter-based keys; every draw (uniform sample,
    binning, pair counting) runs on device.
    """
    coords = np.asarray(coords, np.float32)
    if coords.shape[0] < 2:
        raise ValueError(
            f"Ripley's K needs >= 2 points, got {coords.shape[0]}")
    n = coords.shape[0]
    radii = np.asarray(radii, np.float32)
    r_max = float(radii.max())
    mins, maxs = coords.min(axis=0), coords.max(axis=0)
    if area is None:
        area = float(np.prod(np.maximum(maxs - mins, 1e-9)))

    # capacity slack 2× the observed max: covers CSR draws (uniform
    # occupancy tails are far below clustered observed data + slack)
    spec = make_grid_spec(coords, r_max, bbox=(mins, maxs),
                          capacity_slack=2.0)
    mins_j = jnp.asarray(spec.mins)
    span_j = jnp.asarray(spec.span)
    radii_sq_j = jnp.asarray(radii ** 2)
    codes0 = jnp.zeros(n, jnp.int32)
    norm = area / (n * (n - 1))

    coords_j = jnp.asarray(coords)
    c, _, mc = _counts_pass(coords_j, spec, radii_sq_j, codes0, 1,
                            mins_j, span_j)
    if int(mc) > spec.capacity:
        raise ValueError(
            f"bucket capacity overflow: {int(mc)} > {spec.capacity}")
    k_obs = norm * np.asarray(c)
    out = {"radii": radii, "K": k_obs,
           "L": np.sqrt(np.maximum(k_obs, 0) / np.pi)}

    if n_simulations > 0:
        span_full = jnp.asarray((maxs - mins).astype(np.float32))
        mins_full = jnp.asarray(mins)
        base_key = key_for(seed, "ripley_csr")
        sims_parts = []
        overflow = []
        for start in range(0, n_simulations, _ENVELOPE_CHUNK):
            nd = min(_ENVELOPE_CHUNK, n_simulations - start)
            # pad a TAIL chunk of a multi-chunk run to the full width:
            # n_draws is a static shape, so an odd remainder would compile
            # the heavy draw-scan twice;
            # surplus draws are valid CSR draws — computed and discarded
            nd_run = _ENVELOPE_CHUNK if n_simulations > _ENVELOPE_CHUNK \
                else nd
            cs, mcs = _csr_sim_counts(
                base_key, jnp.uint32(start), mins_full, span_full,
                mins_j, span_j, radii_sq_j, nbx=spec.nbx, nby=spec.nby,
                window=spec.window, n_radii=len(radii), C=spec.capacity,
                n=n, n_draws=nd_run)
            sims_parts.append(norm * np.asarray(cs)[:nd])
            overflow.append(int(np.asarray(mcs).max()))
        sims = np.concatenate(sims_parts, axis=0)
        bad = max(overflow)
        if bad > spec.capacity:   # pragma: no cover - slack makes this rare
            raise ValueError(
                f"CSR simulation bucket overflow: {bad} > {spec.capacity}; "
                "re-run with a larger capacity_slack")
        out["K_env_lo"] = np.quantile(sims, 0.025, axis=0)
        out["K_env_hi"] = np.quantile(sims, 0.975, axis=0)
        out["L_env_lo"] = np.sqrt(np.maximum(out["K_env_lo"], 0) / np.pi)
        out["L_env_hi"] = np.sqrt(np.maximum(out["K_env_hi"], 0) / np.pi)
        out["n_simulations"] = n_simulations
    return out


def co_occurrence_counts(
    coords: np.ndarray,
    type_codes: np.ndarray,
    n_types: int,
    radii: np.ndarray,
) -> np.ndarray:
    """Cumulative ordered pair counts per (radius, type_a, type_b).

    Shared kernel with cross-type K; callers turn these into conditional
    co-occurrence ratios or K estimates.
    """
    coords = np.asarray(coords, np.float32)
    radii = np.asarray(radii, np.float32)
    spec = make_grid_spec(coords, float(radii.max()))
    _, ct, mc = _counts_pass(
        jnp.asarray(coords), spec, jnp.asarray(radii ** 2),
        jnp.asarray(np.asarray(type_codes, np.int32)), n_types,
        jnp.asarray(spec.mins), jnp.asarray(spec.span))
    if int(mc) > spec.capacity:
        raise ValueError(
            f"bucket capacity overflow: {int(mc)} > {spec.capacity}")
    return np.asarray(ct)


def cross_type_k(
    coords: np.ndarray,
    type_codes: np.ndarray,
    n_types: int,
    radii: np.ndarray,
    n_permutations: int = 0,
    seed: int = 0,
    area: Optional[float] = None,
) -> dict:
    """Cross-type K_AB(r) for all type pairs + random-labeling envelopes.

    K̂_AB(r) = A·Σ_{i∈A, j∈B, i≠j} 1[d_ij ≤ r] / (n_A·n_B). The envelope
    permutes labels (positions fixed — binning happens once; each draw is
    one on-device label shuffle + counting pass), the standard null for
    attraction/segregation between cell types.
    """
    coords = np.asarray(coords, np.float32)
    type_codes = np.asarray(type_codes, np.int32)
    radii = np.asarray(radii, np.float32)
    n = coords.shape[0]
    r_max = float(radii.max())
    mins, maxs = coords.min(axis=0), coords.max(axis=0)
    if area is None:
        area = float(np.prod(np.maximum(maxs - mins, 1e-9)))
    n_per_type = np.bincount(type_codes, minlength=n_types).astype(np.float64)
    denom = np.outer(n_per_type, n_per_type)
    np.fill_diagonal(denom, n_per_type * (n_per_type - 1))
    denom = np.maximum(denom, 1.0)

    spec = make_grid_spec(coords, r_max, bbox=(mins, maxs))
    mins_j = jnp.asarray(spec.mins)
    span_j = jnp.asarray(spec.span)
    coords_j = jnp.asarray(coords)
    radii_sq_j = jnp.asarray(radii ** 2)
    codes_j = jnp.asarray(type_codes)

    # positions are fixed: bin once, count many
    table, bx, by, mc = _bin_points(coords_j, mins_j, span_j,
                                    spec.nbx, spec.nby, spec.capacity)
    if int(mc) > spec.capacity:
        raise ValueError(
            f"bucket capacity overflow: {int(mc)} > {spec.capacity}")

    def counts_for(codes):
        _, ct = _pair_counts(coords_j, table, bx, by, radii_sq_j, codes,
                             nbx=spec.nbx, nby=spec.nby, window=spec.window,
                             n_radii=len(radii), n_types=n_types)
        return np.asarray(ct)          # [R, T, T]

    k_obs = area * counts_for(codes_j) / denom[None]
    out = {"radii": radii, "K_cross": k_obs}

    if n_permutations > 0:
        base_key = key_for(seed, "ripley_labelperm")
        parts = []
        for start in range(0, n_permutations, _ENVELOPE_CHUNK):
            nd = min(_ENVELOPE_CHUNK, n_permutations - start)
            # tail padding: one compiled shape (same rationale as ripley_k)
            nd_run = _ENVELOPE_CHUNK if n_permutations > _ENVELOPE_CHUNK \
                else nd
            cts = _label_perm_counts(
                base_key, jnp.uint32(start), coords_j, table, bx, by,
                codes_j, radii_sq_j, nbx=spec.nbx, nby=spec.nby,
                window=spec.window, n_radii=len(radii), n_types=n_types,
                n=n, n_draws=nd_run)
            parts.append(area * np.asarray(cts)[:nd] / denom[None, None])
        sims = np.concatenate(parts, axis=0)
        out["K_cross_env_lo"] = np.quantile(sims, 0.025, axis=0)
        out["K_cross_env_hi"] = np.quantile(sims, 0.975, axis=0)
        out["n_permutations"] = n_permutations
    return out
