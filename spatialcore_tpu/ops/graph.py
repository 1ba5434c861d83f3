"""Fixed-degree spatial neighbor graphs — the device-side weights matrix.

The reference builds scipy CSR weight matrices via sklearn ball-trees
(reference ``spatial/autocorrelation.py:342-413``). Jitted
code wants static shapes, so our W is a fixed-degree structure (SURVEY.md §7
decision 1):

    neighbor_idx : int32[N, k]  — column indices per row
    neighbor_w   : f32[N, k]    — row-normalized weights (0 where invalid)
    valid        : bool[N, k]   — mask for radius graphs / padding

SpMV ( ``lag = W @ Z`` ) becomes a k-step gather + weighted sum that XLA
vectorizes and vmaps over genes; the same arrays shard over a device mesh
along the cell axis.

kNN search runs as a tiled all-pairs scan with a running top-k merge (exact,
O(N²) flops in dense tiles), or — for large N — a uniform-grid bucketed
search with identical results (exact for kNN in 2D as long as the search
window covers the kth-neighbor radius, which we verify and expand adaptively).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.logging import get_logger

logger = get_logger("ops.graph")


class SpatialGraph(NamedTuple):
    """Fixed-degree row-normalized spatial weights."""

    neighbor_idx: jax.Array  # int32 [N, k]
    neighbor_w: jax.Array    # float32 [N, k], rows sum to 1 (or 0 if isolated)
    valid: jax.Array         # bool [N, k]
    distances: jax.Array     # float32 [N, k], +inf where invalid

    @property
    def n_cells(self) -> int:
        return self.neighbor_idx.shape[0]

    @property
    def degree(self) -> int:
        return self.neighbor_idx.shape[1]

    def to_csr(self):
        """Export to scipy CSR (host-side), matching the reference's W."""
        import scipy.sparse as sp

        idx = np.asarray(self.neighbor_idx)
        w = np.asarray(self.neighbor_w)
        valid = np.asarray(self.valid)
        n, k = idx.shape
        rows = np.repeat(np.arange(n), k)[valid.ravel()]
        cols = idx.ravel()[valid.ravel()]
        data = w.ravel()[valid.ravel()]
        return sp.csr_matrix((data, (rows, cols)), shape=(n, n))


# ---------------------------------------------------------------------------
# Exact tiled kNN
# ---------------------------------------------------------------------------

def _pad_to(x: jax.Array, multiple: int, value) -> jax.Array:
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x
    pad_block = jnp.full((pad,) + x.shape[1:], value, dtype=x.dtype)
    return jnp.concatenate([x, pad_block], axis=0)


def _pad_to_np(x: np.ndarray, multiple: int, value) -> np.ndarray:
    """Host-side _pad_to for numpy inputs: eager jnp pads would cost one
    device dispatch PER OP in the host-side expansion rounds below."""
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x
    return np.concatenate(
        [x, np.full((pad,) + x.shape[1:], value, dtype=x.dtype)], axis=0)


@functools.partial(jax.jit, static_argnames=("k", "include_self", "tile_q", "tile_c"))
def knn_exact(
    coords: jax.Array,
    k: int,
    include_self: bool = False,
    tile_q: int = 1024,
    tile_c: int = 4096,
) -> Tuple[jax.Array, jax.Array]:
    """Exact k-nearest-neighbors by tiled all-pairs distance + running top-k.

    Returns ``(indices int32[N, k], distances f32[N, k])`` sorted ascending by
    distance. Self is excluded unless ``include_self`` (then it is the first
    neighbor at distance 0, matching the reference's ``start_col`` semantics,
    /root/reference/src/spatialcore/spatial/autocorrelation.py:397-400).
    """
    n, d = coords.shape
    if k >= n:
        raise ValueError(f"k={k} must be < n_cells={n}")
    coords = coords.astype(jnp.float32)
    # Centering improves f32 conditioning of squared distances.
    coords = coords - jnp.mean(coords, axis=0, keepdims=True)

    cpad = _pad_to(coords, tile_c, jnp.float32(3e18))
    n_cand_tiles = cpad.shape[0] // tile_c
    cand_tiles = cpad.reshape(n_cand_tiles, tile_c, d)

    qpad = _pad_to(coords, tile_q, jnp.float32(1e18))
    qidx_pad = _pad_to(jnp.arange(n, dtype=jnp.int32), tile_q, jnp.int32(-1))
    n_q_tiles = qpad.shape[0] // tile_q
    q_tiles = qpad.reshape(n_q_tiles, tile_q, d)
    qidx_tiles = qidx_pad.reshape(n_q_tiles, tile_q)

    def one_query_tile(q, qidx):
        # carry: best distances / indices per query, ascending
        init = (jnp.full((tile_q, k), jnp.inf, jnp.float32),
                jnp.full((tile_q, k), -1, jnp.int32))

        def body(carry, tile_i):
            best_d, best_i = carry
            cand = cand_tiles[tile_i]                   # [Tc, d]
            cand_ids = tile_i * tile_c + jnp.arange(tile_c, dtype=jnp.int32)
            # [Tq, Tc] squared distances, direct form for f32 accuracy
            dist = jnp.sum((q[:, None, :] - cand[None, :, :]) ** 2, axis=-1)
            in_range = cand_ids[None, :] < n
            if not include_self:
                in_range &= cand_ids[None, :] != qidx[:, None]
            dist = jnp.where(in_range, dist, jnp.inf)
            # merge with running best: top-k smallest of [k + Tc]
            all_d = jnp.concatenate([best_d, dist], axis=1)
            all_i = jnp.concatenate([best_i, jnp.broadcast_to(
                cand_ids[None, :], (tile_q, tile_c))], axis=1)
            neg_top, arg = jax.lax.top_k(-all_d, k)
            return (-neg_top, jnp.take_along_axis(all_i, arg, axis=1)), None

        (best_d, best_i), _ = jax.lax.scan(
            body, init, jnp.arange(n_cand_tiles, dtype=jnp.int32))
        return best_d, best_i

    best_d, best_i = jax.lax.map(
        lambda args: one_query_tile(*args), (q_tiles, qidx_tiles))
    best_d = best_d.reshape(-1, k)[:n]
    best_i = best_i.reshape(-1, k)[:n]
    return best_i, jnp.sqrt(best_d)


# ---------------------------------------------------------------------------
# Grid-bucketed kNN for large N (exact, adaptive window)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k", "r", "include_self"))
def _bucket_knn_round(q_coords, q_ids, qbx, qby, coords, table,
                      nbx, nby, k: int, r: int, include_self: bool):
    """Window-bucket kNN for all query tiles in ONE device dispatch.

    ``table`` is the padded bucket table [nbx*nby, C] of original cell ids
    (−1 pad); queries arrive pre-tiled as [n_tiles, T, …] and a ``lax.map``
    walks the tiles on device — no per-tile host round-trips. Each of the
    (2r+1)² window cells contributes one gather + distance block + running
    top-k merge.

    The candidate coordinates are pre-gathered once into a bucket-row table
    (``tcoords [nb, C, 2]``): fetching whole bucket rows per window offset
    replaces the per-candidate ``coords[cand]`` gather, which fetches C×
    more rows than needed (same layout as ops/ripley.py).
    """
    tcoords = jnp.where((table >= 0)[:, :, None],
                        coords[jnp.maximum(table, 0)], 1e18)

    def one_tile(args):
        qc, qi, bx_t, by_t = args
        tq = qc.shape[0]
        best_d = jnp.full((tq, k), jnp.inf, jnp.float32)
        best_i = jnp.full((tq, k), -1, jnp.int32)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                gx = bx_t + dx
                gy = by_t + dy
                ok = (gx >= 0) & (gx < nbx) & (gy >= 0) & (gy < nby)
                b = jnp.where(ok, gx * nby + gy, 0)
                cand = table[b]                          # [Tq, C] int32
                valid = (cand >= 0) & ok[:, None]
                if not include_self:
                    valid &= cand != qi[:, None]
                cc = tcoords[b]                          # [Tq, C, 2] rows
                d = jnp.sum((qc[:, None, :] - cc) ** 2, axis=-1)
                d = jnp.where(valid, d, jnp.inf)
                all_d = jnp.concatenate([best_d, d], axis=1)
                all_i = jnp.concatenate([best_i, cand], axis=1)
                neg, arg = jax.lax.top_k(-all_d, k)
                best_d = -neg
                best_i = jnp.take_along_axis(all_i, arg, axis=1)
        return best_d, best_i

    return jax.lax.map(one_tile, (q_coords, q_ids, qbx, qby))


@functools.partial(jax.jit, static_argnames=("cap", "bucket_target"))
def _grid_prep(coords, cap: int, bucket_target: int):
    """Fused bbox → grid dims → binning → bucket counts, one dispatch.

    The grid dimensions are data-dependent (bbox aspect), so they are
    computed as traced values and read back alongside the max bucket
    count in a SINGLE host transfer, so the fast path synchronizes with
    the device exactly once before the search. ``cap`` (a power of two
    derived from n alone)
    statically bounds the bucket count so ``bincount`` has a fixed shape.
    """
    n = coords.shape[0]
    mins = jnp.min(coords, axis=0)
    span = jnp.maximum(jnp.max(coords, axis=0) - mins, 1e-9)
    nbt = max(1, n // bucket_target)
    aspect = span[0] / span[1]
    nbx = jnp.floor(jnp.sqrt(nbt * aspect)).astype(jnp.int32)
    nbx = jnp.clip(nbx, 1, cap)
    nby = jnp.clip(nbt // nbx, 1, jnp.maximum(cap // nbx, 1))
    h = span / jnp.stack([nbx, nby]).astype(jnp.float32)
    bx = jnp.clip(jnp.floor((coords[:, 0] - mins[0]) / h[0]).astype(
        jnp.int32), 0, nbx - 1)
    by = jnp.clip(jnp.floor((coords[:, 1] - mins[1]) / h[1]).astype(
        jnp.int32), 0, nby - 1)
    bucket = bx * nby + by
    maxc = jnp.max(jnp.bincount(bucket, length=cap))
    return bx, by, bucket, maxc, nbx, nby, h


@functools.partial(jax.jit, static_argnames=("n_buckets", "C"))
def _bucket_table(bucket, n_buckets: int, C: int):
    """Padded bucket table [n_buckets, C] of cell ids (−1 pad), on device."""
    n = bucket.shape[0]
    order = jnp.argsort(bucket, stable=True).astype(jnp.int32)
    sb = bucket[order]
    counts = jnp.bincount(bucket, length=n_buckets)
    starts = (jnp.cumsum(counts) - counts).astype(jnp.int32)
    pos = jnp.arange(n, dtype=jnp.int32) - starts[sb]
    table = jnp.full((n_buckets, C), -1, jnp.int32)
    return table.at[sb, pos].set(order)


@functools.partial(jax.jit, static_argnames=("t",))
def _round0_tiles(coords, bx, by, t: int):
    """Pad + reshape all cells into [n_tiles, t, …] query tiles on device."""
    n = coords.shape[0]
    pad = (-n) % t
    q = jnp.pad(coords, ((0, pad), (0, 0)), constant_values=1e18)
    ids = jnp.pad(jnp.arange(n, dtype=jnp.int32), (0, pad),
                  constant_values=-2)
    bxp = jnp.pad(bx, (0, pad), constant_values=-10)
    byp = jnp.pad(by, (0, pad), constant_values=-10)
    nt = q.shape[0] // t
    return (q.reshape(nt, t, 2), ids.reshape(nt, t),
            bxp.reshape(nt, t), byp.reshape(nt, t))


@functools.partial(jax.jit, static_argnames=("k", "n"))
def _round0_post(bd, bi, g2, *, k: int, n: int):
    """Fused round-0 post-pass: slice off query-tile padding, take the
    distance sqrt, and compute the exactness mask + its all() in ONE
    program — op-by-op eager versions pay one compile and dispatch each
    on the first cold build. ``g2`` is the squared guaranteed-covered
    radius (inf when the 3x3 window already spans the whole grid)."""
    bd = bd.reshape(-1, k)[:n]
    bi = bi.reshape(-1, k)[:n]
    ok = bd[:, k - 1] <= g2
    return bd, bi, jnp.sqrt(bd), ok, jnp.all(ok)


def knn_grid(
    coords_np: np.ndarray,
    k: int,
    include_self: bool = False,
    bucket_target: int = 32,
    tile: int = 8192,
    max_rounds: int = 6,
    fallback_chunk: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Exact kNN via uniform-grid buckets with on-device window top-k.

    Returns ``(neighbor_idx, neighbor_dist)`` as **jax.Array** device
    arrays of shape [N, k] (int32 indices, float32 distances) — call
    ``np.asarray`` if numpy semantics (e.g. in-place writes) are needed.

    Binning, bucket-table construction, and all distance/top-k math run
    jit-compiled on device; the only host↔device traffic on the fast path
    (round 0 resolves everything — the common case) is a handful of scalar
    transfers (bbox, max bucket count, exactness mask). Accepts a device
    array directly, in which case coordinates are never downloaded unless
    a window-expansion round is needed. Each cell searches a (2r+1)²
    bucket window; cells whose kth-neighbor distance exceeds the window's
    guaranteed-covered radius re-run with a wider window (exactness
    check), so results equal the O(N²) scan.
    """
    import os
    import time as _time

    t_log = os.environ.get("SPATIALCORE_TIME_GRAPH") == "1"
    marks = [("start", _time.time())]

    def mark(name):
        if t_log:
            marks.append((name, _time.time()))

    if isinstance(coords_np, jax.Array) and not isinstance(
            coords_np, np.ndarray):
        coords_host = None
        coords_j = coords_np.astype(jnp.float32)
    else:
        coords_host = np.asarray(coords_np, dtype=np.float32)
        coords_j = jnp.asarray(coords_host)
    n, d = coords_j.shape
    if d != 2:
        raise ValueError("knn_grid currently supports 2D coordinates")
    if k >= n:
        raise ValueError(f"k={k} must be < n_cells={n}")

    # buckets must comfortably hold k candidates or the r=1 window can
    # never guarantee exactness and every query pays expansion rounds
    bucket_target = max(bucket_target, 2 * (k + 1))
    # fused prep; ONE data-dependent readback (grid dims + max count)
    cap = 1 << max(int(np.ceil(np.log2(max(1, n // bucket_target)))), 0)
    bx_j, by_j, bucket_j, maxc_j, nbx_j, nby_j, h_j = _grid_prep(
        coords_j, cap, bucket_target)
    mark("prep_enqueued")
    maxc, nbx, nby, h = jax.device_get((maxc_j, nbx_j, nby_j, h_j))
    nbx, nby = int(nbx), int(nby)
    mark("prep_readback")
    # pad the bucket capacity to a multiple of 16: the capacity is baked
    # into the jitted search's table shape, so an unpadded max-count
    # recompiles the search for every new coordinate draw (same pin as
    # the ripley bucket capacity)
    C = max(-(-int(maxc) // 16) * 16, 16)
    table_j = _bucket_table(bucket_j, cap, C)

    # round 0: everything on device, one dispatch
    t = min(tile, 1 << max(int(np.ceil(np.log2(max(n, 1)))), 6))
    qt, idt, bxt, byt = _round0_tiles(coords_j, bx_j, by_j, t)
    bd, bi = _bucket_knn_round(qt, idt, bxt, byt, coords_j, table_j,
                               jnp.int32(nbx), jnp.int32(nby),
                               k, 1, include_self)
    guaranteed = min(h[0], h[1])
    whole_grid = 3 >= 2 * max(nbx, nby) + 1
    # ONE fused post-pass program (slice + sqrt + exactness mask + all):
    # eager op-by-op versions of these cost one compile EACH on the first
    # cold build
    g2 = jnp.float32(np.inf if whole_grid else guaranteed ** 2)
    bd, bi, dist, ok_j, allok_j = _round0_post(bd, bi, g2, k=k, n=n)
    mark("round0_enqueued")
    # fast path reads ONE byte (all-resolved flag); the per-cell mask
    # (1 MB at 1M cells) crosses to host only when expansion rounds are
    # actually needed, and the [N, k]
    # results never do (a 56MB/1M-cell round-trip otherwise)
    all_ok = True if whole_grid else bool(allok_j)
    mark("round0_done")
    if t_log:
        logger.info("knn_grid stages: " + " ".join(
            f"{nm}={t1 - t0:.2f}s" for (nm, t1), (_, t0)
            in zip(marks[1:], marks)))
    if all_ok:
        return bi, dist                      # common case: all resolved
    ok = np.asarray(ok_j)

    # expansion rounds: materialize host state once, then compact on host
    if coords_host is None:
        coords_host = np.asarray(coords_j)
    bx32 = np.asarray(bx_j)
    by32 = np.asarray(by_j)
    out_idx = np.full((n, k), -1, np.int32)
    out_dist = np.full((n, k), np.inf, np.float32)
    dist_r = np.asarray(bd)
    idx_r = np.asarray(bi)
    out_idx[ok] = idx_r[ok]
    out_dist[ok] = dist_r[ok]
    unresolved = np.nonzero(~ok)[0]
    r = 2
    for _ in range(1, max_rounds):
        if unresolved.size == 0:
            break
        nq = unresolved.size
        t = min(tile, 1 << max(int(np.ceil(np.log2(max(nq, 1)))), 6))
        # host-side padding: eager device pads cost one dispatch per op
        q_pad = _pad_to_np(coords_host[unresolved], t, np.float32(1e18))
        id_pad = _pad_to_np(unresolved.astype(np.int32), t, np.int32(-2))
        bx_pad = _pad_to_np(bx32[unresolved], t, np.int32(-10))
        by_pad = _pad_to_np(by32[unresolved], t, np.int32(-10))
        n_tiles = q_pad.shape[0] // t
        bd, bi = _bucket_knn_round(
            jnp.asarray(q_pad).reshape(n_tiles, t, 2),
            jnp.asarray(id_pad).reshape(n_tiles, t),
            jnp.asarray(bx_pad).reshape(n_tiles, t),
            jnp.asarray(by_pad).reshape(n_tiles, t),
            coords_j, table_j, jnp.int32(nbx), jnp.int32(nby),
            k, r, include_self)
        bd = bd.reshape(-1, k)[:nq]
        bi = bi.reshape(-1, k)[:nq]
        guaranteed = r * min(h[0], h[1])
        whole_grid = 2 * r + 1 >= 2 * max(nbx, nby) + 1
        ok = (np.ones(nq, bool) if whole_grid
              else np.asarray(bd[:, k - 1] <= guaranteed ** 2))
        dist_r = np.asarray(bd)
        idx_r = np.asarray(bi)
        done = unresolved[ok]
        out_idx[done] = idx_r[ok]
        out_dist[done] = dist_r[ok]
        unresolved = unresolved[~ok]
        r *= 2
    if unresolved.size:
        # pathological remainder: exact scan for those queries only,
        # chunked so the dense [chunk, N] distance block stays bounded
        # (heavy-tailed densities can leave many cells unresolved after
        # max_rounds; an unchunked [n_unresolved, N] f64 matrix at 1M
        # cells would be tens of GB of host RAM)
        chunk = fallback_chunk or max(1, (1 << 28) // n)  # ~256M f32 elems
        for c0 in range(0, unresolved.size, chunk):
            urc = unresolved[c0:c0 + chunk]
            dd = ((coords_host[urc][:, None, :]
                   - coords_host[None, :, :]) ** 2).sum(-1)
            if not include_self:
                dd[np.arange(urc.size), urc] = np.inf
            part = np.argpartition(dd, k - 1, axis=1)[:, :k]
            pd_ = np.take_along_axis(dd, part, axis=1)
            o = np.argsort(pd_, axis=1)
            out_idx[urc] = np.take_along_axis(part, o, axis=1)
            out_dist[urc] = np.take_along_axis(pd_, o, axis=1)
    return jnp.asarray(out_idx), jnp.sqrt(jnp.asarray(out_dist))


# ---------------------------------------------------------------------------
# Radius neighbors (capped degree, fail-loud on overflow)
# ---------------------------------------------------------------------------

def radius_neighbors(
    coords: jax.Array,
    radius: float,
    k_max: int,
    include_self: bool = False,
    grid_threshold: int = 20_000,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Neighbors within ``radius``, capped at ``k_max`` per cell.

    Returns ``(indices, distances, valid)``. Raises if any cell has more than
    ``k_max`` in-radius neighbors (static shapes need a cap; the cap is
    checked loudly rather than silently truncating — mirroring the
    reference's fail-loud empty-neighborhood policy,
    /root/reference/src/spatialcore/spatial/neighborhoods.py:253-260).
    Large 2D inputs route through the bucket-grid kNN instead of the
    O(N²) scan.
    """
    if not (isinstance(coords, jax.Array)
            and not isinstance(coords, np.ndarray)):
        # list/f64 inputs: coerce like build_graph (keeps the public ops
        # export accepting plain sequences and pins the compute dtype)
        coords = np.asarray(coords, dtype=np.float32)
    n = coords.shape[0]
    # the cap is a capacity, not a requirement: small datasets simply can't
    # have k_max neighbors, so clamp (validity masking handles the rest).
    # Search ONE extra neighbor so "exactly k_max in radius" (a valid,
    # complete result) is distinguishable from a true overflow — checking
    # the k_max-th neighbor itself false-positived on exact-k_max cells.
    if min(k_max, n - 1) < 1:
        raise ValueError(f"radius_neighbors needs >= 2 cells, got {n}")
    k_search = min(k_max + 1, n - 1)
    if n > grid_threshold and coords.shape[1] == 2:
        idx, dist = knn_grid(coords, k_search, include_self=include_self)
        idx, dist = jnp.asarray(idx), jnp.asarray(dist)
    else:
        idx, dist = knn_exact(jnp.asarray(coords), k_search,
                              include_self=include_self)
    if k_search > min(k_max, n - 1):
        overflow = np.asarray(dist[:, k_max] <= radius)
        if overflow.any():
            n_over = int(overflow.sum())
            raise ValueError(
                f"{n_over} cells have more than k_max={k_max} neighbors "
                f"within radius={radius}. Increase k_max (or reduce "
                f"radius).")
        idx, dist = idx[:, :k_max], dist[:, :k_max]
    valid = dist <= radius
    idx = jnp.where(valid, idx, -1)
    dist = jnp.where(valid, dist, jnp.inf)
    return idx, dist, valid


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def build_graph(
    coords,
    n_neighbors: int = 6,
    include_self: bool = False,
    radius: Optional[float] = None,
    k_max: Optional[int] = None,
    method: str = "auto",
    grid_threshold: int = 20_000,
) -> SpatialGraph:
    """Build a row-normalized fixed-degree spatial weights graph.

    kNN mode (default) reproduces the reference's ``build_spatial_weights``:
    binary adjacency over the k nearest neighbors (self excluded unless
    ``include_self``, which adds self as an extra neighbor), rows normalized
    to sum to 1. Radius mode caps degree at ``k_max`` with a validity mask.

    ``coords`` may be a device array; the grid path then runs fully
    on-device with no bulk host↔device transfers.

    ``method`` picks the kNN search: ``"grid"`` (bucketed, 2D), ``"exact"``
    (tiled all-pairs) or ``"auto"`` (grid above ``grid_threshold`` cells
    in 2D, exact otherwise); any other value raises ``ValueError``.
    """
    if method not in ("auto", "grid", "exact"):
        raise ValueError(f"method must be 'auto', 'grid' or 'exact', got "
                         f"{method!r}")
    if not (isinstance(coords, jax.Array)
            and not isinstance(coords, np.ndarray)):
        coords = np.asarray(coords, dtype=np.float32)
    n = coords.shape[0]
    if radius is not None:
        if k_max is None:
            raise ValueError("radius mode requires k_max")
        idx, dist, valid = radius_neighbors(coords, radius, k_max, include_self)
    else:
        k_eff = n_neighbors + (1 if include_self else 0)
        use_grid = (method == "grid") or (
            method == "auto" and n > grid_threshold and coords.shape[1] == 2)
        if use_grid:
            idx_np, dist_np = knn_grid(coords, k_eff, include_self=include_self)
            idx, dist = jnp.asarray(idx_np), jnp.asarray(dist_np)
        else:
            idx, dist = knn_exact(jnp.asarray(coords), k_eff,
                                  include_self=include_self)
        # kNN rows are all-valid with uniform 1/k weights — ONE fused
        # program instead of the generic eager mask/normalize chain below
        idx, w, valid = _uniform_graph_arrays(idx, k=k_eff)
        return SpatialGraph(neighbor_idx=idx, neighbor_w=w,
                            valid=valid, distances=dist)

    counts = jnp.sum(valid, axis=1)
    w = jnp.where(valid, 1.0, 0.0) / jnp.maximum(counts, 1)[:, None]
    idx = jnp.where(valid, idx, 0).astype(jnp.int32)  # safe gather index
    return SpatialGraph(neighbor_idx=idx, neighbor_w=w.astype(jnp.float32),
                        valid=valid, distances=dist)


@functools.partial(jax.jit, static_argnames=("k",))
def _uniform_graph_arrays(idx, *, k: int):
    """int32 indices + uniform 1/k weights + all-true mask, one program."""
    return (idx.astype(jnp.int32),
            jnp.full(idx.shape, 1.0 / k, jnp.float32),
            jnp.ones(idx.shape, bool))


# ---------------------------------------------------------------------------
# SpMV: lag = W @ Z  (gather + weighted sum, vmappable and shardable)
# ---------------------------------------------------------------------------

def spatial_lag(graph: SpatialGraph, Z: jax.Array) -> jax.Array:
    """Compute ``W @ Z`` for Z of shape [N] or [N, G].

    Unrolls over the small static degree k: k gathers of [N(, G)] rows each.
    For large N·G an ``optimization_barrier`` sequences the per-neighbor
    accumulation — otherwise XLA batches the k gathers into one [N, k, G]
    temp (k·|Z| bytes), which OOMs at 1M cells × thousands of genes.
    """
    squeeze = Z.ndim == 1
    if squeeze:
        Z = Z[:, None]
    k = graph.neighbor_idx.shape[1]
    sequence = Z.shape[0] * Z.shape[1] > 50_000_000
    lag = jnp.zeros_like(Z)
    for j in range(k):
        lag = lag + graph.neighbor_w[:, j:j + 1] * Z[graph.neighbor_idx[:, j]]
        if sequence:
            lag = jax.lax.optimization_barrier(lag)
    return lag[:, 0] if squeeze else lag


def graph_moments(graph: SpatialGraph) -> dict:
    """S0, S1, S2 — the Cliff-Ord weight sums used by analytic variances.

    S0 = ΣΣ w_ij ;  S1 = ½ ΣΣ (w_ij + w_ji)² ;  S2 = Σ_i (w_i· + w_·i)².
    Computed host-side from the CSR export (one-time, O(nnz)).
    """
    W = graph.to_csr().astype(np.float64)   # f64 accumulation: f32 sums
    Wt = W.T.tocsr()                        # cost ~6e-8 relative on S0,
    S0 = float(W.sum())                     # visible in analytic z at 1e-8
    sym = (W + Wt)
    S1 = 0.5 * float(sym.multiply(sym).sum())
    row = np.asarray(W.sum(axis=1)).ravel()
    col = np.asarray(W.sum(axis=0)).ravel()
    S2 = float(((row + col) ** 2).sum())
    return {"S0": S0, "S1": S1, "S2": S2, "n": W.shape[0]}
