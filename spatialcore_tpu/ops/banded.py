"""Banded permutation-null engine: dense-band global and local nulls.

A kNN spatial lag is a gather per neighbour. This module changes the
access pattern instead of the gather implementation:

1. Relabel cells along a Hilbert space-filling curve (or Cuthill-McKee on the
   graph when no coordinates exist). kNN edges become near-diagonal: with a
   block size B, all but a few percent of edges connect cells within one
   block of each other.
2. Per permutation draw, the only random-access step left is ONE row gather
   ``Zp = Z[perm]`` (the permuted values have no locality by construction).
   The permutation itself comes from a sort-free Feistel bijection
   (``core.rng.feistel_permutation``) evaluated at the gathered row indices,
   so no ``[n]`` permutation is ever sorted or materialized.
3. The quadratic form Σ_e w_e·Zp[i_e]·Zp[j_e] is evaluated with dense
   BATCHED matmuls: the in-band adjacency is expanded once per call to a
   block-banded tensor A[nb, B, 3B] (three B-wide slabs: previous / self /
   next block), and the spatial lag of every block is three einsum
   contractions against block-shifted views of Zp — matrix-unit work with
   no sequential loop over blocks. Sparse-as-dense trades ~(3B/k)×
   redundant FLOPs for fully sequential memory traffic.
4. The few percent of out-of-band edges are handled exactly through a
   compacted, zero-padded edge list with plain gathers.

Geary's C rides the same kernel: Σ w (a−b)² = Σ (r_i+c_i)·zp_i² − 2·cross,
with row/col weight sums precomputed (permutation-invariant structure).

The int8 and int4 null systems quantize z per gene and the band weights
per row, so every band product is an exact s8×s8→s32 dot
(``_band_lag_i32``); the draws compare against the observed value of the
SAME quantized operator.

Replaces the hot loop of the reference's squidpy delegation
(/root/reference/src/spatialcore/spatial/autocorrelation.py:563-583) at
1M-cell scale. Estimator conventions identical to ops/moran.py.

Determinism: block size is baked into the plan; contraction order is
independent of device count (gene sharding splits columns only), per
CLAUDE.md's bitwise rule. With ``perm_method="sort"`` the draws use the SAME
counter-based keys as ``permutation_test_global`` (purpose "perm_global"), so
both paths shuffle identically and differ only in floating-point summation
order; the default "feistel" stream is its own seeded, reproducible sequence.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.logging import get_logger
from ..core.rng import feistel_apply, key_for
from .graph import SpatialGraph

logger = get_logger("ops.banded")


# ---------------------------------------------------------------------------
# Orderings
# ---------------------------------------------------------------------------


def hilbert_order(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Cell ordering along a Hilbert curve (vectorized xy2d, 2D only).

    Returns ``order`` such that ``coords[order]`` walks the curve. Ties
    (same grid cell) break by original index (stable argsort) — the
    ordering is a pure function of the coordinates.
    """
    coords = np.asarray(coords, np.float64)
    if coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError("hilbert_order requires [N, 2] coordinates")
    mins = coords.min(axis=0)
    span = np.maximum(coords.max(axis=0) - mins, 1e-12)
    side = (1 << bits) - 1
    x = np.minimum((coords[:, 0] - mins[0]) / span[0] * (side + 1), side)
    y = np.minimum((coords[:, 1] - mins[1]) / span[1] * (side + 1), side)
    x = x.astype(np.uint64)
    y = y.astype(np.uint64)
    d = np.zeros(coords.shape[0], np.uint64)
    s = np.uint64(1) << np.uint64(bits - 1)
    one = np.uint64(1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        # rotate quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = np.where(flip, s - one - x, x)
        y_f = np.where(flip, s - one - y, y)
        x, y = np.where(swap, y_f, x_f), np.where(swap, x_f, y_f)
        s >>= one
    return np.argsort(d, kind="stable").astype(np.int32)


def graph_order(graph: SpatialGraph) -> np.ndarray:
    """Bandwidth-minimizing order from the graph alone (reverse Cuthill-McKee).

    Fallback when no 2D coordinates are available (e.g. precomputed graphs).
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csr = graph.to_csr()
    sym = csr + csr.T
    return np.asarray(reverse_cuthill_mckee(sym.tocsr(), symmetric_mode=True),
                      np.int32)


@functools.partial(jax.jit, static_argnames=("bits",))
def _hilbert_rank_device(coords, bits: int = 16):
    """On-device Hilbert ordering (uint32 xy2d; bits=16 fills uint32).

    Mirrors :func:`hilbert_order` (which normalizes in float64 on host);
    float32 quantization may bucket boundary-straddling cells differently,
    but the banded null's draw values are ordering-invariant by
    construction (``perm = raw[order]`` gives cell ``i`` the value
    ``Z[raw[i]]`` whatever the relabeling), so plans built on either path
    agree to float32 accumulation order.
    """
    n = coords.shape[0]
    mins = jnp.min(coords, axis=0)
    span = jnp.maximum(jnp.max(coords, axis=0) - mins, 1e-12)
    side = (1 << bits) - 1
    x = jnp.minimum((coords[:, 0] - mins[0]) / span[0] * (side + 1),
                    side).astype(jnp.uint32)
    y = jnp.minimum((coords[:, 1] - mins[1]) / span[1] * (side + 1),
                    side).astype(jnp.uint32)
    d = jnp.zeros(n, jnp.uint32)
    for level in range(bits - 1, -1, -1):
        s = jnp.uint32(1 << level)
        rx = ((x & s) > 0).astype(jnp.uint32)
        ry = ((y & s) > 0).astype(jnp.uint32)
        d = d + s * s * ((jnp.uint32(3) * rx) ^ ry)
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = jnp.where(flip, s - 1 - x, x)
        y_f = jnp.where(flip, s - 1 - y, y)
        x, y = jnp.where(swap, y_f, x_f), jnp.where(swap, x_f, y_f)
    order = jnp.argsort(d, stable=True).astype(jnp.int32)
    rank = jnp.zeros(n, jnp.int32).at[order].set(
        jnp.arange(n, dtype=jnp.int32))
    return order, rank


@functools.partial(jax.jit, static_argnames=("block",))
def _plan_relabel(idx, w, order, rank, block: int):
    """Relabel edges into new positions; band split + Geary terms."""
    n, k = idx.shape
    idx_r = rank[idx[order]]                    # [N, k] int32 new positions
    w_r = w[order]
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    ws = (rows // block - 1) * block
    rel = idx_r - ws
    valid = w_r > 0
    inwin = (rel >= 0) & (rel < 3 * block) & valid
    far = valid & ~inwin
    local_idx = jnp.where(inwin, rel, 0).astype(jnp.int32)
    w_local = jnp.where(inwin, w_r, 0.0).astype(jnp.float32)
    r = w_r.sum(axis=1)
    c = jnp.zeros(n, jnp.float32).at[idx_r.reshape(-1)].add(
        jnp.where(valid, w_r, 0.0).reshape(-1))
    rc = (r + c).astype(jnp.float32)
    n_pad = (-n) % block
    if n_pad:
        local_idx = jnp.pad(local_idx, ((0, n_pad), (0, 0)))
        w_local = jnp.pad(w_local, ((0, n_pad), (0, 0)))
        rc = jnp.pad(rc, (0, n_pad))
    return idx_r, w_r, far, jnp.sum(far), local_idx, w_local, rc


@functools.partial(jax.jit, static_argnames=("block", "cap"))
def _plan_far(idx_r, w_r, far, block: int, cap: int):
    """Compact the far-edge list to a static power-of-two capacity."""
    n_far = jnp.sum(far)
    fi, fj = jnp.nonzero(far, size=cap, fill_value=0)   # row-major
    live = jnp.arange(cap) < n_far
    far_src = jnp.where(live, fi + block, 0).astype(jnp.int32)
    far_dst = jnp.where(live, idx_r[fi, fj] + block, 0).astype(jnp.int32)
    far_w = jnp.where(live, w_r[fi, fj], 0.0).astype(jnp.float32)
    return far_src, far_dst, far_w


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


class NullPlan(NamedTuple):
    """Relabeled, band-split graph structure for the banded null kernel.

    Index arrays live in *new-order* coordinates. ``local_idx`` is relative
    to each row's 3-block window start (b−1)·B ∈ [0, 3B); far-edge indices
    carry a +B offset into the front-padded ``Zp`` buffer.
    """

    order: jax.Array        # int32 [N] — original index at each new position
    local_idx: jax.Array    # int32 [Npad, k] — window-relative neighbor pos
    w_local: jax.Array      # f32 [Npad, k] — weight (0 where far/invalid/pad)
    far_src: jax.Array      # int32 [F] — padded-coords row of far-edge source
    far_dst: jax.Array      # int32 [F]
    far_w: jax.Array        # f32 [F] (0 = padding)
    rc_sum: jax.Array       # f32 [Npad] — row+col weight sums (Geary terms)
    block: int              # B (static); the band covers ±B positions
    n: int                  # true cell count (static)
    rank: jax.Array = None  # int32 [N] — new position of each original cell

    @property
    def n_padded(self) -> int:
        return self.local_idx.shape[0]


def build_null_plan(
    graph: SpatialGraph,
    coords: Optional[np.ndarray] = None,
    block: int = 256,
) -> NullPlan:
    """Prep: relabel cells, split edges into band vs far list.

    The band covers neighbor offsets within ±block positions (window =
    previous/self/next block). Larger blocks lower the far fraction but
    raise the dense-matmul FLOPs and A traffic ∝ B; at B=128 about 6% of
    kNN-6 edges fall outside the band. 256 is the default.

    Pass ``coords`` as a DEVICE array to build the whole plan on device
    (one 4-byte readback; no bulk host↔device transfers). A numpy
    ``coords`` keeps the host path (float64 Hilbert quantization).
    """
    if (coords is not None and isinstance(coords, jax.Array)
            and not isinstance(coords, np.ndarray) and coords.ndim == 2
            and coords.shape[1] == 2):
        n, k = graph.neighbor_idx.shape
        order, rank = _hilbert_rank_device(coords.astype(jnp.float32))
        idx_r, w_r, far, n_far_t, local_idx, w_local, rc = _plan_relabel(
            graph.neighbor_idx, graph.neighbor_w.astype(jnp.float32),
            order, rank, block)
        n_far = int(n_far_t)                    # the ONE readback
        logger.info(
            f"null plan (device): N={n:,} k={k} block={block} "
            f"far_edges={n_far:,} ({n_far / (n * k):.2%})")
        cap = 1 << max(int(np.ceil(np.log2(max(n_far, 1)))), 7)
        far_src, far_dst, far_w = _plan_far(idx_r, w_r, far, block, cap)
        return NullPlan(order=order, local_idx=local_idx, w_local=w_local,
                        far_src=far_src, far_dst=far_dst, far_w=far_w,
                        rc_sum=rc, block=block, n=n, rank=rank)

    idx = np.asarray(graph.neighbor_idx)
    w = np.asarray(graph.neighbor_w, np.float32)
    n, k = idx.shape
    if coords is not None and np.asarray(coords).shape[1] == 2:
        order = hilbert_order(np.asarray(coords))
    else:
        order = graph_order(graph)
    rank = np.empty(n, np.int32)
    rank[order] = np.arange(n, dtype=np.int32)

    idx_r = rank[idx[order]].astype(np.int64)   # [N, k] neighbor new-positions
    w_r = w[order]                              # [N, k]
    rows = np.arange(n, dtype=np.int64)[:, None]
    ws = (rows // block - 1) * block            # window start (b−1)·B
    rel = idx_r - ws
    valid = w_r > 0
    inwin = (rel >= 0) & (rel < 3 * block) & valid
    far = valid & ~inwin
    n_far = int(far.sum())
    logger.info(
        f"null plan: N={n:,} k={k} block={block} "
        f"far_edges={n_far:,} ({n_far / max(valid.sum(), 1):.2%})")

    local_idx = np.where(inwin, rel, 0).astype(np.int32)
    w_local = np.where(inwin, w_r, 0.0).astype(np.float32)

    # far list in padded coordinates (+block front pad of Zp)
    fi, fj = np.nonzero(far)                    # row-major: deterministic
    far_src = (fi + block).astype(np.int32)
    far_dst = (idx_r[fi, fj] + block).astype(np.int32)
    far_wv = w_r[fi, fj].astype(np.float32)
    cap = 1 << max(int(np.ceil(np.log2(max(n_far, 1)))), 7)
    pad = cap - n_far
    far_src = np.pad(far_src, (0, pad))
    far_dst = np.pad(far_dst, (0, pad))
    far_wv = np.pad(far_wv, (0, pad))

    # Geary structure terms: r_i = Σ_j w_ij, c_q = Σ_{i→q} w (new coords)
    r = w_r.sum(axis=1)
    c = np.zeros(n, np.float64)
    np.add.at(c, idx_r[valid], w_r[valid])
    rc = (r + c).astype(np.float32)

    n_pad = (-n) % block
    if n_pad:
        local_idx = np.pad(local_idx, ((0, n_pad), (0, 0)))
        w_local = np.pad(w_local, ((0, n_pad), (0, 0)))
        rc = np.pad(rc, (0, n_pad))

    return NullPlan(
        order=jnp.asarray(order),
        local_idx=jnp.asarray(local_idx),
        w_local=jnp.asarray(w_local),
        far_src=jnp.asarray(far_src),
        far_dst=jnp.asarray(far_dst),
        far_w=jnp.asarray(far_wv),
        rc_sum=jnp.asarray(rc),
        block=block,
        n=n,
        rank=jnp.asarray(rank),
    )


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


def _build_band(local_idx, w_local, block: int, dtype):
    """Expand [Npad, k] (idx, w) into the dense band tensor A[nb, B, 3B].

    Loop-invariant across draws: built once per call, reused by every
    permutation. Any window column that could alias a pad row carries
    weight 0, so pad values never contribute.
    """
    nb = local_idx.shape[0] // block
    k = local_idx.shape[1]
    li3 = local_idx.reshape(nb, block, k)
    lw3 = w_local.reshape(nb, block, k)
    iota = jnp.arange(3 * block, dtype=jnp.int32)[None, None, :]
    A = jnp.zeros((nb, block, 3 * block), dtype)
    zero = jnp.zeros((), dtype)
    for j in range(k):
        A = A + jnp.where(iota == li3[:, :, j:j + 1],
                          lw3[:, :, j:j + 1].astype(dtype), zero)
    return A


# ---------------------------------------------------------------------------
# int8 / int4 null modes: z quantized per gene, band weights per row, so
# every band product is an exact integer dot and each gathered row moves
# one byte (int8) or half a byte (int4) per gene.
# ---------------------------------------------------------------------------


def _quantize_z(Z, clip: float = 8.0):
    """Per-gene symmetric int8 quantization of standardized values.

    scale s_g = min(max|z_g|, clip)/127; values beyond ±clip·σ saturate
    (rare spiky genes only — keeps the quantization step ≤ clip/127 ≈
    0.063σ instead of letting one outlier coarsen the whole gene).
    Products z_qi·z_qj are EXACT integers; one s_g² factor converts the
    accumulated cross term back to z units.
    """
    Zf = Z.astype(jnp.float32)
    s = jnp.minimum(jnp.max(jnp.abs(Zf), axis=0), clip) / 127.0
    s = jnp.where(s > 0, s, 1.0)
    Zq = jnp.clip(jnp.round(Zf / s), -127, 127).astype(jnp.int8)
    return Zq, s


def _quantize_z4(Z, clip: float = 8.0):
    """Per-gene symmetric int4 quantization, NIBBLE-PACKED two genes/byte.

    Packing halves the bytes of both the resident table and the per-draw
    row gather. Codes c = clip(round(z/s), -7, 7) with
    s = min(max|z|, clip)/7; gene j (j < G/2) lives in the HIGH nibble of
    packed column j and gene j + G/2 in the LOW nibble (split-half
    layout: unpack + concat restores natural gene order). Bytes store
    (c+8) nibbles — in-range bit patterns regardless of int8 sign
    interpretation.

    G must be even. Returns ``(Zpk int8 [N, G//2], s f32 [G])``.
    """
    codes, s = _quantize_z4_codes(Z, clip)
    return _pack_codes(codes), s


def _quantize_z4_codes(Z, clip: float = 8.0):
    """int4 codes WITHOUT packing: (codes int8 in [-7, 7], s f32).

    Chunked preps (bench.py, ops/streaming.py) quantize gene chunks
    independently and pack afterwards with :func:`_pack_codes` — the
    split-half pairing must span the FULL tile, not each chunk, or the
    unpacked gene order would interleave chunks.
    """
    Zf = Z.astype(jnp.float32)
    s = jnp.minimum(jnp.max(jnp.abs(Zf), axis=0), clip) / 7.0
    s = jnp.where(s > 0, s, 1.0)
    return jnp.clip(jnp.round(Zf / s), -7, 7).astype(jnp.int8), s


def _pack_codes(codes, lo=None):
    """Pack int4 codes into split-half nibble bytes — the inverse of
    :func:`_unpack_nibbles`.

    One-arg form: codes [N, G] (G even) -> [N, G//2] with gene j in the
    HIGH nibble of packed column j and gene j + G//2 in the LOW nibble.
    Two-arg form: ``_pack_codes(hi, lo)`` packs two same-shape code
    blocks directly (chunked preps pair half-offset chunks without
    concatenating the full-width code matrix). All arithmetic stays in
    int8 — an int32 widen would be a 4x [N, G] temp (16 GB at 1M x 4096).
    """
    if lo is None:
        G = codes.shape[-1]
        if G % 2:
            raise ValueError(
                f"int4 packing needs an even gene count, got {G}")
        hi, lo = codes[..., :G // 2], codes[..., G // 2:]
    else:
        hi = codes
        if hi.shape != lo.shape:
            raise ValueError(f"hi/lo shape mismatch: {hi.shape} vs "
                             f"{lo.shape}")
    h8 = (hi.astype(jnp.int8) + jnp.int8(8)) << 4   # wraps >127: bit-exact
    return h8 | (lo.astype(jnp.int8) + jnp.int8(8))


def _unpack_nibbles(Zpk):
    """int8 packed [..., Gp2] -> int8 codes [..., 2*Gp2], natural order.

    Arithmetic-shift + mask reads the nibble bit patterns correctly for
    any int8 sign; the -8 offset restores signed codes in [-7, 7].
    """
    hi = ((Zpk >> 4) & jnp.int8(15)) - jnp.int8(8)
    lo = (Zpk & jnp.int8(15)) - jnp.int8(8)
    return jnp.concatenate([hi, lo], axis=-1)


def _build_band_i8(local_idx, w_local, block: int, row_scale=None):
    """Band tensor in int8 with a PER-ROW weight scale.

    sw[n, b] = rowmax/127, A8 = round(w/sw): for the common row-normalized
    kNN case (k equal weights) every entry quantizes to exactly 127 —
    the band weights are then EXACT. int32 accumulation is overflow-safe:
    K=3B=768 terms × 127³ ≈ 1.57e9 < 2³¹.

    ``row_scale`` ([nb, B, 1], optional) overrides the band-local rowmax
    scale — the fully-integer operators pass the FULL-row max (including
    far edges) so far weights quantize without clipping.
    """
    nb = local_idx.shape[0] // block
    k = local_idx.shape[1]
    li3 = local_idx.reshape(nb, block, k)
    lw3 = w_local.reshape(nb, block, k).astype(jnp.float32)
    if row_scale is None:
        rowmax = jnp.max(lw3, axis=2, keepdims=True)        # [nb, B, 1]
        sw = jnp.where(rowmax > 0, rowmax / 127.0, 1.0)
    else:
        sw = row_scale
    wq = jnp.clip(jnp.round(lw3 / sw), 0, 127).astype(jnp.int8)
    iota = jnp.arange(3 * block, dtype=jnp.int32)[None, None, :]
    A = jnp.zeros((nb, block, 3 * block), jnp.int8)
    zero = jnp.zeros((), jnp.int8)
    for j in range(k):
        A = A + jnp.where(iota == li3[:, :, j:j + 1],
                          wq[:, :, j:j + 1], zero)
    return A, sw


def _quantized_weights(local_idx, w_local, far_src, far_w, block: int):
    """int8 band codes and int32 far-edge codes under ONE per-row scale.

    The scale is taken over the FULL row (band and far edges): a far edge
    can carry its row's largest weight, which a band-only rowmax would
    clip at 127. Returns ``(A8 [nb, B, 3B] int8, sw [nb, B, 1] f32,
    sw_row [Npad] f32, far_q [F] int32)``; padded far entries (weight 0)
    get code 0.
    """
    n_padded = local_idx.shape[0]
    local_max = jnp.max(w_local.astype(jnp.float32), axis=1)
    far_max = jnp.zeros((n_padded,), jnp.float32).at[far_src - block].max(
        far_w.astype(jnp.float32), mode="drop")
    rowmax = jnp.maximum(local_max, far_max)
    sw_row = jnp.where(rowmax > 0, rowmax / 127.0, 1.0)
    A8, sw = _build_band_i8(local_idx, w_local, block,
                            row_scale=sw_row.reshape(-1, block, 1))
    far_q = jnp.clip(jnp.round(far_w / sw_row[far_src - block]), 0,
                     127).astype(jnp.int32)
    return A8, sw, sw_row, far_q


def _band_slab_i32(A8, Zp8, s: int):
    """Band slab ``s`` (previous / self / next block) of the lag:
    ``A8[:, :, sB:(s+1)B] @ Zp8[s:s+nb]`` as an s8×s8→s32 batched dot.

    Both operands stay int8 (the form integer matrix units take); the
    int32 result is exact, so it equals the product of int32 casts."""
    nb, B, _ = A8.shape
    return jnp.einsum("nbw,nwg->nbg", A8[:, :, s * B:(s + 1) * B],
                      Zp8[s:s + nb], preferred_element_type=jnp.int32)


def _band_lag_i32(A8, Zp8):
    """Exact int32 band lag [nb, B, G] of int8 codes ``Zp8`` [nb+2, B, G].

    The barrier after each slab keeps XLA from holding all three slab
    products at once."""
    lag = _band_slab_i32(A8, Zp8, 0)
    for s in (1, 2):
        lag = jax.lax.optimization_barrier(lag)
        lag = lag + _band_slab_i32(A8, Zp8, s)
    return jax.lax.optimization_barrier(lag)


def _band_cross_win_i8_xla(A8, sw, Zp8, far_src, far_dst, far_q):
    """cross_q[g] of the fully quantized operator (``far_mode="win"``).

    Band codes with the full-row scale plus int8 far-edge codes: far edge
    e adds ``far_q[e]·z[far_dst[e]]`` to its source row of the exact
    int32 lag (padded entries carry code 0), and one f32 reduce applies
    the per-row scale. ``Zp8`` [nb+2, B, G] holds the draw's codes."""
    nb, B, _ = A8.shape
    G = Zp8.shape[2]
    n_padded = nb * B
    flat = Zp8.reshape(-1, G)
    lag = _band_lag_i32(A8, Zp8).reshape(n_padded, G)
    vals = flat[far_dst].astype(jnp.int32) * far_q[:, None]
    lag = lag.at[far_src - B].add(vals, mode="drop")
    z1 = flat[B:B + n_padded].astype(jnp.float32)
    swf = sw.reshape(n_padded, 1)
    return jnp.einsum("ig,ig->g", swf * z1, lag.astype(jnp.float32),
                      preferred_element_type=jnp.float32)


def _band_cross_i8_xla(A8, sw, Zp8) -> jax.Array:
    """Band part of cross_q[g] with a band-local row scale
    (``far_mode="exact"``): per slab, an exact int32 dot reduced in f32."""
    nb = A8.shape[0]
    G = Zp8.shape[2]
    zblk = Zp8[1:nb + 1]
    cross = jnp.zeros((G,), jnp.float32)
    for s in range(3):
        lag = _band_slab_i32(A8, Zp8, s)
        cross = cross + jnp.einsum(
            "nbg,nbg->g",
            sw * zblk.astype(jnp.float32), lag.astype(jnp.float32),
            preferred_element_type=jnp.float32)
        cross = jax.lax.optimization_barrier(cross)
    return cross


def _moran_geary(cross, zp2, rc_sum, den, S0, *, n: int, stat: str):
    """Global Moran / Geary (or both stacked, ``"moran_geary"``) from the
    draw's cross term [G] and squared values ``zp2`` [Npad, G] (unused —
    and dead-code-eliminated — for Moran)."""
    moran = (n / S0) * cross / den
    if stat == "moran":
        return moran
    sq = jnp.einsum("i,ig->g", rc_sum, zp2)
    geary = (n - 1) * (sq - 2.0 * cross) / (2.0 * S0 * den)
    if stat == "geary":
        return geary
    # fused "moran_geary": both statistics from the SAME gather + band
    # products; the second statistic costs only the sq reduction
    return jnp.stack([moran, geary])


def _banded_stat_i8(A8, sw, far_src, far_dst, far_w, rc_sum, Zq, sz2, den,
                    S0, rows, *, block: int, n: int, stat: str):
    """One draw's statistic [G] in the int8 system with exact f32 far
    weights (``far_mode="exact"``).

    Band products are exact integers scaled by sw (per band row) and the
    far einsum uses the exact f32 weights; one sz² converts both back to
    z units. ``rows`` is the draw's already-composed padded row-index
    vector ``perm[order[gidx]]`` (the identity placement passes
    ``order[gidx]`` itself), so the SAME operator serves draws and the
    observed configuration and the only gather here is the value rows.
    """
    B = block
    nb = A8.shape[0]
    G = Zq.shape[1]
    Zp = Zq[rows].reshape(nb + 2, B, G)           # int8 row gather
    cross_q = _band_cross_i8_xla(A8, sw, Zp)
    flat = Zp.reshape(-1, G)
    # cap the two [F, G] f32 far gathers at ~3 GB: a high far fraction
    # (graph_order fallback, small blocks) would otherwise materialize
    # multi-GB temps next to the resident Zq tile; chunks + barrier bound
    # the peak without changing the gathered row count
    F = int(far_src.shape[0])
    fbytes = F * G * 4
    n_fc = 1 if fbytes <= (3 << 30) else -(-fbytes // (3 << 29))
    fc = -(-F // n_fc)
    for i in range(n_fc):
        sl = slice(i * fc, min((i + 1) * fc, F))
        fs = flat[far_src[sl]].astype(jnp.float32)
        ft = flat[far_dst[sl]].astype(jnp.float32)
        cross_q = cross_q + jnp.einsum("f,fg,fg->g", far_w[sl], fs, ft,
                                       preferred_element_type=jnp.float32)
        if n_fc > 1:
            cross_q = jax.lax.optimization_barrier(cross_q)
    zp2 = jnp.square(flat[B:B + nb * B].astype(jnp.float32)) * sz2
    return _moran_geary(cross_q * sz2, zp2, rc_sum, den, S0, n=n, stat=stat)


def _banded_stat_win(A8, sw, far_src, far_dst, far_q, rc_sum, Zp, sz2, den,
                     S0, *, block: int, n: int, stat: str):
    """One draw's statistic [G] of the fully quantized operator
    (``far_mode="win"``; int8, and int4 after unpacking). ``Zp`` is the
    draw's gathered int8 codes [nb+2, B, G]."""
    B = block
    nb = A8.shape[0]
    G = Zp.shape[2]
    cross_q = _band_cross_win_i8_xla(A8, sw, Zp, far_src, far_dst, far_q)
    flat = Zp.reshape(-1, G)
    zp2 = jnp.square(flat[B:B + nb * B].astype(jnp.float32)) * sz2
    return _moran_geary(cross_q * sz2, zp2, rc_sum, den, S0, n=n, stat=stat)


def _f32_precision(dtype):
    """``HIGHEST`` for float32 operands, so the f32 null mode computes in
    f32 on GPUs whose default f32 matmul is TF32; ``None`` otherwise."""
    return jax.lax.Precision.HIGHEST if dtype == jnp.float32 else None


def _banded_stat(A, far_src, far_dst, far_w, rc_sum, Ztab, den, S0, rows,
                 *, block: int, n: int, stat: str):
    """One draw's global statistic [G] via three batched band matmuls.

    ``Zp`` is laid out as [nb+2, B, G]: one front and one tail pad block of
    clipped rows whose values never reach the output (their band columns are
    all zero-weight). ``Ztab`` may be bf16 (default null mode) or f32.
    ``rows`` is the already-composed padded row-index vector (see
    :func:`_banded_stat_i8`).
    """
    B = block
    nb = A.shape[0]
    G = Ztab.shape[1]
    prec = _f32_precision(Ztab.dtype)
    Zp = Ztab[rows].reshape(nb + 2, B, G)         # ONE random row gather

    zblk = Zp[1:nb + 1]
    cross = jnp.zeros((G,), jnp.float32)
    lag_dt = Ztab.dtype  # bf16 lag halves the [nb,B,G] temp traffic;
    # the final contraction still accumulates in f32
    for s in range(3):
        lag_s = jnp.einsum("nbw,nwg->nbg", A[:, :, s * B:(s + 1) * B],
                           Zp[s:s + nb], preferred_element_type=lag_dt,
                           precision=prec)
        cross = cross + jnp.einsum("nbg,nbg->g", zblk, lag_s,
                                   preferred_element_type=jnp.float32,
                                   precision=prec)
        cross = jax.lax.optimization_barrier(cross)

    flat = Zp.reshape(-1, G)
    # far gathers stay in the table dtype (bf16 in the default null mode):
    # f32 copies of two [F, G] gathers would double their bytes; the
    # einsum accumulates in f32 either way
    fs = flat[far_src]
    ft = flat[far_dst]
    cross = cross + jnp.einsum("f,fg,fg->g", far_w.astype(flat.dtype),
                               fs, ft,
                               preferred_element_type=jnp.float32,
                               precision=prec)
    zp2 = jnp.square(flat[B:B + nb * B].astype(jnp.float32))
    return _moran_geary(cross, zp2, rc_sum, den, S0, n=n, stat=stat)


@functools.partial(jax.jit, static_argnames=(
    "block", "n", "stat", "alternative", "n_permutations", "precision",
    "perm_method", "far_mode"))
def _banded_test(order, local_idx, w_local, far_src, far_dst, far_w, rc_sum,
                 Z, S0, observed, seed, den, sz=None,
                 draw0=jnp.uint32(0), *, block: int, n: int,
                 n_permutations: int, stat: str, alternative: str,
                 precision: str, perm_method: str, far_mode: str = "exact"):
    prepacked = precision == "int4" and Z.dtype == jnp.int8
    if den is None:
        if prepacked:
            # packed bytes: den from the unpacked CODES (consistent with
            # the quantized operator: Σ (c·s)² per gene)
            if sz is None:
                raise ValueError("int4 Z requires its per-gene scale `sz`")
            codes = _unpack_nibbles(Z).astype(jnp.float32)
            den = jnp.sum(codes * codes, axis=0) * sz * sz
        else:
            den = jnp.sum(Z.astype(jnp.float32) ** 2, axis=0)
            if precision == "int8" and Z.dtype == jnp.int8:
                # Z holds quantized CODES: Σ code² is den/s_g² — rescale
                # to z units so the returned null mean/std keep
                # statistic units
                if sz is None:
                    raise ValueError(
                        "int8 Z requires its per-gene scale `sz`")
                den = den * sz * sz
        den = jnp.where(den > 0, den, 1.0)
    G = Z.shape[1] * (2 if prepacked else 1)
    nbb = local_idx.shape[0] // block
    # padded row-relabel indices, fixed across draws: per draw the value
    # rows are Z[perm[rows_idx]] — with the Feistel stream that composes
    # to ONE elementwise bijection evaluation + ONE row gather (no [n]
    # permutation materialization, no int32 reorder gather)
    gidx = jnp.clip(jnp.arange((nbb + 2) * block, dtype=jnp.int32) - block,
                    0, n - 1)
    rows_idx = order[gidx]
    if precision in ("int8", "int4"):
        if precision == "int4":
            Zq, s_z = (Z, sz) if prepacked else _quantize_z4(Z)
        elif Z.dtype == jnp.int8:
            if sz is None:
                raise ValueError("int8 Z requires its per-gene scale `sz`")
            Zq, s_z = Z, sz           # pre-quantized table (streaming prep)
        else:
            Zq, s_z = _quantize_z(Z)
        sz2 = s_z * s_z
        if far_mode == "win":
            A8, sw, _, far_q = _quantized_weights(local_idx, w_local,
                                                  far_src, far_w, block)

            def stat_fn(rows):
                Zp = Zq[rows]                         # ONE row gather
                if precision == "int4":
                    Zp = _unpack_nibbles(Zp)
                return _banded_stat_win(
                    A8, sw, far_src, far_dst, far_q, rc_sum,
                    Zp.reshape(nbb + 2, block, G), sz2, den, S0,
                    block=block, n=n, stat=stat)
        else:
            A8, sw = _build_band_i8(local_idx, w_local, block)

            def stat_fn(rows):
                return _banded_stat_i8(
                    A8, sw, far_src, far_dst, far_w, rc_sum, Zq, sz2, den,
                    S0, rows, block=block, n=n, stat=stat)

        # compare draws against the observed value of the SAME quantized
        # operator (identity placement: rows = order[gidx])
        observed = stat_fn(rows_idx)
    else:
        wdt = jnp.bfloat16 if precision == "bf16" else Z.dtype
        A = _build_band(local_idx, w_local, block, wdt)
        Ztab = Z if Z.dtype == wdt else Z.astype(wdt)

        def stat_fn(rows):
            return _banded_stat(A, far_src, far_dst, far_w, rc_sum, Ztab,
                                den, S0, rows, block=block, n=n, stat=stat)

    if perm_method == "sort":
        base = key_for(seed, "perm_global", 0)
    else:
        base = key_for(seed, "perm_feistel", 0)

    def body(carry, step):
        count, s1, s2 = carry
        # draw0 is TRACED: chunked callers pass their absolute draw
        # offset so the stream is keyed by global draw index — results
        # are bitwise independent of the chunk split (CLAUDE.md hard
        # rule) and chunks reuse one compiled executable
        key = jax.random.fold_in(base, step + draw0)
        if perm_method == "sort":
            # compose with the relabeling so each draw assigns values to
            # cells EXACTLY as the legacy path does: new position p gets
            # Z[perm[order[p]]]
            rows = jax.random.permutation(key, n)[rows_idx]
        else:
            rows = feistel_apply(key, rows_idx, n)
        vals = stat_fn(rows)

        def _extreme(v, o, alt):
            if alt == "greater":
                return v >= o
            if alt == "less":
                return v <= o
            return jnp.abs(v) >= jnp.abs(o)

        if stat == "moran_geary":
            alts = (alternative if isinstance(alternative, tuple)
                    else (alternative, alternative))
            extreme = jnp.stack([_extreme(vals[i], observed[i], alts[i])
                                 for i in range(2)])
        else:
            extreme = _extreme(vals, observed, alternative)
        return (count + extreme.astype(jnp.int32),
                s1 + vals, s2 + vals * vals), None

    out_shape = (2, G) if stat == "moran_geary" else (G,)
    init = (jnp.zeros(out_shape, jnp.int32),
            jnp.zeros(out_shape, jnp.float32),
            jnp.zeros(out_shape, jnp.float32))
    # unroll=1: a second unrolled step would keep a second [Npad, G]
    # gathered table alive next to the resident gene tile
    (count, s1, s2), _ = jax.lax.scan(body, init,
                                      jnp.arange(n_permutations,
                                                 dtype=jnp.uint32),
                                      unroll=1)
    P = n_permutations
    p = (count + 1.0) / (P + 1.0)
    mean = s1 / P
    var = jnp.maximum(s2 / P - mean ** 2, 0.0)
    return p, mean, jnp.sqrt(var)


def _check_band_impl(band_impl: str) -> None:
    """The plain XLA engine is the only band implementation; the Pallas
    kernels that ``"pallas"``, ``"pallas_halo"`` and ``"pallas_halo4"``
    selected are gone, and a request for one fails instead of running
    something else."""
    if band_impl != "xla":
        raise ValueError(
            f"band_impl must be 'xla' (the only band implementation; the "
            f"Pallas band kernels were removed), got {band_impl!r}")


def banded_permutation_test(
    plan: NullPlan,
    Z: jax.Array,
    S0: float,
    observed: jax.Array,
    seed: int,
    n_permutations: int,
    stat: str = "moran",
    alternative: str = "greater",
    precision: str = "bf16",
    perm_method: str = "feistel",
    band_impl: str = "xla",
    den: Optional[jax.Array] = None,
    sz: Optional[jax.Array] = None,
    draw_offset: int = 0,
    far_mode: str = "auto",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Drop-in replacement for ``permutation_test_global`` using a NullPlan.

    ``draw_offset`` keys this call's draws at global indices
    ``[draw_offset, draw_offset + n_permutations)`` of the seed's stream:
    chunked callers (bench.py, ops/streaming.py) split a P-draw run into
    chunks that reproduce the unchunked run bitwise (the offset is a
    traced scalar — no recompile per chunk).

    ``perm_method="feistel"`` (default) draws permutations from the sort-free
    Feistel stream — its own seeded, device-independent sequence.
    ``perm_method="sort"`` reuses the legacy draw stream: values then differ
    from ``permutation_test_global`` only by floating-point summation order
    (and by ~3-digit rounding with the default bf16 band — nulls feed
    Monte-Carlo *counting*, where that precision is statistically invisible;
    pass precision="f32" for exact-order validation).

    ``band_impl`` accepts only ``"xla"``, the batched-einsum engine; any
    other value raises ``ValueError``.

    Memory note: at large N·G pass ``Z`` already cast to bfloat16 together
    with a precomputed f32 ``den`` (= Σ z² per gene) so no float32 copy of
    Z needs to stay resident during the scan.

    ``precision="int8"``: the null system quantizes z per gene (s_g =
    min(max|z|, 8)/127, outliers saturate) and band weights per row; the
    band products become exact s8×s8→s32 dots and every gather moves one
    byte per gene. Draws are compared against the observed value of the
    SAME quantized operator (the ``observed`` argument is ignored), so the
    Monte-Carlo counting stays internally consistent; mean/std of the
    null are returned in statistic units. ``far_mode="win"`` (the int8
    default) quantizes the far-edge weights into the same integer lag;
    ``"exact"`` keeps them in f32 at the cost of two [F, G] f32 gathers
    per draw.

    ``precision="int4"`` nibble-packs two gene codes per byte (half the
    gathered bytes of int8) and always uses the windowed-far operator. An
    odd gene count is padded by one inert column.
    """
    _check_perm_method(perm_method)
    _check_band_impl(band_impl)
    if far_mode not in ("auto", "win", "exact"):
        raise ValueError(f"far_mode must be 'auto', 'win' or 'exact', got "
                         f"{far_mode!r}")
    prepacked = precision == "int4" and Z.dtype == jnp.int8
    G = Z.shape[1] * (2 if prepacked else 1)
    pad_g = 0
    if precision == "int4":
        if far_mode == "exact":
            raise ValueError("precision='int4' has no exact-far path; use "
                             "far_mode='win' (or 'auto')")
        far_mode = "win"
        pad_g = G % 2          # split-half nibble pairing: even width
    elif precision == "int8":
        if far_mode == "auto":
            far_mode = "win"
    elif far_mode == "win":
        raise ValueError("far_mode='win' requires precision='int8'/'int4' "
                         "(the windowed far operator is int8-quantized)")
    else:
        far_mode = "exact"
    if stat == "moran_geary":
        # fused mode: one gather + one set of band matmuls per draw serves
        # BOTH statistics; ``observed`` must be [2, G] (moran, geary) and
        # ``alternative`` may be a 2-tuple (one per statistic). Outputs are
        # [2, G] stacked the same way. With int8 precision ``observed`` is
        # recomputed under the quantized operator and the argument ignored.
        observed = jnp.asarray(observed)
        if observed.ndim != 2 or observed.shape[0] != 2:
            raise ValueError(
                "stat='moran_geary' needs observed of shape [2, G] "
                "(stacked moran, geary)")
        if isinstance(alternative, (tuple, list)):
            alternative = tuple(alternative)
            if len(alternative) != 2:
                raise ValueError("fused alternative must have 2 entries")
    if pad_g:
        Z = jnp.pad(Z, ((0, 0), (0, pad_g)))
        obs_pad = ((0, 0), (0, pad_g)) if observed.ndim == 2 else (0, pad_g)
        observed = jnp.pad(observed, obs_pad)
        if den is not None:
            den = jnp.pad(den, (0, pad_g), constant_values=1.0)
        if sz is not None:
            sz = jnp.pad(sz, (0, pad_g), constant_values=1.0)
    p, mean, std = _banded_test(
        plan.order, plan.local_idx, plan.w_local, plan.far_src, plan.far_dst,
        plan.far_w, plan.rc_sum, Z, S0, observed, jnp.uint32(seed), den, sz,
        jnp.uint32(draw_offset), block=plan.block, n=plan.n,
        n_permutations=n_permutations, stat=stat, alternative=alternative,
        precision=precision, perm_method=perm_method, far_mode=far_mode)
    if pad_g:
        p, mean, std = p[..., :G], mean[..., :G], std[..., :G]
    return p, mean, std


# ---------------------------------------------------------------------------
# Banded LOCAL Moran (LISA) — the reference's worst-scaling workload
# ---------------------------------------------------------------------------


#: gene-column chunk width for one-time observed-statistic passes
_OBS_CHUNK = 256


def _chunked_cols(fn, arrs, G, width=None):
    """Evaluate ``fn`` over gene-column chunks of its ``[:, G]`` operands.

    The local operators' OBSERVED pass runs the full-width einsum body
    once — which materializes several int32/f32 ``[Npad, G]`` temps at
    the same time (value casts, z² planes, per-family lags) outside the
    draw scan's buffer reuse. Chunking the one-time pass caps the peak at
    one chunk's temps next to the accumulated output; the barrier stops
    XLA from re-batching chunks into the very full-width temps this
    exists to avoid. Outputs concatenate on the last (gene) axis; ``fn``
    may return one array or a tuple.

    Memory-cap caveat: the chunks share no data dependency, so the
    barrier prevents op-level FUSION across chunks but cannot force the
    scheduler to serialize their subgraphs — the cap relies on XLA
    scheduling the independent chunk subgraphs one after another. A
    guaranteed-by-construction cap would need a threaded data
    dependency, which either changes the static slicing to dynamic or
    gets constant-folded away.
    """
    if width is None:
        width = _OBS_CHUNK   # module attr, so tests can patch it
    if G <= width:
        return fn(*arrs)
    single = False
    parts = []
    for s in range(0, G, width):
        res = fn(*(a[:, s:s + width] for a in arrs))
        if not isinstance(res, tuple):
            single, res = True, (res,)
        parts.append(jax.lax.optimization_barrier(res))
    outs = tuple(jnp.concatenate([p[i] for p in parts], axis=-1)
                 for i in range(len(parts[0])))
    return outs[0] if single else outs


def _banded_lag(A, Zp, far_src, far_dst, far_w, *, block: int):
    """Full spatial lag [Npad, G] of the permuted values, banded + far.

    Three batched band matmuls produce the in-band lag; the few percent of
    far edges scatter-add their contributions (duplicate rows accumulate).
    """
    B = block
    nb = A.shape[0]
    G = Zp.shape[2]
    lag = jnp.zeros((nb, B, G), jnp.float32)
    for s in range(3):
        lag = lag + jnp.einsum("nbw,nwg->nbg", A[:, :, s * B:(s + 1) * B],
                               Zp[s:s + nb],
                               preferred_element_type=jnp.float32,
                               precision=_f32_precision(A.dtype))
        lag = jax.lax.optimization_barrier(lag)
    flat = lag.reshape(nb * B, G)
    vals = Zp.reshape(-1, G)[far_dst].astype(jnp.float32) * far_w[:, None]
    # far_src carries the +B pad offset; padded entries have far_w == 0
    flat = flat.at[far_src - B].add(vals, mode="drop")
    return flat                                   # [Npad, G]


@functools.partial(jax.jit, static_argnames=(
    "block", "n", "n_permutations", "perm_method", "return_counts"))
def _banded_local_moran_p_i8(order, rank, local_idx, w_local, far_src,
                             far_dst, far_w, Z, seed, *, block: int, n: int,
                             n_permutations: int, perm_method: str,
                             return_counts: bool = False):
    """LISA permutation p via the int8 null system.

    Quantized-operator convention (same as the global int8 mode): z
    quantizes per gene (:func:`_quantize_z`), band weights per row
    (:func:`_build_band_i8`); each draw's local statistic is
    ``z_q · (sw·(A8 @ z_q) + far)`` with exact s8×s8→s32 band dots,
    and the observed value comes from the SAME operator at the identity
    placement — counting compares like with like, and the per-gene scale
    s_g² (and per-row sw, which multiplies both sides of every row's
    comparison) cancels inside ``|I_perm| ≥ |I_obs|``.

    Why int8 for LOCAL statistics: the [N, G] elementwise traffic (count
    read+write, lag, Ip, observed) dominates local nulls, not the gathers.
    The operator is FULLY INTEGER: far weights quantize with the same
    per-row scale as the band (computed over the FULL row incl. far edges
    so nothing clips), the per-draw statistic is the exact int32
    ``|z_code · Σ w_code z_code|`` (bounded by k·127³ < 2³¹ for
    k ≤ 1000), the observed side comes from the SAME operator, and the
    counters run int8 for P ≤ 127 (int16 ≤ 32767) — no f32 [N, G] array
    is materialized in the draw loop. Per row the shared (s_g²·sw) factor
    multiplies both sides of every comparison, so decisions equal those
    of the quantized-weights f32 operator exactly.
    """
    B = block
    n_padded = local_idx.shape[0]
    nb = n_padded // B
    G = Z.shape[1]
    k_total = local_idx.shape[1]
    if k_total > 1000:
        raise ValueError(
            f"int8 LISA null supports k <= 1000 (int32 bound k*127^3), "
            f"got k={k_total}; use precision='bf16'")
    Zq, _ = _quantize_z(Z) if Z.dtype != jnp.int8 else (Z, None)
    A8, _, _, far_q = _quantized_weights(local_idx, w_local, far_src,
                                         far_w, B)
    gidx0 = jnp.clip(jnp.arange((nb + 2) * B, dtype=jnp.int32) - B, 0, n - 1)
    rows_idx = order[gidx0]      # fixed relabel composition (see _banded_test)

    def abs_ip(rows, Zcols):
        Gc = Zcols.shape[1]
        Zp = Zcols[rows].reshape(nb + 2, B, Gc)      # ONE int8 row gather
        lag = _band_lag_i32(A8, Zp).reshape(n_padded, Gc)
        # far edges in the same integer domain (padded entries: far_q
        # rounds 0-weight to 0, contributing nothing)
        vals = Zp.reshape(-1, Gc)[far_dst].astype(jnp.int32) * far_q[:, None]
        lag = lag.at[far_src - B].add(vals, mode="drop")
        z1 = Zp.reshape(-1, Gc)[B:B + n_padded].astype(jnp.int32)
        return jnp.abs(z1 * lag)                      # exact int32

    # observed via the SAME quantized operator; chunked — the one-time
    # full-width pass peaks several int32 [Npad, G] temps (_chunked_cols)
    abs_obs = _chunked_cols(lambda zc: abs_ip(rows_idx, zc), (Zq,), G)

    if perm_method == "sort":
        base = key_for(seed, "perm_local", 0)   # legacy local draw stream
    else:
        base = key_for(seed, "perm_feistel_local", 0)
    cdt = (jnp.int8 if n_permutations <= 127
           else jnp.int16 if n_permutations <= 32767 else jnp.int32)

    def body(count, step):
        key = jax.random.fold_in(base, step)
        if perm_method == "sort":
            rows = jax.random.permutation(key, n)[rows_idx]
        else:
            rows = feistel_apply(key, rows_idx, n)
        return count + (abs_ip(rows, Zq) >= abs_obs).astype(cdt), None

    count, _ = jax.lax.scan(body, jnp.zeros((n_padded, G), cdt),
                            jnp.arange(n_permutations))
    if return_counts:
        # integer extreme counts in ORIGINAL order: the streaming
        # post-pass computes p per column chunk from these, so the two
        # f32 [N, G] planes (p + its rank gather) never materialize
        return count[rank]
    p_new = (count.astype(jnp.float32) + 1.0) / (n_permutations + 1.0)
    return p_new[rank]      # original order (new position rank[i] = cell i)


@functools.partial(jax.jit, static_argnames=(
    "block", "n", "n_permutations", "precision", "perm_method"))
def _banded_local_moran_p(order, rank, local_idx, w_local, far_src, far_dst,
                          far_w, Z, abs_obs_new, seed, *, block: int, n: int,
                          n_permutations: int, precision: str,
                          perm_method: str):
    """Permutation p for LISA via banded nulls: per draw ONE random gather
    + band matmuls instead of the 7 row-gathers of the direct path.

    ``abs_obs_new`` is |I_obs| already in relabeled order (padded to
    Npad); only the [Npad, G] p-matrix is produced and mapped back — the
    observed statistics come from the exact direct kernel, keeping the
    resident footprint at ~half of Z-f32-everything. Two-tailed p:
    (#{|I_perm| ≥ |I_obs|} + 1)/(P + 1), same convention as
    ``ops.moran.local_moran``.
    """
    B = block
    n_padded = local_idx.shape[0]
    nb = n_padded // B
    G = Z.shape[1]
    wdt = jnp.bfloat16 if precision == "bf16" else Z.dtype
    A = _build_band(local_idx, w_local, B, wdt)
    Ztab = Z if Z.dtype == wdt else Z.astype(wdt)
    gidx0 = jnp.clip(jnp.arange((nb + 2) * B, dtype=jnp.int32) - B, 0, n - 1)
    rows_idx = order[gidx0]

    if perm_method == "sort":
        base = key_for(seed, "perm_local", 0)   # legacy local draw stream
    else:
        base = key_for(seed, "perm_feistel_local", 0)

    def body(count, step):
        key = jax.random.fold_in(base, step)
        if perm_method == "sort":
            rows = jax.random.permutation(key, n)[rows_idx]
        else:
            rows = feistel_apply(key, rows_idx, n)
        Zp = Ztab[rows].reshape(nb + 2, B, G)
        lag_p = _banded_lag(A, Zp, far_src, far_dst, far_w, block=B)
        Ip = Zp.reshape(-1, G)[B:B + n_padded].astype(jnp.float32) * lag_p
        return count + (jnp.abs(Ip) >= abs_obs_new).astype(count.dtype), None

    # int16 counters (exact for P <= 32767): the [N, G] count update is
    # a full read+write per draw — halve its bytes
    cdt = jnp.int16 if n_permutations <= 32767 else jnp.int32
    count, _ = jax.lax.scan(body, jnp.zeros((n_padded, G), cdt),
                            jnp.arange(n_permutations))
    p_new = (count + 1.0) / (n_permutations + 1.0)
    return p_new[rank]      # original order (new position rank[i] = cell i)


@functools.partial(jax.jit, static_argnames=(
    "block", "n", "n_permutations", "precision", "compute_cell_pvalues",
    "perm_method"))
def _banded_lees_p(order, rank, local_idx, w_local, far_src, far_dst,
                   far_w, Zx, Zy, seed, *, block: int, n: int,
                   n_permutations: int, precision: str,
                   compute_cell_pvalues: bool, perm_method: str = "sort"):
    """Lee's L permutation nulls through the banded plan.

    Per draw: ONE random row gather of the permuted Y columns + three band
    matmuls, instead of the direct kernel's k barriered gathers
    (``spatial_lag``) — at the reference vignette's k=50 that is 50×
    fewer issue-bound gathered rows per draw. ``perm_method="sort"``
    matches the draw stream of ``ops.lee.lees_l_pairs`` exactly (same
    ``perm_lee`` key base, Y-only permutation); ``"feistel"`` draws from
    its own sort-free stream evaluated at the composed row indices — no
    [n] permutation materialization or per-draw index gather (the ~40 ms
    sort at 1M cells dominates fast local kernels). Observed comparison
    values come from the SAME banded operator at the identity placement.
    Returns ``(p_global [P], p_local [n, P])`` in original cell order
    (``p_local`` is ones when ``compute_cell_pvalues`` is False).
    """
    B = block
    n_padded = local_idx.shape[0]
    nb = n_padded // B
    Pn = Zy.shape[1]
    wdt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    A = _build_band(local_idx, w_local, B, wdt)
    Ytab = Zy.astype(wdt)
    gidx0 = jnp.clip(jnp.arange((nb + 2) * B, dtype=jnp.int32) - B, 0, n - 1)
    rows_idx = order[gidx0]
    # X stays FIXED across draws (Lee's null permutes Y only); zero-padded
    # rows contribute nothing to the global sum
    Zx_new = Zx[order].astype(jnp.float32)
    if n_padded > n:
        Zx_new = jnp.pad(Zx_new, ((0, n_padded - n), (0, 0)))

    def lees(rows):
        Yp = Ytab[rows].reshape(nb + 2, B, Pn)
        L_local = Zx_new * _banded_lag(A, Yp, far_src, far_dst, far_w,
                                       block=B)
        return L_local, jnp.sum(L_local, axis=0)

    obs_l, obs_g = lees(rows_idx)
    abs_l, abs_g = jnp.abs(obs_l), jnp.abs(obs_g)
    if perm_method == "sort":
        base = key_for(seed, "perm_lee", 0)
    else:
        base = key_for(seed, "perm_feistel_lee", 0)
    cdt = jnp.int16 if n_permutations <= 32767 else jnp.int32

    def body(carry, step):
        cg, cl = carry
        key = jax.random.fold_in(base, step)
        if perm_method == "sort":
            rows = jax.random.permutation(key, n)[rows_idx]
        else:
            rows = feistel_apply(key, rows_idx, n)
        Lp, Lg = lees(rows)
        cg = cg + (jnp.abs(Lg) >= abs_g).astype(jnp.int32)
        if compute_cell_pvalues:
            cl = cl + (jnp.abs(Lp) >= abs_l).astype(cdt)
        return (cg, cl), None

    cl_shape = (n_padded, Pn) if compute_cell_pvalues else (1, Pn)
    (cg, cl), _ = jax.lax.scan(
        body, (jnp.zeros((Pn,), jnp.int32), jnp.zeros(cl_shape, cdt)),
        jnp.arange(n_permutations))
    p_g = (cg + 1.0) / (n_permutations + 1.0)
    if compute_cell_pvalues:
        p_l = ((cl.astype(jnp.float32) + 1.0) / (n_permutations + 1.0))[rank]
    else:
        p_l = jnp.ones((n, Pn), jnp.float32)
    return p_g, p_l


@functools.partial(jax.jit, static_argnames=(
    "block", "n", "n_permutations", "perm_method", "compute_cell_pvalues"))
def _banded_lees_p_i8(order, rank, local_idx, w_local, far_src, far_dst,
                      far_w, Zx, Zy, seed, *, block: int, n: int,
                      n_permutations: int, perm_method: str,
                      compute_cell_pvalues: bool):
    """Lee's L nulls in the int8 quantized-operator system.

    Both columns quantize per gene-pair (:func:`_quantize_z`), weights
    per row with the FULL-row scale (far edges included). The per-cell
    draw statistic is the exact int32 ``x_code · Σ w_code y_code``
    (|L_q| ≤ k·127³ < 2³¹ for k ≤ 1000); the shared positive factor
    s_x·s_y·sw_row multiplies both sides of every per-cell comparison,
    so |L_perm| ≥ |L_obs| decisions equal the quantized-weights f32
    operator exactly. The GLOBAL statistic re-applies the per-row weight
    scale in an f32 reduce (rows carry different sw) — the same
    convention as the global int8 Moran operator — so its comparisons are
    f32-of-integer, deterministic and identical for draw and observed.
    """
    B = block
    n_padded = local_idx.shape[0]
    nb = n_padded // B
    Pn = Zy.shape[1]
    k_total = local_idx.shape[1]
    if k_total > 1000:
        raise ValueError(
            f"int8 Lee null supports k <= 1000 (int32 bound k*127^3), "
            f"got k={k_total}; use precision='bf16'")
    Zxq, _ = _quantize_z(Zx)
    Zyq, _ = _quantize_z(Zy)
    A8, _, sw_row, far_q = _quantized_weights(local_idx, w_local, far_src,
                                              far_w, B)
    gidx0 = jnp.clip(jnp.arange((nb + 2) * B, dtype=jnp.int32) - B, 0, n - 1)
    rows_idx = order[gidx0]
    zx_new = Zxq[order]          # int8 resident; cast per use below
    if n_padded > n:
        zx_new = jnp.pad(zx_new, ((0, n_padded - n), (0, 0)))

    def lees_q(rows, Ycols, xcols):
        Gc = Ycols.shape[1]
        Yp = Ycols[rows].reshape(nb + 2, B, Gc)
        lag = _band_lag_i32(A8, Yp).reshape(n_padded, Gc)
        vals = Yp.reshape(-1, Gc)[far_dst].astype(jnp.int32) * far_q[:, None]
        lag = lag.at[far_src - B].add(vals, mode="drop")
        Lq = xcols.astype(jnp.int32) * lag              # exact int32
        Lg = jnp.einsum("np,n->p", Lq.astype(jnp.float32), sw_row,
                        preferred_element_type=jnp.float32)
        return Lq, Lg

    # one-time observed pass, gene-chunked (see _chunked_cols). Per-cell
    # Lq is exact int32, but the global Lg is an f32 REDUCTION over
    # int32 values past 2^24 — XLA picks its reduce tiling per column
    # width, so obs_g evaluated at chunk width vs full width can differ
    # in the last ulp; a draw whose Lg ties obs_g EXACTLY in f32 could
    # then flip the global count between chunk widths. The per-cell p is
    # width-invariant; the draw-side Lg runs at full Pn width either way.
    obs_l, obs_g = _chunked_cols(
        lambda yc, xc: lees_q(rows_idx, yc, xc), (Zyq, zx_new), Pn)
    abs_l, abs_g = jnp.abs(obs_l), jnp.abs(obs_g)
    if perm_method == "sort":
        base = key_for(seed, "perm_lee", 0)
    else:
        base = key_for(seed, "perm_feistel_lee", 0)
    cdt = (jnp.int8 if n_permutations <= 127
           else jnp.int16 if n_permutations <= 32767 else jnp.int32)

    def body(carry, step):
        cg, cl = carry
        key = jax.random.fold_in(base, step)
        if perm_method == "sort":
            rows = jax.random.permutation(key, n)[rows_idx]
        else:
            rows = feistel_apply(key, rows_idx, n)
        Lq, Lg = lees_q(rows, Zyq, zx_new)
        cg = cg + (jnp.abs(Lg) >= abs_g).astype(jnp.int32)
        if compute_cell_pvalues:
            cl = (cl.astype(jnp.int32)
                  + (jnp.abs(Lq) >= abs_l).astype(jnp.int32)
                  ).astype(cdt)
        return (cg, cl), None

    cl_shape = (n_padded, Pn) if compute_cell_pvalues else (1, Pn)
    (cg, cl), _ = jax.lax.scan(
        body, (jnp.zeros((Pn,), jnp.int32), jnp.zeros(cl_shape, cdt)),
        jnp.arange(n_permutations))
    p_g = (cg + 1.0) / (n_permutations + 1.0)
    if compute_cell_pvalues:
        p_l = ((cl.astype(jnp.float32) + 1.0) / (n_permutations + 1.0))[rank]
    else:
        p_l = jnp.ones((n, Pn), jnp.float32)
    return p_g, p_l


@functools.partial(jax.jit, static_argnames=(
    "block", "n", "n_permutations", "precision", "perm_method"))
def _banded_local_geary_p(order, rank, local_idx, w_local, far_src, far_dst,
                          far_w, Z, seed, *, block: int, n: int,
                          n_permutations: int, precision: str,
                          perm_method: str = "sort"):
    """Local Geary total-null permutation p via the banded plan.

    Per draw ONE row gather + two band matmul families, using the
    expansion c_i = z_i²·Σ_j w_ij + Σ_j w_ij z_j² − 2 z_i Σ_j w_ij z_j
    (algebraically equal to the direct kernel's Σ w (z_i − z_j)²; in f32
    it differs only by float rearrangement). ``perm_method="sort"`` uses
    the same ``perm_local_geary`` draw stream as
    ``ops.moran.local_geary(null="total")``; ``"feistel"`` draws from its
    own sort-free stream at composed row indices (no [n] permutation
    materialization per draw). The observed comparison value comes from
    the SAME banded operator at the identity placement. One-sided low
    tail: p = (#{c_perm ≤ c_obs}+1)/(P+1), returned in original cell
    order.
    """
    B = block
    n_padded = local_idx.shape[0]
    nb = n_padded // B
    G = Z.shape[1]
    wdt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    A = _build_band(local_idx, w_local, B, wdt)
    Ztab = Z.astype(wdt)
    gidx0 = jnp.clip(jnp.arange((nb + 2) * B, dtype=jnp.int32) - B, 0, n - 1)
    # per-row TOTAL weight (band + far; row-normalized kNN rows are 1,
    # isolated radius rows 0)
    row_w = jnp.sum(w_local.astype(jnp.float32), axis=1)
    row_w = row_w.at[far_src - B].add(far_w.astype(jnp.float32),
                                      mode="drop")[:, None]

    rows_idx = order[gidx0]

    def geary(rows):
        Zp = Ztab[rows].reshape(nb + 2, B, G)
        lag1 = _banded_lag(A, Zp, far_src, far_dst, far_w, block=B)
        Zp2 = (Zp.astype(jnp.float32)
               * Zp.astype(jnp.float32)).astype(wdt)
        lag2 = _banded_lag(A, Zp2, far_src, far_dst, far_w, block=B)
        me = Zp.reshape(-1, G)[B:B + n_padded].astype(jnp.float32)
        return me * me * row_w + lag2 - 2.0 * me * lag1

    c_obs = geary(rows_idx)
    if perm_method == "sort":
        base = key_for(seed, "perm_local_geary", 0)
    else:
        base = key_for(seed, "perm_feistel_local_geary", 0)
    cdt = jnp.int16 if n_permutations <= 32767 else jnp.int32

    def body(count, step):
        key = jax.random.fold_in(base, step)
        if perm_method == "sort":
            rows = jax.random.permutation(key, n)[rows_idx]
        else:
            rows = feistel_apply(key, rows_idx, n)
        return count + (geary(rows) <= c_obs).astype(cdt), None

    count, _ = jax.lax.scan(body, jnp.zeros((n_padded, G), cdt),
                            jnp.arange(n_permutations))
    p = (count.astype(jnp.float32) + 1.0) / (n_permutations + 1.0)
    return c_obs[rank], p[rank]


@functools.partial(jax.jit, static_argnames=(
    "block", "n", "n_permutations", "perm_method"))
def _banded_local_geary_p_i8(order, rank, local_idx, w_local, far_src,
                             far_dst, far_w, Z, seed, *, block: int, n: int,
                             n_permutations: int, perm_method: str):
    """Local Geary total nulls, fully integer.

    The expansion c_i = z_i²·W_i + Σ w z_j² − 2 z_i Σ w z_j evaluates
    exactly in the quantized domain: z codes via :func:`_quantize_z`,
    weights per row with the full-row scale. The z² lag rides int8 dots
    through a TWO-PLANE split — z_q² = 128·a + b with a ≤ 126,
    b ≤ 127 both int8 — so lag(z²) = 128·lag(a) + lag(b) is exact.
    Every term shares the positive factor s_g²·sw_row, fixed across
    draws, so c_perm ≤ c_obs decisions are exact int32 comparisons
    (bound: Σ w_q (Δz_q)² ≤ k·127·254² < 2³¹ requires k ≤ 256). Cost per
    draw: ONE int8 row gather + three band matmul families (z, a, b).
    """
    B = block
    n_padded = local_idx.shape[0]
    nb = n_padded // B
    G = Z.shape[1]
    k_total = local_idx.shape[1]
    if k_total > 256:
        raise ValueError(
            f"int8 local-Geary null supports k <= 256 (int32 bound "
            f"k*127*254^2), got k={k_total}; use precision='f32'")
    Zq, _ = _quantize_z(Z) if Z.dtype != jnp.int8 else (Z, None)
    A8, _, _, far_q = _quantized_weights(local_idx, w_local, far_src,
                                         far_w, B)
    # per-row TOTAL quantized weight (band codes + far codes)
    Wq_row = jnp.sum(A8.astype(jnp.int32), axis=2).reshape(n_padded)
    Wq_row = Wq_row.at[far_src - B].add(far_q, mode="drop")[:, None]
    gidx0 = jnp.clip(jnp.arange((nb + 2) * B, dtype=jnp.int32) - B, 0, n - 1)
    rows_idx = order[gidx0]

    def geary_q(rows, Zcols):
        Gc = Zcols.shape[1]
        Zp = Zcols[rows].reshape(nb + 2, B, Gc)         # ONE int8 gather
        zi32 = Zp.astype(jnp.int32)
        z2 = zi32 * zi32                                # ≤ 16129
        a8 = (z2 >> 7).astype(jnp.int8)                 # ≤ 126
        b8 = (z2 & 127).astype(jnp.int8)                # ≤ 127
        lag_z = _band_lag_i32(A8, Zp).reshape(n_padded, Gc)
        lag_z2 = (128 * _band_lag_i32(A8, a8)
                  + _band_lag_i32(A8, b8)).reshape(n_padded, Gc)
        zf = zi32.reshape(-1, Gc)
        z2f = z2.reshape(-1, Gc)
        lag_z = lag_z.at[far_src - B].add(
            zf[far_dst] * far_q[:, None], mode="drop")
        lag_z2 = lag_z2.at[far_src - B].add(
            z2f[far_dst] * far_q[:, None], mode="drop")
        me = zf[B:B + n_padded]
        me2 = z2f[B:B + n_padded]
        return me2 * Wq_row + lag_z2 - 2 * me * lag_z   # exact int32

    # one-time observed pass, gene-chunked (see _chunked_cols)
    c_obs = _chunked_cols(lambda zc: geary_q(rows_idx, zc), (Zq,), G)
    if perm_method == "sort":
        base = key_for(seed, "perm_local_geary", 0)
    else:
        base = key_for(seed, "perm_feistel_local_geary", 0)
    cdt = (jnp.int8 if n_permutations <= 127
           else jnp.int16 if n_permutations <= 32767 else jnp.int32)

    def body(count, step):
        key = jax.random.fold_in(base, step)
        if perm_method == "sort":
            rows = jax.random.permutation(key, n)[rows_idx]
        else:
            rows = feistel_apply(key, rows_idx, n)
        inc = (geary_q(rows, Zq) <= c_obs).astype(jnp.int32)
        return (count.astype(jnp.int32) + inc).astype(cdt), None

    count, _ = jax.lax.scan(body, jnp.zeros((n_padded, G), cdt),
                            jnp.arange(n_permutations))
    p = (count.astype(jnp.float32) + 1.0) / (n_permutations + 1.0)
    return c_obs[rank], p[rank]


def banded_local_geary(
    plan: NullPlan,
    Z: jax.Array,
    seed: int,
    n_permutations: int,
    precision: str = "f32",
    perm_method: str = "feistel",
    band_impl: str = "xla",
):
    """Local Geary total-null p-values via the banded plan — see
    :func:`_banded_local_geary_p`. Returns ``(c_obs_operator, p)`` in
    original cell order; callers should take the OBSERVED C from the
    exact direct kernel and use only ``p`` from here (the int8 path's
    first return value is in integer CODE units).
    ``perm_method="sort"`` reproduces the direct kernel's draw stream.
    ``precision="int8"`` runs the fully-integer quantized-operator
    system (two-plane z² split, k <= 256) — see
    :func:`_banded_local_geary_p_i8`. ``band_impl`` accepts only
    ``"xla"``."""
    if precision not in ("bf16", "f32", "int8"):
        raise ValueError(
            f"banded_local_geary supports precision 'bf16', 'f32' or "
            f"'int8', got {precision!r}")
    _check_perm_method(perm_method)
    _check_band_impl(band_impl)
    if precision == "int8":
        return _banded_local_geary_p_i8(
            plan.order, plan.rank, plan.local_idx, plan.w_local,
            plan.far_src, plan.far_dst, plan.far_w, Z, jnp.uint32(seed),
            block=plan.block, n=plan.n, n_permutations=n_permutations,
            perm_method=perm_method)
    return _banded_local_geary_p(
        plan.order, plan.rank, plan.local_idx, plan.w_local, plan.far_src,
        plan.far_dst, plan.far_w, Z, jnp.uint32(seed), block=plan.block,
        n=plan.n, n_permutations=n_permutations, precision=precision,
        perm_method=perm_method)


@functools.partial(jax.jit, static_argnames=(
    "block", "n", "n_permutations", "star", "alternative", "precision",
    "perm_method"))
def _banded_getis_p(order, rank, local_idx, w_local, far_src, far_dst,
                    far_w, X, seed, *, block: int, n: int,
                    n_permutations: int, star: bool, alternative: str,
                    precision: str, perm_method: str = "sort"):
    """Getis-Ord Gi/Gi* permutation p via the banded plan.

    Under the column-shuffle null every per-gene column statistic (mean,
    variance, totals) is permutation-invariant, and the per-cell scale
    s·denom_i > 0 is shared by draw and observed z — so the extremeness
    test |z_p| ≥ |z_obs| reduces to |lag*_p − x̄·W_i| ≥ |lag*_obs − x̄·W_i|
    (one-sided analogues drop the abs). Only the BINARY-weight lag varies
    per draw: one row gather + band matmuls on the plan's geometry with
    binarized weights (``ops.getis.getis_ord`` uses binary adjacency, not
    the row-normalized weights the plan stores). Gi (non-star) replaces
    x̄, s with their leave-one-out forms — still elementwise functions of
    the gathered own-value. ``perm_method="sort"`` uses the same
    ``perm_getis`` draw stream as the direct kernel; ``"feistel"`` draws
    from its own sort-free stream at composed row indices. Returns p_sim
    in original cell order.
    """
    B = block
    n_padded = local_idx.shape[0]
    nb = n_padded // B
    G = X.shape[1]
    wdt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    # binarize: the plan carries row-normalized weights; Getis adjacency
    # is 0/1 (ops/getis.py _binary_lag)
    wb = (w_local > 0).astype(jnp.float32)
    fb = (far_w > 0).astype(jnp.float32)
    A = _build_band(local_idx, wb, B, wdt)
    Xf = X.astype(jnp.float32)
    Xtab = Xf.astype(wdt)
    gidx0 = jnp.clip(jnp.arange((nb + 2) * B, dtype=jnp.int32) - B, 0, n - 1)
    rows_idx = order[gidx0]
    W_row = (jnp.sum(wb, axis=1).at[far_src - B].add(fb, mode="drop"))[:, None]
    tot = jnp.sum(Xf, axis=0, keepdims=True)                  # [1, G]
    sq = jnp.sum(Xf * Xf, axis=0, keepdims=True)              # [1, G]
    m = jnp.float32(n if star else n - 1)

    def center(rows):
        Xp = Xtab[rows].reshape(nb + 2, B, G)
        lag = _banded_lag(A, Xp, far_src, far_dst, fb, block=B)
        me = Xp.reshape(-1, G)[B:B + n_padded].astype(jnp.float32)
        if star:
            # global x̄, s and denom_i are draw-invariant and positive —
            # they cancel between draw and observed, so the centered lag
            # alone decides extremeness
            return (lag + me) - (tot / m) * (W_row + 1.0)
        # Gi: the leave-one-out x̄_(i), s_(i) DEPEND on the shuffled own
        # value, so the scale does not cancel — divide like the direct
        # kernel (ops/getis.py stat()); only denom_i cancels
        xbar_i = (tot - me) / m
        s2 = jnp.maximum((sq - me * me) / m - xbar_i * xbar_i, 0.0)
        s = jnp.sqrt(jnp.where(s2 > 0, s2, 1.0))
        return (lag - xbar_i * W_row) / s

    obs_c = center(rows_idx)
    if perm_method == "sort":
        base = key_for(seed, "perm_getis", 0)
    else:
        base = key_for(seed, "perm_feistel_getis", 0)
    cdt = jnp.int16 if n_permutations <= 32767 else jnp.int32

    def body(count, step):
        key = jax.random.fold_in(base, step)
        if perm_method == "sort":
            rows = jax.random.permutation(key, n)[rows_idx]
        else:
            rows = feistel_apply(key, rows_idx, n)
        cp = center(rows)
        if alternative == "greater":
            extreme = cp >= obs_c
        elif alternative == "less":
            extreme = cp <= obs_c
        else:
            extreme = jnp.abs(cp) >= jnp.abs(obs_c)
        return count + extreme.astype(cdt), None

    count, _ = jax.lax.scan(body, jnp.zeros((n_padded, G), cdt),
                            jnp.arange(n_permutations))
    p = (count.astype(jnp.float32) + 1.0) / (n_permutations + 1.0)
    return p[rank]


def _quantize_x(X):
    """Per-gene int8 quantization of RAW (non-standardized) values:
    s_g = max|x_g|/127 with no outlier saturation (unlike
    :func:`_quantize_z`'s min(max|z|, 8) clip) — Getis operates on raw
    expression, whose dynamic range after normalization is bounded
    (log1p ~[0, 10]), so the full range keeps all 8 bits useful. The
    clip below only guards the int8 cast against rounding to ±128."""
    Xf = X.astype(jnp.float32)
    s = jnp.max(jnp.abs(Xf), axis=0) / 127.0
    s = jnp.where(s > 0, s, 1.0)
    Xq = jnp.clip(jnp.round(Xf / s), -127, 127).astype(jnp.int8)
    return Xq, s


def _check_perm_method(perm_method: str) -> None:
    """Every kernel branches ``perm_method == "sort" ... else feistel`` —
    validate up front so a typo fails loudly instead of silently drawing
    from the feistel stream (the precision argument gets the same
    treatment in each public entry point)."""
    if perm_method not in ("feistel", "sort"):
        raise ValueError("perm_method must be 'feistel' or 'sort', "
                         f"got {perm_method!r}")


@functools.partial(jax.jit, static_argnames=(
    "block", "n", "n_permutations", "star", "alternative", "perm_method"))
def _banded_getis_p_i8(order, rank, local_idx, w_local, far_src, far_dst,
                       far_w, X, seed, *, block: int, n: int,
                       n_permutations: int, star: bool, alternative: str,
                       perm_method: str):
    """Getis-Ord Gi/Gi* permutation p_sim, int8 quantized operator.

    Getis adjacency is BINARY (0/1 — exact in int8), so the only
    quantization is per-gene on X (:func:`_quantize_x`); the per-draw
    binary lag is an exact int32 count-weighted sum of codes
    (≤ (k+1)·127 ≪ 2³¹, no k bound needed). Column statistics (tot, sq)
    are draw-invariant f32-of-integer sums computed ONCE and shared by
    draw and observed sides, so the centered comparison is deterministic
    and consistent — the same quantized-operator convention as the int8
    Moran/LISA operators. The int8 gather row moves 1 byte per gene.
    """
    B = block
    n_padded = local_idx.shape[0]
    nb = n_padded // B
    G = X.shape[1]
    Xq, _ = _quantize_x(X)
    wb = (w_local > 0)
    A8 = _build_band(local_idx, wb, B, jnp.int8)        # exact 0/1 codes
    fb = (far_w > 0).astype(jnp.int32)
    gidx0 = jnp.clip(jnp.arange((nb + 2) * B, dtype=jnp.int32) - B, 0, n - 1)
    rows_idx = order[gidx0]
    W_row = (jnp.sum(wb.astype(jnp.float32), axis=1)
             .at[far_src - B].add(fb.astype(jnp.float32),
                                  mode="drop"))[:, None]
    def _col_moments(Xcols):
        Xf = Xcols.astype(jnp.float32)
        return (jnp.sum(Xf, axis=0, keepdims=True),
                jnp.sum(Xf * Xf, axis=0, keepdims=True))

    # [1, G] code-unit column sums, gene-chunked: the full-width f32
    # cast of Xq alone is 4 bytes/cell/gene (see _chunked_cols)
    tot, sq = _chunked_cols(_col_moments, (Xq,), G)
    m = jnp.float32(n if star else n - 1)

    def lag_me_q(rows, Xcols):
        Gc = Xcols.shape[1]
        Xp = Xcols[rows].reshape(nb + 2, B, Gc)         # ONE int8 gather
        lag = _band_lag_i32(A8, Xp).reshape(n_padded, Gc)
        xf = Xp.reshape(-1, Gc).astype(jnp.int32)
        lag = lag.at[far_src - B].add(xf[far_dst] * fb[:, None], mode="drop")
        return lag, xf[B:B + n_padded]

    def cp_of(lag, me):
        # Gi leave-one-out centering (f32 — depends on the draw's own
        # value)
        mef = me.astype(jnp.float32)
        lagf = lag.astype(jnp.float32)
        xbar_i = (tot - mef) / m
        s2 = jnp.maximum((sq - mef * mef) / m - xbar_i * xbar_i, 0.0)
        s = jnp.sqrt(jnp.where(s2 > 0, s2, 1.0))
        return (lagf - xbar_i * W_row) / s

    # one-time observed pass, gene-chunked (see _chunked_cols)
    lag_o, me_o = _chunked_cols(
        lambda xc: lag_me_q(rows_idx, xc), (Xq,), G)
    if star:
        # Gi*'s centering constant c = (tot/m)·(W+1) is draw-invariant:
        # one-sided decisions reduce to EXACT integer comparisons of
        # A* = lag + own; two-sided to the sign test
        # (A_d−A_o)·(A_d+A_o−2c) ≥ 0 whose only f32 inputs are c and
        # the exactly-representable small ints d, s — so draw decisions
        # are deterministic even at exact ties (common: integer code
        # sums collide constantly).
        A_o = lag_o + me_o
        c2 = (tot / m) * (W_row + 1.0)                  # [n_padded, G]
    else:
        cp_o = cp_of(lag_o, me_o)
    if perm_method == "sort":
        base = key_for(seed, "perm_getis", 0)
    else:
        base = key_for(seed, "perm_feistel_getis", 0)
    cdt = (jnp.int8 if n_permutations <= 127
           else jnp.int16 if n_permutations <= 32767 else jnp.int32)

    def decide(lag_d, me_d):
        if star:
            A_d = lag_d + me_d
            if alternative == "greater":
                return A_d >= A_o
            if alternative == "less":
                return A_d <= A_o
            d = (A_d - A_o).astype(jnp.float32)
            s_ = (A_d + A_o).astype(jnp.float32)
            return d * (s_ - 2.0 * c2) >= 0.0
        cp_d = cp_of(lag_d, me_d)
        if alternative == "greater":
            ext = cp_d >= cp_o
        elif alternative == "less":
            ext = cp_d <= cp_o
        else:
            ext = jnp.abs(cp_d) >= jnp.abs(cp_o)
        # an exact (lag, own) pair tie means the draw statistic EQUALS
        # the observed in exact arithmetic — extreme under every
        # alternative, independent of f32 rounding
        return ext | ((lag_d == lag_o) & (me_d == me_o))

    def body(count, step):
        key = jax.random.fold_in(base, step)
        if perm_method == "sort":
            rows = jax.random.permutation(key, n)[rows_idx]
        else:
            rows = feistel_apply(key, rows_idx, n)
        extreme = decide(*lag_me_q(rows, Xq))
        return (count.astype(jnp.int32)
                + extreme.astype(jnp.int32)).astype(cdt), None

    count, _ = jax.lax.scan(body, jnp.zeros((n_padded, G), cdt),
                            jnp.arange(n_permutations))
    p = (count.astype(jnp.float32) + 1.0) / (n_permutations + 1.0)
    return p[rank]


def banded_getis(
    plan: NullPlan,
    X: jax.Array,
    seed: int,
    n_permutations: int,
    star: bool = True,
    alternative: str = "two-sided",
    precision: str = "f32",
    perm_method: str = "feistel",
    band_impl: str = "xla",
):
    """Getis-Ord permutation p_sim via the banded plan — see
    :func:`_banded_getis_p`. Observed G/z/analytic p should come from the
    exact direct kernel (``ops.getis.getis_ord`` with P=0).
    ``perm_method="sort"`` reproduces the direct kernel's draw stream.
    ``precision="int8"`` quantizes X per gene against the exact binary
    adjacency — see :func:`_banded_getis_p_i8`. ``band_impl`` accepts
    only ``"xla"``."""
    if precision not in ("bf16", "f32", "int8"):
        raise ValueError(
            f"banded_getis supports precision 'bf16', 'f32' or 'int8', "
            f"got {precision!r}")
    if alternative not in ("two-sided", "greater", "less"):
        raise ValueError(f"invalid alternative {alternative!r}")
    _check_perm_method(perm_method)
    _check_band_impl(band_impl)
    if precision == "int8":
        return _banded_getis_p_i8(
            plan.order, plan.rank, plan.local_idx, plan.w_local,
            plan.far_src, plan.far_dst, plan.far_w, X, jnp.uint32(seed),
            block=plan.block, n=plan.n, n_permutations=n_permutations,
            star=star, alternative=alternative, perm_method=perm_method)
    return _banded_getis_p(
        plan.order, plan.rank, plan.local_idx, plan.w_local, plan.far_src,
        plan.far_dst, plan.far_w, X, jnp.uint32(seed), block=plan.block,
        n=plan.n, n_permutations=n_permutations, star=star,
        alternative=alternative, precision=precision,
        perm_method=perm_method)


def banded_lees_l(
    plan: NullPlan,
    Zx: jax.Array,
    Zy: jax.Array,
    seed: int,
    n_permutations: int,
    precision: str = "bf16",
    compute_cell_pvalues: bool = False,
    perm_method: str = "feistel",
    band_impl: str = "xla",
):
    """Lee's L permutation p-values (global + optional per-cell) via the
    banded plan — see :func:`_banded_lees_p`. Observed L values should
    come from the exact direct kernel (``ops.lee.lees_l_pairs`` with
    ``n_permutations=0``); this only evaluates the null.
    ``perm_method="sort"`` reproduces the direct kernel's draw stream.
    ``precision="int8"`` runs the quantized-operator system (exact
    s8×s8→s32 band dots, int32 per-cell comparisons, k <= 1000) — see
    :func:`_banded_lees_p_i8`. ``band_impl`` accepts only ``"xla"``."""
    if precision not in ("bf16", "f32", "int8"):
        raise ValueError(
            f"banded_lees_l supports precision 'bf16', 'f32' or 'int8', "
            f"got {precision!r}")
    _check_perm_method(perm_method)
    _check_band_impl(band_impl)
    if precision == "int8":
        return _banded_lees_p_i8(
            plan.order, plan.rank, plan.local_idx, plan.w_local,
            plan.far_src, plan.far_dst, plan.far_w, Zx, Zy,
            jnp.uint32(seed), block=plan.block, n=plan.n,
            n_permutations=n_permutations, perm_method=perm_method,
            compute_cell_pvalues=compute_cell_pvalues)
    return _banded_lees_p(
        plan.order, plan.rank, plan.local_idx, plan.w_local, plan.far_src,
        plan.far_dst, plan.far_w, Zx, Zy, jnp.uint32(seed),
        block=plan.block, n=plan.n, n_permutations=n_permutations,
        precision=precision, compute_cell_pvalues=compute_cell_pvalues,
        perm_method=perm_method)


def banded_local_moran_pvalues(
    plan: NullPlan,
    Z: jax.Array,
    seed: int,
    n_permutations: int,
    perm_method: str = "feistel",
    band_impl: str = "xla",
    return_counts: bool = False,
) -> jax.Array:
    """LISA null p-values ONLY, int8 quantized-operator system.

    The p-only entry the streaming keys-mode driver uses
    (ops.streaming.streaming_local_null): unlike
    :func:`banded_local_moran` it never materializes the observed
    I/z/lag planes — at 1M cells x 512-gene tiles those are 3 x 2 GB
    of f32 that the caller may not even keep. Observed statistics should
    come from a fused post-pass that emits compact dtypes directly.

    ``Z`` may be pre-quantized int8 codes (from
    :func:`_quantize_z`) — the per-gene scale cancels inside the
    comparison, so codes alone determine the decisions. With
    ``return_counts`` the integer extreme counts come back instead of
    f32 p (int8 for P <= 127, int16 <= 32767): half (quarter) the
    output bytes, and the caller computes ``p = (c+1)/(P+1)`` per
    column chunk. ``band_impl`` accepts only ``"xla"``.
    """
    _check_perm_method(perm_method)
    _check_band_impl(band_impl)
    return _banded_local_moran_p_i8(
        plan.order, plan.rank, plan.local_idx, plan.w_local,
        plan.far_src, plan.far_dst, plan.far_w, Z, jnp.uint32(seed),
        block=plan.block, n=plan.n, n_permutations=n_permutations,
        perm_method=perm_method, return_counts=return_counts)


def banded_local_moran(
    plan: NullPlan,
    graph: SpatialGraph,
    Z: jax.Array,
    seed: int,
    n_permutations: int,
    precision: str = "bf16",
    perm_method: str = "feistel",
    band_impl: str = "xla",
):
    """Drop-in accelerated ``ops.moran.local_moran`` using a NullPlan.

    Observed I/z/lag come from the exact direct kernel (one lag pass over
    ``graph``); only the permutation nulls run through the banded
    machinery. Returns ``LocalMoranResult`` in the ORIGINAL cell order.
    With ``precision="f32"`` and ``perm_method="sort"`` the draws match
    the direct kernel (float summation order differs in the lag).

    ``precision="int8"`` runs the whole null system in the per-gene
    quantized operator (draws AND the observed comparison value — the
    same convention as the global int8 mode): exact s8×s8→s32 band dots,
    int8 row gathers, fully-integer int32 comparisons with int8 counters
    for P <= 127 (int16 up to 32767). The returned ``local_I/z/lag`` stay
    exact f32; only ``p_value`` uses the quantized operator.
    ``band_impl`` accepts only ``"xla"``.
    """
    from .moran import LocalMoranResult, local_moran

    _check_perm_method(perm_method)
    _check_band_impl(band_impl)
    obs = local_moran(graph, Z, seed, 0)
    if n_permutations == 0:
        return obs
    if precision == "int8":
        p = banded_local_moran_pvalues(
            plan, Z, seed, n_permutations, perm_method=perm_method)
        return LocalMoranResult(obs.local_I, obs.z, obs.lag, p)
    n_padded = plan.local_idx.shape[0]
    abs_obs_new = jnp.abs(obs.local_I)[plan.order]
    if n_padded > plan.n:
        # padded rows never win a comparison (inf observed)
        abs_obs_new = jnp.pad(abs_obs_new, ((0, n_padded - plan.n), (0, 0)),
                              constant_values=jnp.inf)
    p = _banded_local_moran_p(
        plan.order, plan.rank, plan.local_idx, plan.w_local, plan.far_src,
        plan.far_dst, plan.far_w, Z, abs_obs_new, jnp.uint32(seed),
        block=plan.block, n=plan.n, n_permutations=n_permutations,
        precision=precision, perm_method=perm_method)
    return LocalMoranResult(obs.local_I, obs.z, obs.lag, p)
