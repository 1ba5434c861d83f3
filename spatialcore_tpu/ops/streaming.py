"""Streaming permutation nulls for gene matrices beyond one device's memory.

The north-star scaling axis reaches N=1M cells x G~18k genes (SURVEY §5
long-context row): the f32 expression alone is 72 GB, more than one
80 GB card holds next to anything else. This module streams it:

* gene tiles of ``tile`` columns (default 2048) are fetched one at a
  time;
* prep (standardize -> bf16 + den + observed I) runs in <=``prep_chunk``
  gene chunks, which bounds the f32 standardize intermediates;
* permutation draws run in <=``chunk``-draw scans with extreme counts
  accumulated ON DEVICE, so the whole workload enqueues asynchronously:
  the host blocks once per tile boundary at most (to bound in-flight
  memory), and the previous tile's buffers free before the next tile's
  prep executes (in-order device queue);
* every (tile-width, chunk) combination reuses one compiled executable —
  the tail tile pads to tile/2 or tile so at most two widths compile.

Draw d of every tile uses the permutation keyed by ``(seed, d)``
(``draw_offset`` plumbs the global draw index through the chunked
calls), so the output is BITWISE identical to an unstreamed
``banded_permutation_test`` run at any tile/chunk split — the CLAUDE.md
counter-based-randomness rule, pinned by
tests/test_streaming.py::test_chunk_and_tile_split_invariance.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.logging import get_logger
from .banded import NullPlan, banded_permutation_test
from .graph import SpatialGraph
from .moran import standardize

logger = get_logger(__name__)


def tile_widths(n_genes: int, tile: int) -> list:
    """Tile-quantized gene schedule shared by this driver and bench.py.

    Full ``tile``-wide tiles; a tail NEXT TO full tiles rounds UP to the
    full tile (the padded tile reuses the one compiled executable
    instead of compiling a second width). A lone tail uses tile/2 when
    it fits (small single-tile runs shouldn't pay double).
    """
    widths = []
    rem = n_genes
    while rem > 0:
        if rem >= tile:
            widths.append(tile)
            rem -= tile
        elif widths:
            widths.append(tile)
            rem = 0
        else:
            widths.append(tile // 2 if rem <= tile // 2 else tile)
            rem = 0
    return widths


def streaming_moran_null(
    graph: SpatialGraph,
    plan: NullPlan,
    get_tile: Callable[[int, int, int], jax.Array],
    n_genes: int,
    S0: float,
    seed: int = 0,
    n_permutations: int = 1000,
    tile: int = 2048,
    prep_chunk: int = 1024,
    chunk: int = 200,
    stat: str = "moran",
    alternative: str = "greater",
    precision: str = "bf16",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Banded Moran/Geary permutation null over a streamed gene axis.

    ``get_tile(start, width, chunk_index)`` must return the raw [N, width]
    expression block for genes [start, start+width) — a device array (on-
    device generation / pre-staged buffers) or host numpy (uploaded once
    per tile). The returned buffer is CONSUMED (donated to the prep
    program); do not reuse it.

    ``precision="int8"`` stores each tile quantized per gene (half the
    bytes of bf16, exact s8×s8→s32 band dots — ops/banded.py), so a
    tile of the same bytes holds twice the genes.

    ``precision="int4"`` nibble-packs two gene codes per byte (split-half
    layout spanning the full tile — chunk pairs at half-tile offsets pack
    together, the bench.py recipe), halving the gathered bytes again.
    Requires even tiles; widths above ``prep_chunk`` must be multiples of
    ``2 * prep_chunk`` (the split-half pairing is chunk-granular).

    Returns host arrays ``(I_obs, p, null_mean, null_std)`` of length
    ``n_genes``. Peak device memory is one tile's quantized Z + the band
    matrix + one prep chunk's f32 intermediates, independent of
    ``n_genes``.
    """
    widths = tile_widths(n_genes, tile)
    padded = sum(widths)
    if precision == "int4":
        bad = [w for w in widths
               if w % 2 or (w > prep_chunk and w % (2 * prep_chunk))]
        if bad:
            raise ValueError(
                f"precision='int4' needs even tile widths that hold an "
                f"even prep-chunk count (split-half nibble packing); "
                f"schedule {widths} at prep_chunk={prep_chunk} violates "
                f"that (got tile={tile})")

    # donate X (the tile buffer is consumed) AND fuse the observed-I slot
    # loop to [g]-sized reductions: moran_observed's spatial_lag would
    # materialize a second [N, g] f32 temp next to input + Z + output
    @functools.partial(jax.jit, static_argnames=("g",), donate_argnums=(0,))
    def _prep(X, g):
        Z, _ = standardize(X)
        den = jnp.sum(Z * Z, axis=0)
        den = jnp.where(den > 0, den, 1.0)
        n = Z.shape[0]
        num = jnp.zeros((g,), jnp.float32)
        for j in range(graph.neighbor_idx.shape[1]):
            w = graph.neighbor_w[:, j:j + 1]
            if stat == "moran":
                num = num + jnp.sum(w * Z * Z[graph.neighbor_idx[:, j]],
                                    axis=0)
            else:  # geary: Σ w (z_i − z_nbr)² (ops/moran.py geary_observed)
                diff = Z - Z[graph.neighbor_idx[:, j]]
                num = num + jnp.sum(w * diff * diff, axis=0)
            # barrier THREADS Z: a barrier on num alone leaves XLA free to
            # hoist all k [N, g] gather temps to coexist (XLA's
            # gather-batching pathology)
            Z, num = jax.lax.optimization_barrier((Z, num))
        if stat == "moran":
            obs = (n / S0) * num / den
        else:
            obs = (n - 1) * num / (2.0 * S0 * den)
        if precision == "int8":
            from .banded import _quantize_z
            Zq, s_z = _quantize_z(Z)
            return Zq, den, obs, s_z
        if precision == "int4":
            # UNPACKED codes per chunk; the tile assembly packs across
            # the full tile (split-half pairing spans the tile, not the
            # chunk — _quantize_z4_codes docstring)
            from .banded import _quantize_z4_codes
            codes, s_z = _quantize_z4_codes(Z)
            return codes, den, obs, s_z
        return Z.astype(jnp.bfloat16), den, obs, jnp.ones((g,), jnp.float32)

    I_parts, p_parts, m_parts, s_parts = [], [], [], []
    prev = None
    start = 0
    for bi, w in enumerate(widths):
        # materialize tile bi-1's results BEFORE enqueueing tile bi's
        # prep: the sync guarantees the previous tile's working set is
        # free before this tile allocates; within a tile everything still
        # enqueues asynchronously
        if prev is not None:
            for lst, arr in zip((I_parts, p_parts, m_parts, s_parts), prev):
                lst.append(np.asarray(arr))
            prev = None
        parts = []
        for ci, s in enumerate(range(0, w, prep_chunk)):
            g = min(prep_chunk, w - s)
            avail = max(0, min(g, n_genes - (start + s)))
            if avail > 0:
                X = get_tile(start + s, avail, ci)
                if not isinstance(X, jax.Array):
                    X = jnp.asarray(np.asarray(X, np.float32))
                X = X.astype(jnp.float32)
                if avail < g:   # tail tile rounds up to a compiled width;
                    #             zero columns are inert (zero-variance)
                    X = jnp.pad(X, ((0, 0), (0, g - avail)))
            else:
                X = jnp.zeros((graph.neighbor_idx.shape[0], g), jnp.float32)
            # block per prep chunk: keeps at most one prep program's
            # temps in flight next to the accumulated parts
            parts.append(jax.block_until_ready(_prep(X, g)))
        if precision == "int4":
            # pack HALF-OFFSET chunk pairs (global split-half layout:
            # packed column j pairs gene j with gene j + w/2) without
            # ever concatenating the full-width unpacked code matrix
            from .banded import _pack_codes
            if len(parts) > 1 and len(parts) % 2:
                raise ValueError(
                    f"precision='int4' tiles above prep_chunk must hold "
                    f"an even chunk count (w % (2*prep_chunk) == 0); got "
                    f"width {w} at prep_chunk={prep_chunk}")
            pk = jax.jit(_pack_codes)
            if len(parts) == 1:
                Zb = pk(parts[0][0])        # splits the lone chunk in half
            else:
                h = len(parts) // 2
                packed = [pk(parts[i][0], parts[i + h][0])
                          for i in range(h)]
                Zb = packed[0] if h == 1 else jnp.concatenate(
                    packed, axis=1)
            den = jnp.concatenate([p[1] for p in parts]) \
                if len(parts) > 1 else parts[0][1]
            obs = jnp.concatenate([p[2] for p in parts]) \
                if len(parts) > 1 else parts[0][2]
            szv = jnp.concatenate([p[3] for p in parts]) \
                if len(parts) > 1 else parts[0][3]
        elif len(parts) == 1:
            Zb, den, obs, szv = parts[0]
        else:
            Zb = jnp.concatenate([p[0] for p in parts], axis=1)
            den = jnp.concatenate([p[1] for p in parts])
            obs = jnp.concatenate([p[2] for p in parts])
            szv = jnp.concatenate([p[3] for p in parts])
        jax.block_until_ready(Zb)
        del parts

        count = jnp.zeros((w,), jnp.float32)
        mean_acc = jnp.zeros((w,), jnp.float32)
        m2_acc = jnp.zeros((w,), jnp.float32)
        for ci, s in enumerate(range(0, n_permutations, chunk)):
            pc = min(chunk, n_permutations - s)
            # draws keyed by GLOBAL draw index (draw_offset=s), one seed:
            # results are bitwise independent of the chunk split AND of
            # the tile split — every tile sees the same permutation for
            # draw d, exactly like an unstreamed run (CLAUDE.md hard rule)
            p, m, sd = banded_permutation_test(
                plan, Zb, S0, obs, seed=seed,
                n_permutations=pc, den=den, stat=stat,
                alternative=alternative, precision=precision,
                sz=szv if precision in ("int8", "int4") else None,
                draw_offset=s)
            count = count + jnp.round(p * (pc + 1.0) - 1.0)
            mean_acc = mean_acc + m * pc
            m2_acc = m2_acc + (sd * sd + m * m) * pc
        P = n_permutations
        p_tile = (count + 1.0) / (P + 1.0)
        mean_tile = mean_acc / P
        std_tile = jnp.sqrt(jnp.maximum(m2_acc / P - mean_tile ** 2, 0.0))

        prev = (obs, p_tile, mean_tile, std_tile)
        del Zb, den, szv
        start += w
    for lst, arr in zip((I_parts, p_parts, m_parts, s_parts), prev):
        lst.append(np.asarray(arr))

    out = tuple(np.concatenate(ps)[:n_genes]
                for ps in (I_parts, p_parts, m_parts, s_parts))
    if padded != n_genes:
        logger.info(f"streaming null: padded {n_genes} -> {padded} genes "
                    f"({len(widths)} tiles)")
    return out

# ---------------------------------------------------------------------------
# Streaming LOCAL-statistic nulls
# ---------------------------------------------------------------------------

#: compact device dtypes for local outputs beyond device memory:
#: decisions keep full
#: fidelity (p as f16 loses <0.1% of a 1/(P+1)-grained value; quadrant is
#: categorical int8); observed statistics downcast to bf16 (8-bit
#: precision class — same as the int8 null operator they accompany)
_COMPACT_DTYPES = {
    "I": jnp.bfloat16, "z": jnp.bfloat16, "lag": jnp.bfloat16,
    "C": jnp.bfloat16, "G": jnp.bfloat16, "z_score": jnp.bfloat16,
    "L": jnp.bfloat16,
    "p": jnp.float16, "p_adj": jnp.float16, "p_sim": jnp.float16,
    "quadrant": jnp.int8, "hotspot": jnp.int8,
}


def host_local_sink(n_cells: int, n_genes: int):
    """(sink, store) pair flushing each tile's outputs to host numpy.

    The store maps key -> [N, n_genes] f32/int8 numpy arrays, allocated
    lazily on the first tile (keys depend on the statistic). This is the
    right sink when the outputs exceed device memory; otherwise
    :func:`device_local_sink` avoids the per-tile host copies.
    """
    store: Dict[str, np.ndarray] = {}

    def sink(start: int, avail: int, outs: Dict[str, jax.Array]) -> None:
        for key, arr in outs.items():
            if key not in store:
                dt = np.int8 if key == "quadrant" else np.float32
                fill = (np.ones if key.startswith("p") else np.zeros)
                store[key] = fill((n_cells, n_genes), dt)
            store[key][:, start:start + avail] = np.asarray(
                arr[:, :avail], store[key].dtype)

    return sink, store


def device_local_sink(n_genes: int, keys: Optional[tuple] = None):
    """(sink, finalize) pair keeping outputs DEVICE-resident in compact
    dtypes (:data:`_COMPACT_DTYPES`).

    ``keys`` limits what is kept (e.g. ``("I", "p_adj", "quadrant")`` at
    1M x 2048 = ~9 GB instead of 6 f32 planes' 48 GB); ``None`` keeps
    everything the statistic produces, compact. ``finalize()`` returns
    the concatenated [N, n_genes] arrays (per-tile parts are freed as
    they are consumed, the round-3 ``_concat_device_batches`` lesson).
    """
    parts: Dict[str, list] = {}

    def sink(start: int, avail: int, outs: Dict[str, jax.Array]) -> None:
        for key, arr in outs.items():
            if keys is not None and key not in keys:
                continue
            dt = _COMPACT_DTYPES.get(key, jnp.bfloat16)
            parts.setdefault(key, []).append(arr[:, :avail].astype(dt))

    def finalize() -> Dict[str, jax.Array]:
        out = {}
        for key in list(parts):
            cols = parts.pop(key)
            out[key] = cols[0] if len(cols) == 1 else jnp.concatenate(
                cols, axis=1)
            cols.clear()
        return out

    return sink, finalize


def streaming_local_null(
    graph: SpatialGraph,
    plan: NullPlan,
    get_tile: Callable[[int, int], jax.Array],
    n_genes: int,
    sink: Callable[[int, int, Dict[str, jax.Array]], None],
    stat: str = "moran",
    seed: int = 0,
    n_permutations: int = 100,
    tile: int = 512,
    fdr: str = "fdr_bh",
    alpha: float = 0.05,
    star: bool = True,
    alternative: str = "two-sided",
    precision: str = "int8",
    keys: Optional[Tuple[str, ...]] = None,
    post_chunk: int = 128,
    obs_dtype: str = "f32",
) -> None:
    """LOCAL-statistic permutation nulls over a streamed gene axis.

    Runs LISA (``stat="moran"``), local Geary (``"geary"``), Getis-Ord
    Gi/Gi* (``"getis"``) or local Lee's L (``"lee"``; ``get_tile`` then
    returns a ``(X, Y)`` tuple of pair columns and ``n_genes`` counts
    PAIRS) in ``tile``-wide gene tiles through the banded int8 null
    operators (ops/banded.py), handing each tile's [N, tile] outputs to
    ``sink(start, avail, outs)`` — so 1M cells x thousands of genes of
    local nulls run on one device without ever materializing the full
    [N, G] f32 planes (6 x 8 GB at G=2048). Dethrones the reference's
    nested Python loops over cells x genes x perms
    (/root/reference/src/spatialcore/spatial/autocorrelation.py:877-896).

    * every tile reuses ONE compiled executable (tails zero-pad to
      ``tile`` — inert zero-variance columns, sliced off before the
      sink);
    * draw d of every tile uses the permutation keyed by (seed, d), so
      results are bitwise-independent of the tile split;
    * per-gene FDR (axis 0) is tile-separable and computed on device;
    * the host blocks once per tile (bounds in-flight memory to one
      tile's working set next to the sink's accumulation).

    Output keys per stat: moran -> I, z, lag, p, p_adj, quadrant;
    geary -> C, p, p_adj; getis -> G, z_score, p (analytic), p_sim,
    p_adj (BH over p_sim), hotspot (int8: 1 hot / -1 cold at ``alpha``
    after FDR, 0 NS — the ``getis_ord_gi`` convention); lee -> L, lag,
    p, p_adj, quadrant (quadrants classify Zx against lag(Zy), the
    ``lees_l_local`` convention).

    ``keys`` selects the LEAN path: only the named planes are computed,
    in ONE fused post-pass jit per tile that emits them already in the
    compact dtypes of :data:`_COMPACT_DTYPES` — unused planes are
    dead-code-eliminated by XLA instead of materialized-then-dropped by
    the sink. Without it each moran tile transiently holds ~10 f32
    [N, tile] planes (observed I/z/lag/p, the kernel p, and the
    where-masked copy of every output key): ~20 GB at 1M x 512. The
    post-pass additionally chunks its column math
    (``post_chunk`` columns per `lax.map` step — every output plane is
    per-gene independent, including the axis-0 FDR) so its own temps
    stay ~[N, post_chunk]. p-values are bitwise identical to the
    default path (same kernel call); compact planes equal the default
    path's sink-side casts.

    ``obs_dtype="bf16"`` (keys-mode ``stat="moran"`` +
    ``precision="int8"`` only) is the WIDE-tile memory recipe: prep
    quantizes each tile chunkwise and keeps only int8 codes + a bf16
    copy of Z, the kernel returns integer extreme COUNTS
    (:func:`ops.banded.banded_local_moran_pvalues` ``return_counts``),
    and the post-pass computes p per column chunk — so no f32 [N, tile]
    plane (Z or p) is ever resident (tile=512's ledger below holds 4 GB
    of Z + 4 GB of kernel p). p/p_adj stay BITWISE equal to the f32-obs path
    (same integer counts); I/z/lag/quadrant are computed from bf16 Z —
    same precision class as the bf16 compact casts, but not bit-equal
    to casting the f32-computed planes (quadrant sign flips only on
    |z| or |lag| below bf16 resolution).
    """
    from .banded import (banded_getis, banded_lees_l, banded_local_geary,
                         banded_local_moran, banded_local_moran_pvalues)
    from .fdr import apply_fdr
    from .getis import getis_ord
    from .lee import lees_l_pairs
    from .moran import classify_quadrants, local_geary, local_moran

    if stat not in ("moran", "geary", "getis", "lee"):
        raise ValueError(
            f"stat must be 'moran', 'geary', 'getis' or 'lee', "
            f"got {stat!r}")
    n_cells = graph.neighbor_idx.shape[0]
    if obs_dtype not in ("f32", "bf16"):
        raise ValueError(f"obs_dtype must be 'f32' or 'bf16', got "
                         f"{obs_dtype!r}")
    if obs_dtype == "bf16" and (stat != "moran" or precision != "int8"
                                or keys is None):
        raise ValueError("obs_dtype='bf16' is the wide-tile moran recipe: "
                         "requires stat='moran', precision='int8' and "
                         "keys-mode")
    _ALL_KEYS = {"moran": ("I", "z", "lag", "p", "p_adj", "quadrant"),
                 "geary": ("C", "p", "p_adj"),
                 "getis": ("G", "z_score", "p", "p_sim", "p_adj",
                           "hotspot"),
                 "lee": ("L", "lag", "p", "p_adj", "quadrant")}[stat]
    if keys is not None:
        bad = [k for k in keys if k not in _ALL_KEYS]
        if bad:
            raise ValueError(
                f"unknown keys {bad} for stat={stat!r}; available: "
                f"{_ALL_KEYS}")
        _stream_local_lean(
            graph, plan, get_tile, n_genes, sink, stat, seed,
            n_permutations, tile, fdr, alpha, star, alternative,
            precision, tuple(keys), post_chunk, obs_dtype)
        return

    def _f32_tile(X):
        if not isinstance(X, jax.Array):
            X = jnp.asarray(np.asarray(X, np.float32))
        X = X.astype(jnp.float32)
        if avail < tile:
            X = jnp.pad(X, ((0, 0), (0, tile - avail)))
        return X

    for start in range(0, n_genes, tile):
        avail = min(tile, n_genes - start)
        if stat == "lee":
            Xr, Yr = get_tile(start, avail)
            Zx, zvx = standardize(_f32_tile(Xr))
            Zy, zvy = standardize(_f32_tile(Yr))
            zv = (zvx | zvy)[None, :]
            res = lees_l_pairs(graph, Zx, Zy, seed, 0)   # exact observed
            _, p_l = banded_lees_l(plan, Zx, Zy, seed, n_permutations,
                                   precision=precision,
                                   compute_cell_pvalues=True)
            p = jnp.where(zv, 1.0, p_l)
            p_adj = apply_fdr(p, fdr, axis=0,
                              n_levels=n_permutations + 1)
            quad = classify_quadrants(Zx, res.lag_zy, p_adj, alpha)
            outs = {"L": jnp.where(zv, 0.0, res.L_local),
                    "lag": jnp.where(zv, 0.0, res.lag_zy),
                    "p": p, "p_adj": p_adj,
                    "quadrant": jnp.where(zv, jnp.int8(0), quad)}
            jax.block_until_ready(outs["p_adj"])
            sink(start, avail, outs)
            del outs, Zx, Zy
            continue
        X = _f32_tile(get_tile(start, avail))
        if stat == "getis":
            obs = getis_ord(graph, X, star=star, alternative=alternative,
                            n_permutations=0)
            p_sim = banded_getis(plan, X, seed, n_permutations, star=star,
                                 alternative=alternative,
                                 precision=precision)
            p_adj = apply_fdr(p_sim, fdr, axis=0,
                              n_levels=n_permutations + 1)
            hot = jnp.where(p_adj < alpha,
                            jnp.sign(obs.z_score).astype(jnp.int8),
                            jnp.int8(0))
            outs = {"G": obs.G, "z_score": obs.z_score, "p": obs.p_value,
                    "p_sim": p_sim, "p_adj": p_adj, "hotspot": hot}
        else:
            Z, zero_var = standardize(X)
            if stat == "moran":
                res = banded_local_moran(plan, graph, Z, seed,
                                         n_permutations,
                                         precision=precision)
                p = jnp.where(zero_var[None, :], 1.0, res.p_value)
                p_adj = apply_fdr(p, fdr, axis=0,
                                  n_levels=n_permutations + 1)
                quad = classify_quadrants(res.z, res.lag, p_adj, alpha)
                zv = zero_var[None, :]
                outs = {"I": jnp.where(zv, 0.0, res.local_I),
                        "z": jnp.where(zv, 0.0, res.z),
                        "lag": jnp.where(zv, 0.0, res.lag),
                        "p": p, "p_adj": p_adj,
                        "quadrant": jnp.where(zv, jnp.int8(0), quad)}
            else:
                obs = local_geary(graph, Z, seed, 0)
                _, p = banded_local_geary(plan, Z, seed, n_permutations,
                                          precision=precision)
                p = jnp.where(zero_var[None, :], 1.0, p)
                p_adj = apply_fdr(p, fdr, axis=0,
                                  n_levels=n_permutations + 1)
                outs = {"C": jnp.where(zero_var[None, :], 0.0, obs.local_C),
                        "p": p, "p_adj": p_adj}
        # one host sync per tile: bounds in-flight memory to this tile's
        # working set before the next tile's prep enqueues (in-order
        # device queue — the streaming_moran_null lesson)
        jax.block_until_ready(outs["p_adj"] if "p_adj" in outs else outs)
        sink(start, avail, outs)
        del outs, X


def _stream_local_lean(graph, plan, get_tile, n_genes, sink, stat, seed,
                       n_permutations, tile, fdr, alpha, star,
                       alternative, precision, keys, post_chunk,
                       obs_dtype="f32"):
    """The ``keys=``-selected lean tile loop of
    :func:`streaming_local_null` — see its docstring for the contract.

    Memory ledger per moran tile at 1M x 512 (the default path's ~20 GB
    transient is the sum of lines it no longer pays):

    * Z f32 [N, tile]                         2.0 GB
    * kernel p f32 [N, tile] (p-ONLY entry,   2.0 GB
      :func:`ops.banded.banded_local_moran_pvalues` — the public
      wrapper's observed I/z/lag planes never exist)
    * fused post-pass temps: ~[N, post_chunk] <0.5 GB
    * compact outputs (I bf16 + p/p_adj f16 + 3.5 GB
      quadrant int8 at the public 7 B/cell/gene)

    so a device-resident G=2048 sink (7 B -> 14 GB total output...) still
    needs key pruning; at the bench's 5 B keys the loop peaks ~8 GB next
    to a 7.7 GB sink on the last tile.
    """
    from .banded import (banded_getis, banded_lees_l, banded_local_geary,
                         banded_local_moran, banded_local_moran_pvalues)
    from .fdr import apply_fdr
    from .getis import getis_ord
    from .lee import lees_l_pairs
    from .moran import classify_quadrants, local_geary, local_moran

    c = min(post_chunk, tile)
    if tile % c:
        c = tile          # keep the chunk reshape exact for odd tiles
    starts_c = jnp.arange(0, tile, c)

    def _compact(key, arr):
        return arr.astype(_COMPACT_DTYPES.get(key, jnp.bfloat16))

    def _cols(a, s):
        return jax.lax.dynamic_slice_in_dim(a, s, c, axis=1)

    def _assemble(parts):
        # [nc, N, c] per key -> [N, tile]; chunk-major column order is
        # the original order (chunk i holds columns [i*c, (i+1)*c))
        return {k: jnp.swapaxes(v, 0, 1).reshape(v.shape[1], -1)
                for k, v in parts.items()}

    counts_in = obs_dtype == "bf16"
    if stat == "moran":
        def _post(Z, p_raw, zero_var):
            def one(s):
                Zc, pc = _cols(Z, s), _cols(p_raw, s)
                if counts_in:   # integer extreme counts -> p per chunk
                    pc = (pc.astype(jnp.float32) + 1.0) / (
                        n_permutations + 1.0)
                zv = jax.lax.dynamic_slice(zero_var, (s,), (c,))[None, :]
                obs = local_moran(graph, Zc, seed, 0)
                p = jnp.where(zv, 1.0, pc)
                p_adj = apply_fdr(p, fdr, axis=0,
                                  n_levels=n_permutations + 1)
                quad = classify_quadrants(obs.z, obs.lag, p_adj, alpha)
                full = {"I": jnp.where(zv, 0.0, obs.local_I),
                        "z": jnp.where(zv, 0.0, obs.z),
                        "lag": jnp.where(zv, 0.0, obs.lag),
                        "p": p, "p_adj": p_adj,
                        "quadrant": jnp.where(zv, jnp.int8(0), quad)}
                return {k: _compact(k, full[k]) for k in keys}
            return _assemble(jax.lax.map(one, starts_c))
    elif stat == "geary":
        def _post(Z, p_raw, zero_var):
            def one(s):
                Zc, pc = _cols(Z, s), _cols(p_raw, s)
                zv = jax.lax.dynamic_slice(zero_var, (s,), (c,))[None, :]
                obs = local_geary(graph, Zc, seed, 0)
                p = jnp.where(zv, 1.0, pc)
                p_adj = apply_fdr(p, fdr, axis=0,
                                  n_levels=n_permutations + 1)
                full = {"C": jnp.where(zv, 0.0, obs.local_C),
                        "p": p, "p_adj": p_adj}
                return {k: _compact(k, full[k]) for k in keys}
            return _assemble(jax.lax.map(one, starts_c))
    elif stat == "getis":
        def _post(X, p_sim):
            def one(s):
                Xc, pc = _cols(X, s), _cols(p_sim, s)
                obs = getis_ord(graph, Xc, star=star,
                                alternative=alternative,
                                n_permutations=0)
                p_adj = apply_fdr(pc, fdr, axis=0,
                                   n_levels=n_permutations + 1)
                hot = jnp.where(p_adj < alpha,
                                jnp.sign(obs.z_score).astype(jnp.int8),
                                jnp.int8(0))
                full = {"G": obs.G, "z_score": obs.z_score,
                        "p": obs.p_value, "p_sim": pc, "p_adj": p_adj,
                        "hotspot": hot}
                return {k: _compact(k, full[k]) for k in keys}
            return _assemble(jax.lax.map(one, starts_c))
    else:
        def _post(Zx, Zy, p_raw, zero_var):
            def one(s):
                Zxc, Zyc = _cols(Zx, s), _cols(Zy, s)
                pc = _cols(p_raw, s)
                zv = jax.lax.dynamic_slice(zero_var, (s,), (c,))[None, :]
                res = lees_l_pairs(graph, Zxc, Zyc, seed, 0)
                p = jnp.where(zv, 1.0, pc)
                p_adj = apply_fdr(p, fdr, axis=0,
                                  n_levels=n_permutations + 1)
                quad = classify_quadrants(Zxc, res.lag_zy, p_adj, alpha)
                full = {"L": jnp.where(zv, 0.0, res.L_local),
                        "lag": jnp.where(zv, 0.0, res.lag_zy),
                        "p": p, "p_adj": p_adj,
                        "quadrant": jnp.where(zv, jnp.int8(0), quad)}
                return {k: _compact(k, full[k]) for k in keys}
            return _assemble(jax.lax.map(one, starts_c))
    post = jax.jit(_post)
    std = jax.jit(standardize)

    def _f32_pad(X, avail, width):
        if not isinstance(X, jax.Array):
            X = jnp.asarray(np.asarray(X, np.float32))
        X = X.astype(jnp.float32)
        if avail < width:
            X = jnp.pad(X, ((0, 0), (0, width - avail)))
        return X

    def _f32_tile(X, avail):
        return _f32_pad(X, avail, tile)

    if counts_in:
        from .banded import _quantize_z

        @jax.jit
        def _prep_q(Xc):
            # ONE jit: the f32 Z is a fusion-internal temp — only int8
            # codes + the bf16 copy + the zero-variance mask leave
            Zc, zvc = standardize(Xc)
            return _quantize_z(Zc)[0], Zc.astype(jnp.bfloat16), zvc

        def _prep_tile_q(start, avail):
            pcw = min(512, tile)
            Zq_p, Zb_p, zv_p = [], [], []
            for s2 in range(0, tile, pcw):
                av2 = max(0, min(pcw, avail - s2))
                if av2 > 0:
                    Xc = _f32_pad(get_tile(start + s2, av2), av2, pcw)
                else:   # tail padding: inert zero-variance columns
                    Xc = jnp.zeros((n_cells, pcw), jnp.float32)
                # block per chunk: at most one prep program's f32 temps
                # in flight next to the growing code/bf16 buffers
                Zqc, Zbc, zvc = jax.block_until_ready(_prep_q(Xc))
                Zq_p.append(Zqc)
                Zb_p.append(Zbc)
                zv_p.append(zvc)
                del Xc
            cat = (lambda ps, ax: ps[0] if len(ps) == 1
                   else jnp.concatenate(ps, axis=ax))
            return cat(Zq_p, 1), cat(Zb_p, 1), cat(zv_p, 0)

    for start in range(0, n_genes, tile):
        avail = min(tile, n_genes - start)
        if stat == "lee":
            Xr, Yr = get_tile(start, avail)
            Zx, zvx = std(_f32_tile(Xr, avail))
            Zy, zvy = std(_f32_tile(Yr, avail))
            del Xr, Yr
            _, p_raw = banded_lees_l(plan, Zx, Zy, seed, n_permutations,
                                     precision=precision,
                                     compute_cell_pvalues=True)
            outs = post(Zx, Zy, p_raw, zvx | zvy)
            del Zx, Zy, p_raw
        elif stat == "getis":
            X = _f32_tile(get_tile(start, avail), avail)
            p_sim = banded_getis(plan, X, seed, n_permutations,
                                 star=star, alternative=alternative,
                                 precision=precision)
            outs = post(X, p_sim)
            del X, p_sim
        elif counts_in:
            # wide-tile moran recipe: int8 codes feed the kernel, counts
            # come back, bf16 Z feeds the post — no f32 [N, tile] plane
            Zq, Zb, zero_var = _prep_tile_q(start, avail)
            cnt = banded_local_moran_pvalues(
                plan, Zq, seed, n_permutations, return_counts=True)
            del Zq
            outs = post(Zb, cnt, zero_var)
            del Zb, cnt
        else:
            Z, zero_var = std(_f32_tile(get_tile(start, avail), avail))
            if stat == "moran":
                if precision == "int8":
                    p_raw = banded_local_moran_pvalues(
                        plan, Z, seed, n_permutations)
                else:
                    p_raw = banded_local_moran(
                        plan, graph, Z, seed, n_permutations,
                        precision=precision).p_value
            else:
                _, p_raw = banded_local_geary(
                    plan, Z, seed, n_permutations, precision=precision)
            outs = post(Z, p_raw, zero_var)
            del Z, p_raw
        # one host sync per tile bounds in-flight memory (see the
        # default path); compact planes are all that remains in flight
        jax.block_until_ready(outs[keys[0]])
        sink(start, avail, outs)
        del outs
