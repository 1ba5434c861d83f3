"""Streaming gene-axis nulls (ops/streaming.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from spatialcore_tpu.ops.banded import banded_permutation_test, build_null_plan
from spatialcore_tpu.ops.graph import build_graph
from spatialcore_tpu.ops.moran import moran_observed, standardize
from spatialcore_tpu.ops.streaming import streaming_moran_null


def _world(n=600, g=40, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 500, (n, 2)).astype(np.float32)
    X = rng.standard_normal((n, g)).astype(np.float32)
    X[:, 0] += np.sin(coords[:, 0] / 30) * 2
    return coords, X


def test_streaming_single_tile_matches_direct():
    """n_genes < tile: one tile, one chunk — must equal the direct call."""
    coords, X = _world()
    n, g = X.shape
    graph = build_graph(coords, n_neighbors=6)
    plan = build_null_plan(graph, block=64)
    S0 = float(n)

    I, p, m, s = streaming_moran_null(
        graph, plan, lambda st, w, ci: jnp.asarray(X[:, st:st + w]),
        n_genes=g, S0=S0, seed=5, n_permutations=30, tile=64,
        prep_chunk=64, chunk=64)

    Z, _ = standardize(jnp.asarray(np.pad(X, ((0, 0), (0, 64 - g)))))
    obs = moran_observed(graph, Z, S0)
    p_ref, m_ref, s_ref = banded_permutation_test(
        plan, Z, S0, obs, seed=5, n_permutations=30)
    # the count -> p round-trip reassociates one f32 division: compare the
    # exact integer extreme counts, not the 1-ulp-differing quotients
    np.testing.assert_array_equal(np.round(p * 31 - 1),
                                  np.round(np.asarray(p_ref)[:g] * 31 - 1))
    np.testing.assert_allclose(I, np.asarray(obs)[:g], rtol=1e-5)
    np.testing.assert_allclose(m, np.asarray(m_ref)[:g], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(s, np.asarray(s_ref)[:g], rtol=1e-3,
                               atol=1e-4)


def test_streaming_multi_tile_shapes_and_consistency():
    """3.5 tiles with a padded tail + multi-chunk draws: the observed I
    must equal the unstreamed computation and p-values must be sane."""
    coords, X = _world(n=500, g=56)
    n, g = X.shape
    graph = build_graph(coords, n_neighbors=6)
    plan = build_null_plan(graph, block=64)
    S0 = float(n)

    I, p, m, s = streaming_moran_null(
        graph, plan, lambda st, w, ci: jnp.asarray(X[:, st:st + w]),
        n_genes=g, S0=S0, seed=1, n_permutations=20, tile=16,
        prep_chunk=8, chunk=8)
    assert I.shape == p.shape == m.shape == s.shape == (g,)

    Z, _ = standardize(jnp.asarray(X))
    obs = np.asarray(moran_observed(graph, Z, S0))
    np.testing.assert_allclose(I, obs, rtol=1e-4, atol=1e-6)
    # structured gene 0 is strongly autocorrelated; p must be extreme
    assert p[0] == 1.0 / 21.0
    assert (p > 0).all() and (p <= 1).all()
    # null moments near the analytic expectation E[I] = -1/(n-1)
    assert abs(m.mean() - (-1.0 / (n - 1))) < 0.01


def test_streaming_int8_matches_bf16_decisions():
    """precision="int8" streams quantized tiles; decisions must match the
    f32 path and observed I stays the exact f32 value."""
    coords, X = _world(n=500, g=48, seed=3)
    n, g = X.shape
    graph = build_graph(coords, n_neighbors=6)
    plan = build_null_plan(graph, block=64)
    S0 = float(n)

    kw = dict(n_genes=g, S0=S0, seed=2, n_permutations=49, tile=32,
              prep_chunk=16, chunk=25)
    I8, p8, m8, s8 = streaming_moran_null(
        graph, plan, lambda st, w, ci: jnp.asarray(X[:, st:st + w]),
        precision="int8", **kw)
    I32, p32, m32, s32 = streaming_moran_null(
        graph, plan, lambda st, w, ci: jnp.asarray(X[:, st:st + w]),
        precision="f32", **kw)
    assert I8.shape == p8.shape == (g,)
    # observed I is computed in f32 BEFORE quantization: exact match
    np.testing.assert_allclose(I8, I32, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(p8, p32, atol=0.05)
    assert ((p8 < 0.05) == (p32 < 0.05)).all()
    np.testing.assert_allclose(m8, m32, atol=5e-3)


def test_streaming_int4_matches_prepacked_direct():
    """precision="int4" streams nibble-packed tiles (round-4 headline
    operator). Counts must be bitwise equal to the direct pre-packed
    banded call at any prep-chunk split, and decisions must track f32
    within the documented int4 tolerance (docs/performance.md)."""
    from spatialcore_tpu.ops.banded import _quantize_z4

    coords, X = _world(n=800, g=256, seed=13)
    n, g = X.shape
    graph = build_graph(coords, n_neighbors=6)
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(n)
    P = 29

    def run4(prep_chunk):
        return streaming_moran_null(
            graph, plan, lambda st, w, ci: jnp.asarray(X[:, st:st + w]),
            n_genes=g, S0=S0, seed=4, n_permutations=P, tile=256,
            prep_chunk=prep_chunk, chunk=16, precision="int4")

    # two-part split-half packing vs the lone-chunk internal split
    I2, p2, m2, s2 = run4(prep_chunk=128)
    I1, p1, m1, s1 = run4(prep_chunk=256)
    np.testing.assert_array_equal(p2, p1)

    # direct pre-packed call (the bench.py route) — same counts
    Z, _ = standardize(jnp.asarray(X))
    den = jnp.sum(Z * Z, axis=0)
    obs = moran_observed(graph, Z, S0)
    Zpk, s4 = _quantize_z4(Z)
    p_ref, _, _ = banded_permutation_test(
        plan, Zpk, S0, obs, seed=4, n_permutations=P, precision="int4",
        den=den, sz=s4)
    np.testing.assert_array_equal(np.round(p2 * (P + 1) - 1),
                                  np.round(np.asarray(p_ref) * (P + 1) - 1))

    # observed I is exact f32 (computed before quantization); decisions
    # track the f32 stream within the int4 tolerance class
    np.testing.assert_allclose(I2, np.asarray(obs), rtol=1e-5, atol=1e-7)
    _, p32, _, _ = streaming_moran_null(
        graph, plan, lambda st, w, ci: jnp.asarray(X[:, st:st + w]),
        n_genes=g, S0=S0, seed=4, n_permutations=P, tile=256,
        prep_chunk=128, chunk=16, precision="f32")
    assert np.mean((p2 < 0.05) != (p32 < 0.05)) <= 0.05

    # invalid schedules fail loudly: an odd tile, and a tile above
    # prep_chunk that holds an odd number of prep chunks
    for n_genes, tile, prep_chunk in ((65, 130, 64), (192, 192, 128)):
        with pytest.raises(ValueError, match="int4"):
            streaming_moran_null(
                graph, plan, lambda st, w, ci: jnp.asarray(X[:, st:st + w]),
                n_genes=n_genes, S0=S0, seed=4, n_permutations=4,
                tile=tile, prep_chunk=prep_chunk, precision="int4")


def test_chunk_and_tile_split_invariance():
    """CLAUDE.md hard rule: p-values are bitwise identical across chunk
    sizes AND tile splits (draws keyed by global draw index; every tile
    sees the same permutation for draw d)."""
    coords, X = _world(n=400, g=48, seed=7)
    n, g = X.shape
    graph = build_graph(coords, n_neighbors=6)
    plan = build_null_plan(graph, block=64)
    S0 = float(n)

    def run(tile, chunk):
        return streaming_moran_null(
            graph, plan, lambda st, w, ci: jnp.asarray(X[:, st:st + w]),
            n_genes=g, S0=S0, seed=11, n_permutations=24, tile=tile,
            prep_chunk=16, chunk=chunk)

    I0, p0, m0, s0 = run(tile=48, chunk=24)     # one tile, one chunk
    for tile, chunk in ((48, 8), (16, 24), (16, 8)):
        I1, p1, m1, s1 = run(tile, chunk)
        np.testing.assert_array_equal(p0, p1)   # exact: integer counts
        np.testing.assert_allclose(m0, m1, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(s0, s1, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(I0, I1, rtol=1e-6)


def test_streaming_geary_observed_is_geary():
    """stat="geary" must return Geary C as the observed statistic and
    count extremes against it (was: Moran observed vs Geary draws)."""
    from spatialcore_tpu.ops.moran import geary_observed

    coords, X = _world(n=400, g=24, seed=9)
    n, g = X.shape
    graph = build_graph(coords, n_neighbors=6)
    plan = build_null_plan(graph, block=64)
    S0 = float(n)

    C, p, m, s = streaming_moran_null(
        graph, plan, lambda st, w, ci: jnp.asarray(X[:, st:st + w]),
        n_genes=g, S0=S0, seed=2, n_permutations=30, tile=32,
        prep_chunk=16, chunk=15, stat="geary", alternative="less")
    Z, _ = standardize(jnp.asarray(np.pad(X, ((0, 0), (0, 32 - g)))))
    C_ref = np.asarray(geary_observed(graph, Z, S0))[:g]
    np.testing.assert_allclose(C, C_ref, rtol=1e-4, atol=1e-6)
    # gene 0 is spatially structured: C < 1 and the less-tail p is small
    assert C[0] < 0.9
    assert p[0] <= 2.0 / 31.0
    # null centered near E[C] = 1
    assert abs(m[1:].mean() - 1.0) < 0.05


class TestStreamingLocal:
    """streaming_local_null: tile-split invariance + sink contracts."""

    @pytest.fixture(scope="class")
    def world(self):
        rng = np.random.default_rng(11)
        n, g = 500, 24
        coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
        X = rng.normal(size=(n, g)).astype(np.float32)
        X[:, 3] = 0.0                       # zero-variance gene
        graph = build_graph(jnp.asarray(coords), n_neighbors=5)
        plan = build_null_plan(graph, coords, block=64)
        return graph, plan, X

    def test_tile_split_invariance_all_stats(self, world):
        """Draw d is keyed by (seed, d) for every tile, so any tile split
        reproduces the unsplit p-values bitwise (CLAUDE.md hard rule)."""
        from spatialcore_tpu.ops.streaming import (
            host_local_sink, streaming_local_null)

        graph, plan, X = world
        n, g = X.shape
        Y = np.roll(X, 5, axis=1)           # pair columns for stat="lee"
        for stat, pkey in (("moran", "p"), ("geary", "p"),
                           ("getis", "p_sim"), ("lee", "p")):
            outs = []
            for tile in (g, 7):
                sink, store = host_local_sink(n, g)
                get = ((lambda s, w: (X[:, s:s + w], Y[:, s:s + w]))
                       if stat == "lee" else (lambda s, w: X[:, s:s + w]))
                streaming_local_null(
                    graph, plan, get, g, sink,
                    stat=stat, seed=3, n_permutations=19, tile=tile)
                outs.append(store)
            np.testing.assert_array_equal(outs[0][pkey], outs[1][pkey])

    def test_moran_matches_unstreamed_public_kernel(self, world):
        """Streamed LISA == banded_local_moran run unstreamed (observed
        exact, p from the int8 quantized operator), plus FDR/quadrants."""
        from spatialcore_tpu.ops.banded import banded_local_moran
        from spatialcore_tpu.ops.fdr import apply_fdr
        from spatialcore_tpu.ops.moran import classify_quadrants, standardize
        from spatialcore_tpu.ops.streaming import (
            host_local_sink, streaming_local_null)

        graph, plan, X = world
        n, g = X.shape
        sink, store = host_local_sink(n, g)
        streaming_local_null(graph, plan, lambda s, w: X[:, s:s + w], g,
                             sink, stat="moran", seed=5,
                             n_permutations=19, tile=7)
        Z, zv = standardize(jnp.asarray(X))
        res = banded_local_moran(plan, graph, Z, 5, 19, precision="int8")
        p_ref = np.asarray(jnp.where(zv[None, :], 1.0, res.p_value))
        np.testing.assert_array_equal(store["p"], p_ref)
        np.testing.assert_allclose(
            store["I"], np.where(np.asarray(zv)[None, :], 0.0,
                                 np.asarray(res.local_I)), rtol=1e-6)
        p_adj_ref = np.asarray(apply_fdr(jnp.asarray(p_ref), "fdr_bh",
                                         axis=0))
        np.testing.assert_allclose(store["p_adj"], p_adj_ref, rtol=1e-6)
        zv_np = np.asarray(zv)
        assert (store["p"][:, zv_np] == 1.0).all()
        assert (store["quadrant"][:, zv_np] == 0).all()

    def test_device_sink_compact_dtypes(self, world):
        from spatialcore_tpu.ops.streaming import (
            device_local_sink, streaming_local_null)

        graph, plan, X = world
        n, g = X.shape
        sink, finalize = device_local_sink(g, keys=("I", "p_adj",
                                                    "quadrant"))
        streaming_local_null(graph, plan, lambda s, w: X[:, s:s + w], g,
                             sink, stat="moran", seed=5,
                             n_permutations=19, tile=7)
        out = finalize()
        assert set(out) == {"I", "p_adj", "quadrant"}
        assert out["I"].dtype == jnp.bfloat16
        assert out["p_adj"].dtype == jnp.float16
        assert out["quadrant"].dtype == jnp.int8
        assert out["I"].shape == (n, g)

    def test_lee_matches_unstreamed_banded_kernel(self, world):
        """Streamed local Lee == banded_lees_l run unstreamed on the full
        pair set (observed exact lees_l_pairs, per-cell p from the int8
        quantized operator)."""
        from spatialcore_tpu.ops.banded import banded_lees_l
        from spatialcore_tpu.ops.fdr import apply_fdr
        from spatialcore_tpu.ops.lee import lees_l_pairs
        from spatialcore_tpu.ops.moran import standardize
        from spatialcore_tpu.ops.streaming import (
            host_local_sink, streaming_local_null)

        graph, plan, X = world
        n, g = X.shape
        Y = np.roll(X, 5, axis=1)
        sink, store = host_local_sink(n, g)
        streaming_local_null(
            graph, plan, lambda s, w: (X[:, s:s + w], Y[:, s:s + w]), g,
            sink, stat="lee", seed=5, n_permutations=19, tile=7)
        Zx, zvx = standardize(jnp.asarray(X))
        Zy, zvy = standardize(jnp.asarray(Y))
        zv = np.asarray(zvx | zvy)
        res = lees_l_pairs(graph, Zx, Zy, 5, 0)
        _, p_l = banded_lees_l(plan, Zx, Zy, 5, 19, precision="int8",
                               compute_cell_pvalues=True)
        p_ref = np.asarray(jnp.where(jnp.asarray(zv)[None, :], 1.0, p_l))
        np.testing.assert_array_equal(store["p"], p_ref)
        np.testing.assert_allclose(
            store["L"], np.where(zv[None, :], 0.0,
                                 np.asarray(res.L_local)), rtol=1e-5,
            atol=1e-6)
        p_adj_ref = np.asarray(apply_fdr(jnp.asarray(p_ref), "fdr_bh",
                                         axis=0))
        np.testing.assert_allclose(store["p_adj"], p_adj_ref, rtol=1e-6)
        assert (store["p"][:, zv] == 1.0).all()
        assert (store["quadrant"][:, zv] == 0).all()

    def test_lean_keys_mode_matches_default(self, world):
        """keys= (the lean fused post-pass) must reproduce the default
        path's compact outputs for every stat — same kernel p (bitwise),
        same observed/FDR/quadrant planes after the sink-side cast. Uses
        post_chunk < tile so the column-chunked lax.map is exercised."""
        from spatialcore_tpu.ops.streaming import (
            device_local_sink, streaming_local_null)

        graph, plan, X = world
        n, g = X.shape
        Y = np.roll(X, 5, axis=1)
        all_keys = {"moran": ("I", "z", "lag", "p", "p_adj", "quadrant"),
                    "geary": ("C", "p", "p_adj"),
                    "getis": ("G", "z_score", "p", "p_sim", "p_adj"),
                    "lee": ("L", "lag", "p", "p_adj", "quadrant")}
        for stat, keys in all_keys.items():
            get = ((lambda s, w: (X[:, s:s + w], Y[:, s:s + w]))
                   if stat == "lee" else (lambda s, w: X[:, s:s + w]))
            outs = []
            for lean in (False, True):
                sink, finalize = device_local_sink(g, keys=keys)
                streaming_local_null(
                    graph, plan, get, g, sink, stat=stat, seed=3,
                    n_permutations=19, tile=8,
                    keys=keys if lean else None, post_chunk=4)
                outs.append({k: np.asarray(v)
                             for k, v in finalize().items()})
            ref, lean_out = outs
            assert set(lean_out) == set(keys)
            for k in keys:
                np.testing.assert_array_equal(
                    lean_out[k], ref[k],
                    err_msg=f"stat={stat} key={k}")

    def test_lean_keys_mode_rejects_unknown_key(self, world):
        from spatialcore_tpu.ops.streaming import (
            host_local_sink, streaming_local_null)

        graph, plan, X = world
        sink, _ = host_local_sink(*X.shape)
        with pytest.raises(ValueError, match="unknown keys"):
            streaming_local_null(graph, plan, lambda s, w: X[:, s:s + w],
                                 X.shape[1], sink, stat="moran",
                                 keys=("I", "nope"))

    def test_invalid_stat(self, world):
        from spatialcore_tpu.ops.streaming import (
            host_local_sink, streaming_local_null)

        graph, plan, X = world
        sink, _ = host_local_sink(*X.shape)
        with pytest.raises(ValueError, match="stat must be"):
            streaming_local_null(graph, plan, lambda s, w: X[:, s:s + w],
                                 X.shape[1], sink, stat="ripley")


class TestWideTileRecipe:
    """obs_dtype="bf16" + return_counts: the wide-tile memory recipe."""

    @pytest.fixture(scope="class")
    def world(self):
        rng = np.random.default_rng(21)
        n, g = 400, 32
        coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
        X = rng.normal(size=(n, g)).astype(np.float32)
        X[:, 5] = 0.0
        graph = build_graph(jnp.asarray(coords), n_neighbors=5)
        plan = build_null_plan(graph, coords, block=64)
        return graph, plan, X

    def test_return_counts_matches_pvalues(self, world):
        """banded_local_moran_pvalues(return_counts=True) returns the
        integer counts behind the f32 p, in original cell order, and
        accepts pre-quantized int8 codes."""
        from spatialcore_tpu.ops.banded import (_quantize_z,
                                                banded_local_moran_pvalues)

        graph, plan, X = world
        Z, _ = standardize(jnp.asarray(X))
        P = 19
        p = np.asarray(banded_local_moran_pvalues(plan, Z, 7, P))
        cnt = np.asarray(banded_local_moran_pvalues(plan, Z, 7, P,
                                                    return_counts=True))
        assert cnt.dtype == np.int8           # P <= 127
        # compare in the exact integer domain (the f32 division on device
        # and the f64 one here differ in the last ulp)
        np.testing.assert_array_equal(cnt, np.round(p * (P + 1) - 1))
        # pre-quantized codes give the same counts (scale cancels)
        Zq, _ = _quantize_z(Z)
        cnt_q = np.asarray(banded_local_moran_pvalues(plan, Zq, 7, P,
                                                      return_counts=True))
        np.testing.assert_array_equal(cnt_q, cnt)

    def test_bf16_obs_stream_matches_f32_path(self, world):
        """obs_dtype="bf16": p/p_adj BITWISE equal to the f32-obs lean
        path (same integer counts); I within bf16 tolerance; quadrant
        equal away from bf16-resolution sign boundaries."""
        from spatialcore_tpu.ops.streaming import (
            device_local_sink, streaming_local_null)

        graph, plan, X = world
        n, g = X.shape
        keys = ("I", "p", "p_adj", "quadrant")
        outs = {}
        for od in ("f32", "bf16"):
            sink, fin = device_local_sink(g, keys=keys)
            streaming_local_null(
                graph, plan, lambda s, w: X[:, s:s + w], g, sink,
                stat="moran", seed=3, n_permutations=19, tile=16,
                keys=keys, post_chunk=8, obs_dtype=od)
            outs[od] = {k: np.asarray(v, np.float32 if k != "quadrant"
                                      else np.int8)
                        for k, v in fin().items()}
        np.testing.assert_array_equal(outs["bf16"]["p"], outs["f32"]["p"])
        np.testing.assert_array_equal(outs["bf16"]["p_adj"],
                                      outs["f32"]["p_adj"])
        np.testing.assert_allclose(outs["bf16"]["I"], outs["f32"]["I"],
                                   rtol=0.02, atol=0.02)
        # quadrants may differ only where z or lag sits at bf16 resolution
        frac = np.mean(outs["bf16"]["quadrant"] != outs["f32"]["quadrant"])
        assert frac < 0.01, frac

    def test_bf16_obs_validation(self, world):
        from spatialcore_tpu.ops.streaming import (
            host_local_sink, streaming_local_null)

        graph, plan, X = world
        sink, _ = host_local_sink(*X.shape)
        with pytest.raises(ValueError, match="obs_dtype"):
            streaming_local_null(graph, plan, lambda s, w: X[:, s:s + w],
                                 X.shape[1], sink, stat="moran",
                                 obs_dtype="f64")
        with pytest.raises(ValueError, match="wide-tile"):
            streaming_local_null(graph, plan, lambda s, w: X[:, s:s + w],
                                 X.shape[1], sink, stat="geary",
                                 keys=("C",), obs_dtype="bf16")
        with pytest.raises(ValueError, match="wide-tile"):
            streaming_local_null(graph, plan, lambda s, w: X[:, s:s + w],
                                 X.shape[1], sink, stat="moran",
                                 obs_dtype="bf16")   # no keys
