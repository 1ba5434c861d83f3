"""Banded permutation-null kernel: correctness vs dense oracle and legacy path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spatialcore_tpu.core.rng import feistel_permutation
from spatialcore_tpu.ops.banded import (
    banded_permutation_test, build_null_plan, hilbert_order)
from spatialcore_tpu.ops.graph import build_graph
from spatialcore_tpu.ops.moran import (
    geary_observed, moran_observed, permutation_test_global, standardize)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    n, g = 800, 12
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    # spatially structured + noise columns
    X = np.stack(
        [np.sin(coords[:, 0] / 9.0) + rng.normal(0, 0.3, n) for _ in range(g // 2)]
        + [rng.normal(0, 1, n) for _ in range(g - g // 2)], axis=1
    ).astype(np.float32)
    graph = build_graph(coords, n_neighbors=6)
    Z, _ = standardize(jnp.asarray(X))
    return coords, graph, Z


def test_plan_partitions_all_edges(setup):
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    n, k = graph.neighbor_idx.shape
    n_band = int((np.asarray(plan.w_local) > 0).sum())
    n_far = int((np.asarray(plan.far_w) > 0).sum())
    assert n_band + n_far == n * k
    # in-band weight + far weight sums to the total weight mass
    total = float(np.asarray(graph.neighbor_w).sum())
    got = float(np.asarray(plan.w_local).sum() + np.asarray(plan.far_w).sum())
    assert abs(total - got) < 1e-3


def test_device_plan_matches_host_plan(setup):
    """Plans built from a device array agree with the host (numpy) path.

    The orderings may differ at float32/float64 quantization boundaries,
    but edge partition mass, Geary terms, and the resulting p-values are
    equivalent (draw values are ordering-invariant by construction).
    """
    coords, graph, Z = setup
    hp = build_null_plan(graph, coords, block=64)
    dp = build_null_plan(graph, jnp.asarray(coords), block=64)
    n, k = graph.neighbor_idx.shape
    assert int((np.asarray(dp.w_local) > 0).sum()) \
        + int((np.asarray(dp.far_w) > 0).sum()) == n * k
    total = float(np.asarray(graph.neighbor_w).sum())
    got = float(np.asarray(dp.w_local).sum() + np.asarray(dp.far_w).sum())
    assert abs(total - got) < 1e-3
    # rc_sum is a per-cell quantity: compare in original-cell order
    rc_h = np.asarray(hp.rc_sum)[: n][np.asarray(hp.rank)]
    rc_d = np.asarray(dp.rc_sum)[: n][np.asarray(dp.rank)]
    np.testing.assert_allclose(rc_h, rc_d, rtol=1e-5, atol=1e-5)
    # identical p-values with the sort stream (value assignment is
    # ordering-invariant; only f32 accumulation order differs)
    S0 = total
    I_obs = moran_observed(graph, Z, S0)
    p_h, _, _ = banded_permutation_test(hp, Z, S0, I_obs, seed=5,
                                        n_permutations=64,
                                        precision="f32",
                                        perm_method="sort")
    p_d, _, _ = banded_permutation_test(dp, Z, S0, I_obs, seed=5,
                                        n_permutations=64,
                                        precision="f32",
                                        perm_method="sort")
    # identical draws up to f32 accumulation order: counts may flip only
    # when a draw lands within float noise of the observed value
    np.testing.assert_allclose(np.asarray(p_h), np.asarray(p_d),
                               atol=2.0 / 65.0)


def test_banded_matches_dense_oracle_fixed_perm(setup):
    """The banded cross term reproduces the dense quadratic form exactly."""
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    n = plan.n
    rng = np.random.default_rng(3)
    perm = rng.permutation(n).astype(np.int32)  # in new-order coordinates
    from spatialcore_tpu.ops.banded import _banded_stat, _build_band

    den = jnp.sum(Z * Z, axis=0)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    A = _build_band(plan.local_idx, plan.w_local, plan.block, jnp.float32)
    # compose to the padded row-index contract (what the draw loop passes)
    nb = plan.local_idx.shape[0] // plan.block
    gidx = np.clip(np.arange((nb + 2) * plan.block) - plan.block, 0, n - 1)
    got = _banded_stat(
        A, plan.far_src, plan.far_dst, plan.far_w, plan.rc_sum,
        Z, den, S0, jnp.asarray(perm[gidx]), block=plan.block, n=n,
        stat="moran")
    # oracle over the RELABELED graph, f64 dense
    order = np.asarray(plan.order)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    idx_r = rank[np.asarray(graph.neighbor_idx)[order]]
    w_r = np.asarray(graph.neighbor_w, np.float64)[order]
    zp64 = np.asarray(Z, np.float64)[perm]
    expect = np.zeros(zp64.shape[1])
    for j in range(idx_r.shape[1]):
        expect += (w_r[:, j:j + 1] * zp64 * zp64[idx_r[:, j]]).sum(axis=0)
    expect = n / S0 * expect / np.asarray(den, np.float64)
    np.testing.assert_allclose(np.asarray(got), expect, rtol=2e-5, atol=1e-7)


def test_banded_geary_matches_dense_oracle(setup):
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    n = plan.n
    perm = np.random.default_rng(5).permutation(n).astype(np.int32)
    from spatialcore_tpu.ops.banded import _banded_stat, _build_band

    den = jnp.sum(Z * Z, axis=0)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    A = _build_band(plan.local_idx, plan.w_local, plan.block, jnp.float32)
    nb = plan.local_idx.shape[0] // plan.block
    gidx = np.clip(np.arange((nb + 2) * plan.block) - plan.block, 0, n - 1)
    got = _banded_stat(
        A, plan.far_src, plan.far_dst, plan.far_w, plan.rc_sum,
        Z, den, S0, jnp.asarray(perm[gidx]), block=plan.block, n=n,
        stat="geary")
    order = np.asarray(plan.order)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    idx_r = rank[np.asarray(graph.neighbor_idx)[order]]
    w_r = np.asarray(graph.neighbor_w, np.float64)[order]
    zp64 = np.asarray(Z, np.float64)[perm]
    num = np.zeros(zp64.shape[1])
    for j in range(idx_r.shape[1]):
        d = zp64 - zp64[idx_r[:, j]]
        num += (w_r[:, j:j + 1] * d * d).sum(axis=0)
    expect = (n - 1) * num / (2 * S0 * np.asarray(den, np.float64))
    np.testing.assert_allclose(np.asarray(got), expect, rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("stat,alt", [("moran", "greater"), ("geary", "less")])
def test_banded_agrees_with_legacy(setup, stat, alt):
    """perm_method='sort': same permutations => near-identical moments & p."""
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = (moran_observed(graph, Z, S0) if stat == "moran"
           else geary_observed(graph, Z, S0))
    p_l, m_l, s_l = permutation_test_global(
        graph, Z, S0, obs, seed=11, n_permutations=199, stat=stat,
        alternative=alt)
    p_b, m_b, s_b = banded_permutation_test(
        plan, Z, S0, obs, seed=11, n_permutations=199, stat=stat,
        alternative=alt, precision="f32", perm_method="sort")
    np.testing.assert_allclose(np.asarray(m_b), np.asarray(m_l), atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_b), np.asarray(s_l), atol=1e-5)
    # identical permutations: identical extreme counts except float ties
    np.testing.assert_allclose(np.asarray(p_b), np.asarray(p_l), atol=0.02)
    # structured genes significant
    assert np.asarray(p_b)[0] <= 0.01


def test_banded_feistel_statistically_equivalent(setup):
    """The Feistel stream yields the same inference as the sort stream."""
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = moran_observed(graph, Z, S0)
    p_s, m_s, sd_s = banded_permutation_test(
        plan, Z, S0, obs, seed=3, n_permutations=199, precision="f32",
        perm_method="sort")
    p_f, m_f, sd_f = banded_permutation_test(
        plan, Z, S0, obs, seed=3, n_permutations=199, precision="f32",
        perm_method="feistel")
    # same null distribution: moments match within Monte-Carlo error
    np.testing.assert_allclose(np.asarray(m_f), np.asarray(m_s), atol=5e-3)
    np.testing.assert_allclose(np.asarray(sd_f), np.asarray(sd_s), rtol=0.25)
    # decisions agree for the structured genes (p at the floor)
    np.testing.assert_array_equal(np.asarray(p_f)[:6] <= 0.01,
                                  np.asarray(p_s)[:6] <= 0.01)
    # deterministic given the seed
    p_f2, _, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=3, n_permutations=199, precision="f32",
        perm_method="feistel")
    np.testing.assert_array_equal(np.asarray(p_f), np.asarray(p_f2))


def test_banded_bf16_statistically_equivalent(setup):
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = moran_observed(graph, Z, S0)
    p32, m32, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=5, n_permutations=99, precision="f32")
    pbf, mbf, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=5, n_permutations=99, precision="bf16")
    np.testing.assert_allclose(np.asarray(mbf), np.asarray(m32), atol=5e-3)
    np.testing.assert_allclose(np.asarray(pbf), np.asarray(p32), atol=0.05)


def test_graph_order_fallback(setup):
    coords, graph, Z = setup
    valid = float(np.asarray(graph.neighbor_w).sum())
    plan_rcm = build_null_plan(graph, None, block=64)  # RCM, no coords
    got = float(np.asarray(plan_rcm.w_local).sum()
                + np.asarray(plan_rcm.far_w).sum())
    assert abs(got - valid) < 1e-3


def test_hilbert_order_locality():
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 50, (2000, 2))
    order = hilbert_order(coords)
    assert sorted(order.tolist()) == list(range(2000))
    # successive cells along the curve are spatially close on average
    d_curve = np.linalg.norm(np.diff(coords[order], axis=0), axis=1).mean()
    d_rand = np.linalg.norm(np.diff(coords, axis=0), axis=1).mean()
    assert d_curve < d_rand / 5


def test_feistel_permutation_properties():
    # bijectivity at awkward sizes
    for n in (2, 3, 17, 1000, 4097):
        p = np.asarray(feistel_permutation(jax.random.key(1), n))
        assert sorted(p.tolist()) == list(range(n))
    # different keys give different permutations
    a = np.asarray(feistel_permutation(jax.random.key(1), 1000))
    b = np.asarray(feistel_permutation(jax.random.key(2), 1000))
    assert (a != b).mean() > 0.9
    # position-value uniformity (chi-square, df=(n-1)^2=49, 99.9th pct ~ 85)
    n, D = 8, 4000
    counts = np.zeros((n, n))
    f = jax.jit(lambda k: feistel_permutation(k, n))
    for d in range(D):
        p = np.asarray(f(jax.random.fold_in(jax.random.key(0), d)))
        counts[np.arange(n), p] += 1
    chi2 = ((counts - D / n) ** 2 / (D / n)).sum()
    assert chi2 < 100, f"feistel occupancy chi2={chi2:.1f}"


def test_banded_local_moran_matches_direct(setup):
    """Banded LISA == direct kernel: same draws (sort/f32), same p."""
    from spatialcore_tpu.ops.banded import banded_local_moran
    from spatialcore_tpu.ops.moran import local_moran

    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    ref = local_moran(graph, Z, seed=4, n_permutations=99)
    got = banded_local_moran(plan, graph, Z, seed=4, n_permutations=99,
                             precision="f32", perm_method="sort")
    np.testing.assert_array_equal(np.asarray(got.local_I),
                                  np.asarray(ref.local_I))
    np.testing.assert_array_equal(np.asarray(got.lag), np.asarray(ref.lag))
    # same permutations: extreme counts identical except float ties
    diff = np.abs(np.asarray(got.p_value) - np.asarray(ref.p_value))
    assert (diff <= 0.03 + 1e-6).mean() > 0.99
    # bf16 + feistel: same inference statistically
    got_bf = banded_local_moran(plan, graph, Z, seed=4, n_permutations=99)
    sig_a = np.asarray(got_bf.p_value)[:, 0] < 0.05
    sig_b = np.asarray(ref.p_value)[:, 0] < 0.05
    assert (sig_a == sig_b).mean() > 0.9


def test_banded_local_moran_int8(setup):
    """int8 banded LISA: exact observed outputs, quantization-tolerance p.

    Same draws as the direct kernel (sort stream); the statistic operator
    is the per-gene-quantized int8 system applied to BOTH draws and the
    observed comparison value, so decisions flip only where |I_perm| and
    |I_obs| sit within one quantization step of each other.
    """
    from spatialcore_tpu.ops.banded import banded_local_moran
    from spatialcore_tpu.ops.moran import local_moran

    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    ref = local_moran(graph, Z, seed=4, n_permutations=199)
    got = banded_local_moran(plan, graph, Z, seed=4, n_permutations=199,
                             precision="int8", perm_method="sort")
    # observed statistics stay exact f32 (direct kernel)
    np.testing.assert_array_equal(np.asarray(got.local_I),
                                  np.asarray(ref.local_I))
    np.testing.assert_array_equal(np.asarray(got.lag), np.asarray(ref.lag))
    p8 = np.asarray(got.p_value)
    p32 = np.asarray(ref.p_value)
    assert np.abs(p8 - p32).mean() < 0.02
    assert ((p8 < 0.05) == (p32 < 0.05)).mean() > 0.97
    # feistel stream (default) reaches the same inference
    got_f = banded_local_moran(plan, graph, Z, seed=4, n_permutations=199,
                               precision="int8")
    sig_a = np.asarray(got_f.p_value)[:, 0] < 0.05
    sig_b = p32[:, 0] < 0.05
    assert (sig_a == sig_b).mean() > 0.9


def test_banded_int8_statistically_equivalent(setup):
    """int8 null mode: 100% decision agreement with the f32 oracle path.

    The int8 system quantizes z per gene (s_g = min(max|z|, 8)/127) and
    band weights per row, so its draws differ from f32 by O(s_g) — the
    same precision class as bf16 (8 significant bits) at half the bytes.
    Draws compare against the observed value of the SAME quantized
    operator, so Monte-Carlo counting is internally consistent.
    """
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = moran_observed(graph, Z, S0)
    p32, m32, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=5, n_permutations=99, precision="f32")
    p8, m8, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=5, n_permutations=99, precision="int8")
    np.testing.assert_allclose(np.asarray(m8), np.asarray(m32), atol=5e-3)
    np.testing.assert_allclose(np.asarray(p8), np.asarray(p32), atol=0.05)
    assert ((np.asarray(p8) < 0.05) == (np.asarray(p32) < 0.05)).all()


def test_banded_int8_geary(setup):
    """int8 Geary draws agree with the f32 path at quantization tolerance."""
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = geary_observed(graph, Z, S0)
    p32, m32, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=9, n_permutations=99, precision="f32",
        stat="geary", alternative="less")
    p8, m8, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=9, n_permutations=99, precision="int8",
        stat="geary", alternative="less")
    np.testing.assert_allclose(np.asarray(m8), np.asarray(m32), atol=5e-3)
    np.testing.assert_allclose(np.asarray(p8), np.asarray(p32), atol=0.05)


def test_int8_prequantized_matches_inline(setup):
    """Streaming preps quantize once and pass (Zq, sz); must equal the
    inline _quantize_z(Z) route bit-for-bit."""
    from spatialcore_tpu.ops.banded import _quantize_z

    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = moran_observed(graph, Z, S0)
    den = jnp.sum(Z * Z, axis=0)
    p_a, m_a, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=11, n_permutations=49, precision="int8",
        den=den)
    Zq, sz = _quantize_z(Z)
    p_b, m_b, _ = banded_permutation_test(
        plan, Zq, S0, obs, seed=11, n_permutations=49, precision="int8",
        den=den, sz=sz)
    np.testing.assert_array_equal(np.asarray(p_a), np.asarray(p_b))
    # integer products are exact, but the two programs compile differently
    # so the f32 reduction order of the sz2-scaled mean may differ by ulps
    np.testing.assert_allclose(np.asarray(m_a), np.asarray(m_b),
                               rtol=1e-6, atol=1e-9)


def test_quantize_z_properties():
    """Quantizer: symmetric, exact recovery scale, outlier saturation."""
    from spatialcore_tpu.ops.banded import _quantize_z

    rng = np.random.default_rng(0)
    Z = jnp.asarray(rng.standard_normal((512, 8)).astype(np.float32))
    Zq, s = _quantize_z(Z)
    assert Zq.dtype == jnp.int8
    err = np.abs(np.asarray(Zq, np.float32) * np.asarray(s)[None, :]
                 - np.asarray(Z))
    # step size is s/2 per value; s = max|z|/127
    assert err.max() <= float(np.asarray(s).max()) / 2 + 1e-6
    # outliers beyond clip*sigma saturate instead of coarsening the gene
    Zo = Z.at[0, 0].set(1000.0)
    Zq2, s2 = _quantize_z(Zo)
    assert float(s2[0]) <= 8.0 / 127.0 + 1e-6
    assert int(Zq2[0, 0]) == 127


def test_int8_degenerate_genes_no_nans():
    """Constant and all-zero genes must produce I=0, p=1 — never NaN —
    through the public int8 null path (quantizer scale would be 0)."""
    import scipy.sparse as sp

    import spatialcore_tpu as sct

    rng = np.random.default_rng(0)
    n = 2000
    X = rng.poisson(2.0, (n, 6)).astype(np.float32)
    X[:, 2] = 5.0   # constant
    X[:, 4] = 0.0   # all-zero
    a = sct.SpatialData(X=sp.csr_matrix(X))
    a.var_names = [f"G{i}" for i in range(6)]
    a.obsm["spatial"] = rng.uniform(0, 2000, (n, 2)).astype(np.float32)
    sct.spatial.build_spatial_weights(a, n_neighbors=6)
    r = sct.spatial.morans_i(a, n_permutations=19,
                             null_method="banded_int8")
    df = r.uns["morans_i"].set_index("gene")
    assert np.isfinite(df[["I", "z_score", "p_value"]].to_numpy()).all()
    for g in ("G2", "G4"):
        assert df.loc[g, "I"] == 0.0
        assert df.loc[g, "p_value"] == 1.0


def test_int8_prequantized_den_none_mean_std_units(setup):
    """den=None with a pre-quantized int8 table must rescale Σcode² by
    s_g² so null mean/std come back in statistic units (not s_g²-inflated)."""
    from spatialcore_tpu.ops.banded import _quantize_z, banded_permutation_test

    coords, graph, Z = setup
    plan = build_null_plan(graph, block=64)
    S0 = float(Z.shape[0])
    obs = moran_observed(graph, Z, S0)
    Zq, s_z = _quantize_z(Z)
    den = jnp.sum(Z * Z, axis=0)
    p_ref, m_ref, s_ref = banded_permutation_test(
        plan, Zq, S0, obs, seed=3, n_permutations=40, precision="int8",
        sz=s_z, den=den)
    p, m, s = banded_permutation_test(
        plan, Zq, S0, obs, seed=3, n_permutations=40, precision="int8",
        sz=s_z, den=None)
    np.testing.assert_array_equal(np.asarray(p_ref), np.asarray(p))
    # same units: den from codes is rescaled by s², so the only delta is
    # int8 rounding of Σz² (≤ quantizer step); demand tight agreement
    np.testing.assert_allclose(np.asarray(m), np.asarray(m_ref),
                               rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                               rtol=5e-2, atol=5e-3)


def test_draw_offset_matches_unchunked(setup):
    """Two chunked calls with draw_offset reproduce one unchunked run's
    integer extreme counts bitwise."""
    from spatialcore_tpu.ops.banded import banded_permutation_test

    coords, graph, Z = setup
    plan = build_null_plan(graph, block=64)
    S0 = float(Z.shape[0])
    obs = moran_observed(graph, Z, S0)
    P = 40
    p_full, _, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=6, n_permutations=P)
    c_full = np.round(np.asarray(p_full) * (P + 1) - 1)
    c_sum = 0
    for off in (0, 15, 30):
        pc = min(15, P - off)
        p_c, _, _ = banded_permutation_test(
            plan, Z, S0, obs, seed=6, n_permutations=pc, draw_offset=off)
        c_sum = c_sum + np.round(np.asarray(p_c) * (pc + 1) - 1)
    np.testing.assert_array_equal(c_full, c_sum)


def test_banded_lees_l_matches_direct(setup):
    """Banded Lee's L nulls: same draw stream as ops.lee.lees_l_pairs
    (perm_lee key base, Y-only permutation); in f32 the only difference is
    float summation order in the lag, so p-values agree to tie-level."""
    from spatialcore_tpu.ops.banded import banded_lees_l
    from spatialcore_tpu.ops.lee import lees_l_pairs

    coords, graph, Z = setup
    Zx, Zy = Z[:, [0, 2, 6]], Z[:, [1, 3, 7]]
    P = 99
    direct = lees_l_pairs(graph, Zx, Zy, seed=5, n_permutations=P,
                          compute_cell_pvalues=True)
    plan = build_null_plan(graph, coords, block=64)
    p_g, p_l = banded_lees_l(plan, Zx, Zy, seed=5, n_permutations=P,
                             precision="f32", compute_cell_pvalues=True,
                             perm_method="sort")
    np.testing.assert_allclose(np.asarray(p_g), np.asarray(direct.p_global),
                               atol=2.0 / (P + 1))
    pl_d = np.asarray(direct.p_local)
    pl_b = np.asarray(p_l)
    assert np.abs(pl_b - pl_d).mean() < 0.01
    assert ((pl_b < 0.05) == (pl_d < 0.05)).mean() > 0.98

    # bf16 (the production default at scale) reaches the same inference
    p_g16, p_l16 = banded_lees_l(plan, Zx, Zy, seed=5, n_permutations=P,
                                 compute_cell_pvalues=True,
                                 perm_method="sort")
    assert ((np.asarray(p_l16) < 0.05) == (pl_d < 0.05)).mean() > 0.95
    np.testing.assert_allclose(np.asarray(p_g16),
                               np.asarray(direct.p_global), atol=0.05)

    # feistel (the production default): same inference from its own stream
    p_gf, p_lf = banded_lees_l(plan, Zx, Zy, seed=5, n_permutations=P,
                               compute_cell_pvalues=True)
    assert ((np.asarray(p_lf) < 0.05) == (pl_d < 0.05)).mean() > 0.9
    np.testing.assert_array_equal(
        np.asarray(p_gf < 0.05), np.asarray(direct.p_global) < 0.05)


def test_lees_l_public_banded_null(setup):
    """Public lees_l/lees_l_local with null_method='banded' agree with the
    direct path on global L, p, and local decisions."""
    import spatialcore_tpu as sct

    coords, graph, Z = setup
    rng = np.random.default_rng(3)
    n = coords.shape[0]
    X = np.asarray(Z[:, :4])
    a = sct.SpatialData(X=X)
    a.obsm["spatial"] = coords
    r_d = sct.spatial.lees_l(a, ("0", "1"), n_permutations=99, seed=2,
                             null_method="direct")
    r_b = sct.spatial.lees_l(a, ("0", "1"), n_permutations=99, seed=2,
                             null_method="banded")
    assert r_d["L"] == r_b["L"]                      # exact observed
    assert abs(r_d["p_value"] - r_b["p_value"]) <= 0.05

    b = sct.SpatialData(X=X)
    b.obsm["spatial"] = coords
    sct.spatial.lees_l_local(a, gene_pairs=("0", "1"), n_permutations=99,
                             seed=2, compute_cell_pvalues=True,
                             null_method="banded")
    sct.spatial.lees_l_local(b, gene_pairs=("0", "1"), n_permutations=99,
                             seed=2, compute_cell_pvalues=True,
                             null_method="direct")
    np.testing.assert_array_equal(a.obs["0_1_lees_l"], b.obs["0_1_lees_l"])
    agree = (np.asarray(a.obs["0_1_pvalue"] < 0.05)
             == np.asarray(b.obs["0_1_pvalue"] < 0.05)).mean()
    assert agree > 0.9     # banded default = feistel stream (own draws)


def test_banded_family_invalid_precision():
    from spatialcore_tpu.ops.banded import (
        banded_getis, banded_lees_l, banded_local_geary)

    with pytest.raises(ValueError, match="precision"):
        banded_lees_l(None, None, None, 0, 10, precision="fp4")
    with pytest.raises(ValueError, match="precision"):
        banded_local_geary(None, None, 0, 10, precision="fp4")
    with pytest.raises(ValueError, match="precision"):
        banded_getis(None, None, 0, 10, precision="fp4")


def test_banded_family_invalid_perm_method(setup):
    """A perm_method typo must fail loudly — every kernel branches
    `== "sort" else feistel`, so 'Sort'/'sorted' would silently switch
    the draw stream."""
    from spatialcore_tpu.ops.banded import (
        banded_getis, banded_lees_l, banded_local_geary,
        banded_local_moran, banded_permutation_test)

    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    with pytest.raises(ValueError, match="perm_method"):
        banded_lees_l(plan, Z[:, :1], Z[:, 1:2], 0, 10, perm_method="Sort")
    with pytest.raises(ValueError, match="perm_method"):
        banded_local_geary(plan, Z[:, :1], 0, 10, perm_method="sorted")
    with pytest.raises(ValueError, match="perm_method"):
        banded_getis(plan, Z[:, :1], 0, 10, perm_method="fiestel")
    with pytest.raises(ValueError, match="perm_method"):
        banded_local_moran(plan, graph, Z[:, :1], 0, 10, perm_method="")
    with pytest.raises(ValueError, match="perm_method"):
        banded_permutation_test(plan, Z, 1.0, jnp.zeros(Z.shape[1]), 0,
                                10, perm_method="feistal")


def test_banded_lees_l_int8(setup):
    """int8 Lee nulls: quantized-operator decisions track the direct f32
    kernel at tie level under the same (sort) draw stream."""
    from spatialcore_tpu.ops.banded import banded_lees_l
    from spatialcore_tpu.ops.lee import lees_l_pairs

    coords, graph, Z = setup
    Zx, Zy = Z[:, [0, 2, 6]], Z[:, [1, 3, 7]]
    P = 99
    direct = lees_l_pairs(graph, Zx, Zy, seed=5, n_permutations=P,
                          compute_cell_pvalues=True)
    plan = build_null_plan(graph, coords, block=64)
    p_g, p_l = banded_lees_l(plan, Zx, Zy, seed=5, n_permutations=P,
                             precision="int8", compute_cell_pvalues=True,
                             perm_method="sort")
    np.testing.assert_allclose(np.asarray(p_g), np.asarray(direct.p_global),
                               atol=0.05)
    pl_d = np.asarray(direct.p_local)
    pl_b = np.asarray(p_l)
    assert np.abs(pl_b - pl_d).mean() < 0.02
    assert ((pl_b < 0.05) == (pl_d < 0.05)).mean() > 0.97
    # feistel default deterministic
    pg_f1, _ = banded_lees_l(plan, Zx, Zy, seed=5, n_permutations=P,
                             precision="int8")
    pg_f2, _ = banded_lees_l(plan, Zx, Zy, seed=5, n_permutations=P,
                             precision="int8")
    np.testing.assert_array_equal(np.asarray(pg_f1), np.asarray(pg_f2))


def test_banded_local_geary_int8(setup):
    """Fully-integer local Geary nulls: exact int32 comparisons of the
    two-plane quantized expansion, decision agreement with the f32 direct
    kernel under the same draws."""
    from spatialcore_tpu.ops.banded import banded_local_geary
    from spatialcore_tpu.ops.moran import local_geary

    coords, graph, Z = setup
    P = 99
    direct = local_geary(graph, Z, seed=11, n_permutations=P, null="total")
    plan = build_null_plan(graph, coords, block=64)
    _, p8 = banded_local_geary(plan, Z, seed=11, n_permutations=P,
                               precision="int8", perm_method="sort")
    p_d = np.asarray(direct.p_value)
    p8 = np.asarray(p8)
    assert np.abs(p8 - p_d).mean() < 0.02
    assert ((p8 < 0.05) == (p_d < 0.05)).mean() > 0.97


def test_banded_local_geary_int8_k_bound():
    """k > 256 overflows the int32 comparison bound — loud error."""
    import jax.numpy as jnp

    from spatialcore_tpu.ops.banded import _banded_local_geary_p_i8

    npad, k = 64, 300
    with pytest.raises(ValueError, match="k <= 256"):
        _banded_local_geary_p_i8(
            jnp.zeros(64, jnp.int32), jnp.zeros(64, jnp.int32),
            jnp.zeros((npad, k), jnp.int32), jnp.zeros((npad, k)),
            jnp.zeros(4, jnp.int32) + 64, jnp.zeros(4, jnp.int32),
            jnp.zeros(4), jnp.zeros((64, 2)), jnp.uint32(0), block=64,
            n=64, n_permutations=3, perm_method="feistel")


def test_banded_getis_int8(setup):
    """int8 Getis-Ord p_sim: exact binary adjacency, per-gene quantized X,
    decision agreement with the direct kernel under the same draws."""
    from spatialcore_tpu.ops.banded import banded_getis
    from spatialcore_tpu.ops.getis import getis_ord

    coords, graph, Z = setup
    X = jnp.abs(Z[:, :5]) + 0.1
    P = 99
    for star, alt in ((True, "two-sided"), (False, "greater")):
        direct = getis_ord(graph, X, star=star, alternative=alt, seed=6,
                           n_permutations=P)
        plan = build_null_plan(graph, coords, block=64)
        p8 = np.asarray(banded_getis(plan, X, 6, P, star=star,
                                     alternative=alt, precision="int8",
                                     perm_method="sort"))
        p_d = np.asarray(direct.p_sim)
        assert np.abs(p8 - p_d).mean() < 0.02, (star, alt)
        assert ((p8 < 0.05) == (p_d < 0.05)).mean() > 0.97, (star, alt)


def test_banded_local_geary_matches_direct(setup):
    """Banded local-Geary total nulls: same perm_local_geary draw stream;
    the expansion form differs from the direct kernel only by float
    rearrangement in f32, so p-values agree to tie-level."""
    from spatialcore_tpu.ops.banded import banded_local_geary
    from spatialcore_tpu.ops.moran import local_geary

    coords, graph, Z = setup
    P = 99
    direct = local_geary(graph, Z, seed=11, n_permutations=P, null="total")
    plan = build_null_plan(graph, coords, block=64)
    _, p_b = banded_local_geary(plan, Z, seed=11, n_permutations=P,
                                perm_method="sort")
    p_d = np.asarray(direct.p_value)
    p_b = np.asarray(p_b)
    assert np.abs(p_b - p_d).mean() < 0.01
    assert ((p_b < 0.05) == (p_d < 0.05)).mean() > 0.98

    # feistel (the production default): same inference from its own stream
    _, p_f = banded_local_geary(plan, Z, seed=11, n_permutations=P)
    assert ((np.asarray(p_f) < 0.05) == (p_d < 0.05)).mean() > 0.9


def test_local_gearys_c_public_banded(setup):
    """Public local_gearys_c null_method='banded' (total null): exact
    observed C, decision-level p agreement with the direct path."""
    import spatialcore_tpu as sct

    coords, graph, Z = setup
    X = np.asarray(Z[:, :4])
    a = sct.SpatialData(X=X); a.obsm["spatial"] = coords
    b = sct.SpatialData(X=X); b.obsm["spatial"] = coords
    sct.spatial.local_gearys_c(a, n_permutations=99, seed=4, null="total",
                               null_method="banded")
    sct.spatial.local_gearys_c(b, n_permutations=99, seed=4, null="total",
                               null_method="direct")
    np.testing.assert_array_equal(np.asarray(a.obsm["local_geary_C"]),
                                  np.asarray(b.obsm["local_geary_C"]))
    agree = ((np.asarray(a.obsm["local_geary_p"]) < 0.05)
             == (np.asarray(b.obsm["local_geary_p"]) < 0.05)).mean()
    assert agree > 0.9     # banded default = feistel stream (own draws)


def test_banded_getis_matches_direct(setup):
    """Banded Getis-Ord p_sim: same perm_getis draw stream; the centered
    comparison is algebraically the direct z comparison (scales cancel
    for Gi*, divided out for Gi), so decisions agree to tie level."""
    from spatialcore_tpu.ops.banded import banded_getis
    from spatialcore_tpu.ops.getis import getis_ord

    coords, graph, Z = setup
    X = jnp.abs(Z[:, :5]) + 0.1          # raw positive values
    P = 99
    for star, alt in ((True, "two-sided"), (False, "greater")):
        direct = getis_ord(graph, X, star=star, alternative=alt, seed=6,
                           n_permutations=P)
        plan = build_null_plan(graph, coords, block=64)
        p_b = np.asarray(banded_getis(plan, X, 6, P, star=star,
                                      alternative=alt, perm_method="sort"))
        p_d = np.asarray(direct.p_sim)
        assert np.abs(p_b - p_d).mean() < 0.01, (star, alt)
        assert ((p_b < 0.05) == (p_d < 0.05)).mean() > 0.98, (star, alt)
        # feistel (the production default): same inference
        p_f = np.asarray(banded_getis(plan, X, 6, P, star=star,
                                      alternative=alt))
        assert ((p_f < 0.05) == (p_d < 0.05)).mean() > 0.9, (star, alt)


def test_getis_public_banded(setup):
    import spatialcore_tpu as sct

    coords, graph, Z = setup
    X = np.abs(np.asarray(Z[:, :3])) + 0.1
    a = sct.SpatialData(X=X); a.obsm["spatial"] = coords
    b = sct.SpatialData(X=X); b.obsm["spatial"] = coords
    sct.spatial.getis_ord_gi(a, n_permutations=99, seed=1,
                             null_method="banded")
    sct.spatial.getis_ord_gi(b, n_permutations=99, seed=1,
                             null_method="direct")
    np.testing.assert_array_equal(np.asarray(a.obsm["getis_ord_z"]),
                                  np.asarray(b.obsm["getis_ord_z"]))
    agree = ((np.asarray(a.obsm["getis_ord_p_sim"]) < 0.05)
             == (np.asarray(b.obsm["getis_ord_p_sim"]) < 0.05)).mean()
    assert agree > 0.9     # banded default = feistel stream (own draws)


def test_banded_family_public_int8(setup):
    """Public null_method='banded_int8' on lees_l/lees_l_local/
    local_gearys_c/getis_ord_gi: exact observed statistics (always the
    direct kernel), decision-level p agreement with the direct null, and
    the chosen path recorded in uns params."""
    import spatialcore_tpu as sct

    coords, graph, Z = setup
    X = np.asarray(Z[:, :4])
    Xp = np.abs(X) + 0.1

    a = sct.SpatialData(X=X); a.obsm["spatial"] = coords
    b = sct.SpatialData(X=X); b.obsm["spatial"] = coords
    r8 = sct.spatial.lees_l(a, ("0", "1"), n_permutations=99, seed=2,
                            null_method="banded_int8")
    rd = sct.spatial.lees_l(b, ("0", "1"), n_permutations=99, seed=2,
                            null_method="direct")
    assert r8["L"] == rd["L"]                        # exact observed
    assert abs(r8["p_value"] - rd["p_value"]) <= 0.05

    sct.spatial.lees_l_local(a, gene_pairs=("0", "1"), n_permutations=99,
                             seed=2, compute_cell_pvalues=True,
                             null_method="banded_int8")
    sct.spatial.lees_l_local(b, gene_pairs=("0", "1"), n_permutations=99,
                             seed=2, compute_cell_pvalues=True,
                             null_method="direct")
    np.testing.assert_array_equal(a.obs["0_1_lees_l"], b.obs["0_1_lees_l"])
    agree = (np.asarray(a.obs["0_1_pvalue"] < 0.05)
             == np.asarray(b.obs["0_1_pvalue"] < 0.05)).mean()
    assert agree > 0.9

    sct.spatial.local_gearys_c(a, n_permutations=99, seed=4, null="total",
                               null_method="banded_int8")
    sct.spatial.local_gearys_c(b, n_permutations=99, seed=4, null="total",
                               null_method="direct")
    assert a.uns["local_geary_params"]["null_method"] == "banded_int8"
    assert b.uns["local_geary_params"]["null_method"] == "direct"
    np.testing.assert_array_equal(np.asarray(a.obsm["local_geary_C"]),
                                  np.asarray(b.obsm["local_geary_C"]))
    agree = ((np.asarray(a.obsm["local_geary_p"]) < 0.05)
             == (np.asarray(b.obsm["local_geary_p"]) < 0.05)).mean()
    assert agree > 0.9

    a.X, b.X = Xp, Xp
    sct.spatial.getis_ord_gi(a, n_permutations=99, seed=1,
                             null_method="banded_int8")
    sct.spatial.getis_ord_gi(b, n_permutations=99, seed=1,
                             null_method="direct")
    assert a.uns["getis_ord_params"]["null_method"] == "banded_int8"
    np.testing.assert_array_equal(np.asarray(a.obsm["getis_ord_z"]),
                                  np.asarray(b.obsm["getis_ord_z"]))
    agree = ((np.asarray(a.obsm["getis_ord_p_sim"]) < 0.05)
             == (np.asarray(b.obsm["getis_ord_p_sim"]) < 0.05)).mean()
    assert agree > 0.9

    # typo still fails loudly
    with pytest.raises(ValueError, match="null_method"):
        sct.spatial.getis_ord_gi(b, n_permutations=0, null_method="int8")


def test_banded_family_degenerate_inputs(setup):
    """Constant columns and isolated rows keep sane p-values through the
    banded family: a constant gene's centered Getis statistic is 0 for
    every draw (p=1 by the >= tie convention), and rows with zero weights
    produce L=0/c=0 with p=1 rather than NaN."""
    from spatialcore_tpu.ops.banded import (
        banded_getis, banded_lees_l, banded_local_geary)
    from spatialcore_tpu.ops.graph import SpatialGraph

    coords, graph, Z = setup
    n = Z.shape[0]

    # constant positive column through Getis
    Xc = jnp.concatenate([jnp.full((n, 1), 2.0), jnp.abs(Z[:, :1]) + 0.1],
                         axis=1)
    plan = build_null_plan(graph, coords, block=64)
    p = np.asarray(banded_getis(plan, Xc, 0, 19))
    assert np.all(np.isfinite(p))
    np.testing.assert_allclose(p[:, 0], 1.0)     # ties every draw

    # graph with some isolated rows (weights zeroed)
    mask = (np.arange(n) % 7 == 0)
    w = np.array(graph.neighbor_w)   # writable copy
    w[mask] = 0.0
    g2 = SpatialGraph(neighbor_idx=graph.neighbor_idx,
                      neighbor_w=jnp.asarray(w),
                      valid=jnp.asarray(
                          np.asarray(graph.valid) & ~mask[:, None]),
                      distances=graph.distances)
    plan2 = build_null_plan(g2, coords, block=64)
    _, pg = banded_local_geary(plan2, Z[:, :3], 0, 19)
    pl_g, pl_l = banded_lees_l(plan2, Z[:, :2], Z[:, 2:4], 0, 19,
                               compute_cell_pvalues=True)
    for arr in (pg, pl_l):
        a = np.asarray(arr)
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a[mask], 1.0)  # isolated: 0 vs 0 ties


def test_fused_moran_geary_bitwise_matches_separate(setup):
    """stat='moran_geary': one gather serves both statistics, bitwise-equal
    to the separate per-stat calls (same seed => same draw stream)."""
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs_m = moran_observed(graph, Z, S0)
    obs_g = geary_observed(graph, Z, S0)
    for precision in ("f32", "bf16"):
        p_m, m_m, s_m = banded_permutation_test(
            plan, Z, S0, obs_m, seed=13, n_permutations=99, stat="moran",
            alternative="greater", precision=precision)
        p_g, m_g, s_g = banded_permutation_test(
            plan, Z, S0, obs_g, seed=13, n_permutations=99, stat="geary",
            alternative="less", precision=precision)
        p_f, m_f, s_f = banded_permutation_test(
            plan, Z, S0, jnp.stack([obs_m, obs_g]), seed=13,
            n_permutations=99, stat="moran_geary",
            alternative=("greater", "less"), precision=precision)
        assert p_f.shape == (2, Z.shape[1])
        np.testing.assert_array_equal(np.asarray(p_f[0]), np.asarray(p_m))
        np.testing.assert_array_equal(np.asarray(p_f[1]), np.asarray(p_g))
        np.testing.assert_array_equal(np.asarray(m_f[0]), np.asarray(m_m))
        np.testing.assert_array_equal(np.asarray(m_f[1]), np.asarray(m_g))
        np.testing.assert_array_equal(np.asarray(s_f[0]), np.asarray(s_m))
        np.testing.assert_array_equal(np.asarray(s_f[1]), np.asarray(s_g))


def test_fused_moran_geary_int8(setup):
    """int8 fused mode matches the separate int8 calls bitwise."""
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs_m = moran_observed(graph, Z, S0)
    obs_g = geary_observed(graph, Z, S0)
    p_m, _, _ = banded_permutation_test(
        plan, Z, S0, obs_m, seed=21, n_permutations=99, stat="moran",
        alternative="greater", precision="int8")
    p_g, _, _ = banded_permutation_test(
        plan, Z, S0, obs_g, seed=21, n_permutations=99, stat="geary",
        alternative="less", precision="int8")
    p_f, _, _ = banded_permutation_test(
        plan, Z, S0, jnp.stack([obs_m, obs_g]), seed=21,
        n_permutations=99, stat="moran_geary",
        alternative=("greater", "less"), precision="int8")
    np.testing.assert_array_equal(np.asarray(p_f[0]), np.asarray(p_m))
    np.testing.assert_array_equal(np.asarray(p_f[1]), np.asarray(p_g))


def test_fused_moran_geary_validates_observed_shape(setup):
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs_m = moran_observed(graph, Z, S0)
    with pytest.raises(ValueError, match="moran_geary"):
        banded_permutation_test(
            plan, Z, S0, obs_m, seed=1, n_permutations=9,
            stat="moran_geary")


def test_chunked_observed_pass_bitwise(setup, monkeypatch):
    """Gene-chunking the one-time observed pass is bitwise-invisible.

    The i8 local kernels evaluate the observed statistic through
    _chunked_cols (the full-width pass faults at 1M cells where the draw
    scan fits — docs/performance.md). Per-cell comparisons are exact
    integers, so those p-values must match bitwise at any chunk width.
    Lee's GLOBAL Lg is f32-of-integer (terms past 2^24 round), reduced
    per column independently — equality here pins that XLA's per-column
    reduction is width-independent ON THIS BACKEND; at an exact f32 tie
    between a draw's Lg and obs_g the global count could still differ
    across backends/tilings (documented at the obs_g site, ADVICE r3).
    """
    import spatialcore_tpu.ops.banded as bd

    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    pargs = (plan.order, plan.rank, plan.local_idx, plan.w_local,
             plan.far_src, plan.far_dst, plan.far_w)
    ckw = dict(block=plan.block, n=plan.n, n_permutations=29,
               perm_method="feistel")
    X = jnp.abs(Z) + 0.1

    def family():
        jax.clear_caches()   # same shapes re-trace under the new width
        return (
            np.asarray(bd._banded_local_moran_p_i8(
                *pargs, Z, jnp.uint32(3), **ckw)),
            np.asarray(bd._banded_local_geary_p_i8(
                *pargs, Z, jnp.uint32(3), **ckw)[1]),
            np.asarray(bd._banded_getis_p_i8(
                *pargs, X, jnp.uint32(3), star=False,
                alternative="two-sided", **ckw)),
            *(np.asarray(a) for a in bd._banded_lees_p_i8(
                *pargs, Z, Z, jnp.uint32(3),
                compute_cell_pvalues=True, **ckw)),
        )

    assert Z.shape[1] > 4          # the patched width actually chunks
    full = family()                # G=12 <= default width: unchunked
    monkeypatch.setattr(bd, "_OBS_CHUNK", 4)
    chunked = family()
    for a, b in zip(full, chunked):
        np.testing.assert_array_equal(a, b)


def test_global_win_far_matches_exact_decisions(setup):
    """GLOBAL windowed-far int8 nulls (far_mode="win"): the quantized far
    weights coincide with the exact ones for row-normalized kNN (equal
    weights quantize to exactly 127), so p/mean/std match the exact-far
    operator at f32-summation tolerance, and decisions match the f32
    oracle exactly."""
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    assert int((np.asarray(plan.far_w) > 0).sum()) > 0
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = moran_observed(graph, Z, S0)
    p32, _, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=5, n_permutations=99, precision="f32")
    pw, mw, sw = banded_permutation_test(
        plan, Z, S0, obs, seed=5, n_permutations=99, precision="int8",
        far_mode="win")
    pe, me, se = banded_permutation_test(
        plan, Z, S0, obs, seed=5, n_permutations=99, precision="int8",
        far_mode="exact")
    np.testing.assert_allclose(np.asarray(pw), np.asarray(pe), atol=0.03)
    np.testing.assert_allclose(np.asarray(mw), np.asarray(me),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sw), np.asarray(se),
                               rtol=1e-3, atol=1e-5)
    assert ((np.asarray(pw) < 0.05) == (np.asarray(p32) < 0.05)).all()


def test_global_win_far_fused_moran_geary(setup):
    """far_mode="win" serves the fused moran_geary stat: both statistics
    from one gather + one fused kernel, matching the separate win runs."""
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    om = moran_observed(graph, Z, S0)
    og = geary_observed(graph, Z, S0)
    pf, mf, sf = banded_permutation_test(
        plan, Z, S0, jnp.stack([om, og]), seed=4, n_permutations=29,
        precision="int8", stat="moran_geary",
        alternative=("greater", "less"), far_mode="win")
    pm, mm, _ = banded_permutation_test(
        plan, Z, S0, om, seed=4, n_permutations=29, precision="int8",
        stat="moran", alternative="greater", far_mode="win")
    pg, mg, _ = banded_permutation_test(
        plan, Z, S0, og, seed=4, n_permutations=29, precision="int8",
        stat="geary", alternative="less", far_mode="win")
    np.testing.assert_array_equal(np.asarray(pf[0]), np.asarray(pm))
    np.testing.assert_array_equal(np.asarray(pf[1]), np.asarray(pg))
    np.testing.assert_allclose(np.asarray(mf[0]), np.asarray(mm), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mf[1]), np.asarray(mg), rtol=1e-6)


def test_global_win_far_draw_offset_chunks(setup):
    """Chunked draws reproduce the unchunked extreme counts bitwise under
    far_mode="win" (the compact far gather keys off the same global draw
    index as the main gather)."""
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = moran_observed(graph, Z, S0)
    P = 40
    p_full, _, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=6, n_permutations=P, precision="int8",
        far_mode="win")
    c_full = np.round(np.asarray(p_full) * (P + 1) - 1)
    c_sum = 0
    for off in (0, 15, 30):
        pc = min(15, P - off)
        p_c, _, _ = banded_permutation_test(
            plan, Z, S0, obs, seed=6, n_permutations=pc, precision="int8",
            far_mode="win", draw_offset=off)
        c_sum = c_sum + np.round(np.asarray(p_c) * (pc + 1) - 1)
    np.testing.assert_array_equal(c_full, c_sum)


def test_global_win_far_validation():
    """far_mode="win" input gates: f32 precision and unknown modes fail
    loudly; int8's default far mode is the windowed operator."""
    rng = np.random.default_rng(3)
    coords = rng.uniform(0, 50, (300, 2)).astype(np.float32)
    graph = build_graph(jnp.asarray(coords), n_neighbors=4)
    plan = build_null_plan(graph, coords, block=64)
    Z, _ = standardize(jnp.asarray(rng.normal(size=(300, 8)).astype(np.float32)))
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = moran_observed(graph, Z, S0)
    with pytest.raises(ValueError, match="precision='int8'"):
        banded_permutation_test(plan, Z, S0, obs, seed=0, n_permutations=9,
                                precision="f32", far_mode="win")
    with pytest.raises(ValueError, match="far_mode must be"):
        banded_permutation_test(plan, Z, S0, obs, seed=0, n_permutations=9,
                                precision="int8", far_mode="windowed")
    # int8's default far mode is the windowed operator
    p_r, _, _ = banded_permutation_test(plan, Z, S0, obs, seed=0,
                                        n_permutations=9, precision="int8")
    p_f, _, _ = banded_permutation_test(plan, Z, S0, obs, seed=0,
                                        n_permutations=9, precision="int8",
                                        far_mode="win")
    np.testing.assert_array_equal(np.asarray(p_r), np.asarray(p_f))


def test_quantize_z4_roundtrip():
    """Nibble pack/unpack is lossless on the int4 codes and keeps the
    natural gene order (split-half layout)."""
    from spatialcore_tpu.ops.banded import _quantize_z4, _unpack_nibbles

    rng = np.random.default_rng(0)
    Z = jnp.asarray(rng.normal(size=(60, 10)).astype(np.float32) * 3)
    pk, s = _quantize_z4(Z)
    assert pk.shape == (60, 5) and pk.dtype == jnp.int8
    codes = np.asarray(_unpack_nibbles(pk))
    ref = np.clip(np.round(np.asarray(Z) / np.asarray(s)), -7, 7)
    np.testing.assert_array_equal(codes, ref.astype(np.int8))
    # zero column -> scale 1, code 0
    Z0 = Z.at[:, 3].set(0.0)
    pk0, s0 = _quantize_z4(Z0)
    assert float(s0[3]) == 1.0
    assert (np.asarray(_unpack_nibbles(pk0))[:, 3] == 0).all()
    with pytest.raises(ValueError, match="even gene count"):
        _quantize_z4(Z[:, :3])


def test_int4_decisions_match_f32(setup):
    """precision='int4' (nibble-packed quantized operator): decisions at
    alpha=0.05 match the f32 oracle on the fixture; p within the coarser
    int4 quantization tolerance."""
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    for stat, alt, obs in (
            ("moran", "greater", moran_observed(graph, Z, S0)),
            ("geary", "less", geary_observed(graph, Z, S0))):
        p32, m32, _ = banded_permutation_test(
            plan, Z, S0, obs, seed=5, n_permutations=99, precision="f32",
            stat=stat, alternative=alt)
        p4, m4, _ = banded_permutation_test(
            plan, Z, S0, obs, seed=5, n_permutations=99, precision="int4",
            stat=stat, alternative=alt)
        # the int4 operator's null mean carries an O(s²) quantization
        # bias (z² terms, visible on Geary ~4%); DECISIONS are the pin —
        # draws compare against the observed value of the same operator
        np.testing.assert_allclose(np.asarray(m4), np.asarray(m32),
                                   rtol=0.06, atol=0.02)
        assert ((np.asarray(p4) < 0.05) == (np.asarray(p32) < 0.05)).all()


def test_int4_draw_offset_chunks(setup):
    """Chunked int4 draws reproduce the unchunked counts bitwise."""
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = moran_observed(graph, Z, S0)
    P = 40
    p_full, _, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=6, n_permutations=P, precision="int4")
    c_full = np.round(np.asarray(p_full) * (P + 1) - 1)
    c_sum = 0
    for off in (0, 15, 30):
        pc = min(15, P - off)
        p_c, _, _ = banded_permutation_test(
            plan, Z, S0, obs, seed=6, n_permutations=pc, precision="int4",
            draw_offset=off)
        c_sum = c_sum + np.round(np.asarray(p_c) * (pc + 1) - 1)
    np.testing.assert_array_equal(c_full, c_sum)


def test_int4_prepacked_matches_inline(setup):
    """Streaming preps pass (Zpk, sz) pre-packed; must equal the inline
    _quantize_z4 route bit-for-bit. An odd unpacked width is padded by
    one inert column for the split-half pairing."""
    from spatialcore_tpu.ops.banded import _quantize_z4

    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    G = Z.shape[1]
    Zp = jnp.pad(Z, ((0, 0), (0, 256 - G)))
    obs = jnp.pad(moran_observed(graph, Z, S0), (0, 256 - G))
    Zpk, s4 = _quantize_z4(Zp)
    p_in, m_in, _ = banded_permutation_test(
        plan, Zp, S0, obs, seed=3, n_permutations=29, precision="int4")
    p_pk, m_pk, _ = banded_permutation_test(
        plan, Zpk, S0, obs, seed=3, n_permutations=29, precision="int4",
        sz=s4)
    np.testing.assert_array_equal(np.asarray(p_in), np.asarray(p_pk))
    # mean differs only through the den convention: the inline route
    # normalizes by Σz² (f32), pre-packed by Σ(c·s)² (quantized codes) —
    # a per-gene positive factor that cancels in every p comparison
    np.testing.assert_allclose(np.asarray(m_in), np.asarray(m_pk),
                               rtol=0.06, atol=1e-7)
    p_odd, _, _ = banded_permutation_test(
        plan, Z[:, :11], S0, obs[:11], seed=3, n_permutations=29,
        precision="int4")
    p_even, _, _ = banded_permutation_test(
        plan, jnp.pad(Z[:, :11], ((0, 0), (0, 1))), S0,
        jnp.pad(obs[:11], (0, 1)), seed=3, n_permutations=29,
        precision="int4")
    assert p_odd.shape == (11,)
    np.testing.assert_array_equal(np.asarray(p_odd), np.asarray(p_even)[:11])


def test_int4_validation(setup):
    coords, graph, Z = setup
    plan = build_null_plan(graph, coords, block=64)
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = moran_observed(graph, Z, S0)
    with pytest.raises(ValueError, match="no exact-far"):
        banded_permutation_test(plan, Z, S0, obs, seed=0, n_permutations=9,
                                precision="int4", far_mode="exact")
    # int4 always runs the windowed far operator
    p_r, _, _ = banded_permutation_test(plan, Z, S0, obs, seed=0,
                                        n_permutations=9, precision="int4")
    p_f, _, _ = banded_permutation_test(plan, Z, S0, obs, seed=0,
                                        n_permutations=9, precision="int4",
                                        far_mode="win")
    np.testing.assert_array_equal(np.asarray(p_r), np.asarray(p_f))
