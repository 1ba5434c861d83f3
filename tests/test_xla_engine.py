"""The plain-XLA null engine: s8 band dots, dense oracles, integer
reference evaluations of the local operators, and removed options."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spatialcore_tpu.ops.banded as bd
from spatialcore_tpu.core.rng import feistel_apply, key_for
from spatialcore_tpu.ops.graph import build_graph
from spatialcore_tpu.ops.moran import moran_observed, standardize


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(11)
    n, g = 600, 6
    coords = rng.uniform(0, 80, (n, 2)).astype(np.float32)
    X = rng.normal(size=(n, g)).astype(np.float32)
    X[:, :2] += np.sin(coords[:, :1] / 7.0)
    graph = build_graph(coords, n_neighbors=6)
    Z, _ = standardize(jnp.asarray(X))
    plan = bd.build_null_plan(graph, coords, block=64)
    return coords, graph, Z, plan


# ---------------------------------------------------------------------------
# s8 x s8 -> s32 band dots equal the former int32-cast form, at every site
# ---------------------------------------------------------------------------


def _cast_slab(A8, Zp8, s):
    """The form the band products had before: both operands cast to
    int32, then an int32 dot."""
    nb, B, _ = A8.shape
    return jnp.einsum("nbw,nwg->nbg",
                      A8[:, :, s * B:(s + 1) * B].astype(jnp.int32),
                      Zp8[s:s + nb].astype(jnp.int32))


_SITES = {
    "global_int8_exact": lambda plan, graph, Z: bd.banded_permutation_test(
        plan, Z, 600.0, moran_observed(graph, Z, 600.0), seed=1,
        n_permutations=9, precision="int8", far_mode="exact"),
    "global_int8_win": lambda plan, graph, Z: bd.banded_permutation_test(
        plan, Z, 600.0, moran_observed(graph, Z, 600.0), seed=1,
        n_permutations=9, precision="int8", far_mode="win", stat="geary",
        alternative="less"),
    "global_int4": lambda plan, graph, Z: bd.banded_permutation_test(
        plan, Z, 600.0, moran_observed(graph, Z, 600.0), seed=1,
        n_permutations=9, precision="int4"),
    "local_moran": lambda plan, graph, Z: (
        bd.banded_local_moran_pvalues(plan, Z, 1, 9),),
    "local_geary": lambda plan, graph, Z: bd.banded_local_geary(
        plan, Z, 1, 9, precision="int8"),
    "local_getis": lambda plan, graph, Z: (bd.banded_getis(
        plan, jnp.abs(Z) + 0.1, 1, 9, star=False, precision="int8"),),
    "lees_l": lambda plan, graph, Z: bd.banded_lees_l(
        plan, Z, Z[:, ::-1], 1, 9, precision="int8",
        compute_cell_pvalues=True),
}


@pytest.mark.parametrize("site", sorted(_SITES))
def test_s8_band_dot_bitwise_equals_int32_cast(small, site, monkeypatch):
    _, graph, Z, plan = small
    run = _SITES[site]
    jax.clear_caches()
    new = [np.asarray(a) for a in run(plan, graph, Z)]
    monkeypatch.setattr(bd, "_band_slab_i32", _cast_slab)
    jax.clear_caches()
    old = [np.asarray(a) for a in run(plan, graph, Z)]
    jax.clear_caches()
    for a, b in zip(new, old):
        np.testing.assert_array_equal(a, b)


def test_band_slab_is_an_int8_dot():
    """Both band operands reach the dot as int8 (no int32 widening)."""
    A8 = jnp.ones((3, 4, 12), jnp.int8)
    Zp = jnp.ones((5, 4, 8), jnp.int8)
    text = jax.jit(bd._band_slab_i32, static_argnums=2).lower(
        A8, Zp, 1).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots and all("xi8>" in ln and "-> tensor<3x4x8xi32>" in ln
                        for ln in dots)


# ---------------------------------------------------------------------------
# One draw's statistic against a dense float64 oracle
# ---------------------------------------------------------------------------


def _dense_oracle(graph, plan, vals64, perm, den, S0, stat):
    """Moran / Geary of the relabeled graph with new position p holding
    ``vals64[perm[p]]``, in float64."""
    order = np.asarray(plan.order)
    n = plan.n
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    idx_r = rank[np.asarray(graph.neighbor_idx)[order]]
    w_r = np.asarray(graph.neighbor_w, np.float64)[order]
    zp = vals64[perm]
    cross = np.zeros(zp.shape[1])
    sqd = np.zeros(zp.shape[1])
    for j in range(idx_r.shape[1]):
        nb = zp[idx_r[:, j]]
        cross += (w_r[:, j:j + 1] * zp * nb).sum(axis=0)
        sqd += (w_r[:, j:j + 1] * (zp - nb) ** 2).sum(axis=0)
    moran = n / S0 * cross / den
    geary = (n - 1) * sqd / (2.0 * S0 * den)
    return {"moran": moran, "geary": geary,
            "moran_geary": np.stack([moran, geary])}[stat]


@pytest.mark.parametrize("precision", ["f32", "int8_exact", "int8", "int4"])
@pytest.mark.parametrize("stat", ["moran", "geary", "moran_geary"])
def test_xla_engine_matches_dense_oracle(small, precision, stat):
    coords, graph, Z, plan = small
    n, B = plan.n, plan.block
    nb = plan.local_idx.shape[0] // B
    S0 = float(np.asarray(graph.neighbor_w).sum())
    perm = np.random.default_rng(5).permutation(n).astype(np.int32)
    gidx = np.clip(np.arange((nb + 2) * B) - B, 0, n - 1)
    rows = jnp.asarray(perm[gidx])
    G = Z.shape[1]
    kw = dict(block=B, n=n, stat=stat)
    if precision == "f32":
        vals = np.asarray(Z, np.float64)
        den = jnp.sum(Z * Z, axis=0)
        A = bd._build_band(plan.local_idx, plan.w_local, B, jnp.float32)
        got = bd._banded_stat(A, plan.far_src, plan.far_dst, plan.far_w,
                              plan.rc_sum, Z, den, S0, rows, **kw)
        tol = dict(rtol=2e-5, atol=1e-7)
    else:
        if precision == "int4":
            Zpk, s = bd._quantize_z4(Z)
            codes = bd._unpack_nibbles(Zpk)
            Zp = bd._unpack_nibbles(Zpk[rows])
        else:
            codes, s = bd._quantize_z(Z)
            Zp = codes[rows]
        vals = np.asarray(codes, np.float64) * np.asarray(s, np.float64)
        den = jnp.asarray(np.sum(vals ** 2, axis=0), jnp.float32)
        sz2 = s * s
        if precision == "int8_exact":
            A8, sw = bd._build_band_i8(plan.local_idx, plan.w_local, B)
            got = bd._banded_stat_i8(A8, sw, plan.far_src, plan.far_dst,
                                     plan.far_w, plan.rc_sum, codes, sz2,
                                     den, S0, rows, **kw)
        else:
            A8, sw, _, far_q = bd._quantized_weights(
                plan.local_idx, plan.w_local, plan.far_src, plan.far_w, B)
            got = bd._banded_stat_win(
                A8, sw, plan.far_src, plan.far_dst, far_q, plan.rc_sum,
                Zp.reshape(nb + 2, B, G), sz2, den, S0, **kw)
        tol = dict(rtol=1e-5, atol=1e-7)
    expect = _dense_oracle(graph, plan, vals, perm,
                           np.asarray(den, np.float64), S0, stat)
    np.testing.assert_allclose(np.asarray(got), expect, **tol)


# ---------------------------------------------------------------------------
# Local int8 operators against a numpy int64 evaluation
# ---------------------------------------------------------------------------


def _draws(seed, purpose, P, n):
    """Original-order Feistel tables: draw d gives cell c the value of
    cell ``F_d(c)``, the stream the banded local operators use."""
    base = key_for(jnp.uint32(seed), purpose, 0)
    ids = jnp.arange(n, dtype=jnp.int32)
    return [np.asarray(feistel_apply(jax.random.fold_in(base, jnp.int32(d)),
                                     ids, n)) for d in range(P)]


def _codes(graph):
    """Neighbour ids and int8 weight codes under the full-row scale."""
    w = np.asarray(graph.neighbor_w, np.float32)
    rowmax = w.max(axis=1, keepdims=True)
    sw = np.where(rowmax > 0, rowmax / np.float32(127.0), np.float32(1.0))
    q = np.clip(np.round(w / sw), 0, 127).astype(np.int64)
    return np.asarray(graph.neighbor_idx), q


def _lag(idx, q, T):
    return sum(q[:, j:j + 1] * T[idx[:, j]] for j in range(idx.shape[1]))


def _counts(p, P):
    return np.round(np.asarray(p, np.float64) * (P + 1) - 1).astype(np.int64)


def test_local_moran_int8_matches_int64_reference(small):
    _, graph, Z, plan = small
    P, seed = 13, 2
    idx, q = _codes(graph)
    Zq = np.asarray(bd._quantize_z(Z)[0], np.int64)
    obs = np.abs(Zq * _lag(idx, q, Zq))
    count = np.zeros_like(obs)
    for F in _draws(seed, "perm_feistel_local", P, plan.n):
        T = Zq[F]
        count += np.abs(T * _lag(idx, q, T)) >= obs
    got = bd.banded_local_moran_pvalues(plan, Z, seed, P)
    np.testing.assert_array_equal(_counts(got, P), count)


def test_local_geary_int8_matches_int64_reference(small):
    _, graph, Z, plan = small
    P, seed = 13, 3
    idx, q = _codes(graph)
    Wq = q.sum(axis=1, keepdims=True)
    Zq = np.asarray(bd._quantize_z(Z)[0], np.int64)

    def c(T):
        return T * T * Wq + _lag(idx, q, T * T) - 2 * T * _lag(idx, q, T)

    obs = c(Zq)
    count = np.zeros_like(obs)
    for F in _draws(seed, "perm_feistel_local_geary", P, plan.n):
        count += c(Zq[F]) <= obs
    c_op, got = bd.banded_local_geary(plan, Z, seed, P, precision="int8")
    np.testing.assert_array_equal(np.asarray(c_op), obs)
    np.testing.assert_array_equal(_counts(got, P), count)


def test_lees_l_int8_matches_int64_reference(small):
    _, graph, Z, plan = small
    P, seed = 13, 4
    Zy = Z[:, ::-1]
    idx, q = _codes(graph)
    xq = np.asarray(bd._quantize_z(Z)[0], np.int64)
    yq = np.asarray(bd._quantize_z(Zy)[0], np.int64)
    obs = np.abs(xq * _lag(idx, q, yq))
    count = np.zeros_like(obs)
    for F in _draws(seed, "perm_feistel_lee", P, plan.n):
        count += np.abs(xq * _lag(idx, q, yq[F])) >= obs
    _, got = bd.banded_lees_l(plan, Z, Zy, seed, P, precision="int8",
                              compute_cell_pvalues=True)
    np.testing.assert_array_equal(_counts(got, P), count)


@pytest.mark.parametrize("star", [True, False])
@pytest.mark.parametrize("alternative", ["two-sided", "greater", "less"])
def test_getis_int8_matches_integer_reference(small, star, alternative):
    """Binary-adjacency lag of int8 codes in int64; the draw-invariant
    centering terms in float32, in the operator's own expression order."""
    _, graph, Z, plan = small
    P, seed = 13, 5
    X = jnp.abs(Z) + 0.1
    n = plan.n
    idx = np.asarray(graph.neighbor_idx)
    Xq = np.asarray(bd._quantize_x(X)[0], np.int64)
    f32 = np.float32
    W = np.full((n, 1), idx.shape[1], f32)
    tot = Xq.sum(axis=0, keepdims=True).astype(f32)
    sq = (Xq * Xq).sum(axis=0, keepdims=True).astype(f32)
    m = f32(n if star else n - 1)

    def lag_me(T):
        return sum(T[idx[:, j]] for j in range(idx.shape[1])), T

    def decide(lag_d, me_d, lag_o, me_o):
        if star:
            A_d, A_o = lag_d + me_d, lag_o + me_o
            if alternative == "greater":
                return A_d >= A_o
            if alternative == "less":
                return A_d <= A_o
            c2 = (tot / m) * (W + f32(1.0))
            return (A_d - A_o).astype(f32) * (
                (A_d + A_o).astype(f32) - f32(2.0) * c2) >= 0

        def cp(lag, me):
            mef = me.astype(f32)
            xbar = (tot - mef) / m
            s2 = np.maximum((sq - mef * mef) / m - xbar * xbar, f32(0))
            s = np.sqrt(np.where(s2 > 0, s2, f32(1)))
            return (lag.astype(f32) - xbar * W) / s

        d, o = cp(lag_d, me_d), cp(lag_o, me_o)
        ext = {"greater": d >= o, "less": d <= o,
               "two-sided": np.abs(d) >= np.abs(o)}[alternative]
        return ext | ((lag_d == lag_o) & (me_d == me_o))

    lag_o, me_o = lag_me(Xq)
    count = np.zeros(Xq.shape, np.int64)
    for F in _draws(seed, "perm_feistel_getis", P, n):
        count += decide(*lag_me(Xq[F]), lag_o, me_o)
    got = _counts(bd.banded_getis(plan, X, seed, P, star=star,
                                  alternative=alternative,
                                  precision="int8"), P)
    if star:
        np.testing.assert_array_equal(got, count)
    else:
        # Gi's f32 centering may round differently under fusion; an
        # entry can move by one draw at a near-tie
        assert np.abs(got - count).max() <= 1
        assert (got == count).mean() > 0.99


# ---------------------------------------------------------------------------
# Removed options fail loudly
# ---------------------------------------------------------------------------


_ENTRIES = {
    "banded_permutation_test": lambda plan, graph, Z, v: (
        bd.banded_permutation_test(plan, Z, 600.0, jnp.zeros(Z.shape[1]),
                                   0, 3, band_impl=v)),
    "banded_local_moran": lambda plan, graph, Z, v: bd.banded_local_moran(
        plan, graph, Z, 0, 3, band_impl=v),
    "banded_local_moran_pvalues": lambda plan, graph, Z, v: (
        bd.banded_local_moran_pvalues(plan, Z, 0, 3, band_impl=v)),
    "banded_local_geary": lambda plan, graph, Z, v: bd.banded_local_geary(
        plan, Z, 0, 3, band_impl=v),
    "banded_getis": lambda plan, graph, Z, v: bd.banded_getis(
        plan, Z, 0, 3, band_impl=v),
    "banded_lees_l": lambda plan, graph, Z, v: bd.banded_lees_l(
        plan, Z, Z, 0, 3, band_impl=v),
}


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_removed_band_impl_raises(small, entry):
    _, graph, Z, plan = small
    for value in ("pallas", "pallas_halo", "auto"):
        with pytest.raises(ValueError, match="band_impl must be 'xla'"):
            _ENTRIES[entry](plan, graph, Z, value)


def test_removed_knn_method_raises(small):
    coords = small[0]
    with pytest.raises(ValueError, match="'auto', 'grid' or 'exact'"):
        build_graph(coords, n_neighbors=6, method="pallas")
    g = build_graph(coords, n_neighbors=6, method="exact")
    assert g.neighbor_idx.shape == (coords.shape[0], 6)
