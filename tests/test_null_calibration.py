"""Statistical calibration of the banded permutation nulls (VERDICT r3
item 3).

The quantized-operator argument ("draws compare against the observed
value of the SAME quantized operator") is tested statistically, not just
asserted: on a synthetic null world (i.i.d. expression, no spatial
signal) the permutation p-values must be uniform for EVERY precision
(f32 / bf16 / int8 / int4), and the precisions must agree on borderline
FDR decisions up to Monte-Carlo noise.

p-value convention under test: two-one-sided ``(#extreme + 1)/(P + 1)``
(ref /root/reference/src/spatialcore/spatial/autocorrelation.py:318-332).
The p-values are discrete on {k/(P+1)}, so uniformity runs as a
chi-square on equiprobable bins rather than a continuous KS.

The at-scale twin of this test (250k cells x 2,048 genes, on the
device) is tools/measure_calibration.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

from spatialcore_tpu.ops.banded import banded_permutation_test, build_null_plan
from spatialcore_tpu.ops.fdr import apply_fdr
from spatialcore_tpu.ops.graph import build_graph
from spatialcore_tpu.ops.moran import moran_observed, standardize

N, G, P, K = 2500, 256, 199, 6


@pytest.fixture(scope="module")
def null_world():
    rng = np.random.default_rng(42)
    coords = rng.uniform(0, 1000, (N, 2)).astype(np.float32)
    X = rng.normal(size=(N, G)).astype(np.float32)   # no spatial signal
    graph = build_graph(jnp.asarray(coords), n_neighbors=K)
    plan = build_null_plan(graph, coords, block=64)
    Z, _ = standardize(jnp.asarray(X))
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = moran_observed(graph, Z, S0)
    return plan, Z, S0, obs


def _pvals(null_world, precision):
    plan, Z, S0, obs = null_world
    p, _, _ = banded_permutation_test(
        plan, Z, S0, obs, seed=7, n_permutations=P, precision=precision)
    return np.asarray(p)


def _chi2_uniform(p, bins=10):
    """Chi-square GOF p-value against uniformity over equiprobable bins.

    p is supported on {k/(P+1), k=1..P+1}; with bins dividing (P+1) every
    bin holds the same number of support points, so the discrete null is
    exactly equiprobable per bin.
    """
    edges = np.linspace(0, 1, bins + 1)
    counts, _ = np.histogram(p, bins=edges)
    return stats.chisquare(counts).pvalue


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8", "int4"])
def test_null_pvalues_uniform(null_world, precision):
    """Under a no-signal world every precision's p-values are uniform:
    chi-square GOF must not reject at the 1e-3 level (G=256 draws of a
    U{1/(P+1)..1} variable; a mis-calibrated operator — e.g. comparing
    quantized draws to the UNQUANTIZED observed value — fails this hard,
    verified by construction when writing the test)."""
    p = _pvals(null_world, precision)
    assert p.shape == (G,)
    gof = _chi2_uniform(p)
    assert gof > 1e-3, f"{precision}: chi2 GOF p={gof:.2e}, " \
                       f"mean p={p.mean():.3f}"
    # no extreme inflation/deflation of the significant fraction
    frac = (p < 0.05).mean()
    assert 0.01 <= frac <= 0.11, f"{precision}: {frac:.3f} sig at 0.05"


def test_quantized_decision_flip_rates(null_world):
    """Borderline-decision agreement between precisions on the null
    world: raw alpha=0.05 flips bounded by Monte-Carlo noise, and BH-FDR
    at 0.05 discovers (almost) nothing for every precision."""
    ps = {prec: _pvals(null_world, prec)
          for prec in ("f32", "int8", "int4")}
    for prec in ("int8", "int4"):
        flips = ((ps[prec] < 0.05) != (ps["f32"] < 0.05)).mean()
        bound = 0.02 if prec == "int8" else 0.05
        assert flips <= bound, f"{prec} vs f32 flip rate {flips:.3f}"
    for prec, p in ps.items():
        q = np.asarray(apply_fdr(jnp.asarray(p), "fdr_bh"))
        assert (q < 0.05).sum() <= 1, f"{prec}: null-world FDR discoveries"


def test_signal_world_power_agreement(null_world):
    """Planted spatial signal: all precisions detect the same gene set at
    FDR 0.05 (power parity of the quantized operators)."""
    plan, Z, S0, _ = null_world
    rng = np.random.default_rng(3)
    # rebuild a world where the first 16 genes carry smooth signal
    coords = rng.uniform(0, 1000, (N, 2)).astype(np.float32)
    X = rng.normal(size=(N, G // 4)).astype(np.float32)
    for j in range(16):
        X[:, j] += np.sin(coords[:, 0] / (40 + 10 * j)) * 1.5
    graph = build_graph(jnp.asarray(coords), n_neighbors=K)
    plan = build_null_plan(graph, coords, block=64)
    Zs, _ = standardize(jnp.asarray(X))
    S0 = float(np.asarray(graph.neighbor_w).sum())
    obs = moran_observed(graph, Zs, S0)
    sigsets = {}
    for prec in ("f32", "int8", "int4"):
        p, _, _ = banded_permutation_test(
            plan, Zs, S0, obs, seed=11, n_permutations=P, precision=prec)
        q = np.asarray(apply_fdr(jnp.asarray(np.asarray(p)), "fdr_bh"))
        sigsets[prec] = set(np.flatnonzero(q < 0.05))
        assert set(range(16)) <= sigsets[prec], f"{prec} missed signal"
    assert sigsets["int8"] == sigsets["f32"]
    assert sigsets["int4"] == sigsets["f32"]
