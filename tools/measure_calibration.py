"""Null-calibration measurement at scale on the device.

On a synthetic null world (no spatial signal) at scale, measure for each
null precision (f32 / int8 / int4):

* chi-square GOF p-value of the permutation p-values against uniformity
  (10 equiprobable bins; p is discrete on k/(P+1));
* KS distance vs U(0,1) (descriptive — the discrete support inflates it
  by ~1/(2(P+1)));
* the borderline-decision flip rate vs f32 at raw alpha=0.05 and the
  BH-FDR discovery counts.

Prints one JSON line per precision. CPU twin:
tests/test_null_calibration.py.

Env: CAL_CELLS (250k), CAL_GENES (2048), CAL_PERMS (499), CAL_K (6),
CAL_CHUNK (gene-chunk width, default 1024; narrower chunks bound the
f32 banded path's temporaries at high k).
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
from scipy import stats

from spatialcore_tpu.ops.banded import banded_permutation_test, build_null_plan
from spatialcore_tpu.ops.fdr import apply_fdr
from spatialcore_tpu.ops.graph import build_graph
from spatialcore_tpu.ops.moran import moran_observed, standardize

N = int(os.environ.get("CAL_CELLS", 250_000))
G = int(os.environ.get("CAL_GENES", 2048))
P = int(os.environ.get("CAL_PERMS", 499))
K = int(os.environ.get("CAL_K", 6))
CHUNK = int(os.environ.get("CAL_CHUNK", 1024))

coords = jax.random.uniform(jax.random.key(0), (N, 2), jnp.float32, 0, 3000)
_ = float(coords[0, 0])   # eat the first-readback stall
graph = build_graph(coords, n_neighbors=K)
plan = build_null_plan(graph, coords)
jax.block_until_ready(plan.local_idx)
S0 = float(N)
print(f"[cal] N={N:,} G={G} P={P} k={K}", flush=True)

results = {}
ps = {}
for prec in ("f32", "int8", "int4"):
    p_parts = []
    t0 = time.time()
    for s in range(0, G, CHUNK):
        g = min(CHUNK, G - s)
        X = jax.random.normal(jax.random.fold_in(jax.random.key(1), s),
                              (N, g), jnp.float32)
        Z, _zv = standardize(X)
        obs = moran_observed(graph, Z, S0)
        p, _, _ = banded_permutation_test(
            plan, Z, S0, obs, seed=3, n_permutations=P, precision=prec)
        p_parts.append(np.asarray(p))
        del X, Z, obs
    p = np.concatenate(p_parts)
    ps[prec] = p
    counts, _ = np.histogram(p, bins=np.linspace(0, 1, 11))
    gof = stats.chisquare(counts).pvalue
    ks = stats.kstest(p, "uniform").statistic
    q = np.asarray(apply_fdr(jnp.asarray(p), "fdr_bh"))
    results[prec] = {
        "chi2_gof_p": round(float(gof), 4),
        "ks_distance": round(float(ks), 5),
        "sig_frac_alpha05": round(float((p < 0.05).mean()), 5),
        "fdr05_discoveries": int((q < 0.05).sum()),
        "seconds": round(time.time() - t0, 1),
    }
    print(f"[cal] {prec}: {results[prec]}", flush=True)

for prec in ("int8", "int4"):
    flips = float(((ps[prec] < 0.05) != (ps["f32"] < 0.05)).mean())
    mad = float(np.abs(ps[prec] - ps["f32"]).mean())
    results[prec]["flip_rate_vs_f32_alpha05"] = round(flips, 5)
    results[prec]["mean_abs_dp_vs_f32"] = round(mad, 5)
    print(f"[cal] {prec} vs f32: flips={flips:.4f} mean|dp|={mad:.4f}",
          flush=True)

print(json.dumps({"n_cells": N, "n_genes": G, "n_perms": P, "k": K,
                  "results": results}))
