"""Smoke run of the permutation-null path on the GPU, at 1M cells.

    python chip_smoke.py [--seed N] [--out DIR]     # one card
    python chip_smoke.py --four-cards               # gene-sharded, 4 cards

Prints the card's name and power limit first, then for every phase its
compile and run times and each comparison's maximum error beside its
tolerance. The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed. The script exits non-zero, printing
no result, when the first JAX device is not a GPU, when ``nvidia-smi`` is
missing, or when it is run without the ``spatialcore_tpu`` package beside
it.

One card, in one process:

1. graph and plan: ``build_graph`` (grid kNN, k=6) on 1M uniform cells and
   ``build_null_plan(block=256)``; kNN sets of 2,000 sampled cells against
   ``scipy.spatial.cKDTree`` (equal apart from ties at the k-th distance);
2. headline null: one 4,096-gene tile prepared as ``bench.py`` does,
   through ``banded_permutation_test`` at int4 (run twice: counts must be
   bitwise equal) and int8, P=20, with the compiled step's memory analysis
   and its band-dot lowering;
3. reference at real width, 1M x 256 genes under ``"highest"`` matmul
   precision: observed Moran's I against float64 ``scipy.sparse``; the f32
   banded null (sort stream) against ``ops.moran.permutation_test_global``
   with the same draws; int8 and int4 p-values against f32;
4. local family: int8 LISA p-values at 1M x 512 (against the direct f32
   kernel on the same draws) and ``streaming_local_null`` over two tiles;
5. public API: ``sct.spatial.morans_i`` on a 100k-cell x 64-gene
   ``SpatialData`` with P=99 (needs pandas), observed I against float64
   ``scipy.sparse``.

``--four-cards`` runs only the gene-sharded path on a 1x4 mesh and the
same calls on one card: the int4 global null at 1M x 4,096 and the int8
LISA null at 1M x 2,048, requiring bitwise-equal counts.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


class Report:
    """Prints timings and checks; remembers which checks failed."""

    def __init__(self):
        self.failed = []

    def time(self, phase: str, what: str, seconds: float) -> None:
        print(f"[time] {phase}: {what} {seconds:.3f} s", flush=True)

    def check(self, name: str, err: float, tol: float) -> None:
        ok = bool(err <= tol)
        print(f"[check] {name}: max error {err:.3e} (tolerance {tol:.1e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(name)

    def require(self, name: str, cond: bool) -> None:
        print(f"[check] {name}: {'ok' if cond else 'FAIL'}", flush=True)
        if not cond:
            self.failed.append(name)


def _timed(fn, *args, **kwargs):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def _twice(rep: Report, phase: str, fn, *args, **kwargs):
    """Run ``fn`` twice: the first call's excess over the second is the
    compile (and trace) time, the second call is the run time."""
    out1, t1 = _timed(fn, *args, **kwargs)
    out2, t2 = _timed(fn, *args, **kwargs)
    rep.time(phase, "compile", max(t1 - t2, 0.0))
    rep.time(phase, "run", t2)
    return out1, out2, t2


def _gib(n_bytes) -> str:
    return f"{n_bytes / 2 ** 30:.2f} GiB"


def print_memory(label: str, compiled) -> None:
    ma = compiled.memory_analysis()
    if ma is None:
        print(f"[memory] {label}: not reported by this backend")
        return
    print(f"[memory] {label}: arguments "
          f"{_gib(ma.argument_size_in_bytes)}, outputs "
          f"{_gib(ma.output_size_in_bytes)}, temporaries "
          f"{_gib(ma.temp_size_in_bytes)}, aliased "
          f"{_gib(ma.alias_size_in_bytes)}", flush=True)


def band_dot_lowering(hlo_text: str) -> list:
    """Compiled-HLO lines of the matrix products with an int32 result —
    the library call (cuBLAS / cuBLASLt custom call, Triton GEMM fusion)
    or plain ``dot`` the s8 x s8 -> s32 band products were lowered to."""
    hits = []
    for line in hlo_text.splitlines():
        s = line.strip()
        if "s32[" not in s.split("=", 1)[-1][:80]:
            continue
        if (" dot(" in s or "custom-call(" in s or "__triton" in s
                or "__cublas" in s):
            hits.append(s[:300])
    return hits


def _global_null_lowered(plan, Zb, S0, obs, den, sz, seed, P, precision):
    """The compiled executable the public ``banded_permutation_test`` runs
    for this call (same static arguments, no padding at these widths)."""
    import jax.numpy as jnp

    from spatialcore_tpu.ops.banded import _banded_test

    return _banded_test.lower(
        plan.order, plan.local_idx, plan.w_local, plan.far_src,
        plan.far_dst, plan.far_w, plan.rc_sum, Zb, S0, obs,
        jnp.uint32(seed), den, sz, jnp.uint32(0), block=plan.block,
        n=plan.n, n_permutations=P, stat="moran", alternative="greater",
        precision=precision, perm_method="feistel", far_mode="win")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_graph(rep: Report, seed: int, n_cells: int, k: int = 6,
                n_check: int = 2000, block: int = 256):
    """Phase 1: graph + null plan, kNN sets checked against cKDTree."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.spatial import cKDTree

    from spatialcore_tpu.ops.banded import build_null_plan
    from spatialcore_tpu.ops.graph import build_graph

    coords = jax.random.uniform(jax.random.key(seed), (n_cells, 2),
                                jnp.float32, 0.0, 6000.0)
    graph, _, _ = _twice(rep, "graph", build_graph, coords, n_neighbors=k)
    plan, _, _ = _twice(rep, "plan", lambda: build_null_plan(
        graph, coords, block=block))

    c64 = np.asarray(coords, np.float64)
    q = np.random.default_rng(seed).choice(n_cells, min(n_check, n_cells),
                                           replace=False)
    dref, iref = cKDTree(c64).query(c64[q], k=k + 1)
    ours = np.asarray(graph.neighbor_idx)[q]
    bad = 0
    for r, cell in enumerate(q):
        ref_ids = [j for j in iref[r] if j != cell][:k]
        dk = np.sort(dref[r])[k]          # k-th neighbour distance
        for j in set(ours[r].tolist()) ^ set(ref_ids):
            d = np.linalg.norm(c64[cell] - c64[j])
            if abs(d - dk) > 1e-5 * dk + 1e-9:   # not a k-th-distance tie
                bad += 1
    rep.check(f"graph kNN sets vs cKDTree, {len(q)} cells (non-tie "
              f"mismatches)", bad, 0)
    rep.require("plan covers every edge",
                int((np.asarray(plan.w_local) > 0).sum()
                    + (np.asarray(plan.far_w) > 0).sum()) == n_cells * k)
    return coords, graph, plan


def phase_headline(rep: Report, graph, plan, seed: int, n_genes: int,
                   P: int = 20, out_dir: str | None = None):
    """Phase 2: one bench.py tile through the public global null, int4
    (twice, bitwise) and int8; memory analysis and band-dot lowering."""
    import jax
    import numpy as np

    from bench import make_tile_prep
    from spatialcore_tpu.ops.banded import banded_permutation_test

    S0 = float(plan.n)
    per_draw = {}
    for prec in ("int4", "int8"):
        phase = f"headline {prec} {plan.n}x{n_genes}"
        prep = make_tile_prep(graph, S0, prec)
        (Zb, den, obs, sz), t_prep = _timed(prep, jax.random.key(seed + 1),
                                            n_genes)
        rep.time(phase, "tile prep (compile + run)", t_prep)
        t0 = time.perf_counter()
        compiled = _global_null_lowered(plan, Zb, S0, obs, den, sz, seed, P,
                                        prec).compile()
        rep.time(phase, "AOT compile of the null step", time.perf_counter()
                 - t0)
        print_memory(phase, compiled)
        text = compiled.as_text()
        hits = band_dot_lowering(text)
        print(f"[lowering] {phase}: {len(hits)} int32-result matrix "
              f"products in the compiled step")
        for h in hits[:6]:
            print(f"[lowering]   {h}")
        if out_dir:
            with open(os.path.join(out_dir, f"headline_{prec}.hlo.txt"),
                      "w") as f:
                f.write(text)
        del compiled, text

        def run():
            return banded_permutation_test(
                plan, Zb, S0, obs, seed=seed, n_permutations=P,
                precision=prec, den=den, sz=sz)

        # the first call traces and finds the step just compiled in the
        # persistent cache; the second is the run time
        (p1, m1, s1), t_first = _timed(run)
        rep.time(phase, "first call through banded_permutation_test",
                 t_first)
        (p2, _, _), t_run = _timed(run)
        rep.time(phase, "run", t_run)
        per_draw[prec] = t_run / P
        rep.time(phase, f"per draw (run / {P})", per_draw[prec])
        p1 = np.asarray(p1)
        rep.require(f"{phase} p in (0, 1], shape ({n_genes},)",
                    p1.shape == (n_genes,) and bool(np.all(p1 > 0))
                    and bool(np.all(p1 <= 1)))
        rep.require(f"{phase} null mean/std finite",
                    bool(np.isfinite(np.asarray(m1)).all()
                         and np.isfinite(np.asarray(s1)).all()))
        if prec == "int4":
            c1 = np.round(p1 * (P + 1) - 1)
            c2 = np.round(np.asarray(p2) * (P + 1) - 1)
            rep.check(f"{phase} two runs, differing counts",
                      int((c1 != c2).sum()), 0)
        del Zb, den, obs, sz, p1, p2
    return per_draw


def phase_reference(rep: Report, coords, graph, plan, seed: int,
                    n_genes: int, P_legacy: int = 8, P: int = 99):
    """Phase 3: the banded nulls against plain references at real width,
    under ``"highest"`` matmul precision. The first half of the genes
    carry a smooth spatial field of growing amplitude (the observed-I
    check is relative, so it needs I away from zero); the rest are
    noise, so their nulls are not decided by the observed value alone."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from spatialcore_tpu.ops.banded import (
        _quantize_z4, _unpack_nibbles, banded_permutation_test)
    from spatialcore_tpu.ops.moran import (
        moran_observed, permutation_test_global, standardize)

    n = plan.n
    S0 = float(n)
    n_field = n_genes // 2

    @jax.jit
    def make_z(key, c):
        X = jax.random.normal(key, (n, n_genes), jnp.float32)
        field = jnp.sin(c[:, :1] / 300.0) + jnp.cos(c[:, 1:2] / 200.0)
        amp = jnp.where(jnp.arange(n_genes) < n_field,
                        jnp.linspace(0.5, 3.0, n_genes), 0.0)
        return standardize(X + amp * field)[0]

    with jax.default_matmul_precision("highest"):
        Z = make_z(jax.random.key(seed + 2), coords)
        obs, _, _ = _twice(rep, f"reference moran_observed {n}x{n_genes}",
                           jax.jit(moran_observed), graph, Z, S0)

        Z64 = np.asarray(Z[:, :n_field], np.float64)
        W = graph.to_csr().astype(np.float64)
        I64 = (n / W.sum()) * np.einsum("ig,ig->g", Z64, W @ Z64) \
            / np.einsum("ig,ig->g", Z64, Z64)
        del Z64
        err = np.max(np.abs(np.asarray(obs[:n_field], np.float64) - I64)
                     / np.abs(I64))
        rep.check(f"moran_observed vs float64 scipy.sparse W.Z, "
                  f"{n_field} spatial genes (rel)", err, 1e-5)

        (pb, mb, sb), _, _ = _twice(
            rep, f"banded f32 sort P={P_legacy}", lambda: (
                banded_permutation_test(plan, Z, S0, obs, seed=seed,
                                        n_permutations=P_legacy,
                                        precision="f32",
                                        perm_method="sort")))
        (pl, ml, sl), _, _ = _twice(
            rep, f"permutation_test_global P={P_legacy}", lambda: (
                permutation_test_global(graph, Z, S0, obs, seed=seed,
                                        n_permutations=P_legacy)))
        # the null mean of a few draws sits near zero, so its error is
        # scaled by the null's spread (the statistic's own scale)
        scale = np.maximum(np.abs(np.asarray(ml)), np.asarray(sl))
        rep.check("banded f32 null mean vs permutation_test_global "
                  "(rel. to max(|mean|, std))",
                  np.max(np.abs(np.asarray(mb) - np.asarray(ml)) / scale),
                  1e-4)
        rep.check("banded f32 null std vs permutation_test_global (rel)",
                  np.max(np.abs(np.asarray(sb) - np.asarray(sl))
                         / np.asarray(sl)), 1e-4)

        p32 = np.asarray(banded_permutation_test(
            plan, Z, S0, obs, seed=seed, n_permutations=P,
            precision="f32")[0])
        p8 = np.asarray(banded_permutation_test(
            plan, Z, S0, obs, seed=seed, n_permutations=P,
            precision="int8")[0])
        rep.check(f"int8 p vs f32 p, P={P} (abs)",
                  np.max(np.abs(p8 - p32)), 0.05)
        # int4's 15-level codes move single p-values of noise genes
        # further than 0.05 from the f32 operator on the unquantized z
        # (a statistical effect of the coarser operator): its engine is
        # checked against f32 on the SAME dequantized values, and its
        # decisions against f32 on z
        Zpk, s4 = _quantize_z4(Z)
        Zdq = _unpack_nibbles(Zpk).astype(jnp.float32) * s4
        obs_dq = moran_observed(graph, Zdq, S0)
        p4 = np.asarray(banded_permutation_test(
            plan, Zpk, S0, obs_dq, seed=seed, n_permutations=P,
            precision="int4", sz=s4)[0])
        p32_dq = np.asarray(banded_permutation_test(
            plan, Zdq, S0, obs_dq, seed=seed, n_permutations=P,
            precision="f32")[0])
        rep.check(f"int4 p vs f32 p on the dequantized codes, P={P} (abs)",
                  np.max(np.abs(p4 - p32_dq)), 0.05)
        print(f"[info] int4 p vs f32 p on z, P={P}: max abs difference "
              f"{np.max(np.abs(p4 - p32)):.3e}, mean "
              f"{np.mean(np.abs(p4 - p32)):.3e}")
        rep.check("int4 decisions at 0.05 vs f32 on z (flipped share)",
                  float(np.mean((p4 < 0.05) != (p32 < 0.05))), 0.05)
    del Z


def phase_local(rep: Report, graph, plan, seed: int, n_genes: int,
                P: int = 20, n_ref: int = 32):
    """Phase 4: int8 LISA p-values and the streamed local null."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from spatialcore_tpu.ops.banded import banded_local_moran_pvalues
    from spatialcore_tpu.ops.moran import local_moran, standardize
    from spatialcore_tpu.ops.streaming import (
        device_local_sink, streaming_local_null)

    n = plan.n
    key = jax.random.key(seed + 3)

    @jax.jit
    def tile(start):
        return jax.random.normal(jax.random.fold_in(key, start),
                                 (n, n_genes), jnp.float32)

    Z = jax.jit(standardize)(tile(0))[0]
    phase = f"local int8 LISA {n}x{n_genes} P={P}"
    p, _, _ = _twice(rep, phase, banded_local_moran_pvalues, plan, Z, seed,
                     P)
    p = np.asarray(p)
    rep.require(f"{phase} p in (0, 1], shape ({n}, {n_genes})",
                p.shape == (n, n_genes) and bool(np.all(p > 0))
                and bool(np.all(p <= 1)))

    # plain reference: the direct f32 kernel on the same (sort) draws
    Zr = Z[:, :n_ref]
    p8 = np.asarray(banded_local_moran_pvalues(plan, Zr, seed, P,
                                               perm_method="sort"))
    p32 = np.asarray(local_moran(graph, Zr, seed, P).p_value)
    rep.check(f"int8 LISA p vs direct f32 local_moran, {n_ref} genes "
              f"(mean abs)", float(np.abs(p8 - p32).mean()), 0.02)
    rep.check(f"int8 LISA decisions at 0.05 vs direct f32 (disagreeing "
              f"share)", float(((p8 < 0.05) != (p32 < 0.05)).mean()), 0.03)

    sink, finalize = device_local_sink(2 * n_genes, keys=("p", "p_adj"))
    t0 = time.perf_counter()
    streaming_local_null(graph, plan, lambda s, w: tile(s)[:, :w],
                         2 * n_genes, sink, stat="moran", seed=seed,
                         n_permutations=P, tile=n_genes, precision="int8",
                         keys=("p", "p_adj"))
    outs = jax.block_until_ready(finalize())
    rep.time(f"streaming_local_null 2 tiles of {n_genes}",
             "compile + run", time.perf_counter() - t0)
    sp = outs["p"]
    rep.require("streamed p shape", sp.shape == (n, 2 * n_genes))
    # tile 0 of the stream holds the same values as the direct call
    # above, but the stream standardizes and quantizes in ONE compiled
    # program: where z/s lands within an ulp of a rounding boundary an
    # int8 code can differ by one, which moves the counts of the cells
    # around it. Such flips are rare; a wrong draw stream or tile
    # offset would change nearly every entry. The sink keeps p as f16.
    diff = np.asarray(sp[:, :n_genes]) != p.astype(np.float16)
    rep.check("streamed tile-0 p vs direct call (share of differing "
              "entries)", float(diff.mean()), 1e-5)
    pa = np.asarray(outs["p_adj"], np.float32)
    rep.require("streamed p_adj finite and in (0, 1]",
                bool(np.isfinite(pa).all() and (pa > 0).all()
                     and (pa <= 1).all()))


def phase_public(rep: Report, seed: int, n_cells: int, n_genes: int,
                 P: int = 99):
    """Phase 5: ``sct.spatial.morans_i`` on a ``SpatialData``, with the
    default null choice and with ``null_method="banded"``. Observed I of
    the spatial genes against float64 ``scipy.sparse``; every p in
    (0, 1]; the spatial genes reach the smallest p, 1/(P+1)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pandas as pd

    import spatialcore_tpu as sct
    from spatialcore_tpu.ops.graph import build_graph

    n_field = n_genes // 2

    @jax.jit
    def make(key):
        kc, kx = jax.random.split(key)
        c = jax.random.uniform(kc, (n_cells, 2), jnp.float32, 0.0, 2000.0)
        field = jnp.sin(c[:, :1] / 100.0) + jnp.cos(c[:, 1:2] / 70.0)
        amp = jnp.where(jnp.arange(n_genes) < n_field,
                        jnp.linspace(0.5, 3.0, n_genes), 0.0)
        return c, jax.random.normal(kx, (n_cells, n_genes)) + amp * field

    coords, X = (np.asarray(a) for a in make(jax.random.key(seed + 4)))
    names = [f"g{i}" for i in range(n_genes)]

    def run(null_method):
        adata = sct.SpatialData(X=X, var=pd.DataFrame(index=names),
                                obsm={"spatial": coords})
        sct.spatial.morans_i(adata, n_permutations=P, seed=seed,
                             null_method=null_method)
        return adata.uns["morans_i"]

    W = build_graph(coords, n_neighbors=6).to_csr().astype(np.float64)
    Z64 = X[:, :n_field].astype(np.float64)
    Z64 = (Z64 - Z64.mean(0)) / Z64.std(0)
    I64 = (n_cells / W.sum()) * np.einsum("ig,ig->g", Z64, W @ Z64) \
        / np.einsum("ig,ig->g", Z64, Z64)
    for null_method in ("auto", "banded"):
        phase = f"public morans_i {n_cells}x{n_genes} P={P} ({null_method})"
        df, _, _ = _twice(rep, phase, run, null_method)
        rep.require(f"{phase}: one row per gene",
                    list(df["gene"]) == names)
        I = df["I"].to_numpy(np.float64)[:n_field]
        rep.check(f"{phase}: I vs float64 scipy.sparse W.Z, {n_field} "
                  f"spatial genes (rel)", np.max(np.abs(I - I64) / I64),
                  1e-5)
        p = df["p_value"].to_numpy()
        rep.require(f"{phase}: p in (0, 1]",
                    bool(np.all(p > 0) and np.all(p <= 1)))
        rep.check(f"{phase}: spatial genes' p above 1/(P+1)",
                  float(np.max(p[:n_field]) - 1.0 / (P + 1)), 1e-6)


def phase_four_cards(rep: Report, graph, plan, seed: int, n_global: int,
                     n_local: int, P: int = 20):
    """Gene-sharded global int4 and local int8 nulls on a 1x4 mesh, each
    against the same call on one card: counts must be bitwise equal."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import make_tile_prep
    from spatialcore_tpu.ops.banded import (
        banded_local_moran_pvalues, banded_permutation_test)
    from spatialcore_tpu.ops.moran import standardize
    from spatialcore_tpu.parallel import (
        auto_mesh, sharded_banded_local_moran,
        sharded_banded_permutation_test)

    mesh = auto_mesh(n_devices=4)
    S0 = float(plan.n)
    Zb, den, obs, sz = make_tile_prep(graph, S0, "int4")(
        jax.random.key(seed + 1), n_global)
    p1, _, _ = _twice(rep, f"one card int4 {plan.n}x{n_global}", lambda: (
        banded_permutation_test(plan, Zb, S0, obs, seed=seed,
                                n_permutations=P, precision="int4",
                                den=den, sz=sz)[0]))
    p4, _, _ = _twice(rep, f"1x4 mesh int4 {plan.n}x{n_global}", lambda: (
        sharded_banded_permutation_test(plan, Zb, S0, obs, seed=seed,
                                        n_permutations=P, mesh=mesh,
                                        den=den, precision="int4",
                                        sz=sz)[0]))
    rep.check("1x4 mesh vs one card, int4 global counts (differing)",
              int((np.asarray(p1) != np.asarray(p4)).sum()), 0)
    del Zb, den, obs, sz, p1, p4

    Z = jax.jit(lambda k: standardize(jax.random.normal(
        k, (plan.n, n_local), jnp.float32))[0])(jax.random.key(seed + 3))
    q1, _, _ = _twice(rep, f"one card int8 LISA {plan.n}x{n_local}",
                      banded_local_moran_pvalues, plan, Z, seed, P)
    q1 = np.asarray(q1)
    q4, _, _ = _twice(rep, f"1x4 mesh int8 LISA {plan.n}x{n_local}",
                      lambda: sharded_banded_local_moran(
                          plan, graph, Z, seed, P, mesh,
                          precision="int8").p_value)
    rep.check("1x4 mesh vs one card, int8 LISA p (differing entries)",
              int((q1 != np.asarray(q4)).sum()), 0)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def card_info() -> str:
    """``name, power.limit`` of every card, as ``nvidia-smi`` reports."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the gene-sharded path on 4 cards")
    ap.add_argument("--out", default=None,
                    help="directory to write the compiled headline HLO "
                         "text to (not written by default)")
    args = ap.parse_args(argv)

    try:
        info = card_info()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: nvidia-smi failed ({e}); no GPU here",
              file=sys.stderr)
        return 2
    print(f"[card] {info}", flush=True)

    sys.path.insert(0, HERE)
    try:
        import spatialcore_tpu
    except ImportError as e:
        print(f"chip_smoke: spatialcore_tpu not importable beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    pkg = os.path.dirname(os.path.abspath(spatialcore_tpu.__file__))
    if os.path.dirname(pkg) != HERE:
        print(f"chip_smoke: spatialcore_tpu comes from {pkg}, not from "
              f"this checkout", file=sys.stderr)
        return 2

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: first device is {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    print(f"[device] {dev.platform} {dev.device_kind} x{len(devices)}; "
          f"compile cache {jax.config.jax_compilation_cache_dir or 'env'}",
          flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    rep = Report()
    t_all = time.perf_counter()
    coords, graph, plan = phase_graph(rep, args.seed, 1_000_000)
    if args.four_cards:
        phase_four_cards(rep, graph, plan, args.seed, 4096, 2048)
    else:
        phase_headline(rep, graph, plan, args.seed, 4096, out_dir=args.out)
        phase_reference(rep, coords, graph, plan, args.seed, 256)
        phase_local(rep, graph, plan, args.seed, 512)
        phase_public(rep, args.seed, 100_000, 64)
    rep.time("all phases", "wall", time.perf_counter() - t_all)
    if rep.failed:
        print(f"chip_smoke: FAILED {rep.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
