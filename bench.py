"""Headline benchmark: SUSTAINED global-Moran permutation throughput at 1M cells.

BASELINE.md north star: Moran's I, 5,000 genes x 1,000 permutations on 1M
Xenium-like cells in <60 s  =>  83,333 genes*perms/sec on one card. This
script runs the FULL workload end-to-end (gene-batched, prep included in
the timed region) on the GPU(s) JAX finds and prints one JSON line

    {"metric": "moran_sustained_genes_perms_per_sec_1M_cells", "value": ...,
     "unit": "genes*perms/sec", "vs_baseline": value / target,
     "platform": "gpu", "device_kind": ..., "n_devices": ...}

where target = PER_CHIP_TARGET x n_devices. It refuses to run (exit code
2, no JSON) when the first device is not a GPU: a CPU number is not a
device measurement. Graph-build / null-plan times go to stderr.

The null path is the banded engine (ops/banded.py): Hilbert-relabeled
edges evaluated as block-banded dense matmuls, one random row gather per
draw, Feistel permutations. Default precision is int4 (BENCH_PREC):
standardized values quantize per gene and nibble-pack two gene codes per
byte (split-half layout), halving the gathered bytes of int8. Band
products are EXACT s8xs8->s32 dots on unpacked codes; draws compare
against the observed value of the same quantized operator, so the null is
exactly calibrated for that operator (tools/measure_calibration.py
measures its decision agreement with f32).

  * extreme counts accumulate ON DEVICE across draw chunks — the whole
    workload is enqueued asynchronously and the host blocks exactly once,
    at the end (zero mid-flight readbacks);
  * every (width, chunk) executable is AOT-compiled via .lower().compile()
    before the clock starts, so no compile or warm-up execution pollutes
    the timed region.

A device fault fails the run; nothing is retried or narrowed.

Env overrides: BENCH_CELLS, BENCH_GENES (default 8192 int4/int8 / 6144
otherwise), BENCH_PERMS (default 1000), BENCH_K, BENCH_CHUNK (default 200),
BENCH_PREC=int4|int8|bf16|f32 (default int4), BENCH_TILE (default 4096
int4/int8 / 2048 otherwise), BENCH_FAR=auto|win|exact, BENCH_BLOCK,
BENCH_MODE=sustained|burst, BENCH_MESH=CxG (e.g. 1x4: run gene-sharded over
a cells x genes mesh — requires C*G visible devices).
"""

import functools
import json
import os
import sys
import time


PER_CHIP_TARGET = 83333.0  # genes*perms/sec on one card


def make_tile_prep(graph, S0, prec, chunk_genes=1024):
    """``prep_width(key, w) -> (Zb, den, I_obs, sz)`` for a w-wide batch
    of N(0, 1) genes generated on the device.

    Each <=``chunk_genes`` chunk is generated, standardized and reduced to
    den = Σz² and the observed Moran's I in one jit (the f32 standardize
    intermediates stay chunk-sized), then quantized for ``prec``: int8
    codes, UNPACKED int4 codes (packed across the whole tile here — the
    split-half pairing spans the tile, not the chunk), or bf16. ``sz`` is
    the per-gene quantization scale (ones for bf16).
    """
    import jax
    import jax.numpy as jnp

    from spatialcore_tpu.ops.banded import (
        _pack_codes, _quantize_z, _quantize_z4_codes)
    from spatialcore_tpu.ops.moran import moran_observed, standardize

    n_cells = graph.neighbor_idx.shape[0]

    @functools.partial(jax.jit, static_argnames=("g",))
    def prep_chunk(key, g):
        X = jax.random.normal(key, (n_cells, g), jnp.float32)
        Z, _ = standardize(X)
        den = jnp.sum(Z * Z, axis=0)
        den = jnp.where(den > 0, den, 1.0)
        I_obs = moran_observed(graph, Z, S0)
        if prec == "int8":
            Zq, s_z = _quantize_z(Z)
            return Zq, den, I_obs, s_z
        if prec == "int4":
            codes, s_z = _quantize_z4_codes(Z)
            return codes, den, I_obs, s_z
        return Z.astype(jnp.bfloat16), den, I_obs, jnp.ones((g,), jnp.float32)

    pack = jax.jit(_pack_codes)

    def cat(parts, j):
        return (parts[0][j] if len(parts) == 1
                else jnp.concatenate([p[j] for p in parts],
                                     axis=1 if j == 0 else 0))

    def prep_width(key, w):
        gp = min(chunk_genes, w)
        parts = [prep_chunk(jax.random.fold_in(key, i), min(gp, w - s))
                 for i, s in enumerate(range(0, w, gp))]
        if prec != "int4":
            return tuple(cat(parts, j) for j in range(4))
        if len(parts) == 1:
            Zb = pack(parts[0][0])          # splits the lone chunk in half
        else:
            # pack HALF-OFFSET chunk pairs (global split-half layout:
            # packed column j pairs gene j with gene j + w/2) without
            # ever concatenating the full-width code matrix
            if len(parts) % 2 or w % (2 * gp):
                raise ValueError(f"int4 tile of {w} genes must hold an "
                                 f"even count of {gp}-gene chunks")
            h = len(parts) // 2
            packed = [pack(parts[i][0], parts[i + h][0]) for i in range(h)]
            Zb = packed[0] if h == 1 else jnp.concatenate(packed, axis=1)
        return (Zb,) + tuple(cat(parts, j) for j in (1, 2, 3))

    return prep_width


def main():
    n_cells = int(os.environ.get("BENCH_CELLS", 1_000_000))
    n_perms = int(os.environ.get("BENCH_PERMS", 1000))
    k = int(os.environ.get("BENCH_K", 6))
    mode = os.environ.get("BENCH_MODE", "sustained")
    prec = os.environ.get("BENCH_PREC", "int4")
    tile = int(os.environ.get(
        "BENCH_TILE", 4096 if prec in ("int8", "int4") else 2048))
    chunk = int(os.environ.get("BENCH_CHUNK", 200))
    far_env = os.environ.get("BENCH_FAR", "auto")
    mesh_spec = os.environ.get("BENCH_MESH", "")
    if mode == "burst":
        n_genes = int(os.environ.get("BENCH_GENES", 2048))
        n_perms = int(os.environ.get("BENCH_PERMS", 100))
    else:
        # tile-quantized gene count >= the 5,000-gene north star: 2x 4096
        # tiles under int8/int4, 3x 2048 under bf16 — whole tiles only, so
        # one executable serves every batch and no narrow tail batch pays
        # the per-draw row gather for a fraction of the genes
        n_genes = int(os.environ.get(
            "BENCH_GENES", 8192 if prec in ("int8", "int4") else 6144))
    chunk = min(chunk, n_perms)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] refusing to run: first device is {dev.platform!r} "
              f"({dev.device_kind}), not a GPU", file=sys.stderr)
        sys.exit(2)

    from spatialcore_tpu.core.logging import setup_logging
    from spatialcore_tpu.ops.banded import build_null_plan
    from spatialcore_tpu.ops.graph import build_graph

    # package INFO logs default to stdout; the driver parses stdout as ONE
    # JSON line, so route them to stderr with the other [bench] diagnostics
    setup_logging(stream=sys.stderr)

    mesh = None
    n_dev = 1
    if mesh_spec:
        import numpy as np
        from jax.sharding import Mesh

        c, g = (int(v) for v in mesh_spec.lower().split("x"))
        n_dev = c * g
        devs = jax.devices()[:n_dev]
        if len(devs) < n_dev:
            raise SystemExit(f"BENCH_MESH={mesh_spec} needs {n_dev} devices, "
                             f"have {len(jax.devices())}")
        mesh = Mesh(np.array(devs).reshape(c, g), ("cells", "genes"))

    print(f"[bench] device={dev.platform}:{dev.device_kind} x{n_dev} "
          f"N={n_cells:,} G={n_genes} P={n_perms} k={k} mode={mode}"
          f"{' mesh=' + mesh_spec if mesh_spec else ''}", file=sys.stderr)
    # count new persistent-cache entries at exit: "wrote N" = N misses
    cache_dir = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
                 or jax.config.jax_compilation_cache_dir)
    n_cache_before = (len(os.listdir(cache_dir))
                      if cache_dir and os.path.isdir(cache_dir) else 0)
    print(f"[bench] compile cache: dir={cache_dir} entries={n_cache_before}",
          file=sys.stderr)

    kc, kx = jax.random.split(jax.random.key(0))
    coords_j = jax.random.uniform(kc, (n_cells, 2), jnp.float32, 0.0, 6000.0)
    jax.block_until_ready(coords_j)

    # pass the DEVICE array: the grid build then runs with no bulk
    # host<->device transfers
    t0 = time.time()
    graph = build_graph(coords_j, n_neighbors=k)
    jax.block_until_ready(graph.neighbor_w)
    t_graph = time.time() - t0
    # 5-run spread: re-run the build (warm executables, fresh coordinate
    # draws so the search really runs) to split compile time from the
    # search itself
    graph_warm = []
    for i in range(4):
        ci = jax.random.uniform(jax.random.fold_in(kc, i + 1),
                                (n_cells, 2), jnp.float32, 0.0, 6000.0)
        t1 = time.time()
        gw = build_graph(ci, n_neighbors=k)
        jax.block_until_ready(gw.neighbor_w)
        graph_warm.append(round((time.time() - t1) * 1e3, 1))
        del gw, ci
    print(f"[bench] graph build: {t_graph*1e3:.0f} ms cold-process, "
          f"warm spread {graph_warm} ms", file=sys.stderr)

    S0 = float(n_cells)

    t0 = time.time()
    block = int(os.environ.get("BENCH_BLOCK", 256))
    plan = build_null_plan(graph, coords_j, block=block)
    t_plan_cold = time.time() - t0
    # split compile-vs-execute: the first build pays any compiles the
    # persistent cache missed; the second runs the same executables only
    t0 = time.time()
    plan2 = build_null_plan(graph, coords_j, block=block)
    t_plan_warm = time.time() - t0
    del plan2
    print(f"[bench] null plan build: {t_plan_cold:.1f}s cold-process, "
          f"{t_plan_warm:.1f}s warm (execute-only; spread = compile cost) "
          f"(block={block})", file=sys.stderr)

    # batch schedule: full tiles + tail rounded up to tile or tile/2 so at
    # most two executable widths exist (a 904-wide tail would recompile
    # inside the timed region); ONE shared implementation with
    # ops/streaming.py
    from spatialcore_tpu.ops.streaming import tile_widths

    @jax.jit
    def to_counts(acc, p, pc):
        return acc + jnp.round(p * (pc + 1.0) - 1.0)

    prep_width = make_tile_prep(graph, S0, prec)

    far_mode = far_env if far_env != "auto" else (
        "win" if prec in ("int8", "int4") else "exact")

    shard_batch = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from spatialcore_tpu.ops.banded import (
            NullPlan, banded_permutation_test)

        rep = NamedSharding(mesh, P())
        gs2 = NamedSharding(mesh, P(None, "genes"))
        gs1 = NamedSharding(mesh, P("genes"))
        # place the plan ONCE (replicated); Z/den/obs shard per batch
        plan = NullPlan(*(jax.device_put(f, rep) if isinstance(f, jax.Array)
                          else f for f in plan))

        def shard_batch(batch):
            # reshard ONCE per gene batch — resharding the 4 GB tile per
            # draw chunk would pay the transfer chunk-count times inside
            # the timed region
            Zb, den, obs, szv = batch
            return (jax.device_put(Zb, gs2), jax.device_put(den, gs1),
                    jax.device_put(obs, gs1), jax.device_put(szv, gs1))

        def run_chunk(Zb, den, obs, szv, seed, pc, off=0):
            with mesh:
                return banded_permutation_test(
                    plan, Zb, S0, obs, seed=seed, n_permutations=pc,
                    den=den, precision=prec, far_mode=far_mode,
                    sz=szv if prec in ("int8", "int4") else None,
                    draw_offset=off)[0]

        warmed = set()

        def build_run_chunk(widths):
            # mesh mode: warm-up executions instead of AOT (sharding-aware
            # lowering) — warm EVERY (width, pc) incl. the tail chunk so
            # nothing compiles inside the timed region
            pcs = sorted({chunk, n_perms % chunk or chunk})
            for w in sorted(set(widths)):
                if all((w, pc) in warmed for pc in pcs):
                    continue
                Zb, den, obs, szv = shard_batch(
                    prep_width(jax.random.key(99), w))
                for pc in pcs:
                    jax.block_until_ready(run_chunk(Zb, den, obs, szv,
                                                    10_000, pc))
                    warmed.add((w, pc))
                jax.block_until_ready(
                    to_counts(jnp.zeros((w,), jnp.float32),
                              jnp.zeros((w,), jnp.float32), float(chunk)))
                del Zb, den, obs, szv
            return run_chunk
    else:
        from spatialcore_tpu.ops.banded import _banded_test

        compiled = {}

        def build_run_chunk(widths):
            # AOT-compile every (width, chunk-size) executable OUTSIDE the
            # clock: .lower().compile() builds the program without
            # executing it
            pcs = sorted({chunk, n_perms % chunk or chunk})
            t0 = time.time()
            fresh = 0
            for w in sorted(set(widths)):
                if all((w, pc) in compiled for pc in pcs):
                    continue
                Zb, den, obs, szv = jax.block_until_ready(
                    prep_width(jax.random.key(99), w))
                for pc in pcs:
                    if (w, pc) in compiled:
                        continue
                    compiled[(w, pc)] = _banded_test.lower(
                        plan.order, plan.local_idx, plan.w_local,
                        plan.far_src, plan.far_dst, plan.far_w,
                        plan.rc_sum, Zb, S0, obs, jnp.uint32(0), den,
                        szv, jnp.uint32(0),
                        block=plan.block, n=plan.n, n_permutations=pc,
                        stat="moran", alternative="greater",
                        precision=prec, perm_method="feistel",
                        far_mode=far_mode).compile()
                    fresh += 1
                # warm to_counts too — its first call must not compile
                # inside the timed region
                jax.block_until_ready(
                    to_counts(jnp.zeros((w,), jnp.float32),
                              jnp.zeros((w,), jnp.float32), float(chunk)))
                del Zb, den, obs, szv
            print(f"[bench] AOT compile ({fresh} fresh executables): "
                  f"{time.time()-t0:.1f}s", file=sys.stderr)

            def run_chunk(Zb, den, obs, szv, seed, pc, off=0):
                # int4 tables are nibble-packed: table width is w/2
                w = Zb.shape[1] * (2 if prec == "int4" else 1)
                return compiled[(w, pc)](
                    plan.order, plan.local_idx, plan.w_local, plan.far_src,
                    plan.far_dst, plan.far_w, plan.rc_sum, Zb, S0, obs,
                    jnp.uint32(seed), den, szv, jnp.uint32(off))[0]

            return run_chunk

    # ---- timed region: the whole workload enqueues asynchronously -------
    def timed_run(widths, run_chunk):
        counts = []
        t_start = time.time()
        for bi, w in enumerate(widths):
            Zb, den, obs, szv = prep_width(jax.random.fold_in(kx, bi), w)
            if mesh is not None:
                Zb, den, obs, szv = shard_batch((Zb, den, obs, szv))
            acc = jnp.zeros((w,), jnp.float32)
            for ci in range(0, n_perms, chunk):
                pc = min(chunk, n_perms - ci)
                # one seed for the whole run; draws keyed by the GLOBAL
                # draw index ci — every gene batch sees the same
                # permutation for draw d, exactly like one unbatched call
                # (streaming.py semantics); chunk split changes nothing
                # bitwise
                p = run_chunk(Zb, den, obs, szv, 0, pc, ci)
                acc = to_counts(acc, p, float(pc))
            counts.append(acc)
            del Zb, den, obs, szv   # refcount drop: frees right after the
            #                    last enqueued consumer runs, before the
            #                    next batch's prep executes (in-order queue)
        for c in counts:
            jax.block_until_ready(c)
        return time.time() - t_start

    widths = tile_widths(n_genes, min(tile, n_genes))
    elapsed = timed_run(widths, build_run_chunk(widths))
    done_genes = sum(widths)

    n_cache_after = (len(os.listdir(cache_dir))
                     if cache_dir and os.path.isdir(cache_dir) else 0)
    print(f"[bench] compile cache: wrote {n_cache_after - n_cache_before} "
          f"new entries ({n_cache_after} total; >0 fresh writes = that "
          f"many cache MISSES this run)", file=sys.stderr)
    rate = done_genes * n_perms / elapsed
    target = PER_CHIP_TARGET * n_dev
    print(f"[bench] {done_genes}x{n_perms} perms end-to-end in "
          f"{elapsed:.2f}s ({rate:,.0f} genes*perms/s)", file=sys.stderr)
    metric = ("moran_sustained_genes_perms_per_sec_1M_cells"
              if mode == "sustained" else "moran_genes_perms_per_sec_1M_cells")
    out = {
        "metric": metric,
        "value": round(rate, 1),
        "unit": "genes*perms/sec",
        "vs_baseline": round(rate / target, 3),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "n_devices": n_dev,
        "precision": prec,
        "graph_build_ms_cold": round(t_graph * 1e3, 1),
        "graph_build_ms_warm": graph_warm,
        "null_plan_s_cold": round(t_plan_cold, 1),
        "null_plan_s_warm": round(t_plan_warm, 1),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
