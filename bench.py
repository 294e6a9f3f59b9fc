"""Benchmark: DP cells/s of the device engines, and reads/s end to end.

    python bench.py [batch] [iters]

Runs in one process on a GPU and fails (non-zero, no rate printed) when
JAX finds none.  Prints one JSON line per metric, ending with the
headline (mode-1 local POA) line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": "gpu", "device_kind": ..., "device_count": N,
   "card": "<nvidia-smi name, power limit>", "setup_s": N}

A fill's time is the median of ``iters`` calls, each ended by
``block_until_ready``, after one warm-up call (compilation included)
whose wall time is reported as ``setup_s``.  Any failing section fails
the run.

Baseline: **measured on this host** — the reference's kernels
reimplemented in C++ (native/baseline_scalar.cpp, at least as fast as
the Rust: dense table lookups replace its per-cell HashMap gets) and
timed on the same reads.  vs_baseline divides device Gcells/s by: the
AVX2 local kernel (local_poa.rs exec_simd) for mode 1; the reference's
own BANDED scalar loops (global_abpoa.rs exec / gap_global_abpoa.rs
exec) for modes 0/2; and the scalar local kernel for the pathwise modes
(the reference has no SIMD pathwise kernel).

Cell accounting: modes 0/2 count the BANDED cells the reference's loop
fills (sum(right-left) over rows, reported by the C++ baseline) on BOTH
sides of the ratio, so vs_baseline is the wall-clock ratio for the same
alignment task.  The full-width modes count full cells.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp
import numpy as np


def measure_cpu_baseline(g, sm, seqs):
    """(avx2_gcells, scalar_gcells) of the C++ reference kernels."""
    from recgraph_tpu import native

    cells = sum(len(s) for s in seqs) * (g.n - 2)
    out = []
    for simd in (True, False):
        reps = 8
        secs, _ = native.baseline_local_cpu(g, sm, seqs, repeats=reps,
                                            simd=simd)
        out.append(cells * reps / secs / 1e9)
    return out[0], out[1]


def timed(fn, iters):
    """(median seconds per call, seconds of the warm-up call)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    setup = time.perf_counter() - t0
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), setup


class Out:
    """JSON lines, each carrying the device it was measured on."""

    def __init__(self):
        from recgraph_tpu.ops.device import card

        devs = jax.devices()
        self.dev = {
            "device": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "card": "; ".join(card().splitlines()),
        }

    def line(self, metric, value, denom, unit="Gcells/s", extra="",
             **fields):
        rec = {"metric": metric, "value": round(value, 3), "unit": unit,
               "vs_baseline": round(value / denom, 3), **self.dev, **fields}
        print(json.dumps(rec), flush=True)
        if extra:
            print(f"# {extra}", file=sys.stderr)


def _longread_corpus(d, n_back=1200, n_reads=64, seed=11):
    """Multi-kb corpus: full-span haplotype reads (~2.4 kb, 2%
    substitutions) on a ~3.8k-row synthetic pangenome."""
    import chip_smoke
    from recgraph_tpu.io import fasta

    reads_fa, gfa_path = chip_smoke.longread_corpus(d, n_back, n_reads, seed)
    return gfa_path, fasta.get_sequences(reads_fa)[0]


def longread_bench(out, d, iters, base_scalar):
    """Long-read fills (modes 0/2/4, and the opt-in windowed mode-8
    pair) at the widths production settles on.

    Modes 0/2: banded-cell accounting vs the reference's banded CPU
    loops on the same reads.  Modes 4/8: the reference is full-width
    (pathwise_alignment.rs:16), so the lines report full-equivalent
    device throughput against the scalar CPU baseline — the windowed
    fill computes O(W) of each row but solves the same task exactly
    (guard-checked).
    """
    from recgraph_tpu import native
    from recgraph_tpu.graph.pathgraph import PathGraph
    from recgraph_tpu.graph.poagraph import PoaGraph
    from recgraph_tpu.io import gfa
    from recgraph_tpu.ops import (
        pathwise_engine, poa_engine, poa_gap_engine,
        recombination_engine as rec, recombination_window as rw,
    )
    from recgraph_tpu.ops.encode import (
        encode_reads, path_device_graph, poa_device_graph,
    )
    from recgraph_tpu.ops.pathwise_window import (
        _fill_pathwise_win, _final_column_win, _rmin,
    )
    from recgraph_tpu.scoring import ScoreMatrix

    gfa_path, reads = _longread_corpus(d)
    B = len(reads)
    parsed = gfa.parse_gfa(gfa_path)
    g = PoaGraph.from_gfa(parsed)
    dg = poa_device_graph(g)
    sm = ScoreMatrix.create("none", 2, -4)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    seq, L = encode_reads(reads)
    Lp = seq.shape[1]
    cells_full = B * (dg.n - 1) * Lp
    btas_h = [int(1 + 0.01 * len(s)) for s in reads]
    bta = jnp.asarray(btas_h, jnp.int32)
    band0 = native.baseline_banded_cpu(g, sm, reads, btas_h, repeats=1)
    band2 = native.baseline_banded_cpu(
        g, sm, reads, btas_h, repeats=1, gap=(-4, -2)
    )

    # ---- modes 0/2: settle the W ladder, time the settled fill
    poa_engine.fill_global_long(dg, table, seq, L, bta, max(btas_h))
    W0 = poa_engine._long_w_hint[dg.n]
    if W0 < Lp:
        f0 = lambda: poa_engine._fill_global_windowed(
            dg, table, seq, L, bta, W=W0)
    else:
        f0 = lambda: poa_engine._fill_global(dg, table, seq, L, bta)
    dt, setup = timed(f0, iters)
    out.line(
        "global_poa_longread_throughput", band0[1] / dt / 1e9,
        band0[1] / band0[0] / 1e9, setup_s=round(setup, 3),
        extra=f"mode0 longread B={B} W={W0} per-fill={dt*1e3:.2f}ms "
        f"banded-cell basis (band={band0[1]/cells_full:.1%} of full); "
        f"CPU banded fill {band0[0]*1e3:.0f}ms",
    )
    o, e = jnp.int32(-4), jnp.int32(-2)
    poa_gap_engine.fill_gap_global_long(
        dg, table, seq, L, bta, max(btas_h), -4, -2
    )
    W2 = poa_gap_engine._long_w_hint_gap[dg.n]
    if W2 < Lp:
        f2 = lambda: poa_gap_engine._fill_gap_global_windowed(
            dg, table, seq, L, bta, o, e, W=W2)
    else:
        f2 = lambda: poa_gap_engine._fill_gap_global(
            dg, table, seq, L, bta, o, e)
    dt, setup = timed(f2, iters)
    out.line(
        "gap_global_longread_throughput", band2[1] / dt / 1e9,
        band2[1] / band2[0] / 1e9, setup_s=round(setup, 3),
        extra=f"mode2 longread B={B} W={W2} per-fill={dt*1e3:.2f}ms "
        f"banded-cell basis; CPU banded fill {band2[0]*1e3:.0f}ms",
    )

    # ---- mode 4: ladder W exactly as production does
    # (pathwise_engine._run_batch_walks_win) and time the accepted W;
    # the effective rate charges the rejected rungs' fills too
    pg = PathGraph.from_gfa(parsed, is_reversed=False)
    pdg = path_device_graph(pg)
    P = pdg.paths_number
    rmin = jnp.asarray(_rmin(pdg))
    budget = 1 << 29          # pathwise_engine default chunk_bytes
    Lp4 = pathwise_engine._align_lp(reads[:16])

    def rung_B(W):
        return max(1, min(16, len(reads), budget // (P * pdg.n * W * 4)))

    def guard_pass(W, Bsub):
        seqW, LW = encode_reads(reads[:Bsub], pad_to=Lp4)
        Aw, ws, bound = _fill_pathwise_win(pdg, table, seqW, LW, W, rmin)
        fc = np.asarray(jax.device_get(_final_column_win(Aw, ws, LW)))
        bh = np.asarray(jax.device_get(bound))
        npass = 0
        for b in range(Bsub):
            bp, node = pathwise_engine._endings_global(fc[b], pg)
            npass += int(fc[b, bp, node]) > int(bh[b])
        return npass

    W4, rejected = 256, []
    while True:
        B4 = rung_B(W4)
        npass = guard_pass(W4, B4)
        if npass == B4 or W4 * 2 >= Lp4:
            break
        rejected.append((W4, B4))
        W4 *= 2

    def fill4(W, Bsub):
        seqW, LW = encode_reads(reads[:Bsub], pad_to=Lp4)
        return lambda: _fill_pathwise_win(pdg, table, seqW, LW, W, rmin)

    dt, setup = timed(fill4(W4, B4), iters)
    t_ladder = sum(timed(fill4(Wr, Br), 2)[0] for Wr, Br in rejected)
    cells4 = B4 * pdg.n * Lp4 * P
    out.line(
        "pathwise_longread_throughput", cells4 / (dt + t_ladder) / 1e9,
        base_scalar, setup_s=round(setup, 3),
        extra=f"mode4 longread B={B4} P={P} W={W4} per-fill="
        f"{dt*1e3:.2f}ms guard-pass {npass}/{B4}; rejected rungs "
        f"{rejected} (+{t_ladder*1e3:.2f}ms); full-equivalent cells",
    )

    # ---- mode 8: the opt-in windowed fill pair
    rdg8 = rec.rev_device_graph(pg.reverse())
    B8w = max(1, min(8, (1 << 29) // (2 * P * pdg.n * W4 * 4)))
    seq8w, L8w = encode_reads(reads[:B8w], pad_to=Lp4)
    dt8w, setup = timed(lambda: (
        _fill_pathwise_win(pdg, table, seq8w, L8w, W4, rmin),
        rw._fill_pathwise_rev_win(rdg8, table, seq8w, L8w, W4),
    ), iters)
    cells8w = 2 * B8w * pdg.n * Lp4 * P
    out.line(
        "rec_longread_throughput", cells8w / dt8w / 1e9, base_scalar,
        setup_s=round(setup, 3),
        extra=f"mode8 windowed pair B={B8w} W={W4} per-pair="
        f"{dt8w*1e3:.2f}ms (opt-in engine; full-equivalent cells)",
    )


def _timed_pipeline(reads_fa, graph_gfa, mode, out_file, **kw):
    """Wall seconds and phases of one production run; a run whose
    compilation is over a fifth of its wall is repeated warm (the
    persistent compile cache makes every later run warm)."""
    from recgraph_tpu import metrics
    from recgraph_tpu.align.pipeline import Options, run

    def once():
        metrics.reset_phases()
        metrics._compile_secs[0] = metrics._cache_load_secs[0] = 0.0
        t0 = time.time()
        run(Options(sequence_path=reads_fa, graph_path=graph_gfa,
                    alignment_mode=mode, out_file=out_file, **kw))
        return time.time() - t0, metrics.phases_dict()

    dt, phases = once()
    cold = None
    if phases.get("compile", 0) > 0.2 * dt:
        cold = round(dt, 3)
        dt, phases = once()
    return dt, phases, cold


def stretch_bench(out, d):
    """The 1k+ node / 10k-read synthetic corpus END TO END through the
    production pipeline (parse, encode, fill, on-device walks, GAF
    emission to a file), reads/s wall-clock.  Correctness anchors to
    the oracle-generated golden sample (tests/goldens/
    stretch_mode4_sample.gaf).  vs_baseline divides by the measured
    scalar-CPU baseline converted to reads/s on this corpus' full-matrix
    cell count (the reference has no published numbers)."""
    import chip_smoke
    from recgraph_tpu import native
    from recgraph_tpu.graph.pathgraph import PathGraph
    from recgraph_tpu.graph.poagraph import PoaGraph
    from recgraph_tpu.io import fasta, gfa
    from recgraph_tpu.scoring import ScoreMatrix

    reads_fa, graph_gfa = chip_smoke.stretch_corpus(os.path.join(d, "s"))
    golden = os.path.join(ROOT, "tests", "goldens",
                          "stretch_mode4_sample.gaf")
    seqs, _ = fasta.get_sequences(reads_fa)
    n_reads = len(seqs)
    parsed = gfa.parse_gfa(graph_gfa)
    g = PathGraph.from_gfa(parsed, is_reversed=False)
    gl = PoaGraph.from_gfa(parsed)
    sm = ScoreMatrix.create("none", 2, -4)
    secs, _ = native.baseline_local_cpu(gl, sm, seqs[:24], repeats=1,
                                        simd=False)
    base_reads_s = 24 / (secs * g.paths_number)  # P-fold pathwise work
    gaf = os.path.join(d, "stretch.gaf")
    for mode in (1, 4):
        dt, phases, cold = _timed_pipeline(reads_fa, graph_gfa, mode, gaf)
        got = open(gaf).read().splitlines()
        # modes 4-9 write 0-based read numbers, so the reference's
        # truncate-at-number==1 quirk drops read 0's line from -o files
        if len(got) != (n_reads - 1 if mode == 4 else n_reads):
            raise RuntimeError(f"stretch mode {mode}: {len(got)} lines")
        if mode == 4:
            want = open(golden).read().splitlines()[1:]
            if got[: len(want)] != want:
                raise RuntimeError("stretch mode 4: golden sample differs")
        denom = base_reads_s if mode == 4 else base_reads_s * g.paths_number
        out.line(
            f"stretch_mode{mode}_reads_per_s", n_reads / dt, denom,
            unit="reads/s", phases=phases, cold_s=cold,
            extra=f"stretch e2e mode{mode}: {n_reads} reads, n={g.n} "
            f"P={g.paths_number}, {dt:.2f}s wall, golden-sample checked",
        )


def main(batch: int = 512, iters: int = 3) -> None:
    from recgraph_tpu import enable_compile_cache
    from recgraph_tpu.graph.pathgraph import PathGraph
    from recgraph_tpu.graph.poagraph import PoaGraph
    from recgraph_tpu.io import fasta, gfa
    from recgraph_tpu.ops import (
        pathwise_engine, pathwise_gap_engine, poa_engine, poa_gap_engine,
        recombination_engine,
    )
    from recgraph_tpu.ops.encode import encode_reads, poa_device_graph
    from recgraph_tpu.scoring import ScoreMatrix
    from recgraph_tpu import native

    enable_compile_cache()
    out = Out()
    seqs, _ = fasta.get_sequences(os.path.join(ROOT, "example", "reads.fa"))
    graph_gfa = os.path.join(ROOT, "example", "graph.gfa")
    parsed = gfa.parse_gfa(graph_gfa)
    g = PoaGraph.from_gfa(parsed)
    dg = poa_device_graph(g)
    sm = ScoreMatrix.create("none", 2, -4)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    base_avx2, base_scalar = measure_cpu_baseline(g, sm, seqs)
    print(f"# measured CPU baseline: avx2={base_avx2:.3f} "
          f"scalar={base_scalar:.3f} Gcells/s", file=sys.stderr)

    reads = (seqs * ((batch // len(seqs)) + 1))[:batch]
    seq, L = encode_reads(reads)
    Lp = seq.shape[1]
    cells = batch * (dg.n - 1) * Lp
    btas_h = [int(1 + 0.01 * len(s)) for s in reads]
    bta = jnp.asarray(btas_h, jnp.int32)
    # banded baselines on the SAME batch (banded-cell accounting)
    band0 = native.baseline_banded_cpu(g, sm, reads, btas_h, repeats=1)
    band2 = native.baseline_banded_cpu(
        g, sm, reads, btas_h, repeats=1, gap=(-4, -2)
    )

    # ---- mode 1 (headline, printed last): local POA fill
    dt1, setup1 = timed(
        lambda: poa_engine.fill_local_best(dg, table, seq, L), iters)
    headline = dict(
        metric="local_poa_dp_throughput", value=cells / dt1 / 1e9,
        denom=base_avx2, setup_s=round(setup1, 3),
        extra=f"mode1 batch={batch} n={dg.n} Lp={Lp} "
        f"per-fill={dt1*1e3:.3f}ms reads/s={batch/dt1:.0f}",
    )

    # ---- mode 0: banded global POA fill
    dt0, setup = timed(
        lambda: poa_engine._fill_global(dg, table, seq, L, bta), iters)
    out.line(
        "global_poa_dp_throughput", band0[1] / dt0 / 1e9,
        band0[1] / band0[0] / 1e9, setup_s=round(setup, 3),
        extra=f"mode0 batch={batch} per-fill={dt0*1e3:.2f}ms "
        f"reads/s={batch/dt0:.0f} banded-cell basis (full-equiv "
        f"{cells/dt0/1e9:.2f} Gcells/s)",
    )

    # ---- mode 1 + HOXD70 (asymmetric matrix)
    tableh = jnp.asarray(ScoreMatrix.create("HOXD70.mtx", 2, -4).table,
                         dtype=jnp.int32)
    dth, setup = timed(
        lambda: poa_engine.fill_local_best(dg, tableh, seq, L), iters)
    out.line("local_poa_hoxd70_throughput", cells / dth / 1e9, base_avx2,
             setup_s=round(setup, 3),
             extra=f"mode1+HOXD70 batch={batch} per-fill={dth*1e3:.3f}ms")

    # ---- mode 2: affine-gap global POA fill
    dt2, setup = timed(lambda: poa_gap_engine.fill_gap_global(
        dg, table, seq, L, bta, -4, -2), iters)
    out.line(
        "gap_global_dp_throughput", band2[1] / dt2 / 1e9,
        band2[1] / band2[0] / 1e9, setup_s=round(setup, 3),
        extra=f"mode2 batch={batch} per-fill={dt2*1e3:.2f}ms "
        f"reads/s={batch/dt2:.0f} banded-cell basis",
    )

    # ---- mode 4: pathwise fill
    pg = PathGraph.from_gfa(parsed)
    pdg = pathwise_engine.path_device_graph(pg)
    P = pdg.paths_number
    B4 = 32
    seq4, _ = encode_reads(reads[:B4])
    cells4 = B4 * pdg.n * seq4.shape[1] * P
    dt4, setup = timed(lambda: pathwise_engine.fill_pathwise_best(
        pdg, table, seq4, False, True), iters)
    out.line("pathwise_dp_throughput", cells4 / dt4 / 1e9, base_scalar,
             setup_s=round(setup, 3),
             extra=f"mode4 batch={B4} P={P} per-fill={dt4*1e3:.2f}ms "
             f"reads/s={B4/dt4:.0f}")

    # ---- mode 6: pathwise affine (delta-form device fill)
    meta6 = pathwise_gap_engine.gap_meta(pg)
    B6 = 64
    seq6, _ = encode_reads(reads[:B6])
    cells6 = 3 * B6 * pdg.n * seq6.shape[1] * P  # three planes
    dt6, setup = timed(lambda: pathwise_gap_engine.fill_gap_device(
        pg, sm, seq6, -4, -2, False, meta6), iters)
    out.line("pathwise_gap_dp_throughput", cells6 / dt6 / 1e9, base_scalar,
             setup_s=round(setup, 3),
             extra=f"mode6 batch={B6} P={P} per-fill={dt6*1e3:.2f}ms "
             f"reads/s={B6/dt6:.0f}")

    # ---- mode 8: the forward + reverse fill pair at the production
    # chunk size (run_batch_walks holds 2 planes under a 512 MB budget)
    rdg = recombination_engine.rev_device_graph(pg.reverse())
    Lp8 = pathwise_engine._align_lp(reads[:128])
    B8 = int(max(8, min(128, (1 << 29) // (P * pdg.n * Lp8 * 4 * 2))))
    seq8, L8 = encode_reads(reads[:B8], pad_to=Lp8)
    cells8 = 2 * B8 * pdg.n * seq8.shape[1] * P
    dt8, setup = timed(lambda: (
        pathwise_engine.fill_pathwise_best(pdg, table, seq8, False, True),
        pathwise_engine.fill_pathwise_rev_best(rdg, table, seq8, L8, True,
                                               True),
    ), iters)
    out.line("recombination_fills_throughput", cells8 / dt8 / 1e9,
             base_scalar, setup_s=round(setup, 3),
             extra=f"mode8 batch={B8} per-fill-pair={dt8*1e3:.2f}ms "
             f"reads/s={B8/dt8:.0f}")

    d = tempfile.mkdtemp(prefix="recgraph_bench_")
    try:
        # ---- mode 8 END TO END on the -R 10 -r 2 -B 0.5 config:
        # golden-checked on the example corpus, timed on it x10
        import chip_smoke

        kw = chip_smoke.REC_KW
        out8 = os.path.join(d, "rec.gaf")
        _timed_pipeline(os.path.join(ROOT, "example", "reads.fa"),
                        graph_gfa, 8, out8, **kw)
        want8 = open(os.path.join(ROOT, "tests", "goldens",
                                  "mode8_R10_r2_B05.gaf")).read()
        # -o files drop read 0's line (0-based numbers, see above)
        if open(out8).read().splitlines() != want8.splitlines()[1:]:
            raise RuntimeError("mode 8 e2e: golden differs")
        big, _ = chip_smoke.rec_corpus(d)
        n8 = sum(1 for ln in open(big) if ln.startswith(">"))
        dte, phases8, _ = _timed_pipeline(big, graph_gfa, 8, out8, **kw)
        secs_b, _ = native.baseline_local_cpu(g, sm, seqs[:24], repeats=1,
                                              simd=False)
        base8 = 24 / (secs_b * P * 2)
        out.line("rec_e2e_reads_per_s", n8 / dte, base8, unit="reads/s",
                 phases=phases8,
                 extra=f"mode8 e2e: {n8} reads {dte:.2f}s wall "
                 f"(-R 10 -r 2 -B 0.5), golden-checked")

        stretch_bench(out, d)
        longread_bench(out, d, iters, base_scalar)
    finally:
        shutil.rmtree(d, ignore_errors=True)

    extra = headline.pop("extra")
    out.line(headline.pop("metric"), headline.pop("value"),
             headline.pop("denom"), extra=extra, **headline)


if __name__ == "__main__":
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"bench: JAX found no GPU (platform {platform!r}); "
              "this benchmark measures the card only", file=sys.stderr)
        sys.exit(2)
    main(
        batch=int(sys.argv[1]) if len(sys.argv) > 1 else 512,
        iters=int(sys.argv[2]) if len(sys.argv) > 2 else 3,
    )
