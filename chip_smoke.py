#!/usr/bin/env python3
"""Smoke test of recgraph-tpu on one NVIDIA GPU.

    python chip_smoke.py                # every phase, one card
    python chip_smoke.py --four-cards   # the sharded reads path, 4 cards
    python chip_smoke.py --only kernel  # one phase (for iterating)

Phases (any failure ends the run with a non-zero exit code):

1. device   - JAX must report a GPU; prints its kind, the device count,
              and the card's name and power limit from nvidia-smi.
2. goldens  - every mode on example/ through the pipeline, byte-compared
              with tests/goldens/, and the stretch sample.
3. scale    - the stretch corpus (10k reads, n=2249 rows) through modes
              0, 1 and 4, and the mode-8 corpus (example reads x10,
              -R 10 -r 2 -B 0.5); a seeded sample of 64 reads of each
              run is byte-compared with the oracle's GAF.  Mode 1 also
              runs on the XLA engine, byte-equal to the CUDA kernel.
              Reads/s are printed as information.
4. long     - 64 reads of ~2.4 kb on a 3.8k-row graph through modes 0,
              2 and 4: windowed output must equal the exact full-width
              output byte for byte.  Prints peak device memory.
5. kernel   - the CUDA mode-1 fill at B=512 on the example graph
              (Lp=256) and on a stretch chunk, equal to the XLA engine
              on all four outputs; prints memory_analysis() and both
              fill times.
6. tests    - the tests marked ``gpu`` (pytest -m gpu), in-process.

A phase also fails when any metrics.FALLBACKS counter moved: the card
must run the device path.  The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import random
import shutil
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "goldens", "scale", "long", "kernel", "tests")
SAMPLE = 64
SAMPLE_SEED = 7
REC_KW = dict(base_rec_cost=10, multi_rec_cost=2.0, rec_band_width=0.5)

# the configs of tests/test_goldens.py
GOLDENS = {
    "mode0.gaf": dict(alignment_mode=0),
    "mode1.gaf": dict(alignment_mode=1),
    "mode1_hoxd70.gaf": dict(alignment_mode=1, matrix="HOXD70"),
    "mode2.gaf": dict(alignment_mode=2),
    "mode3.gaf": dict(alignment_mode=3),
    "mode4.gaf": dict(alignment_mode=4),
    "mode5.gaf": dict(alignment_mode=5),
    "mode6_full.txt": dict(alignment_mode=6),
    "mode7_full.txt": dict(alignment_mode=7),
    "mode8.gaf": dict(alignment_mode=8),
    "mode9.gaf": dict(alignment_mode=9),
    "mode8_R10_r2_B05.gaf": dict(alignment_mode=8, **REC_KW),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# pure helpers (tested on the CPU)
# ---------------------------------------------------------------------------


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}}
    )


def fallbacks_moved(before: dict, after: dict) -> dict:
    """Counters of metrics.FALLBACKS that grew between two snapshots."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v > before.get(k, 0)}


# ---------------------------------------------------------------------------
# corpora
# ---------------------------------------------------------------------------


def write_fasta(path, seqs, names):
    with open(path, "w") as fh:
        for s, nm in zip(seqs, names):
            fh.write(f">{nm}\n{s[1:] if s.startswith('$') else s}\n")


def stretch_corpus(d, n_reads=10000):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_synthetic import make

    make(d, n_back=700, n_reads=n_reads, seed=42)
    return os.path.join(d, "reads.fa"), os.path.join(d, "graph.gfa")


def rec_corpus(d, reps=10):
    """bench.py's mode-8 e2e corpus: the example reads, ``reps`` times."""
    src = open(os.path.join(ROOT, "example", "reads.fa")).read()
    path = os.path.join(d, "rec_reads.fa")
    with open(path, "w") as fh:
        for rep in range(reps):
            fh.write(src.replace(">", f">r{rep}_"))
    return path, os.path.join(ROOT, "example", "graph.gfa")


def longread_corpus(d, n_back=1200, n_reads=64, seed=11):
    """bench.py's long-read corpus: full-span haplotype reads (~2.4 kb,
    2% substitutions) on a ~3.8k-row graph."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_synthetic import make

    make(d, n_back=n_back, n_reads=1, seed=seed)
    gfa_path = os.path.join(d, "graph.gfa")
    rng = random.Random(seed)
    walks, segs = {}, {}
    for ln in open(gfa_path):
        f = ln.rstrip("\n").split("\t")
        if f[0] == "P":
            walks[f[1]] = [int(x[:-1]) for x in f[2].split(",")]
        elif f[0] == "S":
            segs[int(f[1])] = f[2]
    keys = sorted(walks)
    path = os.path.join(d, "long.fa")
    with open(path, "w") as fh:
        for k in range(n_reads):
            s = "".join(segs[x] for x in walks[rng.choice(keys)])
            rd = "".join(
                (rng.choice("ACGT") if rng.random() < 0.02 else c) for c in s
            )
            fh.write(f">lr{k}\n{rd}\n")
    return path, gfa_path


# ---------------------------------------------------------------------------
# running the pipeline
# ---------------------------------------------------------------------------


def run_pipeline(reads, graph, **kw) -> str:
    """One in-process pipeline run (the Options the CLI builds); returns
    its GAF text.  Fails on a fallback counter or an oracle fallback."""
    from recgraph_tpu import metrics
    from recgraph_tpu.align.pipeline import Options, run

    before = dict(metrics.FALLBACKS)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        run(Options(sequence_path=reads, graph_path=graph, **kw))
    moved = fallbacks_moved(before, dict(metrics.FALLBACKS))
    check(not moved, f"fallback counters moved {moved}: {err.getvalue()[-2000:]}")
    check("device path unavailable" not in err.getvalue(), err.getvalue())
    return out.getvalue()


def _oracle_job(reads, graph, kw):
    """Pool worker: the scalar oracle's GAF for one small read file."""
    from recgraph_tpu.align.pipeline import Options, run

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        run(Options(sequence_path=reads, graph_path=graph, engine="oracle",
                    **kw))
    return out.getvalue()


class OracleSamples:
    """Oracle GAF for seeded read samples, computed by CPU worker
    processes (JAX_PLATFORMS=cpu: they never open the card) while the
    card runs the other phases."""

    def __init__(self, workers):
        import multiprocessing as mp

        old = os.environ.get("JAX_PLATFORMS")
        os.environ["JAX_PLATFORMS"] = "cpu"
        try:
            self.pool = mp.get_context("spawn").Pool(workers)
        finally:
            if old is None:
                del os.environ["JAX_PLATFORMS"]
            else:
                os.environ["JAX_PLATFORMS"] = old
        self.jobs = {}

    def submit(self, key, d, reads, graph, kw, chunk=4):
        from recgraph_tpu.io import fasta

        seqs, names = fasta.get_sequences(reads)
        idx = sorted(random.Random(SAMPLE_SEED).sample(
            range(len(seqs)), min(SAMPLE, len(seqs))))
        parts = []
        for c in range(0, len(idx), chunk):
            sub = idx[c:c + chunk]
            path = os.path.join(d, f"oracle_{key}_{c}.fa")
            write_fasta(path, [seqs[i] for i in sub], [names[i] for i in sub])
            parts.append(self.pool.apply_async(_oracle_job, (path, graph, kw)))
        self.jobs[key] = (idx, parts)

    def compare(self, key, gaf_text, per_read=1):
        idx, parts = self.jobs.pop(key)
        want = "".join(p.get(timeout=1200) for p in parts).splitlines()
        got = gaf_text.splitlines()
        mine = [got[i * per_read + k] for i in idx for k in range(per_read)]
        check(len(want) == len(mine), f"{key}: oracle gave {len(want)} lines")
        bad = [i for i, (a, b) in enumerate(zip(mine, want)) if a != b]
        check(not bad, f"{key}: {len(bad)} sampled reads differ from the "
                       f"oracle, first {mine[bad[0]] if bad else ''!r} vs "
                       f"{want[bad[0]] if bad else ''!r}")

    def close(self):
        self.pool.terminate()
        self.pool.join()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(ctx):
    import jax

    from recgraph_tpu.ops.device import card

    devs = jax.devices()
    text = card()
    ctx["smi"] = "; ".join(text.splitlines())
    print(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)}")
    print(text)


def phase_goldens(ctx):
    ex = os.path.join(ROOT, "example")
    reads, graph = os.path.join(ex, "reads.fa"), os.path.join(ex, "graph.gfa")
    for name, kw in GOLDENS.items():
        t0 = time.time()
        got = run_pipeline(reads, graph, **kw)
        want = open(os.path.join(ROOT, "tests", "goldens", name)).read()
        check(got == want, f"golden {name} differs")
        print(f"golden {name}: byte-equal ({time.time() - t0:.1f}s)")
    d = ctx["tmp"]
    s_reads, s_graph = stretch_corpus(os.path.join(d, "stretch12"), 12)
    got = run_pipeline(s_reads, s_graph, alignment_mode=4)
    want = open(os.path.join(
        ROOT, "tests", "goldens", "stretch_mode4_sample.gaf")).read()
    check(got == want, "stretch mode-4 sample differs from its golden")
    print("golden stretch_mode4_sample.gaf: byte-equal")


def _timed_run(label, ctx, reads, graph, n_reads, **kw):
    from recgraph_tpu import metrics

    metrics.ensure_compile_listener()
    c0 = metrics.compile_seconds()
    t0 = time.time()
    gaf = run_pipeline(reads, graph, **kw)
    dt = time.time() - t0
    comp = metrics.compile_seconds() - c0
    print(f"{label}: {n_reads} reads in {dt:.3f}s = {n_reads / dt:.1f} "
          f"reads/s (compile {comp:.1f}s of it) on {ctx['smi']}")
    return gaf


def phase_scale(ctx):
    from recgraph_tpu.ops import cuda_fill

    s_reads, s_graph = ctx["stretch"]
    oracle = ctx["oracle"]
    n = 10000
    for mode in (0, 1, 4):
        gaf = _timed_run(f"stretch mode {mode}", ctx, s_reads, s_graph, n,
                         alignment_mode=mode)
        check(len(gaf.splitlines()) == n, f"mode {mode}: line count")
        oracle.compare(f"stretch{mode}", gaf)
        print(f"stretch mode {mode}: {SAMPLE} sampled reads equal the oracle")
        if mode == 1:
            # the XLA engine (cold, then checked equal), then both
            # engines warm in the order XLA, CUDA, CUDA, XLA
            use = cuda_fill.use_kernel
            try:
                for impl in ("xla", "xla", "cuda", "cuda", "xla"):
                    cuda_fill.use_kernel = use if impl == "cuda" else (
                        lambda Lp: False)
                    other = _timed_run(f"stretch mode 1 ({impl} fill)", ctx,
                                       s_reads, s_graph, n, alignment_mode=1)
                    check(other == gaf, f"mode 1: {impl} output differs")
            finally:
                cuda_fill.use_kernel = use
            print("stretch mode 1: CUDA kernel output == XLA engine output")
    r_reads, r_graph = ctx["rec"]
    gaf = _timed_run("mode 8 e2e corpus", ctx, r_reads, r_graph, 520,
                     alignment_mode=8, **REC_KW)
    check(len(gaf.splitlines()) == 520, "mode 8: line count")
    oracle.compare("rec8", gaf)
    print(f"mode 8: {SAMPLE} sampled reads equal the oracle")


def phase_long(ctx):
    import jax

    from recgraph_tpu import metrics
    from recgraph_tpu.ops import pathwise_engine, poa_engine, poa_gap_engine

    reads, graph = ctx["long"]
    dev = jax.devices()[0]
    for mode in (0, 2, 4):
        mod = pathwise_engine if mode == 4 else poa_engine
        gate = mod.LONG_READ_LP
        poa_engine._long_w_hint.clear()
        poa_gap_engine._long_w_hint_gap.clear()
        pathwise_engine._pw_w_hint.clear()
        win = _timed_run(f"long reads mode {mode} (windowed)", ctx, reads,
                         graph, 64, alignment_mode=mode)
        hints = (poa_engine._long_w_hint, poa_gap_engine._long_w_hint_gap,
                 pathwise_engine._pw_w_hint)
        w = {k: v for h in hints for k, v in h.items()}
        mod.LONG_READ_LP = 1 << 30
        try:
            full = _timed_run(f"long reads mode {mode} (full width)", ctx,
                              reads, graph, 64, alignment_mode=mode)
        finally:
            mod.LONG_READ_LP = gate
        check(win == full, f"long reads mode {mode}: windowed != full width")
        peak = dev.memory_stats().get("peak_bytes_in_use", 0)
        print(f"long reads mode {mode}: windowed == full width (settled W "
              f"{w}); peak_bytes_in_use {peak}")
    check(not metrics.FALLBACKS.get("pathwise_win_fullwidth"),
          "windowed mode-4 guard fell back to full width")


def _kernel_case(label, g, sm, seqs, Lp, ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from recgraph_tpu.ops import cuda_fill, poa_engine
    from recgraph_tpu.ops.encode import encode_reads, poa_device_graph

    dg = poa_device_graph(g)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    seq, L = encode_reads(seqs, pad_to=Lp)
    pl = cuda_fill.plan(seq.shape[1], dg.compact_span)
    cuda_fill._register()
    compiled = cuda_fill._fill.lower(
        dg, table, seq, L, pl=pl, mesh=None, callee=cuda_fill.kernel_call
    ).compile()
    print(f"kernel {label}: B={seq.shape[0]} n={dg.n} Lp={seq.shape[1]} "
          f"plan={pl} smem={pl.smem_bytes()}B")
    print(f"kernel {label}: memory_analysis {compiled.memory_analysis()}")
    got = jax.block_until_ready(cuda_fill.fill_local(dg, table, seq, L))
    ref = jax.block_until_ready(poa_engine._fill_local(dg, table, seq, L))
    for name, a, b in zip(("score", "best_i", "best_j", "packed"), got, ref):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"kernel {label}: {name} differs from _fill_local")

    def best_of(fn, reps=5):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return min(ts)

    tk = best_of(lambda: cuda_fill.fill_local(dg, table, seq, L))
    tx = best_of(lambda: poa_engine._fill_local(dg, table, seq, L))
    print(f"kernel {label}: equal to _fill_local on all four outputs; fill "
          f"{tk * 1e3:.3f} ms (CUDA) vs {tx * 1e3:.3f} ms (XLA scan), "
          f"best of 5, on {ctx['smi']}")


def phase_kernel(ctx):
    from recgraph_tpu.graph.poagraph import PoaGraph
    from recgraph_tpu.io import fasta, gfa
    from recgraph_tpu.scoring import ScoreMatrix

    sm = ScoreMatrix.create("none", 2, -4)
    ex = os.path.join(ROOT, "example")
    seqs, _ = fasta.get_sequences(os.path.join(ex, "reads.fa"))
    g = PoaGraph.from_gfa(gfa.parse_gfa(os.path.join(ex, "graph.gfa")))
    _kernel_case("example", g, sm, (seqs * 10)[:512], 256, ctx)
    s_reads, s_graph = ctx["stretch"]
    seqs, _ = fasta.get_sequences(s_reads)
    g = PoaGraph.from_gfa(gfa.parse_gfa(s_graph))
    _kernel_case("stretch chunk", g, sm, seqs[:512], None, ctx)


def phase_tests(ctx):
    import pytest

    os.environ["RECGRAPH_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main([os.path.join(ROOT, "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider", "-p", "no:randomly"])
    check(rc == 0, f"pytest -m gpu exited {rc}")


def phase_four_cards(ctx):
    import jax

    sys.path.insert(0, ROOT)
    import __graft_entry__

    check(len(jax.devices()) >= 4, f"need 4 cards, have {len(jax.devices())}")
    __graft_entry__.dryrun_multichip(4)
    s_reads, s_graph = ctx["stretch"]
    outs = {}
    for cards in (1, 4):
        os.environ["RECGRAPH_DP_DEVICES"] = str(cards)
        try:
            outs[cards] = _timed_run(f"stretch mode 1 on {cards} card(s)",
                                     ctx, s_reads, s_graph, 10000,
                                     alignment_mode=1)
        finally:
            del os.environ["RECGRAPH_DP_DEVICES"]
    check(outs[1] == outs[4], "stretch mode 1: 4-card output != 1-card output")
    print("stretch mode 1: 4-card output == 1-card output")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded reads path on 4 cards")
    ap.add_argument("--only", choices=PHASES[1:], action="append",
                    help="run the device phase and these phases only")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import recgraph_tpu  # noqa: F401  (fails outside a checkout)
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {platform!r})",
              file=sys.stderr)
        return 2

    phases = ["device"]
    if args.four_cards:
        phases.append("four_cards")
    else:
        phases += list(args.only or PHASES[1:])
    fns = {"device": phase_device, "goldens": phase_goldens,
           "scale": phase_scale, "long": phase_long, "kernel": phase_kernel,
           "tests": phase_tests, "four_cards": phase_four_cards}

    from recgraph_tpu import enable_compile_cache

    enable_compile_cache()
    ctx = {"tmp": tempfile.mkdtemp(prefix="chip_smoke_")}
    d = ctx["tmp"]
    if {"scale", "kernel", "four_cards"} & set(phases):
        ctx["stretch"] = stretch_corpus(os.path.join(d, "stretch"))
    if "scale" in phases:
        ctx["rec"] = rec_corpus(d)
        ctx["oracle"] = OracleSamples(max(1, min(12, (os.cpu_count() or 2) - 2)))
        for mode in (0, 1, 4):
            ctx["oracle"].submit(f"stretch{mode}", d, *ctx["stretch"],
                                 dict(alignment_mode=mode))
        ctx["oracle"].submit("rec8", d, *ctx["rec"],
                             dict(alignment_mode=8, **REC_KW))
    if "long" in phases:
        ctx["long"] = longread_corpus(os.path.join(d, "long"))
    try:
        for name in phases:
            t0 = time.time()
            print(f"== phase {name}", flush=True)
            fns[name](ctx)
            print(f"== phase {name} ok ({time.time() - t0:.1f}s)", flush=True)
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase {name} FAILED", file=sys.stderr)
        return 1
    finally:
        if "oracle" in ctx:
            ctx["oracle"].close()
        shutil.rmtree(d, ignore_errors=True)
    if args.only:
        print("chip_smoke: selected phases ok (partial run, no result line)")
        return 0
    devs = jax.devices()
    print(result_line(devs[0].platform, devs[0].device_kind, len(devs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
