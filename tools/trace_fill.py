"""Trace the mode-1 fill on the GPU: the XLA scan engine and the CUDA
kernel, at B=512 on the example graph (n=1331, Lp=256).

    python tools/trace_fill.py [outdir]

For each implementation: one warm-up call, then a jax.profiler trace of
three calls, each ended by block_until_ready.  The trace is reduced to
device events per fill and per graph row, the summed event time, the
device busy share of the traced window, and the heaviest event names.
Writes the traces under ``outdir`` (default chiprun_out/trace_fill).
"""

from __future__ import annotations

import collections
import glob
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp

CALLS = 3


def device_events(xplane):
    """[(line, name, start_ns, dur_ns)] of the GPU planes of a trace."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(xplane).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                out.append((line.name, ev.name, ev.start_ns, ev.duration_ns))
    return out


def reduce(events, rows, calls):
    """Counts and times of one traced window of ``calls`` fills."""
    by_line = collections.Counter(ln for ln, *_ in events)
    # kernels: the busiest line (the compute stream); others hold
    # memcpy and XLA-op annotations
    stream = by_line.most_common(1)[0][0]
    ks = sorted((s, s + d, nm) for ln, nm, s, d in events if ln == stream)
    busy, end = 0.0, None
    for s, e, _ in ks:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = ks[-1][1] - ks[0][0]
    per_name = collections.Counter()
    for s, e, nm in ks:
        per_name[nm] += e - s
    return {
        "lines": dict(by_line),
        "stream": stream,
        "events_per_fill": len(ks) / calls,
        "events_per_row": len(ks) / calls / rows,
        "event_ms_per_fill": sum(e - s for s, e, _ in ks) / calls / 1e6,
        "window_ms": window / 1e6,
        "busy_share": busy / window,
        "top": [(nm, t / calls / 1e6) for nm, t in per_name.most_common(6)],
    }


def main(outdir):
    from recgraph_tpu.graph.poagraph import PoaGraph
    from recgraph_tpu.io import fasta, gfa
    from recgraph_tpu.ops import cuda_fill, poa_engine
    from recgraph_tpu.ops.device import card
    from recgraph_tpu.ops.encode import encode_reads, poa_device_graph
    from recgraph_tpu.scoring import ScoreMatrix

    ex = os.path.join(ROOT, "example")
    seqs, _ = fasta.get_sequences(os.path.join(ex, "reads.fa"))
    g = PoaGraph.from_gfa(gfa.parse_gfa(os.path.join(ex, "graph.gfa")))
    dg = poa_device_graph(g)
    table = jnp.asarray(ScoreMatrix.create("none", 2, -4).table, jnp.int32)
    seq, L = encode_reads((seqs * 10)[:512], pad_to=256)
    impls = {
        "xla": lambda: poa_engine._fill_local(dg, table, seq, L),
        "cuda": lambda: cuda_fill.fill_local(dg, table, seq, L),
    }
    print(f"card: {card()}; B={seq.shape[0]} n={dg.n} Lp={seq.shape[1]}")
    for name, fn in impls.items():
        jax.block_until_ready(fn())
        d = os.path.join(outdir, name)
        t0 = time.perf_counter()
        with jax.profiler.trace(d):
            for _ in range(CALLS):
                jax.block_until_ready(fn())
        wall = (time.perf_counter() - t0) / CALLS
        xp = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                              recursive=True))[-1]
        r = reduce(device_events(xp), dg.n - 1, CALLS)
        print(f"{name}: traced wall {wall * 1e3:.3f} ms/fill; {r}")


if __name__ == "__main__":
    if jax.devices()[0].platform != "gpu":
        sys.exit("trace_fill: JAX found no GPU")
    main(sys.argv[1] if len(sys.argv) > 1
         else os.path.join(ROOT, "chiprun_out", "trace_fill"))
