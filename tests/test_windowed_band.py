"""Windowed-band mode-0 engine (long reads) vs the exact full-width fill.

The windowed fill (`poa_engine._fill_global_windowed`) stores O(W)
lanes per row instead of O(L) — the device analogue of the reference's
O(band) rows (utils.rs:17-72).  These tests pin it to the full-width
engine bit-for-bit and byte-for-byte through the pipeline.
"""

import contextlib
import io
import os
import random
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from recgraph_tpu.align.pipeline import Options, run
from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.io import gfa
from recgraph_tpu.ops import poa_engine
from recgraph_tpu.ops.encode import encode_reads, encode_read_aux, poa_device_graph
from recgraph_tpu.scoring import ScoreMatrix


@pytest.fixture(scope="module")
def long_corpus(tmp_path_factory):
    from make_synthetic import make

    d = str(tmp_path_factory.mktemp("longreads"))
    make(d, n_back=700, n_reads=1, seed=11)
    rng = random.Random(5)
    walks, segs = {}, {}
    for ln in open(os.path.join(d, "graph.gfa")):
        f = ln.rstrip("\n").split("\t")
        if f[0] == "P":
            walks[f[1]] = [int(x[:-1]) for x in f[2].split(",")]
        elif f[0] == "S":
            segs[int(f[1])] = f[2]
    reads = []
    for _ in range(3):
        w = walks[rng.choice(list(walks))]
        s = "".join(segs[x] for x in w)
        start = rng.randrange(max(1, len(s) - 1200))
        frag = s[start : start + 1100]
        reads.append(
            "".join((rng.choice("ACGT") if rng.random() < 0.02 else c) for c in frag)
        )
    assert min(len(r) for r in reads) >= poa_engine.LONG_READ_LP
    fa = os.path.join(d, "long_reads.fa")
    with open(fa, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">lr{i}\n{r}\n")
    return fa, os.path.join(d, "graph.gfa"), reads


def test_windowed_fill_bit_exact(long_corpus):
    _, graph_gfa, reads = long_corpus
    parsed = gfa.parse_gfa(graph_gfa)
    g = PoaGraph.from_gfa(parsed)
    dg = poa_device_graph(g)
    sm = ScoreMatrix.create("none", 2, -4)
    import jax.numpy as jnp

    table = jnp.asarray(sm.table, dtype=jnp.int32)
    seq, L = encode_reads(reads)
    bta = encode_read_aux([100] * len(reads))
    sc, lr, lc, pk, lf, rt = (
        np.asarray(x) for x in poa_engine._fill_global(dg, table, seq, L, bta)
    )
    out = poa_engine.fill_global_long(dg, table, seq, L, bta, 100)
    scw, lrw, lcw, pkw, lfw, rtw, ws = (
        None if x is None else np.asarray(x) for x in out
    )
    assert ws is not None, "ladder fell back to full width (W hint too big?)"
    assert (sc == scw).all() and (lr == lrw).all() and (lc == lcw).all()
    assert (lf == lfw).all() and (rt == rtw).all()
    for b in range(len(reads)):
        for i in range(dg.n):
            l, r, w = lf[b, i], rt[b, i], ws[b, i]
            if r > l:
                assert (pk[b, i, l:r] == pkw[b, i, l - w : r - w]).all(), (b, i)


def test_windowed_overflow_guard(long_corpus):
    """A too-small W must set the over flag, never corrupt output."""
    _, graph_gfa, reads = long_corpus
    parsed = gfa.parse_gfa(graph_gfa)
    g = PoaGraph.from_gfa(parsed)
    dg = poa_device_graph(g)
    sm = ScoreMatrix.create("none", 2, -4)
    import jax.numpy as jnp

    table = jnp.asarray(sm.table, dtype=jnp.int32)
    seq, L = encode_reads(reads[:1])
    bta = encode_read_aux([400])
    over = np.asarray(
        poa_engine._fill_global_windowed(dg, table, seq, L, bta, W=256)[7]
    )
    assert over.all()


def _run_cli(reads_fa, graph_gfa):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(
            Options(
                sequence_path=reads_fa, graph_path=graph_gfa, engine="jax",
                alignment_mode=0,
            )
        )
    return buf.getvalue()


def test_windowed_pipeline_byte_equal(long_corpus, monkeypatch):
    reads_fa, graph_gfa, _ = long_corpus
    got_windowed = _run_cli(reads_fa, graph_gfa)
    assert got_windowed.count("\n") == 3
    monkeypatch.setattr(poa_engine, "LONG_READ_LP", 1 << 30)  # force full width
    got_full = _run_cli(reads_fa, graph_gfa)
    assert got_windowed == got_full


def test_windowed_gap_fill_bit_exact(long_corpus):
    """Mode-2 windowed fill (poa_gap_engine._fill_gap_global_windowed)
    vs the exact full-width affine engine: scores, bounds, and all
    three packed planes."""
    import jax.numpy as jnp

    from recgraph_tpu.ops import poa_gap_engine

    _, graph_gfa, reads = long_corpus
    parsed = gfa.parse_gfa(graph_gfa)
    g = PoaGraph.from_gfa(parsed)
    dg = poa_device_graph(g)
    sm = ScoreMatrix.create("none", 2, -4)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    seq, L = encode_reads(reads)
    bta = encode_read_aux([100] * len(reads))
    o, e = jnp.int32(-4), jnp.int32(-2)
    sc, lr, lc, pk, px, py, lf, rt = (
        np.asarray(x)
        for x in poa_gap_engine._fill_gap_global(dg, table, seq, L, bta, o, e)[:8]
    )
    out = poa_gap_engine.fill_gap_global_long(
        dg, table, seq, L, bta, 100, -4, -2
    )
    scw, lrw, lcw, pkw, pxw, pyw, lfw, rtw, ws = (
        None if x is None else np.asarray(x) for x in out
    )
    assert ws is not None, "ladder fell back to full width"
    assert (sc == scw).all() and (lr == lrw).all() and (lc == lcw).all()
    assert (lf == lfw).all() and (rt == rtw).all()
    for b in range(len(reads)):
        for i in range(dg.n):
            l, r, w = lf[b, i], rt[b, i], ws[b, i]
            if r > l:
                for a, bb in ((pk, pkw), (px, pxw), (py, pyw)):
                    assert (a[b, i, l:r] == bb[b, i, l - w : r - w]).all(), (b, i)


def test_windowed_gap_pipeline_byte_equal(long_corpus, monkeypatch):
    reads_fa, graph_gfa, _ = long_corpus
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(Options(sequence_path=reads_fa, graph_path=graph_gfa,
                    engine="jax", alignment_mode=2))
    got_windowed = buf.getvalue()
    assert got_windowed.count("\n") == 3
    monkeypatch.setattr(poa_engine, "LONG_READ_LP", 1 << 30)  # force full width
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(Options(sequence_path=reads_fa, graph_path=graph_gfa,
                    engine="jax", alignment_mode=2))
    assert got_windowed == buf.getvalue()
