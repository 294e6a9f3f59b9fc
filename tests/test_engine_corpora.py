"""The XLA engines against the scalar oracle on the corpora that once
pinned the device kernels: random DAGs (seeds 101, 202), a 126-path
pangenome, the modes-6/7 hard-row corpora, and the windowed long-read
engines at lane-aligned widths.

Each case runs the production engine (the fill the GPU runs, or the
full pipeline path) and compares GAF lines or delta-form planes with
the oracle exactly.
"""

import os
import random
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from recgraph_tpu.graph.pathgraph import PathGraph
from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.io import fasta, gfa as gfa_io
from recgraph_tpu.oracle import gaf_emit, pathwise, poa
from recgraph_tpu.oracle import recombination as ro
from recgraph_tpu.ops import (
    pathwise_engine, poa_engine, poa_gap_engine, recombination_engine,
)
from recgraph_tpu.ops.encode import encode_reads, encode_read_aux, poa_device_graph
from recgraph_tpu.scoring import ScoreMatrix

from test_engine_gap67 import _assert_fill_equal
from test_fuzz_random_graphs import random_gfa, random_read

SEEDS = [101, 202]
EMIT = {
    0: gaf_emit.gaf_of_global_abpoa,
    1: gaf_emit.gaf_of_local_poa,
    2: gaf_emit.gaf_of_gap_abpoa,
    3: gaf_emit.gaf_of_gap_local_poa,
}


def _fuzz(seed, n_nodes=24, n_paths=4, n_reads=8, cover_all=True):
    rng = random.Random(seed)
    gfa = random_gfa(rng, n_nodes=n_nodes, n_paths=n_paths,
                     cover_all=cover_all)
    reads = [random_read(rng, gfa) for _ in range(n_reads)]
    return gfa, reads, ScoreMatrix.create("none", 2, -4)


def _poa_vs_oracle(mode, gfa, reads, sm):
    g = PoaGraph.from_gfa(gfa)
    btas = [100] * len(reads)
    oracle = {
        0: lambda s: poa.global_banded(s, g, sm, 100),
        1: lambda s: poa.local_full(s, g, sm),
        2: lambda s: poa.gap_global_banded(s, g, sm, -4, -2, 100),
        3: lambda s: poa.gap_local_full(s, g, sm, -4, -2),
    }[mode]
    states = poa_engine.run_batch(mode, reads, g, sm, -4, -2, btas)
    for i, s in enumerate(reads):
        want = EMIT[mode](oracle(s), s, "r", False, g.handle_pos).to_string()
        got = EMIT[mode](states[i], s, "r", False, g.handle_pos).to_string()
        assert got == want, f"mode {mode} read {i}"


# ---------------------------------------------------------------------------
# random DAGs: the four families of the former kernel fuzz
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_global(seed):
    _poa_vs_oracle(0, *_fuzz(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_gap_global_and_local(seed):
    gfa, reads, sm = _fuzz(seed)
    _poa_vs_oracle(2, gfa, reads, sm)
    _poa_vs_oracle(3, gfa, reads, sm)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_local_and_padding(seed):
    """Mode 1 vs the oracle, and the fill unchanged by padding the
    reads to a wider, 64-granular width."""
    gfa, reads, sm = _fuzz(seed)
    _poa_vs_oracle(1, gfa, reads, sm)
    dg = poa_device_graph(PoaGraph.from_gfa(gfa))
    table = jnp.asarray(sm.table, jnp.int32)
    seq, L = encode_reads(reads)
    ref = poa_engine._fill_local(dg, table, seq, L)
    S = -(-seq.shape[1] // 64) * 64 + 64
    seqp, Lq = encode_reads(reads, pad_to=S)
    got = poa_engine._fill_local(dg, table, seqp, Lq)
    for a, b in zip(ref[:3], got[:3]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(ref[3]),
                          np.asarray(got[3])[:, :, : seq.shape[1]])


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_pathwise_and_recombination(seed):
    gfa, reads, sm = _fuzz(seed)
    g = PathGraph.from_gfa(gfa)
    for mode in (4, 5):
        recs = pathwise_engine.run_batch_walks(mode, reads, g, sm)
        fn = pathwise.exec_global if mode == 4 else pathwise.exec_semiglobal
        for i, s in enumerate(reads):
            assert recs[i].to_string() == fn(s, g, sm).to_string(), (mode, i)
    rg = g.reverse()
    from recgraph_tpu.graph.pathgraph import nodes_displacement_matrix

    dms = nodes_displacement_matrix(g, rg)
    for mode in (8, 9):
        recs = recombination_engine.run_batch_walks(
            mode, reads[:3], g, rg, sm, 4, 0.1, 1.0
        )
        for i, s in enumerate(reads[:3]):
            want = ro.exec_mode(mode, s, g, rg, sm, 4, 0.1, dms, 1.0)
            assert recs[i].to_string() == want.to_string(), (mode, i)


# ---------------------------------------------------------------------------
# many haplotypes: 126 paths sharing a bubbled backbone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def p126():
    from make_synthetic import make

    with tempfile.TemporaryDirectory() as d:
        make(d, n_back=80, n_reads=8, seed=7, n_paths=126)
        seqs, _ = fasta.get_sequences(os.path.join(d, "reads.fa"))
        g = PathGraph.from_gfa(gfa_io.parse_gfa(os.path.join(d, "graph.gfa")))
    return seqs[:4], g, ScoreMatrix.create("none", 2, -4)


@pytest.mark.parametrize("mode", [4, 5])
def test_many_paths_pathwise(p126, mode):
    seqs, g, sm = p126
    assert g.paths_number == 126
    recs = pathwise_engine.run_batch_walks(mode, seqs, g, sm)
    fn = pathwise.exec_global if mode == 4 else pathwise.exec_semiglobal
    for i, s in enumerate(seqs):
        assert recs[i].to_string() == fn(s, g, sm).to_string(), i


@pytest.mark.parametrize("mode8", [True, False])
def test_many_paths_reverse_fill(p126, mode8):
    """The reverse fill of modes 8/9 at P=126: its padded-width result
    equals the unpadded one on every real column (the column the fill
    reads per read is its own length)."""
    seqs, g, sm = p126
    dgr = recombination_engine.rev_device_graph(g.reverse())
    table = jnp.asarray(sm.table, jnp.int32)
    seq, L = encode_reads(seqs)
    ref = np.asarray(pathwise_engine.fill_pathwise_rev_best(
        dgr, table, seq, L, mode8, True))
    seqp, Lq = encode_reads(seqs, pad_to=256)
    got = np.asarray(pathwise_engine.fill_pathwise_rev_best(
        dgr, table, seqp, Lq, mode8, True))
    assert np.array_equal(ref, got[:, :, :, : seq.shape[1]])


def test_many_paths_recombination(p126):
    seqs, g, sm = p126
    from recgraph_tpu.graph.pathgraph import nodes_displacement_matrix

    rg = g.reverse()
    dms = nodes_displacement_matrix(g, rg)
    recs = recombination_engine.run_batch_walks(
        8, seqs[:2], g, rg, sm, 4, 0.1, 1.0
    )
    for i, s in enumerate(seqs[:2]):
        want = ro.exec_mode(8, s, g, rg, sm, 4, 0.1, dms, 1.0)
        assert recs[i].to_string() == want.to_string(), i


# ---------------------------------------------------------------------------
# modes 6/7: the hard-row corpora, delta-form planes vs the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("semi", [False, True])
def test_gap67_hard_rows_example(example_paths, semi):
    reads_fa, graph_gfa = example_paths
    seqs, _ = fasta.get_sequences(reads_fa)
    g = PathGraph.from_gfa(gfa_io.parse_gfa(graph_gfa), is_reversed=False)
    _assert_fill_equal(g, ScoreMatrix.create("none", 2, -4), seqs[:6],
                       -4, -2, semi)


@pytest.mark.parametrize("semi", [False, True])
def test_gap67_hard_rows_synthetic(semi):
    from make_synthetic import make

    with tempfile.TemporaryDirectory() as d:
        make(d, n_back=60, n_reads=8, seed=7, n_paths=6)
        g = PathGraph.from_gfa(gfa_io.parse_gfa(os.path.join(d, "graph.gfa")),
                               is_reversed=False)
        seqs, _ = fasta.get_sequences(os.path.join(d, "reads.fa"))
    _assert_fill_equal(g, ScoreMatrix.create("none", 2, -4), seqs[:4],
                       -3, -1, semi)


@pytest.mark.parametrize("seed", [1000, 1001, 1002, 1003, 1004, 1005])
def test_gap67_random_dags(seed):
    rng = random.Random(seed)
    gfa = random_gfa(rng, n_nodes=16, n_paths=4, cover_all=True)
    g = PathGraph.from_gfa(gfa, is_reversed=False)
    reads = [random_read(rng, gfa) for _ in range(2)]
    sm, o, e = [
        (ScoreMatrix.create("none", 2, -4), -4, -2),
        (ScoreMatrix.create("HOXD70", 2, -4), -200, -2),
        (ScoreMatrix.create("none", 2, -4), -3, -1),
    ][seed % 3]
    _assert_fill_equal(g, sm, reads, o, e, seed % 2 == 1)


# ---------------------------------------------------------------------------
# windowed long-read engines at lane-aligned widths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def long_corpus():
    """Full-span haplotype reads (2% substitutions) on a small graph."""
    from make_synthetic import make

    with tempfile.TemporaryDirectory() as d:
        make(d, n_back=150, n_reads=1, seed=11, n_paths=4)
        parsed = gfa_io.parse_gfa(os.path.join(d, "graph.gfa"))
    rng = random.Random(3)
    reads = []
    for k in range(4):
        walk = parsed.paths[k % len(parsed.paths)].nodes
        s = "".join(parsed.segments[x] for x in walk)
        reads.append("$" + "".join(
            rng.choice("ACGT") if rng.random() < 0.02 else c for c in s))
    return parsed, reads


@pytest.mark.parametrize("W", [128, 256, 384])
def test_windowed_global_at_width(long_corpus, W):
    """Modes 0 and 2: the windowed fill at a lane-aligned W, where no
    read overflows, equals the full-width fill inside every band."""
    parsed, reads = long_corpus
    g = PoaGraph.from_gfa(parsed)
    dg = poa_device_graph(g)
    table = jnp.asarray(ScoreMatrix.create("none", 2, -4).table, jnp.int32)
    seq, L = encode_reads(reads)
    btas = [int(1 + 0.01 * len(s)) for s in reads]
    bta = encode_read_aux(btas)
    o, e = jnp.int32(-4), jnp.int32(-2)
    # (windowed, full width, plane indices, lefts, rights, ws, over)
    runs = (
        (poa_engine._fill_global_windowed(dg, table, seq, L, bta, W=W),
         poa_engine._fill_global(dg, table, seq, L, bta), (3,), 4, 5, 6, 7),
        (poa_gap_engine._fill_gap_global_windowed(
            dg, table, seq, L, bta, o, e, W=W),
         poa_gap_engine._fill_gap_global(dg, table, seq, L, bta, o, e),
         (3, 4, 5), 6, 7, 8, 9),
    )
    checked = 0
    for win, full, planes, kl, kr, kw, ko in runs:
        win = [np.asarray(x) for x in win]
        full = [np.asarray(x) for x in full]
        for b in range(len(reads)):
            if win[ko][b]:
                continue   # overflow: production reruns it full width
            checked += 1
            for k in range(3):
                assert win[k][b] == full[k][b]
            for i in range(dg.n - 1):
                lo, hi, w0 = win[kl][b, i], win[kr][b, i], win[kw][b, i]
                assert (lo, hi) == (full[kl][b, i], full[kr][b, i])
                for k in planes:
                    assert np.array_equal(win[k][b, i, lo - w0: hi - w0],
                                          full[k][b, i, lo:hi]), (k, b, i)
    assert checked


@pytest.mark.parametrize("W", [128, 256])
def test_windowed_pathwise_pipeline_at_width(long_corpus, W):
    """Mode 4: the windowed W ladder starting at a lane-aligned W emits
    the full-width engine's records."""
    parsed, reads = long_corpus
    g = PathGraph.from_gfa(parsed, is_reversed=False)
    sm = ScoreMatrix.create("none", 2, -4)
    old = pathwise_engine.LONG_READ_LP
    try:
        pathwise_engine.LONG_READ_LP = 1 << 30
        full = pathwise_engine.run_batch_walks(4, reads, g, sm)
        pathwise_engine.LONG_READ_LP = 64
        pathwise_engine._pw_w_hint.clear()
        key = pathwise_engine._graph_hint_key(
            g, pathwise_engine.path_device_graph(g))
        pathwise_engine._pw_w_hint[key] = W
        win = pathwise_engine.run_batch_walks(4, reads, g, sm)
    finally:
        pathwise_engine.LONG_READ_LP = old
        pathwise_engine._pw_w_hint.clear()
    assert [r.to_string() for r in win] == [r.to_string() for r in full]
