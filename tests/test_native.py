"""Native host library (C++ GAF emitter / band checks / FASTA reader)."""

import numpy as np
import pytest

from recgraph_tpu import native
from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.io import fasta, gfa
from recgraph_tpu.oracle import gaf_emit
from recgraph_tpu.ops import poa_engine
from recgraph_tpu.scoring import ScoreMatrix

pytestmark = pytest.mark.skipif(native.load() is None, reason="no native lib")


def test_native_fasta(example_paths):
    reads_fa, _ = example_paths
    nat = native.read_fasta(reads_fa)
    # compare against the pure-Python implementation (bypass fast path)
    sequences, names, current = [], [], []
    with open(reads_fa) as fh:
        for raw in fh:
            line = raw.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                names.append(line[1:])
                if current:
                    sequences.append("$" + "".join(current))
                    current = []
            elif line:
                current.append(line.upper().replace("-", "N"))
    if current:
        sequences.append("$" + "".join(current))
    assert nat == (sequences, names)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_native_emit_identical(example_paths, mode):
    reads_fa, graph_gfa = example_paths
    seqs, names = fasta.get_sequences(reads_fa)
    seqs, names = seqs[:4], names[:4]
    g = PoaGraph.from_gfa(gfa.parse_gfa(graph_gfa))
    sm = ScoreMatrix.create("none", 2, -4)
    hofp_ids = np.array([int(h) for h in g.handle_pos], dtype=np.int64)
    btas = [int(1 + 0.01 * len(s)) for s in seqs]
    emitters = {
        0: gaf_emit.gaf_of_global_abpoa,
        1: gaf_emit.gaf_of_local_poa,
        2: gaf_emit.gaf_of_gap_abpoa,
        3: gaf_emit.gaf_of_gap_local_poa,
    }
    states = poa_engine.run_batch(mode, seqs, g, sm, -4, -2, btas)
    for i, st in enumerate(states):
        py = emitters[mode](st, seqs[i], names[i], False, g.handle_pos).to_string()
        packed = np.ascontiguousarray(st.path.packed)
        lefts = np.ascontiguousarray(np.asarray(st.path.lefts, dtype=np.int32))
        px = np.ascontiguousarray(st.path_x.packed) if mode in (2, 3) else None
        pyy = np.ascontiguousarray(st.path_y.packed) if mode in (2, 3) else None
        tail = native.gaf_emit_poa(
            mode, packed, px, pyy, lefts, hofp_ids,
            st.last_row, st.last_col, len(seqs[i]), False,
        )
        assert f"{names[i]}\t{tail}" == py
        rights = np.ascontiguousarray(np.asarray(st.ampl)[:, 1].astype(np.int32))
        if mode == 0:
            assert st.band_check_ok == native.band_check_linear(
                packed, lefts, rights, len(seqs[i]), st.last_row, st.last_col
            )
        if mode == 2:
            assert st.band_check_ok == native.band_check_gap(
                packed, px, pyy, lefts, rights, len(seqs[i]), st.last_row,
                st.last_col,
            )


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_device_walk_identical(example_paths, mode):
    """On-device traceback + native walk emitter == plane-based path."""
    from recgraph_tpu.align.pipeline import _hofp_ids

    reads_fa, graph_gfa = example_paths
    seqs, names = fasta.get_sequences(reads_fa)
    seqs, names = seqs[:4], names[:4]
    g = PoaGraph.from_gfa(gfa.parse_gfa(graph_gfa))
    sm = ScoreMatrix.create("none", 2, -4)
    btas = [int(1 + 0.01 * len(s)) for s in seqs]
    hofp_ids = _hofp_ids(g)
    emitters = {
        0: gaf_emit.gaf_of_global_abpoa,
        1: gaf_emit.gaf_of_local_poa,
        2: gaf_emit.gaf_of_gap_abpoa,
        3: gaf_emit.gaf_of_gap_local_poa,
    }
    plane_states = poa_engine.run_batch(mode, seqs, g, sm, -4, -2, btas)
    walk_states = poa_engine.run_batch_walks(mode, seqs, g, sm, -4, -2, btas)
    for i, (ps, ws) in enumerate(zip(plane_states, walk_states)):
        ref = emitters[mode](ps, seqs[i], names[i], False, g.handle_pos).to_string()
        tail = native.gaf_emit_poa_walk(
            ws.dirs, ws.rows, ws.stop_row, ws.query_start, ws.last_row,
            ws.last_col_abs, hofp_ids, len(seqs[i]), False,
        )
        assert f"{names[i]}\t{tail}" == ref
        assert ws.band_check_ok == ps.band_check_ok
        assert ws.score == ps.score


def test_banded_baselines_match_engines(example_paths):
    """The C++ banded baselines (global_abpoa.rs / gap_global_abpoa.rs
    loops, VERDICT r3 missing #2) score-match the device engines on the
    full example corpus, with HOXD70 covering the asymmetric-matrix
    score orientations."""
    import jax.numpy as jnp

    from recgraph_tpu.ops import poa_gap_engine
    from recgraph_tpu.ops.encode import (
        encode_read_aux,
        encode_reads,
        poa_device_graph,
    )

    reads_fa, graph_gfa = example_paths
    seqs, _ = fasta.get_sequences(reads_fa)
    g = PoaGraph.from_gfa(gfa.parse_gfa(graph_gfa))
    dg = poa_device_graph(g)
    btas = [int(1 + 0.01 * len(s)) for s in seqs]
    seq, L = encode_reads(seqs)
    bta = encode_read_aux(btas)
    for mtx in ("none", "HOXD70.mtx"):
        sm = ScoreMatrix.create(mtx, 2, -4)
        table = jnp.asarray(sm.table, dtype=jnp.int32)
        secs, cells, scores = native.baseline_banded_cpu(
            g, sm, seqs, btas, repeats=1
        )
        assert secs > 0 and cells > 0
        sc = np.asarray(poa_engine._fill_global(dg, table, seq, L, bta)[0])
        assert (sc == scores).all(), mtx
        o, e = (-4, -2) if mtx == "none" else (-200, -2)
        secs2, cells2, scores2 = native.baseline_banded_cpu(
            g, sm, seqs, btas, repeats=1, gap=(o, e)
        )
        sc2 = np.asarray(
            poa_gap_engine.fill_gap_global(dg, table, seq, L, bta, o, e)[0]
        )
        assert (sc2 == scores2).all(), mtx


@pytest.mark.parametrize("mode", [0, 2])
def test_device_band_check_fail_cases(example_paths, mode):
    """The in-walk device band check (traceback_engine.walk_poa band=)
    must reproduce the native replay verdict on FAILING bands too —
    forced here with bta=1 (near-degenerate band)."""
    reads_fa, graph_gfa = example_paths
    seqs, names = fasta.get_sequences(reads_fa)
    seqs = seqs[:12]
    g = PoaGraph.from_gfa(gfa.parse_gfa(graph_gfa))
    sm = ScoreMatrix.create("none", 2, -4)
    btas = [1] * len(seqs)
    plane_states = poa_engine.run_batch(mode, seqs, g, sm, -4, -2, btas)
    walk_states = poa_engine.run_batch_walks(mode, seqs, g, sm, -4, -2, btas)
    oks = [ps.band_check_ok for ps in plane_states]
    for ps, ws in zip(plane_states, walk_states):
        assert ws.band_check_ok == ps.band_check_ok
        assert ws.score == ps.score
    assert not all(oks), "bta=1 should fail the band check somewhere"
