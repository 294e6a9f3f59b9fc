"""Library API: one-call POA alignments (modes 0-3).

Parity with the reference library surface (reference: src/api.rs:11-164):
``align_global_no_gap``, ``align_global_gap``, ``align_local_no_gap``,
``align_local_gap`` plus the score-matrix constructors.  Inputs are a
raw read string and a parsed GFA (our ``Gfa`` stands in for the
reference's ``HashGraph``); the graph is re-encoded per call exactly as
the reference does (api.rs:19,51,84,110 — callers batching many reads
should use align.pipeline instead, which encodes once).

Defaults mirror api.rs: M=2, X=-4, band fraction 0.1 of the read
length, o=-10, e=-6 for the gap modes (api.rs:20-21,56-58,116-118).
"""

from __future__ import annotations

import numpy as np

from .graph.poagraph import PoaGraph
from .io.fasta import build_align_string
from .io.gaf import GafRecord
from .io.gfa import Gfa
from .oracle import gaf_emit
from .ops import poa_engine
from .scoring import ScoreMatrix


def create_score_matrix_i32(match: int, mismatch: int) -> ScoreMatrix:
    """Mirrors api::create_score_matrix_i32 (api.rs:131-141)."""
    return ScoreMatrix.match_mismatch(match, mismatch)


def create_score_matrix_f32(match: float, mismatch: float) -> ScoreMatrix:
    """Mirrors api::create_score_matrix_f32 (api.rs:153-164).

    The device engines are integer-exact, so the f32 variant shares the
    int table (the reference's f32 path exists only for its AVX2 SIMD).
    """
    return ScoreMatrix.match_mismatch(int(match), int(mismatch))


def _prep(read: str, gfa: Gfa, score_matrix, bases_to_add, default_frac=0.1):
    from . import enable_compile_cache

    enable_compile_cache()
    g = PoaGraph.from_gfa(gfa, amb_mode=False)
    sm = score_matrix or ScoreMatrix.match_mismatch(2, -4)
    bta = int(len(read) * (default_frac if bases_to_add is None else bases_to_add))
    seq = build_align_string(read)
    return g, sm, bta, seq


def align_global_no_gap(
    read: str,
    gfa: Gfa,
    sequence_name: str = "no_name",
    score_matrix: ScoreMatrix | None = None,
    bases_to_add: float | None = None,
) -> GafRecord:
    """Mirrors api::align_global_no_gap (api.rs:11-41)."""
    g, sm, bta, seq = _prep(read, gfa, score_matrix, bases_to_add)
    st = poa_engine.run_single(0, seq, g, sm, -10, -6, bta)
    rec = gaf_emit.gaf_of_global_abpoa(st, seq, sequence_name, False, g.handle_pos)
    return rec


def align_global_gap(
    read: str,
    gfa: Gfa,
    sequence_name: str = "no_name",
    score_matrix: ScoreMatrix | None = None,
    bases_to_add: float | None = None,
    o: int = -10,
    e: int = -6,
) -> GafRecord:
    """Mirrors api::align_global_gap (api.rs:43-74)."""
    g, sm, bta, seq = _prep(read, gfa, score_matrix, bases_to_add)
    st = poa_engine.run_single(2, seq, g, sm, o, e, bta)
    return gaf_emit.gaf_of_gap_abpoa(st, seq, sequence_name, False, g.handle_pos)


def align_local_no_gap(
    read: str,
    gfa: Gfa,
    sequence_name: str = "no_name",
    score_matrix: ScoreMatrix | None = None,
) -> GafRecord:
    """Mirrors api::align_local_no_gap (api.rs:76-100)."""
    g, sm, _, seq = _prep(read, gfa, score_matrix, None)
    st = poa_engine.run_single(1, seq, g, sm, -10, -6, 0)
    return gaf_emit.gaf_of_local_poa(st, seq, sequence_name, False, g.handle_pos)


def align_local_gap(
    read: str,
    gfa: Gfa,
    sequence_name: str = "no_name",
    score_matrix: ScoreMatrix | None = None,
    o: int = -10,
    e: int = -6,
) -> GafRecord:
    """Mirrors api::align_local_gap (api.rs:102-128)."""
    g, sm, _, seq = _prep(read, gfa, score_matrix, None)
    st = poa_engine.run_single(3, seq, g, sm, o, e, 0)
    return gaf_emit.gaf_of_gap_local_poa(st, seq, sequence_name, False, g.handle_pos)
