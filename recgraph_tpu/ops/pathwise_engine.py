"""Batched device kernels for pathwise modes 4/5.

The reference compresses the per-path DP into alpha-absolute +
delta-vs-alpha form to save scalar work (pathwise_alignment.rs:16-304).
Its observable semantics: at every cell, each haplotype path moves in
the direction chosen by its *group representative* path (the
"common paths" group of its predecessor edge), with tie order
mx==d, mx==u, else l.  The device engine keeps dense per-path *absolute*
scores — provably the same values (the delta algebra telescopes:
q's update under the rep's direction is A[q] <- A[q, pred-cell] + inc)
— which turns the whole row into masked vector ops over the path axis.

Group metadata (rep_of/pred_of) is precompiled by
graph.pathgraph.pathwise_meta.  The in-row L-dependency is again a
(max,+) prefix chain: the rep rows are solved by the cummax trick, the
non-rep rows replay the rep's directions via a segmented chain (gather
at the last non-L column plus a cumulative-gap offset).

Layout: A is int32[B, P, n, Lp] (path-major so per-path predecessor-row
gathers are a flat take_along_axis on the fused (path, row) axis).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..io.gaf import GafRecord
from ..oracle import pathwise
from ..scoring import GAP
from .encode import path_device_graph, encode_reads, encode_read_aux
from .poa_engine import D, LOW_D, L_DIR, U_DIR, cummax_last, sub_planes, sub_row

NEG = -(1 << 28)


import functools as _functools


@_functools.partial(jax.jit, static_argnames=("encode_chain",))
def _fill_pathwise(dg, table, seq, semiglobal, encode_chain=True):
    """Dense absolute pathwise fill.

    Returns A int32[B, P, n, Lp] of per-path absolute scores (0 where a
    path does not cover a node — matching the reference's untouched
    cells, pathwise_alignment.rs:16).
    """
    n, P = dg.n, dg.paths_number
    B, Lp = seq.shape
    jcol = jnp.arange(Lp, dtype=jnp.int32)
    gseq = table[seq, GAP]                                 # [B, Lp]
    G = jnp.cumsum(gseq, axis=1)
    SUBP = sub_planes(table, seq)                          # [A, B, Lp]
    qdiag = jnp.arange(P)

    def step(carry, xs):
        # carry layout: FLAT [n*P, B, Lp] with row i's planes at block
        # [i*P:(i+1)*P].  Two reasons: the per-row dynamic_update_slice
        # hits the leading (major) axis, which XLA updates in place (a
        # [B, P, n, Lp] carry forced a relayout copy every row, ~100x);
        # and the predecessor reads gather exactly the 2P [B, Lp]
        # planes they need (~0.9 MB/row) instead of a [P, B, P, Lp]
        # block (~10 MB/row) — the fill is HBM-gather-bound, so this
        # is ~10x less traffic
        A = carry
        i, code_i, pvec, rvec, on = xs                     # [P] each
        gap_i = table[code_i, GAP]
        subrow = sub_row(SUBP, code_i)                     # [B, Lp]
        p_safe = jnp.maximum(pvec, 0)
        r_safe = jnp.maximum(rvec, 0)

        Aq = jnp.moveaxis(A[p_safe * P + qdiag], 0, 1)     # [B, P, Lp]
        Ar = jnp.moveaxis(A[p_safe * P + r_safe], 0, 1)    # [B, P, Lp]

        # rep rows via the (max,+) chain (pathwise_alignment.rs:18-304)
        Ar_sh = jnp.roll(Ar, 1, axis=2).at[:, :, 0].set(NEG)
        d_r = Ar_sh + subrow[:, None, :]
        u_r = Ar + gap_i
        first_r = jnp.where(semiglobal, 0, Ar[:, :, 0] + gap_i)  # j == 0
        Achain = jnp.maximum(d_r, u_r)
        Achain = Achain.at[:, :, 0].set(first_r)
        rep_row = G[:, None, :] + cummax_last(Achain - G[:, None, :])

        # directions from the rep values (tie order mx==d, mx==u, else L)
        dirD = rep_row == d_r
        dirU = ~dirD & (rep_row == u_r)
        nonL = dirD | dirU | (jcol == 0)[None, None, :]

        # non-rep replay: propagate the value at the last non-L column.
        # Instead of a lane-axis gather, the default path packs
        # (column << 17 | value+OFF) and runs a lane cummax — the max
        # picks the latest non-L column, whose
        # low bits carry its restart value (valid while
        # 2*Lp*max|score| < 2^16; encode_chain=False falls back).
        Aq_sh = jnp.roll(Aq, 1, axis=2).at[:, :, 0].set(NEG)
        vD = Aq_sh + subrow[:, None, :]
        vU = Aq + gap_i
        first_q = jnp.where(semiglobal, 0, Aq[:, :, 0] + gap_i)
        V = jnp.where(dirD, vD, vU)
        V = V.at[:, :, 0].set(first_q)
        if encode_chain:
            OFF = 1 << 16
            enc = jnp.where(
                nonL, (jcol << 17) | (V - G[:, None, :] + OFF), -1
            )
            enc = cummax_last(enc)
            row = G[:, None, :] + (enc & ((1 << 17) - 1)) - OFF
        else:
            kidx = cummax_last(jnp.where(nonL, jcol, -1))
            Vk = jnp.take_along_axis(V, kidx, axis=2)
            Gk = jnp.take_along_axis(
                jnp.broadcast_to(G[:, None, :], V.shape), kidx, axis=2
            )
            row = Vk + G[:, None, :] - Gk
        row = jnp.where(on[None, :, None], row, 0)

        A = jax.lax.dynamic_update_slice(
            A, jnp.moveaxis(row, 0, 1), (i * P, 0, 0)
        )
        return A, None

    A0 = jnp.zeros((n * P, B, Lp), dtype=jnp.int32)
    # row 0: all paths advance together with sm(seq[j], '-') gaps
    # (pathwise_alignment.rs:46-49)
    row0 = jnp.broadcast_to((G - G[:, :1])[None], (P, B, Lp))
    A0 = A0.at[:P].set(row0)

    rows = jnp.arange(1, n - 1, dtype=jnp.int32)
    xs = (
        rows,
        dg.codes[1 : n - 1],
        dg.pred_of[1 : n - 1],
        dg.rep_of[1 : n - 1],
        dg.paths_on[1 : n - 1],
    )
    A, _ = jax.lax.scan(step, A0, xs)
    return jnp.transpose(A.reshape(n, P, B, Lp), (2, 1, 0, 3))  # [B,P,n,Lp]


def fill_pathwise_best(dg, table, seq, semiglobal: bool, fits: bool):
    """Pathwise fill (XLA scan engine); returns A int32[B, P, n, Lp].

    ``fits`` is the packed-chain bound (2·Lp·max|score| < 2^16) that
    lets the engine run its in-row chain on packed col|val words.
    """
    return _fill_pathwise(dg, table, seq, jnp.bool_(semiglobal), encode_chain=fits)


def fill_pathwise_rev_best(dgr, table, seq, L, mode8: bool, fits: bool):
    """Reverse pathwise fill (modes 8/9); mirrors
    :func:`fill_pathwise_best`."""
    from .recombination_engine import _fill_pathwise_rev

    return _fill_pathwise_rev(
        dgr, table, seq, L, jnp.bool_(mode8), encode_chain=fits
    )


def _align_lp(sequences) -> int:
    """Chunk pad width: the corpus's longest read."""
    return max(len(s) for s in sequences)


@jax.jit
def _final_column(A, L):
    """A[:, :, :, L-1] per read -> int32[B, P, n]."""
    idx = (L - 1)[:, None, None, None]
    return jnp.take_along_axis(A, idx, axis=3)[..., 0]


@jax.jit
def _extract_plane(A, best_path):
    """A[b, best_path[b], :, :] -> int32[B, n, Lp]."""
    return jnp.take_along_axis(A, best_path[:, None, None, None], axis=1)[:, 0]


def _endings_global(finalcol_b, g):
    """Mirrors final_results_global (pathwise_alignment.rs:305-325)."""
    P = g.paths_number
    results = np.zeros(P, dtype=np.int64)
    ending = np.zeros(P, dtype=np.int64)
    for pred, paths in g.preds_and_paths(g.n - 1):
        for p in np.flatnonzero(paths):
            results[p] = finalcol_b[p, pred]
            ending[p] = pred
    best_path = max(range(P), key=lambda p: (results[p], p))
    return best_path, int(ending[best_path])


def _end_meta(g):
    """Per-path sink predecessor (+assigned mask), mirroring the
    final_results_global loop — cached on the graph so the per-read
    endings reduce ON DEVICE (fetching the [B, P, n] final column was
    the dominant mode-4 e2e transfer: ~80 KB/read)."""
    meta = g.__dict__.get("_end_meta")
    if meta is None:
        P = g.paths_number
        end_pred = np.zeros(P, dtype=np.int32)
        assigned = np.zeros(P, dtype=bool)
        for pred, paths in g.preds_and_paths(g.n - 1):
            for p in np.flatnonzero(paths):
                end_pred[p] = pred
                assigned[p] = True
        meta = (jnp.asarray(end_pred), jnp.asarray(assigned))
        g.__dict__["_end_meta"] = meta
    return meta


@jax.jit
def _endings_global_dev(finalcol, end_pred, assigned):
    """Batched device version of :func:`_endings_global`.

    Ties on the per-path result pick the HIGHEST path index (the
    oracle's max over (results[p], p)); unassigned paths keep the
    oracle's literal 0.  Returns (best_path, node, score) int32[B].
    """
    vals = jnp.take_along_axis(
        finalcol, end_pred[None, :, None], axis=2
    )[..., 0]                                              # [B, P]
    vals = jnp.where(assigned[None, :], vals, 0)
    P = vals.shape[1]
    best = (P - 1) - jnp.argmax(vals[:, ::-1], axis=1).astype(jnp.int32)
    node = end_pred[best]
    score = jnp.take_along_axis(vals, best[:, None], axis=1)[:, 0]
    return best, node, score


@jax.jit
def _endings_semiglobal_dev(finalcol, on):
    """Batched device version of :func:`_endings_semiglobal`; `on` is
    bool[P, n] (g.paths_nodes.T).  First-max tie order throughout,
    like the oracle's argmax calls."""
    NEGI = jnp.int32(np.iinfo(np.int32).min)
    vals = jnp.where(on[None], finalcol, NEGI)             # [B, P, n]
    pnb = jnp.max(vals, axis=1)                            # [B, n]
    pnp = jnp.argmax(vals, axis=1).astype(jnp.int32)       # first max
    node = 1 + jnp.argmax(pnb[:, 1:-1], axis=1).astype(jnp.int32)
    bp = jnp.take_along_axis(pnp, node[:, None], axis=1)[:, 0]
    score = jnp.take_along_axis(pnb, node[:, None], axis=1)[:, 0]
    return bp, node, score


def _endings_semiglobal(finalcol_b, g):
    """Mirrors best_ending_node (pathwise_alignment_semiglobal.rs:244-277)."""
    on = g.paths_nodes.T                                   # [P, n]
    vals = np.where(on, finalcol_b, np.iinfo(np.int32).min)
    per_node_best = vals.max(axis=0)                       # [n]
    per_node_path = vals.argmax(axis=0)                    # first max
    inner = per_node_best[1 : g.n - 1]
    node = 1 + int(inner.argmax())                         # first strict max
    return int(per_node_path[node]), node


def run_batch(mode, sequences, g, sm, chunk_bytes=1 << 29) -> list[GafRecord]:
    dg = path_device_graph(g)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    semiglobal = mode == 5
    n, P = dg.n, dg.paths_number
    records = []
    # chunk the batch so A = [B, P, n, Lp] stays under chunk_bytes
    Lp_all = _align_lp(sequences)
    per_read = P * n * Lp_all * 4
    chunk = max(1, int(chunk_bytes // per_read))
    for c0 in range(0, len(sequences), chunk):
        chunk_seqs = sequences[c0 : c0 + chunk]
        seq, L = encode_reads(chunk_seqs, pad_to=Lp_all)
        fits = 2 * seq.shape[1] * int(np.abs(np.asarray(table)).max()) < (1 << 16)
        A = fill_pathwise_best(dg, table, seq, semiglobal, fits)
        finalcol = np.asarray(jax.device_get(_final_column(A, L)))
        bps, nodes = [], []
        for b in range(len(chunk_seqs)):
            if semiglobal:
                bp, node = _endings_semiglobal(finalcol[b], g)
            else:
                bp, node = _endings_global(finalcol[b], g)
            bps.append(bp)
            nodes.append(node)
        planes = np.asarray(
            jax.device_get(_extract_plane(A, encode_read_aux(bps)))
        )
        del A
        for b, s in enumerate(chunk_seqs):
            plane = planes[b][:, : len(s)]
            records.append(
                pathwise.build_alignment(
                    None, g, s, sm, bps[b], nodes[b], not semiglobal, plane=plane
                )
            )
    return records


# ---------------------------------------------------------------------------
# on-device traceback (mirrors oracle/pathwise.build_alignment)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("global_mode", "max_steps"))
def _walk_pathwise(plane, seq, L, table, node_start, codes, pred_of_bp,
                   ending_node, global_mode, max_steps, start_j=None,
                   ws=None):
    """Batched traceback over dense best-path planes.

    plane: int32[B, n, Lp] absolute scores on the chosen path;
    pred_of_bp: int32[B, n] predecessor row of the chosen path per node
    (-1 where the path does not cover the node — reproduces the
    reference's predecessor=None fallback, pathwise_alignment_output.rs:31-47).
    Emits one step per iteration: main d/u/l recompute walk, then the
    trailing-L and (global) leading-U tails.

    ws (optional, int32[B, n]): per-row window starts for windowed
    planes (pathwise_window._fill_pathwise_win) — plane is then
    [B, n, W] and column j reads plane[b, i, j - ws[b, i]], NEG outside
    the window.  Sound whenever the windowed exit-bound guard passed:
    every cell on (or tied into) an optimal alignment is in-window and
    exact, so the recompute never needs an out-of-window value.
    """
    from ..scoring import GAP

    B, n, Lp = plane.shape
    pf = plane.reshape(B, n * Lp)
    bidx = jnp.arange(B)

    def at(i, j):
        if ws is None:
            return jnp.take_along_axis(pf, (i * Lp + j)[:, None], axis=1)[:, 0]
        base = jnp.take_along_axis(ws, i[:, None], axis=1)[:, 0]
        rel = j - base
        v = jnp.take_along_axis(
            pf, (i * Lp + jnp.clip(rel, 0, Lp - 1))[:, None], axis=1
        )[:, 0]
        return jnp.where((rel >= 0) & (rel < Lp), v, NEG)

    def cond(st):
        it, i, j, k, done, dirs, rows = st
        return (it < max_steps) & jnp.any(~done)

    def body(st):
        it, i, j, k, done, dirs, rows = st
        main = (i > 0) & (j > 0) & ~done
        ltail = (i == 0) & (j > 0) & ~done
        utail = jnp.bool_(global_mode) & (i > 0) & (j == 0) & ~done
        done_new = done | ~(main | ltail | utail)

        is_start = node_start[i]
        pred_e = jnp.take_along_axis(pred_of_bp, i[:, None], 1)[:, 0]
        covered = pred_e >= 0
        pred = jnp.where(is_start, jnp.where(covered, pred_e, i - 1), i - 1)
        code_i = codes[i]
        seq_j = jnp.take_along_axis(seq, j[:, None], 1)[:, 0]
        zero_case = is_start & ~covered
        d = jnp.where(zero_case, 0, at(jnp.where(is_start, jnp.maximum(pred_e, 0), i - 1), j - 1) + table[code_i, seq_j])
        u = jnp.where(zero_case, 0, at(jnp.where(is_start, jnp.maximum(pred_e, 0), i - 1), j) + table[code_i, GAP])
        l = jnp.where(zero_case, 0, at(i, j - 1) + table[GAP, seq_j])
        mx = jnp.maximum(jnp.maximum(d, u), l)
        is_d = mx == d
        is_u = ~is_d & (mx == u)
        match = seq_j == code_i
        code = jnp.where(is_d, jnp.where(match, D, LOW_D), jnp.where(is_u, U_DIR, L_DIR))
        code = jnp.where(ltail, L_DIR, code)
        code = jnp.where(utail, U_DIR, code)

        emit = main | ltail | utail
        # every active iteration emits exactly one step, so k == it and
        # a column write (O(B) in-place) replaces the per-lane scatter
        # that dominated walk time; done lanes write past their step
        # count (never read)
        dirs = jax.lax.dynamic_update_slice(
            dirs, jnp.where(emit, code, -1)[:, None], (0, it)
        )
        rows = jax.lax.dynamic_update_slice(
            rows, jnp.where(emit, i, 0)[:, None], (0, it)
        )

        i_new = jnp.where(main & (is_d | is_u), pred, i)
        i_new = jnp.where(utail, pred, i_new)
        j_new = jnp.where(main & (is_d | ~(is_d | is_u)), j - 1, j)
        j_new = jnp.where(ltail, j - 1, j_new)
        k = k + emit.astype(jnp.int32)
        return it + 1, i_new, j_new, k, done_new, dirs, rows

    def body2(st):
        # 2 steps per loop iteration: the step is ~20 tiny [B]-vector
        # ops whose fixed per-op cost dominates at these batch sizes,
        # and halving the iteration count halves that overhead
        # (mode-4 walks are ~n+L steps)
        return body(body(st))

    z = jnp.zeros((B,), jnp.int32)
    dirs0 = jnp.full((B, max_steps + 8), -1, jnp.int32)
    rows0 = jnp.zeros((B, max_steps + 8), jnp.int32)
    j0 = (L - 1) if start_j is None else start_j
    st = (jnp.int32(0), ending_node, j0, z, jnp.zeros((B,), bool), dirs0,
          rows0)
    _, i, j, k, done, dirs, rows = jax.lax.while_loop(cond, body2, st)
    return dirs, rows, k, i


_DIR_CHARS = {1: "D", 2: "d", 3: "L", 4: "U"}
# build_cigar's per-char flushing means at most one run counter is ever
# nonzero, so it reduces to run-length encoding over the mapped classes
# (D->M, d->X, L->D, U->I) — vectorised here (the Python per-step loop
# was 9s of the 10k-read stretch e2e)
_CIG_CLASS = np.array(["?", "M", "X", "D", "I"])


def _walk_meta(g):
    meta = g.__dict__.get("_walk_meta")
    if meta is None:
        ids = np.asarray(g.nodes_id_pos, dtype=np.int64)
        lnz = np.frombuffer(g.lnz.encode("latin1"), dtype=np.uint8)
        meta = (ids, lnz)
        g.__dict__["_walk_meta"] = meta
    return meta


def _record_from_walk(dirs, rows, n_steps, stop_i, g, bp, ending_node, score):
    """Assemble the GafRecord exactly as build_alignment does
    (oracle/pathwise.py — vectorised, byte-identical output)."""
    from ..oracle.pathwise import get_path_len_start_end

    ids, lnz = _walk_meta(g)
    d = np.asarray(dirs[:n_steps])
    r = np.asarray(rows[:n_steps])
    # forward order = reversed walk
    d_f = d[::-1]
    r_f = r[::-1]
    # CIGAR: RLE over classes in forward order
    if n_steps:
        cls = _CIG_CLASS[d_f]
        bnd = np.flatnonzero(cls[1:] != cls[:-1])
        starts = np.concatenate(([0], bnd + 1))
        ends = np.concatenate((bnd + 1, [n_steps]))
        cigar_str = "".join(
            f"{e - s}{cls[s]}" for s, e in zip(starts, ends)
        )
    else:
        cigar_str = ""
    on_node = (d_f == 1) | (d_f == 2) | (d_f == 4)
    sel = r_f[on_node]                                     # path order
    path_length = int(on_node.sum())
    h = ids[sel]
    if len(h):
        keep = np.empty(len(h), dtype=bool)
        keep[-1] = True
        # dedup is over the WALK order (reverse of path order)
        keep[:-1] = h[1:] != h[:-1]
        handle_dedup = [int(x) for x in h[keep]]
    else:
        handle_dedup = []
    path_seq = lnz[sel].tobytes().decode("latin1")
    path_len, path_start, path_end = get_path_len_start_end(
        ids, stop_i if stop_i == 0 else stop_i + 1, ending_node, path_length
    )
    comments = (
        f"{cigar_str}, best path: {bp}, score: {score}"
        f"\t{path_seq}"
    )
    return handle_dedup, path_len, path_start, path_end, comments


LONG_READ_LP = 1024   # mode-4 reads at least this long use windowed rows
_pw_w_hint: dict[tuple, int] = {}


def _rescore_walk(dirs_b, rows_b, ns, j0, codes, seqc, table, nstart,
                  covered) -> int:
    """Exact, plane-independent score of an emitted forward walk.

    Mirrors _walk_pathwise's value chain: on REP lanes the claimed
    plane value at the walk's start equals the sum of per-step
    increments down to the first zero-case restart cell (node start
    whose chosen path has no covered pred — its d/u/l candidates are
    the literal 0) or the terminal.  On follower lanes the stored
    (replayed) values do NOT telescope along the recomputed walk, so a
    mismatch is NOT proof of corruption — the opt-in windowed mode-8
    path uses this as a CONSERVATIVE acceptance filter (mismatch =>
    ladder/full-width fallback, never wrong output), which also
    catches genuinely derailed walks (measured r5).
    """
    from ..scoring import GAP as GAPC

    s = 0
    j = int(j0)
    for k in range(int(ns)):
        i = int(rows_b[k])
        c = int(dirs_b[k])
        if i > 0 and j > 0 and nstart[i] and not covered[i]:
            return s
        if c in (1, 2):
            s += int(table[codes[i], seqc[j]])
            j -= 1
        elif c == 4:
            s += int(table[codes[i], GAPC])
        else:
            s += int(table[GAPC, seqc[j]])
            j -= 1
    return s


def _graph_hint_key(g, dg) -> tuple:
    """Settled-window-hint key: a real graph+scoring-independent graph
    identity (n alone collided two same-size graphs — ADVICE r4)."""
    codes = np.asarray(g.codes)
    return (dg.n, dg.paths_number, hash(codes.tobytes()))


def run_batch_walks(mode, sequences, g, sm, chunk_bytes=None) -> list[GafRecord]:
    """Modes 4/5 with on-device traceback (planes never leave the device).

    Mode-4 batches with long reads route through the windowed O(W)-lane
    engine (ops/pathwise_window) — beat-the-reference capability: the
    reference is full-width here (pathwise_alignment.rs:16, O(n*L*P)
    memory).  Mode 5 has no windowed variant by design (a semiglobal
    alignment may start at column 0 of any row, which makes the exit
    bound vacuous — see pathwise_window._fill_pathwise_win).
    """
    from ..graph.pathgraph import pathwise_meta

    if chunk_bytes is None:
        chunk_bytes = 1 << 29      # 512 MB of score planes per chunk
    dg = path_device_graph(g)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    semiglobal = mode == 5
    rep_of, pred_of = pathwise_meta(g)
    pred_of_full = jnp.asarray(pred_of)                    # [n, P]
    Lp_all = _align_lp(sequences)
    # The windowed fill's non-rep replay is packed-chain ONLY (17-bit
    # col|value field): when 2*Lp*max|score| >= 2^16 the value spills
    # into the column bits and decodes as an OVERESTIMATE, which can
    # defeat the exit-bound guard (ADVICE r4, high).  Route such
    # batches to the full-width engine, whose encode_chain=False
    # variant is exact at any magnitude.
    fits = 2 * Lp_all * int(np.abs(np.asarray(table)).max()) < (1 << 16)
    if not semiglobal and Lp_all >= LONG_READ_LP and fits:
        return _run_batch_walks_win(
            sequences, g, dg, table, sm, pred_of_full, chunk_bytes
        )
    return _run_batch_walks_full(
        sequences, g, dg, table, sm, semiglobal, pred_of_full, Lp_all,
        chunk_bytes,
    )


def _run_batch_walks_full(sequences, g, dg, table, sm, semiglobal,
                          pred_of_full, Lp_all, chunk_bytes) -> list[GafRecord]:
    from ..metrics import phase
    from .traceback_engine import pack_walk16, pack_walk32, unpack_walk

    n, P = dg.n, dg.paths_number
    records = []
    per_read = P * n * Lp_all * 4
    chunk = max(1, int(chunk_bytes // per_read))
    W = n + Lp_all + 4
    fits = 2 * Lp_all * int(np.abs(np.asarray(table)).max()) < (1 << 16)
    node_start = jnp.asarray(g.node_start)
    # walks batch across fill chunks: each walk iteration is
    # latency-bound (~B-independent [B]-gathers on the plane), so one
    # walk over several chunks' extracted planes costs about what one
    # chunk-sized walk does.  Budget: extracted planes are P-free
    # (n * Lp * 4 bytes/read).
    walk_budget = 1 << 28
    walk_batch = max(1, int(walk_budget // (n * Lp_all * 4)))
    # (chunk_seqs, seq, L, planes, bp, node, score): whole padded chunks,
    # so every device array stays evenly split over a reads mesh; the
    # padding rows are walked too and dropped on the host
    pend: list = []
    pend_reads = 0

    def flush():
        nonlocal pend, pend_reads
        if not pend:
            return
        with phase("dispatch"):
            seqs_h, rows_h, off = [], [], 0
            for t in pend:
                seqs_h.extend(t[0])
                rows_h.extend(range(off, off + len(t[0])))
                off += t[1].shape[0]
            if len(pend) == 1:
                _, seq, L, planes, bp_d, node_d, sc_d = pend[0]
            else:
                seq, L, planes, bp_d, node_d, sc_d = (
                    jnp.concatenate([t[k] for t in pend], axis=0)
                    for k in range(1, 7)
                )
            pend = []
            pend_reads = 0
            B = seq.shape[0]
            pred_of_bp = jnp.take_along_axis(
                jnp.broadcast_to(pred_of_full.T[None], (B, P, n)),
                bp_d[:, None, None], axis=1,
            )[:, 0]
            dirs, rows, steps, stop_i = _walk_pathwise(
                planes, seq, L, table, node_start,
                dg.codes, pred_of_bp, node_d,
                global_mode=not semiglobal, max_steps=W,
            )
        with phase("device_wait"):
            kmax = min(W, (int(jax.device_get(steps.max())) + 63) // 64 * 64)
        pack = pack_walk16 if n <= 2048 else pack_walk32
        pk = pack(dirs[:, :kmax], rows[:, :kmax])
        with phase("fetch"):
            pk, steps, stop_i, bps, nodes, scores = jax.device_get(
                (pk, steps, stop_i, bp_d, node_d, sc_d)
            )
        dirs, rows = unpack_walk(pk)
        with phase("emit"):
            for b, s in zip(rows_h, seqs_h):
                handle_dedup, path_len, path_start, path_end, comments = (
                    _record_from_walk(
                        dirs[b], rows[b], int(steps[b]), int(stop_i[b]), g,
                        bps[b], nodes[b], scores[b],
                    )
                )
                records.append(
                    GafRecord(
                        query_name="Temp",
                        query_length=len(s) - 1,
                        query_start=0,
                        query_end=len(s) - 2,
                        strand="+",
                        path=handle_dedup,
                        path_length=path_len,
                        path_start=path_start,
                        path_end=path_end,
                        residue_matches_number=0,
                        alignment_block_length="*",
                        mapping_quality="*",
                        comments=comments,
                    )
                )

    for c0 in range(0, len(sequences), chunk):
        chunk_seqs = sequences[c0 : c0 + chunk]
        # keep every chunk the same compiled shape (trailing chunk pads
        # with read 0; padded lanes are dropped after the walk)
        pad_n = chunk - len(chunk_seqs) if c0 > 0 else 0
        enc_seqs = chunk_seqs + [chunk_seqs[0]] * pad_n
        with phase("encode"):
            seq, L = encode_reads(enc_seqs, pad_to=Lp_all)
        with phase("dispatch"):
            # fill + endings + plane extraction stay on device; the
            # walk runs later over a multi-chunk batch
            A = fill_pathwise_best(dg, table, seq, semiglobal, fits)
            fc = _final_column(A, L)
            if semiglobal:
                bp_d, node_d, sc_d = _endings_semiglobal_dev(
                    fc, dg.paths_on.T
                )
            else:
                bp_d, node_d, sc_d = _endings_global_dev(fc, *_end_meta(g))
            planes = _extract_plane(A, bp_d)
        del A
        pend.append((chunk_seqs, seq, L, planes, bp_d, node_d, sc_d))
        pend_reads += seq.shape[0]
        if pend_reads + chunk > walk_batch:
            flush()
    flush()
    return records


def _gaf_from_walk(dirs_b, rows_b, steps_b, stop_b, g, bp, node, score, s):
    handle_dedup, path_len, path_start, path_end, comments = _record_from_walk(
        dirs_b, rows_b, steps_b, stop_b, g, bp, node, score
    )
    return GafRecord(
        query_name="Temp",
        query_length=len(s) - 1,
        query_start=0,
        query_end=len(s) - 2,
        strand="+",
        path=handle_dedup,
        path_length=path_len,
        path_start=path_start,
        path_end=path_end,
        residue_matches_number=0,
        alignment_block_length="*",
        mapping_quality="*",
        comments=comments,
    )


def _run_batch_walks_win(sequences, g, dg, table, sm, pred_of_full,
                         chunk_bytes) -> list[GafRecord]:
    """Mode-4 long reads: windowed O(W)-lane fill with a W ladder.

    Per chunk, fills at width W (starting from the last width that
    worked for this graph), accepts every read whose windowed best
    final STRICTLY beats the exit bound (the guard of
    pathwise_window._fill_pathwise_win — all cells an optimal traceback
    can visit or tie into are then exact), and doubles W for the rest.
    Reads still failing at W >= Lp rerun through the exact full-width
    engine (visible: stderr line + pathwise_win_fullwidth counter).
    Memory per read is O(n*P*W) instead of the reference's O(n*P*L)
    (pathwise_alignment.rs:16).
    """
    import sys

    from .pathwise_window import _fill_pathwise_win, _final_column_win, _rmin

    n, P = dg.n, dg.paths_number
    rmin = jnp.asarray(_rmin(dg))
    node_start = jnp.asarray(g.node_start)
    Lp_all = _align_lp(sequences)
    hint_key = _graph_hint_key(g, dg)
    W0 = _pw_w_hint.get(hint_key, 256)
    if W0 >= Lp_all:   # stale hint from a longer-read batch
        W0 = 256
    max_steps = n + Lp_all + 4

    def win_pass(idxs, W):
        """One fill+guard+emit pass at width W; returns failed idxs."""
        sub = [sequences[i] for i in idxs]
        seq, L = encode_reads(sub, pad_to=Lp_all)
        Aw, ws, bound = _fill_pathwise_win(dg, table, seq, L, W, rmin)
        fcw = _final_column_win(Aw, ws, L)
        bp_d, node_d, sc_d = _endings_global_dev(fcw, *_end_meta(g))
        bps, nodes, scores, boundh = jax.device_get(
            (bp_d, node_d, sc_d, bound)
        )
        passed = [
            int(scores[b]) > int(boundh[b]) for b in range(len(sub))
        ]
        if any(passed):
            planes = _extract_plane(Aw, bp_d)              # [B, n, W]
            del Aw
            pred_of_bp = jnp.take_along_axis(
                jnp.broadcast_to(
                    pred_of_full.T[None], (seq.shape[0], P, n)
                ),
                bp_d[:, None, None], axis=1,
            )[:, 0]
            dirs, rows, steps, stop_i = _walk_pathwise(
                planes, seq, L, table, node_start, dg.codes,
                pred_of_bp, node_d,
                global_mode=True, max_steps=max_steps, ws=ws,
            )
            del planes
            from .traceback_engine import (
                pack_walk16, pack_walk32, unpack_walk,
            )

            kmax = min(
                max_steps,
                (int(jax.device_get(steps.max())) + 63) // 64 * 64,
            )
            pack = pack_walk16 if n <= 2048 else pack_walk32
            pk = pack(dirs[:, :kmax], rows[:, :kmax])
            pk, steps, stop_i = jax.device_get((pk, steps, stop_i))
            dirs, rows = unpack_walk(pk)
            # NOTE (r5, measured): windowed follower-lane cells can
            # OVER-estimate (rep-chain flips at window edges replay a
            # different direction), including final-column cells, so a
            # guard pass is not a proof — the r4 contract (W ladder +
            # full-width fallback + byte-equality fuzz pinning) stands
            # as the empirical defence.  An exact walk rescore CANNOT
            # tighten this: follower plane values do not telescope
            # along the recomputed walk (replay != max recompute), so
            # rescoring false-demotes legitimate follower-lane winners
            # (3/3 on the r5 corpus).  See PERF.md "windowed follower
            # soundness".
            for b, i_orig in enumerate(idxs):
                if passed[b]:
                    out[i_orig] = _gaf_from_walk(
                        dirs[b], rows[b], int(steps[b]), int(stop_i[b]),
                        g, bps[b], nodes[b], scores[b], sub[b],
                    )
        else:
            del Aw
        return [i for b, i in enumerate(idxs) if not passed[b]]

    out: dict[int, GafRecord] = {}
    fullwidth_idx: list[int] = []
    # chunk on the expected ladder width …
    chunk = max(1, int(chunk_bytes // (P * n * min(2 * W0, Lp_all) * 4)))
    for c0 in range(0, len(sequences), chunk):
        idxs = list(range(c0, min(c0 + chunk, len(sequences))))
        W = W0
        while idxs and W < Lp_all:
            # … but RE-chunk at every rung: W can double to ~Lp/2, and
            # rerunning a whole W0-sized chunk there holds Lp/(4*W0)x
            # the plane budget — the r4 B=32 worker OOM (ADVICE r4)
            rung = max(1, int(chunk_bytes // (P * n * W * 4)))
            failed: list[int] = []
            for s0 in range(0, len(idxs), rung):
                failed.extend(win_pass(idxs[s0 : s0 + rung], W))
            idxs = failed
            if not idxs:
                _pw_w_hint[hint_key] = W
            W *= 2
        fullwidth_idx.extend(idxs)
    if fullwidth_idx:
        from ..metrics import count_fallback

        for _ in fullwidth_idx:
            count_fallback("pathwise_win_fullwidth")
        print(
            f"recgraph: {len(fullwidth_idx)} long read(s) exceeded the "
            "windowed exit bound at every W; running full-width",
            file=sys.stderr,
        )
        sub = [sequences[i] for i in fullwidth_idx]
        recs = _run_batch_walks_full(
            sub, g, dg, table, sm, False, pred_of_full, _align_lp(sub),
            chunk_bytes,
        )
        for i, rec in zip(fullwidth_idx, recs):
            out[i] = rec
    return [out[i] for i in range(len(sequences))]
