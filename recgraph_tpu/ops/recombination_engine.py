"""Batched device kernels for recombination modes 8/9.

Three device phases (reference: src/pathwise_alignment_recombination.rs):

1. forward pathwise fill — reuses pathwise_engine._fill_pathwise
   (mode-4 recurrence for 8, mode-5 for 9; align :436-745);
2. reverse pathwise fill — the same group-semantics fill mirrored over
   the reverse graph (successor edges), scanning rows n-2..1 and
   columns right-to-left with suffix (max,+) chains (rev_align
   :129-435), including the reference's row-(n-1) delta quirk
   (absolute_scores stops before the last row, :747-757) and the
   never-written column 0;
3. split search — best_alignment (:759-873) as a `lax.scan` over the
   recombination column band; each step evaluates the full
   (forward node x reverse node) candidate plane
   m[i,j,fp(i)] + w[k,j,rp(k)] - (R + r*displacement[i,k]) in f32 and
   applies the reference's sequential tie rules (strict improvement, or
   equal score displaced only by the first `onedge` candidate).

Host work is only: baseline best-path selection from the forward final
column, and GAF traceback replay over two extracted score planes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.pathgraph import (
    PathGraph,
    nodes_displacement_matrix,
    pathwise_meta_rev,
)
from ..io.gaf import GafRecord
from ..oracle import recombination as rec_oracle
from ..scoring import GAP, SENTINEL
from .encode import PathDeviceGraph, path_device_graph, encode_reads
from . import pathwise_engine as pathwise_engine_mod
from .pathwise_engine import (
    _align_lp, _final_column, _extract_plane, _walk_pathwise,
    _record_from_walk, fill_pathwise_best,
)
from .poa_engine import (
    D as D_C, LOW_D as LOW_D_C, L_DIR as L_C, U_DIR as U_C,
    sub_planes, sub_row,
)

_DIRCH = {1: "D", 2: "d", 3: "L", 4: "U"}

NEG = -(1 << 28)
NEGF = jnp.float32(-3.0e38)


def rev_device_graph(rg: PathGraph) -> PathDeviceGraph:
    from .encode import _place_device_graph

    return _place_device_graph(
        rg, lambda: _build_rev_device_graph(rg), key="_device_graph_rev"
    )


def _build_rev_device_graph(rg: PathGraph) -> PathDeviceGraph:
    rep_of, pred_of, qsrc_of = pathwise_meta_rev(rg)
    dg = PathDeviceGraph(
        codes=jnp.asarray(rg.codes, dtype=jnp.int32),
        node_start=jnp.asarray(rg.node_start),
        paths_on=jnp.asarray(rg.paths_nodes),
        alphas=jnp.asarray(rg.alphas, dtype=jnp.int32),
        rep_of=jnp.asarray(rep_of),
        pred_of=jnp.asarray(pred_of),
        n=rg.n,
        paths_number=rg.paths_number,
        qsrc_of=jnp.asarray(qsrc_of),
    )
    return dg


def _suffix_cummax(x):
    from .poa_engine import cummax_last

    return cummax_last(x[..., ::-1])[..., ::-1]


@functools.partial(jax.jit, static_argnames=("encode_chain",))
def _fill_pathwise_rev(dg, table, seq, L, mode8, encode_chain=True):
    """Reverse fill over the reverse graph; returns W int32[B, P, n, Lp].

    ``seq`` is the forward '$'-prefixed read; the reverse read
    (get_rev_sequence: drop '$', append 'F') is derived on device.
    """
    n, P = dg.n, dg.paths_number
    B, Lp = seq.shape
    jcol = jnp.arange(Lp, dtype=jnp.int32)
    rev = jnp.roll(seq, -1, axis=1)
    rev = jnp.where(jcol[None, :] == (L - 1)[:, None], SENTINEL, rev)
    in_read = jcol[None, :] < L[:, None]
    gseq = jnp.where(in_read, table[rev, GAP], 0)          # [B, Lp]
    SUBP = sub_planes(table, rev)                          # [A, B, Lp]
    Gs = jnp.cumsum(gseq[:, ::-1], axis=1)[:, ::-1]        # suffix sums
    is_last = jcol[None, :] == (L - 1)[:, None]

    qdiag = jnp.arange(P)

    def step(carry, xs):
        A = carry                                          # [n, B, P, Lp]
        i, code_i, pvec, rvec, on, qsrc = xs
        gap_i = table[code_i, GAP]
        subrow = sub_row(SUBP, code_i)
        p_safe = jnp.maximum(pvec, 0)
        r_safe = jnp.maximum(rvec, 0)

        Arows = A[p_safe]                                  # [P, B, P, Lp]
        # own-plane source: qsrc == q except on delta-leak rows, where
        # a clone path reads its representative's plane instead; -1
        # marks ghost-alpha slots pinned to constant 0
        Aq = jnp.moveaxis(Arows[qdiag, :, jnp.maximum(qsrc, 0), :], 0, 1)
        Ar = jnp.take_along_axis(
            Arows, r_safe[:, None, None, None], axis=2
        )[:, :, 0, :]
        Ar = jnp.moveaxis(Ar, 0, 1)

        Ar_sh = jnp.roll(Ar, -1, axis=2).at[:, :, -1].set(NEG)
        d_r = Ar_sh + subrow[:, None, :]
        u_r = Ar + gap_i
        # restart at j == L-1: mode 8 U-only chain (:156-255), mode 9 zero
        Ar_last = jnp.take_along_axis(Ar, (L - 1)[:, None, None], axis=2)
        last_r = jnp.where(mode8, Ar_last[:, :, 0] + gap_i, 0)
        Achain = jnp.maximum(d_r, u_r)
        Achain = jnp.where(is_last[:, None, :], last_r[:, :, None], Achain)
        Achain = jnp.where(in_read[:, None, :], Achain, NEG)
        rep_row = Gs[:, None, :] + _suffix_cummax(Achain - Gs[:, None, :])

        dirD = rep_row == d_r
        dirU = ~dirD & (rep_row == u_r)
        nonL = dirD | dirU | is_last[:, None, :]

        Aq_sh = jnp.roll(Aq, -1, axis=2).at[:, :, -1].set(NEG)
        vD = Aq_sh + subrow[:, None, :]
        vU = Aq + gap_i
        Aq_last = jnp.take_along_axis(Aq, (L - 1)[:, None, None], axis=2)
        last_q = jnp.where(mode8, Aq_last[:, :, 0] + gap_i, 0)
        V = jnp.where(dirD, vD, vU)
        V = jnp.where(is_last[:, None, :], last_q[:, :, None], V)
        if encode_chain:
            # packed suffix chain (see _fill_pathwise): the suffix max
            # picks the nearest non-L column to the right
            OFF = 1 << 16
            enc = jnp.where(
                nonL, ((Lp - jcol) << 17) | (V - Gs[:, None, :] + OFF), -1
            )
            enc = _suffix_cummax(enc)
            row = Gs[:, None, :] + (enc & ((1 << 17) - 1)) - OFF
        else:
            kneg = _suffix_cummax(jnp.where(nonL, -jcol, NEG))
            kidx = jnp.maximum(-kneg, 0)
            Vk = jnp.take_along_axis(V, kidx, axis=2)
            Gk = jnp.take_along_axis(
                jnp.broadcast_to(Gs[:, None, :], V.shape), kidx, axis=2
            )
            row = Vk + Gs[:, None, :] - Gk
        row = jnp.where(on[None, :, None], row, 0)
        row = jnp.where((qsrc >= 0)[None, :, None], row, 0)
        row = jnp.where(in_read[:, None, :], row, 0)
        row = row.at[:, :, 0].set(0)                      # column 0 never written
        A = jax.lax.dynamic_update_slice(A, row[None], (i, 0, 0, 0))
        return A, None

    A0 = jnp.zeros((n, B, P, Lp), dtype=jnp.int32)
    # row n-1: all paths carry the suffix gap chain (rev_align :76-79);
    # column 0 and padding stay 0
    rown1 = jnp.where((jcol[None, :] > 0) & in_read, Gs, 0)
    A0 = A0.at[n - 1].set(rown1[:, None, :])

    rows = jnp.arange(n - 2, 0, -1, dtype=jnp.int32)
    sl = slice(n - 2, 0, -1)
    qsrc_all = dg.qsrc_of if dg.qsrc_of is not None else jnp.broadcast_to(
        jnp.arange(P, dtype=jnp.int32)[None], (n, P)
    )
    xs = (rows, dg.codes[sl], dg.pred_of[sl], dg.rep_of[sl], dg.paths_on[sl],
          qsrc_all[sl])
    A, _ = jax.lax.scan(step, A0, xs)
    A = jnp.moveaxis(A, 0, 2)                              # -> [B, P, n, Lp]
    # row n-1 delta quirk: only the alpha (path 0) plane keeps the chain
    A = A.at[:, 1:, n - 1, :].set(0)
    return A


@jax.jit
def _path_argmax(A):
    """Per-cell best path over ALL P planes; larger path id wins ties.

    Mirrors best_alignment's reversed argmax (:809-830).
    """
    P = A.shape[1]
    rev = A[:, ::-1]
    arg = (P - 1) - rev.argmax(axis=1).astype(jnp.int32)   # [B, n, Lp]
    mx = A.max(axis=1)
    return mx, arg


def _split_search_fn(I, Tc=None):
    """Split-search scan factory.

    ``Tc``: chunk width over the reverse-node axis.  The per-column
    candidate plane is O(I^2); chunking evaluates it [B, I, Tc] at a
    time and combines (max, first-flat-at-max, first-edge-at-max,
    edge-any) across chunks — exactly the unchunked first-best
    semantics (argmax picks the smallest flat index at the max; the
    chunked min over per-chunk minima is the same index).  Bounds
    memory for large graphs; Tc == I is the single-chunk fast case.
    """
    if Tc is None:
        Tc = I
    NC = -(-I // Tc)
    Ipad = NC * Tc
    BIG = jnp.int32(1 << 30)

    @jax.jit
    def run(cols, fmax, farg, vf, rmax, rarg, vr, penalty, diff_node, onedge,
            active, init_best):
        """Sequential column scan of best_alignment (:803-860).

        ``cols`` int32[C]: the (ascending) columns to evaluate — either
        every interior column, or the pruned candidate set from
        ``_candidate_columns`` (exactness argument there).  Padding
        entries may repeat column 0, which is never active.
        fmax/farg/vf: int32/int32/bool [B, I, Lp] over interior rows;
        penalty f32[I, I]; active bool[B, Lp]; init_best f32[B].
        Returns (best f32[B], taken bool[B], fen, rsn, fp, rp, rec_col).
        """
        B, _, Lp = fmax.shape
        kpad = Ipad - I
        rmax_p = jnp.pad(rmax, ((0, 0), (0, kpad), (0, 0)))
        rarg_p = jnp.pad(rarg, ((0, 0), (0, kpad), (0, 0)))
        vr_p = jnp.pad(vr, ((0, 0), (0, kpad), (0, 0)))  # False pad: invalid
        penalty_p = jnp.pad(penalty, ((0, 0), (0, kpad)))
        diff_node_p = jnp.pad(diff_node, ((0, 0), (0, kpad)))
        onedge_p = jnp.pad(onedge, ((0, 0), (0, kpad)))
        iidx = jnp.arange(I, dtype=jnp.int32)
        tidx = jnp.arange(Tc, dtype=jnp.int32)

        def step(carry, j):
            best, edge_state, taken, fen, rsn, fp, rp, col = carry
            fv = fmax[:, :, j].astype(jnp.float32)          # [B, I]
            fa = farg[:, :, j]
            vfj = vf[:, :, j]
            rv_all = rmax_p[:, :, j]
            ra_all = rarg_p[:, :, j]
            vr_all = vr_p[:, :, j]

            def chunk(c, cc):
                bestv, bflat, beflat, beany = cc
                k0 = c * Tc
                rvc = jax.lax.dynamic_slice(rv_all, (0, k0), (B, Tc))
                rac = jax.lax.dynamic_slice(ra_all, (0, k0), (B, Tc))
                vrc = jax.lax.dynamic_slice(vr_all, (0, k0), (B, Tc))
                penc = jax.lax.dynamic_slice(penalty_p, (0, k0), (I, Tc))
                dnc = jax.lax.dynamic_slice(diff_node_p, (0, k0), (I, Tc))
                onc = jax.lax.dynamic_slice(onedge_p, (0, k0), (I, Tc))
                cand = (
                    fv[:, :, None] + rvc[:, None, :].astype(jnp.float32)
                    - penc[None]
                )
                valid = (
                    dnc[None]
                    & (fa[:, :, None] != rac[:, None, :])
                    & vfj[:, :, None]
                    & vrc[:, None, :]
                )
                cv = jnp.where(valid, cand, NEGF).reshape(B, I * Tc)
                flatv = (
                    iidx[:, None] * I + k0 + tidx[None, :]
                ).reshape(1, I * Tc)
                cmax = cv.max(axis=1)
                atm = cv == cmax[:, None]
                fmin = jnp.min(jnp.where(atm, flatv, BIG), axis=1)
                ate = atm & onc.reshape(1, I * Tc)
                eany = ate.any(axis=1)
                femin = jnp.min(jnp.where(ate, flatv, BIG), axis=1)
                gtc = cmax > bestv
                eqc = cmax == bestv
                bflat = jnp.where(
                    gtc, fmin, jnp.where(eqc, jnp.minimum(bflat, fmin), bflat)
                )
                beflat = jnp.where(
                    gtc, femin,
                    jnp.where(eqc, jnp.minimum(beflat, femin), beflat),
                )
                beany = jnp.where(gtc, eany, beany | (eqc & eany))
                return (jnp.maximum(bestv, cmax), bflat, beflat, beany)

            col_max, flat_plain, flat_edge, edge_any = jax.lax.fori_loop(
                0, NC, chunk,
                (
                    jnp.full((B,), NEGF),
                    jnp.full((B,), BIG),
                    jnp.full((B,), BIG),
                    jnp.zeros((B,), bool),
                ),
            )
            flat_edge = jnp.where(edge_any, flat_edge, 0)
            flat_plain = jnp.minimum(flat_plain, I * I - 1)
            gt = col_max > best
            eq = col_max == best
            take = active[:, j] & (gt | (eq & ~edge_state & edge_any))
            use_edge = jnp.where(gt, edge_any, True)
            flat = jnp.where(use_edge, flat_edge, flat_plain)
            ii = (flat // I).astype(jnp.int32)
            kk = (flat % I).astype(jnp.int32)
            best = jnp.where(take, col_max, best)
            edge_state = jnp.where(take, use_edge, edge_state)
            taken = taken | take
            fen = jnp.where(take, ii + 1, fen)
            rsn = jnp.where(take, kk + 1, rsn)
            fp = jnp.where(take, jnp.take_along_axis(farg[:, :, j], ii[:, None], 1)[:, 0], fp)
            rp = jnp.where(take, jnp.take_along_axis(rarg[:, :, j], kk[:, None], 1)[:, 0], rp)
            col = jnp.where(take, j, col)
            return (best, edge_state, taken, fen, rsn, fp, rp, col), None

        z = jnp.zeros((B,), jnp.int32)
        carry = (
            init_best,
            jnp.zeros((B,), bool),
            jnp.zeros((B,), bool),
            z, z, z, z, z,
        )
        carry, _ = jax.lax.scan(step, carry, cols)
        best, edge_state, taken, fen, rsn, fp, rp, col = carry
        return best, taken, fen, rsn, fp, rp, col

    return run


_split_cache: dict[tuple, object] = {}


def _get_split(I, B):
    """Split scan for I interior rows at batch B; chunks the candidate
    plane when the single-chunk form would exceed ~256 MB."""
    plane = 4 * B * I * I
    if plane <= (1 << 28):
        Tc = I
    else:
        Tc = max(128, ((1 << 28) // (4 * B * I)) // 128 * 128)
    key = (I, Tc)
    split = _split_cache.get(key)
    if split is None:
        split = _split_search_fn(I, Tc)
        _split_cache[key] = split
    return split


@jax.jit
def _column_ub(fmax, vf, rmax, vr, wf, wr):
    """f32[B, Lp] per-column upper bound on the candidate-plane max.

    SURVEY §7.4.6's 4-sign decomposition of the displacement penalty:
    for every sign pair (s1, s2),
      -r(|Δdfs| + |Δdfe|) <= -r·s1·Δdfs - r·s2·Δdfe,
    so  cand[i,k] <= (fv_i - r(s1·dfs_i + s2·dfe_i))
                   + (rv_k + r(s1·dfs_k + s2·dfe_k)) - R,
    which is separable in i and k.  The min over the four sign cases of
    the separated maxes is an UPPER bound on the true column max — not
    the max itself (two coincident pairs with opposite-sign spreads
    break exactness) — which is all pruning needs.

    wf/wr: f32[4, I] = ∓r(s1·dfs + s2·dfe) per sign case (R folded in
    by the caller).  O(n) per column instead of the O(n²) plane.
    """
    fv = jnp.where(vf, fmax.astype(jnp.float32), NEGF)     # [B, I, Lp]
    rv = jnp.where(vr, rmax.astype(jnp.float32), NEGF)
    ub = None
    for s in range(4):
        a = jnp.max(fv + wf[s][None, :, None], axis=1)     # [B, Lp]
        b = jnp.max(rv + wr[s][None, :, None], axis=1)
        t = a + b
        ub = t if ub is None else jnp.minimum(ub, t)
    return ub


def _candidate_columns(split_inputs, dfs_i, dfe_i, base_rec_cost,
                       multi_rec_cost, active_np, init_best, Lp):
    """Ascending column set that can still affect the split search.

    Exactness: the scan's running best starts at the per-read baseline
    and never decreases, and a column is taken only when its max is
    > best or == best.  A column whose upper bound (``_column_ub``)
    is strictly below every read's baseline therefore can never be
    taken for any read; dropping it leaves the scan's carry — and so
    every tie decision — unchanged.  0.5 of slack absorbs f32
    round-off between the bound and the plane expressions (scores are
    integers and penalties multiples of r).

    Returns int32[C] columns, padded with 0 (never active) to the next
    power of two to bound jit retraces, or None to use the full range.
    """
    cols_full = np.arange(1, Lp - 1, dtype=np.int32)
    if Lp - 2 <= 8:
        return None
    fmax, farg, vf, rmax, rarg, vr = split_inputs
    r = np.float32(multi_rec_cost)
    signs = np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], np.float32)
    d = np.stack([dfs_i, dfe_i]).astype(np.float32)        # [2, I]
    wf = jnp.asarray(-(r * signs @ d))                     # [4, I]
    wr = jnp.asarray(r * signs @ d)
    ub = np.asarray(jax.device_get(_column_ub(fmax, vf, rmax, vr, wf, wr)))
    ub = ub - np.float32(base_rec_cost)
    keep = (ub + 0.5 >= init_best[:, None]) & active_np    # [B, Lp]
    cols = np.flatnonzero(keep.any(axis=0)).astype(np.int32)
    if len(cols) * 2 >= len(cols_full):
        return None                                        # no win: full scan
    C = 1 << max(int(np.ceil(np.log2(max(len(cols), 1)))), 2)
    out = np.zeros(C, dtype=np.int32)
    out[: len(cols)] = cols
    return out


_SUMMARY_K = 16
_summary_cache: dict[tuple, object] = {}


class _SplitGeometry:
    """O(n) split-search geometry: dfs/dfe distances, compacted node
    ids, and the onedge edge flags over interior rows.

    Replaces the O(n^2) displacement/penalty/diff-node/onedge planes
    (the reference materialises the full displacement matrix,
    pathwise_graph.rs:284-305): the guided search recomputes penalty
    chunks from these vectors on device, so modes 8/9 memory is O(n).
    The dense planes are built lazily only for the
    RECGRAPH_SPLIT_FULL=1 cross-check path.
    """

    def __init__(self, g, rg):
        n = g.n
        self.dfs = rg.distance_from_start_on_reverse()
        self.dfe = g.distance_from_end()
        ids = np.asarray(g.nodes_id_pos)
        interior = np.arange(1, n - 1)
        # equality-preserving compact ids (raw GFA ids may exceed int32)
        self.ids_i = np.unique(
            ids[interior], return_inverse=True
        )[1].astype(np.int32)
        self.fw_edge = ids[interior] != ids[interior + 1]
        self.rv_edge = ids[interior] != ids[interior - 1]
        self.dfs_i = self.dfs[interior]
        self.dfe_i = self.dfe[interior]

    def displacement(self, i: int, k: int) -> int:
        """dms[i, k] for absolute positions (0 on the diagonal)."""
        if i == k:
            return 0
        return int(
            abs(int(self.dfs[i]) - int(self.dfs[k]))
            + abs(int(self.dfe[i]) - int(self.dfe[k]))
        )

    def planes(self, base_rec_cost, multi_rec_cost):
        """(penalty f32, diff_node, onedge) dense interior planes."""
        disp = (
            np.abs(self.dfs_i[:, None] - self.dfs_i[None, :])
            + np.abs(self.dfe_i[:, None] - self.dfe_i[None, :])
        )
        penalty = (
            np.float32(base_rec_cost)
            + np.float32(multi_rec_cost) * disp.astype(np.float32)
        )
        diff_node = self.ids_i[:, None] != self.ids_i[None, :]
        onedge = self.fw_edge[:, None] & self.rv_edge[None, :]
        return (
            jnp.asarray(penalty), jnp.asarray(diff_node), jnp.asarray(onedge)
        )


def _col_summary_fn(I, Tc, K):
    """Per-column plane summaries for a given column set.

    Same [B, I, Tc]-chunked evaluation as ``_split_search_fn`` but with
    NO sequential carry: each column independently reduces to
    (col_max f32, edge_any, flat_edge, flat_plain) — everything the
    take/tie logic of best_alignment (:803-860) reads.  Used by the
    bound-guided search, which replays that logic on host.

    The displacement penalty and the node-id masks are computed on the
    fly per [I, Tc] chunk from the O(n) dfs/dfe/id vectors (chunks
    outer, the K columns inner, so each chunk builds them once) —
    modes 8/9 never materialise an O(n²) plane, which is what makes
    10^5-node graphs feasible (the reference holds the full
    displacement matrix, pathwise_graph.rs:284-305).
    """
    NC = -(-I // Tc)
    Ipad = NC * Tc
    BIG = jnp.int32(1 << 30)

    @jax.jit
    def run(cols, fmax, farg, vf, rmax, rarg, vr, dfs, dfe, ids, fwe, rve,
            Rr):
        B, _, Lp = fmax.shape
        kpad = Ipad - I
        rmax_p = jnp.pad(rmax, ((0, 0), (0, kpad), (0, 0)))
        rarg_p = jnp.pad(rarg, ((0, 0), (0, kpad), (0, 0)))
        vr_p = jnp.pad(vr, ((0, 0), (0, kpad), (0, 0)))
        dfs_p = jnp.pad(dfs, (0, kpad))
        dfe_p = jnp.pad(dfe, (0, kpad))
        ids_p = jnp.pad(ids, (0, kpad), constant_values=-1)
        rve_p = jnp.pad(rve, (0, kpad))
        iidx = jnp.arange(I, dtype=jnp.int32)
        tidx = jnp.arange(Tc, dtype=jnp.int32)

        # per-column slices of the forward/reverse summaries [B, I|Ipad, K]
        fvK = jnp.moveaxis(fmax[:, :, cols], 2, 0).astype(jnp.float32)
        faK = jnp.moveaxis(farg[:, :, cols], 2, 0)
        vfK = jnp.moveaxis(vf[:, :, cols], 2, 0)
        rvK = jnp.moveaxis(rmax_p[:, :, cols], 2, 0).astype(jnp.float32)
        raK = jnp.moveaxis(rarg_p[:, :, cols], 2, 0)
        vrK = jnp.moveaxis(vr_p[:, :, cols], 2, 0)

        def chunk(c, cc):
            bestv, bflat, beflat, beany = cc                # [K, B] each
            k0 = c * Tc
            dfs_k = jax.lax.dynamic_slice(dfs_p, (k0,), (Tc,))
            dfe_k = jax.lax.dynamic_slice(dfe_p, (k0,), (Tc,))
            ids_k = jax.lax.dynamic_slice(ids_p, (k0,), (Tc,))
            rve_k = jax.lax.dynamic_slice(rve_p, (k0,), (Tc,))
            # the product rounds on its own before the add, as on the
            # host and in the oracle: the barrier keeps the compiler
            # from fusing the two into one FMA, which rounds once
            rdisp = jax.lax.optimization_barrier(Rr[1] * (
                jnp.abs(dfs[:, None] - dfs_k[None, :])
                + jnp.abs(dfe[:, None] - dfe_k[None, :])
            ))
            penc = Rr[0] + rdisp                            # f32[I, Tc]
            dnc = ids[:, None] != ids_k[None, :]
            onc = (fwe[:, None] & rve_k[None, :]).reshape(1, I * Tc)
            flatv = (
                iidx[:, None] * I + k0 + tidx[None, :]
            ).reshape(1, I * Tc)

            def col_one(bv_t, bf_t, bef_t, bea_t, fv_t, fa_t, vf_t, rv_t,
                        ra_t, vr_t):
                rvc = jax.lax.dynamic_slice(rv_t, (0, k0), (B, Tc))
                rac = jax.lax.dynamic_slice(ra_t, (0, k0), (B, Tc))
                vrc = jax.lax.dynamic_slice(vr_t, (0, k0), (B, Tc))
                cand = fv_t[:, :, None] + rvc[:, None, :] - penc[None]
                valid = (
                    dnc[None]
                    & (fa_t[:, :, None] != rac[:, None, :])
                    & vf_t[:, :, None]
                    & vrc[:, None, :]
                )
                cv = jnp.where(valid, cand, NEGF).reshape(B, I * Tc)
                cmax = cv.max(axis=1)
                atm = cv == cmax[:, None]
                fmin = jnp.min(jnp.where(atm, flatv, BIG), axis=1)
                ate = atm & onc
                eany = ate.any(axis=1)
                femin = jnp.min(jnp.where(ate, flatv, BIG), axis=1)
                gtc = cmax > bv_t
                eqc = cmax == bv_t
                bf_t = jnp.where(
                    gtc, fmin, jnp.where(eqc, jnp.minimum(bf_t, fmin), bf_t)
                )
                bef_t = jnp.where(
                    gtc, femin,
                    jnp.where(eqc, jnp.minimum(bef_t, femin), bef_t),
                )
                bea_t = jnp.where(gtc, eany, bea_t | (eqc & eany))
                return jnp.maximum(bv_t, cmax), bf_t, bef_t, bea_t

            # columns are independent: sequentially map the per-column
            # update over the K axis (lax.map = one compiled program,
            # no K-batched intermediates; penc/dnc/onc stay hoisted)
            bestv, bflat, beflat, beany = jax.lax.map(
                lambda a: col_one(*a),
                (bestv, bflat, beflat, beany, fvK, faK, vfK, rvK, raK, vrK),
            )
            return (bestv, bflat, beflat, beany)

        col_max, flat_plain, flat_edge, edge_any = jax.lax.fori_loop(
            0, NC, chunk,
            (
                jnp.full((K, B), NEGF),
                jnp.full((K, B), BIG),
                jnp.full((K, B), BIG),
                jnp.zeros((K, B), bool),
            ),
        )
        flat_edge = jnp.where(edge_any, flat_edge, 0)
        flat_plain = jnp.minimum(flat_plain, I * I - 1)
        return tuple(
            jnp.moveaxis(o, 0, 1)
            for o in (col_max, edge_any, flat_edge, flat_plain)
        )                                                   # [B, K] each

    return run


def _run_split_guided(inputs, geom, active_np, init_best, base_rec_cost,
                      multi_rec_cost, I, Lp, ub_pre=None):
    """Bound-guided EXACT split search.

    The 4-sign upper bound (``_column_ub``) is measured near-tight
    (median gap 0 on the example corpus), so evaluating the O(I²)
    candidate plane only for columns whose bound can still reach the
    running per-read maximum finds the same result as the full column
    scan at a fraction of the work:

    1. compute ub[b, j] for every column — O(I) per column;
    2. repeatedly evaluate (device, in K-column batches) the columns
       with ub + 0.5 >= max(M_b, baseline_b) for some read b, where
       M_b is the max col_max seen so far — until none remain.  Any
       skipped column has col_max <= ub < max(M_b, baseline_b), so it
       could never equal the final maximum B*_b;
    3. replay best_alignment's take/tie chain (:803-860) on host over
       the evaluated columns in ascending order.  The chain's final
       state depends only on the ordered columns with
       col_max == B*_b (the first of them always takes; later ones
       only via the onedge == rule), and all of those are evaluated,
       so the replay is exact — including the f32 == comparisons,
       which use the very summaries the full scan would compare.

    The 0.5 slack absorbs f32 round-off between the separated bound
    and the plane expression (scores are integers, penalties multiples
    of the rec cost).
    """
    # under a data-parallel mesh the fill outputs are batch-sharded;
    # the host-driven rounds below would reshard them on every sliced
    # call — gather once instead (the split phase's plane work is a few
    # columns per read, single-device is the right place for it)
    sh = getattr(inputs[0], "sharding", None)
    if sh is not None and len(sh.device_set) > 1:
        dev0 = next(iter(sh.device_set))
        inputs = tuple(jax.device_put(x, dev0) for x in inputs)

    fmax, farg, vf, rmax, rarg, vr = inputs
    B = active_np.shape[0]

    if ub_pre is None:
        # ONE bound fetch for the whole batch (a device_get costs a
        # link round trip; computing it per sub-batch doubled the RTT
        # count of the whole search)
        r = np.float32(multi_rec_cost)
        signs = np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], np.float32)
        d = np.stack([geom.dfs_i, geom.dfe_i]).astype(np.float32)
        wf = jnp.asarray(-(r * signs @ d))
        wr = jnp.asarray(r * signs @ d)
        ub = np.asarray(
            jax.device_get(_column_ub(fmax, vf, rmax, vr, wf, wr))
        )
        ub = ub - np.float32(base_rec_cost)
        ub = np.where(active_np, ub, -np.inf)              # [B, Lp]
        ub[:, :1] = -np.inf
        ub[:, Lp - 1 :] = -np.inf
    else:
        ub = ub_pre

    # different reads peak at different columns, so the needed-column
    # union grows with the batch; sub-batching keeps it near the
    # per-read count (~1-3 on the example corpus)
    SB = 4
    if B > SB:
        outs = [
            _run_split_guided(
                tuple(x[b0 : b0 + SB] for x in inputs), geom,
                active_np[b0 : b0 + SB], init_best[b0 : b0 + SB],
                base_rec_cost, multi_rec_cost, I, Lp,
                ub_pre=ub[b0 : b0 + SB],
            )
            for b0 in range(0, B, SB)
        ]
        return tuple(np.concatenate(parts) for parts in zip(*outs))

    plane = 4 * B * I * I
    Tc = I if plane <= (1 << 28) else max(
        128, ((1 << 28) // (4 * B * I)) // 128 * 128
    )
    K = _SUMMARY_K
    key = (I, Tc, K)
    summarize = _summary_cache.get(key)
    if summarize is None:
        summarize = _col_summary_fn(I, Tc, K)
        _summary_cache[key] = summarize
    dfs_j = jnp.asarray(geom.dfs_i.astype(np.float32))
    dfe_j = jnp.asarray(geom.dfe_i.astype(np.float32))
    ids_j = jnp.asarray(geom.ids_i)
    fwe_j = jnp.asarray(geom.fw_edge)
    rve_j = jnp.asarray(geom.rv_edge)
    Rr = jnp.asarray(
        [np.float32(base_rec_cost), np.float32(multi_rec_cost)], jnp.float32
    )

    M = np.full(B, -np.inf, np.float32)
    thresh = np.maximum(M, init_best)
    evaluated: dict[int, tuple] = {}
    while True:
        needed = (ub + 0.5 >= thresh[:, None]).any(axis=0)
        needed[list(evaluated)] = False
        idx = np.flatnonzero(needed)
        if len(idx) == 0:
            break
        prio = (ub[:, idx] - thresh[:, None]).max(axis=0)
        take = idx[np.argsort(-prio)[:K]]
        cols = np.zeros(K, np.int32)
        cols[: len(take)] = take
        cm, ea, fe, fp_ = (
            np.asarray(jax.device_get(x))
            for x in summarize(
                jnp.asarray(cols), fmax, farg, vf, rmax, rarg, vr,
                dfs_j, dfe_j, ids_j, fwe_j, rve_j, Rr,
            )
        )
        for t, j in enumerate(take):
            evaluated[int(j)] = (cm[:, t], ea[:, t], fe[:, t], fp_[:, t])
        M = np.maximum(M, cm[:, : len(take)].max(axis=1))
        thresh = np.maximum(M, init_best)

    # host replay of the take/tie chain over evaluated columns
    best = init_best.astype(np.float32).copy()
    edge_state = np.zeros(B, bool)
    taken = np.zeros(B, bool)
    fen = np.zeros(B, np.int32)
    rsn = np.zeros(B, np.int32)
    fpo = np.zeros(B, np.int32)
    rpo = np.zeros(B, np.int32)
    col = np.zeros(B, np.int32)
    win_i = np.zeros(B, np.int32)
    win_k = np.zeros(B, np.int32)
    for j in sorted(evaluated):
        cm, ea, fe, fp_ = evaluated[j]
        gt = cm > best
        eq = cm == best
        take = active_np[:, j] & (gt | (eq & ~edge_state & ea))
        if not take.any():
            continue
        use_edge = np.where(gt, ea, True)
        flat = np.where(use_edge, fe, fp_).astype(np.int64)
        ii = (flat // I).astype(np.int32)
        kk = (flat % I).astype(np.int32)
        best = np.where(take, cm, best)
        edge_state = np.where(take, use_edge, edge_state)
        taken |= take
        fen = np.where(take, ii + 1, fen)
        rsn = np.where(take, kk + 1, rsn)
        col = np.where(take, j, col)
        win_i = np.where(take, ii, win_i)
        win_k = np.where(take, kk, win_k)
    if taken.any():
        # winner paths: farg/rarg at the taken (row, column) per read
        # (one combined fetch: each device_get costs a link RTT)
        bidx = jnp.arange(B)
        fpo, rpo = (
            np.asarray(x) for x in jax.device_get((
                farg[bidx, jnp.asarray(win_i), jnp.asarray(col)],
                rarg[bidx, jnp.asarray(win_k), jnp.asarray(col)],
            ))
        )
        fpo = np.where(taken, fpo, 0).astype(np.int32)
        rpo = np.where(taken, rpo, 0).astype(np.int32)
    return best, taken, fen, rsn, fpo, rpo, col


def _run_split(inputs, geom, active_np, init_best, base_rec_cost,
               multi_rec_cost, n, Lp):
    """Split search dispatcher; returns numpy outputs.

    The bound-guided search (``_run_split_guided``, O(n) memory) is the
    default; ``RECGRAPH_SPLIT_FULL=1`` forces the original full column
    scan over the dense planes (kept as the cross-check and for
    degenerate bound cases — the only path that still materialises
    O(n^2) state).
    """
    import os

    if Lp - 2 > 8 and not os.environ.get("RECGRAPH_SPLIT_FULL"):
        return _run_split_guided(
            inputs, geom, active_np, init_best,
            base_rec_cost, multi_rec_cost, n - 2, Lp,
        )
    penalty, diff_node, onedge = geom.planes(base_rec_cost, multi_rec_cost)
    split = _get_split(n - 2, active_np.shape[0])
    cols = _candidate_columns(
        inputs, geom.dfs_i, geom.dfe_i, base_rec_cost,
        multi_rec_cost, active_np, init_best, Lp,
    )
    if cols is None:
        cols = np.arange(1, Lp - 1, dtype=np.int32)
    fmax, farg, vf, rmax, rarg, vr = inputs
    return tuple(
        np.asarray(jax.device_get(x))
        for x in split(
            jnp.asarray(cols), fmax, farg, vf, rmax, rarg, vr,
            penalty, diff_node, onedge, jnp.asarray(active_np),
            jnp.asarray(init_best),
        )
    )


def _baseline(mode, finalcol_b, g):
    """No-recombination best score/path (:777-800); first-max tie order."""
    mx = None
    best_path = 0
    if mode == 8:
        for pred, paths in g.preds_and_paths(g.n - 1):
            for path in np.flatnonzero(paths):
                v = finalcol_b[path, pred]
                if mx is None or mx < v:
                    mx = v
                    best_path = int(path)
    else:
        for i in range(g.n - 1):
            for path in range(g.paths_number):
                if g.paths_nodes[i, path]:
                    v = finalcol_b[path, i]
                    if mx is None or mx < v:
                        mx = v
                        best_path = int(path)
    return np.float32(mx), best_path


def _oracle_fallback(
    mode, sequences, g, rg, sm, base_rec_cost, multi_rec_cost, rbw
) -> list[GafRecord]:
    """Scalar-oracle route for graphs whose reverse fill hits the
    delta-leak edge cases (pathwise_meta_rev raises NotImplementedError).

    The reference just runs these graphs
    (pathwise_alignment_recombination.rs:129-435); we match its output
    exactly through the per-cell port instead of the device engine.
    """
    import sys

    from ..metrics import count_fallback

    count_fallback("oracle_rec_89")
    print(
        "recgraph: reverse-fill edge case; modes 8/9 falling back to the "
        "scalar oracle for this graph",
        file=sys.stderr,
    )
    dms = nodes_displacement_matrix(g, rg)
    return [
        rec_oracle.exec_mode(
            mode, s, g, rg, sm, base_rec_cost, multi_rec_cost, dms, rbw
        )
        for s in sequences
    ]


def run_batch(
    mode, sequences, g, rg, sm, base_rec_cost, multi_rec_cost, rbw,
    chunk_bytes=1 << 29,
) -> list[GafRecord]:
    dg = path_device_graph(g)
    try:
        dgr = rev_device_graph(rg)
    except NotImplementedError:
        return _oracle_fallback(
            mode, sequences, g, rg, sm, base_rec_cost, multi_rec_cost, rbw
        )
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    n, P = dg.n, dg.paths_number
    I = n - 2

    # split-search geometry: O(n) vectors only (the penalty plane and
    # the onedge/diff-node masks, :837,:845-852, are recomputed in
    # chunks on device — no O(n^2) materialisation)
    geom = _SplitGeometry(g, rg)
    paths_on = jnp.asarray(g.paths_nodes)

    records: list[GafRecord] = []
    Lp_all = _align_lp(sequences)
    per_read = P * n * Lp_all * 4 * 2
    chunk = max(1, int(chunk_bytes // per_read))
    for c0 in range(0, len(sequences), chunk):
        from ..metrics import phase

        chunk_seqs = sequences[c0 : c0 + chunk]
        B = len(chunk_seqs)
        with phase("encode"):
            seq, L = encode_reads(chunk_seqs, pad_to=Lp_all)
        fits = 2 * seq.shape[1] * int(np.abs(np.asarray(table)).max()) < (1 << 16)
        with phase("dispatch"):
            Af = fill_pathwise_best(dg, table, seq, mode == 9, fits)
            Ar = pathwise_engine_mod.fill_pathwise_rev_best(
                dgr, table, seq, L, mode == 8, fits
            )
            fc_d = _final_column(Af, L)

        Bp = seq.shape[0]  # >= B when a data-parallel mesh pads the batch
        with phase("device_wait"):
            finalcol = np.asarray(jax.device_get(fc_d))
        init_best = np.zeros(Bp, dtype=np.float32)
        base_paths = np.zeros(Bp, dtype=np.int32)
        with phase("host_tb"):
            for b in range(B):
                init_best[b], base_paths[b] = _baseline(mode, finalcol[b], g)

        fmax, farg = _path_argmax(Af)
        rmax, rarg = _path_argmax(Ar)
        vf = jnp.take_along_axis(
            jnp.broadcast_to(paths_on[None], (Bp, n, P)), farg, axis=2
        )
        vr = jnp.take_along_axis(
            jnp.broadcast_to(paths_on[None], (Bp, n, P)), rarg, axis=2
        )
        jcol = np.arange(seq.shape[1])
        Lnp = np.asarray(jax.device_get(L))
        oob = np.maximum((Lnp * (1.0 - rbw) / 2.0).astype(np.int64), 1)
        active_np = (
            (jcol[None, :] >= oob[:, None]) & (jcol[None, :] < (Lnp - oob)[:, None])
        )
        best, taken, fen, rsn, fp, rp, rec_col = _run_split(
            (
                fmax[:, 1 : n - 1], farg[:, 1 : n - 1], vf[:, 1 : n - 1],
                rmax[:, 1 : n - 1], rarg[:, 1 : n - 1], vr[:, 1 : n - 1],
            ),
            geom, active_np, init_best,
            base_rec_cost, multi_rec_cost, n, seq.shape[1],
        )

        fp_final = np.where(taken, fp, base_paths)
        rp_final = np.where(taken, rp, base_paths)
        fplanes = np.asarray(
            jax.device_get(_extract_plane(Af, jnp.asarray(fp_final, jnp.int32)))
        )
        rplanes = np.asarray(
            jax.device_get(_extract_plane(Ar, jnp.asarray(rp_final, jnp.int32)))
        )
        del Af, Ar
        for b, s in enumerate(chunk_seqs):
            Lb = len(s)
            fplane = fplanes[b][:, :Lb]
            if fp_final[b] == rp_final[b]:
                bp = int(fp_final[b])
                if mode == 8:
                    end_node = 0
                    for node, paths in g.preds_and_paths(g.n - 1):
                        if paths[bp]:
                            end_node = node
                    records.append(
                        rec_oracle._gaf_no_rec(
                            fplane, g, s, sm, bp, end_node, global_tail=True
                        )
                    )
                else:
                    vals = finalcol[b, bp, 1 : g.n - 1].astype(np.int64)
                    covered = g.paths_nodes[1 : g.n - 1, bp]
                    vals = np.where(covered, vals, np.iinfo(np.int64).min)
                    end_node = 1 + int(vals.argmax())
                    records.append(
                        rec_oracle._gaf_no_rec(
                            fplane, g, s, sm, bp, end_node, global_tail=False
                        )
                    )
            else:
                rplane = rplanes[b][:, :Lb]
                records.append(
                    rec_oracle._gaf_rec(
                        fplane, rplane, g, rg, s, sm,
                        int(fp_final[b]), int(rp_final[b]),
                        int(fen[b]), int(rsn[b]), int(rec_col[b]),
                        (float(best[b]),
                         geom.displacement(int(fen[b]), int(rsn[b]))),
                        global_mode=(mode == 8),
                    )
                )
    return records


# ---------------------------------------------------------------------------
# on-device traceback (walks) for modes 8/9
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("global_mode", "max_steps"))
def _walk_reverse(plane, seq, L, table, node_start_rev, codes, succ_of_rp,
                  start_i, start_j, global_mode, max_steps, ws=None):
    """Reverse-matrix traceback (recombination_output.rs:39-98,:389-449).

    Walks from the split point towards the sinks: moves are i -> its
    successor on the chosen path (succ_of_rp, -1 off-path) and j -> j+1;
    rev_seq[j] == seq[j+1].  Emits (dir|flags, row); returns
    rev_ending_node (the i of the last main-loop cell, :481).

    ws (optional, int32[B, n]): per-row window starts for windowed
    planes (recombination_window) — plane is then [B, n, W] and
    column j reads plane[b, i, j - ws[b, i]], NEG outside (sound when
    the composite exit-bound guard passed).
    """
    from ..scoring import GAP as GAPC

    B, n, Lp = plane.shape
    pf = plane.reshape(B, n * Lp)
    bidx = jnp.arange(B)

    def at(i, j):
        if ws is None:
            return jnp.take_along_axis(
                pf, (i * Lp + j)[:, None], axis=1
            )[:, 0]
        base = jnp.take_along_axis(ws, i[:, None], axis=1)[:, 0]
        rel = j - base
        v = jnp.take_along_axis(
            pf, (i * Lp + jnp.clip(rel, 0, Lp - 1))[:, None], axis=1
        )[:, 0]
        return jnp.where((rel >= 0) & (rel < Lp), v, NEG)

    def cond(st):
        it, i, j, k, done, rev_end, dirs, rows = st
        return (it < max_steps) & jnp.any(~done)

    def body(st):
        it, i, j, k, done, rev_end, dirs, rows = st
        main = (i > 0) & (i < n - 1) & (j < L - 1) & ~done
        ltail = (j < L - 1) & ~main & ~done
        utail = jnp.bool_(global_mode) & (i < n - 1) & (j >= L - 1) & ~main & ~ltail & ~done
        done_new = done | ~(main | ltail | utail)

        is_end = node_start_rev[i]                      # marked node ends
        succ_e = jnp.take_along_axis(succ_of_rp, i[:, None], 1)[:, 0]
        covered = succ_e >= 0
        succ = jnp.where(is_end, jnp.where(covered, succ_e, i + 1), i + 1)
        code_i = codes[i]
        rseq_j = jnp.take_along_axis(seq, jnp.minimum(j + 1, Lp - 1)[:, None], 1)[:, 0]
        zero_case = is_end & ~covered
        s_row = jnp.where(is_end, jnp.maximum(succ_e, 0), i + 1)
        d = jnp.where(zero_case, 0, at(s_row, j + 1) + table[code_i, rseq_j])
        u = jnp.where(zero_case, 0, at(s_row, j) + table[code_i, GAPC])
        l = jnp.where(zero_case, 0, at(i, j + 1) + table[GAPC, rseq_j])
        mx = jnp.maximum(jnp.maximum(d, u), l)
        is_d = mx == d
        is_u = ~is_d & (mx == u)
        match = rseq_j == code_i
        code = jnp.where(is_d, jnp.where(match, D_C, LOW_D_C),
                         jnp.where(is_u, U_C, L_C))
        code = jnp.where(ltail, L_C, code)
        code = jnp.where(utail, U_C, code)

        rev_end = jnp.where(main, i, rev_end)
        emit = main | ltail | utail
        # column write at the loop index (k == it while active; see
        # pathwise_engine._walk_pathwise)
        dirs = jax.lax.dynamic_update_slice(
            dirs, jnp.where(emit, code, -1)[:, None], (0, it)
        )
        rows = jax.lax.dynamic_update_slice(
            rows, jnp.where(emit, i, 0)[:, None], (0, it)
        )

        i_new = jnp.where(main & (is_d | is_u), succ, i)
        i_new = jnp.where(utail, succ, i_new)
        j_new = jnp.where(main & (is_d | ~(is_d | is_u)), j + 1, j)
        j_new = jnp.where(ltail, j + 1, j_new)
        k = k + emit.astype(jnp.int32)
        return it + 1, i_new, j_new, k, done_new, rev_end, dirs, rows

    def body2(st):
        # 2 steps/iteration (see pathwise_engine._walk_pathwise)
        return body(body(st))

    z = jnp.zeros((B,), jnp.int32)
    dirs0 = jnp.full((B, max_steps + 8), -1, jnp.int32)
    rows0 = jnp.zeros((B, max_steps + 8), jnp.int32)
    st = (jnp.int32(0), start_i, start_j, z, jnp.zeros((B,), bool),
          start_i, dirs0, rows0)
    _, i, j, k, done, rev_end, dirs, rows = jax.lax.while_loop(
        cond, body2, st
    )
    return dirs, rows, k, rev_end


def _walk_pieces(dirs, rows, n_steps, ids, lnz):
    """(cigar chars, handles, path chars, path_length) from one walk."""
    cigar, handles, pseq = [], [], []
    plen = 0
    for k in range(n_steps):
        c = int(dirs[k])
        cigar.append(_DIRCH[c])
        if c in (1, 2, 4):
            r = int(rows[k])
            handles.append(int(ids[r]))
            pseq.append(lnz[r])
            plen += 1
    return cigar, handles, pseq, plen


def _gaf_rec_from_walks(fw, rv, g, fp, rp, fen, rsn, rev_ending_node,
                        best_score, seq_len):
    """Stitch forward+reverse walks into the rec GAF record.

    Mirrors _gaf_rec (recombination_output.rs:12-237,:363-631) with the
    walks replacing the matrix re-walk.
    """
    from ..oracle.gaf_emit import build_cigar
    from ..oracle.recombination import get_node_offset, get_rec_path_len_start_end, _fmt_f32

    ids = g.nodes_id_pos
    fw_cig, fw_h, fw_ps, fw_len, stop_i = fw
    rv_cig, rv_h, rv_ps, rv_len = rv
    rec_edge = len(fw_ps) - 1
    fw_cig = list(reversed(fw_cig)) + rv_cig
    handles = list(reversed(fw_h)) + rv_h
    handles_d = []
    for h in handles:
        if not handles_d or handles_d[-1] != h:
            handles_d.append(h)
    pseq = "".join(reversed(fw_ps)) + "".join(rv_ps)
    start = stop_i if stop_i == 0 else stop_i + 1
    path_len, path_start, path_end = get_rec_path_len_start_end(
        ids, fen, rsn, start, rev_ending_node, fw_len, rv_len
    )
    fen_off = get_node_offset(ids, fen)
    rsn_off = get_node_offset(ids, rsn)
    recombination = (
        f"recombination path {fp} {rp}, "
        f"nodes {ids[fen]}[{fen_off}] {ids[rsn]}[{rsn_off}], "
        f"score: {_fmt_f32(best_score[0])}, displacement: {best_score[1]}"
        f"\t{pseq}\t{rec_edge}"
    )
    return GafRecord(
        query_name="Temp",
        query_length=seq_len - 1,
        query_start=0,
        query_end=seq_len - 2,
        strand="+",
        path=handles_d,
        path_length=path_len,
        path_start=path_start,
        path_end=path_end,
        residue_matches_number=0,
        alignment_block_length="*",
        mapping_quality="*",
        comments=f"{build_cigar(fw_cig)}, {recombination}",
    )


def run_batch_walks(
    mode, sequences, g, rg, sm, base_rec_cost, multi_rec_cost, rbw,
    chunk_bytes=None, no_window=False,
) -> list[GafRecord]:
    """Modes 8/9 with on-device traceback (planes stay on device)."""
    from ..graph.pathgraph import pathwise_meta

    if chunk_bytes is None:
        chunk_bytes = 1 << 29      # 512 MB of plane pairs per chunk
    dg = path_device_graph(g)
    try:
        dgr = rev_device_graph(rg)
    except NotImplementedError:
        return _oracle_fallback(
            mode, sequences, g, rg, sm, base_rec_cost, multi_rec_cost, rbw
        )
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    n, P = dg.n, dg.paths_number
    I = n - 2
    lnz = g.lnz
    ids = g.nodes_id_pos

    # split-search geometry: O(n) vectors only (the penalty plane and
    # the onedge/diff-node masks, :837,:845-852, are recomputed in
    # chunks on device — no O(n^2) materialisation)
    geom = _SplitGeometry(g, rg)
    paths_on = jnp.asarray(g.paths_nodes)
    rep_f, pred_f = pathwise_meta(g)
    pred_f_full = jnp.asarray(pred_f)                      # [n, P] fwd preds
    rep_r, pred_r, _qsrc_r = pathwise_meta_rev(rg)
    pred_r_full = jnp.asarray(pred_r)                      # [n, P] successors

    records: list[GafRecord] = []
    Lp_all = _align_lp(sequences)
    # long-read mode 8 can route through the windowed O(W)-lane pair
    # (ops/recombination_window) — the reference is full-width on BOTH
    # matrices (pathwise_alignment_recombination.rs:129-435).
    # OPT-IN (RECGRAPH_REC_WINDOW=1), not default: the split search
    # reads EVERY plane cell, and windowed follower-replay cells can
    # both over- and under-estimate (measured r5, PERF.md "windowed
    # mode-8 soundness"); the exit-bound guard plus the exact
    # acceptance rescores prevent invalid or mis-scored output, but an
    # in-window follower underestimate can still hide the reference's
    # optimum and emit a valid lower-scoring alignment.  Mode 9 has no
    # windowed variant by design (semiglobal-style endings make the
    # exit bound vacuous — see recombination_window docstring); the
    # packed-chain fits gate mirrors run_batch_walks for mode 4.
    import os as _os

    fits_all = (
        2 * Lp_all * int(np.abs(np.asarray(table)).max()) < (1 << 16)
    )
    if (
        mode == 8
        and not no_window
        and _os.environ.get("RECGRAPH_REC_WINDOW") == "1"
        and fits_all
        and Lp_all >= pathwise_engine_mod.LONG_READ_LP
    ):
        return _run_batch_walks_win8(
            sequences, g, rg, sm, base_rec_cost, multi_rec_cost, rbw,
            dg, dgr, table, geom, paths_on, pred_f_full, pred_r_full,
            chunk_bytes,
        )
    per_read = P * n * Lp_all * 4 * 2
    chunk = max(1, int(chunk_bytes // per_read))
    W = n + Lp_all + 4
    for c0 in range(0, len(sequences), chunk):
        from ..metrics import phase

        chunk_seqs = sequences[c0 : c0 + chunk]
        B = len(chunk_seqs)
        with phase("encode"):
            seq, L = encode_reads(chunk_seqs, pad_to=Lp_all)
        fits = 2 * seq.shape[1] * int(np.abs(np.asarray(table)).max()) < (1 << 16)
        with phase("dispatch"):
            Af = fill_pathwise_best(dg, table, seq, mode == 9, fits)
            Ar = pathwise_engine_mod.fill_pathwise_rev_best(
                dgr, table, seq, L, mode == 8, fits
            )
            fc_d = _final_column(Af, L)

        Bp = seq.shape[0]  # >= B when a data-parallel mesh pads the batch
        with phase("device_wait"):
            finalcol = np.asarray(jax.device_get(fc_d))
        init_best = np.zeros(Bp, dtype=np.float32)
        base_paths = np.zeros(Bp, dtype=np.int32)
        with phase("host_tb"):
            for b in range(B):
                init_best[b], base_paths[b] = _baseline(mode, finalcol[b], g)

        fmax, farg = _path_argmax(Af)
        rmax, rarg = _path_argmax(Ar)
        vf = jnp.take_along_axis(
            jnp.broadcast_to(paths_on[None], (Bp, n, P)), farg, axis=2
        )
        vr = jnp.take_along_axis(
            jnp.broadcast_to(paths_on[None], (Bp, n, P)), rarg, axis=2
        )
        jcol = np.arange(seq.shape[1])
        Lnp = np.asarray(jax.device_get(L))
        oob = np.maximum((Lnp * (1.0 - rbw) / 2.0).astype(np.int64), 1)
        active_np = (
            (jcol[None, :] >= oob[:, None]) & (jcol[None, :] < (Lnp - oob)[:, None])
        )
        with phase("split"):
            best, taken, fen, rsn, fp, rp, rec_col = _run_split(
                (
                    fmax[:, 1 : n - 1], farg[:, 1 : n - 1], vf[:, 1 : n - 1],
                    rmax[:, 1 : n - 1], rarg[:, 1 : n - 1], vr[:, 1 : n - 1],
                ),
                geom, active_np, init_best,
                base_rec_cost, multi_rec_cost, n, seq.shape[1],
            )
        fp_final = np.where(taken, fp, base_paths)
        rp_final = np.where(taken, rp, base_paths)

        # per-read forward walk start: (fen, rec_col) when a split was
        # taken, else the mode's no-rec ending at the last column
        # (padded rows start at (0,0): immediately-done walks)
        start_i = np.zeros(Bp, dtype=np.int32)
        start_j = np.zeros(Bp, dtype=np.int32)
        for b in range(B):
            if taken[b]:
                start_i[b] = fen[b]
                start_j[b] = rec_col[b]
            else:
                bp = int(fp_final[b])
                if mode == 8:
                    end_node = 0
                    for node, paths in g.preds_and_paths(g.n - 1):
                        if paths[bp]:
                            end_node = node
                else:
                    vals = finalcol[b, bp, 1 : g.n - 1].astype(np.int64)
                    covered = g.paths_nodes[1 : g.n - 1, bp]
                    vals = np.where(covered, vals, np.iinfo(np.int64).min)
                    end_node = 1 + int(vals.argmax())
                start_i[b] = end_node
                start_j[b] = Lnp[b] - 1

        fp_j = jnp.asarray(fp_final, jnp.int32)
        rp_j = jnp.asarray(rp_final, jnp.int32)
        fplane = _extract_plane(Af, fp_j)
        rplane = _extract_plane(Ar, rp_j)
        pred_of_bp = jnp.take_along_axis(
            jnp.broadcast_to(pred_f_full.T[None], (Bp, P, n)),
            fp_j[:, None, None], axis=1,
        )[:, 0]
        succ_of_rp = jnp.take_along_axis(
            jnp.broadcast_to(pred_r_full.T[None], (Bp, P, n)),
            rp_j[:, None, None], axis=1,
        )[:, 0]
        fdirs, frows, fsteps, fstop = _walk_pathwise(
            fplane, seq, L, table, jnp.asarray(g.node_start), dg.codes,
            pred_of_bp, jnp.asarray(start_i), global_mode=(mode == 8),
            max_steps=W, start_j=jnp.asarray(start_j),
        )
        rdirs, rrows, rsteps, rev_end = _walk_reverse(
            rplane, seq, L, table, jnp.asarray(rg.node_start), dg.codes,
            succ_of_rp, jnp.asarray(rsn.astype(np.int32)),
            jnp.asarray(rec_col.astype(np.int32)),
            global_mode=(mode == 8), max_steps=W,
        )
        del Af, Ar, fplane, rplane
        kf = min(W, (int(jax.device_get(fsteps.max())) + 255) // 256 * 256)
        kr = min(W, (int(jax.device_get(rsteps.max())) + 255) // 256 * 256)
        fdirs, frows = fdirs[:, :kf], frows[:, :kf]
        rdirs, rrows = rdirs[:, :kr], rrows[:, :kr]
        with phase("fetch"):
            (fdirs, frows, fsteps, fstop, rdirs, rrows, rsteps,
             rev_end) = jax.device_get(
                (fdirs, frows, fsteps, fstop, rdirs, rrows, rsteps, rev_end)
            )
        with phase("emit"):
            records.extend(
                _records_from_rec_walks(
                    chunk_seqs, g, geom, finalcol, start_i, fp_final,
                    rp_final, best, fen, rsn, fdirs, frows, fsteps,
                    fstop, rdirs, rrows, rsteps, rev_end,
                )
            )
    return records


def _records_from_rec_walks(chunk_seqs, g, geom, finalcol, start_i,
                            fp_final, rp_final, best, fen, rsn,
                            fdirs, frows, fsteps, fstop,
                            rdirs, rrows, rsteps, rev_end):
    """Assemble per-read GafRecords from fetched walk arrays (shared by
    the full-width and windowed mode-8 paths)."""
    ids = g.nodes_id_pos
    lnz = g.lnz
    out = []
    for b, s in enumerate(chunk_seqs):
        bp = int(fp_final[b])
        fw_cig, fw_h, fw_ps, fw_len = _walk_pieces(
            fdirs[b], frows[b], int(fsteps[b]), ids, lnz
        )
        if fp_final[b] == rp_final[b]:
            score = int(finalcol[b, bp, start_i[b]])
            hd, plen, pstart, pend, comments = _record_from_walk(
                fdirs[b], frows[b], int(fsteps[b]), int(fstop[b]), g,
                bp, int(start_i[b]), score,
            )
            # no-rec comments have no path-seq difference: identical
            out.append(
                GafRecord(
                    query_name="Temp",
                    query_length=len(s) - 1,
                    query_start=0,
                    query_end=len(s) - 2,
                    strand="+",
                    path=hd,
                    path_length=plen,
                    path_start=pstart,
                    path_end=pend,
                    residue_matches_number=0,
                    alignment_block_length="*",
                    mapping_quality="*",
                    comments=comments,
                )
            )
        else:
            rv = _walk_pieces(rdirs[b], rrows[b], int(rsteps[b]), ids, lnz)
            out.append(
                _gaf_rec_from_walks(
                    (fw_cig, fw_h, fw_ps, fw_len, int(fstop[b])),
                    rv, g, int(fp_final[b]), int(rp_final[b]),
                    int(fen[b]), int(rsn[b]), int(rev_end[b]),
                    (float(best[b]),
                     geom.displacement(int(fen[b]), int(rsn[b]))),
                    len(s),
                )
            )
    return out


def _rescore_walk_rev(dirs_b, rows_b, ns, j0, codes, seqc, Lr, table,
                      nstart_r, covered_r, n) -> int:
    """Exact, plane-independent score of an emitted reverse walk
    (mirror of pathwise_engine._rescore_walk; rev[j] = seq[j+1] with
    the SENTINEL at j = L-1, moves go right)."""
    s = 0
    j = int(j0)
    for k in range(int(ns)):
        i = int(rows_b[k])
        c = int(dirs_b[k])
        if 0 < i < n - 1 and j < Lr - 1 and nstart_r[i] and not covered_r[i]:
            return s
        rs = int(seqc[j + 1]) if j + 1 < Lr else SENTINEL
        if c in (1, 2):
            s += int(table[codes[i], rs])
            j += 1
        elif c == 4:
            s += int(table[codes[i], GAP])
        else:
            s += int(table[GAP, rs])
            j += 1
    return s


def _run_batch_walks_win8(sequences, g, rg, sm, base_rec_cost,
                          multi_rec_cost, rbw, dg, dgr, table, geom,
                          paths_on, pred_f_full, pred_r_full,
                          chunk_bytes) -> list[GafRecord]:
    """Mode-8 long reads: windowed O(W)-lane fill PAIR with a W ladder.

    Per chunk, fills both matrices at width W, materialises the
    P-free full-width (max, arg, valid) arrays the split search
    consumes (recombination_window.full_from_win), runs the UNCHANGED
    split search, and accepts every read whose combined best STRICTLY
    beats the composite exit bound (recombination_window.
    composite_bound) — all cells any optimal solution (no-rec or rec)
    can visit or tie into are then in-window and exact, so walks over
    the windowed planes emit byte-identical GAF.  Failures double W;
    at W >= Lp the read reruns through the exact full-width engine.
    Memory per read: 2*O(n*P*W) planes + O(n*L) search arrays instead
    of the reference's 2*O(n*P*L) planes
    (pathwise_alignment_recombination.rs:129-435).
    """
    import sys

    from ..metrics import count_fallback
    from . import recombination_window as rw
    from .pathwise_engine import _graph_hint_key, _pw_w_hint
    from .pathwise_window import _fill_pathwise_win, _final_column_win, _rmin

    n, P = dg.n, dg.paths_number
    rmin = jnp.asarray(_rmin(dg))
    node_start = jnp.asarray(g.node_start)
    node_start_rev = jnp.asarray(rg.node_start)
    Lp_all = _align_lp(sequences)
    smax = jnp.maximum(jnp.max(table), 0)
    hint_key = _graph_hint_key(g, dg) + ("rec8",)
    W0 = _pw_w_hint.get(hint_key, 256)
    if W0 >= Lp_all:
        W0 = 256
    max_steps = n + Lp_all + 4
    # precompute the mode-8 no-rec ending per path (graph-only)
    end_node_of = np.zeros(P, dtype=np.int32)
    for node, paths in g.preds_and_paths(g.n - 1):
        for p in np.flatnonzero(paths):
            end_node_of[p] = node
    # host metadata for the exact acceptance rescores
    pred_f_np = np.asarray(pred_f_full)
    pred_r_np = np.asarray(pred_r_full)
    nstart_np = np.asarray(g.node_start)
    nstart_r_np = np.asarray(rg.node_start)
    codes_np = np.asarray(g.codes)
    table_np = np.asarray(table)

    def win_pass(idxs, W):
        sub = [sequences[i] for i in idxs]
        seq, L = encode_reads(sub, pad_to=Lp_all)
        B = seq.shape[0]
        Awf, wsf, bound_f = _fill_pathwise_win(dg, table, seq, L, W, rmin)
        Awr, wsr, Rr_d = rw._fill_pathwise_rev_win(dgr, table, seq, L, W)
        fmax_w, farg_w = _path_argmax(Awf)                 # [B, n, W]
        rmax_w, rarg_w = _path_argmax(Awr)
        negf = jnp.full((B, 1, Lp_all), NEG, jnp.int32)
        zf = jnp.zeros((B, 1, Lp_all), jnp.int32)
        fmax = rw.full_from_win(fmax_w, wsf, negf)
        farg = rw.full_from_win(farg_w, wsf, zf)
        rmax = rw.full_from_win(rmax_w, wsr, negf)
        rarg = rw.full_from_win(rarg_w, wsr, zf)
        covered_f = fmax > NEG // 2
        covered_r = rmax > NEG // 2
        vf = jnp.take_along_axis(
            jnp.broadcast_to(paths_on[None], (B, n, P)), farg, axis=2
        ) & covered_f
        vr = jnp.take_along_axis(
            jnp.broadcast_to(paths_on[None], (B, n, P)), rarg, axis=2
        ) & covered_r
        # composite exit-bound guard inputs
        F = jnp.max(fmax[:, 1 : n - 1], axis=1)            # [B, Lp]
        G = jnp.max(rmax[:, 1 : n - 1], axis=1)
        Rf_d = bound_f - smax * (L - 1)
        gbound = rw.composite_bound(F, G, Rf_d, Rr_d, L, smax)
        gbound = jnp.maximum(gbound, bound_f.astype(jnp.float32))

        finalcol = np.asarray(jax.device_get(_final_column_win(Awf, wsf, L)))
        init_best = np.zeros(B, dtype=np.float32)
        base_paths = np.zeros(B, dtype=np.int32)
        for b in range(B):
            init_best[b], base_paths[b] = _baseline(8, finalcol[b], g)
        jcol = np.arange(Lp_all)
        Lnp = np.asarray(jax.device_get(L))
        oob = np.maximum((Lnp * (1.0 - rbw) / 2.0).astype(np.int64), 1)
        active_np = (
            (jcol[None, :] >= oob[:, None])
            & (jcol[None, :] < (Lnp - oob)[:, None])
        )
        best, taken, fen, rsn, fp, rp, rec_col = _run_split(
            (
                fmax[:, 1 : n - 1], farg[:, 1 : n - 1], vf[:, 1 : n - 1],
                rmax[:, 1 : n - 1], rarg[:, 1 : n - 1], vr[:, 1 : n - 1],
            ),
            geom, active_np, init_best,
            base_rec_cost, multi_rec_cost, n, Lp_all,
        )
        gb_h = np.asarray(jax.device_get(gbound))
        passed = [float(best[b]) > float(gb_h[b]) for b in range(B)]
        if any(passed):
            fp_final = np.where(taken, fp, base_paths)
            rp_final = np.where(taken, rp, base_paths)
            start_i = np.zeros(B, dtype=np.int32)
            start_j = np.zeros(B, dtype=np.int32)
            for b in range(B):
                if taken[b]:
                    start_i[b] = fen[b]
                    start_j[b] = rec_col[b]
                else:
                    start_i[b] = end_node_of[int(fp_final[b])]
                    start_j[b] = Lnp[b] - 1
            fp_j = jnp.asarray(fp_final, jnp.int32)
            rp_j = jnp.asarray(rp_final, jnp.int32)
            fplane = _extract_plane(Awf, fp_j)             # [B, n, W]
            rplane = _extract_plane(Awr, rp_j)
            del Awf, Awr
            pred_of_bp = jnp.take_along_axis(
                jnp.broadcast_to(pred_f_full.T[None], (B, P, n)),
                fp_j[:, None, None], axis=1,
            )[:, 0]
            succ_of_rp = jnp.take_along_axis(
                jnp.broadcast_to(pred_r_full.T[None], (B, P, n)),
                rp_j[:, None, None], axis=1,
            )[:, 0]
            fdirs, frows, fsteps, fstop = _walk_pathwise(
                fplane, seq, L, table, node_start, dg.codes,
                pred_of_bp, jnp.asarray(start_i), global_mode=True,
                max_steps=max_steps, start_j=jnp.asarray(start_j),
                ws=wsf,
            )
            rdirs, rrows, rsteps, rev_end = _walk_reverse(
                rplane, seq, L, table, node_start_rev, dg.codes,
                succ_of_rp, jnp.asarray(rsn.astype(np.int32)),
                jnp.asarray(rec_col.astype(np.int32)),
                global_mode=True, max_steps=max_steps, ws=wsr,
            )
            del fplane, rplane
            kf = min(
                max_steps,
                (int(jax.device_get(fsteps.max())) + 63) // 64 * 64,
            )
            kr = min(
                max_steps,
                (int(jax.device_get(rsteps.max())) + 63) // 64 * 64,
            )
            bidx = jnp.arange(B)
            fsel_d = fmax[
                bidx, jnp.asarray(fen, jnp.int32),
                jnp.asarray(rec_col, jnp.int32),
            ]
            rsel_d = rmax[
                bidx, jnp.asarray(rsn, jnp.int32),
                jnp.asarray(rec_col, jnp.int32),
            ]
            (fdirs, frows, fsteps, fstop, rdirs, rrows, rsteps,
             rev_end, fsel, rsel) = jax.device_get(
                (fdirs[:, :kf], frows[:, :kf], fsteps, fstop,
                 rdirs[:, :kr], rrows[:, :kr], rsteps, rev_end,
                 fsel_d, rsel_d)
            )
            # exact acceptance rescores (follower replay flips can
            # overestimate windowed cells — a guard pass alone cannot
            # certify the record; mismatch -> ladder/fallback)
            from ..metrics import count_fallback as _cf
            from ..scoring import encode as _encode

            for b in range(len(sub)):
                if not passed[b]:
                    continue
                seqc = _encode(sub[b])
                Lb = len(sub[b])
                vf_claim = (
                    int(fsel[b]) if taken[b]
                    else int(finalcol[b, int(fp_final[b]), start_i[b]])
                )
                vs = pathwise_engine_mod._rescore_walk(
                    fdirs[b], frows[b], int(fsteps[b]), int(start_j[b]),
                    codes_np, seqc, table_np, nstart_np,
                    pred_f_np[:, int(fp_final[b])] >= 0,
                )
                ok = vs == vf_claim
                if ok and taken[b]:
                    vr = _rescore_walk_rev(
                        rdirs[b], rrows[b], int(rsteps[b]),
                        int(rec_col[b]), codes_np, seqc, Lb, table_np,
                        nstart_r_np, pred_r_np[:, int(rp_final[b])] >= 0,
                        n,
                    )
                    ok = vr == int(rsel[b])
                if not ok:
                    passed[b] = False
                    _cf("rec_win_rescore")
            recs = _records_from_rec_walks(
                sub, g, geom, finalcol, start_i, fp_final, rp_final,
                best, fen, rsn, fdirs, frows, fsteps, fstop,
                rdirs, rrows, rsteps, rev_end,
            )
            for b, i_orig in enumerate(idxs):
                if passed[b]:
                    out[i_orig] = recs[b]
        else:
            del Awf, Awr
        return [i for b, i in enumerate(idxs) if not passed[b]]

    out: dict[int, GafRecord] = {}
    fullwidth_idx: list[int] = []
    per_read0 = 2 * P * n * min(2 * W0, Lp_all) * 4 + 18 * n * Lp_all
    chunk = max(1, int(chunk_bytes // per_read0))
    for c0 in range(0, len(sequences), chunk):
        idxs = list(range(c0, min(c0 + chunk, len(sequences))))
        W = W0
        while idxs and W < Lp_all:
            per_read = 2 * P * n * W * 4 + 18 * n * Lp_all
            rung = max(1, int(chunk_bytes // per_read))
            failed: list[int] = []
            for s0 in range(0, len(idxs), rung):
                failed.extend(win_pass(idxs[s0 : s0 + rung], W))
            idxs = failed
            if not idxs:
                _pw_w_hint[hint_key] = W
            W *= 2
        fullwidth_idx.extend(idxs)
    if fullwidth_idx:
        for _ in fullwidth_idx:
            count_fallback("rec_win_fullwidth")
        print(
            f"recgraph: {len(fullwidth_idx)} long read(s) exceeded the "
            "windowed mode-8 exit bound at every W; running full-width",
            file=sys.stderr,
        )
        sub = [sequences[i] for i in fullwidth_idx]
        recs = run_batch_walks(
            8, sub, g, rg, sm, base_rec_cost, multi_rec_cost, rbw,
            chunk_bytes=chunk_bytes, no_window=True,
        )
        for i, rec in zip(fullwidth_idx, recs):
            out[i] = rec
    return [out[i] for i in range(len(sequences))]
