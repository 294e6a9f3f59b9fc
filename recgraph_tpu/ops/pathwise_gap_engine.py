"""Batched device fill for experimental pathwise affine-gap modes 6/7.

Unlike modes 4/5 (dense absolute scores, ops/pathwise_engine.py), modes
6/7 must reproduce the reference's alpha/delta *compressed* matrices
bit-for-bit: the delta form is observable in its output (gap-run
extension during traceback compares delta-form dpm vs x/y entries
directly, pathwise_alignment_output.rs:272,289, and the mask_q filter
quirk at pathwise_alignment_gap.rs:336-343 leaks deltas between
groups).  So this engine computes dpm/x/y exactly as the scalar oracle
(oracle/pathwise_gap.fill) does, in delta form, on device.

Design:

- one `lax.scan` over DP rows that EMITS each finished [B, P, Lp] row
  as a stacked scan output and CARRIES only the previous row plus a
  compact ring of the pred (node-end) rows — carrying the full
  [n, B, P, Lp] planes made XLA lay them out batch-minor (4x pad) and
  copy them at every lax.cond boundary;
- substitution planes are gathered once per fill ([A, B, Lp]) and all
  in-scan lane reads are dynamic_slices;
- ~97% of rows (non-start rows + single-pred node starts whose group
  representative is the row alpha) run a closed-form vector program:
  the in-row affine coupling collapses to one (max,+) cummax chain on
  the alpha lane (chaining through intermediate dpm cells never beats
  direct extension for o <= 0), and the delta-lane copies are pure
  selections replayed from the alpha lane's selectors — the same
  program as the oracle's `_fill_row_vec`, vectorised over the batch;
- the rare multi-pred / re-alpha'd rows (32 of 1331 on the example
  graph) run the literal per-column program — per-pred-block
  sequential lane overwrites, the mask_q quirk, and the multi-alpha
  delta fixup — as an inner `lax.scan` over columns under a scalar
  `lax.cond`, so easy rows never pay for it;
- block metadata (pred row, representative lane, member masks,
  first-occurrence flags and final member sets for the insertion-order
  fixup) is precompiled on host by :func:`gap_meta`.

Traceback stays on host (modes 6/7 print a CIGAR, not GAF —
main.rs:271-288): the device extracts the four planes the walk
actually reads (dpm on the best path and on each row's alpha lane, x/y
on the best path) and :func:`walk_gap_planes` replays the oracle's
delta-form walk over them.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.pathgraph import PathGraph
from ..oracle.gaf_emit import build_cigar
from ..scoring import ScoreMatrix


# ---------------------------------------------------------------------------
# host metadata
# ---------------------------------------------------------------------------


class RejectedGraph(ValueError):
    """The reference itself rejects this graph (a predecessor block
    sharing no path with its node panics in pathwise_alignment_gap.rs's
    common-paths indexing).  Callers may fall back to the scalar oracle
    for EXACTLY this case; any other engine error must propagate."""


@dataclass
class GapMeta:
    """Per-row static metadata for the device fill (all numpy)."""

    n: int
    P: int
    maxb: int
    codes: np.ndarray          # int32[n]
    alphas: np.ndarray         # int32[n]
    node_start: np.ndarray     # bool[n]
    # easy-row program (interior columns)
    easy: np.ndarray           # bool[n]
    pr: np.ndarray             # int32[n]  predecessor row
    eap: np.ndarray            # int32[n]  predecessor alpha lane
    edelta: np.ndarray         # bool[n]   pred alpha outside common set
    emask: np.ndarray          # bool[n,P] common minus row alpha
    # first-column program for non-start rows (mode 6)
    fap: np.ndarray            # int32[n]  alphas[i-1]
    fcommon_ap: np.ndarray     # bool[n]   common[i-1-alpha]
    fmask: np.ndarray          # bool[n,P] (pn[i] & pn[i-1]) minus alpha
    # hard-row / node-start block program
    bvalid: np.ndarray         # bool[n,MB]
    bpred: np.ndarray          # int32[n,MB]
    bap: np.ndarray            # int32[n,MB] pred alpha
    btb: np.ndarray            # int32[n,MB] written ("temp alpha") lane
    bdelta: np.ndarray         # bool[n,MB]  pred alpha outside common
    bcase1: np.ndarray         # bool[n,MB]  rep case (ap in common)
    bmask: np.ndarray          # bool[n,MB,P] common minus tb
    bmaskq: np.ndarray         # bool[n,MB,P] common minus alpha (mask_q quirk)
    bfirst: np.ndarray         # bool[n,MB]  first slot with this tb
    bfixmem: np.ndarray        # bool[n,MB,P] final members minus tb (fixup)
    # compact pred-row ring (device fill carries only these rows)
    ring_s: int                # ring size S (reads stay < S writes apart)
    eslot: np.ndarray          # int32[n]  ring slot of the easy-row pred
    bslot: np.ndarray          # int32[n,MB] ring slot per block pred
    wslot: np.ndarray          # int32[n]  write slot (S = dummy, not a pred)
    # hard-row last-writer owner maps (vectorised per-column program):
    # each block's per-column writes hit maskb|{tb}, later blocks
    # overwrite earlier ones, so the final lane value is the owning
    # (last-writing) block's formula — selected by one-hot instead of a
    # sequential per-block where-chain
    bown: np.ndarray           # bool[n,MB,P] lane owned by block s
    bfire: np.ndarray          # bool[n,MB]  fixup fires (valid&first&tb!=ai)
    bisa: np.ndarray           # bool[n,MB]  the fire block whose fixmem
                               #   contains the row alpha (at most one)
    bafter: np.ndarray         # bool[n,MB]  fire blocks ordered after it


def gap_meta(g: PathGraph) -> GapMeta:
    """Row classification + padded block metadata (see module docstring).

    Raises :class:`RejectedGraph` for graphs the reference itself
    rejects (a predecessor block sharing no path with the node) so
    callers can fall back to the scalar oracle, which raises the same
    way.  Real engine bugs raise other exception types and propagate.
    """
    n, P = g.n, g.paths_number
    pn = g.paths_nodes
    alphas = np.asarray(g.alphas, dtype=np.int32)
    node_start = np.asarray(g.node_start, dtype=bool)
    codes = np.asarray(g.codes, dtype=np.int32)

    maxb = 1
    rows_blocks: list[list] = [[] for _ in range(n)]
    for i in range(1, n - 1):
        if node_start[i]:
            rows_blocks[i] = g.preds_and_paths(i)
            maxb = max(maxb, len(rows_blocks[i]))

    easy = np.zeros(n, dtype=bool)
    pr = np.zeros(n, dtype=np.int32)
    eap = np.zeros(n, dtype=np.int32)
    edelta = np.zeros(n, dtype=bool)
    emask = np.zeros((n, P), dtype=bool)
    fap = np.zeros(n, dtype=np.int32)
    fcommon_ap = np.zeros(n, dtype=bool)
    fmask = np.zeros((n, P), dtype=bool)
    MB = maxb
    bvalid = np.zeros((n, MB), dtype=bool)
    bpred = np.zeros((n, MB), dtype=np.int32)
    bap = np.zeros((n, MB), dtype=np.int32)
    btb = np.zeros((n, MB), dtype=np.int32)
    bdelta = np.zeros((n, MB), dtype=bool)
    bcase1 = np.zeros((n, MB), dtype=bool)
    bmask = np.zeros((n, MB, P), dtype=bool)
    bmaskq = np.zeros((n, MB, P), dtype=bool)
    bfirst = np.zeros((n, MB), dtype=bool)
    bfixmem = np.zeros((n, MB, P), dtype=bool)

    for i in range(1, n - 1):
        ai = int(alphas[i])
        if not node_start[i]:
            common = pn[i] & pn[i - 1]
            ap = int(alphas[i - 1])
            easy[i] = True
            pr[i] = i - 1
            eap[i] = ap
            edelta[i] = not common[ap] if ap < P else True
            emask[i] = common.copy()
            emask[i, ai] = False
            fap[i] = ap
            fcommon_ap[i] = common[ap] if ap < P else False
            fmask[i] = emask[i]
            continue

        blocks = rows_blocks[i]
        # block metadata (used by the first-column program for every
        # node-start row, and by the interior program for hard rows)
        members_of: dict[int, np.ndarray] = {}
        for s, (p, p_paths) in enumerate(blocks):
            common = pn[i] & p_paths
            if not common.any():
                raise RejectedGraph(f"empty common-paths set at row {i}")
            ap = int(alphas[p])
            case1 = ap < P and bool(common[ap])
            if case1:
                tb = ap
            else:
                tb = ai if common[ai] else int(np.flatnonzero(common)[0])
            bvalid[i, s] = True
            bpred[i, s] = p
            bap[i, s] = ap
            btb[i, s] = tb
            bdelta[i, s] = not case1
            bcase1[i, s] = case1
            bmask[i, s] = common.copy()
            bmask[i, s, tb] = False
            bmaskq[i, s] = common.copy()
            bmaskq[i, s, ai] = False
            if tb not in members_of:
                bfirst[i, s] = True
            members_of[tb] = common
        for s in range(len(blocks)):
            if bfirst[i, s]:
                m = members_of[int(btb[i, s])].copy()
                m[int(btb[i, s])] = False
                bfixmem[i, s] = m

        if len(blocks) == 1:
            p, p_paths = blocks[0]
            common = pn[i] & p_paths
            ap = int(alphas[p])
            if ap < P and (
                (common[ap] and ap == ai) or (not common[ap] and common[ai])
            ):
                easy[i] = True
                pr[i] = p
                eap[i] = ap
                edelta[i] = not common[ap]
                emask[i] = common.copy()
                emask[i, ai] = False

    # ---- compact pred-row ring layout -----------------------------------
    # Block preds are always node-end rows (pathwise_graph preds_and_paths
    # keys are pred END positions) or row 0; the device fill keeps only
    # those rows (plus the previous row) in a ring carry instead of
    # carrying the full [n, B, P, Lp] planes.  S is the smallest ring
    # where every read happens fewer than S ring-writes after its slot
    # was written (the compact span of PoaDeviceGraph, per block).
    pred_rows = {0}
    for i in range(1, n - 1):
        if node_start[i]:
            for p, _ in rows_blocks[i]:
                pred_rows.add(int(p))
    pred_list = sorted(pred_rows)
    rank = {p: k for k, p in enumerate(pred_list)}
    import bisect

    S = 1
    for i in range(1, n - 1):
        if node_start[i]:
            cnt_before = bisect.bisect_left(pred_list, i)
            for p, _ in rows_blocks[i]:
                S = max(S, cnt_before - rank[int(p)])
    eslot = np.zeros(n, dtype=np.int32)
    bslot = np.full((n, MB), S, dtype=np.int32)
    wslot = np.full(n, S, dtype=np.int32)
    for p, k in rank.items():
        wslot[p] = k % S
    bown = np.zeros((n, MB, P), dtype=bool)
    bfire = np.zeros((n, MB), dtype=bool)
    bisa = np.zeros((n, MB), dtype=bool)
    bafter = np.zeros((n, MB), dtype=bool)
    for i in range(1, n - 1):
        if node_start[i]:
            if easy[i]:
                eslot[i] = rank[int(pr[i])] % S
            nb = len(rows_blocks[i])
            for s in range(nb):
                bslot[i, s] = rank[int(bpred[i, s])] % S
            ownid = np.full(P, -1, dtype=np.int64)
            ai = int(alphas[i])
            saw_sa = False
            for s in range(nb):
                wset = bmask[i, s].copy()
                wset[int(btb[i, s])] = True
                ownid[wset] = s
                fire = bool(bfirst[i, s]) and int(btb[i, s]) != ai
                bfire[i, s] = fire
                if fire:
                    bafter[i, s] = saw_sa
                    if bfixmem[i, s, ai]:
                        bisa[i, s] = True
                        saw_sa = True
            bown[i] = ownid[None, :] == np.arange(MB)[:, None]

    return GapMeta(
        n=n, P=P, maxb=MB, codes=codes, alphas=alphas, node_start=node_start,
        easy=easy, pr=pr, eap=eap, edelta=edelta, emask=emask,
        fap=fap, fcommon_ap=fcommon_ap, fmask=fmask,
        bvalid=bvalid, bpred=bpred, bap=bap, btb=btb, bdelta=bdelta,
        bcase1=bcase1, bmask=bmask, bmaskq=bmaskq, bfirst=bfirst,
        bfixmem=bfixmem,
        ring_s=S, eslot=eslot, bslot=bslot, wslot=wslot,
        bown=bown, bfire=bfire, bisa=bisa, bafter=bafter,
    )


# ---------------------------------------------------------------------------
# device fill
# ---------------------------------------------------------------------------


def _lane(v, a):
    """v[:, a] for a scalar (possibly traced) lane index a; v: [B, P] or
    [B, P, Lp], as a dynamic_slice rather than a traced-index gather."""
    if v.ndim == 2:
        return jax.lax.dynamic_slice(v, (0, a), (v.shape[0], 1))[:, 0]
    return jax.lax.dynamic_slice(
        v, (0, a, 0), (v.shape[0], 1, v.shape[2]))[:, 0]


_NEGC = -(1 << 30)


def _cummax_lanes(x):
    """Running max along the last axis as a log-depth shift-max chain
    (static pad-shifted maxima; the pads are _NEGC)."""
    W = x.shape[-1]
    d = 1
    while d < W:
        sh = jnp.concatenate(
            [jnp.full(x.shape[:-1] + (d,), _NEGC, x.dtype), x[..., :-d]],
            axis=-1,
        )
        x = jnp.maximum(x, sh)
        d *= 2
    return x


@functools.partial(
    jax.jit,
    static_argnames=("maxb", "semiglobal", "ring_s", "fits", "force_easy"),
)
def _fill_gap(xs_meta, codes, alphas, node_start, table, seq, o, e,
              maxb, semiglobal, ring_s, fits=False, force_easy=False):
    """Scan-over-rows delta-form fill.

    Returns (dpm, x, y) each int32[n, B, P, Lp] matching the oracle's
    [n, L, P] matrices (transposed, batched) exactly on real columns.

    The scan CARRIES only the previous row plus a compact ring of the
    pred (node-end) rows — ring_s slots sized by gap_meta so no slot is
    overwritten before its last read — and EMITS each finished row as a
    stacked scan output.  Carrying the full [n, B, P, Lp] planes instead
    made XLA copy them at every lax.cond boundary.
    """
    (easy, pr, eap, edelta, emask, fap, fcommon_ap, fmask,
     bvalid, bpred, bap, btb, bdelta, bcase1, bmask, bmaskq, bfirst,
     bfixmem, eslot, bslot, wslot, bown, bfire, bisa, bafter) = xs_meta
    S = ring_s
    n = codes.shape[0]
    P = emask.shape[1]
    B, Lp = seq.shape
    MB = maxb
    jcol = jnp.arange(Lp, dtype=jnp.int32)
    lane_i = jnp.arange(P, dtype=jnp.int32)
    o = jnp.int32(o)
    e = jnp.int32(e)
    # substitution planes for every code, gathered once; each row takes
    # its code's plane with a leading-axis dynamic_slice
    SUB = jnp.take(table, seq, axis=1)                      # [A, B, Lp]

    def fc_nonstart(Xp0, i, ai, args):
        """_fill_first_col_gap non-start branch (gap.rs:35-75); x0 == d0.

        Xp0: int32[B, P] — column 0 of row i-1's x plane (hoisted by the
        caller so this branch never touches the scan carries)."""
        ap, cap, maskc = args
        xp_ai = _lane(Xp0, ai)
        xp_ap = _lane(Xp0, ap)
        # common[ap] branch vs not, i==1 special in both
        x_ai_t = jnp.where(i == 1, o + e, xp_ai + e)
        x_ai_f = jnp.where(i == 1, o + e, xp_ai + xp_ap + e)
        x_ai = jnp.where(cap, x_ai_t, x_ai_f)
        xm = jnp.where(cap, Xp0, Xp0 - xp_ai[:, None])
        x0 = jnp.where(maskc[None, :], xm, 0)
        x0 = jnp.where((lane_i == ai)[None, :], x_ai[:, None], x0)
        return x0

    def fc_start(Xp0s, i, ai, hard_ops):
        """_fill_first_col_gap node-start branch (gap.rs:76-147); x0 == d0.

        Xp0s: int32[MB, B, P] — column 0 of each pred block's x-plane row
        (hoisted by the caller)."""
        (valid, pred, ap, tb, delta, case1, maskb, maskq, first, fixmem) = (
            hard_ops[:10]
        )
        x0 = jnp.zeros((B, P), jnp.int32)
        for s in range(MB):
            Xp0 = Xp0s[s]
            xp_tb = _lane(Xp0, tb[s])
            xp_ap = _lane(Xp0, ap[s])
            d_s = delta[s].astype(jnp.int32)
            x_tb = jnp.where(pred[s] == 0, o + e, xp_tb + d_s * xp_ap + e)
            xm = Xp0 - d_s[None] * xp_tb[:, None]
            w = valid[s]
            x0 = jnp.where(w & maskb[s][None, :], xm, x0)
            x0 = jnp.where(w & (lane_i == tb[s])[None, :], x_tb[:, None], x0)
        # insertion-order fixup over x (dpm mirrors x; gap.rs:133-147)
        for s in range(MB):
            fire = valid[s] & first[s] & (tb[s] != ai)
            va = _lane(x0, tb[s]) - _lane(x0, ai)
            x0 = jnp.where(
                fire & (lane_i == tb[s])[None, :], va[:, None], x0
            )
            x0 = jnp.where(fire & fixmem[s][None, :], x0 + va[:, None], x0)
        return x0

    def easy_row(prevD, prevY, i, ai, x0, args):
        """The closed-form vector row (oracle _fill_row_vec), batched.

        prevD/prevY: int32[B, P, Lp] — the pred row's planes (hoisted)."""
        p, ap, delta, mask = args
        sub = jax.lax.dynamic_slice(SUB, (codes[i], 0, 0), (1, B, Lp))[0]
        d32 = delta.astype(jnp.int32)
        pD_ap = _lane(prevD, ap)                            # [B, Lp]
        pD_ai = _lane(prevD, ai)
        pY_ap = _lane(prevY, ap)
        pY_ai = _lane(prevY, ai)

        u_y = pY_ap + d32 * pY_ai + e
        u_dpm = pD_ap + d32 * pD_ai + o + e
        usel = u_dpm >= u_y
        y_a = jnp.where(usel, u_dpm, u_y)
        Ym = jnp.where(
            usel[:, None, :],
            prevD - d32 * pD_ai[:, None, :],
            prevY - d32 * pY_ai[:, None, :],
        )                                                   # mask lanes

        # alpha lane closed form
        base = pD_ap + d32 * pD_ai
        d_col = jnp.roll(base, 1, axis=1) + sub             # col 0 unused
        const = jnp.maximum(d_col, y_a)
        x0_ai = _lane(x0, ai)
        dpm0_ai = x0_ai  # dpm col0 == x col0 (mode 6) or 0 (mode 7)
        q = const - e * jcol[None, :]
        q = q.at[:, 0].set(jnp.maximum(dpm0_ai, x0_ai - o))
        M = _cummax_lanes(q)
        x_a = o + e * jcol[None, :] + jnp.roll(M, 1, axis=1)
        x_a = x_a.at[:, 0].set(x0_ai)
        dpm_a = jnp.maximum(const, x_a)
        dpm_a = dpm_a.at[:, 0].set(dpm0_ai)
        lsel = dpm_a + o >= x_a                             # col t -> sel t+1
        dsel = jnp.where(dpm_a == d_col, 0, jnp.where(dpm_a == y_a, 1, 2))

        # mask lanes
        Dmn = prevD - d32 * pD_ai[:, None, :]
        Dm_sh = jnp.roll(Dmn, 1, axis=2)
        Cval = jnp.where((dsel == 0)[:, None, :], Dm_sh, Ym)
        Cval = Cval.at[:, :, 0].set(x0)                     # dpm col0 (mask)
        inject = jnp.roll(lsel, 1, axis=1) & (jnp.roll(dsel, 1, axis=1) != 2)
        inject = inject.at[:, 1].set(lsel[:, 0])
        inject = inject.at[:, 0].set(False)
        src = _cummax_lanes(jnp.where(inject, jcol[None, :], 0))
        if fits:
            # pack (column << 17 | value + OFF) per lane and pick the
            # latest inject column with a running max instead of a
            # lane-axis gather (valid while plane magnitudes stay under
            # 2^16 — the caller gates).
            OFF = 1 << 16
            Cval_sh = jnp.roll(Cval, 1, axis=2)
            enc = jnp.where(
                inject[:, None, :], (jcol << 17) | (Cval_sh + OFF), -1
            )
            encM = _cummax_lanes(enc)
            x_m = jnp.where(
                (src == 0)[:, None, :],
                x0[:, :, None],
                (encM & ((1 << 17) - 1)) - OFF,
            )
        else:
            x_m = jnp.where(
                (src == 0)[:, None, :],
                x0[:, :, None],
                jnp.take_along_axis(
                    Cval, jnp.maximum(src - 1, 0)[:, None, :], axis=2
                ),
            )
        dpm_m = jnp.where(
            (dsel == 0)[:, None, :], Dm_sh,
            jnp.where((dsel == 1)[:, None, :], Ym, x_m),
        )

        interior = (jcol >= 1)[None, None, :]
        la = (lane_i == ai)[None, :, None]
        lm = mask[None, :, None]
        Yrow = jnp.where(
            interior & la, y_a[:, None, :],
            jnp.where(interior & lm, Ym, 0),
        )
        Xrow = jnp.where(
            interior & la, x_a[:, None, :],
            jnp.where(interior & lm, x_m, jnp.where(~interior, x0[:, :, None], 0)),
        )
        Drow = jnp.where(
            interior & la, dpm_a[:, None, :],
            jnp.where(interior & lm, dpm_m, jnp.where(~interior, x0[:, :, None], 0)),
        )
        return Yrow, Xrow, Drow

    def hard_row(Dp, Yp, i, ai, x0, hard_ops):
        """Literal per-column program (gap.rs:150-539).

        Dp/Yp: int32[MB, B, P, Lp] — every pred block's row (hoisted).
        Only the in-row L/x coupling (and the D select that reads it) is
        inherently sequential; the U/y pass and the D candidates read
        pred rows only, so they are computed for every column at once
        and fed to the per-column scan as sliced inputs.  Inside the
        scan the per-block sequential where-chains are replaced by the
        host-precomputed last-writer owner one-hots (``bown``) — each
        block's writes hit maskb|{tb} for all three matrices, so the
        final lane value is the owning block's formula evaluated on the
        previous column and the FINAL in-column x (block s reads x as
        of block s, which equals final x exactly on the lanes s owns).
        The column scan body is issue-bound on tiny [B, P] arrays; the
        block axis runs as one vector dimension instead of a Python
        unroll.
        """
        (valid, pred, ap, tb, delta, case1, maskb, maskq, first, fixmem,
         own, fireb, isa, after) = hard_ops
        sub = jax.lax.dynamic_slice(SUB, (codes[i], 0, 0), (1, B, Lp))[0]

        # ---- U/y pass and D candidates, vectorized over columns ----
        y_c = jnp.zeros((B, P, Lp), jnp.int32)
        u_all, d_all, dfd_all = [], [], []
        for s in range(MB):
            w = valid[s]
            d_s = delta[s].astype(jnp.int32)
            tb_s, ap_s = tb[s], ap[s]
            tb_hot = (lane_i == tb_s)[None, :, None]
            Dp_s, Yp_s = Dp[s], Yp[s]
            yp_tb = _lane(Yp_s, tb_s)                       # [B, Lp]
            yp_ap = _lane(Yp_s, ap_s)
            dp_tb = _lane(Dp_s, tb_s)
            dp_ap = _lane(Dp_s, ap_s)
            u_y = yp_ap + d_s * yp_tb + e
            u_dpm = dp_ap + d_s * dp_tb + o + e
            usel = (u_dpm >= u_y)[:, None, :]               # [B, 1, Lp]
            y_from_d = Dp_s - d_s * dp_tb[:, None, :]
            y_from_y = Yp_s - d_s * yp_tb[:, None, :]
            elsemask = jnp.where(case1[s], maskq[s], maskb[s])
            y_c = jnp.where(
                w & usel & maskb[s][None, :, None], y_from_d, y_c
            )
            y_c = jnp.where(
                w & ~usel & elsemask[None, :, None], y_from_y, y_c
            )
            u = jnp.where(usel[:, 0, :], u_dpm, u_y)
            y_c = jnp.where(w & tb_hot, u[:, None, :], y_c)
            # D candidates read pred column j-1
            Dp_sh = jnp.roll(Dp_s, 1, axis=2)
            dsh_tb = _lane(Dp_sh, tb_s)
            dsh_ap = _lane(Dp_sh, ap_s)
            u_all.append(u)
            d_all.append(dsh_ap + d_s * dsh_tb + sub)
            dfd_all.append(Dp_sh - d_s * dsh_tb[:, None, :])
        # y's multi-alpha fixup reads only y (gap.rs:521-537) — hoisted
        # too; the D select below reads the PRE-fixup y, as the scalar
        # program does
        y_fix = y_c
        for s in range(MB):
            fire = valid[s] & first[s] & (tb[s] != ai)
            hot = (lane_i == tb[s])[None, :, None]
            mem = fixmem[s][None, :, None]
            va = _lane(y_fix, tb[s]) - _lane(y_fix, ai)
            y_fix = jnp.where(fire & hot, va[:, None, :], y_fix)
            y_fix = jnp.where(fire & mem, y_fix + va[:, None, :], y_fix)

        # per-column inputs, column axis leading for the scan
        U = jnp.moveaxis(jnp.stack(u_all, axis=1), 2, 0)[1:]   # [Lp-1, B, MB]
        Dc = jnp.moveaxis(jnp.stack(d_all, axis=1), 2, 0)[1:]
        Dfd = jnp.moveaxis(jnp.stack(dfd_all, axis=1), 3, 0)[1:]  # [Lp-1,B,MB,P]
        Ypre = jnp.moveaxis(y_c, 2, 0)[1:]                  # [Lp-1, B, P]

        oh = (lane_i[None, :] == tb[:, None]).astype(jnp.int32)  # [MB, P]
        ohb = oh.astype(bool)
        nd = (tb != ai).astype(jnp.int32)                   # [MB]
        own32 = own.astype(jnp.int32)                       # [MB, P]
        fire32 = fireb.astype(jnp.int32)                    # [MB]
        isa32 = isa.astype(jnp.int32)
        after32 = after.astype(jnp.int32)
        fixmem32 = fixmem.astype(jnp.int32)                 # [MB, P]
        hotl = (fire32[:, None] * oh).sum(0) > 0            # [P]

        def col(carry, xsj):
            x_row, d_row = carry                            # [B, P]
            u_j, d_j, dfd_j, ypre_j = xsj
            # L / x, all blocks at once (reads the in-row carry only)
            x_tb = (x_row[:, None, :] * oh[None]).sum(-1)   # [B, MB]
            d_tb = (d_row[:, None, :] * oh[None]).sum(-1)
            x_ai = _lane(x_row, ai)
            d_ai = _lane(d_row, ai)
            l_x = x_tb + nd[None] * x_ai[:, None] + e
            l_dpm = d_tb + nd[None] * d_ai[:, None] + o + e
            lsel = l_dpm >= l_x
            l = jnp.where(lsel, l_dpm, l_x)                 # [B, MB]
            xm = jnp.where(
                lsel[:, :, None],
                d_row[:, None, :] - nd[None, :, None] * d_tb[:, :, None],
                x_row[:, None, :] - nd[None, :, None] * x_tb[:, :, None],
            )                                               # [B, MB, P]
            cand_x = jnp.where(ohb[None], l[:, :, None], xm)
            x_c = (cand_x * own32[None]).sum(axis=1)        # [B, P]
            # D / dpm
            mx = jnp.maximum(jnp.maximum(d_j, u_j), l)      # [B, MB]
            is_d = mx == d_j
            is_u = ~is_d & (mx == u_j)
            dm = jnp.where(
                is_d[:, :, None], dfd_j,
                jnp.where(is_u[:, :, None], ypre_j[:, None, :],
                          x_c[:, None, :]),
            )
            cand_d = jnp.where(ohb[None], mx[:, :, None], dm)
            d_c = (cand_d * own32[None]).sum(axis=1)
            # multi-alpha fixup on x and d, vectorised: fire tb lanes
            # are distinct and fixmem sets are group-disjoint, and only
            # one fire block's fixmem can contain the row alpha, so the
            # sequential cascade closes after one correction (blocks
            # ordered after it read the already-adjusted alpha lane)
            M = jnp.stack([d_c, x_c])                       # [2, B, P]
            M_tb = (M[:, :, None, :] * oh[None, None]).sum(-1)   # [2, B, MB]
            M_ai = jax.lax.dynamic_slice(M, (0, 0, ai), (2, B, 1))[:, :, 0]
            va0 = M_tb - M_ai[:, :, None]                   # [2, B, MB]
            va_adj = (va0 * isa32[None, None]).sum(-1)      # [2, B]
            va = (va0 - after32[None, None] * va_adj[..., None]) * (
                fire32[None, None]
            )
            adds = (va[:, :, :, None] * fixmem32[None, None]).sum(2)
            hotv = (va[:, :, :, None] * oh[None, None]).sum(2)   # [2, B, P]
            M = jnp.where(hotl[None, None, :], hotv, M + adds)
            d_c, x_c = M[0], M[1]
            return (x_c, d_c), (x_c, d_c)

        (xf, df), (xs_, ds) = jax.lax.scan(
            col, (x0, x0), (U, Dc, Dfd, Ypre), unroll=4
        )
        # assemble rows: col 0 = (0, x0, x0), cols 1.. from the scan
        Yrow = y_fix.at[:, :, 0].set(0)
        Xrow = jnp.concatenate(
            [x0[:, :, None], jnp.moveaxis(xs_, 0, 2)], axis=2
        )
        Drow = jnp.concatenate(
            [x0[:, :, None], jnp.moveaxis(ds, 0, 2)], axis=2
        )
        return Yrow, Xrow, Drow

    def step(carry, xs):
        prevD, prevY, prevX0, ringD, ringY, ringX0 = carry
        (i, easy_i, pr_i, eap_i, edelta_i, emask_i, fap_i, fcap_i, fmask_i,
         valid, pred, ap, tb, delta, case1, maskb, maskq, first, fixmem,
         eslot_i, bslot_i, wslot_i, own_i, fire_i, isa_i, after_i) = xs
        ai = alphas[i]
        ns = node_start[i]
        hard_ops = (valid, pred, ap, tb, delta, case1, maskb, maskq, first,
                    fixmem, own_i, fire_i, isa_i, after_i)
        # All carry reads are hoisted out of the lax.cond branches (a
        # cond whose branches capture an in-place-updated carry forces
        # XLA to copy it at the branch boundary every row).  Node-start
        # rows read pred blocks from the ring; other rows read prev.
        Dp = jnp.stack([
            jax.lax.dynamic_slice(
                ringD, (bslot_i[s], 0, 0, 0), (1, B, P, Lp))[0]
            for s in range(MB)
        ])                                                  # [MB, B, P, Lp]
        Yp = jnp.stack([
            jax.lax.dynamic_slice(
                ringY, (bslot_i[s], 0, 0, 0), (1, B, P, Lp))[0]
            for s in range(MB)
        ])
        Xp0s = jnp.stack([
            jax.lax.dynamic_slice(ringX0, (bslot_i[s], 0, 0), (1, B, P))[0]
            for s in range(MB)
        ])                                                  # [MB, B, P]
        De = jnp.where(
            ns, jax.lax.dynamic_slice(
                ringD, (eslot_i, 0, 0, 0), (1, B, P, Lp))[0],
            prevD,
        )
        Ye = jnp.where(
            ns, jax.lax.dynamic_slice(
                ringY, (eslot_i, 0, 0, 0), (1, B, P, Lp))[0],
            prevY,
        )
        if semiglobal:
            x0 = jnp.zeros((B, P), jnp.int32)
        else:
            # keep the cond: computing both branches unconditionally
            # measured SLOWER (356 vs 302 ms/fill) — fc_start's
            # MB-unrolled [B, P] ops outweigh the cond boundary
            x0 = jax.lax.cond(
                ns,
                lambda: fc_start(Xp0s, i, ai, hard_ops),
                lambda: fc_nonstart(prevX0, i, ai, (fap_i, fcap_i, fmask_i)),
            )
        if force_easy:
            Yrow, Xrow, Drow = easy_row(
                De, Ye, i, ai, x0, (pr_i, eap_i, edelta_i, emask_i))
        else:
            Yrow, Xrow, Drow = jax.lax.cond(
                easy_i,
                lambda: easy_row(De, Ye, i, ai, x0,
                                 (pr_i, eap_i, edelta_i, emask_i)),
                lambda: hard_row(Dp, Yp, i, ai, x0, hard_ops),
            )
        ringD = jax.lax.dynamic_update_slice(
            ringD, Drow[None], (wslot_i, 0, 0, 0))
        ringY = jax.lax.dynamic_update_slice(
            ringY, Yrow[None], (wslot_i, 0, 0, 0))
        ringX0 = jax.lax.dynamic_update_slice(
            ringX0, Xrow[:, :, 0][None], (wslot_i, 0, 0))
        carry = (Drow, Yrow, Xrow[:, :, 0], ringD, ringY, ringX0)
        return carry, (Yrow, Xrow, Drow)

    # row 0: open+extend ladder on the row-0 alpha lane (gap.rs:23-33)
    a0 = alphas[0]
    ladder = (o + e * jcol) * (jcol >= 1)
    row0 = jnp.where(
        (lane_i == a0)[None, :, None] & (jcol >= 1)[None, None, :],
        jnp.broadcast_to(ladder[None, None, :], (B, P, Lp)), 0,
    )
    # ring slot 0 is row 0 (rank 0; always in the pred set); slot S is
    # the dummy non-pred rows write to
    ringD0 = jnp.zeros((S + 1, B, P, Lp), jnp.int32).at[0].set(row0)
    ringY0 = jnp.zeros((S + 1, B, P, Lp), jnp.int32).at[0].set(row0)
    ringX00 = jnp.zeros((S + 1, B, P), jnp.int32)

    rows = jnp.arange(1, n - 1, dtype=jnp.int32)
    sl = slice(1, n - 1)
    xs = (rows, easy[sl], pr[sl], eap[sl], edelta[sl], emask[sl], fap[sl],
          fcommon_ap[sl], fmask[sl], bvalid[sl], bpred[sl], bap[sl], btb[sl],
          bdelta[sl], bcase1[sl], bmask[sl], bmaskq[sl], bfirst[sl],
          bfixmem[sl], eslot[sl], bslot[sl], wslot[sl], bown[sl], bfire[sl],
          bisa[sl], bafter[sl])
    carry0 = (row0, row0, jnp.zeros((B, P), jnp.int32),
              ringD0, ringY0, ringX00)
    _, (Ys, Xs, Ds) = jax.lax.scan(step, carry0, xs)
    zrow = jnp.zeros((1, B, P, Lp), jnp.int32)
    Dm = jnp.concatenate([row0[None], Ds, zrow], axis=0)
    X = jnp.concatenate([zrow, Xs, zrow], axis=0)
    Y = jnp.concatenate([row0[None], Ys, zrow], axis=0)
    return Dm, X, Y


def fill_gap_device(g: PathGraph, sm: ScoreMatrix, seq, o: int, e: int,
                    semiglobal: bool, meta: GapMeta | None = None):
    """Device fill for modes 6/7; seq is the encoded batch int32[B, Lp].

    Returns (dpm, x, y) int32[n, B, P, Lp] device arrays, bit-identical
    (as int32) to the oracle's delta-form matrices on real columns.
    """
    if meta is None:
        meta = gap_meta(g)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    xs_meta = tuple(
        jnp.asarray(a) for a in (
            meta.easy, meta.pr, meta.eap, meta.edelta, meta.emask, meta.fap,
            meta.fcommon_ap, meta.fmask, meta.bvalid, meta.bpred, meta.bap,
            meta.btb, meta.bdelta, meta.bcase1, meta.bmask, meta.bmaskq,
            meta.bfirst, meta.bfixmem, meta.eslot, meta.bslot, meta.wslot,
            meta.bown, meta.bfire, meta.bisa, meta.bafter,
        )
    )
    # gate for the packed column|value chain in easy_row: plane
    # magnitudes must fit 16 bits (alpha lanes are bounded by the score
    # ladder over Lp columns; delta lanes by twice that)
    Lp = int(seq.shape[1])
    mt = int(np.abs(np.asarray(sm.table)).max())
    fits = 2 * (Lp * (mt + max(abs(o), abs(e))) + abs(o)) < (1 << 16)
    return _fill_gap(
        xs_meta, jnp.asarray(meta.codes), jnp.asarray(meta.alphas),
        jnp.asarray(meta.node_start), table, seq, o, e,
        maxb=meta.maxb, semiglobal=semiglobal, ring_s=meta.ring_s,
        fits=fits, force_easy=bool(meta.easy[1 : meta.n - 1].all()),
    )


# ---------------------------------------------------------------------------
# plane extraction + host traceback (delta-form walk over 4 planes)
# ---------------------------------------------------------------------------


@jax.jit
def extract_gap_planes(Dm, X, Y, alphas, bp):
    """The four planes the walk reads, per read.

    Dm/X/Y: int32[n, B, P, Lp]; bp: int32[B] best path per read.
    Returns (dpm_bp, dpm_al, x_bp, y_bp) each int32[B, n, Lp]:
    dpm_al[b, i] is dpm on row i's alpha lane (abs_at's rebase term);
    the others are the best-path lanes (delta form, as the reference
    walks them — pathwise_alignment_output.rs:207-306).
    """
    idx_bp = bp[None, :, None, None]                       # [1, B, 1, 1]
    d_bp = jnp.take_along_axis(Dm, idx_bp, axis=2)[:, :, 0]
    x_bp = jnp.take_along_axis(X, idx_bp, axis=2)[:, :, 0]
    y_bp = jnp.take_along_axis(Y, idx_bp, axis=2)[:, :, 0]
    idx_al = alphas[:, None, None, None]                   # [n, 1, 1, 1]
    d_al = jnp.take_along_axis(Dm, idx_al, axis=2)[:, :, 0]
    return (jnp.moveaxis(d_bp, 0, 1), jnp.moveaxis(d_al, 0, 1),
            jnp.moveaxis(x_bp, 0, 1), jnp.moveaxis(y_bp, 0, 1))


@jax.jit
def final_gap_column(Dm, L):
    """dpm[:, :, :, L-1] per read -> int32[B, n, P]."""
    idx = (L - 1)[None, :, None, None]
    col = jnp.take_along_axis(Dm, idx, axis=3)[:, :, :, 0]  # [n, B, P]
    return jnp.moveaxis(col, 0, 1)


def _pred_on_path(g: PathGraph, i: int, bp: int):
    """Last pred block of row i covering path bp, or None (the
    reference's `predecessor` loop keeps the last match)."""
    pred = None
    for p, paths in g.preds_and_paths(i):
        if paths[bp]:
            pred = p
    return pred


def walk_gap_planes(planes_b, g: PathGraph, bp: int, semiglobal: bool,
                    end_node: int) -> str:
    """build_alignment_gap / _semiglobal_gap over the extracted planes
    (pathwise_alignment_output.rs:186-451), including the delta-form
    gap-run comparisons and mode 6's no-pred trailing-U tail."""
    dpm_bp, dpm_al, x_bp, y_bp = planes_b
    alphas = g.alphas
    nwp = g.node_start

    def abs_at(ii: int, jj: int) -> int:
        v = int(dpm_bp[ii, jj])
        if alphas[ii] != bp:
            v += int(dpm_al[ii, jj])
        return v

    cigar: list[str] = []
    if semiglobal:
        i = end_node
    else:
        i = 0
        for node, paths in g.preds_and_paths(g.n - 1):
            if paths[bp]:
                i = node
    j = dpm_bp.shape[1] - 1

    while i != 0 and j != 0:
        curr_score = abs_at(i, j)
        predecessor = None
        if not nwp[i]:
            d = abs_at(i - 1, j - 1)
            u = abs_at(i - 1, j)
            l = abs_at(i, j - 1)
        else:
            d = u = l = 0
            predecessor = _pred_on_path(g, i, bp)
            if predecessor is not None:
                d = abs_at(predecessor, j - 1)
                u = abs_at(predecessor, j)
                l = abs_at(i, j - 1)
        mx = max(d, u, l)
        if mx == d:
            cigar.append("d" if curr_score < d else "D")
            i = (i - 1) if predecessor is None else predecessor
            j -= 1
        elif mx == u:
            cigar.append("U")
            i = (i - 1) if predecessor is None else predecessor
            while dpm_bp[i, j] < y_bp[i, j]:
                cigar.append("U")
                if nwp[i]:
                    # quirk: `predecessor` is only reassigned when a
                    # block covers the path; otherwise the previous
                    # value is retained (output.rs:276-283).  When that
                    # stale value is absent the reference crashes /
                    # loops — surface it instead.
                    p = _pred_on_path(g, i, bp)
                    if p is not None:
                        predecessor = p
                else:
                    predecessor = i - 1
                if predecessor is None:
                    raise RuntimeError(
                        "gap-run traceback left the best path "
                        "(the reference crashes on such inputs)"
                    )
                i = predecessor
        else:
            cigar.append("L")
            j -= 1
            while dpm_bp[i, j] < x_bp[i, j]:
                cigar.append("L")
                j -= 1
    while j > 0:
        cigar.append("L")
        j -= 1
    if semiglobal:
        cigar.reverse()
        starting_node = _count_to_source(g, i, bp)
        final_node = _count_to_source(g, end_node, bp)
        return f"{build_cigar(cigar)}\t({starting_node} {final_node})"
    while i > 0:
        cigar.append("U")
        i -= 1  # quirk: no pred lookup in this tail (output.rs:299-302)
    cigar.reverse()
    if cigar:
        cigar.pop()  # quirk: last move dropped (output.rs:304)
    return build_cigar(cigar)


def _endings_gap_global(finalcol_b, g: PathGraph) -> int:
    """Best path over F's preds (gap.rs:541-562); finalcol_b: [n, P]."""
    P = g.paths_number
    results = np.zeros(P, dtype=np.int64)
    for pred, paths in g.preds_and_paths(g.n - 1):
        ap = g.alphas[pred]
        for path in np.flatnonzero(paths):
            if path == ap:
                results[path] = finalcol_b[pred, path]
            else:
                results[path] = finalcol_b[pred, path] + finalcol_b[pred, ap]
    return max(range(P), key=lambda p: (results[p], p))


def _endings_gap_semi(finalcol_b, g: PathGraph) -> tuple[int, int]:
    """best_ending_node (gap_semi.rs:446-473); returns (node, path)."""
    mx = None
    ending_node = 0
    chosen_path = 0
    for i in range(g.n - 1):
        ai = g.alphas[i]
        absolute = finalcol_b[i].astype(np.int64).copy()
        on = g.paths_nodes[i]
        for path in np.flatnonzero(on):
            if path != ai:
                absolute[path] += absolute[ai]
        best_path = max(
            range(g.paths_number), key=lambda p: (absolute[p], p)
        )
        if mx is None or absolute[best_path] > mx:
            mx = absolute[best_path]
            ending_node = i
            chosen_path = best_path
    return ending_node, chosen_path


def run_batch(mode: int, sequences, g: PathGraph, sm: ScoreMatrix,
              o: int, e: int, chunk_bytes=None) -> list[tuple[int, str]]:
    """Modes 6/7 on device: returns [(best_path, printed line), ...]
    matching oracle exec_gap_global / exec_gap_semiglobal exactly.

    Traceback runs on device (:func:`_walk_gap`) — only compact walks
    cross to the host, not the four [n, Lp] planes."""
    from ..graph.pathgraph import pathwise_meta
    from .encode import encode_reads
    from .pathwise_engine import _align_lp

    meta = gap_meta(g)
    semiglobal = mode == 7
    n, P = g.n, g.paths_number
    out: list[tuple[int, str]] = []
    Lp_all = _align_lp(sequences)
    per_read = 3 * n * P * Lp_all * 4
    # 2 GiB of planes per chunk: the planes are scan OUTPUTS (written
    # once), so the cost of a bigger chunk is memory.  512 cap: the XLA
    # scan carry stops updating in place at large batches.
    if chunk_bytes is None:
        chunk_bytes = 2 << 30
    chunk = max(1, min(512, int(chunk_bytes // per_read)))
    alphas_j = jnp.asarray(meta.alphas)
    node_start_j = jnp.asarray(meta.node_start)
    _, pred_of = pathwise_meta(g)                          # [n, P]
    pred_of_T = jnp.asarray(pred_of.T)                     # [P, n]
    # the walk's start node for mode 6: F's last pred covering bp
    f_pred_of = np.zeros(P, dtype=np.int32)
    for node, paths in g.preds_and_paths(n - 1):
        f_pred_of[paths] = node
    W = 2 * (n + Lp_all) + 8
    for c0 in range(0, len(sequences), chunk):
        chunk_seqs = sequences[c0 : c0 + chunk]
        B = len(chunk_seqs)
        seq, L = encode_reads(chunk_seqs, pad_to=Lp_all)
        Dm, X, Y = fill_gap_device(g, sm, seq, o, e, semiglobal, meta)
        finalcol = np.asarray(
            jax.device_get(final_gap_column(Dm, L))
        )                                                   # [B, n, P]
        bps, nodes = [], []
        for b in range(B):
            if semiglobal:
                node, bp = _endings_gap_semi(finalcol[b], g)
            else:
                bp, node = _endings_gap_global(finalcol[b], g), 0
            bps.append(bp)
            nodes.append(node)
        # batch-align the per-read aux arrays with encode_reads: a
        # data-parallel mesh pads Dm/X/Y/L to a mesh multiple, so bp and
        # start_i must be padded+sharded the same way (results for the
        # padded lanes are discarded by the b < B host loop below)
        from .encode import encode_read_aux

        bp_j = encode_read_aux(bps)
        planes = extract_gap_planes(Dm, X, Y, alphas_j, bp_j)
        del Dm, X, Y
        start_i = [nodes[b] if semiglobal else int(f_pred_of[bps[b]])
                   for b in range(B)]
        pred_of_bp = jnp.take(pred_of_T, bp_j, axis=0)     # [Bp, n]
        dirs, ks, stop_i, errs = _walk_gap(
            *planes, alphas_j, jnp.int32(P), bp_j, node_start_j,
            pred_of_bp, encode_read_aux(start_i), L,
            global_mode=not semiglobal, max_steps=W,
        )
        del planes
        kmax = min(W, (int(jax.device_get(ks.max())) + 255) // 256 * 256)
        dirs, ks, stop_i, errs = jax.device_get(
            (dirs[:, :kmax], ks, stop_i, errs)
        )
        for b, s in enumerate(chunk_seqs):
            if errs[b]:
                # covers: gap run left the best path, walk read an
                # uncovered row, or the walk failed to terminate in
                # max_steps (the reference hangs/crashes on all three)
                raise RuntimeError(
                    "gap traceback left the best path "
                    "(the reference hangs/crashes on such inputs)"
                )
            cig = [_DIR_CHARS[int(c)] for c in dirs[b, : int(ks[b])]]
            cig.reverse()
            if semiglobal:
                starting = _count_to_source(g, int(stop_i[b]), bps[b])
                final = _count_to_source(g, nodes[b], bps[b])
                line = f"{build_cigar(cig)}\t({starting} {final})"
            else:
                if cig:
                    cig.pop()  # quirk: last move dropped (output.rs:304)
                line = build_cigar(cig)
            out.append((bps[b], line))
    return out


def _count_to_source(g: PathGraph, i: int, bp: int) -> int:
    """Semiglobal tail node counts (output.rs:413-445)."""
    nwp = g.node_start
    steps = 0
    while i > 0:
        if nwp[i]:
            p = _pred_on_path(g, i, bp)
            if p is None:
                raise RuntimeError(
                    "semiglobal tail left the best path "
                    "(the reference loops forever on such inputs)"
                )
            i = p
        else:
            i -= 1
        steps += 1
    return steps


# ---------------------------------------------------------------------------
# on-device traceback (mirrors walk_gap_planes; compact walks instead of
# 4 fetched planes — same ~100x transfer cut as the other modes)
# ---------------------------------------------------------------------------

# emitted codes
_D, _LOWD, _L, _U = 1, 2, 3, 4
_DIR_CHARS = {_D: "D", _LOWD: "d", _L: "L", _U: "U"}


@functools.partial(jax.jit, static_argnames=("global_mode", "max_steps"))
def _walk_gap(dpm_bp, dpm_al, x_bp, y_bp, alphas, n_paths, bp, node_start,
              pred_of_bp, start_i, L, global_mode, max_steps):
    """Batched delta-form gap walk over the four device planes.

    One phase applies per read per iteration (0 = main dispatch,
    1 = U gap run, 2 = L gap run, 3 = trailing L, 4 = trailing U for
    mode 6); phase transitions may burn an iteration without emitting,
    so ``max_steps`` is sized ~2(n + Lp).  Emission order matches the
    host walk (end -> start), including the predecessor-retention
    quirk; ``err`` marks the degenerate left-the-best-path case where
    the reference itself hangs/crashes (callers raise).
    """
    B, n, Lp = dpm_bp.shape
    dbf = dpm_bp.reshape(B, n * Lp)
    daf = dpm_al.reshape(B, n * Lp)
    xbf = x_bp.reshape(B, n * Lp)
    ybf = y_bp.reshape(B, n * Lp)
    bidx = jnp.arange(B)

    def at(flat, i, j):
        return jnp.take_along_axis(flat, (i * Lp + j)[:, None], 1)[:, 0]

    def abs_at(i, j):
        reb = jnp.take(alphas, i) != bp
        return at(dbf, i, j) + jnp.where(reb, at(daf, i, j), 0)

    def body(_, st):
        i, j, phase, retained, k, done, err, dirs = st
        live = ~done & ~err
        is_start = node_start[i]
        pred_e = jnp.take_along_axis(pred_of_bp, i[:, None], 1)[:, 0]
        covered = pred_e >= 0

        # ---- phase 0: main loop ----
        p_main = live & (phase == 0)
        in_main = p_main & (i > 0) & (j > 0)
        to_tail = p_main & ~((i > 0) & (j > 0))
        zero_case = is_start & ~covered
        src_row = jnp.where(is_start, jnp.maximum(pred_e, 0), i - 1)
        d = jnp.where(zero_case, 0, abs_at(src_row, j - 1))
        u = jnp.where(zero_case, 0, abs_at(src_row, j))
        l = jnp.where(zero_case, 0, abs_at(i, j - 1))
        mx = jnp.maximum(jnp.maximum(d, u), l)
        is_d = mx == d
        is_u = ~is_d & (mx == u)
        curr = abs_at(i, j)
        code_main = jnp.where(
            is_d, jnp.where(curr < d, _LOWD, _D),
            jnp.where(is_u, _U, _L),
        )
        # degenerate: the walk reads a row no path covers (alphas
        # sentinel P+1) — the oracle/reference crash there; surface it
        bad_alpha = in_main & (
            (jnp.take(alphas, i) >= n_paths)
            | (~zero_case & (jnp.take(alphas, src_row) >= n_paths))
        )
        predecessor = jnp.where(is_start & covered, pred_e, -1)
        step_i = jnp.where(predecessor >= 0, predecessor, i - 1)

        # ---- phase 1: U gap run ----
        p_urun = live & (phase == 1)
        u_more = at(dbf, i, j) < at(ybf, i, j)
        p_new = jnp.where(
            is_start, jnp.where(covered, pred_e, retained), i - 1
        )
        u_err = p_urun & u_more & (p_new < 0)
        u_emit = p_urun & u_more & ~u_err

        # ---- phase 2: L gap run ----
        p_lrun = live & (phase == 2)
        l_more = at(dbf, i, j) < at(xbf, i, j)
        l_emit = p_lrun & l_more

        # ---- phase 3: trailing L ----
        p_ltail = live & (phase == 3)
        lt_emit = p_ltail & (j > 0)

        # ---- phase 4: trailing U (mode 6) ----
        p_utail = live & (phase == 4)
        ut_emit = p_utail & (i > 0)

        # ---- merge: emission, movement, phase, termination ----
        emit = in_main | u_emit | l_emit | lt_emit | ut_emit
        code = jnp.where(in_main, code_main,
                         jnp.where(u_emit, _U,
                                   jnp.where(l_emit | lt_emit, _L, _U)))
        i_new = jnp.where(in_main & (is_d | is_u), step_i, i)
        i_new = jnp.where(u_emit, jnp.maximum(p_new, 0), i_new)
        i_new = jnp.where(ut_emit, i - 1, i_new)   # no-pred tail quirk
        j_dec = (in_main & (is_d | ~(is_d | is_u))) | l_emit | lt_emit
        j_new = jnp.where(j_dec, j - 1, i * 0 + j)
        phase_new = jnp.where(
            in_main, jnp.where(is_d, 0, jnp.where(is_u, 1, 2)), phase
        )
        phase_new = jnp.where(to_tail, 3, phase_new)
        phase_new = jnp.where(p_urun & ~u_more, 0, phase_new)
        phase_new = jnp.where(p_lrun & ~l_more, 0, phase_new)
        tail_done = p_ltail & (j == 0)
        phase_new = jnp.where(
            tail_done, jnp.where(jnp.bool_(global_mode), 4, phase_new),
            phase_new,
        )
        done_new = done | (tail_done & ~jnp.bool_(global_mode)) | (
            p_utail & (i == 0)
        )
        retained_new = jnp.where(in_main & is_u, predecessor, retained)
        retained_new = jnp.where(u_emit, p_new, retained_new)
        err_new = err | u_err | bad_alpha

        dirs = dirs.at[bidx, k].set(jnp.where(emit, code, dirs[bidx, k]))
        k = k + emit.astype(jnp.int32)
        return i_new, j_new, phase_new, retained_new, k, done_new, err_new, dirs

    z = jnp.zeros((B,), jnp.int32)
    dirs0 = jnp.full((B, max_steps), -1, jnp.int32)
    st = (start_i, L - 1, z, z - 1, z, jnp.zeros((B,), bool),
          jnp.zeros((B,), bool), dirs0)
    i, j, phase, retained, k, done, err, dirs = jax.lax.fori_loop(
        0, max_steps, body, st
    )
    return dirs, k, i, err | ~done
