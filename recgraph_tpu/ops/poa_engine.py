"""Batched device kernels for POA modes 0-3.

Batched device re-design of the reference's per-read scalar/AVX2 DP
(reference: src/global_abpoa.rs, src/local_poa.rs, src/gap_global_abpoa.rs,
src/gap_local_poa.rs): one `lax.scan` over graph rows, each step filling
an entire [batch, read] plane.  The in-row "left" dependency — which the
reference's AVX2 kernels resolve with a scalar fix-up sweep
(global_abpoa.rs:156-165) — is instead solved in closed form:

    m[j] = max(A[j], m[j-1] + gap)
         = G[j] + cummax_{k<=j}(A[k] - G[k]),   G = cumsum(gap)

a (max,+) prefix scan that vectorises across the whole row (and, for
the affine modes, a 2-state (max,+) associative scan).  Directions and
predecessors are then re-derived from the final row values with exactly
the reference's tie order and packed 4 bits/cell next to a predecessor
index, so host traceback reproduces the reference GAF bit-for-bit.

All kernels are batch-first: every tensor carries a leading read-batch
axis, which is the data-parallel axis sharded across chips (see
recgraph_tpu.parallel).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..oracle.poa import PoaState, _band_ampl_enough
from ..scoring import GAP
from .encode import poa_device_graph, encode_reads, encode_read_aux

NEG = -(1 << 28)  # -inf stand-in that survives a few additions in int32


def cummax_last(x):
    """Running max along the last axis."""
    return jax.lax.cummax(x, axis=x.ndim - 1)


def sub_planes(table, seq):
    """Substitution planes for every alphabet code: [A, B, Lp].

    Gathered once per fill so that each scan row takes its code's plane
    with a leading-axis dynamic_slice instead of a per-row gather.
    Pass ``table.T`` for the transposed local-mode lookup."""
    return jnp.take(table, seq, axis=1)


def sub_row(SUBP, code_i):
    """SUBP[code_i] via a leading-axis dynamic_slice."""
    A, B, Lp = SUBP.shape
    return jax.lax.dynamic_slice(SUBP, (code_i, 0, 0), (1, B, Lp))[0]

# direction codes: match reference bitfield_path.rs:3-15 plus the
# reference's out-of-range 'u' (gap_global_abpoa.rs:154, a preserved quirk)
_DIRS = "ODdLUXYMu"
O, D, LOW_D, L_DIR, U_DIR, X_DIR, Y_DIR, M_DIR, LOW_U = range(9)


# ---------------------------------------------------------------------------
# packed-path host views (PoaState adapter)
# ---------------------------------------------------------------------------


class _PackedRow:
    __slots__ = ("row", "left")

    def __init__(self, row, left):
        self.row = row
        self.left = left

    def __getitem__(self, j):
        v = int(self.row[j + self.left])
        return (v >> 4, _DIRS[v & 15])


class _PackedPath:
    """Band-relative (pred, dir) view over a packed int32[n, Lp] plane.

    ``ws`` (optional, int32[n]): per-row window starts for windowed
    planes — row i's lane k holds absolute column ws[i] + k, so the
    band-relative offset becomes lefts[i] - ws[i].
    """

    __slots__ = ("packed", "lefts", "ws")

    def __init__(self, packed, lefts, ws=None):
        self.packed = packed
        self.lefts = lefts
        self.ws = ws

    def __getitem__(self, i):
        off = int(self.lefts[i])
        if self.ws is not None:
            off -= int(self.ws[i])
        return _PackedRow(self.packed[i], off)


def _state_from_device(
    score, last_row, last_col_abs, packed, lefts, rights, seq_len,
    band_check=None, ws=None
) -> PoaState:
    ampl = np.stack([lefts, rights], axis=1)
    path = _PackedPath(packed, lefts, ws)
    st = PoaState(
        score=int(score),
        m=None,
        path=path,
        ampl=ampl,
        last_row=int(last_row),
        last_col=int(last_col_abs) - int(lefts[int(last_row)]),
    )
    if band_check == "linear":
        st.band_check_ok = _band_ampl_enough(path, ampl, seq_len, st.last_row, st.last_col)
    return st


# ---------------------------------------------------------------------------
# mode 0 — global POA, linear gap, adaptive band (global_abpoa.rs:260-427)
# ---------------------------------------------------------------------------


@jax.jit
def _fill_global(dg: "PoaDeviceGraph", table, seq, L, bta):
    """Banded global POA fill for a whole read batch.

    seq: int32[B, Lp] ('$'-prefixed, N-padded); L, bta: int32[B].
    Returns (score[B], last_row[B], last_col_abs[B],
             packed int32[B, n, Lp], lefts int32[B, n], rights int32[B, n]).
    """
    n, Pm = dg.n, dg.max_preds
    B, Lp = seq.shape
    jcol = jnp.arange(Lp, dtype=jnp.int32)
    gseq = table[seq, GAP]          # [B, Lp]  sm(seq[j], '-')
    gcol0 = table[GAP, seq]         # [B, Lp]  sm('-', seq[j]) (row 0)
    SUBP = sub_planes(table, seq)   # [A, B, Lp]

    def step(carry, xs):
        m, lefts, rights, bsp = carry
        i, code_i, pidx, pmask, minp, r_i = xs
        pidx_safe = jnp.maximum(pidx, 0)
        gnode_i = table[code_i, GAP]
        subrow_i = sub_row(SUBP, code_i)

        # --- adaptive band (utils.rs:17-72 via graph.set_ampl_for_row) ---
        pred_bsp = bsp[:, pidx_safe]                       # [B, Pm]
        ms = jnp.min(jnp.where(pmask, pred_bsp, 1 << 28), axis=1) + 1
        me = jnp.max(jnp.where(pmask, pred_bsp, NEG), axis=1) + 1
        ms = jnp.where(i == 0, 0, ms)
        me = jnp.where(i == 0, 0, me)
        left = jnp.maximum(0, jnp.minimum(ms, L - r_i - bta))
        right = jnp.where(
            L > r_i,
            jnp.minimum(L, jnp.maximum(me, L - r_i) + bta),
            jnp.minimum(L, me + bta),
        )
        in_band = (left[:, None] <= jcol) & (jcol < right[:, None])  # [B, Lp]

        # --- gather predecessor rows ---
        mp = m[:, pidx_safe, :]                            # [B, Pm, Lp]
        leftp = lefts[:, pidx_safe]                        # [B, Pm]
        rightp = rights[:, pidx_safe]

        # U candidates: preds whose band covers j (global_abpoa.rs:528-566)
        u_cov = pmask[None, :, None] & (leftp[..., None] <= jcol) & (
            jcol < rightp[..., None]
        )
        u_vals = jnp.where(u_cov, mp, NEG)
        u_best = u_vals.max(axis=1)
        u_pred = pidx_safe[u_vals.argmax(axis=1)]          # first best, asc order
        has_u = u_best > NEG // 2
        u_val = jnp.where(has_u, u_best + gnode_i, gnode_i * (i + jcol))
        u_pred = jnp.where(has_u, u_pred, minp)

        # D candidates: preds whose band covers j-1 shifted (":486-526")
        mp_sh = jnp.roll(mp, 1, axis=2).at[:, :, 0].set(NEG)
        d_cov = pmask[None, :, None] & (leftp[..., None] < jcol) & (
            jcol <= rightp[..., None]
        )
        d_vals = jnp.where(d_cov, mp_sh, NEG)
        d_best = d_vals.max(axis=1)
        d_pred = pidx_safe[d_vals.argmax(axis=1)]
        has_d = d_best > NEG // 2
        d_fb = (gnode_i * (i + left))[:, None]             # ":117" row constant
        d_val = jnp.where(has_d, d_best + subrow_i, d_fb)
        d_pred = jnp.where(has_d, d_pred, minp)

        # --- chain restart values A and the (max,+) prefix scan ---
        A = jnp.maximum(d_val, u_val)
        gseq_left = jnp.take_along_axis(gseq, left[:, None], axis=1)[:, 0]
        l_fb = gseq_left * (i + left)                      # ":85" j==0, left>0
        # j==0 && left==0 base case (":74-77"): m[min_pred][0] + gap
        m_minp = m[:, minp, :]                             # [B, Lp]
        lefts_minp = lefts[:, minp]
        base0 = (
            jnp.take_along_axis(m_minp, lefts_minp[:, None], axis=1)[:, 0] + gnode_i
        )
        is_left = jcol[None, :] == left[:, None]
        A_left = jnp.where(
            left == 0,
            base0,
            jnp.maximum(jnp.take_along_axis(A, left[:, None], 1)[:, 0], l_fb),
        )
        A_left = jnp.where(i == 0, 0, A_left)
        A = jnp.where(is_left, A_left[:, None], A)
        A = jnp.where(i == 0, jnp.where(jcol == 0, 0, NEG)[None, :], A)
        A = jnp.where(in_band, A, NEG)

        grow = jnp.where(i == 0, gcol0, gseq)
        G = jnp.cumsum(grow, axis=1)
        m_row = G + cummax_last(A - G)
        m_row = jnp.where(in_band, m_row, NEG)

        # --- rightmost in-band argmax => best_scoring_pos (":129-130") ---
        masked = jnp.where(in_band, m_row, NEG)
        bsp_i = Lp - 1 - jnp.argmax(masked[:, ::-1], axis=1).astype(jnp.int32)

        # --- directions (utils.rs:129-140 tie order D >= U >= L) ---
        m_prev = jnp.roll(m_row, 1, axis=1).at[:, 0].set(NEG)
        l_val = m_prev + gseq
        l_val = jnp.where(is_left, jnp.where((left == 0)[:, None], NEG, l_fb[:, None]), l_val)
        l_pred = jnp.where(jcol[None, :] > left[:, None], i, minp)
        d_ge_u = d_val >= u_val
        dirD = d_ge_u & (d_val >= l_val)
        dirU = (~d_ge_u) & (u_val >= l_val)
        match = seq == code_i
        dcode = jnp.where(
            dirD, jnp.where(match, D, LOW_D), jnp.where(dirU, U_DIR, L_DIR)
        )
        pred_sel = jnp.where(dirD, d_pred, jnp.where(dirU, u_pred, l_pred))
        # base cases override
        is_base = is_left & (left == 0)[:, None] & (i > 0)
        dcode = jnp.where(is_base, U_DIR, dcode)
        pred_sel = jnp.where(is_base, minp, pred_sel)
        dcode = jnp.where(i == 0, jnp.where(jcol == 0, O, L_DIR)[None, :], dcode)
        pred_sel = jnp.where(i == 0, 0, pred_sel)
        packed = jnp.where(in_band, pred_sel * 16 + dcode, 0)

        m = jax.lax.dynamic_update_slice(m, m_row[:, None, :], (0, i, 0))
        lefts = jax.lax.dynamic_update_slice(lefts, left[:, None], (0, i))
        rights = jax.lax.dynamic_update_slice(rights, right[:, None], (0, i))
        bsp = jax.lax.dynamic_update_slice(bsp, bsp_i[:, None], (0, i))
        return (m, lefts, rights, bsp), packed

    m0 = jnp.zeros((B, n, Lp), dtype=jnp.int32)
    z = jnp.zeros((B, n), dtype=jnp.int32)
    rows = jnp.arange(n - 1, dtype=jnp.int32)
    xs = (
        rows,
        dg.codes[:-1],
        dg.pred_idx[:-1],
        dg.pred_mask[:-1],
        dg.min_pred[:-1],
        dg.r_values[:-1],
    )
    (m, lefts, rights, _), packed = jax.lax.scan(step, (m0, z, z, z), xs)
    packed = jnp.concatenate(
        [jnp.moveaxis(packed, 0, 1), jnp.zeros((B, 1, Lp), jnp.int32)], axis=1
    )

    # final cell: best over F's preds, first strict max, row n-2 seeded
    # (global_abpoa.rs:397-405)
    cand = jnp.asarray((n - 2,) + dg.sink_rows, dtype=jnp.int32)
    cand_right = rights[:, cand]                           # [B, S+1]
    mcand = m[:, cand, :]
    vals = jnp.take_along_axis(mcand, (cand_right - 1)[..., None], axis=2)[..., 0]
    bidx = jnp.argmax(vals, axis=1)
    last_row = cand[bidx]
    score = jnp.take_along_axis(vals, bidx[:, None], 1)[:, 0]
    last_col_abs = jnp.take_along_axis(cand_right, bidx[:, None], 1)[:, 0] - 1
    return score, last_row, last_col_abs, packed, lefts, rights


@functools.partial(jax.jit, static_argnames=("W",))
def _fill_global_windowed(dg: "PoaDeviceGraph", table, seq, L, bta, W):
    """Banded global fill with O(W)-lane windowed rows (long reads).

    Same recurrence as ``_fill_global`` (global_abpoa.rs:260-427) but
    each row stores only the W columns [ws_i, ws_i+W) around its band,
    so memory and per-row work are O(W) instead of O(L) — the device
    analogue of the reference's O(band) rows (utils.rs:17-72).
    ws_i is the band left rounded down to a lane multiple; predecessor
    windows are realigned with a lane gather.  Rows whose band outgrows
    the window set the per-read ``over`` flag; callers must rerun those
    reads through the exact full-width engine.

    Returns (score[B], last_row[B], last_col_abs[B],
             packed int32[B, n, W], lefts, rights, ws int32[B, n],
             over bool[B]).
    """
    n, Pm = dg.n, dg.max_preds
    B, Lp = seq.shape
    Q = 8
    kcol = jnp.arange(W, dtype=jnp.int32)

    def step(carry, xs):
        m, wss, lefts, rights, bsp, over = carry
        i, code_i, pidx, pmask, minp, r_i = xs
        pidx_safe = jnp.maximum(pidx, 0)
        gnode_i = table[code_i, GAP]

        # --- adaptive band (same math as _fill_global) ---
        pred_bsp = bsp[:, pidx_safe]
        ms = jnp.min(jnp.where(pmask, pred_bsp, 1 << 28), axis=1) + 1
        me = jnp.max(jnp.where(pmask, pred_bsp, NEG), axis=1) + 1
        ms = jnp.where(i == 0, 0, ms)
        me = jnp.where(i == 0, 0, me)
        left = jnp.maximum(0, jnp.minimum(ms, L - r_i - bta))
        right = jnp.where(
            L > r_i,
            jnp.minimum(L, jnp.maximum(me, L - r_i) + bta),
            jnp.minimum(L, me + bta),
        )
        ws_i = (left // Q) * Q                              # [B]
        over = over | (right - ws_i > W)
        jabs = ws_i[:, None] + kcol[None, :]                # [B, W]
        in_band = (left[:, None] <= jabs) & (jabs < right[:, None])
        seq_w = jnp.take_along_axis(seq, jnp.minimum(jabs, Lp - 1), axis=1)
        gseq_w = table[seq_w, GAP]
        subrow_i = table[code_i][seq_w]

        # --- gather predecessor windows, realigned to jabs ---
        mp = m[:, pidx_safe, :]                             # [B, Pm, W]
        ws_p = wss[:, pidx_safe]                            # [B, Pm]
        shift = (ws_i[:, None] - ws_p)[:, :, None]          # [B, Pm, 1]
        idx = shift + kcol                                  # [B, Pm, W]
        ok = (idx >= 0) & (idx < W)
        mp_al = jnp.where(
            ok, jnp.take_along_axis(mp, jnp.clip(idx, 0, W - 1), axis=2), NEG
        )
        okm1 = (idx >= 1) & (idx <= W)
        mp_m1 = jnp.where(
            okm1, jnp.take_along_axis(mp, jnp.clip(idx - 1, 0, W - 1), axis=2),
            NEG,
        )
        leftp = lefts[:, pidx_safe]
        rightp = rights[:, pidx_safe]

        # U candidates: preds whose band covers jabs
        u_cov = pmask[None, :, None] & (leftp[..., None] <= jabs[:, None]) & (
            jabs[:, None] < rightp[..., None]
        )
        u_vals = jnp.where(u_cov, mp_al, NEG)
        u_best = u_vals.max(axis=1)
        u_pred = pidx_safe[u_vals.argmax(axis=1)]
        has_u = u_best > NEG // 2
        u_val = jnp.where(has_u, u_best + gnode_i, gnode_i * (i + jabs))
        u_pred = jnp.where(has_u, u_pred, minp)

        # D candidates: preds whose band covers jabs-1
        d_cov = pmask[None, :, None] & (leftp[..., None] < jabs[:, None]) & (
            jabs[:, None] <= rightp[..., None]
        )
        d_vals = jnp.where(d_cov, mp_m1, NEG)
        d_best = d_vals.max(axis=1)
        d_pred = pidx_safe[d_vals.argmax(axis=1)]
        has_d = d_best > NEG // 2
        d_fb = (gnode_i * (i + left))[:, None]
        d_val = jnp.where(has_d, d_best + subrow_i, d_fb)
        d_pred = jnp.where(has_d, d_pred, minp)

        # --- chain restart values and the (max,+) prefix scan ---
        A = jnp.maximum(d_val, u_val)
        seq_left = jnp.take_along_axis(seq, left[:, None], axis=1)[:, 0]
        gseq_left = table[seq_left, GAP]
        l_fb = gseq_left * (i + left)
        m_minp = m[:, minp, :]
        rel_minp = jnp.clip(lefts[:, minp] - wss[:, minp], 0, W - 1)
        base0 = (
            jnp.take_along_axis(m_minp, rel_minp[:, None], axis=1)[:, 0] + gnode_i
        )
        is_left = jabs == left[:, None]
        left_rel = jnp.clip(left - ws_i, 0, W - 1)
        A_left = jnp.where(
            left == 0,
            base0,
            jnp.maximum(jnp.take_along_axis(A, left_rel[:, None], 1)[:, 0], l_fb),
        )
        A_left = jnp.where(i == 0, 0, A_left)
        A = jnp.where(is_left, A_left[:, None], A)
        A = jnp.where(i == 0, jnp.where(jabs == 0, 0, NEG), A)
        A = jnp.where(in_band, A, NEG)

        grow = jnp.where(i == 0, table[GAP, seq_w], gseq_w)
        G = jnp.cumsum(grow, axis=1)
        m_row = G + cummax_last(A - G)
        m_row = jnp.where(in_band, m_row, NEG)

        # rightmost in-band argmax => best_scoring_pos
        bsp_i = ws_i + W - 1 - jnp.argmax(
            jnp.where(in_band, m_row, NEG)[:, ::-1], axis=1
        ).astype(jnp.int32)

        # directions (utils.rs:129-140 tie order D >= U >= L)
        m_prev = jnp.roll(m_row, 1, axis=1).at[:, 0].set(NEG)
        l_val = m_prev + gseq_w
        l_val = jnp.where(
            is_left, jnp.where((left == 0)[:, None], NEG, l_fb[:, None]), l_val
        )
        l_pred = jnp.where(jabs > left[:, None], i, minp)
        d_ge_u = d_val >= u_val
        dirD = d_ge_u & (d_val >= l_val)
        dirU = (~d_ge_u) & (u_val >= l_val)
        match = seq_w == code_i
        dcode = jnp.where(
            dirD, jnp.where(match, D, LOW_D), jnp.where(dirU, U_DIR, L_DIR)
        )
        pred_sel = jnp.where(dirD, d_pred, jnp.where(dirU, u_pred, l_pred))
        is_base = is_left & (left == 0)[:, None] & (i > 0)
        dcode = jnp.where(is_base, U_DIR, dcode)
        pred_sel = jnp.where(is_base, minp, pred_sel)
        dcode = jnp.where(i == 0, jnp.where(jabs == 0, O, L_DIR), dcode)
        pred_sel = jnp.where(i == 0, 0, pred_sel)
        packed = jnp.where(in_band, pred_sel * 16 + dcode, 0)

        m = jax.lax.dynamic_update_slice(m, m_row[:, None, :], (0, i, 0))
        wss = jax.lax.dynamic_update_slice(wss, ws_i[:, None], (0, i))
        lefts = jax.lax.dynamic_update_slice(lefts, left[:, None], (0, i))
        rights = jax.lax.dynamic_update_slice(rights, right[:, None], (0, i))
        bsp = jax.lax.dynamic_update_slice(bsp, bsp_i[:, None], (0, i))
        return (m, wss, lefts, rights, bsp, over), packed

    m0 = jnp.zeros((B, n, W), dtype=jnp.int32)
    z = jnp.zeros((B, n), dtype=jnp.int32)
    over0 = jnp.zeros((B,), bool)
    rows = jnp.arange(n - 1, dtype=jnp.int32)
    xs = (
        rows,
        dg.codes[:-1],
        dg.pred_idx[:-1],
        dg.pred_mask[:-1],
        dg.min_pred[:-1],
        dg.r_values[:-1],
    )
    (m, wss, lefts, rights, _, over), packed = jax.lax.scan(
        step, (m0, z, z, z, z, over0), xs
    )
    packed = jnp.concatenate(
        [jnp.moveaxis(packed, 0, 1), jnp.zeros((B, 1, W), jnp.int32)], axis=1
    )

    # final cell: best over F's preds, first strict max (":397-405")
    cand = jnp.asarray((n - 2,) + dg.sink_rows, dtype=jnp.int32)
    cand_right = rights[:, cand]
    cand_rel = jnp.clip(cand_right - 1 - wss[:, cand], 0, W - 1)
    mcand = m[:, cand, :]
    vals = jnp.take_along_axis(mcand, cand_rel[..., None], axis=2)[..., 0]
    bidx = jnp.argmax(vals, axis=1)
    last_row = cand[bidx]
    score = jnp.take_along_axis(vals, bidx[:, None], 1)[:, 0]
    last_col_abs = jnp.take_along_axis(cand_right, bidx[:, None], 1)[:, 0] - 1
    return score, last_row, last_col_abs, packed, lefts, rights, wss, over


LONG_READ_LP = 1024     # mode-0 reads at least this long use windowed rows
_long_w_hint: dict[int, int] = {}


def fill_global_long(dg, table, seq, L, bta, bta_max):
    """Mode-0 fill for long reads: windowed rows with a W ladder.

    Starts at the smallest W covering 2·bta plus drift slack (or the
    last W that worked for this graph) and doubles until no read's
    band overflows its window; at W >= Lp falls back to the exact
    full-width fill.  Returns (score, last_row, last_col_abs,
    packed[B, n, W], lefts, rights, ws | None); ws None means the
    full-width plane.
    """
    Lp = seq.shape[1]
    W = _long_w_hint.get(dg.n, 0)
    if W == 0:
        W = 256
        while W < 2 * bta_max + 64:
            W *= 2
    while W < Lp:
        out = _fill_global_windowed(dg, table, seq, L, bta, W=W)
        if not bool(jax.device_get(out[7].any())):
            _long_w_hint[dg.n] = W
            return out[:7]
        W *= 2
    _long_w_hint[dg.n] = Lp
    return _fill_global(dg, table, seq, L, bta) + (None,)


# ---------------------------------------------------------------------------
# mode 1 — local POA, full matrix (local_poa.rs:181-255)
# ---------------------------------------------------------------------------


@jax.jit
def _fill_local(dg: "PoaDeviceGraph", table, seq, L):
    n, Pm = dg.n, dg.max_preds
    B, Lp = seq.shape
    jcol = jnp.arange(Lp, dtype=jnp.int32)
    gseq = table[seq, GAP]
    # the scalar local kernel scores as (seq[j], lnz[i]) and ('-', lnz[i])
    # (local_poa.rs:202-221) — transposed vs the global modes; matters
    # for asymmetric matrices (the shipped HOXD70 is asymmetric)
    tT = table.T
    SUBP = sub_planes(tT, seq)      # [A, B, Lp]
    valid = jcol[None, :] < L[:, None]

    def step(carry, xs):
        m, best_val, best_i, best_j = carry
        i, code_i, is_start, pidx, pmask = xs
        pidx_safe = jnp.maximum(pidx, 0)
        gnode_i = tT[code_i, GAP]
        subrow_i = sub_row(SUBP, code_i)
        mp = m[:, pidx_safe, :]                            # [B, Pm, Lp]
        mvals = jnp.where(pmask[None, :, None], mp, NEG)
        mp_sh = jnp.roll(mvals, 1, axis=2).at[:, :, 0].set(NEG)

        # first-best quirk: running max starts at 0/index(row)0
        # (local_poa.rs:257-293)
        d_pre = mp_sh.max(axis=1)
        d_arg = pidx_safe[mp_sh.argmax(axis=1)]
        d_val = jnp.where(is_start, jnp.maximum(d_pre, 0), d_pre) + subrow_i
        d_idx = jnp.where(is_start, jnp.where(d_pre > 0, d_arg, 0), i - 1)
        u_pre = mvals.max(axis=1)
        u_arg = pidx_safe[mvals.argmax(axis=1)]
        u_val = jnp.where(is_start, jnp.maximum(u_pre, 0), u_pre) + gnode_i
        u_idx = jnp.where(is_start, jnp.where(u_pre > 0, u_arg, 0), i - 1)

        A = jnp.maximum(jnp.maximum(d_val, u_val), 0)
        A = jnp.where(jcol == 0, 0, A)
        A = jnp.where((i == 0) & (jcol > 0)[None, :], 0, A)
        G = jnp.cumsum(gseq, axis=1)
        m_row = G + cummax_last(A - G)
        m_row = jnp.where(valid, m_row, NEG)
        m_row = jnp.where(i == 0, jnp.zeros_like(m_row), m_row)
        m_row = jnp.where(jcol == 0, 0, m_row)

        # directions (zero floor local_poa.rs:222-233)
        m_prev = jnp.roll(m_row, 1, axis=1).at[:, 0].set(NEG)
        l_val = m_prev + gseq
        all_neg = (d_val < 0) & (u_val < 0) & (l_val < 0)
        d_ge_u = d_val >= u_val
        dirD = d_ge_u & (d_val >= l_val)
        dirU = (~d_ge_u) & (u_val >= l_val)
        match = seq == code_i
        dcode = jnp.where(
            dirD, jnp.where(match, D, LOW_D), jnp.where(dirU, U_DIR, L_DIR)
        )
        pred_sel = jnp.where(dirD, d_idx, jnp.where(dirU, u_idx, i))
        dcode = jnp.where(all_neg, O, dcode)
        pred_sel = jnp.where(all_neg, 0, pred_sel)
        border = (i == 0) | (jcol == 0)[None, :] | ~valid
        dcode = jnp.where(border, O, dcode)
        pred_sel = jnp.where(border, 0, pred_sel)
        packed = pred_sel * 16 + dcode

        # global best, strict > in row-major scan order (local_poa.rs:240-244)
        row_masked = jnp.where(valid, m_row, NEG)
        rmax = row_masked.max(axis=1)
        rarg = row_masked.argmax(axis=1).astype(jnp.int32)
        upd = rmax > best_val
        best_val = jnp.where(upd, rmax, best_val)
        best_i = jnp.where(upd, i, best_i)
        best_j = jnp.where(upd, rarg, best_j)

        m = jax.lax.dynamic_update_slice(m, m_row[:, None, :], (0, i, 0))
        return (m, best_val, best_i, best_j), packed

    m0 = jnp.zeros((B, n, Lp), dtype=jnp.int32)
    zb = jnp.zeros((B,), dtype=jnp.int32)
    rows = jnp.arange(n - 1, dtype=jnp.int32)
    xs = (
        rows,
        dg.codes[:-1],
        dg.node_start[:-1],
        dg.pred_idx[:-1],
        dg.pred_mask[:-1],
    )
    (m, best_val, best_i, best_j), packed = jax.lax.scan(
        step, (m0, zb, zb, zb), xs
    )
    packed = jnp.concatenate(
        [jnp.moveaxis(packed, 0, 1), jnp.zeros((B, 1, Lp), jnp.int32)], axis=1
    )
    return best_val, best_i, best_j, packed


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def fill_local_best(dg, table, seq, L):
    """Mode-1 fill: (score[B], best_i[B], best_j[B], packed[B, n, Lp]).

    On a GPU the CUDA kernel (ops/cuda_fill.py) runs the fill when the
    shape is within its limits; elsewhere the XLA scan engine does.
    """
    from . import cuda_fill

    if cuda_fill.use_kernel(seq.shape[1]):
        return cuda_fill.fill_local(dg, table, seq, L)
    return _fill_local(dg, table, seq, L)


CHUNK_READS = 512  # per-dispatch read chunk: bounds device memory at
                   # [chunk, n, Lp] planes and keeps the XLA scan carry
                   # in its in-place-update regime


def run_batch(mode, sequences, g, sm, o, e, btas) -> list[PoaState]:
    if len(sequences) > CHUNK_READS:
        out = []
        for c in range(0, len(sequences), CHUNK_READS):
            out.extend(
                run_batch(
                    mode, sequences[c : c + CHUNK_READS], g, sm, o, e,
                    btas[c : c + CHUNK_READS],
                )
            )
        return out
    dg = poa_device_graph(g)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    seq, L = encode_reads(sequences)
    B = len(sequences)
    if mode == 0:
        bta = encode_read_aux(btas)
        if seq.shape[1] >= LONG_READ_LP:
            score, last_row, last_col, packed, lefts, rights, ws = (
                fill_global_long(dg, table, seq, L, bta, max(btas))
            )
            score, last_row, last_col, packed, lefts, rights, ws = jax.device_get(
                (score, last_row, last_col, packed, lefts, rights, ws)
            )
            return [
                _state_from_device(
                    score[b], last_row[b], last_col[b], packed[b], lefts[b],
                    rights[b], len(sequences[b]), band_check="linear",
                    ws=None if ws is None else ws[b],
                )
                for b in range(B)
            ]
        score, last_row, last_col, packed, lefts, rights = jax.device_get(
            _fill_global(dg, table, seq, L, bta)
        )
        return [
            _state_from_device(
                score[b], last_row[b], last_col[b], packed[b], lefts[b],
                rights[b], len(sequences[b]), band_check="linear",
            )
            for b in range(B)
        ]
    if mode == 1:
        score, best_i, best_j, packed = jax.device_get(
            fill_local_best(dg, table, seq, L)
        )
        states = []
        for b in range(B):
            lb = len(sequences[b])
            lefts = np.zeros(dg.n, dtype=np.int32)
            rights = np.full(dg.n, lb, dtype=np.int32)
            states.append(
                _state_from_device(
                    score[b], best_i[b], best_j[b], packed[b], lefts, rights, lb
                )
            )
        return states
    if mode in (2, 3):
        from . import poa_gap_engine

        return poa_gap_engine.run_batch(mode, sequences, g, sm, o, e, btas)
    raise ValueError(f"unsupported POA mode {mode}")


def run_single(mode, seq, g, sm, o, e, bta) -> PoaState:
    return run_batch(mode, [seq], g, sm, o, e, [bta])[0]


# ---------------------------------------------------------------------------
# device-traceback batch path (compact walks instead of packed planes)
# ---------------------------------------------------------------------------


class WalkState:
    """Per-read result with a compact device walk (no packed planes).

    ~100x smaller host transfer than PoaState's direction planes; GAF
    emission goes through the native walk emitter
    (native/gaf_emit.cpp: gaf_emit_poa_walk).
    """

    __slots__ = (
        "mode", "score", "last_row", "last_col_abs", "stop_row",
        "query_start", "dirs", "rows", "band_check_ok",
    )

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def run_batch_walks(mode, sequences, g, sm, o, e, btas):
    """Modes 0-3 with on-device traceback; returns list[WalkState].

    Large corpora run as a depth-2 software pipeline over read chunks:
    chunk k+1's fill+walk is dispatched to the device before chunk k's
    walks are drained to the host, so transfers and host emission
    overlap device compute (the host-side pipeline of SURVEY.md §2.3).
    """
    from . import traceback_engine
    from .. import native
    from ..metrics import phase

    ckr = CHUNK_READS
    if len(sequences) > ckr:
        # ONE compiled shape for every chunk: pad Lp corpus-wide and pad
        # the trailing chunk's batch up to the chunk size with copies of
        # its first read (drain slices them off), so that per-chunk
        # shape drift never recompiles the fill.
        pad_to = max(len(s) for s in sequences)
        out = []
        pending = None
        starts = list(range(0, len(sequences), ckr))
        for c in starts + [None]:
            nxt = None
            if c is not None:
                chunk = sequences[c : c + ckr]
                cbtas = btas[c : c + ckr]
                n_real = len(chunk)
                if n_real < ckr:
                    fill_n = ckr - n_real
                    chunk = chunk + [chunk[0]] * fill_n
                    cbtas = cbtas + [cbtas[0]] * fill_n
                with phase("dispatch"):
                    seqs_p, dev = _dispatch_walks(
                        mode, chunk, g, sm, o, e, cbtas, pad_to=pad_to
                    )
                nxt = (seqs_p[:n_real], dev)
            if pending is not None:
                out.extend(_drain_walks(mode, *pending))
            pending = nxt
        return out
    with phase("dispatch"):
        pending = _dispatch_walks(mode, sequences, g, sm, o, e, btas)
    return _drain_walks(mode, *pending)


def _dispatch_walks(mode, sequences, g, sm, o, e, btas, pad_to=None):
    """Device-side fill + walk for one chunk; no host transfers."""
    from . import traceback_engine
    from ..metrics import phase

    dg = poa_device_graph(g)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    with phase("encode"):
        seq, L = encode_reads(sequences, pad_to=pad_to)
    B, Lp = seq.shape
    W = traceback_engine.max_walk_steps(dg.n, Lp)
    gap = mode in (2, 3)
    banded = mode in (0, 2)
    ws = None
    if mode == 0:
        bta = encode_read_aux(btas)
        if Lp >= LONG_READ_LP:
            score, last_row, last_col, packed, lefts, rights, ws = (
                fill_global_long(dg, table, seq, L, bta, max(btas))
            )
        else:
            score, last_row, last_col, packed, lefts, rights = (
                _fill_global(dg, table, seq, L, bta)
            )
        px = py = packed
    elif mode == 1:
        score, last_row, last_col, packed = fill_local_best(dg, table, seq, L)
        px = py = packed
        lefts = rights = None
    elif mode == 2:
        from . import poa_gap_engine

        if Lp >= LONG_READ_LP:
            out = poa_gap_engine.fill_gap_global_long(
                dg, table, seq, L, encode_read_aux(btas), max(btas), o, e
            )
            (score, last_row, last_col, packed, px, py, lefts, rights,
             ws) = out
        else:
            score, last_row, last_col, packed, px, py, lefts, rights = (
                poa_gap_engine.fill_gap_global(
                    dg, table, seq, L, encode_read_aux(btas), o, e
                )
            )
    else:
        from . import poa_gap_engine

        score, last_row, last_col, packed, px, py = (
            poa_gap_engine.fill_gap_local(dg, table, seq, L, o, e)
        )
        lefts = rights = None

    band = (lefts, rights, L) if banded else None
    dirs, rows, steps, stop_row, stop_col, band_ok, qstart, kmax_dev = (
        traceback_engine.walk_poa(
            packed, px, py, last_row, last_col, gap=gap, max_steps=W,
            ws=ws, band=band,
        )
    )
    # one [8, B] int32 block -> ONE host fetch for all per-read scalars
    ok_i = (
        band_ok.astype(jnp.int32) if band_ok is not None
        else jnp.ones_like(score)
    )
    scal = jnp.stack([
        score, last_row, last_col, steps, stop_row, stop_col, qstart, ok_i
    ])
    dev = dict(
        scal=scal, dirs=dirs, rows=rows, kmax=kmax_dev, W=W, n=dg.n,
    )
    return sequences, dev


def _drain_walks(mode, sequences, dev):
    """Fetch one dispatched chunk and build WalkStates."""
    from ..metrics import phase

    gap = mode in (2, 3)
    banded = mode in (0, 2)
    B = len(sequences)
    # truncate the padded walk buffers to the batch's longest walk
    # (bucketed) before they cross the device->host link
    from . import traceback_engine as tb

    with phase("device_wait"):
        # fetching this scalar blocks until the chunk's fill+walk is
        # done on-device
        kmax = min(
            dev["W"], (int(jax.device_get(dev["kmax"])) + 63) // 64 * 64
        )
    pack = tb.pack_walk16 if dev["n"] <= 2048 else tb.pack_walk32
    pk = pack(dev["dirs"][:, :kmax], dev["rows"][:, :kmax])
    with phase("fetch"):
        pk, scal = jax.device_get([pk, dev["scal"]])
    (score, last_row, last_col, steps, stop_row, stop_col, qstart_a,
     band_ok_a) = scal
    dirs, rows = tb.unpack_walk(pk)
    states = []
    with phase("host_tb"):
        for b in range(B):
            ns = int(steps[b])
            d, r = tb.compact_walk(dirs[b], rows[b], ns)
            lb = len(sequences[b])
            if banded:
                qstart = int(qstart_a[b])
                ok = bool(band_ok_a[b])
            else:
                qstart = int(stop_col[b])
                ok = True
            states.append(
                WalkState(
                    mode=mode,
                    score=int(score[b]),
                    last_row=int(last_row[b]),
                    last_col_abs=int(last_col[b]),
                    stop_row=int(stop_row[b]),
                    query_start=qstart,
                    dirs=d,
                    rows=r,
                    band_check_ok=bool(ok),
                )
            )
    return states
