"""Batched device kernels for affine-gap POA modes 2/3.

Gotoh-on-DAG (reference: src/gap_global_abpoa.rs:11-250,
src/gap_local_poa.rs:8-129) with the in-row (M,X) coupled recurrence

    x[j] = max(x[j-1] + e, m[j-1] + o + e)
    m[j] = max(c[j], x[j])          c[j] = max(d[j], y[j] [, 0])

solved as a 2-state (max,+) affine associative scan across the row:
elements (M_j, b_j) with v_j = M_j (x) v_{j-1} (+) b_j compose
associatively, so `jax.lax.associative_scan` vectorises the whole row.
Cross-row Y candidates and diagonal D candidates have no in-row
dependency and are plain masked max-reductions over predecessor rows.

Direction/tie semantics match the reference exactly, including:
- mode 2's D/L/U cascade (gap_global_abpoa.rs:143-195; ties differ from
  utils::get_max_d_u_l — L beats U, D beats both),
- the out-of-range 'u' direction char when u_pred == 0
  (gap_global_abpoa.rs:153-157; would panic in the reference's
  bitfield encoder — preserved as a distinct code),
- mode 3's asymmetric Y/M tie rules between start and non-start rows
  (gap_local_poa.rs:56-93 vs :131-187).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..oracle.poa import PoaState, _gap_band_ampl_enough
from .encode import poa_device_graph, encode_reads, encode_read_aux
from .poa_engine import (
    NEG,
    O,
    D,
    LOW_D,
    L_DIR,
    U_DIR,
    X_DIR,
    sub_planes,
    sub_row,
    Y_DIR,
    M_DIR,
    LOW_U,
    _PackedPath,
    _state_from_device,
)


def _mp_combine(a, b):
    """Compose two (max,+) affine maps: b after a; clamped to NEG."""
    Ma, ba = a
    Mb, bb = b
    M = jnp.max(Mb[..., :, :, None] + Ma[..., None, :, :], axis=-2)
    v = jnp.maximum(jnp.max(Mb + ba[..., None, :], axis=-1), bb)
    return jnp.maximum(M, NEG), jnp.maximum(v, NEG)


def _affine_row_scan(c, v_left, is_left, in_band, o, e):
    """Solve m[j]=max(c[j],x[j]), x[j]=max(x[j-1]+e, m[j-1]+o+e) per row.

    c: int32[B, Lp] chain inputs; v_left: int32[B, 2] state at the band
    start; returns (m_row, x_row) int32[B, Lp].
    """
    B, Lp = c.shape
    oe = o + e
    M = jnp.broadcast_to(
        jnp.asarray([[oe, e], [oe, e]], dtype=jnp.int32), (B, Lp, 2, 2)
    )
    ident = jnp.asarray([[0, NEG], [NEG, 0]], dtype=jnp.int32)
    kill = jnp.full((2, 2), NEG, dtype=jnp.int32)
    M = jnp.where(is_left[..., None, None], kill, M)
    M = jnp.where(in_band[..., None, None], M, ident)
    b = jnp.stack([c, jnp.full_like(c, NEG)], axis=-1)
    b = jnp.where(is_left[..., None], v_left[:, None, :], b)
    b = jnp.where(in_band[..., None], b, NEG)
    _, v = jax.lax.associative_scan(_mp_combine, (M, b), axis=1)
    return v[..., 0], v[..., 1]


# ---------------------------------------------------------------------------
# mode 2 — affine-gap global POA, adaptive band (gap_global_abpoa.rs:11-250)
# ---------------------------------------------------------------------------


@jax.jit
def _fill_gap_global(dg, table, seq, L, bta, o, e):
    n, Pm = dg.n, dg.max_preds
    B, Lp = seq.shape
    jcol = jnp.arange(Lp, dtype=jnp.int32)
    SUBP = sub_planes(table, seq)   # [A, B, Lp]

    def step(carry, xs):
        m, y, lefts, rights, bsp = carry
        i, code_i, pidx, pmask, minp, r_i = xs
        pidx_safe = jnp.maximum(pidx, 0)
        subrow_i = sub_row(SUBP, code_i)

        # --- adaptive band (same as mode 0) ---
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
        in_band = (left[:, None] <= jcol) & (jcol < right[:, None])
        is_left = jcol[None, :] == left[:, None]

        mp = m[:, pidx_safe, :]
        yp = y[:, pidx_safe, :]
        leftp = lefts[:, pidx_safe]
        rightp = rights[:, pidx_safe]
        cov = pmask[None, :, None] & (leftp[..., None] <= jcol) & (
            jcol < rightp[..., None]
        )

        # Y candidates (gap_global_abpoa.rs:121-141,294-346): first-best
        # argmax over covering preds of m[p][j]+o and y[p][j] separately
        um_vals = jnp.where(cov, mp, NEG)
        um_best = um_vals.max(axis=1)
        um_idx = pidx_safe[um_vals.argmax(axis=1)]
        uy_vals = jnp.where(cov, yp, NEG)
        uy_best = uy_vals.max(axis=1)
        uy_idx = pidx_safe[uy_vals.argmax(axis=1)]
        covered = um_best > NEG // 2
        um_best = um_best + o
        y_fb = 2 * o + e * (minp + 1) + e * jcol          # ":137"
        from_y = uy_best > um_best                        # strict (":328")
        y_row = jnp.where(
            covered, jnp.maximum(um_best, uy_best) + e, y_fb
        )
        u_pred = jnp.where(covered, jnp.where(from_y, uy_idx, um_idx), minp)
        py_code = jnp.where(covered & from_y, Y_DIR, O)
        py_pred = jnp.where(covered & from_y, uy_idx, 0)

        # D candidates (":143-195,252-292")
        mp_sh = jnp.roll(mp, 1, axis=2).at[:, :, 0].set(NEG)
        d_cov = pmask[None, :, None] & (leftp[..., None] < jcol) & (
            jcol <= rightp[..., None]
        )
        d_vals = jnp.where(d_cov, mp_sh, NEG)
        d_best = d_vals.max(axis=1)
        d_idx = pidx_safe[d_vals.argmax(axis=1)]
        has_d = d_best > NEG // 2
        d_val = d_best + subrow_i

        # row 0 (":60-66"): y[j] = m[j] = o + e*j, x untouched
        row0_y = jnp.where(jcol == 0, 0, o + e * jcol)[None, :]
        y_row = jnp.where(i == 0, row0_y, y_row)

        # --- in-row (M,X) affine scan ---
        c = jnp.maximum(d_val, y_row)
        c = jnp.where(has_d | (i == 0), jnp.where(i == 0, row0_y, c), y_row)
        # v_left: band-start state (":55-58" j==0&&left==0; ":104-107" fallback)
        x0_base = o + e * (minp + 1)                      # left == 0
        x0_fb = 2 * o + e * (minp + 1) + e * left         # left > 0
        x_left = jnp.where(left == 0, x0_base, x0_fb)
        c_left = jnp.take_along_axis(c, left[:, None], 1)[:, 0]
        m_left = jnp.where(left == 0, x_left, jnp.maximum(c_left, x_left))
        m_left = jnp.where(i == 0, 0, m_left)
        x_left = jnp.where(i == 0, 0, x_left)
        v_left = jnp.stack([m_left, x_left], axis=-1)
        m_row, x_row = _affine_row_scan(c, v_left, is_left, in_band, o, e)
        # row 0 takes y directly — its x state never competes (":60-66")
        m_row = jnp.where(i == 0, row0_y, m_row)
        x_row = jnp.where(i == 0, 0, x_row)
        m_row = jnp.where(in_band, m_row, NEG)
        y_row = jnp.where(in_band, y_row, NEG)

        # path_x plane (":99-120": 'X' iff x[j-1] > m[j-1] + o, j_rel > 0)
        x_prev = jnp.roll(x_row, 1, axis=1).at[:, 0].set(NEG)
        m_prev = jnp.roll(m_row, 1, axis=1).at[:, 0].set(NEG)
        stay_x = (x_prev > m_prev + o) & ~is_left
        px_code = jnp.where(stay_x, X_DIR, O)
        px_pred = jnp.where(stay_x, i, 0)
        l_pred = jnp.where(is_left, minp, i)

        # --- M directions: the mode-2 cascade (":143-195") ---
        l_val = x_row
        u_val = y_row
        d_lt_l = d_val < l_val
        l_lt_u = l_val < u_val
        d_lt_u = d_val < u_val
        # has_d branch
        dir_code_d = jnp.where(
            d_lt_l,
            jnp.where(
                l_lt_u,
                jnp.where(u_pred == 0, LOW_U, U_DIR),      # ":153-157" quirk
                L_DIR,
            ),
            jnp.where(d_lt_u, U_DIR, jnp.where(seq == code_i, D, LOW_D)),
        )
        pred_d = jnp.where(
            d_lt_l,
            jnp.where(l_lt_u, u_pred, l_pred),
            jnp.where(d_lt_u, u_pred, d_idx),
        )
        # no-d branch (":372-378"): l < u => U else L
        dir_code_nd = jnp.where(l_lt_u, U_DIR, L_DIR)
        pred_nd = jnp.where(l_lt_u, u_pred, l_pred)
        dcode = jnp.where(has_d, dir_code_d, dir_code_nd)
        pred_sel = jnp.where(has_d, pred_d, pred_nd)
        # base cases
        is_base = is_left & (left == 0)[:, None] & (i > 0)
        dcode = jnp.where(is_base, U_DIR, dcode)
        pred_sel = jnp.where(is_base, minp, pred_sel)
        dcode = jnp.where(i == 0, jnp.where(jcol == 0, O, L_DIR)[None, :], dcode)
        pred_sel = jnp.where(i == 0, 0, pred_sel)
        packed = jnp.where(in_band, pred_sel * 16 + dcode, 0)
        packed_x = jnp.where(in_band, px_pred * 16 + px_code, 0)
        packed_y = jnp.where(in_band, py_pred * 16 + py_code, 0)
        packed_x = jnp.where(i == 0, 0, packed_x)
        packed_y = jnp.where(i == 0, 0, packed_y)

        masked = jnp.where(in_band, m_row, NEG)
        bsp_i = Lp - 1 - jnp.argmax(masked[:, ::-1], axis=1).astype(jnp.int32)

        m = jax.lax.dynamic_update_slice(m, m_row[:, None, :], (0, i, 0))
        y = jax.lax.dynamic_update_slice(y, y_row[:, None, :], (0, i, 0))
        lefts = jax.lax.dynamic_update_slice(lefts, left[:, None], (0, i))
        rights = jax.lax.dynamic_update_slice(rights, right[:, None], (0, i))
        bsp = jax.lax.dynamic_update_slice(bsp, bsp_i[:, None], (0, i))
        return (m, y, lefts, rights, bsp), (packed, packed_x, packed_y)

    m0 = jnp.zeros((B, n, Lp), dtype=jnp.int32)
    y0 = jnp.zeros((B, n, Lp), dtype=jnp.int32)
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
    (m, y, lefts, rights, _), (packed, packed_x, packed_y) = jax.lax.scan(
        step, (m0, y0, z, z, z), xs
    )

    def _finish(p):
        return jnp.concatenate(
            [jnp.moveaxis(p, 0, 1), jnp.zeros((B, 1, Lp), jnp.int32)], axis=1
        )

    packed, packed_x, packed_y = _finish(packed), _finish(packed_x), _finish(packed_y)

    cand = jnp.asarray((n - 2,) + dg.sink_rows, dtype=jnp.int32)
    cand_right = rights[:, cand]
    mcand = m[:, cand, :]
    vals = jnp.take_along_axis(mcand, (cand_right - 1)[..., None], axis=2)[..., 0]
    bidx = jnp.argmax(vals, axis=1)
    last_row = cand[bidx]
    score = jnp.take_along_axis(vals, bidx[:, None], 1)[:, 0]
    last_col_abs = jnp.take_along_axis(cand_right, bidx[:, None], 1)[:, 0] - 1
    return score, last_row, last_col_abs, packed, packed_x, packed_y, lefts, rights, m, y


@functools.partial(jax.jit, static_argnames=("W",))
def _fill_gap_global_windowed(dg, table, seq, L, bta, o, e, W):
    """Mode-2 fill with O(W)-lane windowed rows (long reads).

    Same recurrence and tie semantics as ``_fill_gap_global``
    (gap_global_abpoa.rs:11-250) but each row stores only the W columns
    [ws_i, ws_i+W) around its band — the affine-mode counterpart of
    ``poa_engine._fill_global_windowed`` (reference analogue:
    utils.rs:17-72's O(band) rows apply to the banded affine kernel
    too).  Returns the full-width tuple plus per-row window starts and
    a per-read ``over`` flag; callers rerun overflowing reads through
    the exact full-width engine.
    """
    n, Pm = dg.n, dg.max_preds
    B, Lp = seq.shape
    Q = 8
    kcol = jnp.arange(W, dtype=jnp.int32)

    def step(carry, xs):
        m, y, wss, lefts, rights, bsp, over = carry
        i, code_i, pidx, pmask, minp, r_i = xs
        pidx_safe = jnp.maximum(pidx, 0)

        # --- adaptive band (same math as the full-width engine) ---
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
        is_left = jabs == left[:, None]
        seq_w = jnp.take_along_axis(seq, jnp.minimum(jabs, Lp - 1), axis=1)
        subrow_i = table[code_i][seq_w]

        # --- gather predecessor windows, realigned to jabs ---
        ws_p = wss[:, pidx_safe]                            # [B, Pm]
        shift = (ws_i[:, None] - ws_p)[:, :, None]          # [B, Pm, 1]
        idx = shift + kcol                                  # [B, Pm, W]
        ok = (idx >= 0) & (idx < W)
        idx_c = jnp.clip(idx, 0, W - 1)
        okm1 = (idx >= 1) & (idx <= W)
        idx_m1 = jnp.clip(idx - 1, 0, W - 1)
        mp_raw = m[:, pidx_safe, :]
        yp_raw = y[:, pidx_safe, :]
        mp = jnp.where(ok, jnp.take_along_axis(mp_raw, idx_c, axis=2), NEG)
        yp = jnp.where(ok, jnp.take_along_axis(yp_raw, idx_c, axis=2), NEG)
        mp_m1 = jnp.where(
            okm1, jnp.take_along_axis(mp_raw, idx_m1, axis=2), NEG
        )
        leftp = lefts[:, pidx_safe]
        rightp = rights[:, pidx_safe]
        cov = pmask[None, :, None] & (leftp[..., None] <= jabs[:, None]) & (
            jabs[:, None] < rightp[..., None]
        )

        # Y candidates (gap_global_abpoa.rs:121-141,294-346)
        um_vals = jnp.where(cov, mp, NEG)
        um_best = um_vals.max(axis=1)
        um_idx = pidx_safe[um_vals.argmax(axis=1)]
        uy_vals = jnp.where(cov, yp, NEG)
        uy_best = uy_vals.max(axis=1)
        uy_idx = pidx_safe[uy_vals.argmax(axis=1)]
        covered = um_best > NEG // 2
        um_best = um_best + o
        y_fb = 2 * o + e * (minp + 1) + e * jabs            # ":137"
        from_y = uy_best > um_best                          # strict (":328")
        y_row = jnp.where(covered, jnp.maximum(um_best, uy_best) + e, y_fb)
        u_pred = jnp.where(covered, jnp.where(from_y, uy_idx, um_idx), minp)
        py_code = jnp.where(covered & from_y, Y_DIR, O)
        py_pred = jnp.where(covered & from_y, uy_idx, 0)

        # D candidates (":143-195,252-292")
        d_cov = pmask[None, :, None] & (leftp[..., None] < jabs[:, None]) & (
            jabs[:, None] <= rightp[..., None]
        )
        d_vals = jnp.where(d_cov, mp_m1, NEG)
        d_best = d_vals.max(axis=1)
        d_idx = pidx_safe[d_vals.argmax(axis=1)]
        has_d = d_best > NEG // 2
        d_val = d_best + subrow_i

        # row 0 (":60-66")
        row0_y = jnp.where(jabs == 0, 0, o + e * jabs)
        y_row = jnp.where(i == 0, row0_y, y_row)

        # --- in-row (M,X) affine scan over the window ---
        c = jnp.maximum(d_val, y_row)
        c = jnp.where(has_d | (i == 0), jnp.where(i == 0, row0_y, c), y_row)
        x0_base = o + e * (minp + 1)
        x0_fb = 2 * o + e * (minp + 1) + e * left
        x_left = jnp.where(left == 0, x0_base, x0_fb)
        left_rel = jnp.clip(left - ws_i, 0, W - 1)
        c_left = jnp.take_along_axis(c, left_rel[:, None], 1)[:, 0]
        m_left = jnp.where(left == 0, x_left, jnp.maximum(c_left, x_left))
        m_left = jnp.where(i == 0, 0, m_left)
        x_left = jnp.where(i == 0, 0, x_left)
        v_left = jnp.stack([m_left, x_left], axis=-1)
        m_row, x_row = _affine_row_scan(c, v_left, is_left, in_band, o, e)
        m_row = jnp.where(i == 0, row0_y, m_row)
        x_row = jnp.where(i == 0, 0, x_row)
        m_row = jnp.where(in_band, m_row, NEG)
        y_row = jnp.where(in_band, y_row, NEG)

        # path_x plane (":99-120")
        x_prev = jnp.roll(x_row, 1, axis=1).at[:, 0].set(NEG)
        m_prev = jnp.roll(m_row, 1, axis=1).at[:, 0].set(NEG)
        stay_x = (x_prev > m_prev + o) & ~is_left
        px_code = jnp.where(stay_x, X_DIR, O)
        px_pred = jnp.where(stay_x, i, 0)
        l_pred = jnp.where(is_left, minp, i)

        # --- M directions: the mode-2 cascade (":143-195") ---
        l_val = x_row
        u_val = y_row
        d_lt_l = d_val < l_val
        l_lt_u = l_val < u_val
        d_lt_u = d_val < u_val
        dir_code_d = jnp.where(
            d_lt_l,
            jnp.where(
                l_lt_u,
                jnp.where(u_pred == 0, LOW_U, U_DIR),       # ":153-157" quirk
                L_DIR,
            ),
            jnp.where(d_lt_u, U_DIR, jnp.where(seq_w == code_i, D, LOW_D)),
        )
        pred_d = jnp.where(
            d_lt_l,
            jnp.where(l_lt_u, u_pred, l_pred),
            jnp.where(d_lt_u, u_pred, d_idx),
        )
        dir_code_nd = jnp.where(l_lt_u, U_DIR, L_DIR)
        pred_nd = jnp.where(l_lt_u, u_pred, l_pred)
        dcode = jnp.where(has_d, dir_code_d, dir_code_nd)
        pred_sel = jnp.where(has_d, pred_d, pred_nd)
        is_base = is_left & (left == 0)[:, None] & (i > 0)
        dcode = jnp.where(is_base, U_DIR, dcode)
        pred_sel = jnp.where(is_base, minp, pred_sel)
        dcode = jnp.where(i == 0, jnp.where(jabs == 0, O, L_DIR), dcode)
        pred_sel = jnp.where(i == 0, 0, pred_sel)
        packed = jnp.where(in_band, pred_sel * 16 + dcode, 0)
        packed_x = jnp.where(in_band & (i > 0), px_pred * 16 + px_code, 0)
        packed_y = jnp.where(in_band & (i > 0), py_pred * 16 + py_code, 0)

        bsp_i = ws_i + W - 1 - jnp.argmax(
            jnp.where(in_band, m_row, NEG)[:, ::-1], axis=1
        ).astype(jnp.int32)

        m = jax.lax.dynamic_update_slice(m, m_row[:, None, :], (0, i, 0))
        y = jax.lax.dynamic_update_slice(y, y_row[:, None, :], (0, i, 0))
        wss = jax.lax.dynamic_update_slice(wss, ws_i[:, None], (0, i))
        lefts = jax.lax.dynamic_update_slice(lefts, left[:, None], (0, i))
        rights = jax.lax.dynamic_update_slice(rights, right[:, None], (0, i))
        bsp = jax.lax.dynamic_update_slice(bsp, bsp_i[:, None], (0, i))
        return (m, y, wss, lefts, rights, bsp, over), (packed, packed_x,
                                                       packed_y)

    m0 = jnp.zeros((B, n, W), dtype=jnp.int32)
    y0 = jnp.zeros((B, n, W), dtype=jnp.int32)
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
    (m, y, wss, lefts, rights, _, over), (packed, packed_x, packed_y) = (
        jax.lax.scan(step, (m0, y0, z, z, z, z, over0), xs)
    )

    def _finish(p):
        return jnp.concatenate(
            [jnp.moveaxis(p, 0, 1), jnp.zeros((B, 1, W), jnp.int32)], axis=1
        )

    packed, packed_x, packed_y = (
        _finish(packed), _finish(packed_x), _finish(packed_y)
    )

    cand = jnp.asarray((n - 2,) + dg.sink_rows, dtype=jnp.int32)
    cand_right = rights[:, cand]
    cand_rel = jnp.clip(cand_right - 1 - wss[:, cand], 0, W - 1)
    mcand = m[:, cand, :]
    vals = jnp.take_along_axis(mcand, cand_rel[..., None], axis=2)[..., 0]
    bidx = jnp.argmax(vals, axis=1)
    last_row = cand[bidx]
    score = jnp.take_along_axis(vals, bidx[:, None], 1)[:, 0]
    last_col_abs = jnp.take_along_axis(cand_right, bidx[:, None], 1)[:, 0] - 1
    return (score, last_row, last_col_abs, packed, packed_x, packed_y,
            lefts, rights, wss, over)


_long_w_hint_gap: dict[int, int] = {}


def fill_gap_global_long(dg, table, seq, L, bta, bta_max, o, e):
    """Mode-2 fill for long reads: windowed rows with a W ladder.

    Mirrors ``poa_engine.fill_global_long``: start at the smallest W
    covering 2·bta plus drift slack (or the last W that worked for this
    graph), double until no read's band overflows, fall back to the
    exact full-width fill at W >= Lp.  Returns (score, last_row,
    last_col_abs, packed, packed_x, packed_y, lefts, rights, ws | None);
    planes are [B, n, W].
    """
    Lp = seq.shape[1]
    W = _long_w_hint_gap.get(dg.n, 0)
    if W == 0:
        W = 256
        while W < 2 * bta_max + 64:
            W *= 2
    oj, ej = jnp.int32(o), jnp.int32(e)
    while W < Lp:
        out = _fill_gap_global_windowed(dg, table, seq, L, bta, oj, ej, W=W)
        if not bool(jax.device_get(out[9].any())):
            _long_w_hint_gap[dg.n] = W
            return out[:9]
        W *= 2
    _long_w_hint_gap[dg.n] = Lp
    return _fill_gap_global(dg, table, seq, L, bta, oj, ej)[:8] + (None,)


# ---------------------------------------------------------------------------
# mode 3 — affine-gap local POA, full matrix (gap_local_poa.rs:8-129)
# ---------------------------------------------------------------------------


@jax.jit
def _fill_gap_local(dg, table, seq, L, o, e):
    n, Pm = dg.n, dg.max_preds
    B, Lp = seq.shape
    # (seq[j], lnz[i]) argument order, as in gap_local_poa.rs:57,137
    tT = table.T
    SUBP = sub_planes(tT, seq)      # [A, B, Lp]
    jcol = jnp.arange(Lp, dtype=jnp.int32)
    valid = jcol[None, :] < L[:, None]
    in_band = valid
    is_left = (jcol == 0)[None, :] | jnp.zeros((B, Lp), bool)

    def step(carry, xs):
        m, y, best_val, best_i, best_j = carry
        i, code_i, is_start, pidx, pmask = xs
        pidx_safe = jnp.maximum(pidx, 0)
        subrow_i = sub_row(SUBP, code_i)

        mp = jnp.where(pmask[None, :, None], m[:, pidx_safe, :], NEG)
        yp = jnp.where(pmask[None, :, None], y[:, pidx_safe, :], NEG)
        mp_sh = jnp.roll(mp, 1, axis=2).at[:, :, 0].set(NEG)

        # start rows: first-best quirk, running max from 0/index(row)0
        # (gap_local_poa.rs:131-187)
        d_pre = mp_sh.max(axis=1)
        d_arg = pidx_safe[mp_sh.argmax(axis=1)]
        d_val_s = jnp.maximum(d_pre, 0) + subrow_i
        d_idx_s = jnp.where(d_pre > 0, d_arg, 0)
        um_pre = mp.max(axis=1) + o
        um_arg = pidx_safe[mp.argmax(axis=1)]
        um_s = jnp.maximum(um_pre, 0)
        um_idx_s = jnp.where(um_pre > 0, um_arg, 0)
        uy_pre = yp.max(axis=1)
        uy_arg = pidx_safe[yp.argmax(axis=1)]
        uy_s = jnp.maximum(uy_pre, 0)
        uy_idx_s = jnp.where(uy_pre > 0, uy_arg, 0)
        from_m_s = um_s > uy_s                             # ties => Y (":166-171")
        y_row_s = jnp.maximum(um_s, uy_s) + e
        y_idx_s = jnp.where(from_m_s, um_idx_s, uy_idx_s)

        # non-start rows (":56-73"): plain i-1; ties => M
        m_up = m[:, i - 1, :]
        y_up = y[:, i - 1, :]
        d_val_n = jnp.roll(m_up, 1, axis=1).at[:, 0].set(NEG) + subrow_i
        um_n = m_up + o
        uy_n = y_up
        from_y_n = uy_n > um_n                             # strict => Y
        y_row_n = jnp.maximum(um_n, uy_n) + e

        d_val = jnp.where(is_start, d_val_s, d_val_n)
        d_idx = jnp.where(is_start, d_idx_s, i - 1)
        y_row = jnp.where(is_start, y_row_s, y_row_n)
        u_idx = jnp.where(is_start, y_idx_s, i - 1)
        py_is_y = jnp.where(is_start, ~from_m_s, from_y_n)
        py_code = jnp.where(py_is_y, Y_DIR, M_DIR)
        py_pred = u_idx

        c = jnp.maximum(jnp.maximum(d_val, y_row), 0)
        v_left = jnp.zeros((B, 2), dtype=jnp.int32)
        m_row, x_row = _affine_row_scan(c, v_left, is_left, in_band, o, e)
        border = (i == 0) | (jcol == 0)[None, :] | ~valid
        m_row = jnp.where(border, 0, m_row)
        x_row = jnp.where(border, 0, x_row)
        y_row = jnp.where(border, 0, y_row)

        # path_x (":40-54"): X iff x[j-1] > m[j-1]+o (ties => M)
        x_prev = jnp.roll(x_row, 1, axis=1).at[:, 0].set(NEG)
        m_prev = jnp.roll(m_row, 1, axis=1).at[:, 0].set(NEG)
        stay_x = x_prev > m_prev + o
        px_code = jnp.where(stay_x, X_DIR, M_DIR)
        px_pred = jnp.full_like(px_code, 0) + i

        # M directions with zero floor (":96-110"); tie order D >= U >= L
        l_val = x_row
        u_val = y_row
        all_neg = (d_val < 0) & (u_val < 0) & (l_val < 0)
        d_ge_u = d_val >= u_val
        dirD = d_ge_u & (d_val >= l_val)
        dirU = (~d_ge_u) & (u_val >= l_val)
        dcode = jnp.where(
            dirD, jnp.where(seq == code_i, D, LOW_D), jnp.where(dirU, U_DIR, L_DIR)
        )
        pred_sel = jnp.where(dirD, d_idx, jnp.where(dirU, u_idx, i))
        dcode = jnp.where(all_neg, O, dcode)
        pred_sel = jnp.where(all_neg, 0, pred_sel)
        dcode = jnp.where(border, O, dcode)
        pred_sel = jnp.where(border, 0, pred_sel)
        packed = pred_sel * 16 + dcode
        packed_x = jnp.where(border, 0, px_pred * 16 + px_code)
        packed_y = jnp.where(border, 0, py_pred * 16 + py_code)

        row_masked = jnp.where(valid, m_row, NEG)
        rmax = row_masked.max(axis=1)
        rarg = row_masked.argmax(axis=1).astype(jnp.int32)
        upd = rmax > best_val
        best_val = jnp.where(upd, rmax, best_val)
        best_i = jnp.where(upd, i, best_i)
        best_j = jnp.where(upd, rarg, best_j)

        m = jax.lax.dynamic_update_slice(m, m_row[:, None, :], (0, i, 0))
        y = jax.lax.dynamic_update_slice(y, y_row[:, None, :], (0, i, 0))
        return (m, y, best_val, best_i, best_j), (packed, packed_x, packed_y)

    m0 = jnp.zeros((B, n, Lp), dtype=jnp.int32)
    y0 = jnp.zeros((B, n, Lp), dtype=jnp.int32)
    zb = jnp.zeros((B,), dtype=jnp.int32)
    rows = jnp.arange(n - 1, dtype=jnp.int32)
    xs = (
        rows,
        dg.codes[:-1],
        dg.node_start[:-1],
        dg.pred_idx[:-1],
        dg.pred_mask[:-1],
    )
    (m, y, best_val, best_i, best_j), (packed, packed_x, packed_y) = jax.lax.scan(
        step, (m0, y0, zb, zb, zb), xs
    )

    def _finish(p):
        return jnp.concatenate(
            [jnp.moveaxis(p, 0, 1), jnp.zeros((B, 1, Lp), jnp.int32)], axis=1
        )

    return (
        best_val,
        best_i,
        best_j,
        _finish(packed),
        _finish(packed_x),
        _finish(packed_y),
    )


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def fill_gap_global(dg, table, seq, L, bta, o, e):
    """Mode-2 fill: (score, last_row, last_col_abs, packed, packed_x,
    packed_y, lefts, rights), planes [B, n, Lp]."""
    out = _fill_gap_global(dg, table, seq, L, bta, jnp.int32(o), jnp.int32(e))
    return out[:8]


def fill_gap_local(dg, table, seq, L, o, e):
    """Mode-3 fill: (best_val, best_i, best_j, packed, packed_x,
    packed_y), planes [B, n, Lp]."""
    return _fill_gap_local(dg, table, seq, L, jnp.int32(o), jnp.int32(e))


def run_batch(mode, sequences, g, sm, o, e, btas) -> list[PoaState]:
    dg = poa_device_graph(g)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    seq, L = encode_reads(sequences)
    B = len(sequences)
    oj = jnp.int32(o)
    ej = jnp.int32(e)
    if mode == 2:
        from .poa_engine import LONG_READ_LP

        bta = encode_read_aux(btas)
        if seq.shape[1] >= LONG_READ_LP:
            out = fill_gap_global_long(
                dg, table, seq, L, bta, max(btas), o, e
            )
            (score, last_row, last_col, packed, px, py, lefts, rights,
             ws) = jax.device_get(out)
            states = []
            for b in range(B):
                wsb = None if ws is None else ws[b]
                st = _state_from_device(
                    score[b], last_row[b], last_col[b], packed[b], lefts[b],
                    rights[b], len(sequences[b]), ws=wsb,
                )
                st.path_x = _PackedPath(px[b], lefts[b], wsb)
                st.path_y = _PackedPath(py[b], lefts[b], wsb)
                st.band_check_ok = _gap_band_ampl_enough(
                    st.path, st.path_x, st.path_y, st.last_row, st.last_col,
                    st.ampl, len(sequences[b]),
                )
                states.append(st)
            return states
        # XLA's CPU fusion codegen miscompiles this scan for tiny graphs
        # (fusion_compiler.cc RET_CHECK, n <= ~8); run those eagerly —
        # they are test-sized anyway.
        import contextlib

        from .device import platform

        tiny = platform() == "cpu" and dg.n <= 16
        with jax.disable_jit() if tiny else contextlib.nullcontext():
            out = fill_gap_global(dg, table, seq, L, bta, o, e)
        score, last_row, last_col, packed, px, py, lefts, rights = (
            jax.device_get(out)
        )
        states = []
        for b in range(B):
            plane, plx, ply = packed[b], px[b], py[b]
            st = _state_from_device(
                score[b], last_row[b], last_col[b], plane, lefts[b], rights[b],
                len(sequences[b]),
            )
            st.path_x = _PackedPath(plx, lefts[b])
            st.path_y = _PackedPath(ply, lefts[b])
            st.band_check_ok = _gap_band_ampl_enough(
                st.path, st.path_x, st.path_y, st.last_row, st.last_col,
                st.ampl, len(sequences[b]),
            )
            states.append(st)
        return states
    if mode == 3:
        out = fill_gap_local(dg, table, seq, L, o, e)
        score, best_i, best_j, packed, px, py = jax.device_get(out)
        states = []
        for b in range(B):
            lb = len(sequences[b])
            lefts = np.zeros(dg.n, dtype=np.int32)
            rights = np.full(dg.n, lb, dtype=np.int32)
            plane, plx, ply = packed[b], px[b], py[b]
            st = _state_from_device(
                score[b], best_i[b], best_j[b], plane, lefts, rights, lb
            )
            st.path_x = _PackedPath(plx, lefts)
            st.path_y = _PackedPath(ply, lefts)
            states.append(st)
        return states
    raise ValueError(f"unsupported gap POA mode {mode}")
