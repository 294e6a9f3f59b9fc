"""Windowed O(W)-lane long-read fill for pathwise mode 4.

The reference's pathwise DP is FULL-width (pathwise_alignment.rs:16 —
it has no banding at all), so multi-kb reads cost O(n * L * P) memory
and work.  This engine stores only W columns per (read, row), centred
adaptively on the predecessor rows' best-scoring positions — the
long-read treatment modes 0/2 already have (the poa_engine and
poa_gap_engine windowed fills), extended to the pathwise recurrence.  This is
beat-the-reference capability: there is no reference semantics to pin
against, so exactness is vs our own full-width engine
(ops/pathwise_engine._fill_pathwise).

Exactness story (see PERF.md "Design note: windowed long-read
pathwise"):

* Out-of-window predecessor reads are NEG, and the recurrence is
  monotone, so windowed rep-lane values LOWER-bound the full-width
  ones, and any in-window value is exact unless its best path left the
  window somewhere.  (Downstream of a follower replay flip — see the
  caveat below — the lower bound can be violated on any lane the
  flipped value feeds, including rep lanes; every windowed value does
  stay bounded by its lane's plain-DP best, every move being legal, so
  the R accounting below stays conservative.  The single-path-graph
  test isolates the flip-free arithmetic, where the bound is exact:
  tests/test_pathwise_window.py.)
* The fill accumulates a sound exit bound R: every cell a successor
  row's shifted window strands (plus each row's right-edge cell, which
  can exit via an in-row L move) contributes ``value - Smax * column``
  where Smax = max(0, max substitution score).  Any alignment that
  ever leaves the window scores <= R + Smax * (L - 1): after leaving
  it can gain at most Smax per remaining consumed read char (D/L
  moves; U moves gain <= 0).
* Guard: the windowed best final STRICTLY beats that bound => every
  optimal alignment stays in-window, the cells the traceback visits
  are exact, and every tie candidate achieving a visited cell's max is
  exact too => byte-identical output (for the rep-lane argument; the
  known caveat is follower lanes, whose replayed values can shift if a
  non-optimal rep cell near a window edge is underestimated and flips
  a direction flag — the caller handles guard failure by doubling W
  and finally re-running the read full-width, and the fuzz suite pins
  equality empirically).

Layout lessons from the modes-6/7 rework (PERF.md "anti-patterns")
are applied: substitution planes hoisted, dynamic-slice lane reads,
shift-max chains, rows emitted as scan outputs where possible.  The
carry keeps the flat [n*P, B, W] plane of _fill_pathwise (pathwise
preds reach arbitrarily far back, and the flat leading-axis update is
the layout XLA keeps in place).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..scoring import GAP
from .poa_engine import cummax_last, sub_planes, sub_row

NEG = -(1 << 28)


def _rmin(dg) -> np.ndarray:
    """min over on-lanes of the path length remaining AFTER row i.

    The pathwise analogue of the reference's r-values (utils.rs
    set_r_values, which mode 0's band uses to pull its right edge
    toward column L - r near the end): a global alignment on lane p
    must sit at column >= L - remaining(p, i) at row i, so the window
    must cover it.
    """
    on = np.asarray(dg.paths_on, dtype=bool)               # [n, P]
    pos = np.cumsum(on, axis=0)                            # rows of p <= i
    totals = on.sum(axis=0)[None, :]
    rrem = np.where(on, totals - pos, 1 << 28)
    r = rrem.min(axis=1)
    return np.minimum(r, 1 << 27).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("W",))
def _fill_pathwise_win(dg, table, seq, L, W, rmin=None):
    """Windowed mode-4 (global) fill.

    Mode 5 (semiglobal) deliberately has NO windowed variant: a
    semiglobal alignment may start at column 0 of ANY row, so an
    alignment starting left of a row's window never crosses the exit
    frontier the bound accounts for, and the only sound ceiling for
    such starts is smax*(L-1) — the perfect-score ceiling — which makes
    the guard vacuous.  This mirrors the reference, whose adaptive band
    also exists only for the global modes (utils.rs:17-72 used by
    global_abpoa/gap_global_abpoa, never local/semi).

    seq: int32[B, Lp] ('$'-prefixed); L int32[B]; W static window width
    (multiple of 8).  Returns:
      Aw    int32[B, P, n, W]  windowed per-path absolute scores
      ws    int32[B, n]        per-row window starts (multiples of 8)
      bound int32[B]           R + Smax*(L-1): max score any alignment
                               that leaves the window can reach
    Mirrors ops/pathwise_engine._fill_pathwise (same group-rep
    semantics, tie order mx==d, mx==u, else L; untouched lanes 0).
    """
    n, P = dg.n, dg.paths_number
    B, Lp = seq.shape
    kcol = jnp.arange(W, dtype=jnp.int32)
    qdiag = jnp.arange(P)
    gseq_full = table[seq, GAP]                            # [B, Lp]
    SUBP = sub_planes(table, seq)                          # [A, B, Lp]
    smax = jnp.maximum(jnp.max(table), 0)
    OFF = 1 << 16

    def step(carry, xs):
        A, wss, bsp, R = carry
        # A: flat [n*P, B, W]; wss/bsp: [B, n]; R: [B]
        i, code_i, pvec, rvec, on, rmin_i = xs             # [P] each
        gap_i = table[code_i, GAP]
        p_safe = jnp.maximum(pvec, 0)
        r_safe = jnp.maximum(rvec, 0)

        # --- adaptive window: centred on the pred rows' best positions,
        # but always covering column L - remaining (a global alignment
        # must be there at this row — the r-values pull of mode 0) ---
        pred_bsp = bsp[:, p_safe]                          # [B, P]
        onb = on[None, :]
        ms = jnp.min(jnp.where(onb, pred_bsp, 1 << 28), axis=1)
        me = jnp.max(jnp.where(onb, pred_bsp, 0), axis=1)
        center = (ms + me) // 2 + 1
        # keep the required column at least W/8 from the right edge:
        # stranding happens at the edges, and the guard (correctly)
        # fails whenever a near-optimal cell is stranded
        right_target = jnp.maximum(me + 2, L - rmin_i + 2) + W // 8
        ws_i = jnp.maximum(
            jnp.maximum(center - W // 2, right_target - W), 0
        )
        ws_i = (ws_i // 8) * 8                             # [B]
        jabs = ws_i[:, None] + kcol[None, :]               # [B, W]
        in_read = jabs < L[:, None]
        seq_w = jnp.take_along_axis(seq, jnp.minimum(jabs, Lp - 1), axis=1)
        gseq_w = jnp.take_along_axis(
            gseq_full, jnp.minimum(jabs, Lp - 1), axis=1
        )
        subrow = jnp.take_along_axis(
            sub_row(SUBP, code_i), jnp.minimum(jabs, Lp - 1), axis=1
        )                                                  # [B, W]

        # --- gather pred windows, realigned to this row's window ---
        Aq = jnp.moveaxis(A[p_safe * P + qdiag], 0, 1)     # [B, P, W]
        Ar = jnp.moveaxis(A[p_safe * P + r_safe], 0, 1)
        ws_p = wss[:, p_safe]                              # [B, P]
        shift = (ws_i[:, None] - ws_p)[:, :, None]         # [B, P, 1]
        idx = shift + kcol                                 # [B, P, W]
        ok = (idx >= 0) & (idx < W)
        idx_c = jnp.clip(idx, 0, W - 1)
        Aq_al = jnp.where(ok, jnp.take_along_axis(Aq, idx_c, axis=2), NEG)
        Ar_al = jnp.where(ok, jnp.take_along_axis(Ar, idx_c, axis=2), NEG)
        okm1 = (idx >= 1) & (idx <= W)
        idx_m1 = jnp.clip(idx - 1, 0, W - 1)
        Aq_sh = jnp.where(
            okm1, jnp.take_along_axis(Aq, idx_m1, axis=2), NEG
        )
        Ar_sh = jnp.where(
            okm1, jnp.take_along_axis(Ar, idx_m1, axis=2), NEG
        )

        # --- exit-bound accounting: pred cells whose U/D moves land
        # outside this row's window — strictly left of it (U from
        # ws_i-1 lands at ws_i-1), or at/right of its last column (D
        # from ws_i+W-1 lands at ws_i+W); normalise by Smax * column ---
        jabs_p = ws_p[:, :, None] + kcol[None, None, :]    # [B, P, W]
        stranded = (jabs_p < ws_i[:, None, None]) | (
            jabs_p >= ws_i[:, None, None] + W - 1
        )
        stranded = stranded & onb[:, :, None] & (jabs_p < L[:, None, None])
        norm = jnp.where(stranded, Aq - smax * jabs_p, NEG)
        R = jnp.maximum(R, jnp.max(norm, axis=(1, 2)))

        # --- rep rows: (max,+) chain over the window ---
        d_r = Ar_sh + subrow[:, None, :]
        u_r = Ar_al + gap_i
        # column j==0 of the full engine: pred col 0 + gap
        Achain = jnp.maximum(d_r, u_r)
        at0 = jabs[:, None, :] == 0                        # [B, 1, W]
        Achain = jnp.where(at0, Ar_al + gap_i, Achain)
        Gw = jnp.cumsum(gseq_w, axis=1)                    # window-local
        rep_row = Gw[:, None, :] + cummax_last(Achain - Gw[:, None, :])

        dirD = rep_row == d_r
        dirU = ~dirD & (rep_row == u_r)
        # kcol==0 restarts the replay chain at the window edge (true
        # L-runs crossing the edge are lost => underestimate, which the
        # guard covers)
        nonL = dirD | dirU | at0 | (kcol == 0)[None, None, :]

        # --- non-rep replay via the packed chain ---
        vD = Aq_sh + subrow[:, None, :]
        vU = Aq_al + gap_i
        V = jnp.where(dirD, vD, vU)
        V = jnp.where(at0, Aq_al + gap_i, V)
        # clamp to the packing floor: out-of-window NEG values would
        # otherwise overflow the 17-bit field and decode as GARBAGE
        # (overestimates).  Gw - OFF is far below any true score under
        # the caller's fits gate (2*Lp*smax < 2^16), so the clamped
        # cell stays a sound lower bound.
        Vc = jnp.maximum(V - Gw[:, None, :], -OFF)
        enc = jnp.where(nonL, (kcol[None, None, :] << 17) | (Vc + OFF), -1)
        enc = cummax_last(enc)
        row = Gw[:, None, :] + (enc & ((1 << 17) - 1)) - OFF
        row = jnp.where(on[None, :, None], row, 0)
        row = jnp.where(in_read[:, None, :], row, NEG)

        # best-scoring position (rightmost max over on-lanes)
        rowv = jnp.max(jnp.where(on[None, :, None], row, NEG), axis=1)
        rowv = jnp.where(in_read, rowv, NEG)
        bsp_i = ws_i + W - 1 - jnp.argmax(rowv[:, ::-1], axis=1).astype(
            jnp.int32
        )

        # right-edge cells of THIS row can exit right via an in-row L
        # move (the pred-side accounting above only covers pred reads)
        edge = jnp.where(
            (jabs < L[:, None]) & (kcol == W - 1)[None, :],
            rowv - smax * jabs, NEG,
        )
        R = jnp.maximum(R, jnp.max(edge, axis=1))

        A = jax.lax.dynamic_update_slice(
            A, jnp.moveaxis(row, 0, 1), (i * P, 0, 0)
        )
        wss = jax.lax.dynamic_update_slice(wss, ws_i[:, None], (0, i))
        bsp = jax.lax.dynamic_update_slice(bsp, bsp_i[:, None], (0, i))
        return (A, wss, bsp, R), None

    A0 = jnp.zeros((n * P, B, W), dtype=jnp.int32)
    # row 0: all paths advance with sm(seq[j], '-') gaps, window at 0
    G0 = jnp.cumsum(gseq_full[:, :W], axis=1)
    row0 = jnp.broadcast_to((G0 - G0[:, :1])[None], (P, B, W))
    A0 = A0.at[:P].set(row0)
    wss0 = jnp.zeros((B, n), dtype=jnp.int32)
    bsp0 = jnp.zeros((B, n), dtype=jnp.int32)
    # row 0's own right-edge cell can L-exit right (scan edge terms
    # only cover rows it processes)
    R0 = jnp.where(
        W - 1 < L, row0[0, :, W - 1] - smax * (W - 1), NEG
    )

    rows = jnp.arange(1, n - 1, dtype=jnp.int32)
    xs = (
        rows,
        dg.codes[1 : n - 1],
        dg.pred_of[1 : n - 1],
        dg.rep_of[1 : n - 1],
        dg.paths_on[1 : n - 1],
        rmin[1 : n - 1],
    )
    (A, wss, bsp, R), _ = jax.lax.scan(step, (A0, wss0, bsp0, R0), xs)
    Aw = jnp.transpose(A.reshape(n, P, B, W), (2, 1, 0, 3))
    bound = R + smax * (L - 1)
    return Aw, wss, bound


@jax.jit
def _final_column_win(Aw, ws, L):
    """Aw[:, :, :, L-1 - ws] per read where in-window, else NEG."""
    B, P, n, W = Aw.shape
    rel = (L[:, None] - 1) - ws                            # [B, n]
    okc = (rel >= 0) & (rel < W)
    idx = jnp.clip(rel, 0, W - 1)[:, None, :, None]
    col = jnp.take_along_axis(Aw, idx, axis=3)[..., 0]     # [B, P, n]
    return jnp.where(okc[:, None, :], col, NEG)
