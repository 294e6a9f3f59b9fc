"""The CUDA mode-1 fill (native/cuda/fill_local.cu, ops/cuda_fill.py).

CUDA code has no interpret mode, so on the CPU this file checks what
surrounds the kernel — the launch plan, the choice of implementation by
platform, the shard_map wrapping, the build's failure path — and a
NumPy model of the kernel's own decomposition (per-thread column
chunks, warp and cross-warp (max,+) scans, the predecessor ring and its
device-memory spill, per-thread bests and their block reduction)
against the XLA engine ``poa_engine._fill_local``.  The tests marked
``gpu`` run the kernel itself against the same reference on the card
(chip_smoke.py, phase 6).
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest

from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.io import fasta, gfa as gfa_io
from recgraph_tpu.ops import cuda_fill, poa_engine
from recgraph_tpu.ops.encode import encode_reads, poa_device_graph
from recgraph_tpu.parallel import mesh as pmesh
from recgraph_tpu.scoring import ScoreMatrix

from test_fuzz_random_graphs import random_gfa, random_read

NEG, IDA = -(1 << 28), -(1 << 30)
GAP, NCODE = 5, 4
O, D, LOW_D, L_DIR, U_DIR = 0, 1, 2, 3, 4


def _compose(a, g, pa, pg):
    """The map "(pa, pg), then (a, g)" of fill_local.cu's compose()."""
    return np.maximum(a, pa + g), pg + g


def emulate(dg, table, seq, L, pl, ring_garbage=12345):
    """NumPy model of fill_local_kernel<C>, thread by thread."""
    tab = np.asarray(table, np.int64)
    seq = np.asarray(seq)
    L = np.asarray(L)
    codes = np.asarray(dg.codes)
    start = np.asarray(dg.node_start)
    pidx = np.asarray(dg.pred_idx)
    prank = np.asarray(dg.pred_rank)
    erank = np.asarray(dg.erank)
    B, Lp = seq.shape
    n, T, C, W = dg.n, pl.threads, pl.cols, pl.lpad
    nw = T // 32
    j = np.arange(W)
    lane = np.arange(32)
    out_v, out_i, out_j = (np.zeros(B, np.int64) for _ in range(3))
    packed = np.zeros((B, n, Lp), np.int64)
    for b in range(B):
        sq = np.full(W, NCODE)
        sq[:Lp] = seq[b]
        gs = tab[sq, GAP]
        # only slot 0 is written before use; the rest must never be read
        ring = np.full((pl.ring, W), ring_garbage, np.int64)
        ring[0] = 0
        ends = np.zeros((max(dg.n_ends, 1), Lp), np.int64)
        prev = np.zeros(W, np.int64)
        seen = 1
        tbv, tbi, tbj = (np.zeros(T, np.int64) for _ in range(3))
        for i in range(1, n - 1):
            code = codes[i]
            sub = tab[sq, code]
            gnode = tab[GAP, code]
            if not start[i]:
                dv = np.concatenate([[NEG], prev[:-1]]) + sub
                uv = prev + gnode
                di = ui = np.full(W, i - 1)
            else:
                dpre = np.full(W, NEG - 1)
                upre = np.full(W, NEG - 1)
                darg = np.zeros(W, np.int64)
                uarg = np.zeros(W, np.int64)
                for k in range(pidx.shape[1]):
                    pr = pidx[i, k]
                    if pr < 0:
                        continue
                    rk = prank[i, k]
                    if seen - 1 - rk < pl.ring:
                        src, width = ring[rk % pl.ring], W
                    else:
                        assert pl.use_global
                        src, width = ends[rk], Lp
                    src = np.concatenate([src, np.full(W - width, NEG)])
                    uval = np.where(j < width, src, NEG)
                    dval = np.where(
                        (j == 0) | (j - 1 >= width), NEG, np.roll(src, 1)
                    )
                    up = dval > dpre
                    dpre, darg = np.where(up, dval, dpre), np.where(up, pr, darg)
                    up = uval > upre
                    upre, uarg = np.where(up, uval, upre), np.where(up, pr, uarg)
                dv = np.maximum(dpre, 0) + sub
                di = np.where(dpre > 0, darg, 0)
                uv = np.maximum(upre, 0) + gnode
                ui = np.where(upre > 0, uarg, 0)
            A = np.where(j == 0, 0, np.maximum(np.maximum(dv, uv), 0))
            At, gt = A.reshape(T, C), gs.reshape(T, C)
            ta, tg = np.full(T, IDA, np.int64), np.zeros(T, np.int64)
            for c in range(C):
                ta, tg = _compose(At[:, c], gt[:, c], ta, tg)
            wa, wg = ta.reshape(nw, 32), tg.reshape(nw, 32)
            for off in (1, 2, 4, 8, 16):
                pa = np.concatenate([wa[:, :off], wa[:, :-off]], axis=1)
                pg = np.concatenate([wg[:, :off], wg[:, :-off]], axis=1)
                na, ng = _compose(wa, wg, pa, pg)
                wa = np.where(lane >= off, na, wa)
                wg = np.where(lane >= off, ng, wg)
            ea = np.where(lane == 0, IDA, np.roll(wa, 1, axis=1))
            eg = np.where(lane == 0, 0, np.roll(wg, 1, axis=1))
            xa, xg = np.full(nw, IDA, np.int64), np.zeros(nw, np.int64)
            for w in range(1, nw):
                xa[w], xg[w] = _compose(wa[w - 1, 31], wg[w - 1, 31],
                                        xa[w - 1], xg[w - 1])
            ea, eg = _compose(ea, eg, xa[:, None], xg[:, None])
            x = ea.reshape(T)
            m = np.zeros((T, C), np.int64)
            for c in range(C):
                x = np.maximum(At[:, c], x + gt[:, c])
                m[:, c] = x
            m = np.where(j < L[b], m.reshape(W), NEG)
            m[0] = 0
            lv = np.concatenate([[NEG], m[:-1]]) + gs
            valid = j < L[b]
            o_cell = (j == 0) | ~valid | ((dv < 0) & (uv < 0) & (lv < 0))
            isd = (dv >= uv) & (dv >= lv)
            isu = ~(dv >= uv) & (uv >= lv)
            dcode = np.where(isd, np.where(sq == code, D, LOW_D),
                             np.where(isu, U_DIR, L_DIR))
            pred = np.where(isd, di, np.where(isu, ui, i))
            cell = np.where(o_cell, 0, pred * 16 + dcode)
            packed[b, i] = cell[:Lp]
            rv = np.where(valid, m, NEG).reshape(T, C)
            for c in range(C):
                up = rv[:, c] > tbv
                tbv = np.where(up, rv[:, c], tbv)
                tbi = np.where(up, i, tbi)
                tbj = np.where(up, j.reshape(T, C)[:, c], tbj)
            if erank[i] >= 0:
                ring[seen % pl.ring] = m
                ends[seen] = m[:Lp]
                seen += 1
            prev = m
        k = np.lexsort((tbj, tbi, -tbv))[0]
        out_v[b], out_i[b], out_j[b] = tbv[k], tbi[k], tbj[k]
    return out_v, out_i, out_j, packed


def _example(matrix="none", n_reads=3, pad_to=None):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    seqs, _ = fasta.get_sequences(os.path.join(root, "example", "reads.fa"))
    g = PoaGraph.from_gfa(
        gfa_io.parse_gfa(os.path.join(root, "example", "graph.gfa"))
    )
    sm = ScoreMatrix.create(matrix, 2, -4)
    seq, L = encode_reads(seqs[:n_reads], pad_to=pad_to)
    return poa_device_graph(g), jnp.asarray(sm.table, jnp.int32), seq, L


def _random(seed, read_len=None, n_reads=3):
    rng = random.Random(seed)
    gfa = random_gfa(rng, n_nodes=24, n_paths=4)
    reads = [random_read(rng, gfa) for _ in range(n_reads)]
    if read_len:
        reads = [
            "$" + "".join(rng.choice("ACGT") for _ in range(read_len - 1))
            for _ in range(n_reads)
        ]
    sm = ScoreMatrix.create("none", 2, -4)
    seq, L = encode_reads(reads)
    g = PoaGraph.from_gfa(gfa)
    return poa_device_graph(g), jnp.asarray(sm.table, jnp.int32), seq, L


def _assert_equal(got, ref):
    for name, a, b in zip(("score", "best_i", "best_j", "packed"), got, ref):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


def _force_plan(Lp, span, cols=None, budget=None, monkeypatch=None):
    if budget is not None:
        monkeypatch.setattr(cuda_fill, "SMEM_BUDGET", budget)
    pl = cuda_fill.plan(Lp, span)
    if cols is not None and cols != pl.cols:
        threads = cuda_fill._ceil(cuda_fill._ceil(Lp, cols), 32) * 32
        pl = cuda_fill.Plan(cols, threads, cols * threads, pl.ring,
                            pl.use_global)
    return pl


# ---------------------------------------------------------------------------
# the kernel's decomposition, modelled on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("matrix", ["none", "HOXD70"])
def test_model_matches_xla_example(matrix):
    dg, table, seq, L = _example(matrix)
    pl = cuda_fill.plan(seq.shape[1], dg.compact_span)
    assert not pl.use_global and pl.ring == dg.compact_span + 1
    _assert_equal(emulate(dg, table, seq, L, pl),
                  poa_engine._fill_local(dg, table, seq, L))


def test_model_device_memory_spill(monkeypatch):
    """A ring smaller than the compact span spills far predecessors to
    the device-memory copy of the end rows."""
    dg, table, seq, L = _example()
    Lp = seq.shape[1]
    w = cuda_fill.plan(Lp, 0).lpad
    budget = 4 * (7 * 7 + 1 + 64 + 2 * w + 3 * w)   # room for 3 slots
    pl = _force_plan(Lp, dg.compact_span, budget=budget,
                     monkeypatch=monkeypatch)
    assert pl.use_global and pl.ring == 3
    _assert_equal(emulate(dg, table, seq, L, pl),
                  poa_engine._fill_local(dg, table, seq, L))


@pytest.mark.parametrize("seed,cols", [(101, 1), (202, 2), (303, 4)])
def test_model_random_graphs(seed, cols):
    dg, table, seq, L = _random(seed)
    pl = _force_plan(seq.shape[1], dg.compact_span, cols=cols)
    _assert_equal(emulate(dg, table, seq, L, pl),
                  poa_engine._fill_local(dg, table, seq, L))


def test_model_many_warps():
    """Reads wider than one warp's columns: the cross-warp prefix."""
    dg, table, seq, L = _random(404, read_len=300, n_reads=2)
    pl = cuda_fill.plan(seq.shape[1], dg.compact_span)
    assert pl.threads // 32 > 1
    _assert_equal(emulate(dg, table, seq, L, pl),
                  poa_engine._fill_local(dg, table, seq, L))


# ---------------------------------------------------------------------------
# launch plan and choice of implementation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "Lp,span,cols,threads,ring,spill",
    [
        (152, 3, 1, 160, 4, False),      # stretch chunk
        (256, 13, 1, 256, 14, False),    # example graph at Lp=256
        (32, 0, 1, 32, 1, False),        # tiny reads
        (520, 13, 2, 288, 14, False),    # past one column per thread
        (2408, 13, 8, 320, 14, False),   # long reads
        (8192, 500, 16, 512, 4, True),   # widest reads, far predecessors
    ],
)
def test_plan(Lp, span, cols, threads, ring, spill):
    pl = cuda_fill.plan(Lp, span)
    assert (pl.cols, pl.threads, pl.ring, pl.use_global) == (
        cols, threads, ring, spill
    )
    assert pl.lpad == cols * threads >= Lp
    assert pl.threads % 32 == 0 and pl.threads <= cuda_fill.MAX_THREADS
    assert pl.smem_bytes() <= cuda_fill.SMEM_BUDGET


def test_plan_rejects_too_wide():
    with pytest.raises(ValueError):
        cuda_fill.plan(cuda_fill.MAX_LP + 8, 1)


@pytest.mark.parametrize(
    "platform,Lp,want",
    [("gpu", 152, True), ("gpu", cuda_fill.MAX_LP + 8, False),
     ("cpu", 152, False)],
)
def test_use_kernel_by_platform(monkeypatch, platform, Lp, want):
    monkeypatch.setattr(cuda_fill, "platform", lambda: platform)
    assert cuda_fill.use_kernel(Lp) is want


def test_fill_local_best_takes_xla_on_cpu(monkeypatch):
    dg, table, seq, L = _example()

    def boom(*a, **k):
        raise AssertionError("kernel path taken on the CPU")

    monkeypatch.setattr(cuda_fill, "fill_local", boom)
    _assert_equal(poa_engine.fill_local_best(dg, table, seq, L),
                  poa_engine._fill_local(dg, table, seq, L))


def _stand_in(dg, table, seq, L, pl):
    assert isinstance(pl, cuda_fill.Plan)
    return poa_engine._fill_local(dg, table, seq, L)


@pytest.mark.parametrize("with_mesh", [False, True])
def test_fill_local_shard_map(with_mesh):
    """With a reads mesh the call runs per device in shard_map (8
    virtual CPU devices here), with the graph replicated; the result
    equals the unsharded reference."""
    dg, table, seq, L = _example(n_reads=5)
    ref = poa_engine._fill_local(dg, table, seq, L)
    prev = pmesh.set_active_mesh(pmesh.auto_mesh() if with_mesh else None)
    try:
        if with_mesh:
            dg, table, seq, L = _example(n_reads=5)   # mesh-placed inputs
            assert seq.shape[0] % pmesh.get_active_mesh().size == 0
        got = cuda_fill.fill_local(dg, table, seq, L, callee=_stand_in)
        if with_mesh:
            assert got[3].sharding.spec[0] == pmesh.READS_AXIS
    finally:
        pmesh.set_active_mesh(prev)
    _assert_equal([np.asarray(x)[:5] for x in got], ref)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def _isolated_build(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_fill, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_fill, "LIBRARY",
                        str(tmp_path / "build" / "libfill_local.so"))


def test_build_failure_raises_without_nvcc(monkeypatch, tmp_path):
    _isolated_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="cannot run nvcc"):
        cuda_fill.build(nvcc=str(tmp_path / "no-such-nvcc"))


def test_build_failure_raises_on_compile_error(monkeypatch, tmp_path):
    _isolated_build(monkeypatch, tmp_path)
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        cuda_fill.build(nvcc=str(fake))
    assert not os.path.exists(cuda_fill.LIBRARY)


def test_build_writes_library_and_reuses_it(monkeypatch, tmp_path):
    _isolated_build(monkeypatch, tmp_path)
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    fake.chmod(0o755)
    path = cuda_fill.build(nvcc=str(fake))
    assert open(path).read() == "built\n"
    fake.write_text("#!/bin/sh\nexit 1\n")   # up to date: not rerun
    assert cuda_fill.build(nvcc=str(fake)) == path


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("matrix", ["none", "HOXD70"])
def test_kernel_matches_xla_example(gpu, matrix):
    dg, table, seq, L = _example(matrix, n_reads=52)
    _assert_equal(cuda_fill.fill_local(dg, table, seq, L),
                  poa_engine._fill_local(dg, table, seq, L))


@pytest.mark.gpu
@pytest.mark.parametrize("seed,read_len", [(101, None), (202, 600),
                                           (303, 1100), (404, 2100)])
def test_kernel_matches_xla_random(gpu, seed, read_len):
    dg, table, seq, L = _random(seed, read_len=read_len, n_reads=16)
    _assert_equal(cuda_fill.fill_local(dg, table, seq, L),
                  poa_engine._fill_local(dg, table, seq, L))


@pytest.mark.gpu
def test_kernel_device_memory_spill(gpu, monkeypatch):
    dg, table, seq, L = _example(n_reads=52)
    Lp = seq.shape[1]
    w = cuda_fill.plan(Lp, 0).lpad
    monkeypatch.setattr(cuda_fill, "SMEM_BUDGET",
                        4 * (7 * 7 + 1 + 64 + 5 * w))
    assert cuda_fill.plan(Lp, dg.compact_span).use_global
    _assert_equal(cuda_fill.fill_local(dg, table, seq, L),
                  poa_engine._fill_local(dg, table, seq, L))
