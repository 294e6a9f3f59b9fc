"""Host->device graph encodings.

The graph compilers (graph/poagraph.py, graph/pathgraph.py) produce
Python/NumPy structures; this module lowers them to the dense device
arrays consumed by the scan kernels, and caches the result on the graph
object so repeated batches reuse the same device buffers.

Reference mapping (see SURVEY.md §7.2): ``LnzGraph``/``PathGraph``
(reference: src/graph.rs:23-27, src/pathwise_graph.rs:10-18) become
flat int32 arrays with -1-padded predecessor lists.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.poagraph import PoaGraph
from ..graph.pathgraph import PathGraph, pathwise_meta


@dataclass(frozen=True)
class PoaDeviceGraph:
    """Dense arrays for the POA kernels (modes 0-3)."""

    codes: jnp.ndarray       # int32[n]   lnz base codes
    node_start: jnp.ndarray  # bool[n]
    pred_idx: jnp.ndarray    # int32[n, Pm]  predecessor end positions, -1 pad
    pred_mask: jnp.ndarray   # bool[n, Pm]
    min_pred: jnp.ndarray    # int32[n]   fallback predecessor (min pred / i-1)
    r_values: jnp.ndarray    # int32[n]   distance-to-sink (utils.rs:103-126)
    # compact predecessor-ring metadata: predecessors of node-start rows
    # are always node *ends*, so a ring of rows indexed by end rank needs
    # only O(nodes-spanned) slots instead of O(rows-spanned) — erank[i]
    # is row i's rank among end rows (-1 elsewhere), pred_rank the rank
    # of each padded predecessor, compact_span the max number of ends
    # written between a pred's ring write and its last read, n_ends the
    # number of end rows (used by the CUDA mode-1 kernel)
    erank: jnp.ndarray       # int32[n]
    pred_rank: jnp.ndarray   # int32[n, Pm]
    sink_rows: tuple[int, ...]  # F's predecessor end positions, ascending
    n: int
    max_preds: int
    compact_span: int
    n_ends: int


jax.tree_util.register_dataclass(
    PoaDeviceGraph,
    data_fields=["codes", "node_start", "pred_idx", "pred_mask", "min_pred",
                 "r_values", "erank", "pred_rank"],
    meta_fields=["sink_rows", "n", "max_preds", "compact_span", "n_ends"],
)


def _mesh_key():
    from ..parallel import mesh as pmesh

    m = pmesh.get_active_mesh()
    return m, (None if m is None else tuple(id(d) for d in m.devices.flat))


def _place_device_graph(g: object, build, key: str = "_device_graph") -> object:
    """Cache a device graph per (graph, active mesh).

    The uncommitted single-device build is kept as the base; when a
    data-parallel mesh is active its arrays are replicated across the
    mesh (once — reused by every subsequent batch).
    """
    mesh, mkey = _mesh_key()
    if g.__dict__.get(key + "_mesh", ()) == mkey:
        return g.__dict__[key]
    base = g.__dict__.get(key + "_base")
    if base is None:
        base = build()
        g.__dict__[key + "_base"] = base
    if mesh is not None:
        from ..parallel import mesh as pmesh

        dg = pmesh.replicate(mesh, base)
    else:
        dg = base
    g.__dict__[key] = dg
    g.__dict__[key + "_mesh"] = mkey
    return dg


def poa_device_graph(g: PoaGraph) -> PoaDeviceGraph:
    return _place_device_graph(g, lambda: _build_poa_device_graph(g))


def _build_poa_device_graph(g: PoaGraph) -> PoaDeviceGraph:
    idx, mask = g.padded_preds()
    n = g.n
    min_pred = np.zeros(n, dtype=np.int32)
    for i in range(1, n):
        min_pred[i] = g.min_pred(i)

    # compact end-rank ring metadata (see PoaDeviceGraph docstring)
    is_end = np.zeros(n, dtype=bool)
    is_end[0] = True
    for preds in g.preds.values():
        for p in preds:
            is_end[p] = True
    ends_before = np.cumsum(is_end)                # ends at rows <= i
    erank = np.where(is_end, ends_before - 1, -1).astype(np.int32)
    pred_rank = np.where(mask, erank[np.maximum(idx, 0)], -1).astype(np.int32)
    compact_span = 0
    for i, preds in g.preds.items():
        for p in preds:
            if p > 0:
                compact_span = max(
                    compact_span, int(ends_before[i - 1] - 1 - erank[p]) + 1
                )

    dg = PoaDeviceGraph(
        codes=jnp.asarray(g.codes, dtype=jnp.int32),
        node_start=jnp.asarray(g.node_start),
        pred_idx=jnp.asarray(idx, dtype=jnp.int32),
        pred_mask=jnp.asarray(mask),
        min_pred=jnp.asarray(min_pred),
        r_values=jnp.asarray(g.r_values(), dtype=jnp.int32),
        erank=jnp.asarray(erank),
        pred_rank=jnp.asarray(pred_rank),
        sink_rows=tuple(int(p) for p in g.preds[n - 1]),
        n=n,
        max_preds=idx.shape[1],
        compact_span=compact_span,
        n_ends=int(is_end.sum()),
    )
    return dg


@dataclass(frozen=True)
class PathDeviceGraph:
    """Dense arrays for the pathwise kernels (modes 4-9).

    ``rep_of``/``pred_of`` materialise the reference's alpha/delta group
    semantics (see graph.pathgraph.pathwise_meta): at row i every path p
    moves in the direction chosen by its group representative
    ``rep_of[i, p]`` reading from predecessor row ``pred_of[i, p]``.
    """

    codes: jnp.ndarray       # int32[n]
    node_start: jnp.ndarray  # bool[n]
    paths_on: jnp.ndarray    # bool[n, P]
    alphas: jnp.ndarray      # int32[n]
    rep_of: jnp.ndarray      # int32[n, P] (-1 off-path)
    pred_of: jnp.ndarray     # int32[n, P] (-1 off-path)
    n: int
    paths_number: int
    # own-plane source per path: identity except on the reverse fill's
    # delta-leak rows, where a path reads the representative's plane
    # (clone semantics; see graph.pathgraph.pathwise_meta_rev)
    qsrc_of: jnp.ndarray | None = None  # int32[n, P]


jax.tree_util.register_dataclass(
    PathDeviceGraph,
    data_fields=[
        "codes", "node_start", "paths_on", "alphas", "rep_of", "pred_of",
        "qsrc_of",
    ],
    meta_fields=["n", "paths_number"],
)


def path_device_graph(g: PathGraph) -> PathDeviceGraph:
    return _place_device_graph(g, lambda: _build_path_device_graph(g))


def _build_path_device_graph(g: PathGraph) -> PathDeviceGraph:
    rep_of, pred_of = pathwise_meta(g)
    dg = PathDeviceGraph(
        codes=jnp.asarray(g.codes, dtype=jnp.int32),
        node_start=jnp.asarray(g.node_start),
        paths_on=jnp.asarray(g.paths_nodes),
        alphas=jnp.asarray(g.alphas, dtype=jnp.int32),
        rep_of=jnp.asarray(rep_of),
        pred_of=jnp.asarray(pred_of),
        n=g.n,
        paths_number=g.paths_number,
    )
    return dg


def encode_reads(sequences: list[str], pad_to: int | None = None):
    """Pad '$'-prefixed reads into (codes int32[B, Lp], lengths int32[B]).

    Padding uses the 'N' code; all kernels mask to the per-read length.
    Lp is rounded up to a multiple of 8, which sidesteps an XLA-CPU
    fusion codegen crash on small odd widths (fusion_compiler.cc
    RET_CHECK, seen at Lp=10).
    """
    from .. import scoring

    lengths = np.array([len(s) for s in sequences], dtype=np.int32)
    Lp = int(lengths.max()) if pad_to is None else pad_to
    Lp = (Lp + 7) // 8 * 8
    out = np.full((len(sequences), Lp), scoring.N, dtype=np.int32)
    for b, s in enumerate(sequences):
        out[b, : len(s)] = scoring.encode(s)

    from ..parallel import mesh as pmesh

    mesh = pmesh.get_active_mesh()
    if mesh is not None:
        # data-parallel: pad the batch to a mesh multiple (copies of
        # read 0; callers index results by len(sequences) so padded
        # lanes are discarded) and commit with a reads-axis sharding —
        # every downstream jit then runs SPMD via sharding propagation
        return tuple(pmesh.shard_read_arrays(mesh, out, lengths))
    return jnp.asarray(out), jnp.asarray(lengths)


def encode_read_aux(values, dtype=np.int32):
    """A per-read auxiliary array (bta, best-path ids, …), batch-aligned
    with :func:`encode_reads` — same row-0 padding and reads sharding
    when a data-parallel mesh is active."""
    from ..parallel import mesh as pmesh

    a = np.asarray(values, dtype=dtype)
    mesh = pmesh.get_active_mesh()
    if mesh is not None:
        return pmesh.shard_read_arrays(mesh, a)[0]
    return jnp.asarray(a)
