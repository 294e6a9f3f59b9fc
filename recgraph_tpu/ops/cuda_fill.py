"""The mode-1 fill as a CUDA kernel (native/cuda/fill_local.cu).

On a GPU, :func:`poa_engine.fill_local_best` calls :func:`fill_local`
in place of the XLA scan engine ``poa_engine._fill_local``, which stays
as its reference: same outputs (score, best row, best column, packed
``(pred << 4) | dir`` plane [B, n, Lp]), same tie rules, exact integer
equality.

The library is compiled from the repository's source with ``nvcc`` on
first use, into ``native/build/`` (listed in .gitignore).  On a GPU a
failed build raises: the XLA engine is no silent substitute.  CUDA code
has no interpret mode, so the CPU tests cover what surrounds the call:
the launch plan, the choice of implementation, the shard_map wrapping
and the build's failure path.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .device import platform

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
SOURCE = os.path.join(_REPO, "native", "cuda", "fill_local.cu")
BUILD_DIR = os.path.join(_REPO, "native", "build")
LIBRARY = os.path.join(BUILD_DIR, "libfill_local.so")
TARGET = "recgraph_fill_local"

MAX_THREADS = 512            # threads per block (one block per read)
COLS = (1, 2, 4, 8, 16)      # columns per thread the kernel is built for
MAX_LP = MAX_THREADS * COLS[-1]
SMEM_BUDGET = 200 * 1024     # bytes of shared memory a block may take

_lock = threading.Lock()
_registered = [False]


@dataclass(frozen=True)
class Plan:
    """Launch plan of one call: threads own ``cols`` consecutive
    columns; shared-memory rows are ``lpad`` wide; the ring holds
    ``ring`` predecessor rows, and ``use_global`` keeps every node-end
    row in device memory too, for graphs whose span exceeds it."""

    cols: int
    threads: int
    lpad: int
    ring: int
    use_global: bool

    def smem_bytes(self) -> int:
        return 4 * (7 * 7 + 1 + 64 + (2 + self.ring) * self.lpad)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(Lp: int, compact_span: int) -> Plan:
    """Launch plan for reads padded to ``Lp`` on a graph whose
    predecessor rows are at most ``compact_span`` node ends back."""
    if Lp > MAX_LP:
        raise ValueError(f"Lp={Lp} exceeds the kernel's {MAX_LP} columns")
    cols = next(c for c in COLS if _ceil(Lp, c) <= MAX_THREADS)
    threads = _ceil(_ceil(Lp, cols), 32) * 32
    lpad = cols * threads
    ring = compact_span + 1
    fixed = Plan(cols, threads, lpad, 0, False).smem_bytes()
    fit = (SMEM_BUDGET - fixed) // (4 * lpad)
    use_global = ring > fit
    if use_global:
        ring = max(1, fit)
    return Plan(cols, threads, lpad, ring, use_global)


def use_kernel(Lp: int) -> bool:
    """The CUDA kernel runs the mode-1 fill on a GPU, up to MAX_LP
    columns; everything else takes the XLA scan engine."""
    return platform() == "gpu" and Lp <= MAX_LP


def build(nvcc: str | None = None) -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns its path.  Raises RuntimeError on failure."""
    if os.path.exists(LIBRARY) and (
        os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)
    ):
        return LIBRARY
    nvcc = nvcc or os.environ.get("NVCC") or _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", tmp, SOURCE,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except OSError as exc:
        raise RuntimeError(f"cannot run nvcc ({nvcc}): {exc}") from exc
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}"
        )
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _find_nvcc() -> str:
    cand = "/usr/local/cuda/bin/nvcc"
    return cand if os.path.exists(cand) else "nvcc"


def _register() -> None:
    with _lock:
        if _registered[0]:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.RecgraphFillLocal), platform="CUDA"
        )
        _registered[0] = True


def kernel_call(dg, table, seq, L, pl: Plan):
    """One ffi_call of the kernel on the reads of one device."""
    B, Lp = seq.shape
    i32 = jnp.int32
    out = (
        jax.ShapeDtypeStruct((B,), i32),
        jax.ShapeDtypeStruct((B,), i32),
        jax.ShapeDtypeStruct((B,), i32),
        jax.ShapeDtypeStruct((B, dg.n, Lp), i32),
        jax.ShapeDtypeStruct((B, dg.n_ends if pl.use_global else 1, Lp), i32),
    )
    bv, bi, bj, packed, _ = jax.ffi.ffi_call(TARGET, out)(
        seq, L, table, dg.codes, dg.node_start.astype(i32), dg.pred_idx,
        dg.pred_rank, dg.erank,
        cols=pl.cols, threads=pl.threads, ring=pl.ring,
        use_global=int(pl.use_global),
    )
    return bv, bi, bj, packed


@functools.partial(jax.jit, static_argnames=("pl", "mesh", "callee"))
def _fill(dg, table, seq, L, pl, mesh, callee):
    fill = functools.partial(callee, pl=pl)
    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        ax = mesh.axis_names[0]
        fill = jax.shard_map(
            fill, mesh=mesh, in_specs=(P(), P(), P(ax), P(ax)),
            out_specs=(P(ax),) * 4, check_vma=False,
        )
    return fill(dg, table, seq, L)


def fill_local(dg, table, seq, L, callee=None):
    """Mode-1 fill on the GPU: (score[B], best_i[B], best_j[B],
    packed[B, n, Lp]).

    Under an active reads mesh the call runs per device inside
    shard_map (GSPMD cannot partition a custom call); the graph and the
    table are replicated.  ``callee(dg, table, seq, L, pl=plan)``
    replaces the kernel call (tests on the CPU).
    """
    from ..parallel import mesh as pmesh

    if callee is None:
        _register()
        callee = kernel_call
    pl = plan(seq.shape[1], dg.compact_span)
    mesh = pmesh.get_active_mesh()
    if mesh is not None and mesh.size <= 1:
        mesh = None
    return _fill(dg, table.astype(jnp.int32), seq.astype(jnp.int32),
                 L.astype(jnp.int32), pl=pl, mesh=mesh, callee=callee)
