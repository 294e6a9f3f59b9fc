"""Device mesh + shard_map wrappers for the alignment kernels.

Data-parallel design (SURVEY.md §2.3; replaces the reference's
sequential per-read loop, src/main.rs:56): reads are the data-parallel
axis.  An *active mesh* set here is picked up by ``ops.encode`` — read
tensors are committed with a ``reads``-axis NamedSharding and the graph
arrays/score table are replicated, so every jitted engine (modes 0-5,
8/9 fills *and* the on-device walks) runs SPMD via XLA sharding
propagation with no per-engine changes.  The CUDA mode-1 fill, a custom
call that GSPMD cannot partition, is wrapped in ``shard_map`` at its
dispatch site (ops.cuda_fill.fill_local).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

READS_AXIS = "reads"

_ACTIVE: Mesh | None = None


def make_mesh(n_devices: int | None = None, axis: str = READS_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def set_active_mesh(mesh: Mesh | None) -> Mesh | None:
    """Install ``mesh`` as the process-wide data-parallel mesh.

    Returns the previous active mesh (restore it in tests).
    """
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    return prev


def get_active_mesh() -> Mesh | None:
    return _ACTIVE


def auto_mesh(min_devices: int = 2) -> Mesh | None:
    """A reads-mesh over this host's local devices, or None when
    single-device.  Local (not global) devices: multi-host runs shard
    reads per host (parallel.distributed) and per card here — hosts
    never exchange device data, so each host meshes only its own
    cards.  ``RECGRAPH_DP_DEVICES`` caps the device count
    (e.g. to co-locate several jobs on one host)."""
    import os

    devs = jax.local_devices()
    cap = os.environ.get("RECGRAPH_DP_DEVICES")
    if cap:
        devs = devs[: int(cap)]
    if len(devs) < min_devices:
        return None
    return Mesh(np.asarray(devs), (READS_AXIS,))


def reads_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(READS_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_reads_multiple(mesh: Mesh, lane: int = 1) -> int:
    """Batch-size multiple required to shard evenly (times ``lane``)."""
    return mesh.size * lane


def shard_read_arrays(mesh: Mesh, *host_arrays, lane: int = 1):
    """Pad leading axis to a mesh multiple and commit with a reads spec.

    ``host_arrays`` are NumPy arrays (batch-leading); padding repeats
    row 0 so padded lanes recompute a real read (results are sliced
    back by callers).  Returns the committed jax arrays.
    """
    mult = pad_reads_multiple(mesh, lane)
    out = []
    sh = reads_sharding(mesh)
    for a in host_arrays:
        b = a.shape[0]
        bp = -(-b // mult) * mult
        if bp != b:
            a = np.concatenate([a, np.repeat(a[:1], bp - b, axis=0)], axis=0)
        out.append(jax.device_put(a, sh))
    return out


def replicate(mesh: Mesh, tree):
    """Replicate every array leaf of ``tree`` across the mesh."""
    sh = replicated_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def pad_batch_to(arrays, batch: int):
    """Pad leading (read-batch) axis of every array to ``batch`` rows.

    Padding replicates the last read; callers slice results back to the
    true batch.  Needed so the batch divides the mesh axis.
    """
    out = []
    for a in arrays:
        b = a.shape[0]
        if b < batch:
            pad = jnp.repeat(a[-1:], batch - b, axis=0)
            a = jnp.concatenate([a, pad], axis=0)
        out.append(a)
    return out


def sharded_poa_fill(mesh: Mesh, mode: int = 0):
    """Return a jitted, reads-sharded POA fill for ``mode`` (0 or 1).

    Read tensors (seq, L, bta) are sharded over the ``reads`` mesh
    axis; the graph pytree and score table are replicated per chip.
    """
    from ..ops import poa_engine

    axis = mesh.axis_names[0]
    if mode == 0:
        fill = poa_engine._fill_global.__wrapped__
        in_specs = (P(), P(), P(axis), P(axis), P(axis))
    elif mode == 1:
        fill = poa_engine._fill_local.__wrapped__
        in_specs = (P(), P(), P(axis), P(axis))
    else:
        raise ValueError(mode)
    sharded = jax.shard_map(
        fill, mesh=mesh, in_specs=in_specs, out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(sharded)
