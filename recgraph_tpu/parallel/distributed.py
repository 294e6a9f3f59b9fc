"""Multi-host scale-out: process groups + read sharding over hosts.

The reference is a single process (SURVEY.md §2.3 — no MPI/NCCL
anywhere); this design shards *reads* across hosts and across the
cards of each host:

- ONE process per host: it calls :func:`initialize` (jax.distributed)
  and takes all of its host's local devices.  Two such processes on
  one host would each reserve memory on every card (a JAX process
  reserves most of a card's memory when it first uses it), so the
  second would run out; split a host's cards between processes only
  with ``CUDA_VISIBLE_DEVICES`` and ``XLA_PYTHON_CLIENT_MEM_FRACTION``;
- each host parses the same graph (replicated, it is small relative to
  device memory);
- the read corpus is split contiguously per host by
  :func:`host_read_slice`; per-host batches run through the reads-mesh
  `shard_map` kernels (parallel.mesh) on the host's local chips;
- GAF lines are written per-host to ``<out>.part<k>`` and concatenated
  (reads are embarrassingly parallel, so no collectives are needed
  beyond the jax.distributed barrier at init/teardown).

There is deliberately no gradient-style synchronisation: per BASELINE's
north star the only cross-host data motion is the result gather.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Initialise the multi-host process group; no-op when single-host.

    Returns (process_id, num_processes).
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def host_read_slice(n_reads: int, process_id: int | None = None,
                    num_processes: int | None = None) -> slice:
    """Contiguous read range owned by this host (balanced split)."""
    pid = jax.process_index() if process_id is None else process_id
    np_ = jax.process_count() if num_processes is None else num_processes
    base, extra = divmod(n_reads, np_)
    start = pid * base + min(pid, extra)
    stop = start + base + (1 if pid < extra else 0)
    return slice(start, stop)


def merge_host_outputs(out_file: str, num_processes: int) -> None:
    """Concatenate per-host ``<out>.part<k>`` files into ``out_file``."""
    with open(out_file, "w") as dst:
        for k in range(num_processes):
            with open(f"{out_file}.part{k}") as src:
                dst.write(src.read())
