"""recgraph_tpu — a batched accelerator engine for sequence-to-variation-
graph alignment.

A JAX/XLA re-design of the capabilities of RecGraph (AlgoLab/RecGraph):
exact POA, pathwise, and recombination alignment of reads against GFA
variation graphs, emitting GAF.

Layer map:

- ``io``       host parsing/serialisation: FASTA, GFA, GAF.
- ``scoring``  dense substitution matrices (replaces HashMap<(char,char),i32>).
- ``graph``    the graph *compiler*: GFA -> dense device arrays
               (linearisation, padded predecessor lists, path bitmasks).
- ``oracle``   NumPy scalar implementations of every DP mode, faithful to
               the reference recurrences cell-by-cell.  These are the
               golden spec the device kernels are tested against, and the
               host-side traceback replayer reuses their emitters.
- ``ops``      device engines: XLA row-scan DP over the graph
               linearisation (the within-row "left" dependency is solved
               with a (max,+) prefix scan instead of a scalar fixup loop),
               plus a CUDA kernel for the mode-1 fill on a GPU.
- ``align``    batching, bucketing, device dispatch, host traceback.
- ``parallel`` mesh / shard_map read-data-parallelism, multi-host gather.
"""

import os

__version__ = "0.1.0"

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set; otherwise a fixed
    ``.jax_cache/`` at the checkout root (the path is part of the
    cache key, so it must not move between runs).
    """
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> None:
    """Turn on the persistent XLA compilation cache on accelerators.

    A warm cache removes compilation from every run after the first.
    CPU runs are not cached: XLA:CPU entries are pinned to the host's
    CPU features.  With ``JAX_COMPILATION_CACHE_DIR`` set, jax already
    points its cache there and no other directory is set here.

    Called from the pipeline/API entry points, NOT at import: asking
    for the platform initialises the backend, which must not happen
    before jax.distributed.initialize in multi-process runs.
    """
    import jax

    from .ops.device import platform

    if platform() == "cpu":
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
