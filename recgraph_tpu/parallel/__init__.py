"""Multi-device / multi-host scale-out.

The reference is single-threaded (SURVEY.md §2.3); the parallelism
model here is read-data-parallelism: batches of padded reads are
sharded over a 1-D device mesh axis ``reads``, the compiled graph
arrays are replicated per device, and per-read outputs
(scores, traceback planes) come back sharded for host-side GAF
emission.  No gradient-style collectives are needed — reads are
embarrassingly parallel; collectives only gather result metadata.
"""

from .mesh import make_mesh, sharded_poa_fill, pad_batch_to

__all__ = ["make_mesh", "sharded_poa_fill", "pad_batch_to"]
