"""NumPy/Python scalar oracle — the executable spec.

Literal per-cell ports of every reference DP recurrence (cited per
function).  Slow by design; used to (a) generate golden GAF outputs,
(b) validate the vectorised device engines cell-by-cell, and
(c) share traceback/GAF-emission code with the production host layer.
"""

from . import poa, gaf_emit, pathwise, pathwise_gap, recombination  # noqa: F401
