"""Device compute engines (JAX/XLA, and a CUDA kernel for the mode-1 fill).

Layering:

- ``encode``              host->device graph encodings (dense arrays)
- ``poa_engine``          modes 0-3 (POA global/local, linear/affine gap)
- ``pathwise_engine``     modes 4/5 (pathwise global/semiglobal)
- ``recombination_engine`` modes 8/9 (pathwise + one recombination)

Each engine computes score planes and packed traceback planes on
device; the host replays the traceback and emits GAF through the same
emitters the oracle uses, so device results are GAF-identical to the
oracle (and hence to the reference) by construction of the tests.
"""
