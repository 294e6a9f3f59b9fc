"""The shared XLA-scan-body helpers (poa_engine.cummax_last /
sub_planes / sub_row) must be drop-in equivalents of the ops they
replace."""

import jax
import jax.numpy as jnp
import numpy as np

from recgraph_tpu.ops.poa_engine import cummax_last, sub_planes, sub_row


def test_cummax_last_matches_native():
    rng = np.random.default_rng(0)
    for shape in [(7,), (3, 5), (4, 3, 17), (2, 3, 128)]:
        x = jnp.asarray(rng.integers(-(1 << 20), 1 << 20, shape), jnp.int32)
        got = np.asarray(cummax_last(x))
        want = np.asarray(jax.lax.cummax(x, axis=x.ndim - 1))
        assert (got == want).all(), shape


def test_sub_planes_row_matches_indexing():
    rng = np.random.default_rng(2)
    table = jnp.asarray(rng.integers(-8, 8, (7, 7)), jnp.int32)
    seq = jnp.asarray(rng.integers(0, 7, (5, 33)), jnp.int32)
    SUBP = sub_planes(table, seq)
    for c in range(7):
        got = np.asarray(sub_row(SUBP, jnp.int32(c)))
        want = np.asarray(table[c][seq])
        assert (got == want).all(), c
