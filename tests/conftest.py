"""Test configuration: force an 8-device virtual CPU mesh.

Multi-device sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count).  Tests marked ``gpu`` need an
NVIDIA card: the ``gpu`` fixture skips them elsewhere, and
``chip_smoke.py`` runs them on the card in its own process, with
RECGRAPH_TESTS_ON_DEVICE=1 so that this file leaves the platform alone.
"""

import os
import sys

if not os.environ.get("RECGRAPH_TESTS_ON_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from recgraph_tpu.graph.poagraph import PoaGraph  # noqa: E402
from recgraph_tpu import scoring  # noqa: E402

EXAMPLE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "example")


def make_poa_graph(lnz: str, preds: dict[int, list[int]]) -> PoaGraph:
    """Build a PoaGraph literal the way the reference tests build LnzGraph
    (e.g. global_abpoa.rs:577-598): every key of ``preds`` is a node start."""
    n = len(lnz)
    node_start = np.zeros(n, dtype=bool)
    for k in preds:
        node_start[k] = True
    # handle ids: consecutive node index per start, as in
    # utils::create_handle_pos_in_lnz (utils.rs:144-165)
    handle_pos = ["-1"] * n
    cur = 0
    for i in range(1, n - 1):
        if node_start[i]:
            cur += 1
        handle_pos[i] = str(cur)
    return PoaGraph(
        lnz=lnz,
        codes=scoring.encode(lnz),
        node_start=node_start,
        preds={k: sorted(v) for k, v in preds.items()},
        handle_pos=handle_pos,
    )


def simple_score_matrix(match: int = 1, mismatch: int = -1) -> scoring.ScoreMatrix:
    """Uniform match/mismatch table (reference tests hand-build these)."""
    t = np.full((7, 7), mismatch, dtype=np.int32)
    for i in range(6):
        t[i, i] = match
    t[6, :] = 0
    t[:, 6] = 0
    return scoring.ScoreMatrix(t)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is an NVIDIA GPU (decided when the
    test runs, never at import or collection)."""
    from recgraph_tpu.ops.device import platform

    if platform() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs it on the card")


@pytest.fixture(scope="session")
def example_paths():
    return (
        os.path.join(EXAMPLE_DIR, "reads.fa"),
        os.path.join(EXAMPLE_DIR, "graph.gfa"),
    )
