"""Multi-host read sharding through the production CLI.

Two worker processes each run the real CLI entry point with
``--num-processes/--process-id/--coordinator`` (pipeline._setup_parallel
initialises jax.distributed, takes the host's read slice, writes
``<out>.part<k>``; process 0 merges after the barrier).  The merged
output must equal a single-process run byte-for-byte.
"""

import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The production CLI, with the platform pinned to CPU first.
WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from recgraph_tpu.cli import main
main(sys.argv[1:])
"""


def _spawn_workers(tmp_path, out, mode_args, extra_env=None):
    port = socket.socket()
    port.bind(("localhost", 0))
    addr = f"localhost:{port.getsockname()[1]}"
    port.close()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(extra_env or {})
    procs = [
        subprocess.Popen(
            [
                sys.executable, str(script), *mode_args,
                "example/reads.fa", "example/graph.gfa",
                "-o", out,
                "--num-processes", "2",
                "--process-id", str(k),
                "--coordinator", addr,
            ],
            cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for k in range(2)
    ]
    errs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, se.decode()[-2000:]
        errs.append(se.decode())
    return errs


def test_two_process_cli_run(tmp_path, example_paths):
    out = str(tmp_path / "out.gaf")
    _spawn_workers(tmp_path, out, ["-m", "1"])

    # reference: single-process run over the whole corpus
    import contextlib
    import io

    from recgraph_tpu.align.pipeline import Options, run

    reads_fa, graph_gfa = example_paths
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(Options(sequence_path=reads_fa, graph_path=graph_gfa,
                    alignment_mode=1))
    assert open(out).read() == buf.getvalue()
    # per-host part files exist (written before the merge)
    assert os.path.exists(out + ".part0") and os.path.exists(out + ".part1")


def test_two_process_overhead_projection(tmp_path):
    """Multi-host efficiency projection (PERF.md "Multi-host scaling"):
    the hot loop has NO cross-host communication — the only shared
    steps are the jax.distributed init barrier (setup) and the end
    barrier + part merge (gather).  This pins the measured overheads:
    the pure merge cost (the later-arriving host's gather, which does
    not wait) must be a trivial fraction of the per-host align time,
    which is the term that scales 1/N."""
    import re

    out = str(tmp_path / "out.gaf")
    errs = _spawn_workers(
        tmp_path, out, ["-m", "1"], extra_env={"RECGRAPH_METRICS": "1"}
    )
    stats = []
    for se in errs:
        m = re.search(
            r"recgraph-timing: pid=(\d)/2 setup=([\d.]+) "
            r"align=([\d.]+) gather=([\d.]+)", se)
        assert m, se[-1500:]
        stats.append(tuple(float(x) for x in m.groups()))
    align = min(s[2] for s in stats)
    # the later host's gather is barrier-wait-free: pure merge cost.
    # Assert only an absolute ceiling (the merge is a ~KB file concat;
    # 2s allows a loaded CI host) and PRINT the ratio the projection
    # uses — a wall-clock ratio across subprocesses flakes (r4 ADVICE).
    gather_pure = min(s[3] for s in stats)
    assert gather_pure < 2.0, (stats, "pure merge cost should be bounded")
    print(f"# gather_pure/align ratio: {gather_pure / align:.3f}")
    # efficiency projection: eff(N) = W / (W + N*(F_b + m) - F_b) with
    # W = align (scales 1/N), m = pure gather; the barrier-wait part of
    # setup/gather is skew, which exists at N=1 too (it is not overhead
    # charged to scaling).  With the measured numbers this stays >= 0.8
    # for any N while W/N >= 4 * (F_b + m) — document, don't flake.
    print(f"# timing stats (setup, align, gather) per host: {stats}")
