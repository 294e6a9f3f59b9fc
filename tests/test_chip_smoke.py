"""The parts of chip_smoke.py and bench.py that run without a card: the
no-GPU refusal, the result line, nvidia-smi parsing and the fallback
gate.  The phases themselves run on the card."""

import io
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from recgraph_tpu import metrics  # noqa: E402
from recgraph_tpu.ops import device  # noqa: E402


def _run(script, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _no_result(stdout):
    for ln in stdout.splitlines():
        assert not ln.startswith("{"), ln
        assert "reads/s" not in ln and "Gcells/s" not in ln, ln


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    res = _run(os.path.join(ROOT, script), ROOT)
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    _no_result(res.stdout)


def test_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert res.returncode != 0
    _no_result(res.stdout)


def test_result_line_format():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert "\n" not in line


@pytest.mark.parametrize(
    "text,want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         [("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
         [("NVIDIA H100 80GB HBM3", "500.00 W"),
          ("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("NVIDIA H100, PCIe, [N/A]", [("NVIDIA H100, PCIe", "[N/A]")]),
    ],
)
def test_parse_smi(text, want):
    assert device.parse_smi(text) == want


@pytest.mark.parametrize("text", ["", "no comma here", ", 700 W"])
def test_parse_smi_rejects(text):
    with pytest.raises(ValueError):
        device.parse_smi(text)


@pytest.mark.parametrize(
    "before,after,moved",
    [
        ({}, {}, {}),
        ({"native_to_python": 1}, {"native_to_python": 1}, {}),
        ({"oracle_gap_67": 1}, {"oracle_gap_67": 3}, {"oracle_gap_67": 2}),
        ({}, {"pathwise_win_fullwidth": 1}, {"pathwise_win_fullwidth": 1}),
    ],
)
def test_fallbacks_moved(before, after, moved):
    assert chip_smoke.fallbacks_moved(before, after) == moved


def test_run_pipeline_fails_on_a_fallback(example_paths, monkeypatch):
    """A run that took a fallback fails its phase even though its
    output may be right."""
    from recgraph_tpu.ops import poa_engine

    real = poa_engine.run_batch_walks

    def degraded(*a, **k):
        metrics.count_fallback("native_to_python")
        return real(*a, **k)

    monkeypatch.setattr(poa_engine, "run_batch_walks", degraded)
    with pytest.raises(chip_smoke.SmokeFailure, match="native_to_python"):
        chip_smoke.run_pipeline(*example_paths, alignment_mode=1)


class _Done:
    def __init__(self, text):
        self.text = text

    def get(self, timeout=None):
        return self.text


@pytest.mark.parametrize("differ", [False, True])
def test_oracle_sample_compare(differ):
    samples = object.__new__(chip_smoke.OracleSamples)
    samples.jobs = {"k": ([1, 3], [_Done("b\n"), _Done("x\n" if differ
                                                        else "d\n")])}
    gaf = "a\nb\nc\nd\n"
    if differ:
        with pytest.raises(chip_smoke.SmokeFailure, match="differ"):
            samples.compare("k", gaf)
    else:
        samples.compare("k", gaf)


def test_write_fasta_strips_sentinel(tmp_path):
    p = tmp_path / "r.fa"
    chip_smoke.write_fasta(str(p), ["$ACGT", "GG"], ["a", "b"])
    assert p.read_text() == ">a\nACGT\n>b\nGG\n"
