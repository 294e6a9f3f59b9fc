"""The device the engines run on, read in one place.

Every choice that depends on the accelerator (which implementation a
fill uses, whether a CPU-only workaround applies) asks
:func:`platform`: the platform JAX reports for its first device,
``"gpu"`` on a CUDA card and ``"cpu"`` on the host.
"""

from __future__ import annotations

import subprocess

import jax


def platform() -> str:
    return jax.devices()[0].platform


def parse_smi(text: str) -> list[tuple[str, str]]:
    """Lines of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` -> [(name, power limit)]."""
    out = []
    for ln in text.strip().splitlines():
        name, sep, limit = ln.rpartition(",")
        if not sep or not name.strip():
            raise ValueError(f"unexpected nvidia-smi line: {ln!r}")
        out.append((name.strip(), limit.strip()))
    if not out:
        raise ValueError("nvidia-smi printed no card")
    return out


def card() -> str:
    """The cards' names and power limits as nvidia-smi prints them (a
    card may be set below its maximum power and then runs slower, so
    every measurement carries this)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    parse_smi(res.stdout)
    return res.stdout.strip()
