"""Which accelerator a measurement ran on.

Every number a benchmark or a smoke run prints names its device: JAX's
view (platform, device kind, count) and the card's name and power limit
as ``nvidia-smi`` reports them.  A card set below its maximum power
limit runs slower under load, so the limit travels with every number.
``nvidia-smi`` runs as a child process that never imports JAX.
"""

from __future__ import annotations

import subprocess
from typing import List, Tuple

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def parse_name_power(text: str) -> List[Tuple[str, str]]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output -> one ``(name, power_limit)`` pair per card, e.g.
    ``("NVIDIA H100 80GB HBM3", "700.00 W")``.  The name may itself
    contain commas, so the power limit is the field after the last one."""
    cards = []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        name, sep, limit = line.rpartition(",")
        if not sep:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def query_name_power(timeout: float = 30.0) -> str:
    """The raw ``nvidia-smi`` name/power-limit lines (stripped); raises
    ``RuntimeError`` when the tool is missing or fails."""
    try:
        proc = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                              text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"nvidia-smi unavailable: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed (rc={proc.returncode}): "
                           f"{proc.stderr.strip()}")
    return proc.stdout.strip()


def jax_device_info() -> dict:
    """``{"platform", "kind", "count"}`` of the default JAX backend
    (initializes it)."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """:func:`jax_device_info`, or ``RuntimeError`` when the default
    backend is not a GPU: device measurements never fall back to the
    CPU."""
    info = jax_device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {info['platform']!r} "
            f"({info['kind']}); this measurement runs only on the card")
    return info
