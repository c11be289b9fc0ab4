"""Which device a measurement ran on.

Every number a benchmark or smoke run prints names its device: JAX's
platform, device kind and count, and the card's name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power runs slower
under load).  A run that finds no GPU stops here instead of measuring
something else.
"""

from __future__ import annotations

import subprocess


def nvidia_smi_cards() -> list[str]:
    """``name, power.limit`` of every visible card, one string each, read by
    an ``nvidia-smi`` child process (which stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def require_gpu() -> dict:
    """JAX's device identity; raises RuntimeError unless its first device is
    a GPU."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {devices[0]} (platform {platform})"
        )
    return {"platform": platform, "kind": devices[0].device_kind,
            "count": len(devices), "cards": nvidia_smi_cards()}
