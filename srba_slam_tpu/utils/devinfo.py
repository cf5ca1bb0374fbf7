"""What a measurement ran on: JAX's device and the card's power limit."""

from __future__ import annotations

import subprocess


def nvidia_smi_line() -> str:
    """``name, power.limit`` of the card(s) as nvidia-smi reports them, or
    ``"not available"`` where there is no nvidia-smi."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    out = r.stdout.strip()
    return out if r.returncode == 0 and out else "not available"


def device_info() -> dict:
    """Platform, device kind and count of JAX's default backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
