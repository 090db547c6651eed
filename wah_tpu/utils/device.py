"""What a measurement runs on: the JAX device, and the card's name and
power limit as nvidia-smi reports them."""
from __future__ import annotations

import subprocess

import jax

__all__ = ["device_info", "require_gpu", "card_line"]


def device_info() -> dict:
    """{"platform", "kind", "count"} of JAX's devices."""
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def require_gpu() -> dict:
    """device_info(), or SystemExit when JAX finds no GPU: a measurement
    does not fall back to the CPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {info['platform']!r}; this "
            "measurement runs only on a GPU"
        )
    return info


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output (one line per
    card), or a note saying it could not be read."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
