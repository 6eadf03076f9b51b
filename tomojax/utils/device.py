"""The accelerator a measurement runs on, named beside every number.

Measurement entry points (``chip_smoke.py``, ``bench.py``, the scripts that
time kernels) call :func:`require_gpu` first: a run that finds no GPU fails
instead of timing XLA's CPU backend under a device metric's name.
"""

from __future__ import annotations

import subprocess

import jax


def device_record() -> dict:
    """Platform, kind and count of the default devices, as JAX reports
    them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """:func:`device_record`, or ``SystemExit`` naming the missing GPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's default devices are "
                         f"{rec['count']} x {rec['platform']} "
                         f"({rec['kind']}); this run measures the GPU")
    return rec


def gpu_name_power() -> str:
    """``name, power.limit`` of each card as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip()
