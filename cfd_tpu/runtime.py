"""Run-time setup shared by the entry points (CLI, bench.py, chip_smoke.py):
the persistent compile cache, and the device a run reports."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

# In-checkout compile cache, used when JAX_COMPILATION_CACHE_DIR is unset
# (.gitignore lists it). A fixed path: the cache key includes it.
REPO_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here; otherwise the cache goes to ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)


def card() -> str | None:
    """The first GPU's name and power limit as ``nvidia-smi`` reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``), or None without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_info() -> dict:
    """JAX's first device, the device count, and the card (see ``card``)."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": card() if dev.platform == "gpu" else None}
