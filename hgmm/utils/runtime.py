"""Set-up shared by the GPU entry points (chip_smoke.py, bench.py, the CLI,
benchmarks/): the persistent compile cache and the device check. Nothing
here runs on library import."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets no other directory. Otherwise the cache goes to `.jax_cache/` at
    the root of the checkout, a fixed path (the path is part of the
    cache's key), which .gitignore lists."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)


def require_gpu(cpu_ok: bool = False):
    """Return JAX's first device; exit non-zero with a message when it is
    not a GPU, unless the caller's explicit --cpu option (cpu_ok) was
    given. A measurement never falls back to the CPU silently."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not cpu_ok:
        sys.exit(
            f"no GPU found: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this command measures the GPU "
            "(pass --cpu where the script offers it to run on the CPU)"
        )
    return dev


def device_record() -> dict:
    """The device as JAX reports it, for every printed result."""
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, read by a
    child process that does not import JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"
