"""What the program runs on: the compile cache, the card, the peaks table.

- :func:`enable_compile_cache` places JAX's persistent compilation cache:
  ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself; nothing else
  is set), otherwise one fixed directory inside the checkout, so that a
  second process on the same tree finds what the first compiled.
- :func:`card_info` reads the card's name and power limit from
  ``nvidia-smi`` (the clock and therefore every time depends on the limit).
- :data:`PEAKS` holds published device-memory bandwidths keyed by JAX's
  ``device_kind``; a device missing from it gets no speed-of-light figure.
"""

from __future__ import annotations

import os
import shutil
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")

# Published device-memory bandwidth (bytes/s), by jax device_kind.
# Source: NVIDIA H100 data sheet (SXM5 80 GB: 3.35 TB/s; PCIe 80 GB:
# 2.0 TB/s). Rates assume the card's full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
    "NVIDIA H100 PCIe": {"hbm_bytes_per_s": 2.0e12},
}


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns the directory used."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def card_info() -> str | None:
    """``"<name>, <power limit>"`` of each visible NVIDIA card (one line
    per card, as ``nvidia-smi`` prints it), or None without nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def device_summary() -> dict:
    """platform, device_kind and count of the JAX devices in use."""
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()),
    }


def hbm_peak(device_kind: str) -> float | None:
    """Published memory bandwidth of ``device_kind``; None if unknown."""
    entry = PEAKS.get(device_kind)
    return None if entry is None else entry["hbm_bytes_per_s"]
