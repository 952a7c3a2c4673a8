"""The accelerator a measurement runs on, and refusing to run without one."""

from __future__ import annotations

import subprocess

__all__ = ["card_line", "device_record", "require_gpu"]


def require_gpu():
    """The first GPU device; raises when JAX finds none (never a CPU run)."""
    import jax

    devs = jax.devices()
    if not devs or devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU visible to JAX (default backend devices: {devs}); "
            "run with JAX_PLATFORMS=cuda,cpu on a machine with a card")
    return devs[0]


def card_line() -> str:
    """``name, power.limit`` of every card as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"


def device_record() -> dict:
    """{"platform", "kind", "count"} of the default backend, as JAX sees it."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}
