"""The card's name and power limit, for labelling every measurement."""

from __future__ import annotations

import subprocess


def card() -> str:
    """First GPU's "name, power.limit" as nvidia-smi reports it, or "none".

    Runs nvidia-smi in a child process, so it stays off JAX. A card may be
    set below its maximum power and then runs slower under load, which is
    why numbers carry this label.
    """
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "none"
    return out.splitlines()[0] if out else "none"
