"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W power limit), and the card's own line beside them.

A roofline share is stated against these peaks; the card may run at a
lower power limit, which ``card_line`` prints beside every number.
"""

from __future__ import annotations

import subprocess

PEAK_FP32_FLOPS = 67e12      # FP32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12     # HBM3 bytes a second


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card could take for ``ops`` FP32 operations
    on ``nbytes`` read once or written once."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def smi(*fields: str) -> str:
    """``nvidia-smi``'s reading of ``fields`` for the cards, as it prints
    them (``""`` where it cannot be run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()


def card_line() -> str:
    """The card's name and power limit, as the peaks' caveat needs."""
    return smi("name", "power.limit")


def clocks_line() -> str:
    """SM clock, power draw, power limit and temperature now."""
    return smi("clocks.sm", "power.draw", "power.limit", "temperature.gpu")
