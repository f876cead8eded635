"""The GPU a measurement runs on: a guard and the card's identity."""

from __future__ import annotations

import subprocess


def require_gpu(n_cards: int = 1) -> list:
    """The first ``n_cards`` GPU devices. Exits non-zero on any other
    backend, so no measurement is ever taken on the CPU by mistake."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n_cards:
        raise SystemExit(
            f"needs {n_cards} GPU device(s); JAX found {len(devs)} x "
            f"{devs[0].platform} ({devs[0].device_kind})"
        )
    return devs[:n_cards]


def card_name_and_power() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it.
    A card set below its maximum power runs slower under load, so every
    timing is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
