"""The port's experiment drivers (counterparts of the repo's
``experiments/*.py``), each run with ``python -m``; see each module."""

from __future__ import annotations

import subprocess


def device_meta(device) -> dict:
    """What a result file records of where it ran: ``backend`` (``cuda`` or
    ``cpu``) and, on the card, its name and power limit as ``nvidia-smi``
    gives them (None where it cannot say)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"backend": dev.type, "card": None, "power_limit": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        power = line.rsplit(",", 1)[1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        power = None
    return {"backend": "cuda", "card": torch.cuda.get_device_name(dev), "power_limit": power}


def tail(values: list) -> list:
    """The last third of a validation curve (at least one point): a
    constant-lr full-coverage run oscillates, and the tail's mean and
    minimum separate encoders that one final read-out would conflate."""
    return values[-(max(len(values) // 3, 1)):]
