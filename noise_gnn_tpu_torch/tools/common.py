"""What the port's measuring tools share: the device rule, and the card's
name and power limit that each tool's JSON line carries.

Each tool runs on CUDA card 0 unless it is given ``--cpu``; without a card
and without ``--cpu`` it raises (:func:`tool_device`). Its result is one
JSON line on stdout carrying ``card`` and ``power_limit`` as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them (``"cpu"`` and ``null`` on the CPU); its diagnostics go to stderr.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout: configs/, docs/, the package


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def tool_device(cpu: bool) -> torch.device:
    """The CPU when asked for, else card 0; raises where no card is visible."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible: run on a card, or pass --cpu")
    return torch.device("cuda", 0)


def card_info(device: torch.device) -> dict:
    """``{"card": name, "power_limit": limit}`` of the card ``device`` is on,
    as nvidia-smi prints them; ``{"card": "cpu", "power_limit": None}`` on
    the CPU."""
    if device.type != "cuda":
        return {"card": "cpu", "power_limit": None}
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = res.stdout.strip().splitlines()[device.index or 0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"card": name, "power_limit": limit}
