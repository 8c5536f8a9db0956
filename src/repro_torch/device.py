"""Device resolution for the port's entry points.

Every entry point that does device work (``build_lut``,
``build_lut_grid``, ``LUTMethodSolver``, ``api.lut/scheduler/compiler``)
takes ``device="cuda"`` by default; callers (the CPU tests) ask for
``"cpu"`` explicitly. A CUDA request without a card raises - the port
never runs on the CPU in its place.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: Union[str, torch.device] = DEFAULT_DEVICE
            ) -> torch.device:
    """``device`` as a :class:`torch.device`, checked to be usable."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA card is "
            f"available; pass device='cpu' to run the plain versions")
    return dev
