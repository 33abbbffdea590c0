"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
A CUDA device with no card present raises here: the port never drops to
the CPU on its own. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            f"pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
