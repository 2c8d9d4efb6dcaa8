"""Where the port's entry points run: on the card unless asked for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda", *, caller: str) -> torch.device:
    """``torch.device(device)``; a CUDA device when CUDA is not available
    raises, naming ``device="cpu"`` (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}: device {str(dev)!r} but no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device=\"cpu\" to "
            "run on the CPU")
    return dev
