"""Where the port runs: the card by default, the CPU only when it is named."""

from __future__ import annotations

import torch


def require_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises if a CUDA device is asked for (the default of every
    entry point) and there is none, instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"lkgd_torch: device {str(device)!r} was asked for (the default) but "
            f"torch.cuda.is_available() is False; to run on the CPU say so explicitly "
            f"(device='cpu', --device cpu)")
    return device
