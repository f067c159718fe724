"""Device resolution for the port's entry points: CUDA by default, the CPU
only when the caller asks for it, and never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises when a CUDA device is asked for and
    none is present, naming ``device="cpu"`` as the way to run without one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU (its plain PyTorch versions of every kernel)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
