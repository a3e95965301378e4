"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for (or
    implied) and absent: the port never falls back to the CPU on its
    own; the CPU path is taken only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def to_device(x, device: torch.device) -> torch.Tensor:
    """Host data (list, numpy array or CPU tensor) on `device`.  For CUDA
    the data goes through pinned memory, so the copy is queued on the
    current stream instead of waiting for the device to drain."""
    t = torch.as_tensor(x)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
