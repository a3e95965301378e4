"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import numpy as np
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


def host_tensor(x, device: torch.device) -> torch.Tensor:
    """Host data (numpy array or CPU tensor) as a CPU tensor, pinned when
    `device` is CUDA so copies out of it are queued without waiting; a
    numpy array is shared, not copied, on the CPU."""
    t = torch.as_tensor(x)
    if t.device.type != "cpu":
        raise ValueError(f"host data must be on the CPU, got {t.device}")
    if device.type == "cuda" and not t.is_pinned():
        t = t.pin_memory()
    return t


def gather_to_device(host: torch.Tensor, idx, device: torch.device):
    """host[idx] (rows along dim 0) on `device`.  For CUDA the rows are
    gathered into a pinned buffer and copied on the current stream; the
    host's caching allocator keeps the buffer until the copy is done."""
    idx = torch.as_tensor(np.asarray(idx, np.int64))
    if device.type == "cpu":
        return host.index_select(0, idx)
    buf = torch.empty((len(idx), *host.shape[1:]), dtype=host.dtype,
                      pin_memory=True)
    torch.index_select(host, 0, idx, out=buf)
    return buf.to(device, non_blocking=True)
