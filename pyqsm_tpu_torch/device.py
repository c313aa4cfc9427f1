"""Device selection for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE, mesh=None) -> torch.device:
    """The device an entry point runs on. ``cuda`` is the default; asking
    for it without a card raises — there is no silent CPU fallback. With a
    ``parallel.mesh.Mesh`` it is this rank's mesh device, which ``device``
    must name (or its type, as the default ``cuda`` does); another device
    raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if mesh is None:
        return dev
    if dev.type != mesh.device.type or (dev.index is not None and dev != mesh.device):
        raise ValueError(f"device {dev} is not this rank's mesh device {mesh.device}")
    return mesh.device


def input_device(x, device=None) -> torch.device:
    """The device asked for, else that of a tensor input, else the card
    (``resolve_device``'s default)."""
    if device is None:
        return x.device if isinstance(x, torch.Tensor) else resolve_device()
    return resolve_device(device)


def as_tensor(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array on the
    host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
