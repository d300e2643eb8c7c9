"""Where the port's tensors live.

Every entry point takes the torch device as an explicit string (``"cuda"``
is the default, ``"cpu"`` is what the host-only tests ask for).  A request
for the GPU on a machine without one raises: the port never carries on
silently on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` → :class:`torch.device`.

    Raises ``RuntimeError`` when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false, ``ValueError`` for any other
    device type.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"torch device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"torch device {device!r} requested but torch.cuda.is_available() is "
            "False; pass torch_device='cpu' (or device='cpu') to run on the host")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
