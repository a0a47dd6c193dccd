"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (the default of every entry point and module) or ``"cpu"``;
    ``"meta"`` builds a module's shapes without storage.

    Asking for CUDA on a machine without it raises: the port never drops to
    the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
