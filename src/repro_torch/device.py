"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` or the default ``"cuda"``; raises where CUDA is absent.

    There is no quiet CPU fallback: a CPU run is asked for explicitly
    (``device="cpu"``), as the tests do."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False — the port serves on an NVIDIA GPU; pass device='cpu' to "
            "run the plain PyTorch versions instead")
    return dev
