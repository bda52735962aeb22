"""PyTorch/CUDA port of mrn_tpu (incremental multilingual text recognition).

The JAX package ``mrn_tpu`` is the reference; this package imports nothing
from it.  Entry points run on the CUDA card unless the caller asks for the
CPU explicitly (``device="cpu"``); with no card and no explicit request they
raise instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card; raises when there is none.  An explicit
    device (``"cpu"``, ``"cuda:1"``) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mrn_tpu_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device
