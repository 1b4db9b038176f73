"""Device resolution shared by every entry point that creates tensors."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it returns ``cuda`` when CUDA is available and
    raises otherwise — an entry point never carries on quietly on the CPU.
    Any explicit device (``"cpu"``, ``"cuda:0"``, a ``torch.device``) is
    returned as given.

    >>> resolve_device("cpu")
    device(type='cpu')
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return torch.device("cuda")
