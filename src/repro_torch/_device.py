"""Device resolution shared by every entry point that creates tensors, and
the rule for ``meta`` tensors (the dry-run's, ``launch/dryrun.py``).

A meta tensor has a shape and a dtype but no data, so nothing can be read
from it on the host. The port's data-dependent host reads go through
``taken`` and ``host_int``, which give the reference's roofline counts on
meta (``repro/roofline/hlo_parse.py`` multiplies a while body by its cap
and counts every conditional branch as taken): a loop runs its cap, a
branch is taken, an every_k gate fires. Code that branches on the device
asks ``on_card``: meta takes the card's side, since the dry-run describes
the card's run. On a CPU or CUDA tensor each of them reads as before.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "is_meta", "on_card", "kernel_side", "taken",
           "host_int"]


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


def is_meta(x) -> bool:
    """True for a tensor on the ``meta`` device."""
    return isinstance(x, torch.Tensor) and x.device.type == "meta"


def on_card(x: torch.Tensor) -> bool:
    """True where ``x``'s work runs as on the card: a CUDA or a meta
    tensor."""
    return x.device.type in ("cuda", "meta")


def kernel_side(x: torch.Tensor, what: str) -> bool:
    """The side of kernel wrapper ``what`` that ``x`` takes: True for the
    kernel's (``on_card``: a CUDA tensor launches, a meta one records the
    launch), False for the plain version on a CPU tensor; raises for any
    other device."""
    if on_card(x):
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device "
                     f"{x.device}")


def taken(cond) -> bool:
    """``bool(cond)`` for a host read that steers a loop or a branch;
    True for a meta tensor (the loop runs to its cap, the branch is
    taken)."""
    return True if is_meta(cond) else bool(cond)


def host_int(x) -> Optional[int]:
    """``int(x)`` of a count read on the host (the optimizer's step);
    None for a meta tensor, where the caller keeps the count on the
    device, so that every every_k gate fires."""
    return None if is_meta(x) else int(x)
