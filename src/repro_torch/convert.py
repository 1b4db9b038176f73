"""Carry the JAX package's state across to the port.

The JAX package draws its initial weights from threefry keys, which torch
cannot reproduce, so a run that must start where a JAX run starts carries
the JAX arrays over as numpy:

    params_np = jax.tree_util.tree_map(np.asarray, params)
    params = params_from_numpy(params_np, device="cuda")

Nested dicts keep their keys, so a parameter path (``enc1/w``) names the
same tensor in both packages, and layouts are unchanged (no transposes).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ._device import resolve_device
from ._tree import tree_map
from .optim.adam import AdamState

__all__ = ["params_from_numpy", "opt_state_from_numpy"]


def params_from_numpy(tree: Any, device: Optional[str] = None) -> Any:
    """Nested dict of numpy arrays -> the same dict of tensors (copies) on
    ``device`` (the card when None; raises if CUDA is missing).

    >>> params = params_from_numpy({"enc1": {"w": np.ones((3, 2))}}, "cpu")
    """
    dev = resolve_device(device)
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=dev), tree)


def opt_state_from_numpy(state: Any,
                         device: Optional[str] = None) -> AdamState:
    """A JAX ``AdamState`` (count, mu, nu) given as numpy -> the port's
    ``AdamState`` on ``device``.

    >>> opt = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, st))
    """
    dev = resolve_device(device)
    count, mu, nu = state
    return AdamState(
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                           device=dev),
        mu=params_from_numpy(mu, dev), nu=params_from_numpy(nu, dev))
