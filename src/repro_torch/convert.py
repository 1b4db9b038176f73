"""Carry the JAX package's state across to the port.

The JAX package draws its initial weights from threefry keys, which torch
cannot reproduce, so a run that must start where a JAX run starts carries
the JAX arrays over as numpy:

    params_np = jax.tree_util.tree_map(np.asarray, params)
    params = params_from_numpy(params_np, device="cuda")

Nested dicts keep their keys, so a parameter path (``enc1/w``) names the
same tensor in both packages, and layouts are unchanged (no transposes).
Over a mesh, ``params_to_mesh`` keeps each rank's piece of every full
leaf under its ``Spec`` (``launch.steps.param_shardings``), and
``params_from_mesh`` puts the full leaves back on every rank;
``cache_to_mesh`` / ``cache_from_mesh`` do the same for a decode cache
under ``launch.steps.cache_shardings`` (a JAX cache given as numpy, or
the port's own).
bfloat16 arrays (numpy's ``ml_dtypes`` extension type, which torch cannot
read directly) go through float32, which holds every bfloat16 value
exactly, and come out as ``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ._device import resolve_device
from ._tree import tree_map
from .optim.adam import AdamState

__all__ = ["params_from_numpy", "opt_state_from_numpy", "params_to_mesh",
           "params_from_mesh", "cache_to_mesh", "cache_from_mesh"]


def _tensor(x, dev: torch.device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.tensor(x.astype(np.float32), device=dev).to(
            torch.bfloat16)
    return torch.tensor(x, device=dev)


def params_from_numpy(tree: Any, device: Optional[str] = None) -> Any:
    """Nested dict of numpy arrays -> the same dict of tensors (copies) on
    ``device`` (the card when None; raises if CUDA is missing).

    >>> params = params_from_numpy({"enc1": {"w": np.ones((3, 2))}}, "cpu")
    """
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x, dev), tree)


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


def params_to_mesh(tree: Any, mesh, specs: Any,
                   device: Optional[str] = None) -> Any:
    """Full leaves (numpy arrays or tensors, the same on every rank, e.g.
    JAX's draw) -> ``DTensor``s over ``mesh`` holding this rank's piece
    of each under the tree of ``dist.sharding.Spec`` ``specs``: a local
    slice, copied into storage of its own (no rank keeps a whole leaf),
    no collective. ``device``: where the pieces live (the card when
    None)."""
    return _to_mesh(tree, mesh, specs, device)


def _to_mesh(tree, mesh, specs, device):
    from .dist.layout import MeshLayout, _box, wrap
    from .dist.sharding import placements
    dev = resolve_device(device)
    lay = MeshLayout(mesh)

    def one(x, spec):
        t = x.to(dev) if isinstance(x, torch.Tensor) else _tensor(x, dev)
        pl = placements(mesh, spec)
        box = _box(tuple(t.shape), pl, lay.shape, lay.coords[lay.me])
        piece = t[tuple(slice(lo, hi) for lo, hi in box)]
        # a copy: a slice (even a contiguous one, along dim 0) would keep
        # the whole leaf's storage alive on every rank
        piece = piece.clone(memory_format=torch.contiguous_format)
        return wrap(piece, t.shape, pl, lay)

    return tree_map(one, tree, specs)


def params_from_mesh(tree: Any, mesh) -> Any:
    """``DTensor`` leaves over ``mesh`` -> the full tensors on every rank
    (each leaf moved to replicated by ``dist.layout.move``: one
    all-to-all). Plain tensors pass through."""
    from .dist.layout import (MeshLayout, local_of, move, placements_of,
                              replicated_placements)
    lay = MeshLayout(mesh)

    def one(x):
        if not hasattr(x, "placements"):
            return x
        return move(local_of(x), x.shape, placements_of(x, lay),
                    replicated_placements(lay), lay)

    return tree_map(one, tree)


def cache_to_mesh(tree: Any, mesh, specs: Any,
                  device: Optional[str] = None) -> Any:
    """A whole decode cache (numpy arrays, e.g. JAX's, or tensors; the
    same on every rank) -> ``DTensor``s over ``mesh`` holding this rank's
    piece of each leaf under ``specs`` (``launch.steps.cache_shardings``):
    the pieces the mesh decode step writes in place. A local slice, no
    collective; each piece is a copy (the step writes it in place, and
    the whole cache given here stays as it was).

    >>> pieces = cache_to_mesh(cache, mesh, cache_shardings(cache, mesh,
    ...                                                     rules), "cpu")
    """
    return _to_mesh(tree, mesh, specs, device)


def cache_from_mesh(tree: Any, mesh) -> Any:
    """A decode cache's ``DTensor`` pieces -> the whole leaves on every
    rank (one ``dist.layout.move`` each)."""
    return params_from_mesh(tree, mesh)
