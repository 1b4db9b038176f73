"""Parameter layouts: one source of truth for parameter shapes, initializers
and logical sharding axes (the axes are kept for the distributed slice).

``model_layout(cfg)`` (transformer.py) builds a nested dict of ``PM``
leaves; ``materialize`` turns it into initialized tensors and
``partition_specs`` into the mesh rules' ``Spec`` per leaf, and
``abstract`` into ``meta`` tensors (the dry-run's: shapes and dtypes,
nothing allocated).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["PM", "is_pm", "abstract", "materialize", "partition_specs",
           "stack_layout", "count_params"]


class PM(NamedTuple):
    """Parameter metadata: shape, logical axes (one name or None per dim),
    initializer, dtype."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | scaled
    dtype: Any = None              # None -> layout default
    scale: float = 0.02

    def __repr__(self):
        return f"PM{self.shape}@{self.axes}"


def is_pm(x) -> bool:
    return isinstance(x, PM)


def _map_pm(fn, layout):
    if isinstance(layout, dict):
        return {k: _map_pm(fn, layout[k]) for k in sorted(layout)}
    return fn(layout)


def _pm_leaves(layout):
    """PM leaves in JAX's pre-order (dict keys sorted)."""
    if isinstance(layout, dict):
        return [pm for k in sorted(layout) for pm in _pm_leaves(layout[k])]
    return [layout]


def abstract(layout, default_dtype: torch.dtype = torch.bfloat16):
    """The layout as a tree of ``meta`` tensors of each leaf's shape and
    dtype (``pm.dtype`` or ``default_dtype``): nothing is allocated (the
    dry-run's params)."""
    return _map_pm(lambda pm: torch.empty(pm.shape, dtype=pm.dtype
                                          or default_dtype, device="meta"),
                   layout)


def materialize(generator: torch.Generator, layout,
                dtype: torch.dtype = torch.float32, device=None):
    """Initialized parameters for ``layout`` on ``device`` (the card when
    None), drawn from ``generator`` leaf by leaf in the JAX pre-order.

    Same initializers as the JAX package: normal (N(0, 1) * pm.scale),
    zeros, ones, and scaled (N(0, 1) * sqrt(1 / fan_in)) with fan_in =
    ``shape[0]``, which for a stacked layer leaf is the layer count, as in
    the reference. The numbers differ from JAX's (threefry keys); a run
    that must match a JAX run carries its params across with
    ``convert.params_from_numpy``.
    """
    dev = resolve_device(device)

    def one(pm: PM):
        dt = pm.dtype or dtype
        if pm.init == "zeros":
            return torch.zeros(pm.shape, dtype=dt, device=dev)
        if pm.init == "ones":
            return torch.ones(pm.shape, dtype=dt, device=dev)
        z = torch.randn(pm.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        if pm.init == "scaled":
            fan_in = pm.shape[0] if pm.shape else 1
            return (z * float(np.sqrt(1.0 / max(fan_in, 1)))).to(dt)
        return (z * pm.scale).to(dt)

    return _map_pm(one, layout)


def partition_specs(layout, rules: dict):
    """Logical axes -> ``dist.sharding.Spec`` via ``rules`` (name -> mesh
    axes or None), with no divisibility check (the reference's
    ``PartitionSpec`` per leaf). Unknown names map to None (replicated)."""
    from ..dist.sharding import logical_spec
    return _map_pm(lambda pm: logical_spec(pm.axes, rules), layout)


def stack_layout(layout, n: int, axis_name: Optional[str] = None):
    """Prepend a leading `layers` dim of size n to every PM."""
    return _map_pm(lambda pm: PM((n,) + pm.shape, (axis_name,) + pm.axes,
                                 pm.init, pm.dtype, pm.scale), layout)


def count_params(layout) -> int:
    return int(sum(int(np.prod(pm.shape)) for pm in _pm_leaves(layout)))
