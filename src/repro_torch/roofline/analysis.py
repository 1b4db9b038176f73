"""The roofline of one dry-run cell at the H100's constants (port of
``repro.roofline.analysis``).

Three terms per (arch x shape x mesh), in seconds a step, per device:

    compute    = (dot FLOPs + kernel operations) / PEAK_FLOPS
    memory     = (HBM byte proxy + kernel bytes) / HBM_BW
    collective = sum over collectives of bytes moved per device / LINK_BW

The counts come from ``roofline.counter.Counter`` over the step run on
meta tensors (rank 0's view on a mesh), not from compiled HLO: the port's
hand-written kernels count their own operations and bytes (``*_cost`` in
each kernel module), so the step is already the fused view. Collective
bytes take the reference's ring factors over the group size n:

    all-reduce       moved = 2 (n-1)/n * bytes(operand)
    all-gather       moved = (n-1)/n   * bytes(result)
    reduce-scatter   moved = (n-1)/n   * bytes(operand)  (operand = n*result)
    all-to-all       moved = (n-1)/n   * bytes(result)
    broadcast        moved = bytes(operand)

Constants (one NVIDIA H100 SXM, from NVIDIA's data sheet, dense rates,
at the 700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s f32 outside them (``PEAK_FLOPS_F32``, for a cell whose params are
f32), 3.35 TB/s HBM, 80 GB of it, and NVLink 4 at 450 GB/s each way to the
other cards of one host of eight. A group that spans hosts is slower
(its traffic leaves NVLink), so there ``collective_s`` is a lower bound.

The reference's ``flops_xla_raw``, ``bytes_xla_raw``, ``while_trips``,
``tile_bytes`` and its ``_fused`` view (``memory_fused_s``,
``dominant_fused``, ``roofline_fraction_fused``) have no meaning here
(no XLA cost analysis, no while loops, the kernels already are the fused
view) and are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch

__all__ = ["PEAK_FLOPS", "PEAK_FLOPS_F32", "HBM_BW", "LINK_BW", "HBM_BYTES",
           "CollectiveStats", "collective_stats", "Roofline", "analyze",
           "model_flops_for", "active_params", "kernel_bound_ms"]

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, per card
PEAK_FLOPS_F32 = 67e12       # float32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # NVLink 4, each way, within one host
HBM_BYTES = 80e9             # device memory per card


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak rate for work in ``dtype``."""
    return PEAK_FLOPS_F32 if dtype == torch.float32 else PEAK_FLOPS


def kernel_bound_ms(cost: Tuple[float, float],
                    dtype: torch.dtype = torch.float32) -> Tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card could take for
    a kernel's ``cost`` = (operations, bytes), the larger of bytes over
    ``HBM_BW`` and operations over the peak for ``dtype``."""
    ops, nbytes = cost
    return max((nbytes / HBM_BW * 1e3, "bytes"),
               (ops / peak_flops(dtype) * 1e3, "operations"))


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]    # bytes moved per device (ring model)
    raw_bytes_by_kind: Dict[str, float]

    @property
    def total_moved(self) -> float:
        return sum(self.bytes_by_kind.values())


def collective_stats(calls: Iterable[Tuple[str, int, int]]
                     ) -> CollectiveStats:
    """Ring-model bytes moved per device of (kind, bytes, group size n)
    calls (``Counts.collectives``); a group of one moves nothing."""
    counts: Dict[str, int] = {}
    moved: Dict[str, float] = {}
    raw: Dict[str, float] = {}
    for kind, nbytes, n in calls:
        ring = (n - 1) / n if n > 1 else 0.0
        if kind == "all-reduce":
            b = 2.0 * ring * nbytes
        elif kind in ("all-gather", "reduce-scatter", "all-to-all"):
            b = ring * nbytes
        else:            # broadcast
            b = float(nbytes) if n > 1 else 0.0
        counts[kind] = counts.get(kind, 0) + 1
        moved[kind] = moved.get(kind, 0.0) + b
        raw[kind] = raw.get(kind, 0.0) + float(nbytes)
    return CollectiveStats(counts=counts, bytes_by_kind=moved,
                           raw_bytes_by_kind=raw)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float           # dot FLOPs + kernel operations
    bytes_per_device: float           # HBM proxy + kernel bytes
    collective_bytes: float           # ring-model bytes moved per device
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float                # 6*N*D (active params) global
    useful_ratio: float               # model_flops / (flops_per_device*chips)
    collective_counts: Dict[str, float]
    memory_analysis: Dict[str, float]
    roofline_fraction: float          # ideal/dominant-term efficiency
    dot_flops: float = 0.0            # the aten products alone
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)         # launches, operations, bytes by name
    collective_moved: Dict[str, float] = dataclasses.field(
        default_factory=dict)   # bytes moved per device, by op kind

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def analyze(arch: str, shape: str, mesh_name: str, n_chips: int, counts,
            model_flops: float, memory_analysis: Optional[dict] = None,
            dtype: torch.dtype = torch.bfloat16) -> Roofline:
    """The roofline of a cell from its ``Counts`` (one device's), at the
    peak for the cell's param ``dtype``."""
    cs = collective_stats(counts.collectives)
    flops = counts.dot_flops + counts.kernel_operations
    byts = counts.bytes_proxy + counts.kernel_bytes
    peak = peak_flops(dtype)
    compute_s = flops / peak
    memory_s = byts / HBM_BW
    collective_s = cs.total_moved / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total_flops = flops * n_chips
    useful = model_flops / total_flops if total_flops else 0.0
    # the ideal step is compute-only at the useful FLOPs; the step takes
    # at least the dominant term, so the fraction is ideal / max(terms)
    ideal = model_flops / (n_chips * peak)
    frac = ideal / max(max(terms.values()), 1e-30)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes=cs.total_moved,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops, useful_ratio=useful,
        collective_counts=dict(cs.counts),
        memory_analysis=memory_analysis or {},
        roofline_fraction=frac, dot_flops=counts.dot_flops,
        kernels={k: dict(v) for k, v in counts.kernels.items()},
        collective_moved=dict(cs.bytes_by_kind))


def model_flops_for(cfg, shape_name: str, n_params_total: int,
                    n_params_active: Optional[int] = None) -> float:
    """6*N*D with D = tokens processed per step (decode: one per batch row).
    For training D counts fwd+bwd via the 6x factor; for inference 2*N*D."""
    from ..models.zoo import SHAPES
    sh = SHAPES[shape_name]
    n = n_params_active or n_params_total
    if sh["kind"] == "train":
        return 6.0 * n * sh["batch"] * sh["seq"]
    if sh["kind"] == "prefill":
        return 2.0 * n * sh["batch"] * sh["seq"]
    return 2.0 * n * sh["batch"]  # decode: 1 token per row


def active_params(cfg, n_total: int) -> int:
    """Rough active-parameter count for MoE archs (top-k of routed)."""
    if not cfg.n_experts:
        return n_total
    # routed expert params per layer
    per_layer_routed = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
    cycles = cfg.n_layers
    routed_total = per_layer_routed * cycles
    active_routed = routed_total * cfg.top_k / cfg.n_experts
    return int(n_total - routed_total + active_routed)
