"""Mamba2 SSD (state-space duality) block — full-sequence chunked scan +
recurrent single-token decode. [arXiv:2405.21060]

Recurrence (per head h, head dim P, state dim N):
    h_t = exp(a_h dt_t) h_{t-1} + dt_t B_t x_t^T       (h_t in R^{P x N})
    y_t = h_t C_t + D_h x_t
The full-sequence form runs the chunked scan through
``kernels.ssd.ssd_attention``: the hand-written CUDA kernels when the
tensors are on the card, their plain PyTorch versions on the CPU, forward
and, under grad, backward (``SSDFunction``: ``csrc/ssd_bwd.cu`` on the
card). The JAX package's model runs a jnp chunked scan here, keeps the
Pallas kernel as the TPU drop-in for the same forward, and trains through
jax's autodiff of the scan, whose gradient is NaN where the reference's
full-width dt makes exp(cum_i - cum_j) for i < j overflow (ROADMAP C-11);
the port's backward never forms that exp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .param import PM
from .layers import rmsnorm_apply
from .._device import resolve_device
from ..dist.sharding import (active_axis, axis_index, model_gather,
                             model_sum, model_whole, shard, tp_enter,
                             tp_exit)
from ..kernels.ssd.ops import ssd_attention

__all__ = ["CONV_W", "ssm_layout", "ssd_apply", "ssm_init_cache",
           "ssd_decode", "ssd_decode_"]

CONV_W = 4  # causal depthwise conv width


def ssm_layout(d: int, d_inner: int, n_state: int, headdim: int):
    H = d_inner // headdim
    return {
        "wz": PM((d, d_inner), ("fsdp", "mlp"), init="scaled"),
        "wx": PM((d, d_inner), ("fsdp", "mlp"), init="scaled"),
        "wB": PM((d, n_state), ("fsdp", None), init="scaled"),
        "wC": PM((d, n_state), ("fsdp", None), init="scaled"),
        "wdt": PM((d, H), ("fsdp", None), init="scaled"),
        "dt_bias": PM((H,), (None,), init="zeros"),
        "A_log": PM((H,), (None,), init="zeros"),
        "D": PM((H,), (None,), init="ones"),
        "conv_x": PM((CONV_W, d_inner), (None, "mlp"), init="scaled"),
        "conv_B": PM((CONV_W, n_state), (None, None), init="scaled"),
        "conv_C": PM((CONV_W, n_state), (None, None), init="scaled"),
        "norm": PM((d_inner,), (None,), init="ones"),
        "wo": PM((d_inner, d), ("mlp", "fsdp"), init="scaled"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width CONV_W. x: (B, S, D); w: (CONV_W, D)."""
    pad = F.pad(x, (0, 0, CONV_W - 1, 0))
    out = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(CONV_W))
    return F.silu(out)


def _causal_conv_step(x_new, tail, w):
    """x_new: (B, 1, D); tail: (B, CONV_W-1, D) previous inputs."""
    window = torch.cat([tail, x_new], dim=1)             # (B, CONV_W, D)
    out = torch.einsum("bwd,wd->bd", window, w)[:, None]
    return F.silu(out), window[:, 1:]


def _ssd_inputs(params, u):
    """u: (B, S, d) -> z, x (B,S,d_inner), B/C (B,S,N), dt_raw (B,S,H)."""
    z = u @ params["wz"]
    x = u @ params["wx"]
    Bm = u @ params["wB"]
    Cm = u @ params["wC"]
    dt_raw = u @ params["wdt"]
    return z, x, Bm, Cm, dt_raw


def _whole_width(params, headdim: int):
    """``params`` as the SSM computes with them: where the "model" axis
    splits the inner width through its heads (the reference's layout of
    an SSM whose heads the axis does not divide: ``wx`` holds a part of
    a head), ``wz`` / ``wx`` / ``conv_x`` and ``wo`` gathered over model
    at use (``ssm_model_gather``, one all_gather each, this layer's
    only), so that the layer runs whole on every model rank; a split by
    whole heads, or no split, as they are."""
    full = params["A_log"].shape[0] * headdim
    if params["wx"].shape[-1] % headdim == 0:
        return params
    out = dict(params)
    for k, dim in (("wz", -1), ("wx", -1), ("conv_x", -1), ("wo", 0)):
        out[k] = model_whole(params[k], full, dim, "ssm_model_gather")
    return out


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(v, 0)."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype, device=v.device))


def ssd_apply(params, u: torch.Tensor, *, headdim: int, chunk: int = 64,
              tile_bf16: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """Full-sequence SSD block. u: (B, S, d), S a multiple of ``chunk``.

    dt = softplus(dt_raw + dt_bias) in f32; the intra-chunk, inter-chunk
    and D x terms come from ``ssd_attention`` (kernels on the card, forward
    and backward) on f32 x, dt, B and C; then the gated RMSNorm (eps 1e-6)
    and ``wo``. ``tile_bf16``: the intra-chunk tiles in bf16, the decay
    cumsums, states and scan in f32 (the bf16-tile kernels).

    Under a mesh whose "model" axis splits the inner width (``wx`` holds
    fewer than the heads' columns), this is the rank's share of a
    tensor-parallel block, its heads the slice ``lo:lo + h_loc``: ``wz`` /
    ``wx`` / ``conv_x`` hold its columns and ``wo`` its rows. u, and every
    weight the rank uses whole or in part (``wB``, ``wC``, ``wdt``, the B /
    C convs, and the per-head ``dt_bias``, ``A_log``, ``D`` and ``norm``
    before it takes its slice), enter through ``tp_enter``: each rank's
    heads give a part of their gradients. The gated RMSNorm spans the full
    inner width: the sum of squares of the rank's columns is summed over
    model (``ssm_norm``; its gradient, which each rank's columns give a
    part of, too). ``wo``'s partial output leaves through ``tp_exit``.
    Where the axis splits the width through the heads, the pieces are
    gathered over model first (``_whole_width``) and the block runs
    whole."""
    params = _whole_width(params, headdim)
    B_, S, d = u.shape
    H = params["A_log"].shape[0]
    cols = params["wx"].shape[-1]
    h_loc = cols // headdim
    tp = h_loc < H
    enter = tp_enter if tp else (lambda t: t)
    lo = axis_index(active_axis("model"), "model") * h_loc if tp else 0
    heads = slice(lo, lo + h_loc)
    u = enter(u)
    w = {k: enter(params[k]) for k in (
        "wB", "wC", "wdt", "conv_B", "conv_C", "dt_bias", "A_log", "D",
        "norm")}
    z = u @ params["wz"]
    x = _causal_conv(u @ params["wx"], params["conv_x"])
    Bm = _causal_conv(u @ w["wB"], w["conv_B"])
    Cm = _causal_conv(u @ w["wC"], w["conv_C"])
    dt_raw = (u @ w["wdt"])[..., heads]
    x = shard(x, "batch", "seq", "mlp")
    xh = x.reshape(B_, S, h_loc, headdim).float()
    dt = _softplus(dt_raw.float() + w["dt_bias"][heads].float())  # (B,S,h)
    y = ssd_attention(xh, dt, w["A_log"][heads], w["D"][heads], Bm.float(),
                      Cm.float(), chunk=chunk, tile_bf16=tile_bf16)

    # gated output norm (mamba2: RMSNorm(y * silu(z))), its mean square
    # over the full inner width
    g = (y.reshape(B_, S, cols).to(u.dtype) * F.silu(z)).float()
    ss = (g * g).sum(dim=-1, keepdim=True)
    if tp:
        ss = model_sum(ss, "ssm_norm", parts=True)
    scale = w["norm"][lo * headdim:lo * headdim + cols].float()
    y = (g * torch.rsqrt(ss / (H * headdim) + eps) * scale).to(u.dtype)
    y = y @ params["wo"]
    return tp_exit(y) if tp else y


def ssm_init_cache(B: int, d_inner: int, n_state: int, headdim: int,
                   dtype=torch.float32, device=None):
    """Zeroed decode cache on ``device`` (the card when None)."""
    dev = resolve_device(device)
    H = d_inner // headdim
    return {
        "state": torch.zeros((B, H, headdim, n_state), dtype=torch.float32,
                             device=dev),
        "conv_x": torch.zeros((B, CONV_W - 1, d_inner), dtype=dtype,
                              device=dev),
        "conv_B": torch.zeros((B, CONV_W - 1, n_state), dtype=dtype,
                              device=dev),
        "conv_C": torch.zeros((B, CONV_W - 1, n_state), dtype=dtype,
                              device=dev),
    }


def ssd_decode_(params, u, cache, *, headdim: int) -> torch.Tensor:
    """Single-token recurrent step. u: (B, 1, d); ``cache`` (state,
    conv_x, conv_B, conv_C) is updated in place (each leaf keeps its
    dtype). Returns y.

    Under a mesh whose "model" axis splits the heads (``wx`` holding fewer
    than the heads' columns; the decode rules' "mlp"), as ``ssd_apply``
    splits them: the rank's heads ``lo:lo + h_loc`` of the state (its
    piece of ``cache["state"]``), its columns of ``wz`` / ``wx`` /
    ``conv_x`` and rows of ``wo``; the gated norm's sum of squares summed
    over model (``ssm_norm``) and the output too (``tp_exit``). The conv
    states stay whole on every rank (``cache_shardings``' conv rows): the
    rank convolves its columns, and its new conv input columns are
    gathered over model into the whole ``conv_x`` (``ssm_conv_gather``).
    A split through the heads gathers the weights first, as
    ``ssd_apply``'s."""
    params = _whole_width(params, headdim)
    B_ = u.shape[0]
    H = params["A_log"].shape[0]
    cols = params["wx"].shape[-1]
    h_loc = cols // headdim
    if h_loc < H:
        return _ssd_decode_tp_(params, u, cache, headdim=headdim,
                               h_loc=h_loc)
    z, x, Bm, Cm, dt_raw = _ssd_inputs(params, u)
    x, conv_x = _causal_conv_step(x, cache["conv_x"], params["conv_x"])
    Bm, conv_B = _causal_conv_step(Bm, cache["conv_B"], params["conv_B"])
    Cm, conv_C = _causal_conv_step(Cm, cache["conv_C"], params["conv_C"])

    xh = x.reshape(B_, H, headdim).float()
    dt = _softplus(dt_raw[:, 0].float() + params["dt_bias"].float())  # (B,H)
    a = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt * a[None, :])                              # (B,H)

    state = cache["state"]                                           # (B,H,P,N)
    state = (state * decay[:, :, None, None]
             + torch.einsum("bh,bn,bhp->bhpn", dt, Bm[:, 0].float(), xh))
    y = torch.einsum("bhpn,bn->bhp", state, Cm[:, 0].float())
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(B_, 1, H * headdim).to(u.dtype)
    y = rmsnorm_apply({"scale": params["norm"]}, y * F.silu(z))
    for key, new in (("state", state), ("conv_x", conv_x),
                     ("conv_B", conv_B), ("conv_C", conv_C)):
        cache[key].copy_(new)
    return y @ params["wo"]


def _ssd_decode_tp_(params, u, cache, *, headdim: int, h_loc: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """``ssd_decode_``'s tensor-parallel share: this rank's ``h_loc``
    heads (see there)."""
    B_ = u.shape[0]
    H = params["A_log"].shape[0]
    cols = h_loc * headdim
    lo = axis_index(active_axis("model"), "model") * h_loc
    heads, width = slice(lo, lo + h_loc), slice(lo * headdim,
                                                lo * headdim + cols)
    if cache["state"].shape[1] != h_loc:
        raise ValueError(
            f"ssd_decode_: the state holds {cache['state'].shape[1]} heads, "
            f"the weights {h_loc}: lay the cache out under the rules the "
            f"params were laid out under (launch.steps.cache_shardings)")
    u = tp_enter(u)
    z, x, Bm, Cm, dt_raw = _ssd_inputs(params, u)   # z, x: this rank's cols
    x_all = model_gather(x, -1, "ssm_conv_gather")
    conv_x = torch.cat([cache["conv_x"][:, 1:], x_all], dim=1)
    x, _ = _causal_conv_step(x, cache["conv_x"][..., width],
                             params["conv_x"])
    Bm, conv_B = _causal_conv_step(Bm, cache["conv_B"], params["conv_B"])
    Cm, conv_C = _causal_conv_step(Cm, cache["conv_C"], params["conv_C"])

    xh = x.reshape(B_, h_loc, headdim).float()
    dt = _softplus(dt_raw[:, 0].float()
                   + params["dt_bias"].float())[:, heads]            # (B,h)
    a = -torch.exp(params["A_log"].float())[heads]
    decay = torch.exp(dt * a[None, :])

    state = cache["state"]                                           # (B,h,P,N)
    state = (state * decay[:, :, None, None]
             + torch.einsum("bh,bn,bhp->bhpn", dt, Bm[:, 0].float(), xh))
    y = torch.einsum("bhpn,bn->bhp", state, Cm[:, 0].float())
    y = y + params["D"].float()[heads][None, :, None] * xh
    y = y.reshape(B_, 1, cols).to(u.dtype)
    # the gated RMSNorm over the full inner width
    g = (y * F.silu(z)).float()
    ss = model_sum((g * g).sum(dim=-1, keepdim=True), "ssm_norm")
    y = (g * torch.rsqrt(ss / (H * headdim) + eps)
         * params["norm"][width].float()).to(u.dtype)
    for key, new in (("state", state), ("conv_x", conv_x),
                     ("conv_B", conv_B), ("conv_C", conv_C)):
        cache[key].copy_(new)
    return tp_exit(y @ params["wo"])


def ssd_decode(params, u, cache, *, headdim: int):
    """``ssd_decode_`` on a copy of the cache. Returns (y, new_cache); the
    old cache is left as it was."""
    new = {k: v.clone() for k, v in cache.items()}
    return ssd_decode_(params, u, new, headdim=headdim), new
