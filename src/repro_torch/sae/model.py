"""Supervised autoencoder (paper §5, Fig. 4) — port of ``repro.sae.model``.

Symmetric fully-connected net: encoder d -> h -(ReLU)-> k (latent = #classes),
decoder k -> h -(ReLU)-> d. Loss phi = lambda * Huber(X, Xhat) + CE(Y, Z).

Parameters are the JAX package's nested dict with its names and layouts:
``enc1/w`` is (d, h) and is used as ``x @ w``, so input feature i is row i
of W1 and the paper's prunable "column" is our row (spec max-axis = 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import resolve_device

__all__ = ["SAEConfig", "sae_init", "sae_apply", "huber", "sae_loss",
           "accuracy"]


@dataclasses.dataclass(frozen=True)
class SAEConfig:
    n_features: int
    n_hidden: int = 96
    n_classes: int = 2
    lam: float = 1.0          # reconstruction weight (paper's lambda)
    huber_delta: float = 1.0


def _linear_init(d_in, d_out, generator, device):
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device) * math.sqrt(2.0 / d_in)
    return {"w": w.to(device),
            "b": torch.zeros((d_out,), dtype=torch.float32, device=device)}


def sae_init(cfg: SAEConfig, *, generator: torch.Generator,
             device: Optional[str] = None) -> Dict[str, Any]:
    """He-normal weights and zero biases, drawn from ``generator`` in the
    order enc1, enc2, dec1, dec2 (on the generator's device, then moved to
    ``device``). The draws differ from the JAX package's threefry draws;
    carry JAX weights across with ``repro_torch.convert.params_from_numpy``
    where the two must start equal."""
    dev = resolve_device(device)
    return {
        "enc1": _linear_init(cfg.n_features, cfg.n_hidden, generator, dev),
        "enc2": _linear_init(cfg.n_hidden, cfg.n_classes, generator, dev),
        "dec1": _linear_init(cfg.n_classes, cfg.n_hidden, generator, dev),
        "dec2": _linear_init(cfg.n_hidden, cfg.n_features, generator, dev),
    }


def sae_apply(params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (latent logits Z, reconstruction Xhat)."""
    h = torch.relu(x @ params["enc1"]["w"] + params["enc1"]["b"])
    z = h @ params["enc2"]["w"] + params["enc2"]["b"]
    hd = torch.relu(z @ params["dec1"]["w"] + params["dec1"]["b"])
    xhat = hd @ params["dec2"]["w"] + params["dec2"]["b"]
    return z, xhat


def huber(err: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    a = err.abs()
    return torch.where(a <= delta, 0.5 * a * a, delta * (a - 0.5 * delta))


def sae_loss(params, x, y, cfg: SAEConfig):
    """(lambda * mean Huber(Xhat - X) + mean CE, {"recon", "ce"})."""
    z, xhat = sae_apply(params, x)
    recon = huber(xhat - x, cfg.huber_delta).mean()
    logp = F.log_softmax(z, dim=-1)
    ce = -torch.gather(logp, 1, y[:, None]).mean()
    return cfg.lam * recon + ce, {"recon": recon, "ce": ce}


def accuracy(params, x, y) -> torch.Tensor:
    z, _ = sae_apply(params, x)
    return (torch.argmax(z, dim=-1) == y).to(torch.float32).mean()
