"""Normalization (counterpart of ``phi_3_vision_mlx_tpu/ops/norms.py``):
the decoder's RMSNorm and the CLIP tower's LayerNorm."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 accumulation, cast back to ``x.dtype``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of the CLIP tower: float32 mean and (biased) variance, cast
    back to ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()).to(x.dtype)
