"""Group quantization (counterpart of ``phi_3_vision_mlx_tpu/ops/quant.py``).

Affine mode: ``w ~= scales[g] * q + biases[g]`` with ``q`` in
``[0, 2**bits - 1]``; symmetric mode (4-bit only): ``w ~= scales[g] * (q - 8)``.
Groups run along the contraction dim K of ``(K, N)`` weights.  The payload
here is the plain one-value-per-byte uint8 ``(K, N)`` of the checkpoint; the
packed layout kernel K1 reads is built by ``core.weights.prepare_params``.
All dequantization math is float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

SYMMETRIC_MID = 8


class QTensor(NamedTuple):
    q: torch.Tensor  # (..., K, N) uint8
    scales: torch.Tensor  # (..., K // group, N)
    biases: Optional[torch.Tensor]  # same, or None (symmetric)


def quantize(
    w: torch.Tensor, group_size: int = 64, bits: int = 4, axis: int = -2, mode: str = "affine"
) -> QTensor:
    """Quantize ``w`` along ``axis`` in groups of ``group_size``."""
    if axis != -2:
        w = w.movedim(axis, -2)
    *lead, k, n = w.shape
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group={group_size}")
    levels = (1 << bits) - 1
    wf = w.float().reshape(*lead, k // group_size, group_size, n)
    w_min = wf.amin(dim=-2, keepdim=True)
    w_max = wf.amax(dim=-2, keepdim=True)
    if mode == "symmetric":
        mid = 1 << (bits - 1)
        scale = torch.maximum(w_max / (levels - mid), w_min / (-mid))
        scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(wf / scale) + mid, 0, levels)
        biases = None
    else:
        scale = (w_max - w_min) / levels
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round((wf - w_min) / scale), 0, levels)
        biases = w_min.squeeze(-2)
    out = QTensor(q.reshape(*lead, k, n).to(torch.uint8), scale.squeeze(-2), biases)
    if axis != -2:
        out = QTensor(*(None if t is None else t.movedim(-2, axis) for t in out))
    return out


def quantize_for_saving(w_out_in: torch.Tensor, qcfg) -> dict:
    """Quantize an HF-layout ``(out, in)`` weight for checkpoint storage
    (``qcfg``: a ``core/config.py:QuantConfig``): ``weight`` (the levels,
    uint8), ``scales`` and, in affine mode, ``biases``, groups along the
    input dim, as the JAX package stores them."""
    t = quantize(w_out_in.T, group_size=qcfg.group_size, bits=qcfg.bits, mode=qcfg.mode)
    out = {"weight": t.q, "scales": t.scales}
    if t.biases is not None:
        out["biases"] = t.biases
    return out


def dequantize(t: QTensor, dtype=torch.bfloat16, axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`quantize`: f32 math, then one rounding to ``dtype``."""
    q, scales, biases = t
    if axis != -2:
        q, scales = q.movedim(axis, -2), scales.movedim(axis, -2)
        biases = None if biases is None else biases.movedim(axis, -2)
    *lead, k, n = q.shape
    groups = scales.shape[-2]
    qf = q.float().reshape(*lead, groups, k // groups, n)
    s = scales.float().unsqueeze(-2)
    if biases is None:
        w = (qf - SYMMETRIC_MID) * s
    else:
        w = qf * s + biases.float().unsqueeze(-2)
    w = w.reshape(*lead, k, n).to(dtype)
    return w if axis == -2 else w.movedim(-2, axis)


def quantized_matmul(x: torch.Tensor, t: QTensor, dtype=None) -> torch.Tensor:
    """``x @ dequantize(t)`` with the weight rounded to ``x``'s dtype and the
    product accumulated in float32 — the plain path of ``ops/quant.py``."""
    dtype = dtype or x.dtype
    w = dequantize(t, dtype=x.dtype)
    return (x.float() @ w.float()).to(dtype)
