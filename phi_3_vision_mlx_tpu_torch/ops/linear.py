"""Linear layers and the quantized embedding lookup
(counterpart of ``phi_3_vision_mlx_tpu/ops/linear.py``).

A linear leaf is either ``{'weight': (K, N)}`` (full precision), one of the
port's word layouts ``{'qweight': (K/8, N) int32 (4-bit) or (K/4, N) int32
(8-bit), 'scales': (K/64, N) bf16, 'biases': (K/64, N) bf16 (absent in
symmetric mode)}``, or the JAX package's flat packed 4-bit layout
``{'weight': (K, N/2) uint8, 'scales', 'biases'}`` (``core/weights.py:
is_packed_leaf``), optionally with a ``'bias': (N,)``.  The width of a word
layout is read from the word count against K (``core/weights.py:
leaf_bits``).  Dispatch follows the JAX package (ops/linear.py:101-131,
204-227): up to 256 rows go to kernel K1 (4-bit), K8 (8-bit) or K9 (packed);
above that (prefill) the weight is unpacked, dequantized to the activation
dtype and multiplied with ``torch.matmul``, as the JAX package leaves that
product to XLA.  LoRA leaves are not ported.
"""

from __future__ import annotations

import torch

from ..core.weights import LAYOUTS, from_packed_layout, is_packed_leaf, leaf_bits
from .kernels.quant_matmul import quant_matmul, quant_matmul_packed, quant_matmul_w8
from .quant import SYMMETRIC_MID, QTensor, dequantize

KERNEL_MAX_ROWS = 256
KERNELS = {4: quant_matmul, 8: quant_matmul_w8}  # bits -> K1 or K8


def embedding(p: dict, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Token-embedding lookup; quantized tables dequantize only the looked-up
    rows (groups along the embedding dim)."""
    ids = ids.long()
    rows = p["weight"][ids]
    if "scales" not in p:
        return rows if dtype is None else rows.to(dtype)
    s = p["scales"][ids]
    *lead, e = rows.shape
    groups = s.shape[-1]
    rf = rows.float().reshape(*lead, groups, e // groups)
    if "biases" in p:
        out = rf * s.float()[..., None] + p["biases"][ids].float()[..., None]
    else:
        out = (rf - SYMMETRIC_MID) * s.float()[..., None]
    return out.reshape(*lead, e).to(dtype or s.dtype)


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Apply a linear leaf to ``x`` (..., K) -> (..., N)."""
    lead, k = x.shape[:-1], x.shape[-1]
    if "qweight" in p:
        payload, bits = p["qweight"], leaf_bits(p["qweight"], k)
        kernel, unpack = KERNELS[bits], LAYOUTS[bits][2]
    elif is_packed_leaf(p):
        payload, kernel = p["weight"], quant_matmul_packed
        unpack = lambda w: from_packed_layout(w, k // p["scales"].shape[-2])  # noqa: E731
    elif "scales" in p:
        raise ValueError("a quantized linear leaf needs core/weights.prepare_params first")
    if "scales" in p:
        s, b = p["scales"], p.get("biases")
        if x.numel() // k <= KERNEL_MAX_ROWS:
            y = kernel(x.reshape(-1, k).contiguous(), payload, s, b, out_dtype=x.dtype)
            y = y.reshape(*lead, -1)
        else:
            w = dequantize(QTensor(unpack(payload), s, b), dtype=x.dtype)
            y = torch.matmul(x, w)
    else:
        y = torch.matmul(x, p["weight"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def layer_view(node: dict, layer: int) -> dict:
    """Layer ``layer`` of a stacked leaf: zero-copy ``t[layer]`` views."""
    return {k: v[layer] for k, v in node.items()}


def dense_stacked(node: dict, x: torch.Tensor, layer: int) -> torch.Tensor:
    """Linear over layer ``layer`` of a stacked leaf (JAX ``dense_stacked``)."""
    return dense(layer_view(node, layer), x)
