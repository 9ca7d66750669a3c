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
above that (prefill, training batches) the weight is unpacked, dequantized
to the activation dtype and multiplied with ``torch.matmul``, as the JAX
package leaves that product to XLA.  Both routes run behind the autograd
seam of ``ops/kernels/quant_matmul.py``, so a gradient reaches ``x``
through them; the frozen weights take none.

Any leaf kind may carry LoRA leaves, ``'lora_a': (K, r)``, ``'lora_b': (r,
N)`` and ``'lora_scale'`` (a 0-d tensor, or absent for 1.0), all float32:
:func:`dense` adds ``scale * (x_dropped @ A) @ B`` to the base output in
float32, as the JAX ``_apply_lora`` does at ``HIGHEST`` precision (the
port leaves TF32 off, PyTorch's default for matmuls).  A stacked leaf's
``lora_a (nl, K, r)``, ``lora_b (nl, r, N)`` and ``lora_scale (nl,)`` are
read through the same zero-copy ``w[layer]`` views as its weights, so the
scale stays a device tensor inside a captured decode step.
"""

from __future__ import annotations

import torch

from ..core.weights import LAYOUTS, is_packed_leaf, leaf_bits
from .kernels.quant_matmul import (DequantMatmulFn, QuantMatmulFn, QuantMatmulPackedFn,
                                   QuantMatmulW8Fn, packed_unpack)
from .quant import SYMMETRIC_MID

KERNEL_MAX_ROWS = 256
KERNELS = {4: QuantMatmulFn, 8: QuantMatmulW8Fn}  # bits -> K1 or K8, behind the seam


def is_quantized(p: dict) -> bool:
    """Whether a linear or embedding leaf holds a quantized weight."""
    return "scales" in p


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


def dense(p: dict, x: torch.Tensor, dropout_mask=None) -> torch.Tensor:
    """Apply a linear leaf to ``x`` (..., K) -> (..., N); ``dropout_mask``
    (the shape of ``x``) scales the LoRA branch's input only."""
    lead, k = x.shape[:-1], x.shape[-1]
    if "qweight" in p:
        payload, bits = p["qweight"], leaf_bits(p["qweight"], k)
        seam, unpack = KERNELS[bits], LAYOUTS[bits][2]
    elif is_packed_leaf(p):
        payload, seam = p["weight"], QuantMatmulPackedFn
        unpack = packed_unpack(payload, p["scales"])
    elif "scales" in p:
        raise ValueError("a quantized linear leaf needs core/weights.prepare_params first")
    if "scales" in p:
        s, b = p["scales"], p.get("biases")
        if x.numel() // k <= KERNEL_MAX_ROWS:
            y = seam.apply(x.reshape(-1, k).contiguous(), payload, s, b, x.dtype)
            y = y.reshape(*lead, -1)
        else:
            y = DequantMatmulFn.apply(x, payload, s, b, unpack)
    else:
        y = torch.matmul(x, p["weight"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    if "lora_a" in p:
        y = _apply_lora(p, x, y, dropout_mask)
    return y


def _apply_lora(p: dict, x, y, dropout_mask=None):
    """``y + scale * (x_dropped @ A) @ B`` in float32, cast to ``x.dtype``
    (JAX ``_apply_lora``; the reference ``LoRALinear``).  The scale takes no
    gradient."""
    xa = x if dropout_mask is None else x * dropout_mask
    z = torch.matmul(torch.matmul(xa.float(), p["lora_a"].float()), p["lora_b"].float())
    scale = p.get("lora_scale", 1.0)
    if torch.is_tensor(scale):
        scale = scale.detach().float()
    return (y.float() + scale * z).to(x.dtype)


def layer_view(node: dict, layer: int) -> dict:
    """Layer ``layer`` of a stacked leaf: zero-copy ``t[layer]`` views."""
    return {k: v[layer] for k, v in node.items()}


def dense_stacked(node: dict, x: torch.Tensor, layer: int, dropout_mask=None) -> torch.Tensor:
    """Linear over layer ``layer`` of a stacked leaf, its LoRA leaves
    included (JAX ``dense_stacked``)."""
    return dense(layer_view(node, layer), x, dropout_mask)
