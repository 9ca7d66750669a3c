"""Kernel K3: decode attention over the stacked dense KV cache.

Replaces ``phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:dense_kv_attention``;
the CUDA source is ``csrc/attention.cu`` (``k3_dense_kv_attention``).  A few
queries (Lq <= 16 on the decode path) attend to layer ``layer_idx`` of the
``(layers, B, KV, Lmax, D)`` cache, read in place.  Query ``i`` sits at
position ``offset + i`` and sees key ``j`` iff ``j <= offset + i`` and
``valid[b, j]``.  The quantized-cache and paged kernels of that file are not
ported yet.

:func:`dense_kv_attention` launches the kernel for CUDA tensors and runs the
plain version :func:`dense_kv_attention_plain` only for CPU tensors.
``dense_kv_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..attention import decode_attention
from . import _build
from .flash_attention import check_attention_inputs, head_major_empty


def dense_kv_attention_plain(q, k_stack, v_stack, valid, offset: int, layer_idx: int, scale: float):
    q_pos = offset + torch.arange(q.shape[2], device=q.device)
    return decode_attention(q, k_stack[layer_idx], v_stack[layer_idx], valid, q_pos, scale)


def dense_kv_attention(q, k_stack, v_stack, valid, offset: int, layer_idx: int, scale: float):
    """q (B, H, Lq, D); k_stack/v_stack (layers, B, KV, Lmax, D); valid
    (B, Lmax) bool.  Returns (B, H, Lq, D)."""
    if q.device.type == "cpu":
        return dense_kv_attention_plain(q, k_stack, v_stack, valid, offset, layer_idx, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"dense_kv_attention: no kernel for device {q.device}")
    if k_stack.dim() != 5 or not 0 <= layer_idx < k_stack.shape[0]:
        raise ValueError(f"dense_kv_attention: cache {tuple(k_stack.shape)}, layer {layer_idx}")
    check_attention_inputs(q, k_stack, v_stack, valid, "dense_kv_attention")
    b, h, lq, d = q.shape
    kvh, lmax = k_stack.shape[2], k_stack.shape[3]
    out = head_major_empty(q)
    lib, _ = _build.library()
    err = lib.k3_dense_kv_attention(
        q.data_ptr(), k_stack.data_ptr(), v_stack.data_ptr(),
        valid.view(torch.uint8).data_ptr(), out.data_ptr(), b, h, kvh, lq, lmax, d,
        *q.stride()[:3], *out.stride()[:3], int(layer_idx), int(offset), float(scale),
        _build.stream_ptr(q.device),
    )
    _build.check(err, "k3_dense_kv_attention")
    dense_kv_attention.launches += 1
    return out


dense_kv_attention.launches = 0
