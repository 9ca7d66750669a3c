"""Kernels K3, K4 and K5: attention over the stacked KV cache, read in place.

Each takes the whole ``(layers, ...)`` cache and a layer index, so a layer is
read with no per-layer copy.  Query ``i`` sits at position ``offset + i``
(``q_pos0 + i``) and sees key ``j`` iff ``j <= offset + i`` and
``valid[b, j]``.  Queries and outputs are in the original D order.

* K3 :func:`dense_kv_attention` — decode (Lq <= 16) over the dense bf16
  cache ``(layers, B, KV, Lmax, D)``.  Replaces
  ``phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:dense_kv_attention``;
  CUDA source ``csrc/attention.cu`` (``k3_dense_kv_attention``).
* K4 :func:`quantized_kv_attention` — decode over the int4 cache (payload
  ``(layers, B, KV, Lmax, D)`` uint8 ``k | v << 4``, scales
  ``(layers, B, KV, Lmax, 4G)`` bf16; ``engine/state.py``).  Replaces
  ``kv_attention.py:quantized_kv_attention``; CUDA source
  ``csrc/quant_kv_attention.cu`` (``k4_quantized_kv_attention``).
* K5 :func:`quantized_flash_attention` — prefill and extend chunks of any
  length over the int4 cache.  Replaces
  ``kv_attention.py:quantized_flash_attention``; CUDA source
  ``csrc/quant_kv_attention.cu`` (``k5_quantized_flash_attention``).

The JAX package permutes the head dim of its quantized cache and of the
queries for the TPU's lane tiling; the port does not.  Each wrapper launches
its kernel for CUDA tensors and runs its plain version (``*_plain``: the
window dequantized to ``q.dtype``, then ``ops/attention.py``) only for CPU
tensors; ``<wrapper>.launches`` counts kernel launches.  The kernels
dequantize to the same bits as the plain version (f32 ``q * s``, then
``+ b``, one rounding to bf16).
"""

from __future__ import annotations

import torch

from ...engine.state import dequantize_kv
from ..attention import decode_attention
from . import _build
from .flash_attention import HEAD_DIMS, check_attention_inputs, flash_attention_plain, head_major_empty

KV_GROUP = 32  # the kernels' quantization group along D
K4_SPLIT_KEYS = 256  # K4: keys per block; longer windows split across blocks


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


def quantized_kv_attention_plain(q, payload, scales, valid, offset: int, layer_idx: int, scale: float):
    k, v = dequantize_kv(payload[layer_idx], scales[layer_idx], q.dtype, bits=4)
    q_pos = offset + torch.arange(q.shape[2], device=q.device)
    return decode_attention(q, k, v, valid, q_pos, scale)


def quantized_flash_attention_plain(q, payload, scales, valid, q_pos0: int, layer_idx: int, scale: float):
    k, v = dequantize_kv(payload[layer_idx], scales[layer_idx], q.dtype, bits=4)
    return flash_attention_plain(q, k, v, valid, q_pos0, scale)


def check_quantized_inputs(q, payload, scales, valid, layer_idx: int, name: str) -> None:
    """Device, dtype, shape, layout and alignment checks shared by K4 and K5."""
    b, h, _, d = q.shape
    if any(t.device != q.device for t in (payload, scales, valid)):
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dtype != torch.bfloat16 or payload.dtype != torch.uint8 or scales.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 q, a uint8 payload and bf16 scales, "
                        f"got {q.dtype}/{payload.dtype}/{scales.dtype}")
    if valid.dtype != torch.bool or not valid.is_contiguous():
        raise TypeError(f"{name}: valid must be a contiguous bool tensor")
    if payload.dim() != 5 or not 0 <= layer_idx < payload.shape[0]:
        raise ValueError(f"{name}: cache {tuple(payload.shape)}, layer {layer_idx}")
    nl, pb, kvh, lmax, width = payload.shape
    if d not in HEAD_DIMS or width != d or scales.shape != (nl, pb, kvh, lmax, 4 * (d // KV_GROUP)):
        raise ValueError(f"{name}: head dim {d}, int4 payload {tuple(payload.shape)} and scales "
                         f"{tuple(scales.shape)} (group {KV_GROUP}) do not match")
    if h % kvh or pb != b or valid.shape != (b, lmax):
        raise ValueError(f"{name}: q {tuple(q.shape)}, cache {tuple(payload.shape)}, "
                         f"valid {tuple(valid.shape)} do not match")
    if q.stride(-1) != 1 or not (payload.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{name}: q needs unit stride along D and the cache must be contiguous")
    if scales.data_ptr() % 8:
        raise ValueError(f"{name}: scales must be 8-byte aligned")


def quantized_kv_attention(q, payload, scales, valid, offset: int, layer_idx: int, scale: float):
    """Decode attention over layer ``layer_idx`` of the int4 cache.  q (B, H,
    Lq, D); payload (layers, B, KV, Lmax, D) uint8; scales (layers, B, KV,
    Lmax, 4G) bf16; valid (B, Lmax) bool.  Returns (B, H, Lq, D)."""
    if q.device.type == "cpu":
        return quantized_kv_attention_plain(q, payload, scales, valid, offset, layer_idx, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"quantized_kv_attention: no kernel for device {q.device}")
    check_quantized_inputs(q, payload, scales, valid, layer_idx, "quantized_kv_attention")
    b, h, lq, d = q.shape
    kvh, lmax = payload.shape[2], payload.shape[3]
    n_split = -(-min(lmax, offset + lq) // K4_SPLIT_KEYS)
    out = head_major_empty(q)
    # Per split: (max score, sum of exp, unnormalized output) of each query row.
    partial = (torch.empty((n_split, b * h * lq, d + 2), dtype=torch.float32, device=q.device)
               if n_split > 1 else None)
    lib, _ = _build.library()
    err = lib.k4_quantized_kv_attention(
        q.data_ptr(), payload.data_ptr(), scales.data_ptr(), valid.view(torch.uint8).data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(), b, h, kvh, lq, lmax, d,
        *q.stride()[:3], *out.stride()[:3], int(layer_idx), int(offset), float(scale),
        n_split, K4_SPLIT_KEYS, _build.stream_ptr(q.device),
    )
    _build.check(err, "k4_quantized_kv_attention")
    quantized_kv_attention.launches += 1
    return out


quantized_kv_attention.launches = 0


def quantized_flash_attention(q, payload, scales, valid, q_pos0: int, layer_idx: int, scale: float):
    """Flash attention of a prefill or extend chunk over layer ``layer_idx``
    of the int4 cache, the chunk's own keys included.  Shapes as in
    :func:`quantized_kv_attention`, at any Lq."""
    if q.device.type == "cpu":
        return quantized_flash_attention_plain(q, payload, scales, valid, q_pos0, layer_idx, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"quantized_flash_attention: no kernel for device {q.device}")
    check_quantized_inputs(q, payload, scales, valid, layer_idx, "quantized_flash_attention")
    b, h, lq, d = q.shape
    kvh, lmax = payload.shape[2], payload.shape[3]
    out = head_major_empty(q)
    lib, _ = _build.library()
    err = lib.k5_quantized_flash_attention(
        q.data_ptr(), payload.data_ptr(), scales.data_ptr(), valid.view(torch.uint8).data_ptr(),
        out.data_ptr(), b, h, kvh, lq, lmax, d, *q.stride()[:3], *out.stride()[:3],
        int(layer_idx), int(q_pos0), float(scale), _build.stream_ptr(q.device),
    )
    _build.check(err, "k5_quantized_flash_attention")
    quantized_flash_attention.launches += 1
    return out


quantized_flash_attention.launches = 0
