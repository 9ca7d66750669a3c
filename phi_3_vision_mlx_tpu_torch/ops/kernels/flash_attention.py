"""Kernel K2: masked flash attention for prefill and extend.

Replaces ``phi_3_vision_mlx_tpu/ops/kernels/flash_attention.py:flash_attention``;
the CUDA source is ``csrc/attention.cu`` (``k2_flash_attention``) over the
tensor-core body of ``csrc/flash_mma.cuh``, which rounds the softmax
weights to bf16 before ``p @ v`` as the JAX kernel does (the plain version
keeps them in f32).  Query
``i`` sits at absolute position ``q_pos0 + i`` and sees key ``j`` iff
``j <= q_pos0 + i`` and ``valid[b, j]``.  Head dim 96 runs as is (no padding
to 128 lanes, which was TPU-only); GQA maps query head ``h`` to kv head
``h // (H // KV)``.

:func:`flash_attention` launches the kernel for CUDA tensors and runs the
plain version :func:`flash_attention_plain` only for CPU tensors.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..attention import causal_valid_mask, masked_attention
from . import _build

# Head dims the CUDA source instantiates: Phi-3.5-mini's 96.  Add one here and
# in csrc/attention.cu when a configuration on the card needs it.
HEAD_DIMS = (96,)


def flash_attention_plain(q, k, v, valid, q_pos0: int, scale: float):
    q_pos = q_pos0 + torch.arange(q.shape[2], device=q.device)
    return masked_attention(q, k, v, causal_valid_mask(valid, q_pos), scale)


def check_attention_inputs(q, k, v, valid, name: str) -> None:
    """Device, dtype, shape, layout and alignment checks shared by K2 and
    K3 (both copy K and V rows with 16-byte loads)."""
    b, h, _, d = q.shape
    if any(t.device != q.device for t in (k, v, valid)):
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if valid.dtype != torch.bool or not valid.is_contiguous():
        raise TypeError(f"{name}: valid must be a contiguous bool tensor")
    if d not in HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"{name}: head dim {d} / k {tuple(k.shape)} / v {tuple(v.shape)}")
    kvh = k.shape[-3]
    if h % kvh or k.shape[-4] != b or valid.shape != (b, k.shape[-2]):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"valid {tuple(valid.shape)} do not match")
    if q.stride(-1) != 1 or not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q needs unit stride along D and k/v must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k and v must be 16-byte aligned")


def head_major_empty(q: torch.Tensor) -> torch.Tensor:
    """(B, H, Lq, D) output stored (B, Lq, H, D), so the caller's
    ``transpose(1, 2).reshape(B, Lq, H * D)`` is free."""
    b, h, lq, d = q.shape
    return torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def flash_attention(q, k, v, valid, q_pos0: int, scale: float):
    """q (B, H, Lq, D); k, v (B, KV, Lk, D) — the full key window, cache
    contents included; valid (B, Lk) bool.  Returns (B, H, Lq, D)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, valid, q_pos0, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    check_attention_inputs(q, k, v, valid, "flash_attention")
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    out = head_major_empty(q)
    lib, _ = _build.library()
    err = lib.k2_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.view(torch.uint8).data_ptr(),
        out.data_ptr(), b, h, kvh, lq, lk, d, *q.stride()[:3], *out.stride()[:3],
        int(q_pos0), float(scale), _build.stream_ptr(q.device),
    )
    _build.check(err, "k2_flash_attention")
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
