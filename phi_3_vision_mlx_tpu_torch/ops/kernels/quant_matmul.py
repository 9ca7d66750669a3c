"""Kernel K1: W4A16 matmul over the port's packed 4-bit layout.

Replaces ``phi_3_vision_mlx_tpu/ops/kernels/quant_matmul.py:quant_matmul_tiled``
and ``quant_matmul_tiled_stacked``; the CUDA source is ``csrc/quant_matmul.cu``.
A stacked weight's layer is a zero-copy ``w[layer]`` view, so one wrapper
covers both.

:func:`quant_matmul` launches the kernel for CUDA tensors and runs the plain
PyTorch version :func:`quant_matmul_plain` only for CPU tensors; a CUDA
tensor the kernel does not take raises.  ``quant_matmul.launches`` counts
kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.weights import WORD, unpack_int4
from ..quant import QTensor, dequantize
from . import _build

GROUP = 64
_TARGET_BLOCKS = 528  # four waves of blocks over the H100's 132 SMs
_THREADS = 128  # output columns per block (csrc/quant_matmul.cu kThreads)


def quant_matmul_plain(x, qweight, scales, biases=None, out_dtype=None):
    """``x @ W`` with ``W = dequantize(...)`` rounded to ``x.dtype`` and the
    product accumulated in float32 (``ops/quant.py:quantized_matmul``)."""
    w = dequantize(QTensor(unpack_int4(qweight), scales, biases), dtype=x.dtype)
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


def _splits(m: int, k: int, n: int) -> tuple[int, int]:
    """K splits so the grid holds about ``_TARGET_BLOCKS`` blocks."""
    groups = k // GROUP
    bm = 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8
    base = -(-n // _THREADS) * -(-m // bm)
    want = max(1, min(groups, -(-_TARGET_BLOCKS // base)))
    per = -(-groups // want)
    return -(-groups // per), per


def quant_matmul(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    biases: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """y (M, N) = x (M, K) @ W; qweight (K/8, N) int32, scales/biases
    (K/64, N) bf16 (biases None in symmetric mode)."""
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or qweight.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and qweight {tuple(qweight.shape)} must be 2-D")
    m, k = x.shape
    n = qweight.shape[1]
    if qweight.shape[0] * WORD != k or scales.shape[-1] != n:
        raise ValueError(f"shapes x {tuple(x.shape)}, qweight {tuple(qweight.shape)}, "
                         f"scales {tuple(scales.shape)} do not match")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qweight, scales, biases, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"quant_matmul: no kernel for device {x.device}")
    tensors = [x, qweight, scales] + ([] if biases is None else [biases])
    if any(t.device != x.device for t in tensors):
        raise ValueError("quant_matmul: all tensors must be on one device")
    if x.dtype != torch.bfloat16 or out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant_matmul kernel takes bf16 x and bf16/f32 output, got "
                        f"{x.dtype} -> {out_dtype}")
    if qweight.dtype != torch.int32 or scales.dtype != torch.bfloat16 or (
        biases is not None and biases.dtype != torch.bfloat16
    ):
        raise TypeError("quant_matmul kernel takes int32 qweight and bf16 scales/biases")
    if k % GROUP or scales.shape != (k // GROUP, n) or (
        biases is not None and biases.shape != scales.shape
    ):
        raise ValueError(f"quant_matmul kernel needs group {GROUP}: K={k}, scales "
                         f"{tuple(scales.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("quant_matmul kernel needs contiguous tensors")
    lib, _ = _build.library()
    splits, per = _splits(m, k, n)
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = lib.k1_w4a16_matmul(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
        None if biases is None else biases.data_ptr(),
        partial.data_ptr(), out.data_ptr(), m, k, n, splits, per,
        int(out_dtype == torch.float32), _build.stream_ptr(x.device),
    )
    _build.check(err, "k1_w4a16_matmul")
    _build.count_launch(quant_matmul)
    return out


quant_matmul.launches = 0
