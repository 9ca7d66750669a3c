"""Kernel E1: the W4A8 experiment's matmul (int8 activations, 4-bit weights).

Replaces ``experiments/w4a8_bench.py:w4a8_matmul``, a TPU kernel that no
served path runs; the port's entry point is
``phi_3_vision_mlx_tpu_torch/experiments/w4a8_bench.py``.  CUDA source
``csrc/w4a8_matmul.cu`` (``e1_w4a8_matmul``).

    y[m, n] = sx[m] * sum_g s[g, n] * (x8[m, g] . (q[g, n] - 8))

The activation prologue, :func:`quantize_activations`, is plain PyTorch, as
the JAX script leaves it to XLA, in the JAX order: ``sx = max|x| / 127`` in
``x``'s dtype (bf16 x rounds it to bf16 there), 0 becomes 1, then ``x8 =
clip(round(x / sx), -127, 127)`` in f32, half to even.  The weight is K1's
symmetric layout (``(K/8, N)`` int32 words, bf16 ``(K/64, N)`` scales), so
an A/B against K1 reads the same bytes.

Two routes, as K1's (:func:`route`; no argument forces one): route A at one
row, a ``dp4a`` GEMV on the CUDA cores; route B from two rows on, the int8
tensor cores (``mma.sync.m16n8k32``).  :func:`plan` sizes the K split of
each on K1's blocks (``quant_matmul.route_plan``), route B with fewer
splits.

:func:`w4a8_matmul` launches the kernel for CUDA tensors and runs the plain
version :func:`w4a8_matmul_plain` only for CPU tensors;
``w4a8_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools

import torch

from ...core.weights import WORD, unpack_int4
from ..quant import SYMMETRIC_MID
from . import _build
from .quant_matmul import GROUP, route_plan


# Route B: blocks to aim for, two an SM.  Fewer splits than K1's six an SM
# (``quant_matmul._B_TARGET_BLOCKS``): E1's f32 partial sums are as large as
# its output, and on the H100 two an SM took the least time over M = 2-256
# of 264, 396, 528 and 792 blocks (PERF.md section 6, E1).
_B_TARGET_BLOCKS = 264


def route(m: int) -> str:
    """E1's route for ``m`` rows, as ``csrc/w4a8_matmul.cu:e1_w4a8_matmul``
    takes it: ``"a"`` (the ``dp4a`` GEMV) at one row, else ``"b"`` (int8
    tensor cores)."""
    return "a" if m == 1 else "b"


@functools.lru_cache(maxsize=256)
def plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(splits, groups per split) of E1 on its :func:`route`."""
    return route_plan(route(m), m, k, n, b_target=_B_TARGET_BLOCKS)


def quantize_activations(x: torch.Tensor):
    """x (M, K) -> (x8 (M, K) int8, sx (M,) f32): per-row absmax int8."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    sx = (amax.float() / 127.0).to(x.dtype).float()
    sx = torch.where(sx == 0, torch.ones_like(sx), sx)
    x8 = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    return x8, sx.reshape(-1)


def w4a8_matmul_plain(x8, sx, qweight, scales):
    """E1's plain version: each group's int8 product exact (integers below
    2**24 in f32), then ``acc + part * s`` over the groups in order, then
    ``* sx``.  Returns (M, N) f32."""
    m, k = x8.shape
    n = qweight.shape[-1]
    groups = k // GROUP
    w = (unpack_int4(qweight).float() - SYMMETRIC_MID).reshape(groups, GROUP, n)
    parts = torch.matmul(x8.float().reshape(m, groups, GROUP).transpose(0, 1), w)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x8.device)
    for g in range(groups):
        acc = acc + parts[g] * scales[g].float()
    return acc * sx[:, None]


def w4a8_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """E1: x (M, K) -> y (M, N) f32; qweight (K/8, N) int32 of 4-bit levels
    (symmetric, zero point 8), scales (K/64, N) bf16."""
    if x.dim() != 2 or qweight.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and qweight {tuple(qweight.shape)} must be 2-D")
    m, k = x.shape
    n = qweight.shape[1]
    if qweight.shape[0] * WORD != k or k % GROUP or scales.shape != (k // GROUP, n):
        raise ValueError(f"w4a8_matmul: shapes x {tuple(x.shape)}, qweight {tuple(qweight.shape)}, "
                         f"scales {tuple(scales.shape)} do not match (group {GROUP})")
    x8, sx = quantize_activations(x)
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x8, sx, qweight, scales)
    if x.device.type != "cuda":
        raise RuntimeError(f"w4a8_matmul: no kernel for device {x.device}")
    if qweight.device != x.device or scales.device != x.device:
        raise ValueError("w4a8_matmul: all tensors must be on one device")
    if qweight.dtype != torch.int32 or scales.dtype != torch.bfloat16:
        raise TypeError("w4a8_matmul kernel takes int32 qweight and bf16 scales")
    if not (qweight.is_contiguous() and scales.is_contiguous()):
        raise ValueError("w4a8_matmul kernel needs contiguous tensors")
    if n % 8 or any(t.data_ptr() % 16 for t in (x8, qweight, scales)):
        raise ValueError(f"w4a8_matmul kernel needs N a multiple of 8 (got {n}) and 16-byte aligned tensors")
    lib, _ = _build.library()
    splits, per = plan(m, k, n)
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else None
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = lib.e1_w4a8_matmul(
        x8.data_ptr(), sx.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(), m, k, n, splits, per,
        _build.stream_ptr(x.device),
    )
    _build.check(err, "e1_w4a8_matmul")
    _build.count_launch(w4a8_matmul)
    return out


w4a8_matmul.launches = 0
