"""Kernels K1 (W4A16), K8 (W8A16) and K9 (W4A16 over the flat packed
layout): matmul over the port's quantized layouts.

K1 replaces ``phi_3_vision_mlx_tpu/ops/kernels/quant_matmul.py:quant_matmul_tiled``
and ``quant_matmul_tiled_stacked``; K8 replaces ``quant_matmul_interleaved``;
K9 replaces ``quant_matmul_packed`` and ``quant_matmul_packed_stacked`` (K10).
All are one CUDA source, ``csrc/quant_matmul.cu``.  A stacked weight's layer
is a zero-copy ``w[layer]`` view, so one wrapper covers both variants of a
layout.

All three run on the tensor cores (route B); K1 and K8 at one row (decode)
run a GEMV on the CUDA cores instead (route A, :func:`route`), the crossover
measured on the H100 (PERF.md section 6).  :func:`plan` sizes the K split of
each on its route.

K8 computes the function the JAX package means, the XLA path
(``ops/quant.py:quantized_matmul``) on unsigned 8-bit levels 0..255; the TPU
kernel's signed int8 payload turns levels >= 128 into ``q - 256``.

An fp32 model's f32 x runs each kernel's ``_f32`` entry (f32 output): the
XLA path's function in f32 (W dequantized in f32 and never rounded, f32
products and sums), not the TPU kernels', which cast x to bf16 first.  Route
A stays the GEMV; route B runs on the tensor cores in 3xTF32 (each f32
operand split into tf32 hi + lo; PERF.md section 6).
``<wrapper>.fp32.launches`` counts the fp32 entries' launches among the
wrapper's own.

Each wrapper (:func:`quant_matmul`, :func:`quant_matmul_w8`,
:func:`quant_matmul_packed`) launches its kernel for CUDA tensors and runs
its plain PyTorch version (``*_plain``) only for CPU tensors; a CUDA tensor
a kernel does not take raises.  ``<wrapper>.launches`` counts kernel
launches.

The autograd seam: a kernel hands raw pointers to the built library, so its
output has no ``grad_fn``.  :class:`QuantMatmulFn` (K1),
:class:`QuantMatmulW8Fn` (K8) and :class:`QuantMatmulPackedFn` (K9) run
their wrapper as the forward (the kernel on the card, the plain version on
the CPU) and give ``dx = dy @ dequantize(W)^T`` as the backward;
:class:`DequantMatmulFn` is the same for ``ops/linear.py:dense``'s
dequantize-then-matmul route above 256 rows, whose forward keeps no
dequantized copy of W.  The frozen payload, scales and biases take no
gradient.  The JAX package leaves this backward to XLA, so it is plain
PyTorch: W dequantized again to the activation dtype and one
``torch.matmul`` (float32 accumulation; cuBLAS accumulates bf16 products in
float32), the dequantization under the profiler range
``"seam.dequantize"``.  A kernel that fails under the seam raises.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ...core.weights import (WORD, WORD8, from_packed_layout, packable, packed_block_k,
                             unpack_int4, unpack_int8)
from ..quant import QTensor, dequantize
from . import _build

GROUP = 64

_A_TARGET_BLOCKS = 1056  # route A: eight blocks per SM
_A_COLUMNS = 128  # route A: output columns per block, 32 lanes x 4
_A_MAX_GROUPS = 64  # route A: groups per split (x staged as f32 in 16 KB)
_A_WARPS = 4  # route A: a block's warps split its groups: keep their shares even
_A_MAX_SPLITS = 32  # the second pass adds at most this many partial sums per output
_B_COLUMNS = 128  # route B: output columns per block
_B_TARGET_BLOCKS = 792  # route B: six blocks per SM
_B_MIN_GROUPS = 4  # route B: groups per split, so the cp.async ring has work to overlap


def _plain(unpack, x, qweight, scales, biases, out_dtype):
    """``x @ W`` with ``W = dequantize(...)`` rounded to ``x.dtype`` and the
    product accumulated in float32 (``ops/quant.py:quantized_matmul``)."""
    w = dequantize(QTensor(unpack(qweight), scales, biases), dtype=x.dtype)
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


def quant_matmul_plain(x, qweight, scales, biases=None, out_dtype=None):
    """K1's plain version: qweight (K/8, N) int32 of 4-bit levels."""
    return _plain(unpack_int4, x, qweight, scales, biases, out_dtype)


def quant_matmul_w8_plain(x, qweight, scales, biases, out_dtype=None):
    """K8's plain version: qweight (K/4, N) int32 of unsigned 8-bit levels."""
    return _plain(unpack_int8, x, qweight, scales, biases, out_dtype)


def route(m: int, layout: str) -> str:
    """The route of K1 (``layout="k1"``), K8 (``"k8"``) or K9 (``"k9"``) for
    ``m`` rows, as ``csrc/quant_matmul.cu:launch_route`` takes it: ``"a"``
    (the CUDA-core GEMV) for K1 and K8 at one row, else ``"b"`` (tensor
    cores).  On the H100 route A lost to route B from two rows on, and a
    GEMV over K9's packed rows at every M."""
    return "a" if layout in ("k1", "k8") and m == 1 else "b"


@functools.lru_cache(maxsize=256)
def plan(m: int, k: int, n: int, layout: str) -> tuple[int, int]:
    """(splits, groups per split) of K1 (``layout="k1"``), K8 (``"k8"``) or
    K9 (``"k9"``) on its :func:`route`."""
    return route_plan(route(m, layout), m, k, n)


def route_plan(rt: str, m: int, k: int, n: int, b_target: int = _B_TARGET_BLOCKS) -> tuple[int, int]:
    """(splits, groups per split) of a quantized matmul on route ``rt`` (K1,
    K8, K9 and E1 share the routes' blocks): about ``b_target`` blocks on
    route B and ``_A_TARGET_BLOCKS`` on route A, to fill the card; on route
    A, each split's groups a multiple of the block's warps and its staged x
    within 16 KB (E1 stages x8 in 4 KB under the same limit)."""
    groups = k // GROUP
    if rt == "a":
        per = -(-groups // max(1, -(-_A_TARGET_BLOCKS // -(-n // _A_COLUMNS))))
        per = max(per, -(-groups // _A_MAX_SPLITS))
        per = min(-(-per // _A_WARPS) * _A_WARPS, _A_MAX_GROUPS)
    else:
        rows = 16 if m <= 16 else 32 if m <= 32 else 64
        tiles = -(-n // _B_COLUMNS) * -(-m // rows)
        per = max(_B_MIN_GROUPS, -(-groups // max(1, -(-b_target // tiles))))
    per = max(1, min(per, groups))
    return -(-groups // per), per


def _check_shapes(name, x, payload, k_rows, n, scales):
    """``x`` (M, K) against a 2-D payload of ``k_rows`` rows for K and
    ``scales`` of N = ``n`` columns."""
    if x.dim() != 2 or payload.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and the payload {tuple(payload.shape)} must be 2-D")
    if k_rows != x.shape[1] or scales.shape[-1] != n:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, payload {tuple(payload.shape)}, "
                         f"scales {tuple(scales.shape)} do not match")


def _check_cuda(name, x, payload, payload_dtype, scales, biases, out_dtype, n):
    """Device, dtype, group and layout checks before a launch."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    check_kernel_inputs(name, x, payload, payload_dtype, scales, biases, out_dtype, n)


def check_kernel_inputs(name, x, payload, payload_dtype, scales, biases, out_dtype, n):
    """The checks of :func:`_check_cuda` past the device: one device, the
    dtypes (bf16 x with bf16 or f32 output, or f32 x with f32 output; never
    a mix), the group and contiguity."""
    k = x.shape[1]
    tensors = [x, payload, scales] + ([] if biases is None else [biases])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if not ((x.dtype == torch.bfloat16 and out_dtype in (torch.bfloat16, torch.float32))
            or (x.dtype == torch.float32 and out_dtype == torch.float32)):
        raise TypeError(f"{name} kernel takes bf16 x with bf16/f32 output or f32 x with f32 "
                        f"output, got {x.dtype} -> {out_dtype}")
    if payload.dtype != payload_dtype or scales.dtype != torch.bfloat16 or (
        biases is not None and biases.dtype != torch.bfloat16
    ):
        raise TypeError(f"{name} kernel takes a {payload_dtype} payload and bf16 scales/biases")
    if k % GROUP or scales.shape != (k // GROUP, n) or (
        biases is not None and biases.shape != scales.shape
    ):
        raise ValueError(f"{name} kernel needs group {GROUP}: K={k}, scales "
                         f"{tuple(scales.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous tensors")


def _check_aligned(name, *tensors):
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} kernel needs 16-byte aligned x, payload, scales and biases")


def _launch(wrapper, entry, layout, x, payload, scales, biases, out_dtype, n, *extra):
    """Launch the C entry ``entry`` (its ``_f32`` one for f32 x) on
    :func:`plan`'s K split for ``layout``, f32 partial sums in a scratch
    tensor only for more than one split (one split writes the output
    itself), and count the launch on ``wrapper``."""
    m, k = x.shape
    splits, per = plan(m, k, n, layout)
    entry = _build.entry_of(entry, x.dtype)
    lib, _ = _build.library()
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else None
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = getattr(lib, entry)(
        x.data_ptr(), payload.data_ptr(), scales.data_ptr(),
        None if biases is None else biases.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(), m, k, n, *extra,
        splits, per, int(out_dtype == torch.float32), _build.stream_ptr(x.device),
    )
    _build.check(err, entry)
    _build.count(wrapper, x.dtype)
    return out


def quant_matmul(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    biases: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """K1: y (M, N) = x (M, K) @ W; qweight (K/8, N) int32, scales/biases
    (K/64, N) bf16 (biases None in symmetric mode)."""
    name = "quant_matmul"
    out_dtype = out_dtype or x.dtype
    n = qweight.shape[-1]
    _check_shapes(name, x, qweight, qweight.shape[0] * WORD, n, scales)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qweight, scales, biases, out_dtype)
    _check_cuda(name, x, qweight, torch.int32, scales, biases, out_dtype, n)
    if n % 8:
        raise ValueError(f"{name} kernel needs N a multiple of 8, got {n}")
    _check_aligned(name, x, qweight, scales, biases)
    return _launch(quant_matmul, "k1_w4a16_matmul", "k1", x, qweight, scales, biases, out_dtype, n)


def quant_matmul_w8(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """K8: y (M, N) = x (M, K) @ W; qweight (K/4, N) int32 of unsigned 8-bit
    levels, scales/biases (K/64, N) bf16 (affine only: symmetric mode is
    4-bit only, as in ``ops/quant.py``)."""
    name = "quant_matmul_w8"
    if biases is None:
        raise ValueError(f"{name}: 8-bit weights are affine and need biases")
    out_dtype = out_dtype or x.dtype
    n = qweight.shape[-1]
    _check_shapes(name, x, qweight, qweight.shape[0] * WORD8, n, scales)
    if x.device.type == "cpu":
        return quant_matmul_w8_plain(x, qweight, scales, biases, out_dtype)
    _check_cuda(name, x, qweight, torch.int32, scales, biases, out_dtype, n)
    if n % 8:
        raise ValueError(f"{name} kernel needs N a multiple of 8, got {n}")
    _check_aligned(name, x, qweight, scales, biases)
    return _launch(quant_matmul_w8, "k8_w8a16_matmul", "k8", x, qweight, scales, biases, out_dtype, n)


def quant_matmul_packed_plain(x, weight, scales, biases, out_dtype=None):
    """K9's plain version: unpack and unpermute the packed payload, then
    K1's function."""
    group = weight.shape[-2] // scales.shape[-2]
    return _plain(lambda w: from_packed_layout(w, group), x, weight, scales, biases, out_dtype)


def quant_matmul_packed(
    x: torch.Tensor,
    weight: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """K9: y (M, N) = x (M, K) @ W; weight (K, N/2) uint8 in the flat packed
    layout (``core/weights.py:to_packed_layout``), scales/biases (K/64, N)
    bf16 (affine only: the JAX kernel reads ``biases``).  A stacked leaf's
    ``w[layer]`` view is K10."""
    name = "quant_matmul_packed"
    out_dtype = out_dtype or x.dtype
    if biases is None:
        raise ValueError(f"{name}: the packed layout is affine and needs biases")
    n = 2 * weight.shape[-1]
    _check_shapes(name, x, weight, weight.shape[0], n, scales)
    if x.device.type == "cpu":
        return quant_matmul_packed_plain(x, weight, scales, biases, out_dtype)
    _check_cuda(name, x, weight, torch.uint8, scales, biases, out_dtype, n)
    k = x.shape[1]
    if not packable(k, n, GROUP):
        raise ValueError(f"{name}: K={k}, N={n} do not fit the packed layout's blocks")
    _check_aligned(name, x, weight, scales, biases)
    return _launch(quant_matmul_packed, "k9_w4a16_packed_matmul", "k9", x, weight, scales, biases,
                   out_dtype, n, packed_block_k(k))


for _wrapper in (quant_matmul, quant_matmul_w8, quant_matmul_packed):
    _wrapper.launches = 0
    _wrapper.fp32 = _build.Launches()
del _wrapper


# -- the autograd seam --------------------------------------------------------


def _save(ctx, x, payload, scales, biases, unpack) -> None:
    ctx.save_for_backward(payload, scales, biases)
    ctx.unpack, ctx.x_dtype = unpack, x.dtype


def _seam_backward(ctx, dy):
    """dx = dy @ W^T with W dequantized again to the activation dtype; no
    gradient for the payload, scales, biases or the static arguments."""
    payload, scales, biases = ctx.saved_tensors
    with torch.profiler.record_function("seam.dequantize"):
        w = dequantize(QTensor(ctx.unpack(payload), scales, biases), dtype=ctx.x_dtype)
    return torch.matmul(dy.to(ctx.x_dtype), w.t()), None, None, None, None


def packed_unpack(weight: torch.Tensor, scales: torch.Tensor):
    """The packed layout's payload -> its (K, N) levels (group from the
    scales' rows)."""
    return functools.partial(from_packed_layout, group=weight.shape[-2] // scales.shape[-2])


class QuantMatmulFn(torch.autograd.Function):
    """K1 (:func:`quant_matmul`) under autograd: ``apply(x (M, K), qweight,
    scales, biases, out_dtype)``."""

    @staticmethod
    def forward(ctx, x, qweight, scales, biases, out_dtype):
        _save(ctx, x, qweight, scales, biases, unpack_int4)
        return quant_matmul(x, qweight, scales, biases, out_dtype=out_dtype)

    backward = staticmethod(_seam_backward)


class QuantMatmulW8Fn(torch.autograd.Function):
    """K8 (:func:`quant_matmul_w8`) under autograd."""

    @staticmethod
    def forward(ctx, x, qweight, scales, biases, out_dtype):
        _save(ctx, x, qweight, scales, biases, unpack_int8)
        return quant_matmul_w8(x, qweight, scales, biases, out_dtype=out_dtype)

    backward = staticmethod(_seam_backward)


class QuantMatmulPackedFn(torch.autograd.Function):
    """K9 (:func:`quant_matmul_packed`) under autograd."""

    @staticmethod
    def forward(ctx, x, weight, scales, biases, out_dtype):
        _save(ctx, x, weight, scales, biases, packed_unpack(weight, scales))
        return quant_matmul_packed(x, weight, scales, biases, out_dtype=out_dtype)

    backward = staticmethod(_seam_backward)


class DequantMatmulFn(torch.autograd.Function):
    """``x (..., K) @ dequantize(W)`` in ``x.dtype``, the route above 256
    rows: ``apply(x, payload, scales, biases, unpack)``, ``unpack`` the
    payload's (K, N) levels.  The backward dequantizes again."""

    @staticmethod
    def forward(ctx, x, payload, scales, biases, unpack):
        _save(ctx, x, payload, scales, biases, unpack)
        return torch.matmul(x, dequantize(QTensor(unpack(payload), scales, biases), dtype=x.dtype))

    backward = staticmethod(_seam_backward)
