"""Kernels K3-K7: attention over the stacked KV cache or page pool, read in place.

Each takes the whole ``(layers, ...)`` cache and a layer index, so a layer is
read with no per-layer copy.  Query ``i`` sits at position ``offset + i``
(``q_pos0 + i``) and sees key ``j`` iff ``j <= offset + i`` and
``valid[b, j]``.  The decode kernels (K3, K4, K6, K7) take at most 16 query
rows and a ``row0``: query ``i`` of a launch then sits at ``offset + row0 +
i``, so a verify pass of more rows runs as launches on groups of 16
(:func:`by_row_groups`).  Queries and outputs are in the original D order.

* K3 :func:`dense_kv_attention` — decode (Lq <= 16) over the dense bf16
  (or, for an fp32 model, fp32) cache ``(layers, B, KV, Lmax, D)``, the
  window split into runs of ``K3_SPLIT_KEYS`` keys
  (:func:`dense_kv_split_plan`, the window only), one block each, merged by
  a second kernel; ``dense_kv_attention.fp32.launches`` counts the fp32
  kernels' launches among its own.  Replaces
  ``phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:dense_kv_attention``;
  CUDA source ``csrc/attention.cu`` (``k3_dense_kv_attention``).
* K4 :func:`quantized_kv_attention` — decode (Lq <= 16) over the int4 cache
  (payload ``(layers, B, KV, Lmax, D)`` uint8 ``k | v << 4``, scales
  ``(layers, B, KV, Lmax, 4G)`` bf16; ``engine/state.py``) on K7's split-run
  kernels (``csrc/split_runs.cuh``) behind the stacked cache's window:
  blocks of ``block_keys`` keys (:func:`quantized_split_plan`), each walking
  its 64-key runs, one block per (block, head, batch row) for all of the
  row's query rows, merged by a second kernel.  Replaces
  ``kv_attention.py:quantized_kv_attention``; CUDA source
  ``csrc/quant_kv_attention.cu`` (``k4_quantized_kv_attention``).
* E2/E3 :func:`quantized_kv_attention_variant` — K4 with another
  dequantization (``VARIANT_MODES``), the kernels of the experiments
  ``experiments/qkv_probe.py:probe_attention`` and
  ``experiments/qdecode_sweep.py:qkv_attn``; same CUDA source
  (``e23_quantized_kv_attention_variant``, K4's kernels with a
  compile-time mode).  Reached by the port's ``experiments/`` entry points
  only.
* K5 :func:`quantized_flash_attention` — prefill and extend chunks of any
  length over the int4 cache: K2's tensor-core flash body
  (``csrc/flash_mma.cuh``) with a loader that dequantizes each 64-key tile
  once per block.  Replaces ``kv_attention.py:quantized_flash_attention``;
  CUDA source ``csrc/quant_kv_attention.cu``
  (``k5_quantized_flash_attention``).
* K6 :func:`paged_kv_attention` — decode (Lq <= 16) of every slot of the
  paged engine through its page table over the dense page pool
  ``(layers, P + 1, KV, page, D)`` (``engine/paging.py``), on the same
  split-run kernels behind the page tables' window: runs of
  ``PAGED_RUN_KEYS`` keys (:func:`paged_split_plan`), one block per (run,
  head, slot) for all of a slot's query rows, merged by a second kernel.
  Replaces ``kv_attention.py:paged_kv_attention``; CUDA source
  ``csrc/paged_kv_attention.cu`` (``k6_paged_kv_attention``).
* K7 :func:`paged_quantized_kv_attention` — K6 over the int4 page pool
  (payload ``(layers, P + 1, KV, page, D)`` uint8, scales ``(..., 4G)``):
  the same kernels behind another loader.  Replaces
  ``kv_attention.py:paged_quantized_kv_attention``; same source
  (``k7_paged_quantized_kv_attention``).

K3 and K4 take the offset on the device, a ``(1,)`` int32 tensor (the
decode state's ``pos``; on the CPU their plain versions also take a host
int); their plans depend on the window only, so a captured launch replays at any offset
(``engine/graphs.py``), and the host checks the offset on its mirror.  K6
and K7 take per-slot offsets ``(S,)`` on the device and apply the
fresh-region rule: query ``i`` of slot ``s`` sees key ``j`` iff ``j <=
offsets[s] + i`` and (``valid[s, j]`` or ``j >= offsets[s]``) — the keys
from the offset on are the step's own, whose validity bits commit after it.

The JAX package permutes the head dim of its quantized cache and of the
queries for the TPU's lane tiling; the port does not.  Each wrapper launches
its kernel for CUDA tensors and runs its plain version (``*_plain``: the
window dequantized to ``q.dtype``, then ``ops/attention.py``) only for CPU
tensors; ``<wrapper>.launches`` counts kernel launches.  The kernels
dequantize to the same bits as the plain version (f32 ``q * s``, then
``+ b``, one rounding to bf16).

An fp32 model's f32 query runs each kernel's ``_f32`` entry, which returns
f32: the JAX XLA path's function in f32 (keys and values dequantized in f32
and never rounded, f32 products and softmax), not the TPU kernels', which
cast the query to bf16.  K4, K6 and K7 in fp32 run the split-run plan and
combine with both products on the tensor cores in 3xTF32 (each f32 operand
split into tf32 hi + lo); K5 in fp32 runs fp32 K2's 3xTF32 flash body; K6
in fp32 reads an f32 page pool.
``<wrapper>.fp32.launches`` counts the fp32 entries' launches among the
wrapper's own (K3's too).
"""

from __future__ import annotations

import torch

from ...engine.state import dequantize_kv
from ..attention import decode_attention, masked_attention
from . import _build
from .flash_attention import (CACHE_HEAD_DIMS, DTYPES, check_attention_inputs, flash_attention_plain,
                              head_major_empty)

KV_GROUP = 32  # the kernels' quantization group along D
# K3: keys per block of the split window.  A block requests its run's K and
# V (24 KB at 64 keys, D = 96) at once, and eight such blocks fit an SM's
# shared memory: at B = 1 and 32 heads that is 12 x 32 = 384 blocks at the
# main path's 768-key window and 68 x 32 = 2176 at 4352, two rounds of the
# card's 1056 slots.  On the H100 (NVIDIA H100 80GB HBM3, 700 W) 64-key runs
# beat 128 and 256 at both 640 and 4224 keys (PERF.md, Findings).
K3_SPLIT_KEYS = 64
K3_MAX_ROWS = 16  # K3: query rows per (batch, head), the decode chunk's limit
# K4, K6, K7: keys per run of the split window (the kernels' kRunKeys): one
# page at the served page of 64, so a run reads one contiguous block of the
# pool.  A block walks one or more consecutive runs.
RUN_KEYS = 64
# K4: keys per block (a multiple of RUN_KEYS) by window, (largest window,
# keys), first match.  Timed on the H100 (NVIDIA H100 80GB HBM3, 700 W) at
# 64-1024 keys a block, Lq = 1 (experiments/k4_ab.py --kernels K4S; PERF.md,
# Findings): one run a block is fastest up to 768 keys, two at 2048, four
# at 4224 and 4352, where fewer blocks mean fewer partials to merge.
K4_BLOCK_KEYS = ((1024, 64), (2048, 128), (1 << 31, 256))
PAGED_RUN_KEYS = RUN_KEYS  # K6/K7: one run a block
MAX_PAGED_ROWS = 16  # K4, K6, K7: query rows per block (decode and speculation)
assert K3_MAX_ROWS == MAX_PAGED_ROWS  # by_row_groups groups rows for all four


def query_positions(offset, lq: int, device, row0: int = 0) -> torch.Tensor:
    """(Lq,) positions ``offset + row0 + i`` of a launch's query rows;
    ``offset`` a host int or the (1,) device offset (no host sync)."""
    return offset + row0 + torch.arange(lq, device=device)


def by_row_groups(attention, q, *args):
    """``attention(q, *args)`` for a decode kernel (K3, K4, K6, K7) at any
    number of query rows: more than the kernels' 16 run as launches on
    groups of 16 rows, each with its ``row0``, the outputs concatenated.
    Every ``row0`` is a host constant of the shape, so a captured pass stays
    one graph with no branch and no host sync."""
    rows = MAX_PAGED_ROWS  # == K3_MAX_ROWS
    lq = q.shape[2]
    if lq <= rows:
        return attention(q, *args)
    return torch.cat([attention(q[:, :, r : r + rows], *args, row0=r) for r in range(0, lq, rows)],
                     dim=2)


def check_device_offset(offset, device, name: str) -> None:
    """K3 and K4 read the offset on the device: a (1,) int32 tensor on
    ``device`` (its caller checks the host mirror).  Only the plain versions
    also take a host int."""
    if (not isinstance(offset, torch.Tensor) or offset.shape != (1,)
            or offset.dtype != torch.int32 or offset.device != device):
        got = (f"{tuple(offset.shape)} {offset.dtype} on {offset.device}"
               if isinstance(offset, torch.Tensor) else type(offset).__name__)
        raise ValueError(f"{name}: the offset must be a (1,) int32 tensor on {device}, got {got}")


def dense_kv_attention_plain(q, k_stack, v_stack, valid, offset, layer_idx: int, scale: float,
                             row0: int = 0):
    q_pos = query_positions(offset, q.shape[2], q.device, row0)
    return decode_attention(q, k_stack[layer_idx], v_stack[layer_idx], valid, q_pos, scale)


def dense_kv_split_plan(lmax: int) -> tuple[int, int]:
    """K3's split of the window: ``(n_split, split_keys)``.  Split ``s``
    reads keys ``[s * split_keys, min((s + 1) * split_keys, kend))``, with
    ``kend = min(lmax, offset + lq)``: every key some query row can see, in
    exactly one split.  The plan depends on the window only, never on the
    offset (a captured launch replays for any offset); a split at or past
    ``kend`` reads nothing and writes an empty partial (max NEG_INF, sum
    0), which the merge weighs 0."""
    return -(-lmax // K3_SPLIT_KEYS), K3_SPLIT_KEYS


def dense_kv_attention(q, k_stack, v_stack, valid, offset, layer_idx: int, scale: float,
                       row0: int = 0):
    """q (B, H, Lq, D); k_stack/v_stack (layers, B, KV, Lmax, D); valid
    (B, Lmax) bool; offset: the (1,) int32 device offset (on the CPU, where
    the plain version runs, a host int too); query ``i`` at ``offset + row0
    + i``.  Returns (B, H, Lq, D)."""
    if q.device.type == "cpu":
        return dense_kv_attention_plain(q, k_stack, v_stack, valid, offset, layer_idx, scale, row0)
    if q.device.type != "cuda":
        raise RuntimeError(f"dense_kv_attention: no kernel for device {q.device}")
    if k_stack.dim() != 5 or not 0 <= layer_idx < k_stack.shape[0]:
        raise ValueError(f"dense_kv_attention: cache {tuple(k_stack.shape)}, layer {layer_idx}")
    check_attention_inputs(q, k_stack, v_stack, valid, "dense_kv_attention")
    b, h, lq, d = q.shape
    if not 1 <= lq <= K3_MAX_ROWS or row0 < 0:
        raise ValueError(f"dense_kv_attention: {lq} query rows from row {row0} (the kernel takes "
                         f"1-{K3_MAX_ROWS} from a row >= 0)")
    check_device_offset(offset, q.device, "dense_kv_attention")
    kvh, lmax = k_stack.shape[2], k_stack.shape[3]
    n_split, split_keys = dense_kv_split_plan(lmax)
    out = head_major_empty(q)
    # Per split: (max score, sum of exp, unnormalized output) of each query row.
    partial = torch.empty((n_split, b * h * lq, d + 2), dtype=torch.float32, device=q.device)
    entry = _build.entry_of("k3_dense_kv_attention", q.dtype)
    lib, _ = _build.library()
    err = getattr(lib, entry)(
        q.data_ptr(), k_stack.data_ptr(), v_stack.data_ptr(),
        valid.view(torch.uint8).data_ptr(), out.data_ptr(), partial.data_ptr(), b, h, kvh, lq,
        lmax, d, *q.stride()[:3], *out.stride()[:3], int(layer_idx), offset.data_ptr(), int(row0),
        float(scale), n_split, split_keys, _build.stream_ptr(q.device),
    )
    _build.check(err, entry)
    _build.count(dense_kv_attention, q.dtype)
    return out


dense_kv_attention.launches = 0
dense_kv_attention.fp32 = _build.Launches()


def quantized_kv_attention_plain(q, payload, scales, valid, offset, layer_idx: int, scale: float,
                                 row0: int = 0):
    k, v = dequantize_kv(payload[layer_idx], scales[layer_idx], q.dtype, bits=4)
    q_pos = query_positions(offset, q.shape[2], q.device, row0)
    return decode_attention(q, k, v, valid, q_pos, scale)


def quantized_flash_attention_plain(q, payload, scales, valid, q_pos0: int, layer_idx: int, scale: float):
    k, v = dequantize_kv(payload[layer_idx], scales[layer_idx], q.dtype, bits=4)
    return flash_attention_plain(q, k, v, valid, q_pos0, scale)


def check_quantized_inputs(q, payload, scales, valid, layer_idx: int, name: str) -> None:
    """Device, dtype, shape, layout and alignment checks shared by K4 and K5."""
    b, h, _, d = q.shape
    if any(t.device != q.device for t in (payload, scales, valid)):
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dtype not in DTYPES or payload.dtype != torch.uint8 or scales.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 or fp32 q, a uint8 payload and bf16 scales, "
                        f"got {q.dtype}/{payload.dtype}/{scales.dtype}")
    if valid.dtype != torch.bool or not valid.is_contiguous():
        raise TypeError(f"{name}: valid must be a contiguous bool tensor")
    if payload.dim() != 5 or not 0 <= layer_idx < payload.shape[0]:
        raise ValueError(f"{name}: cache {tuple(payload.shape)}, layer {layer_idx}")
    nl, pb, kvh, lmax, width = payload.shape
    if d not in CACHE_HEAD_DIMS or width != d or scales.shape != (nl, pb, kvh, lmax, 4 * (d // KV_GROUP)):
        raise ValueError(f"{name}: head dim {d}, int4 payload {tuple(payload.shape)} and scales "
                         f"{tuple(scales.shape)} (group {KV_GROUP}) do not match")
    if h % kvh or pb != b or valid.shape != (b, lmax):
        raise ValueError(f"{name}: q {tuple(q.shape)}, cache {tuple(payload.shape)}, "
                         f"valid {tuple(valid.shape)} do not match")
    if q.stride(-1) != 1 or not (payload.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{name}: q needs unit stride along D and the cache must be contiguous")
    if scales.data_ptr() % 8:
        raise ValueError(f"{name}: scales must be 8-byte aligned")


def quantized_split_plan(lmax: int) -> tuple[int, int]:
    """K4's split of the window: ``(n_split, block_keys)``.  Block ``t``
    covers keys ``[t * block_keys, min((t + 1) * block_keys, lmax))`` in
    runs of ``RUN_KEYS``: every key of the window in exactly one block.  The
    plan depends on the window only, never on the offset (a captured launch
    replays for any offset); a block past ``offset + Lq`` finds nothing to
    do."""
    keys = next(k for w, k in K4_BLOCK_KEYS if lmax <= w)
    return -(-lmax // keys), keys


def _quantized_decode_launch(entry: str, q, payload, scales, valid, offset, layer_idx: int,
                             scale: float, block_keys: int, *mode, row0: int = 0):
    """Launch K4 or E2/E3 (``entry``, its ``_f32`` one for an f32 query)
    with ``block_keys`` keys per block."""
    b, h, lq, d = q.shape
    kvh, lmax = payload.shape[2], payload.shape[3]
    if not 1 <= lq <= MAX_PAGED_ROWS or row0 < 0:
        raise ValueError(f"{entry}: {lq} query rows from row {row0} (the kernel takes "
                         f"1-{MAX_PAGED_ROWS} from a row >= 0)")
    check_device_offset(offset, q.device, entry)
    if payload.data_ptr() % 16:
        raise ValueError(f"{entry}: the payload must be 16-byte aligned")
    n_split = -(-lmax // block_keys)
    out = head_major_empty(q)
    # Per block: (max score, sum of exp, unnormalized output) of each query row.
    partial = torch.empty((n_split, b * h * lq, d + 2), dtype=torch.float32, device=q.device)
    entry = _build.entry_of(entry, q.dtype)
    lib, _ = _build.library()
    err = getattr(lib, entry)(
        q.data_ptr(), payload.data_ptr(), scales.data_ptr(), valid.view(torch.uint8).data_ptr(),
        out.data_ptr(), partial.data_ptr(), b, h, kvh, lq, lmax, d, *q.stride()[:3],
        *out.stride()[:3], int(layer_idx), offset.data_ptr(), int(row0), float(scale), n_split,
        int(block_keys), *mode, _build.stream_ptr(q.device),
    )
    _build.check(err, entry)
    return out


def quantized_kv_attention(q, payload, scales, valid, offset, layer_idx: int, scale: float,
                           row0: int = 0):
    """Decode attention over layer ``layer_idx`` of the int4 cache.  q (B, H,
    Lq, D), Lq <= 16; payload (layers, B, KV, Lmax, D) uint8; scales (layers,
    B, KV, Lmax, 4G) bf16; valid (B, Lmax) bool; offset and row0 as in
    :func:`dense_kv_attention`.  Returns (B, H, Lq, D)."""
    if q.device.type == "cpu":
        return quantized_kv_attention_plain(q, payload, scales, valid, offset, layer_idx, scale, row0)
    if q.device.type != "cuda":
        raise RuntimeError(f"quantized_kv_attention: no kernel for device {q.device}")
    check_quantized_inputs(q, payload, scales, valid, layer_idx, "quantized_kv_attention")
    out = _quantized_decode_launch("k4_quantized_kv_attention", q, payload, scales, valid, offset,
                                   layer_idx, scale, quantized_split_plan(payload.shape[3])[1],
                                   row0=row0)
    _build.count(quantized_kv_attention, q.dtype)
    return out


quantized_kv_attention.launches = 0
quantized_kv_attention.fp32 = _build.Launches()


# E2/E3 modes, in the order of csrc/attention.cuh's Mode: how a level q of
# group g (scale s, bias b) becomes a key or a value.  "fp32" is K4;
# "fbias" and "mxu" add the bias outside the dot products, which changes
# only the rounding; "nosoftmax" drops the mask and the softmax.
VARIANT_MODES = ("fp32", "bf16", "convert", "nomul", "fbias", "mxu", "nosoftmax")


def _variant_kv(payload, scales, mode: str, dtype):
    """(payload, scales) of one layer -> (k, v) as ``mode`` dequantizes them,
    float32 holding values rounded to ``dtype`` where the mode rounds."""
    if mode == "fp32":
        k, v = dequantize_kv(payload, scales, dtype, bits=4)
        return k.float(), v.float()
    g = scales.shape[-1] // 4
    per = payload.shape[-1] // g
    planes = [scales[..., i * g : (i + 1) * g].float().repeat_interleave(per, dim=-1) for i in range(4)]
    r = lambda t, dt=dtype: t.to(dt).float()  # noqa: E731
    out = []
    for lvl, s, b in ((payload & 15, *planes[:2]), (payload >> 4, *planes[2:])):
        lvl = lvl.float()
        if mode == "bf16":
            out.append(r(r(lvl * s, torch.bfloat16) + b, torch.bfloat16))
        elif mode in ("convert", "nosoftmax"):
            out.append(lvl)
        elif mode == "nomul":
            out.append(r(lvl + s))
        elif mode == "fbias":
            out.append(r(lvl * s) + b)
        else:  # mxu
            out.append(lvl * s + b)
    return tuple(out)


def quantized_kv_attention_variant_plain(q, payload, scales, valid, offset, layer_idx: int,
                                         scale: float, mode: str = "fp32"):
    """The plain version of every mode: attention over the mode's keys and
    values; "nosoftmax" sums ``score * value`` over the whole window."""
    k, v = _variant_kv(payload[layer_idx], scales[layer_idx], mode, q.dtype)
    if mode != "nosoftmax":
        return decode_attention(q, k, v, valid, query_positions(offset, q.shape[2], q.device), scale)
    b, h, lq, d = q.shape
    kvh = k.shape[1]
    qg = (q * scale).reshape(b, kvh, h // kvh, lq, d).float()
    s = torch.matmul(qg, k[:, :, None].transpose(-1, -2))
    return torch.matmul(s, v[:, :, None]).reshape(b, h, lq, d).to(q.dtype)


def quantized_kv_attention_variant(q, payload, scales, valid, offset, layer_idx: int,
                                   scale: float, mode: str = "fp32", split_keys: int | None = None):
    """E2/E3: K4 with the dequantization of ``mode`` (``VARIANT_MODES``);
    ``split_keys`` is the keys per block of the split window, a multiple of
    ``RUN_KEYS`` (default: K4's :func:`quantized_split_plan`).  Shapes as in
    :func:`quantized_kv_attention`."""
    if mode not in VARIANT_MODES:
        raise ValueError(f"quantized_kv_attention_variant: mode {mode!r} is not one of {VARIANT_MODES}")
    if split_keys is not None and (split_keys < RUN_KEYS or split_keys % RUN_KEYS):
        raise ValueError(f"quantized_kv_attention_variant: split_keys {split_keys} is not a "
                         f"multiple of the {RUN_KEYS}-key run")
    if q.device.type == "cpu":
        return quantized_kv_attention_variant_plain(q, payload, scales, valid, offset, layer_idx,
                                                    scale, mode)
    if q.device.type != "cuda":
        raise RuntimeError(f"quantized_kv_attention_variant: no kernel for device {q.device}")
    check_quantized_inputs(q, payload, scales, valid, layer_idx, "quantized_kv_attention_variant")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"quantized_kv_attention_variant kernel takes a bf16 q, got {q.dtype}")
    block_keys = quantized_split_plan(payload.shape[3])[1] if split_keys is None else split_keys
    out = _quantized_decode_launch("e23_quantized_kv_attention_variant", q, payload, scales, valid,
                                   offset, layer_idx, scale, block_keys, VARIANT_MODES.index(mode))
    _build.count_launch(quantized_kv_attention_variant)
    return out


quantized_kv_attention_variant.launches = 0


def quantized_flash_attention(q, payload, scales, valid, q_pos0: int, layer_idx: int, scale: float):
    """Flash attention of a prefill or extend chunk over layer ``layer_idx``
    of the int4 cache, the chunk's own keys included.  Shapes as in
    :func:`quantized_kv_attention`, at any Lq."""
    if q.device.type == "cpu":
        return quantized_flash_attention_plain(q, payload, scales, valid, q_pos0, layer_idx, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"quantized_flash_attention: no kernel for device {q.device}")
    check_quantized_inputs(q, payload, scales, valid, layer_idx, "quantized_flash_attention")
    if payload.data_ptr() % 16:
        raise ValueError("quantized_flash_attention: the payload must be 16-byte aligned")
    return _flash_launch(q, payload, scales, valid, q_pos0, layer_idx, scale)


def _flash_launch(q, payload, scales, valid, q_pos0: int, layer_idx: int, scale: float):
    """Launch K5 (its ``_f32`` entry for an f32 query) and count it."""
    b, h, lq, d = q.shape
    kvh, lmax = payload.shape[2], payload.shape[3]
    out = head_major_empty(q)
    entry = _build.entry_of("k5_quantized_flash_attention", q.dtype)
    lib, _ = _build.library()
    err = getattr(lib, entry)(
        q.data_ptr(), payload.data_ptr(), scales.data_ptr(), valid.view(torch.uint8).data_ptr(),
        out.data_ptr(), b, h, kvh, lq, lmax, d, *q.stride()[:3], *out.stride()[:3],
        int(layer_idx), int(q_pos0), float(scale), _build.stream_ptr(q.device),
    )
    _build.check(err, entry)
    _build.count(quantized_flash_attention, q.dtype)
    return out


quantized_flash_attention.launches = 0
quantized_flash_attention.fp32 = _build.Launches()


def gather_pages(pool_layer, page_tables):
    """One layer's pool ``(P + 1, KV, page, X)`` -> each slot's logical
    window ``(S, KV, W, X)`` through its page table ``(S, W / page)``."""
    g = pool_layer[page_tables.long()]  # (S, mp, KV, page, X)
    s, mp, kvh, page, x = g.shape
    return g.transpose(1, 2).reshape(s, kvh, mp * page, x)


def paged_visible(valid, offsets, lq: int, row0: int = 0):
    """(S, 1, Lq, W) bool: the fresh-region rule of the module docstring,
    query ``i`` at ``offsets[s] + row0 + i``; the fresh region starts at
    ``offsets[s]`` whatever ``row0`` is."""
    key = torch.arange(valid.shape[1], device=valid.device)
    off = offsets.long()[:, None, None]
    q_pos = off + row0 + torch.arange(lq, device=valid.device)[None, :, None]
    return (((key < off) & valid[:, None, :]) | ((key >= off) & (key <= q_pos)))[:, None]


def paged_kv_attention_plain(q, pool_k, pool_v, page_tables, valid, offsets, layer_idx: int,
                             scale: float, row0: int = 0):
    k = gather_pages(pool_k[layer_idx], page_tables)
    v = gather_pages(pool_v[layer_idx], page_tables)
    return masked_attention(q, k, v, paged_visible(valid, offsets, q.shape[2], row0), scale)


def paged_quantized_kv_attention_plain(q, payload, scales, page_tables, valid, offsets,
                                       layer_idx: int, scale: float, row0: int = 0):
    k, v = dequantize_kv(gather_pages(payload[layer_idx], page_tables),
                         gather_pages(scales[layer_idx], page_tables), q.dtype, bits=4)
    return masked_attention(q, k, v, paged_visible(valid, offsets, q.shape[2], row0), scale)


def check_paged_inputs(q, pool_a, pool_b, page_tables, valid, offsets, layer_idx: int,
                       b_width: int, name: str) -> None:
    """Device, dtype, shape and layout checks shared by K6 and K7;
    ``b_width`` is the last dim ``pool_b`` must have."""
    s, h, lq, d = q.shape
    if any(t.device != q.device for t in (pool_a, pool_b, page_tables, valid, offsets)):
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dtype not in DTYPES or page_tables.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError(f"{name} kernel takes bf16 or fp32 q and int32 page tables and offsets, got "
                        f"{q.dtype}/{page_tables.dtype}/{offsets.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"{name}: valid must be a bool tensor")
    if pool_a.dim() != 5 or not 0 <= layer_idx < pool_a.shape[0]:
        raise ValueError(f"{name}: pool {tuple(pool_a.shape)}, layer {layer_idx}")
    _, _, kvh, page, width = pool_a.shape
    mp = page_tables.shape[-1]
    if d not in CACHE_HEAD_DIMS or width != d or pool_b.shape != (*pool_a.shape[:4], b_width):
        raise ValueError(f"{name}: head dim {d}, pools {tuple(pool_a.shape)} and "
                         f"{tuple(pool_b.shape)} do not match")
    if (h % kvh or not 1 <= lq <= MAX_PAGED_ROWS or page_tables.shape != (s, mp)
            or valid.shape != (s, mp * page) or offsets.shape != (s,)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, pool {tuple(pool_a.shape)}, tables "
                         f"{tuple(page_tables.shape)}, valid {tuple(valid.shape)}, offsets "
                         f"{tuple(offsets.shape)} do not match")
    if q.stride(-1) != 1 or not all(t.is_contiguous() for t in (pool_a, pool_b, page_tables,
                                                                 valid, offsets)):
        raise ValueError(f"{name}: q needs unit stride along D; pools, tables, valid and offsets "
                         "must be contiguous")


def paged_split_plan(window: int) -> tuple[int, int]:
    """K6's and K7's split of a slot's window of ``window`` keys: ``(n_split,
    split_keys)``, one run a block.  Run ``r`` covers keys ``[r *
    split_keys, min((r + 1) * split_keys, window))``: every key of the
    window in exactly one run.  The
    plan depends on the window only, never on the offsets, which stay on the
    device (a captured launch replays for any offsets); a run past a slot's
    last visible key finds nothing to do."""
    return -(-window // PAGED_RUN_KEYS), PAGED_RUN_KEYS


def _paged_launch(entry: str, q, pool_a, pool_b, page_tables, valid, offsets, layer_idx: int,
                  scale: float, n_split: int, split_keys: int, row0: int):
    if row0 < 0:
        raise ValueError(f"{entry}: row0 {row0} < 0")
    s, h, lq, d = q.shape
    _, p1, kvh, page, _ = pool_a.shape
    mp = page_tables.shape[1]
    out = head_major_empty(q)
    # Per run: (max score, sum of exp, unnormalized output) of each query row.
    partial = torch.empty((n_split, s * h * lq, d + 2), dtype=torch.float32, device=q.device)
    entry = _build.entry_of(entry, q.dtype)
    lib, _ = _build.library()
    err = getattr(lib, entry)(
        q.data_ptr(), pool_a.data_ptr(), pool_b.data_ptr(), page_tables.data_ptr(),
        valid.view(torch.uint8).data_ptr(), offsets.data_ptr(), out.data_ptr(),
        partial.data_ptr(), s, h, kvh, lq, p1, page, mp, d, *q.stride()[:3], *out.stride()[:3],
        int(layer_idx), int(row0), float(scale), n_split, split_keys, _build.stream_ptr(q.device),
    )
    _build.check(err, entry)
    return out


def check_pool_dtype(q, pool_k, pool_v) -> None:
    """K6 reads a pool of its query's type: bf16, or f32 for an fp32 model."""
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError(f"paged_kv_attention kernel takes a pool of q's type {q.dtype}, got "
                        f"{pool_k.dtype}/{pool_v.dtype}")


def paged_kv_attention(q, pool_k, pool_v, page_tables, valid, offsets, layer_idx: int, scale: float,
                       row0: int = 0):
    """K6: decode attention of every slot over layer ``layer_idx`` of the
    dense page pool.  q (S, H, Lq, D); pool_k/pool_v (layers, P + 1, KV,
    page, D); page_tables (S, W / page) int32 with entries in [0, P];
    valid (S, W) bool; offsets (S,) int32; query ``i`` of slot ``s`` at
    ``offsets[s] + row0 + i``.  Returns (S, H, Lq, D)."""
    if q.device.type == "cpu":
        return paged_kv_attention_plain(q, pool_k, pool_v, page_tables, valid, offsets,
                                        layer_idx, scale, row0)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_kv_attention: no kernel for device {q.device}")
    check_paged_inputs(q, pool_k, pool_v, page_tables, valid, offsets, layer_idx, q.shape[-1],
                       "paged_kv_attention")
    check_pool_dtype(q, pool_k, pool_v)
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_kv_attention: the pools must be 16-byte aligned")
    n_split, split_keys = paged_split_plan(page_tables.shape[1] * pool_k.shape[3])
    out = _paged_launch("k6_paged_kv_attention", q, pool_k, pool_v, page_tables, valid, offsets,
                        layer_idx, scale, n_split, split_keys, row0)
    _build.count(paged_kv_attention, q.dtype)
    return out


paged_kv_attention.launches = 0
paged_kv_attention.fp32 = _build.Launches()


def paged_quantized_kv_attention(q, payload, scales, page_tables, valid, offsets, layer_idx: int,
                                 scale: float, row0: int = 0):
    """K7: K6 over layer ``layer_idx`` of the int4 page pool; payload
    (layers, P + 1, KV, page, D) uint8 ``k | v << 4``, scales (..., 4G)
    bf16.  Returns (S, H, Lq, D)."""
    if q.device.type == "cpu":
        return paged_quantized_kv_attention_plain(q, payload, scales, page_tables, valid, offsets,
                                                  layer_idx, scale, row0)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_quantized_kv_attention: no kernel for device {q.device}")
    d = q.shape[-1]
    check_paged_inputs(q, payload, scales, page_tables, valid, offsets, layer_idx,
                       4 * (d // KV_GROUP), "paged_quantized_kv_attention")
    if payload.dtype != torch.uint8 or scales.dtype != torch.bfloat16:
        raise TypeError("paged_quantized_kv_attention kernel takes a uint8 payload and bf16 "
                        f"scales, got {payload.dtype}/{scales.dtype}")
    if payload.data_ptr() % 16 or scales.data_ptr() % 8:
        raise ValueError("paged_quantized_kv_attention: the payload must be 16-byte and the "
                         "scales 8-byte aligned")
    n_split, split_keys = paged_split_plan(page_tables.shape[1] * payload.shape[3])
    out = _paged_launch("k7_paged_quantized_kv_attention", q, payload, scales, page_tables, valid,
                        offsets, layer_idx, scale, n_split, split_keys, row0)
    _build.count(paged_quantized_kv_attention, q.dtype)
    return out


paged_quantized_kv_attention.launches = 0
paged_quantized_kv_attention.fp32 = _build.Launches()
