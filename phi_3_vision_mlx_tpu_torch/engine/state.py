"""Decode state: the dense bf16 cache and the 4/8-bit quantized cache
(counterpart of ``phi_3_vision_mlx_tpu/engine/state.py``).

The cache is preallocated for the whole window.  The JAX package threads an
immutable state through jitted steps and relies on buffer donation to update
it in place; the port writes the chunk's positions into the same tensors in
place instead.  The offset lives on the device, as the JAX package's does
(``pos``, a ``(1,)`` int32 tensor): a decode step reads it there and
advances it in place, so a CUDA graph of the step replays at any offset
(``engine/graphs.py``).  ``offset`` is its host mirror, which the host
advances by the steps it ran: prefill and extend chunks (K2, K5), the
window-overflow check and the stoppers read the mirror, never the device.

Dense mode: ``k``/``v`` are ``(layers, B, KV, Lmax, D)`` in the compute
dtype.

Quantized mode (``use_quantized_cache``): group-32 affine quantization along
D, bf16 scale and bias (``lo``), ``scale == 0 -> 1``, round half to even,
clipped to ``[0, 2**bits - 1]``, as in the JAX package.  The layout is the
port's own.  The JAX package stores the cache transposed,
``(layers, B, KV, D, Lmax)``, with D permuted so that Mosaic's lane tiling
and ``pltpu.repeat`` can expand per-group scales; neither exists on a GPU.
Here the cache is token-major, in the original D order:

* ``k`` (the payload): ``(layers, B, KV, Lmax, D)`` uint8 at 4 bits, byte
  ``d = k_q[d] | v_q[d] << 4``; ``(layers, B, KV, Lmax, 2D)`` at 8 bits, the
  k bytes then the v bytes.  ``v`` is None.
* ``k_scales``: ``(layers, B, KV, Lmax, 4G)`` bf16, ``[k_scale, k_bias,
  v_scale, v_bias]`` for the G groups of D.

So a decode write is one contiguous run per (head, token) (96 + 24 bytes at
D = 96, 4 bits) instead of single bytes at stride Lmax, and the kernels read
each key's payload and scales as contiguous runs.  Quantizing a fresh chunk
is plain PyTorch: the JAX package does it in XLA, with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.config import KVQuantConfig, ModelConfig
from ..ops.rope import su_rope_tables


@dataclasses.dataclass
class DecodeState:
    """k, v: the cache (see the module docstring; v is None when quantized);
    offset: committed positions (shared by rows: left padding keeps them
    aligned), the host mirror of ``pos``, the (1,) int32 device offset;
    valid (B, Lmax) bool: False at left-pad positions; cos/sin (B|1, Lmax,
    D) float32 SuRoPE tables for the whole window; k_scales and kv_quant:
    the quantized cache's scale planes and its config, None for the dense
    cache."""

    k: torch.Tensor
    v: Optional[torch.Tensor]
    offset: int
    pos: torch.Tensor
    valid: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    kv_quant: Optional[KVQuantConfig] = None

    @property
    def window(self) -> int:
        return self.valid.shape[1]

    @property
    def quantized(self) -> bool:
        return self.kv_quant is not None


def init_state(
    cfg: ModelConfig,
    batch: int,
    prompt_len: int,
    l_all: int,
    pids=None,
    prompt_valid=None,
    compute_dtype=torch.bfloat16,
    device=None,
    into: Optional[DecodeState] = None,
) -> DecodeState:
    """Allocate a fresh decode window of ``l_all`` positions.  Positions at
    or past ``prompt_len`` start valid (they will hold decoded tokens).

    ``into``: a state of the same shape whose tensors are reused instead (a
    CUDA graph holds their addresses): it is reset in place to what a fresh
    window holds.  The cache is zeroed too, not only past the offset: a row
    that sees no key averages the whole window."""
    valid = torch.ones((batch, l_all), dtype=torch.bool, device=device)
    if prompt_valid is not None:
        valid[:, :prompt_len] = torch.as_tensor(prompt_valid, device=device).bool()
    cos, sin = su_rope_tables(cfg, l_all, pids, device=device)
    if into is None:
        lead = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, l_all)
        return DecodeState(offset=0, pos=torch.zeros((1,), dtype=torch.int32, device=device),
                           valid=valid, cos=cos, sin=sin,
                           **alloc_cache(cfg, lead, compute_dtype, device))
    if into.valid.shape != valid.shape or into.cos.shape != cos.shape:
        raise ValueError(f"state of window {tuple(into.valid.shape)} reused for {tuple(valid.shape)}")
    for t in (into.k, into.v, into.k_scales, into.pos):
        if t is not None:
            t.zero_()
    into.valid.copy_(valid)
    into.cos.copy_(cos)
    into.sin.copy_(sin)
    return dataclasses.replace(into, offset=0)


def alloc_cache(cfg: ModelConfig, lead: tuple, compute_dtype, device) -> dict:
    """Zeroed cache tensors with leading dims ``lead`` (layers, rows, KV,
    positions) in the layout of the module docstring: the ``k``, ``v``,
    ``k_scales`` and ``kv_quant`` fields of a state.  The slot and paged
    engines use it with (slots, window) and (pages, page) in place of
    (B, Lmax)."""
    d = cfg.head_dim
    if not cfg.use_quantized_cache:
        return dict(k=torch.zeros((*lead, d), dtype=compute_dtype, device=device),
                    v=torch.zeros((*lead, d), dtype=compute_dtype, device=device))
    kvq = cfg.kv_quant
    if kvq.bits not in (4, 8) or d % min(kvq.group_size, d):
        raise ValueError(f"KV quantization {kvq} does not fit head dim {d}")
    groups = d // min(kvq.group_size, d)
    width = d if kvq.bits == 4 else 2 * d
    return dict(k=torch.zeros((*lead, width), dtype=torch.uint8, device=device), v=None,
                k_scales=torch.zeros((*lead, 4 * groups), dtype=torch.bfloat16, device=device),
                kv_quant=kvq)


def _kv_quantize(x, kvq: KVQuantConfig):
    """x (..., D) float -> (payload uint8, scales f32, biases f32), with
    groups along D."""
    *lead, d = x.shape
    g = min(kvq.group_size, d)
    levels = (1 << kvq.bits) - 1
    xf = x.float().reshape(*lead, d // g, g)
    lo, hi = torch.aminmax(xf, dim=-1)
    scale = (hi - lo) / levels
    scale = torch.where(scale == 0, 1.0, scale)
    q = ((xf - lo[..., None]) / scale[..., None]).round_().clamp_(0, levels)
    return q.reshape(*lead, d).to(torch.uint8), scale, lo


def _kv_dequantize(q, scales, biases, dtype):
    """``q * scale + bias`` in float32, two roundings (no fused multiply-add:
    the kernels compute the same bits), then one rounding to ``dtype``."""
    *lead, d = q.shape
    groups = scales.shape[-1]
    qf = q.float().reshape(*lead, groups, d // groups)
    x = qf * scales.float()[..., None] + biases.float()[..., None]
    return x.reshape(*lead, d).to(dtype)


def quantize_chunk(k_new, v_new, kvq: KVQuantConfig):
    """Fresh (..., L, D) k/v -> (payload, scales) in the cache's layout.
    k and v are quantized in one pass: a decode step runs this once per
    layer, and each operation is a kernel launch."""
    q, scale, lo = _kv_quantize(torch.stack([k_new, v_new]), kvq)
    payload = q[0] | (q[1] << 4) if kvq.bits == 4 else torch.cat([q[0], q[1]], dim=-1)
    return payload, torch.cat([scale[0], lo[0], scale[1], lo[1]], dim=-1).to(torch.bfloat16)


def dequantize_kv(payload, scales, dtype, bits: int = 4):
    """(payload, scales) of any leading shape -> (k, v) (..., L, D) in
    ``dtype``: the quantized branch of the JAX ``read_kv``."""
    g = scales.shape[-1] // 4
    if bits == 4:
        kq, vq = payload & 15, payload >> 4
    else:
        d = payload.shape[-1] // 2
        kq, vq = payload[..., :d], payload[..., d:]
    ks, kb, vs, vb = (scales[..., i * g : (i + 1) * g] for i in range(4))
    return _kv_dequantize(kq, ks, kb, dtype), _kv_dequantize(vq, vs, vb, dtype)


def read_kv(state: DecodeState, layer: int, dtype):
    """Layer ``layer``'s whole (B, KV, Lmax, D) k/v window in ``dtype``."""
    if state.quantized:
        return dequantize_kv(state.k[layer], state.k_scales[layer], dtype, state.kv_quant.bits)
    return state.k[layer].to(dtype), state.v[layer].to(dtype)


def update_layer_chunk(state: DecodeState, layer: int, pos, k_new, v_new) -> None:
    """Write a fresh (B, KV, L, D) chunk into layer ``layer`` in place
    (quantized first for a quantized cache): O(tokens), not O(window).
    ``pos``: the chunk's (L,) int64 positions on the device, or a host int,
    the first of L consecutive ones."""
    if isinstance(pos, int):
        pos = torch.arange(pos, pos + k_new.shape[2], device=k_new.device)
    if state.quantized:
        payload, scales = quantize_chunk(k_new, v_new, state.kv_quant)
        state.k[layer].index_copy_(2, pos, payload)
        state.k_scales[layer].index_copy_(2, pos, scales)
        return
    state.k[layer].index_copy_(2, pos, k_new.to(state.k.dtype))
    state.v[layer].index_copy_(2, pos, v_new.to(state.v.dtype))
