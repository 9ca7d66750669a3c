"""Decode state, dense bf16 cache only
(counterpart of ``phi_3_vision_mlx_tpu/engine/state.py``).

The cache is preallocated ``(layers, B, KV, Lmax, D)`` for the whole window.
The JAX package threads an immutable state through jitted steps and relies
on buffer donation to update it in place; the port writes the chunk's
columns into the same tensors in place instead.  ``offset`` is a host int:
decode runs eagerly, so it never has to live on the device.  The quantized
cache is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import ModelConfig
from ..ops.rope import su_rope_tables


@dataclasses.dataclass
class DecodeState:
    """k, v: (layers, B, KV, Lmax, D) cache; offset: committed positions
    (shared by rows: left padding keeps them aligned); valid (B, Lmax) bool:
    False at left-pad positions; cos/sin (B|1, Lmax, D) float32 SuRoPE tables
    for the whole window."""

    k: torch.Tensor
    v: torch.Tensor
    offset: int
    valid: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor

    @property
    def window(self) -> int:
        return self.valid.shape[1]


def init_state(
    cfg: ModelConfig,
    batch: int,
    prompt_len: int,
    l_all: int,
    pids=None,
    prompt_valid=None,
    compute_dtype=torch.bfloat16,
    device=None,
) -> DecodeState:
    """Allocate a fresh decode window of ``l_all`` positions.  Positions at
    or past ``prompt_len`` start valid (they will hold decoded tokens)."""
    if cfg.use_quantized_cache:
        raise NotImplementedError("the quantized KV cache is not ported yet")
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, l_all, cfg.head_dim)
    k = torch.zeros(shape, dtype=compute_dtype, device=device)
    v = torch.zeros(shape, dtype=compute_dtype, device=device)
    valid = torch.ones((batch, l_all), dtype=torch.bool, device=device)
    if prompt_valid is not None:
        valid[:, :prompt_len] = torch.as_tensor(prompt_valid, device=device).bool()
    cos, sin = su_rope_tables(cfg, l_all, pids, device=device)
    return DecodeState(k=k, v=v, offset=0, valid=valid, cos=cos, sin=sin)


def update_layer_chunk(state: DecodeState, layer: int, offset: int, k_new, v_new) -> None:
    """Write a fresh (B, KV, L, D) chunk into layer ``layer`` at ``offset``,
    in place: O(tokens), not O(window)."""
    n = k_new.shape[2]
    state.k[layer, :, :, offset : offset + n] = k_new
    state.v[layer, :, :, offset : offset + n] = v_new
