"""Phi-3 decoder, write path over the dense or quantized cache
(counterpart of ``phi_3_vision_mlx_tpu/models/phi3.py``).

Pre-RMSNorm blocks with a fused qkv projection, su-scaled RoPE, GQA attention
against the preallocated window and a SwiGLU MLP with a fused gate_up
projection.  The JAX package scans one compiled layer body over stacked
weights; here the layers run as a Python loop over zero-copy ``w[layer]``
views of the same stacked tensors.

Each layer writes the chunk's k/v into the cache first (quantized first for
a quantized cache), then attends to the cache, the fresh keys included.
Attention routing (the port's own table; the JAX package's TPU thresholds
do not carry over):

=============  ===============================  ================================
cache          Lq <= ``MAX_DECODE_ROWS`` (16)   Lq > 16 (prefill, extend)
=============  ===============================  ================================
dense bf16     K3 over the stacked cache        K2 over the layer's window
int4           K4 over the stacked payload      K5 over the stacked payload
int8           ``read_kv`` of the layer to the  ``read_kv``, then K2
               compute dtype, then K3 on that
               one-layer view
=============  ===============================  ================================

The int8 row is explicit routing, not a fallback: K4 and K5 read the
nibble-packed int4 layout only (the JAX package dispatches its int4 decode
kernel without checking the bits).  On the CPU every wrapper runs its plain
``ops/attention.py`` path.  The beam read path (``n_beam``) waits for
constrained decoding.  The continuous-batching engines run the same
:func:`block` with their own ``attend`` (per-slot offsets; the paged pool's
K6/K7, ``engine/paging.py``).  A vision prompt enters as
``inputs_embeds`` (``models/vision.py``).  :func:`init_params` draws random
weights, the vision tower's too, for ``core/weights.py:
create_random_checkpoint``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..core.weights import torch_dtype
from ..engine.state import DecodeState, init_state, read_kv, update_layer_chunk
from ..ops.kernels.flash_attention import flash_attention
from ..ops.kernels.kv_attention import dense_kv_attention, quantized_flash_attention, quantized_kv_attention
from ..ops.linear import dense, dense_stacked, embedding
from ..ops.norms import rms_norm
from ..ops.rope import apply_rotary

MAX_DECODE_ROWS = 16


class ForwardResult(NamedTuple):
    logits: torch.Tensor
    state: DecodeState


def _qkv_split(cfg: ModelConfig, qkv: torch.Tensor):
    """Fused qkv (B, L, (H + 2KV) * D) -> q (B,H,L,D), k, v (B,KV,L,D) views."""
    b, l, _ = qkv.shape
    h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q = qkv[..., : h * d].reshape(b, l, h, d).transpose(1, 2)
    k = qkv[..., h * d : (h + kv) * d].reshape(b, l, kv, d).transpose(1, 2)
    v = qkv[..., (h + kv) * d :].reshape(b, l, kv, d).transpose(1, 2)
    return q, k, v


def _attend(q, state: DecodeState, i: int, scale: float, decode=None):
    """Attention of the chunk's queries to layer ``i`` of the cache, routed
    by the table of the module docstring (``decode`` True takes the decode
    route at any length).  Decode (K3, K4) reads the device offset
    ``state.pos``; prefill and extend (K2, K5) take the host mirror."""
    if decode is None:
        decode = q.shape[2] <= MAX_DECODE_ROWS
    if state.quantized and state.kv_quant.bits == 4:
        if decode:
            return quantized_kv_attention(q, state.k, state.k_scales, state.valid, state.pos, i, scale)
        return quantized_flash_attention(q, state.k, state.k_scales, state.valid, state.offset, i,
                                         scale)
    if state.quantized:
        k, v = read_kv(state, i, q.dtype)
        k_stack, v_stack, layer = k[None], v[None], 0
    else:
        k_stack, v_stack, layer = state.k, state.v, i
    if decode:
        return dense_kv_attention(q, k_stack, v_stack, state.valid, state.pos, layer, scale)
    return flash_attention(q, k_stack[layer], v_stack[layer], state.valid, state.offset, scale)


def block(cfg: ModelConfig, x, layers: dict, i: int, cos, sin, attend):
    """Decoder block ``i``.  ``attend(q, k, v)`` gets the rotated chunk
    (B, H|KV, L, D), writes its k/v into the cache and returns the attention
    output (B, H, L, D); the single-stream and the slot engines differ only
    there."""
    eps = cfg.rms_norm_eps
    attn, mlp = layers["self_attn"], layers["mlp"]
    h = rms_norm(x, layers["input_layernorm"]["weight"][i], eps)
    q, k, v = _qkv_split(cfg, dense_stacked(attn["qkv_proj"], h, i))
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    o = attend(q, k, v)
    b, _, l, _ = q.shape
    o = o.transpose(1, 2).reshape(b, l, -1)
    x = x + dense_stacked(attn["o_proj"], o, i).to(x.dtype)
    h = rms_norm(x, layers["post_attention_layernorm"]["weight"][i], eps)
    gate, up = dense_stacked(mlp["gate_up_proj"], h, i).chunk(2, dim=-1)
    ff = F.silu(gate.float()).to(up.dtype) * up
    return x + dense_stacked(mlp["down_proj"], ff, i).to(x.dtype)


def decode_forward(
    params: dict,
    cfg: ModelConfig,
    state: DecodeState,
    input_ids: Optional[torch.Tensor] = None,
    *,
    inputs_embeds: Optional[torch.Tensor] = None,
    advance: Optional[int] = None,
    last_logit_only: bool = False,
    positions: Optional[torch.Tensor] = None,
) -> ForwardResult:
    """Run a (B, L) chunk through the decoder against the cache window:
    ``input_ids``, or ``inputs_embeds`` (B, L, E) in their place (a vision
    prompt's embeddings with the image features written in).

    The chunk's k/v are written at the device offset ``state.pos``, whose
    host mirror ``state.offset`` is checked against the window; the returned
    state shares the cache tensors and ``pos``, advanced in place by ``L``
    (or by ``advance``: 0 scores without committing, 1 commits one
    position), and carries the advanced mirror.  The state passed in keeps
    its mirror, so it no longer describes the device: use the returned one.
    ``last_logit_only`` runs the lm_head for the last position only.  With L
    <= ``MAX_DECODE_ROWS`` nothing reads the mirror on the device path, so
    a CUDA graph of a decode step replays at any offset.

    ``positions`` (L,) int64 on the device, in the window: a speculative
    verify pass, whose offset the host learns only later.  The chunk's k/v
    and RoPE take these columns, the queries sit at ``pos + i`` as always,
    attention takes the decode route (K3/K4) at any length, and the mirror
    is not checked: the caller keeps the columns in the window.
    """
    mdl = params["model"]
    if inputs_embeds is None:
        x = embedding(mdl["embed_tokens"], input_ids, dtype=torch_dtype(cfg.dtype))
    else:
        x = inputs_embeds.to(torch_dtype(cfg.dtype))
    b, l, _ = x.shape
    offset = state.offset
    if positions is not None:
        pos = positions
    elif offset < 0 or offset + l > state.window:
        raise ValueError(f"chunk of {l} at offset {offset} overflows window {state.window}")
    else:
        pos = (state.pos + torch.arange(l, dtype=torch.int32, device=x.device)).long()
    cos = state.cos.index_select(1, pos)
    sin = state.sin.index_select(1, pos)
    if cos.shape[0] == 1 and b > 1:
        cos, sin = cos.expand(b, -1, -1), sin.expand(b, -1, -1)
    scale = cfg.head_dim**-0.5

    def attend(q, k, v, i):
        update_layer_chunk(state, i, pos, k, v)
        return _attend(q, state, i, scale, decode=True if positions is not None else None)

    for i in range(cfg.num_hidden_layers):
        x = block(cfg, x, mdl["layers"], i, cos, sin, functools.partial(attend, i=i))
    x = rms_norm(x, mdl["norm"]["weight"], cfg.rms_norm_eps)
    if last_logit_only:
        x = x[:, -1:]
    logits = dense(params["lm_head"], x)[..., : cfg.vocab_size]
    step = l if advance is None else advance
    if step:
        state.pos.add_(step)
    return ForwardResult(logits, dataclasses.replace(state, offset=offset + step))


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=None) -> dict:
    """Random parameters in the tree of a loaded unquantized checkpoint (the
    layer subtree stacked along axis 0), drawn on ``generator``'s device.

    The JAX ``init_params`` law: normal with scale ``fan_in ** -0.5`` for
    the linears (stored ``(in, out)``) and 0.02 for the embedding, unit
    norms; ``torch.Generator`` gives other numbers than ``jax.random``.
    """
    dt = dtype or torch_dtype(cfg.dtype)
    e, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    nl = cfg.num_hidden_layers

    def nrm(shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        return (torch.randn(shape, generator=generator, device=generator.device) * scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=generator.device)

    params = {
        "model": {
            "embed_tokens": {"weight": nrm((v, e), 0.02)},
            "layers": {
                "self_attn": {
                    "qkv_proj": {"weight": nrm((nl, e, (h + 2 * kv) * d))},
                    "o_proj": {"weight": nrm((nl, h * d, e))},
                },
                "mlp": {
                    "gate_up_proj": {"weight": nrm((nl, e, 2 * i))},
                    "down_proj": {"weight": nrm((nl, i, e))},
                },
                "input_layernorm": {"weight": ones(nl, e)},
                "post_attention_layernorm": {"weight": ones(nl, e)},
            },
            "norm": {"weight": ones(e)},
        },
        "lm_head": {"weight": nrm((e, v))},
    }
    if cfg.has_vision:
        from .vision import init_vision_params

        params["model"]["vision_embed_tokens"] = init_vision_params(cfg, generator, dt)
    return params


def prefill(
    params: dict,
    cfg: ModelConfig,
    input_ids: Optional[torch.Tensor],
    *,
    max_tokens: int,
    pids=None,
    prompt_valid=None,
    inputs_embeds: Optional[torch.Tensor] = None,
    last_logit_only: bool = False,
    into: Optional[DecodeState] = None,
) -> ForwardResult:
    """Allocate a window of ``L + max_tokens`` positions (or reset ``into``,
    ``engine/state.py:init_state``) and run the prompt, given as ids or as
    ``inputs_embeds``."""
    lead = inputs_embeds if inputs_embeds is not None else input_ids
    b, l = lead.shape[:2]
    state = init_state(
        cfg, b, l, l + max_tokens, pids=pids, prompt_valid=prompt_valid,
        compute_dtype=torch_dtype(cfg.dtype), device=lead.device, into=into,
    )
    return decode_forward(params, cfg, state, input_ids, inputs_embeds=inputs_embeds,
                          last_logit_only=last_logit_only)
