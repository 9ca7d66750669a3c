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
kernel without checking the bits).  A decode-route chunk of more than 16
rows (a verify pass, a constrained-decoding score step) runs K3/K4 on
groups of 16 rows.  On the CPU every wrapper runs its plain
``ops/attention.py`` path.

Two read paths write nothing (constrained decoding, ``engine/constrain.py``):
the beam read (``decode_forward(n_beam=...)``) repeats each cache row's
committed window ``n_beam`` times beside the chunk, and
:func:`forward_nocache` runs a causal pass with no cache (K2 at offset 0 on
the card).  The JAX package runs the beam read in XLA with no Pallas
kernel; here it is plain PyTorch attention over the window that
``read_kv`` dequantizes, every layer.  The continuous-batching engines run the same
:func:`block` with their own ``attend`` (per-slot offsets; the paged pool's
K6/K7, ``engine/paging.py``).  A vision prompt enters as
``inputs_embeds`` (``models/vision.py``).  :func:`init_params` draws random
weights, the vision tower's too, for ``core/weights.py:
create_random_checkpoint``.

LoRA: a linear leaf may carry adapter leaves (``ops/linear.py``), which
every path here applies through ``dense_stacked`` and ``dense``.  Training
(``train/trainer.py``) differentiates :func:`forward_nocache` with
``allow_flash=False``: plain masked attention, or
``ops/attention.py:blockwise_attention`` from ``BLOCKWISE_MIN_LEN`` keys on,
and LoRA-branch dropout with one keep mask per (layer, linear)
(:func:`lora_dropout_mask`: a counter-based hash of a device key, so that a
captured training step draws each step's own mask).

Parallelism (``parallel/``): :func:`prefill`, :func:`decode_forward`,
:func:`forward_nocache` and :func:`block` take an optional ``tp``, a
tensor-parallel rank (``parallel/tensor.py:TensorParallel``) running its
shards (``parallel/sharding.py:shard_params``) under its
``local_config``: Megatron's operators around the linears, the
vocab-parallel embedding and lm_head, a cache of the rank's KV heads, on
which the kernels run unchanged.  Without it nothing of this runs.
:func:`prefill_ring` prefills a prompt cut over a mesh axis through ring
attention (``parallel/ring_attention.py``) and gathers the cache for an
ordinary decode; ``LM(sp_mesh=)`` takes that route
(``engine/engine.py:run_prefill``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..core.weights import torch_dtype
from ..engine.rng import MASK, hash32
from ..engine.state import DecodeState, init_state, read_kv, update_layer_chunk
from ..ops.attention import blockwise_attention, causal_valid_mask, masked_attention
from ..ops.kernels.flash_attention import flash_attention
from ..ops.kernels.kv_attention import (by_row_groups, dense_kv_attention, quantized_flash_attention,
                                        quantized_kv_attention)
from ..ops.linear import dense, dense_stacked, embedding
from ..ops.norms import rms_norm
from ..ops.rope import apply_rotary, su_rope_tables
from ..parallel.ring_attention import make_ring_attention

MAX_DECODE_ROWS = 16
DROPOUT = 0x5BD1E995  # the LoRA dropout's stream (engine/rng.py's streams are a step's draws)
BLOCKWISE_MIN_LEN = 2048  # forward_nocache without flash: blockwise attention from here on
# Stable ids of the linears for LoRA dropout keys (JAX models/phi3.py:93-97).
_PATH_IDS = {
    ("self_attn", "qkv_proj"): 0,
    ("self_attn", "o_proj"): 1,
    ("mlp", "gate_up_proj"): 2,
    ("mlp", "down_proj"): 3,
}


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
    route at any length, in launches of 16 query rows).  Decode (K3, K4)
    reads the device offset ``state.pos``; prefill and extend (K2, K5) take
    the host mirror."""
    if decode is None:
        decode = q.shape[2] <= MAX_DECODE_ROWS
    if state.quantized and state.kv_quant.bits == 4:
        if decode:
            return by_row_groups(quantized_kv_attention, q, state.k, state.k_scales, state.valid,
                                 state.pos, i, scale)
        return quantized_flash_attention(q, state.k, state.k_scales, state.valid, state.offset, i,
                                         scale)
    if state.quantized:
        k, v = read_kv(state, i, q.dtype)
        k_stack, v_stack, layer = k[None], v[None], 0
    else:
        k_stack, v_stack, layer = state.k, state.v, i
    if decode:
        return by_row_groups(dense_kv_attention, q, k_stack, v_stack, state.valid, state.pos, layer,
                             scale)
    return flash_attention(q, k_stack[layer], v_stack[layer], state.valid, state.offset, scale)


def block(cfg: ModelConfig, x, layers: dict, i: int, cos, sin, attend, dropout=None, tp=None):
    """Decoder block ``i``.  ``attend(q, k, v)`` gets the rotated chunk
    (B, H|KV, L, D), writes its k/v into the cache and returns the attention
    output (B, H, L, D); the single-stream and the slot engines differ only
    there.  ``dropout(layer, path, h)``, for training, gives the LoRA
    branch's input mask of each linear that carries LoRA leaves.

    ``tp`` (``parallel/tensor.py:TensorParallel``): this rank's shards of a
    tensor-parallel model (``cfg`` its ``local_config``), with Megatron's
    operators around the linears: ``tp.enter`` before qkv and gate_up,
    ``tp.reduce`` after o_proj and down_proj.  None runs neither."""
    eps = cfg.rms_norm_eps
    enter = tp.enter if tp is not None else (lambda t: t)
    reduce = tp.reduce if tp is not None else (lambda t: t)

    def linear(path, h):
        node = layers[path[0]][path[1]]
        mask = dropout(i, path, h) if dropout is not None and "lora_a" in node else None
        return dense_stacked(node, h, i, dropout_mask=mask)

    h = enter(rms_norm(x, layers["input_layernorm"]["weight"][i], eps))
    q, k, v = _qkv_split(cfg, linear(("self_attn", "qkv_proj"), h))
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    o = attend(q, k, v)
    b, _, l, _ = q.shape
    o = o.transpose(1, 2).reshape(b, l, -1)
    x = x + reduce(linear(("self_attn", "o_proj"), o).to(x.dtype))
    h = enter(rms_norm(x, layers["post_attention_layernorm"]["weight"][i], eps))
    gate, up = linear(("mlp", "gate_up_proj"), h).chunk(2, dim=-1)
    ff = F.silu(gate.float()).to(up.dtype) * up
    return x + reduce(linear(("mlp", "down_proj"), ff).to(x.dtype))


def lora_dropout_mask(rng, layer: int, path_id: int, shape, keep: float, device) -> torch.Tensor:
    """Keep decisions (bool, ``shape``) of the LoRA-branch dropout of linear
    ``path_id`` (``_PATH_IDS``) in layer ``layer``: one stream per (``rng``,
    layer, linear), as the JAX package folds its key
    (``fold_in(fold_in(key, layer), path_id)``).  ``rng`` is the trainer's
    step key, an int64 tensor ``(seed + 1, step)`` on ``device`` (an int or
    a tuple of ints is made one).  Element ``e`` is kept iff the top 24
    bits of ``hash32(hash32(e ^ k) ^ DROPOUT)`` fall below ``keep * 2**24``,
    ``k`` the key's words, layer and linear hashed in turn
    (``engine/rng.py:hash32``): integer tensor ops only, so the CPU and the
    card draw the same mask, and a replayed step draws its own step's.  The
    numbers are not JAX's."""
    key = torch.as_tensor(rng, dtype=torch.long, device=device).reshape(-1)
    k = hash32((key[0] & MASK) ^ DROPOUT)
    for i in range(1, key.shape[0]):
        k = hash32(k ^ (key[i] & MASK))
    k = hash32(hash32(k ^ layer) ^ path_id)
    idx = torch.arange(int(np.prod(shape)), dtype=torch.long, device=device)
    bits = hash32(hash32(idx ^ k) ^ DROPOUT)
    return ((bits >> 8) < int(keep * 2**24)).reshape(shape)


def decode_forward(
    params: dict,
    cfg: ModelConfig,
    state: DecodeState,
    input_ids: Optional[torch.Tensor] = None,
    *,
    inputs_embeds: Optional[torch.Tensor] = None,
    advance: Optional[int] = None,
    n_beam: int = 1,
    last_logit_only: bool = False,
    positions: Optional[torch.Tensor] = None,
    decode_route: bool = False,
    tp=None,
    write=None,
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
    <= ``MAX_DECODE_ROWS`` (or ``decode_route``) nothing reads the mirror on
    the device path, so a CUDA graph of the step replays at any offset.

    ``positions`` (L,) int64 on the device, in the window: a speculative
    verify pass, whose offset the host learns only later.  The chunk's k/v
    and RoPE take these columns, the queries sit at ``pos + i`` as always,
    attention takes the decode route (K3/K4) at any length, and the mirror
    is not checked: the caller keeps the columns in the window.

    ``decode_route``: the decode route (K3/K4 at the device offset, in
    launches of 16 query rows) at any length, the chunk's columns at ``pos
    + arange(L)``: a constrained-decoding score step, whose graph replays
    at any offset (``engine/engine.py:LM.score_fn``).

    ``n_beam`` > 1: a (B * n_beam, L) chunk, beam rows ``r * n_beam + j`` of
    cache row ``r``, scored against the shared cache without writing it
    (JAX ``decode_forward(n_beam=)``).  Each layer reads its window with
    ``read_kv``, repeats it ``n_beam`` times along the rows and appends the
    chunk's k/v: query ``i`` sees the committed keys (``key < pos`` and
    valid) and the chunk's keys up to its own.  The state comes back as it
    was.

    ``tp`` (``parallel/tensor.py:TensorParallel``): a tensor-parallel rank
    of the model, ``params`` its shards and ``cfg`` its ``local_config``
    (``parallel/sharding.py``), ``state`` a cache of its KV heads (the
    kernels run on them unchanged); the logits come back whole on every
    rank.  None for the whole model.

    ``write(state, layer, pos, k, v)`` writes each layer's chunk into the
    cache (None: ``engine/state.py:update_layer_chunk``); a check that
    holds a run to another's quantized entries passes one that writes
    those (``parallel/dryrun.py:ReplayEntries``).
    """
    if n_beam > 1:
        if tp is not None:
            raise ValueError("the beam read has no tensor-parallel form")
        return _beam_forward(params, cfg, state, input_ids, inputs_embeds, n_beam, last_logit_only)
    x = _embed(params, cfg, input_ids, inputs_embeds, tp)
    b, l, _ = x.shape
    offset = state.offset
    if positions is not None:
        pos = positions
    elif offset < 0 or offset + l > state.window:
        raise ValueError(f"chunk of {l} at offset {offset} overflows window {state.window}")
    else:
        pos = (state.pos + torch.arange(l, dtype=torch.int32, device=x.device)).long()
    cos = _rows(state.cos.index_select(1, pos), b)
    sin = _rows(state.sin.index_select(1, pos), b)
    scale = cfg.head_dim**-0.5

    write = update_layer_chunk if write is None else write

    def attend(q, k, v, i):
        write(state, i, pos, k, v)
        return _attend(q, state, i, scale, decode=True if positions is not None or decode_route else None)

    for i in range(cfg.num_hidden_layers):
        x = block(cfg, x, params["model"]["layers"], i, cos, sin, functools.partial(attend, i=i), tp=tp)
    logits = _head(params, cfg, x, last_logit_only, tp)
    step = l if advance is None else advance
    if step:
        state.pos.add_(step)
    return ForwardResult(logits, dataclasses.replace(state, offset=offset + step))


def _embed(params: dict, cfg: ModelConfig, input_ids, inputs_embeds, tp=None):
    if inputs_embeds is not None:
        return inputs_embeds.to(torch_dtype(cfg.dtype))
    if tp is not None:  # the vocab-parallel table
        return tp.embed(params["model"]["embed_tokens"], input_ids, dtype=torch_dtype(cfg.dtype))
    return embedding(params["model"]["embed_tokens"], input_ids, dtype=torch_dtype(cfg.dtype))


def _rows(t: torch.Tensor, b: int) -> torch.Tensor:
    """RoPE tables (1 | B', L, D) aligned to ``b`` query rows: broadcast, or
    each row repeated ``b // B'`` times (beam rows, JAX ``decode_forward``)."""
    if t.shape[0] == b:
        return t
    if t.shape[0] == 1:
        return t.expand(b, -1, -1)
    return t.repeat_interleave(b // t.shape[0], dim=0)


def _head(params: dict, cfg: ModelConfig, x, last_logit_only: bool = False, tp=None):
    x = rms_norm(x, params["model"]["norm"]["weight"], cfg.rms_norm_eps)
    if last_logit_only:
        x = x[:, -1:]
    if tp is not None:  # the vocab-parallel lm_head: each rank's columns, gathered
        return tp.gather(dense(params["lm_head"], tp.enter(x)))[..., : cfg.vocab_size]
    return dense(params["lm_head"], x)[..., : cfg.vocab_size]


def _beam_forward(params, cfg, state: DecodeState, input_ids, inputs_embeds, n_beam: int,
                  last_logit_only: bool) -> ForwardResult:
    """The beam read path of :func:`decode_forward`."""
    x = _embed(params, cfg, input_ids, inputs_embeds)
    b, l, _ = x.shape
    if b != state.valid.shape[0] * n_beam:
        raise ValueError(f"{b} beam rows for {state.valid.shape[0]} cache rows x n_beam {n_beam}")
    if state.offset + l > state.window:
        raise ValueError(f"beam chunk of {l} at offset {state.offset} overflows window {state.window}")
    dev = x.device
    pos = (state.pos + torch.arange(l, dtype=torch.int32, device=dev)).long()
    cos = _rows(state.cos.index_select(1, pos), b)
    sin = _rows(state.sin.index_select(1, pos), b)
    key = torch.arange(state.window, device=dev)
    cache_ok = ((key[None] < state.pos.long()) & state.valid).repeat_interleave(n_beam, dim=0)
    chunk_causal = torch.ones((l, l), dtype=torch.bool, device=dev).tril()
    allowed = torch.cat([cache_ok[:, None, None, :].expand(b, 1, l, state.window),
                         chunk_causal[None, None].expand(b, 1, l, l)], dim=-1)
    scale = cfg.head_dim**-0.5

    def attend(q, k, v, i):
        kc, vc = read_kv(state, i, q.dtype)
        kc = torch.cat([kc.repeat_interleave(n_beam, dim=0), k], dim=2)
        vc = torch.cat([vc.repeat_interleave(n_beam, dim=0), v], dim=2)
        return masked_attention(q, kc, vc, allowed, scale)

    for i in range(cfg.num_hidden_layers):
        x = block(cfg, x, params["model"]["layers"], i, cos, sin, functools.partial(attend, i=i))
    return ForwardResult(_head(params, cfg, x, last_logit_only), state)


def forward_nocache(
    params: dict,
    cfg: ModelConfig,
    input_ids: Optional[torch.Tensor] = None,
    *,
    pids=None,
    prompt_valid=None,
    inputs_embeds: Optional[torch.Tensor] = None,
    dropout_rng=None,
    lora_dropout: float = 0.0,
    allow_flash: bool = True,
    rope=None,
    tp=None,
) -> torch.Tensor:
    """One causal pass over a (B, L) chunk with no cache (JAX
    ``forward_nocache``, the reference's ``max_tokens=0`` mode of
    ``_choose_from``): su-RoPE tables for L positions and ``pids``, query
    ``i`` seeing keys ``j <= i`` with ``prompt_valid[b, j]``.  Attention is
    K2 at offset 0 over the chunk's own k/v (its plain version on the CPU);
    ``allow_flash=False`` (training: K2 is forward-only) runs the plain
    masked attention instead, or :func:`blockwise_attention` from
    ``BLOCKWISE_MIN_LEN`` positions on.  With ``dropout_rng`` and
    ``lora_dropout`` > 0 each LoRA branch's input is dropped with rate
    ``lora_dropout`` and the kept values scaled by ``1 / (1 -
    lora_dropout)`` (:func:`lora_dropout_mask`).  ``rope``: the (cos, sin)
    tables of the L positions, made beforehand (a captured pass:
    ``su_rope_tables`` copies host values to the device); None makes them
    from ``pids``.  ``tp``: a tensor-parallel rank, as in
    :func:`decode_forward`.  Returns the logits (B, L, V)."""
    x = _embed(params, cfg, input_ids, inputs_embeds, tp)
    b, l, _ = x.shape
    dev = x.device
    if prompt_valid is None:
        valid = torch.ones((b, l), dtype=torch.bool, device=dev)
    else:
        valid = torch.as_tensor(prompt_valid, device=dev).bool().contiguous()
    cos, sin = su_rope_tables(cfg, l, pids, device=dev) if rope is None else rope
    cos, sin = _rows(cos, b), _rows(sin, b)
    scale = cfg.head_dim**-0.5
    if allow_flash:
        def attend(q, k, v):
            return flash_attention(q, k.contiguous(), v.contiguous(), valid, 0, scale)
    elif l >= BLOCKWISE_MIN_LEN:
        def attend(q, k, v):
            return blockwise_attention(q, k, v, valid, scale)
    else:
        allowed = causal_valid_mask(valid, torch.arange(l, device=dev))

        def attend(q, k, v):
            return masked_attention(q, k, v, allowed, scale)

    dropout = None
    if dropout_rng is not None and lora_dropout > 0.0:
        keep = 1.0 - lora_dropout

        def dropout(layer, path, h):
            mask = lora_dropout_mask(dropout_rng, layer, _PATH_IDS.get(path, 7), h.shape, keep, h.device)
            return mask.to(h.dtype) / keep

    for i in range(cfg.num_hidden_layers):
        x = block(cfg, x, params["model"]["layers"], i, cos, sin, attend, dropout, tp)
    return _head(params, cfg, x, tp=tp)


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
    tp=None,
    write=None,
) -> ForwardResult:
    """Allocate a window of ``L + max_tokens`` positions (or reset ``into``,
    ``engine/state.py:init_state``) and run the prompt, given as ids or as
    ``inputs_embeds``.  ``tp``: a tensor-parallel rank (:func:`decode_forward`;
    the window holds ``cfg``'s KV heads, the rank's); ``write``: the cache
    writer, as in :func:`decode_forward`."""
    lead = inputs_embeds if inputs_embeds is not None else input_ids
    b, l = lead.shape[:2]
    state = init_state(
        cfg, b, l, l + max_tokens, pids=pids, prompt_valid=prompt_valid,
        compute_dtype=torch_dtype(cfg.dtype), device=lead.device, into=into,
    )
    return decode_forward(params, cfg, state, input_ids, inputs_embeds=inputs_embeds,
                          last_logit_only=last_logit_only, tp=tp, write=write)


def prefill_ring(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    mesh,
    *,
    max_tokens: int,
    seq_axis: str = "data",
    pids=None,
    prompt_valid=None,
    last_logit_only: bool = False,
    into: Optional[DecodeState] = None,
    write=None,
) -> ForwardResult:
    """Sequence-parallel prefill (JAX ``prefill_ring``): the prompt (B, L)
    is cut over the ranks of ``seq_axis`` of ``mesh`` (L a multiple of
    their count P; every rank is given the whole prompt), and attention
    runs as ring attention (``parallel/ring_attention.py``) while K/V
    blocks travel between the ranks.  Rank i embeds and runs positions
    ``[i L/P, (i + 1) L/P)`` through every :func:`block`, writing their
    columns of its window (dense, or int4/int8 entries through
    ``quantize_chunk``); then the ranks all-gather the cache columns, so
    that every rank holds the whole window and decodes it as usual, to the
    same tokens.  The JAX package decodes on the L-cut cache instead; a
    sharded decode waits for a machine with more than one card.

    Same contract as :func:`prefill` (``into`` reuses a state's tensors,
    ``write`` writes each rank's columns as in :func:`decode_forward`):
    the logits of the whole prompt, or of its last position
    (``last_logit_only``), on every rank.  Each layer holds its block's
    f32 scores, (B, H, L/P, L/P), while it runs (2.2 GiB at one rank, 4224
    positions and 32 heads)."""
    group = mesh.get_group(seq_axis)
    p, r = dist.get_world_size(group), dist.get_rank(group)
    b, l = input_ids.shape
    if l % p:
        raise ValueError(f"a prompt of {l} positions does not split over {p} ranks of {seq_axis!r}")
    shard = l // p
    cols = slice(r * shard, (r + 1) * shard)
    state = init_state(cfg, b, l, l + max_tokens, pids=pids, prompt_valid=prompt_valid,
                       compute_dtype=torch_dtype(cfg.dtype), device=input_ids.device, into=into)
    ring = make_ring_attention(mesh, seq_axis)
    write = update_layer_chunk if write is None else write
    x = _embed(params, cfg, input_ids[:, cols], None)
    cos, sin = _rows(state.cos[:, cols], b), _rows(state.sin[:, cols], b)
    valid = state.valid[:, cols]
    positions = torch.arange(r * shard, (r + 1) * shard, device=x.device)

    def attend(q, k, v, i):
        write(state, i, positions, k, v)
        return ring(q, k, v, valid)

    for i in range(cfg.num_hidden_layers):
        x = block(cfg, x, params["model"]["layers"], i, cos, sin, functools.partial(attend, i=i))
    logits = _head(params, cfg, x, last_logit_only)
    if p > 1:
        for t in (state.k, state.v, state.k_scales):  # the cache columns, from every rank
            if t is not None:
                parts = [torch.empty_like(t[:, :, :, cols]) for _ in range(p)]
                dist.all_gather(parts, t[:, :, :, cols].contiguous(), group=group)
                for j, part in enumerate(parts):
                    t[:, :, :, j * shard : (j + 1) * shard] = part
        if last_logit_only:  # the last position is the last rank's
            logits = logits.contiguous()
            dist.broadcast(logits, dist.get_global_rank(group, p - 1), group=group)
        else:
            parts = [torch.empty_like(logits) for _ in range(p)]
            dist.all_gather(parts, logits.contiguous(), group=group)
            logits = torch.cat(parts, dim=1)
    state.pos.fill_(l)
    return ForwardResult(logits, dataclasses.replace(state, offset=l))
