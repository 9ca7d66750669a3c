"""Masked GQA attention — the plain path
(counterpart of ``phi_3_vision_mlx_tpu/ops/attention.py``).

Masks are derived from three integer facts — the cache write offset, the
per-key validity bits and the causal rule ``key_pos <= query_pos`` — never
materialized as a window-sized additive mask.  Masked scores take the finite
``NEG_INF`` of the JAX package, so a fully masked row comes out as a uniform
average of the values, never NaN.  Softmax math is float32.  This is the
plain counterpart of kernels K2 and K3 and what runs on the CPU.
:func:`blockwise_attention` is the differentiable causal path of
O(L * block) memory that training takes on long sequences (K2 is
forward-only).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def masked_attention(q, k, v, allowed, scale: float):
    """softmax((q * scale) @ k^T, masked by ``allowed``) @ v.

    q (B, H, Lq, D); k, v (B, KV, Lk, D); ``allowed`` bool, broadcastable to
    (B, 1, Lq, Lk).  Returns (B, H, Lq, D) in ``q.dtype``.
    """
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    g = h // kvh
    qg = (q * scale).reshape(b, kvh, g, lq, d).float()
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2))  # (B, KV, g, Lq, Lk)
    s = s.reshape(b, h, lq, lk)
    s = s.masked_fill(~allowed, NEG_INF)  # a scalar: no host-to-device copy in a captured step
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.reshape(b, kvh, g, lq, lk), v.float()[:, :, None])
    return o.reshape(b, h, lq, d).to(q.dtype)


def causal_valid_mask(valid, q_pos):
    """(B, 1, Lq, Lk) bool: key ``j`` visible from query ``i`` iff
    ``j <= q_pos[i]`` and ``valid[b, j]``."""
    key_pos = torch.arange(valid.shape[1], device=valid.device)
    causal = key_pos[None, :] <= q_pos[:, None]
    return causal[None, None] & valid[:, None, None, :]


def decode_attention(q, k_cache, v_cache, valid, q_pos, scale: float):
    """Attention of a small query chunk against the whole cache window.

    k_cache/v_cache (B, KV, Lmax, D) with the new keys already written;
    valid (B, Lmax) bool; q_pos (Lq,) absolute query positions.
    """
    return masked_attention(q, k_cache, v_cache, causal_valid_mask(valid, q_pos), scale)


def prefill_attention(q, k, v, valid, scale: float):
    """Causal self-attention over a fresh prompt chunk: q (B, H, L, D); k, v
    (B, KV, L, D); valid (B, L) bool, False at left-pad positions.  Returns
    (B, H, L, D) in ``q.dtype``."""
    return masked_attention(q, k, v, causal_valid_mask(valid, torch.arange(q.shape[2], device=q.device)), scale)


def _blockwise_rows(q_blk, k, v, valid, q0: int, k_block: int, scale: float):
    """One query block's online softmax over the key blocks (float32)."""
    b, h, qb, d = q_blk.shape
    q_pos = q0 + torch.arange(qb, device=q_blk.device)
    qs = (q_blk * scale).float()
    m_run = torch.full((b, h, qb), NEG_INF, dtype=torch.float32, device=q_blk.device)
    l_run = torch.zeros((b, h, qb), dtype=torch.float32, device=q_blk.device)
    acc = torch.zeros((b, h, qb, d), dtype=torch.float32, device=q_blk.device)
    for k0 in range(0, k.shape[2], k_block):
        key_pos = k0 + torch.arange(k_block, device=q_blk.device)
        ok = (key_pos[None, :] <= q_pos[:, None])[None, None] & valid[:, None, None, k0:k0 + k_block]
        s = torch.matmul(qs, k[:, :, k0:k0 + k_block].float().transpose(-1, -2))
        s = s.masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = alpha * l_run + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, v[:, :, k0:k0 + k_block].float())
        m_run = m_new
    l_run = torch.where(l_run == 0.0, torch.ones_like(l_run), l_run)
    return acc / l_run[..., None]


def blockwise_attention(q, k, v, valid, scale: float, q_block: int = 512, k_block: int = 1024):
    """Causal self-attention over a fresh chunk with O(L * block) memory,
    differentiable (JAX ``blockwise_attention``): for each query block an
    online softmax over the key blocks, its body recomputed in the backward
    (``torch.utils.checkpoint``) instead of keeping every score tile.

    q (B, H, L, D); k, v (B, KV, L, D); valid (B, L) bool.  The blocks
    halve until they divide L.  Returns (B, H, L, D) in ``q.dtype``.
    """
    b, h, l, d = q.shape
    if k.shape[1] != h:  # expand GQA heads once, as the JAX version does
        k = k.repeat_interleave(h // k.shape[1], dim=1)
        v = v.repeat_interleave(h // v.shape[1], dim=1)
    q_block, k_block = min(q_block, l), min(k_block, l)
    while l % q_block:
        q_block //= 2
    while l % k_block:
        k_block //= 2
    # The block draws no random number, so the recomputation needs no RNG
    # state: the default (preserve_rng_state) reads the CUDA generator's,
    # which a captured training step must not.
    blocks = [checkpoint(_blockwise_rows, q[:, :, q0:q0 + q_block], k, v, valid, q0, k_block, scale,
                         use_reentrant=False, preserve_rng_state=False)
              for q0 in range(0, l, q_block)]
    return torch.cat(blocks, dim=2).to(q.dtype)
