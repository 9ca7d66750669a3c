"""Masked GQA attention — the plain path
(counterpart of ``phi_3_vision_mlx_tpu/ops/attention.py``).

Masks are derived from three integer facts — the cache write offset, the
per-key validity bits and the causal rule ``key_pos <= query_pos`` — never
materialized as a window-sized additive mask.  Masked scores take the finite
``NEG_INF`` of the JAX package, so a fully masked row comes out as a uniform
average of the values, never NaN.  Softmax math is float32.  This is the
plain counterpart of kernels K2 and K3 and what runs on the CPU.
"""

from __future__ import annotations

import torch

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
