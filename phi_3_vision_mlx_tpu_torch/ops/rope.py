"""Su-scaled (LongRoPE) rotary embeddings
(counterpart of ``phi_3_vision_mlx_tpu/ops/rope.py``).

The long factors apply when the whole window (prompt + new tokens) exceeds
``original_max_position_embeddings``, else the short ones; the tables are
computed once per generation for the whole window, in float32, with
per-row position ids (``pids``) for left-padded batches.
"""

from __future__ import annotations

import math

import torch

from ..core.config import ModelConfig


def su_rope_tables(cfg: ModelConfig, l_all: int, pids=None, device=None):
    """(cos, sin), each float32 (B, l_all, head_dim); B = 1 without ``pids``.

    ``pids``: optional (B, L_prompt) int position ids; positions past the
    prompt continue each row's count.
    """
    dim = cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.rope_scaling is not None and cfg.rope_scaling.long_factor:
        orig = cfg.original_max_position_embeddings
        scaling = math.sqrt(1.0 + math.log(cfg.max_position_embeddings / orig) / math.log(orig))
        su = cfg.rope_scaling.long_factor if l_all > orig else cfg.rope_scaling.short_factor
        su_factor = torch.tensor(su, **f32)
    else:
        scaling = 1.0
        su_factor = torch.ones(dim // 2, **f32)
    if pids is None:
        position_ids = torch.arange(l_all, **f32)[None]
    else:
        pids = torch.as_tensor(pids).to(**f32)
        ext = pids[:, -1:] + 1.0 + torch.arange(l_all - pids.shape[1], **f32)[None]
        position_ids = torch.cat([pids, ext], dim=1)
    exponent = torch.arange(0, dim, 2, **f32) / dim
    inv_freq = 1.0 / (su_factor * torch.pow(torch.tensor(cfg.rope_theta, **f32), exponent))
    freqs = position_ids[:, :, None] * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * scaling, torch.sin(emb) * scaling


def su_rope_tables_np(cfg: ModelConfig, l_all: int, pids=None):
    """NumPy twin of :func:`su_rope_tables` (on the CPU) for host-side
    precompute."""
    cos, sin = su_rope_tables(cfg, l_all, pids, device="cpu")
    return cos.numpy(), sin.numpy()


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE.  x (B, H, L, D); cos/sin float32 (B, L, D)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    out = x.float() * cos[:, None] + rotated.float() * sin[:, None]
    return out.to(x.dtype)
