"""The Phi-3 decoder in float32, from the checkpoint-format weights.

Published description (Phi-3 technical report; the model's
``modeling_phi3.py``): token embedding; per layer RMSNorm, a fused qkv
projection, rotary embedding of the first and second halves of each head
(rotate-half), causal softmax attention with scale ``head_dim ** -0.5``,
the output projection and a residual; RMSNorm, a fused gate-up projection,
``silu(gate) * up``, the down projection and a residual; a final RMSNorm
and the untied lm_head.  Rotary embedding with LongRoPE ("su") scaling:
``inv_freq = 1 / (factor * theta ** (2i / d))`` with the long factors when
the sequence is longer than ``original_max_position_embeddings`` and the
short ones otherwise, cos and sin multiplied by ``sqrt(1 + ln(max / orig)
/ ln(orig))``.  Every served sequence and window here is at most 4096
positions, so the short factors apply on both sides (the system chooses by
its serving window).

Weights: ``w = scale * q + bias`` per group of 64 along K (the embedding
table along its width), computed in float32.  Linear inputs pass through
``act``, which is the identity for the reference and rounds to the
control's lower precision for the control.

Everything runs layer by layer over all the sequences, so that only one
layer's float32 weights (450 MB at Phi-3.5-mini's widths) are held, and
attention runs in blocks of queries.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

QUERY_BLOCK = 512


def dequantize(p: dict) -> torch.Tensor:
    """(K, N) float32 of a quantized linear leaf (``weight``, ``scales``,
    ``biases``)."""
    q = p["weight"].float()
    k, n = q.shape[-2:]
    g = p["scales"].shape[-2]
    w = q.reshape(*q.shape[:-2], g, k // g, n) * p["scales"].float().unsqueeze(-2) \
        + p["biases"].float().unsqueeze(-2)
    return w.reshape(*q.shape)


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    q = p["weight"][ids].float()
    s, b = p["scales"][ids].float(), p["biases"][ids].float()
    n, e = q.shape
    g = s.shape[-1]
    return (q.reshape(n, g, e // g) * s[..., None] + b[..., None]).reshape(n, e)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(cfg: dict, length: int, device):
    d = cfg["hidden_size"] // cfg["num_attention_heads"]
    orig, top = cfg["original_max_position_embeddings"], cfg["max_position_embeddings"]
    rs = cfg["rope_scaling"]
    factors = torch.tensor(rs["long_factor"] if length > orig else rs["short_factor"],
                           dtype=torch.float32, device=device)
    mult = math.sqrt(1 + math.log(top / orig) / math.log(orig))
    inv = 1.0 / (factors * cfg["rope_theta"] ** (torch.arange(0, d, 2, device=device).float() / d))
    f = torch.arange(length, device=device).float()[:, None] * inv[None]
    f = torch.cat([f, f], dim=-1)
    return f.cos() * mult, f.sin() * mult


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _attention(q, k, v):
    """Causal attention, (H, L, D) each, in blocks of queries."""
    length, scale = q.shape[1], q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    for s in range(0, length, QUERY_BLOCK):
        e = min(s + QUERY_BLOCK, length)
        scores = (q[:, s:e] * scale) @ k[:, :e].transpose(-1, -2)
        mask = torch.arange(e, device=q.device)[None] > torch.arange(s, e, device=q.device)[:, None]
        out[:, s:e] = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1) @ v[:, :e]
    return out


def logits(cfg: dict, params: dict, inputs: list, act=lambda t: t) -> list:
    """``inputs``: (x (L, E) float32 embeddings, first) per sequence; the
    logits (L - first, V) of positions ``first`` onward of each."""
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    e = cfg["hidden_size"]
    d, eps = e // h, cfg["rms_norm_eps"]
    lay = params["model"]["layers"]
    xs = [x for x, _ in inputs]
    tables = [rope(cfg, x.shape[0], x.device) for x in xs]
    for i in range(cfg["num_hidden_layers"]):
        w = {name: dequantize({k: t[i] for k, t in leaf.items()})
             for name, leaf in (("qkv", lay["self_attn"]["qkv_proj"]), ("o", lay["self_attn"]["o_proj"]),
                                ("gate_up", lay["mlp"]["gate_up_proj"]), ("down", lay["mlp"]["down_proj"]))}
        for j, (x, (cos, sin)) in enumerate(zip(xs, tables)):
            n = x.shape[0]
            qkv = act(rms(x, lay["input_layernorm"]["weight"][i], eps)) @ w["qkv"]
            q = qkv[:, : h * d].reshape(n, h, d).transpose(0, 1)
            k = qkv[:, h * d: (h + kv) * d].reshape(n, kv, d).transpose(0, 1)
            v = qkv[:, (h + kv) * d:].reshape(n, kv, d).transpose(0, 1)
            q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
            if kv != h:
                k, v = k.repeat_interleave(h // kv, 0), v.repeat_interleave(h // kv, 0)
            o = _attention(q, k, v).transpose(0, 1).reshape(n, h * d)
            x = x + act(o) @ w["o"]
            gate, up = (act(rms(x, lay["post_attention_layernorm"]["weight"][i], eps)) @ w["gate_up"]).chunk(2, -1)
            xs[j] = x + act(F.silu(gate) * up) @ w["down"]
        del w
    head = dequantize(params["lm_head"])
    return [act(rms(x[first:], params["model"]["norm"]["weight"], eps)) @ head
            for x, (_, first) in zip(xs, inputs)]
