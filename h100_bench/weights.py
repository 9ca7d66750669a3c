"""Seeded weights in the checkpoint format the two packages share, made on
the device: each quantized linear a plain ``(K, N)`` uint8 payload of
4-bit levels with bf16 scales and biases ``(K / 64, N)`` (affine,
``w = scale * q + bias``), stacked over layers; every other leaf in
bf16, the type it is served in.

The same seed gives the same tensors bit for bit, so the program is handed
them once and the reference makes them again after the window, from the
seed, instead of holding a second copy through the run.  Each leaf draws
from its own generator (the seed and the leaf's index), in a few large
calls: one per stacked leaf.

Laws: levels uniform on 0..15, scales ``0.004 * (1 + 0.1 N)``, biases
``-7.5 * scale + 0.002 N`` (zero-mean weights of about +-0.03), both bf16; norms
``1 + 0.1 N``; float biases, separators and embeddings ``0.02 N``.  The
norms, biases and separators are random, not ones and zeros, so that a
program that skipped one would read wrong.
"""

from __future__ import annotations

import torch

GROUP = 64


class _Leaves:
    def __init__(self, seed: int, device, dtype):
        self.seed, self.device, self.dtype, self.index = int(seed), torch.device(device), dtype, 0

    def gen(self) -> torch.Generator:
        self.index += 1
        return torch.Generator(device=self.device).manual_seed(
            (self.seed * 4096 + self.index) % (2**63))

    def normal(self, shape, scale: float, shift: float = 0.0) -> torch.Tensor:
        g = self.gen()
        return (shift + scale * torch.randn(shape, generator=g, device=self.device)).to(self.dtype)

    def linear(self, *lead, k: int, n: int, bias: bool = False) -> dict:
        g = self.gen()
        q = torch.randint(0, 16, (*lead, k, n), dtype=torch.uint8, generator=g, device=self.device)
        s = 0.004 * (1.0 + 0.1 * torch.randn((*lead, k // GROUP, n), generator=g, device=self.device))
        b = -7.5 * s + 0.002 * torch.randn(s.shape, generator=g, device=self.device)
        out = {"weight": q, "scales": s.to(torch.bfloat16), "biases": b.to(torch.bfloat16)}
        if bias:
            out["bias"] = self.normal((*lead, n), 0.02)
        return out


def checkpoint(cfg: dict, seed: int, device) -> dict:
    """The params tree of a 4-bit checkpoint of ``cfg`` (a configuration
    file's dict) from ``seed``, on ``device``; the float leaves in bf16,
    the type they are served in."""
    w = _Leaves(seed, device, torch.bfloat16)
    e, inter, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    h, kv, nl = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["num_hidden_layers"]
    d = e // h
    g = w.gen()  # the table's groups run along E, not along K
    embed = {"weight": torch.randint(0, 16, (v, e), dtype=torch.uint8, generator=g, device=w.device)}
    s = 0.004 * (1.0 + 0.1 * torch.randn((v, e // GROUP), generator=g, device=w.device))
    embed["scales"] = s.to(torch.bfloat16)
    embed["biases"] = (-7.5 * s + 0.002 * torch.randn(s.shape, generator=g, device=w.device)).to(torch.bfloat16)
    params = {
        "model": {
            "embed_tokens": embed,
            "layers": {
                "self_attn": {"qkv_proj": w.linear(nl, k=e, n=(h + 2 * kv) * d),
                              "o_proj": w.linear(nl, k=h * d, n=e)},
                "mlp": {"gate_up_proj": w.linear(nl, k=e, n=2 * inter),
                        "down_proj": w.linear(nl, k=inter, n=e)},
                "input_layernorm": {"weight": w.normal((nl, e), 0.1, 1.0)},
                "post_attention_layernorm": {"weight": w.normal((nl, e), 0.1, 1.0)},
            },
            "norm": {"weight": w.normal((e,), 0.1, 1.0)},
        },
        "lm_head": w.linear(k=e, n=v),
    }
    if cfg.get("vision_config"):
        params["model"]["vision_embed_tokens"] = _tower(cfg, w)
    return params


def _tower(cfg: dict, w: _Leaves) -> dict:
    vc = cfg["vision_config"]
    e, nl, inter, p = vc["hidden_size"], vc["num_hidden_layers"], vc["intermediate_size"], vc["patch_size"]
    positions = (vc["image_size"] // p) ** 2 + 1
    c4 = 4 * cfg["img_processor"]["image_dim_out"]
    hidden = cfg["hidden_size"]

    def ln(*lead):
        return {"weight": w.normal((*lead, e), 0.1, 1.0), "bias": w.normal((*lead, e), 0.02)}

    return {
        "img_processor": {"vision_model": {
            "embeddings": {
                "class_embedding": w.normal((e,), 0.02),
                "patch_embedding": {"weight": w.normal((e, p, p, 3), 0.02)},
                "position_embedding": {"weight": w.normal((positions, e), 0.02)},
            },
            "pre_layrnorm": ln(),
            "encoder": {"layers": {
                "self_attn": {name: w.linear(nl, k=e, n=e, bias=True)
                              for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
                "layer_norm1": ln(nl),
                "layer_norm2": ln(nl),
                "mlp": {"fc1": w.linear(nl, k=e, n=inter, bias=True),
                        "fc2": w.linear(nl, k=inter, n=e, bias=True)},
            }},
            "post_layernorm": ln(),
        }},
        "glb_GN": w.normal((1, 1, c4), 0.02),
        "sub_GN": w.normal((1, 1, 1, c4), 0.02),
        "img_projection": {"0": w.linear(k=c4, n=hidden, bias=True),
                           "2": w.linear(k=hidden, n=hidden, bias=True)},
    }
