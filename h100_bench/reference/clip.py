"""Phi-3.5-vision's image embedding in float32: the CLIP ViT-L/14-336 tower
and the HD projection, from the checkpoint-format weights.

Published description (CLIP; the Phi-3-vision model card and modeling
code): a 14 x 14 stride-14 patch convolution without bias, a class token
and learned positions, a pre-LayerNorm, pre-LN blocks (LayerNorm,
16-head attention with biased projections, residual; LayerNorm, an MLP
with quick-GELU ``x * sigmoid(1.702 x)``, residual); the features are the
penultimate layer's output (``hidden_states[-2]``: all layers but the
last), class token dropped.  Each crop's 24 x 24 grid is pooled by 2 x 2
into 12 x 12 vectors of 4C (channels ordered row offset, column offset,
channel); the sub-crops form the HD grid with a learned separator
``sub_GN`` after every row, then ``glb_GN``, then the global view with its
own separators; a Linear - GELU (exact) - Linear projection maps 4C to the
decoder width.

Departure, shared with the system under test: the sub-crops' pooled
vectors are laid into the ``rows * 12`` by ``cols * 12`` grid by a plain
reshape in crop order, as the MLX framework does, where Hugging Face's
``reshape_hd_patches_2x2merge`` interleaves the crops' rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .decoder import dequantize

POOL = 12


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps)


def _linear(p: dict, x: torch.Tensor, i=None) -> torch.Tensor:
    w = dequantize({k: (v if i is None else v[i]) for k, v in p.items() if k != "bias"})
    b = p["bias"] if i is None else p["bias"][i]
    return x @ w + b.float()


def tower(vp: dict, vcfg: dict, pixels: torch.Tensor, act=lambda t: t) -> torch.Tensor:
    """(N, 3, 336, 336) crops -> (N, 576, C) penultimate-layer features.
    ``act`` rounds each linear's input (the control's lower precision)."""
    vm = vp["img_processor"]["vision_model"]
    emb = vm["embeddings"]
    w = emb["patch_embedding"]["weight"].float().permute(0, 3, 1, 2)  # OHWI -> OIHW
    x = F.conv2d(pixels, w, stride=vcfg["patch_size"]).flatten(2).transpose(1, 2)
    n, e = x.shape[0], x.shape[2]
    cls = emb["class_embedding"].float().expand(n, 1, e)
    x = torch.cat([cls, x], dim=1) + emb["position_embedding"]["weight"].float()
    eps = vcfg.get("layer_norm_eps", 1e-5)
    x = _ln(x, vm["pre_layrnorm"], eps)
    layers = vm["encoder"]["layers"]
    heads = vcfg["num_attention_heads"]
    d = e // heads
    for i in range(vcfg["num_hidden_layers"] - 1):
        at = layers["self_attn"]
        h = act(_ln(x, {k: v[i] for k, v in layers["layer_norm1"].items()}, eps))

        def split(name):
            return _linear(at[name], h, i).reshape(n, -1, heads, d).transpose(1, 2)

        q, k, v = split("q_proj"), split("k_proj"), split("v_proj")
        p = torch.softmax((q * d**-0.5) @ k.transpose(-1, -2), dim=-1)
        o = (p @ v).transpose(1, 2).reshape(n, -1, e)
        x = x + _linear(at["out_proj"], act(o), i)
        h = act(_ln(x, {k: v[i] for k, v in layers["layer_norm2"].items()}, eps))
        h = _linear(layers["mlp"]["fc1"], h, i)
        h = h * torch.sigmoid(1.702 * h)
        x = x + _linear(layers["mlp"]["fc2"], act(h), i)
    return x[:, 1:]


def _hd(vp: dict, feats: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    n, _, c = feats.shape
    pooled = (feats.reshape(n, POOL, 2, POOL, 2, c).permute(0, 1, 3, 2, 4, 5)
              .reshape(rows * POOL, cols * POOL, 4 * c))
    sep = vp["sub_GN"].float().reshape(1, 1, 4 * c).expand(rows * POOL, 1, 4 * c)
    return torch.cat([pooled, sep], dim=1).reshape(-1, 4 * c)


def image_embedding(vp: dict, vcfg: dict, all_crops: torch.Tensor, rows: int, cols: int,
                    act=lambda t: t) -> torch.Tensor:
    """Global view and crops -> (image tokens, decoder width)."""
    feats = tower(vp, vcfg, all_crops, act)
    x = torch.cat([_hd(vp, feats[1:], rows, cols), vp["glb_GN"].float().reshape(1, -1),
                   _hd(vp, feats[:1], 1, 1)])
    x = F.gelu(_linear(vp["img_projection"]["0"], act(x)))
    return _linear(vp["img_projection"]["2"], act(x))
