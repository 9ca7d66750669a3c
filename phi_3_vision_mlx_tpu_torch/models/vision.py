"""CLIP ViT vision tower and the Phi-3 image embedding (counterpart of
``phi_3_vision_mlx_tpu/models/vision.py``).

* ViT-L/14-336 with pre-LN blocks and the fast-approximate GELU MLP; the
  features are the **penultimate** layer's, CLS dropped (layers
  ``[: num_hidden_layers - 1]`` run);
* the patch embedding's weight is OHWI over NHWC pixels, as the checkpoint
  stores it; a 14 x 14 stride-14 convolution is a reshape into patches and
  one matmul, which is how it runs here;
* 2 x 2 patch pooling into 4C features, a learned ``sub_GN`` separator after
  every row and ``glb_GN`` between the sub-crops and the global view, then a
  2-layer exact-GELU MLP to the decoder width;
* the image features replace the embeddings of the placeholder ids.

The layers run as a Python loop over ``w[layer]`` views of the stacked
weights (``ops/linear.py:dense_stacked``); their linears have more than 256
rows, so 4-bit leaves take the dequantize + ``torch.matmul`` path.  The JAX
package runs no Pallas kernel in the tower.  Attention keeps the JAX
arithmetic on the CPU (scores, softmax and P V in float32); on a CUDA tensor
it is ``F.scaled_dot_product_attention``, which ``chip_smoke.py`` holds to
that plain version.  The device resize of the raw-image path and the global
view's bicubic are float32 products at full precision, so on the card they
refuse to run with TF32 matmuls allowed.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import ClipVisionConfig, ModelConfig
from ..core.weights import torch_dtype
from ..ops.linear import dense, dense_stacked, embedding, layer_view
from ..ops.norms import layer_norm
from .image_processor import CROP, IMAGE_MEAN, IMAGE_STD, _pil_bilinear_matrix, _resize_matrix, count_tokens

POOL_SIDE = 12  # (336 / 14) / 2: a crop's pooled grid


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_vision_params(cfg: ModelConfig, generator: torch.Generator, dtype=None) -> dict:
    """Random ``vision_embed_tokens`` params in the checkpoint's tree (the
    JAX ``init_vision_params`` law: linears normal with scale ``fan_in **
    -0.5`` and zero bias, the patch and position embeddings 0.02, unit
    LayerNorms, zero CLS and separators), drawn on ``generator``'s device."""
    v = cfg.vision
    dt = dtype or torch_dtype(cfg.dtype)
    dev = generator.device
    e, nl = v.hidden_size, v.num_hidden_layers

    def nrm(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def lin(nin, nout, *lead):
        return {"weight": nrm((*lead, nin, nout), nin**-0.5), "bias": zeros(*lead, nout)}

    def ln(*lead):
        return {"weight": torch.ones((*lead, e), dtype=dt, device=dev), "bias": zeros(*lead, e)}

    c4 = cfg.image_dim_out * 4
    return {
        "img_processor": {
            "vision_model": {
                "embeddings": {
                    "class_embedding": zeros(e),
                    "patch_embedding": {"weight": nrm((e, v.patch_size, v.patch_size, 3), 0.02)},
                    "position_embedding": {"weight": nrm((v.num_positions, e), 0.02)},
                },
                "pre_layrnorm": ln(),  # sic: the checkpoint's key
                "encoder": {"layers": {
                    "self_attn": {name: lin(e, e, nl) for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
                    "layer_norm1": ln(nl),
                    "layer_norm2": ln(nl),
                    "mlp": {"fc1": lin(e, v.intermediate_size, nl), "fc2": lin(v.intermediate_size, e, nl)},
                }},
                "post_layernorm": ln(),
            }
        },
        "glb_GN": zeros(1, 1, c4),
        "sub_GN": zeros(1, 1, 1, c4),
        "img_projection": {"0": lin(c4, cfg.hidden_size), "2": lin(cfg.hidden_size, cfg.hidden_size)},
    }


# ---------------------------------------------------------------------------
# CLIP forward
# ---------------------------------------------------------------------------


def _gelu_fast_approx(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), the sigmoid in float32 cast to ``x.dtype``."""
    return x * torch.sigmoid(1.702 * x.float()).to(x.dtype)


def clip_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """The JAX arithmetic: (B, H, L, D) -> (B, H, L, D) with float32 scores,
    softmax and P V, cast back to ``q.dtype``."""
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _clip_attention(lp: dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, e = x.shape
    d = e // num_heads

    def heads(name):
        return dense(lp[name], x).reshape(b, l, num_heads, d).transpose(1, 2)

    q, k, v = heads("q_proj"), heads("k_proj"), heads("v_proj")
    if x.is_cuda:
        o = F.scaled_dot_product_attention(q, k, v, scale=d**-0.5)
    else:
        o = clip_attention_plain(q, k, v, d**-0.5)
    return dense(lp["out_proj"], o.transpose(1, 2).reshape(b, l, e))


def patch_embed(weight: torch.Tensor, pixels_nhwc: torch.Tensor) -> torch.Tensor:
    """The stride-``P`` ``P`` x ``P`` convolution with an OHWI weight (E, P,
    P, 3) over (N, S, S, 3) pixels, as patches (kh, kw, c) times the
    flattened weight: (N, (S/P)^2, E)."""
    e, p = weight.shape[0], weight.shape[1]
    n, s = pixels_nhwc.shape[0], pixels_nhwc.shape[1]
    g = s // p
    patches = (pixels_nhwc.to(weight.dtype).reshape(n, g, p, g, p, 3)
               .permute(0, 1, 3, 2, 4, 5).reshape(n, g * g, p * p * 3))
    return torch.matmul(patches, weight.reshape(e, -1).t())


def clip_vision_forward(vparams: dict, vcfg: ClipVisionConfig, pixels_nhwc: torch.Tensor) -> torch.Tensor:
    """(N, 336, 336, 3) crops -> (N, 576, C) penultimate-layer patch
    features."""
    vm = vparams["img_processor"]["vision_model"]
    emb = vm["embeddings"]
    x = patch_embed(emb["patch_embedding"]["weight"], pixels_nhwc)
    n = x.shape[0]
    cls = emb["class_embedding"][None, None, :].expand(n, 1, vcfg.hidden_size).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + emb["position_embedding"]["weight"][None]
    eps = vcfg.layer_norm_eps
    x = layer_norm(x, vm["pre_layrnorm"]["weight"], vm["pre_layrnorm"]["bias"], eps)
    layers = vm["encoder"]["layers"]
    for i in range(vcfg.num_hidden_layers - 1):  # the penultimate layer's output
        ln1, ln2 = layer_view(layers["layer_norm1"], i), layer_view(layers["layer_norm2"], i)
        attn = {name: layer_view(leaf, i) for name, leaf in layers["self_attn"].items()}
        h = layer_norm(x, ln1["weight"], ln1["bias"], eps)
        x = x + _clip_attention(attn, h, vcfg.num_attention_heads)
        h = layer_norm(x, ln2["weight"], ln2["bias"], eps)
        h = dense_stacked(layers["mlp"]["fc2"], _gelu_fast_approx(dense_stacked(layers["mlp"]["fc1"], h, i)), i)
        x = x + h
    return x[:, 1:]


# ---------------------------------------------------------------------------
# Image embedding: pooling, separators, projection
# ---------------------------------------------------------------------------


def _project(vparams: dict, x: torch.Tensor) -> torch.Tensor:
    x = dense(vparams["img_projection"]["0"], x)
    return dense(vparams["img_projection"]["2"], F.gelu(x))


def _pool_rows(vparams: dict, feats: torch.Tensor, n: int, rows: int, cols: int) -> torch.Tensor:
    """``n`` crops' (n, 576, C) features -> (1, rows * (cols + 1), 4C): each
    2 x 2 patch block to one 4C vector, the crops laid out as the JAX
    reshape does, ``sub_GN`` after every row."""
    c = feats.shape[-1]
    t = (feats.reshape(n, POOL_SIDE, 2, POOL_SIDE, 2, c).permute(0, 1, 3, 2, 4, 5)
         .reshape(1, rows, cols, 4 * c))
    sub = vparams["sub_GN"].expand(1, rows, 1, 4 * c).to(t.dtype)
    return torch.cat([t, sub], dim=2).reshape(1, -1, 4 * c)


def _assemble(vparams: dict, feats: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """(1 + gh * gw, 576, C) features, the global view first -> (1,
    n_tokens, hidden): ``[sub crops, glb_GN, global view]``, projected."""
    nb = grid_h * grid_w
    glb = _pool_rows(vparams, feats[:1], 1, POOL_SIDE, POOL_SIDE)
    sub = _pool_rows(vparams, feats[1 : nb + 1], nb, grid_h * POOL_SIDE, grid_w * POOL_SIDE)
    x = torch.cat([sub, vparams["glb_GN"].to(sub.dtype), glb], dim=1)
    return _project(vparams, x)


def compute_image_embeds(params: dict, cfg: ModelConfig, pixel_values, image_sizes) -> List[torch.Tensor]:
    """(B, 17, 3, 336, 336) crops (numpy or tensor) -> a (1, n_tokens_i,
    hidden) tensor per image.  Only the global view and the image's own
    crops go through the tower (the JAX package also runs the zero crops
    past them, whose features it drops)."""
    vparams = params["model"]["vision_embed_tokens"]
    dev = params["model"]["embed_tokens"]["weight"].device
    sizes = (np.asarray(image_sizes) // CROP).tolist()
    out = []
    for i, (gh, gw) in enumerate(sizes):
        crops = _on(pixel_values[i][: 1 + gh * gw], dev)
        feats = clip_vision_forward(vparams, cfg.vision, crops.permute(0, 2, 3, 1))
        out.append(_assemble(vparams, feats, gh, gw))
    return out


def _full_precision(x: torch.Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the image resize runs float32 products at full precision: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


@functools.lru_cache(maxsize=64)
def _resize_weights(kind: str, out_size: int, in_size: int, device: torch.device) -> torch.Tensor:
    """A resize's static float32 matrix on ``device``, made once per shape:
    PIL's bilinear (``kind`` "bilinear") or the global view's 2-tap cubic
    ("cubic", to 336)."""
    m = (_pil_bilinear_matrix(out_size, in_size) if kind == "bilinear"
         else _resize_matrix(CROP / in_size, CROP, in_size))
    return torch.from_numpy(m.astype(np.float32)).to(device)


def _on(a, device) -> torch.Tensor:
    """A host array (a writable copy) on ``device``."""
    return torch.from_numpy(np.array(a)).to(device)


def _features_from_hd(vparams: dict, vcfg: ClipVisionConfig, x_hwc: torch.Tensor,
                      grid_h: int, grid_w: int) -> torch.Tensor:
    """CLIP-normalized (H, W, 3) float32 image -> (1, n_tokens, hidden): the
    global 336 x 336 view (the 2-tap cubic as ``G_h @ img @ G_w^T``), the
    crop tiling, the tower, pooling, separators and projection."""
    _full_precision(x_hwc)
    h_px, w_px = grid_h * CROP, grid_w * CROP
    chw = x_hwc.permute(2, 0, 1)
    gh = _resize_weights("cubic", CROP, h_px, x_hwc.device)
    gw = _resize_weights("cubic", CROP, w_px, x_hwc.device)
    glb = torch.matmul(torch.matmul(gh, chw), gw.t())  # (3, 336, 336)
    crops = (chw.reshape(3, grid_h, CROP, grid_w, CROP).permute(1, 3, 0, 2, 4)
             .reshape(-1, 3, CROP, CROP))
    all_crops = torch.cat([glb[None], crops], dim=0)
    feats = clip_vision_forward(vparams, vcfg, all_crops.permute(0, 2, 3, 1))
    return _assemble(vparams, feats, grid_h, grid_w)


def _normalize_u8(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std_inv = 1.0 / torch.tensor(IMAGE_STD, dtype=torch.float32, device=x.device)
    return (x.float() * (1.0 / 255.0) - mean) * std_inv


def device_image_features(vparams: dict, vcfg: ClipVisionConfig, img_u8: torch.Tensor,
                          grid_h: int, grid_w: int) -> torch.Tensor:
    """(H, W, 3) uint8 hd image on the device -> (1, n_tokens, hidden):
    normalize, then :func:`_features_from_hd`."""
    return _features_from_hd(vparams, vcfg, _normalize_u8(img_u8), grid_h, grid_w)


def device_image_features_raw(vparams: dict, vcfg: ClipVisionConfig, orig_u8: torch.Tensor, plan: dict,
                              grid_h: int, grid_w: int) -> torch.Tensor:
    """The image pipeline from the original (H, W, 3) uint8 pixels: PIL's
    bilinear resize as two float32 products (``_pil_bilinear_matrix``), a
    clip to 0-255, white padding above and below, the portrait transposes
    before and after (``plan``: ``Phi3VImageProcessor.resize_plan``), then
    normalize and :func:`_features_from_hd`."""
    _full_precision(orig_u8)
    x = orig_u8.permute(1, 0, 2) if plan["trans"] else orig_u8
    rh, rw, src_h, src_w = plan["rh"], plan["rw"], plan["src_h"], plan["src_w"]
    ph = _resize_weights("bilinear", rh, src_h, x.device)
    pw = _resize_weights("bilinear", rw, src_w, x.device)
    tmp = torch.matmul(ph, x.float().reshape(src_h, src_w * 3)).reshape(rh, src_w, 3)
    resized = torch.matmul(tmp.permute(0, 2, 1), pw.t()).permute(0, 2, 1).clamp(0.0, 255.0)
    padded = F.pad(resized, (0, 0, 0, 0, plan["pad_top"], plan["pad_bot"]), value=255.0)
    if plan["trans"]:
        padded = padded.permute(1, 0, 2)
    return _features_from_hd(vparams, vcfg, _normalize_u8(padded), grid_h, grid_w)


def image_features(params: dict, cfg: ModelConfig, dict_input: dict) -> List[torch.Tensor]:
    """A processor's output -> each image's (1, n_tokens, hidden) features,
    by whichever of its three modes it holds: ``raw_images`` (original
    pixels and resize plans), ``hd_images`` (host-resized) or
    ``pixel_values`` (normalized crops)."""
    vparams = params["model"]["vision_embed_tokens"]
    dev = params["model"]["embed_tokens"]["weight"].device
    sizes = (np.asarray(dict_input["image_sizes"]) // CROP).tolist()
    if dict_input.get("raw_images") is not None:
        return [device_image_features_raw(vparams, cfg.vision, _on(img, dev), plan, gh, gw)
                for img, plan, (gh, gw) in zip(dict_input["raw_images"], dict_input["resize_plans"], sizes)]
    if dict_input.get("hd_images") is not None:
        return [device_image_features(vparams, cfg.vision, _on(img, dev), gh, gw)
                for img, (gh, gw) in zip(dict_input["hd_images"], sizes)]
    return compute_image_embeds(params, cfg, dict_input["pixel_values"], dict_input["image_sizes"])


def compute_inputs_embeds(params: dict, cfg: ModelConfig, dict_input: dict, ids=None) -> torch.Tensor:
    """The prompt's embeddings with each image's features written over its
    run of placeholders (which read as id 0), from any of the processor's
    three modes (:func:`image_features`).  ``ids``: the prompt's ids
    left-padded to the engine's bucket (default: as the processor gave
    them); the features then shift right by the pad."""
    dev = params["model"]["embed_tokens"]["weight"].device
    given = np.asarray(dict_input["input_ids"])
    ids = given if ids is None else np.asarray(ids)
    shift = ids.shape[1] - given.shape[1]
    embeds = embedding(params["model"]["embed_tokens"], torch.as_tensor(np.maximum(ids, 0), device=dev),
                       dtype=torch_dtype(cfg.dtype))
    positions, idx = np.asarray(dict_input["positions"]), 0
    for f in image_features(params, cfg, dict_input):
        row, col = int(positions[idx][0]), int(positions[idx][1]) + shift
        embeds[row, col : col + f.shape[1]] = f[0].to(embeds.dtype)
        idx += f.shape[1]
    return embeds


def image_token_count(dict_input: dict) -> int:
    """Image tokens of a processor's output."""
    return sum(count_tokens(h, w) for h, w in np.asarray(dict_input["image_sizes"]).tolist())
