"""LoRA leaves on the stacked-layer params tree (counterpart of
``phi_3_vision_mlx_tpu/train/lora.py``).

The reference wraps the named linears (default ``self_attn.qkv_proj``) of the
last N (or the listed) decoder layers with ``y + scale * (x @ A) @ B``, A
drawn from U(-1/sqrt(K), 1/sqrt(K)) and B = 0.  The layer subtree is
stacked along a leading layer axis, so the LoRA leaves are stacked too:
every layer carries (A, B), inactive layers keep A = B = 0 (an exact no-op)
and the trainer masks their gradients with ``layer_mask`` (and detaches
them, :func:`active_layers`, so that the backward stops at the lowest
active layer).  On save only
the active layers are written, in the reference's per-layer key format
(``model.layers.N.<target>.lora_a``), which both packages read.

The logical (K, N) of a target comes from its leaf: a full-precision
``weight (nl, K, N)``; a word layout's ``qweight (nl, K/8 | K/4, N)`` (K from
the word count at the model's bits, ``core/weights.py:LAYOUTS``); a flat
packed ``weight (nl, K, N/2)``, whose N comes from the scales.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..core.config import ModelConfig
from ..core.weights import LAYOUTS, is_packed_leaf


def _resolve_layers(lora_layers, num_layers: int) -> List[int]:
    if isinstance(lora_layers, int):
        return list(range(num_layers - lora_layers, num_layers))
    if isinstance(lora_layers, (list, tuple)):
        return list(lora_layers)
    raise ValueError(
        "Invalid type for lora_layers. Expected int (number of layers) or "
        "list (layer indices)."
    )


def _target(layers: dict, target: str) -> dict:
    node = layers
    for part in target.split("."):
        node = node[part]
    return node


def _logical_kn(node: dict, cfg: ModelConfig) -> Tuple[int, int]:
    """(K, N) of a stacked linear leaf, whatever its layout."""
    if "qweight" in node:
        return node["qweight"].shape[1] * LAYOUTS[cfg.quantized.bits][0], node["qweight"].shape[-1]
    if is_packed_leaf(node):
        return node["weight"].shape[1], node["scales"].shape[-1]
    return node["weight"].shape[1], node["weight"].shape[2]


def inject_lora(
    params: dict,
    cfg: ModelConfig,
    lora_targets: List[str],
    lora_layers,
    rank: int,
    generator: torch.Generator,
    alpha: float = None,
    scale: float = 1.0,
    dropout: float = 0.0,
) -> Tuple[dict, torch.Tensor]:
    """Add stacked float32 LoRA leaves to the targeted linears of ``params``
    (in place, as the JAX package does) on their weights' device.  A is
    drawn on ``generator`` (a CPU generator gives the same A for a model on
    any device), then zeroed outside the active layers.

    Returns (params, layer_mask): ``layer_mask`` (num_layers,) float32, 1.0
    at the trainable layers.  ``dropout`` is the trainer's business
    (``forward_nocache``), as in the JAX package.
    """
    del dropout
    alpha = rank if alpha is None else alpha
    eff_scale = scale * (alpha / rank)
    nl = cfg.num_hidden_layers
    mask = torch.zeros((nl,), dtype=torch.float32)
    mask[_resolve_layers(lora_layers, nl)] = 1.0
    for target in lora_targets:
        node = _target(params["model"]["layers"], target)
        kdim, ndim = _logical_kn(node, cfg)
        device = next(v.device for v in node.values() if torch.is_tensor(v))
        bound = 1.0 / kdim**0.5
        a = (torch.rand((nl, kdim, rank), generator=generator, device=generator.device) * 2 - 1) * bound
        node["lora_a"] = (a * mask.to(a.device)[:, None, None]).to(device)
        node["lora_b"] = torch.zeros((nl, rank, ndim), dtype=torch.float32, device=device)
        node["lora_scale"] = torch.full((nl,), eff_scale, dtype=torch.float32, device=device)
    return params, mask


def partition_lora(params: dict) -> Tuple[dict, dict]:
    """Split the tree into (trainable LoRA leaves, frozen rest): the same
    nested structure, disjoint leaves, the same tensors."""

    def walk(node):
        train: dict = {}
        frozen: dict = {}
        for k, v in node.items():
            if k in ("lora_a", "lora_b"):
                train[k] = v
            elif isinstance(v, dict):
                t, f = walk(v)
                if t:
                    train[k] = t
                frozen[k] = f
            else:
                frozen[k] = v
        return train, frozen

    return walk(params)


def merge_lora(frozen: dict, trainable: dict) -> dict:
    """Inverse of :func:`partition_lora` (new dicts; the inputs are not
    changed)."""
    if not trainable:
        return frozen
    out = dict(frozen)
    for k, v in trainable.items():
        out[k] = merge_lora(frozen.get(k, {}), v) if isinstance(v, dict) else v
    return out


def lora_leaves(tree: dict) -> List[torch.Tensor]:
    """The tensors of a (trainable) tree, in a fixed order."""
    out: List[torch.Tensor] = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(lora_leaves(v) if isinstance(v, dict) else [v])
    return out


def active_layers(trainable: dict, layer_mask) -> dict:
    """``trainable`` with each stacked leaf as the list of its layers'
    views, the inactive layers' detached (``layer_view``'s ``v[layer]``
    reads a list as it reads a tensor).  The loss is the same and so are
    the gradients the trainer keeps: an inactive layer's A and B are 0 and
    its gradients are masked to 0.  But with every layer's leaves taking a
    gradient the backward runs through every layer below the lowest active
    one, dequantizing each weight again; with the inactive ones detached it
    stops there.  ``layer_mask``: a tensor, or its values as a list (a
    captured step reads no tensor on the host)."""
    values = layer_mask.tolist() if torch.is_tensor(layer_mask) else layer_mask
    active = [m > 0 for m in values]

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return [node[i] if a else node[i].detach() for i, a in enumerate(active)]

    return walk(trainable)


def mask_lora_grads(grads, layer_mask: torch.Tensor):
    """Gradients (a tree or one tensor, the layer axis leading) with the
    inactive layers zeroed."""
    if isinstance(grads, dict):
        return {k: mask_lora_grads(v, layer_mask) for k, v in grads.items()}
    return grads * layer_mask.to(grads.device).reshape((-1,) + (1,) * (grads.dim() - 1))


def adapter_flat_dict(params: dict, layer_mask, lora_targets: List[str]) -> Dict[str, torch.Tensor]:
    """The trained leaves in the reference adapter key format (active layers
    only), float32 CPU tensors for ``core/weights.py:save_safetensors``."""
    flat: Dict[str, torch.Tensor] = {}
    active = [i for i, m in enumerate(torch.as_tensor(layer_mask).tolist()) if m > 0]
    for target in lora_targets:
        node = _target(params["model"]["layers"], target)
        for i in active:
            for field in ("lora_a", "lora_b"):
                flat[f"model.layers.{i}.{target}.{field}"] = node[field][i].detach().float().cpu().contiguous()
    return flat
