"""JAX-package state (as numpy arrays) -> the port's tensors: the parameter
pytree, and the quantized KV cache.

The parity tests use this to make both packages compute the same thing from
one set of weights and one cache.  bf16 arrays leave JAX as ``ml_dtypes.bfloat16``; mixing
those with float32 in numpy silently gives garbage, so every floating array
is cast to float32 at the numpy boundary first, then to the torch dtype (the
bf16 -> f32 -> bf16 round trip is exact).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .weights import LORA_KEYS, prepare_params, torch_dtype


def _to_torch(a, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return torch.from_numpy(np.array(a))  # a writable copy
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def from_numpy_params(tree: dict, cfg: ModelConfig) -> dict:
    """Nested dict of numpy arrays (JAX ``build_params`` structure, plain
    ``(K, N)`` uint8 payloads, or linears already in the flat packed layout)
    -> the port's CPU params (K1 layout; packed leaves kept for K9).  Float
    leaves take ``cfg.dtype``, LoRA leaves (``lora_a``, ``lora_b``,
    ``lora_scale``) stay float32, as in the JAX tree."""
    dt = torch_dtype(cfg.dtype)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _to_torch(node, torch.float32 if key in LORA_KEYS else dt)

    return prepare_params(walk(tree), cfg)


def d_perm(d: int, groups: int) -> np.ndarray:
    """The JAX package's head-dim permutation of its quantized cache: its
    column c holds original dim ``(c % G) * (d // G) + c // G``."""
    c = np.arange(d)
    return (c % groups) * (d // groups) + c // groups


def from_jax_kv_cache(payload, scales, bits: int = 4):
    """A JAX quantized cache (numpy, any leading dims) -> the port's layout.

    JAX: payload (..., D, L) uint8 at 4 bits or (..., 2D, L) at 8 bits (k
    rows over v rows), D permuted by :func:`d_perm`; scales (..., 4G, L).
    Port (``engine/state.py``): payload (..., L, D | 2D) in the original D
    order, scales (..., L, 4G) bf16.
    """
    scales = np.asarray(scales).astype(np.float32)
    rows = np.swapaxes(np.asarray(payload), -1, -2)
    unperm = np.argsort(d_perm(rows.shape[-1] // (1 if bits == 4 else 2), scales.shape[-2] // 4))
    if bits == 4:
        rows = rows[..., unperm]
    else:
        d = rows.shape[-1] // 2
        rows = np.concatenate([rows[..., :d][..., unperm], rows[..., d:][..., unperm]], axis=-1)
    return (torch.from_numpy(np.ascontiguousarray(rows)),
            torch.from_numpy(np.ascontiguousarray(np.swapaxes(scales, -1, -2))).to(torch.bfloat16))


def from_jax_paged_pool(pool_k, pool_v, quantized: bool = False, bits: int = 4,
                        dtype: torch.dtype = torch.float32):
    """A JAX page pool (numpy, with or without the layer axis) -> the port's
    pool (``engine/paging.py``), with the spare page appended.

    JAX dense: pool_k/pool_v (..., P, KV, page, D) -> port k/v (..., P + 1,
    KV, page, D) in ``dtype``.  JAX quantized: pool_k the payload (..., P,
    KV, D | 2D, page), D permuted, pool_v the scales (..., P, KV, 4G, page)
    -> port payload (..., P + 1, KV, page, D | 2D) and scales (..., P + 1,
    KV, page, 4G) bf16 (:func:`from_jax_kv_cache`).  Returns (k, v) or
    (payload, scales); the spare page is zero.
    """
    if quantized:
        a, b = from_jax_kv_cache(pool_k, pool_v, bits)
    else:
        a, b = _to_torch(pool_k, dtype), _to_torch(pool_v, dtype)

    def with_spare(t):
        axis = t.dim() - 4  # the page axis
        spare = t.new_zeros((*t.shape[:axis], 1, *t.shape[axis + 1:]))
        return torch.cat([t, spare], dim=axis).contiguous()

    return with_spare(a), with_spare(b)


def from_numpy_f32_tree(tree, device="cpu"):
    """A tree of numpy arrays (nested dicts, lists and tuples; the JAX GTE
    ``init_gte_params`` / ``load_gte_npz`` tree, the JAX RetNet
    ``init_params`` tree) -> float32 tensors on ``device`` in the same
    structure (``models/gte.py``, ``models/retnet.py``)."""
    if isinstance(tree, dict):
        return {k: from_numpy_f32_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy_f32_tree(v, device) for v in tree]
    return torch.from_numpy(np.asarray(tree).astype(np.float32)).to(device)
