"""JAX-package parameter pytree (as numpy arrays) -> the port's params.

The parity tests use this to make both packages compute the same thing from
one set of weights.  bf16 arrays leave JAX as ``ml_dtypes.bfloat16``; mixing
those with float32 in numpy silently gives garbage, so every floating array
is cast to float32 at the numpy boundary first, then to the torch dtype (the
bf16 -> f32 -> bf16 round trip is exact).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .weights import prepare_params, torch_dtype


def _to_torch(a, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return torch.from_numpy(np.array(a))  # a writable copy
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def from_numpy_params(tree: dict, cfg: ModelConfig) -> dict:
    """Nested dict of numpy arrays (JAX ``build_params`` structure, plain
    ``(K, N)`` uint8 payloads) -> the port's CPU params (K1 layout)."""
    dt = torch_dtype(cfg.dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_torch(node, dt)

    return prepare_params(walk(tree), cfg)
