"""Architecture registry (counterpart of
``phi_3_vision_mlx_tpu/core/registry.py``): architecture name -> processor
class, with the JAX package's prefix match."""

from __future__ import annotations


def _proc_text():
    from ..models.preprocess import Phi3Processor

    return Phi3Processor


def _proc_vision():
    from ..models.preprocess import Phi3VProcessor

    return Phi3VProcessor


_REGISTRY = {
    "Phi3ForCausalLM": _proc_text,
    "Phi3VForCausalLM": _proc_vision,
}


def processor_for(architecture: str):
    """The processor class of ``architecture`` (exact name, else the first
    entry sharing its first five characters)."""
    if architecture in _REGISTRY:
        return _REGISTRY[architecture]()
    for name, factory in _REGISTRY.items():
        if architecture.startswith(name[:5]):
            return factory()
    raise KeyError(f"unknown architecture: {architecture}")
