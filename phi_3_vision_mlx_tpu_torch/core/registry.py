"""Architecture registry (counterpart of
``phi_3_vision_mlx_tpu/core/registry.py``): a declarative table in place of
the reference's ``eval(model_arch)`` dispatch, architecture name -> (has
vision, processor class factory), with the JAX package's prefix match and
its extension point :func:`register`."""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple


class ArchEntry(NamedTuple):
    name: str
    has_vision: bool
    processor: Callable


def _proc_text():
    from ..models.preprocess import Phi3Processor

    return Phi3Processor


def _proc_vision():
    from ..models.preprocess import Phi3VProcessor

    return Phi3VProcessor


_REGISTRY: Dict[str, dict] = {
    "Phi3ForCausalLM": {"has_vision": False, "processor": _proc_text},
    "Phi3VForCausalLM": {"has_vision": True, "processor": _proc_vision},
}


def register(architecture: str, *, has_vision: bool, processor_factory):
    """Register an architecture (the extension point for new model
    families): ``processor_factory()`` returns its processor class."""
    _REGISTRY[architecture] = {"has_vision": has_vision, "processor": processor_factory}


def lookup(architecture: str) -> dict:
    """The entry of ``architecture``: the exact name, else the first entry
    sharing its name's first five characters (the reference's ``arch[:5]``
    dispatch); ``KeyError`` for an unknown one."""
    if architecture in _REGISTRY:
        return _REGISTRY[architecture]
    for name, entry in _REGISTRY.items():
        if architecture.startswith(name[:5]):
            return entry
    raise KeyError(f"unknown architecture: {architecture}")


def processor_for(architecture: str):
    """The processor class of ``architecture`` (:func:`lookup`)."""
    return lookup(architecture)["processor"]()
