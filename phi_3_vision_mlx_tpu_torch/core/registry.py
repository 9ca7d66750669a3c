"""Architecture registry (``phi_3_vision_mlx_tpu/core/registry.py``,
framework-free, shared with the JAX package)."""

from phi_3_vision_mlx_tpu.core.registry import processor_for  # noqa: F401
