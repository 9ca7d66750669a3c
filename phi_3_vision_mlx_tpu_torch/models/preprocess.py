"""Prompt processors (``phi_3_vision_mlx_tpu/models/preprocess.py``,
numpy only, shared with the JAX package)."""

from phi_3_vision_mlx_tpu.models.preprocess import Phi3Processor  # noqa: F401
