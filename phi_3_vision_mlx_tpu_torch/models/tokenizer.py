"""Tokenizers (``phi_3_vision_mlx_tpu/models/tokenizer.py``, framework-free,
shared with the JAX package)."""

from phi_3_vision_mlx_tpu.models.tokenizer import ByteTokenizer  # noqa: F401
