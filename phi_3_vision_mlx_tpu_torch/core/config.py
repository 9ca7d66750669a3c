"""Model and quantization config (``phi_3_vision_mlx_tpu/core/config.py``).

The JAX package's config module is plain Python (dataclasses and JSON, no
``jax``), so the port shares it instead of copying it: one definition of the
presets and of the checkpoint's ``config.json`` schema for both packages.
"""

from phi_3_vision_mlx_tpu.core.config import (  # noqa: F401
    ID_EOS,
    KVQuantConfig,
    ModelConfig,
    QuantConfig,
    config_from_dict,
    preset,
)
