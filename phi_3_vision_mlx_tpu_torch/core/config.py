"""Model and quantization config (counterpart of
``phi_3_vision_mlx_tpu/core/config.py``).

Frozen, hashable dataclasses and the checkpoint's HF-style ``config.json``
schema.  The port keeps its own copy, field for field the JAX package's
(``tests/test_torch_host.py`` holds the presets, ``config_from_dict`` and
``config_to_dict`` to it), so that nothing of the JAX package is imported at
run time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Token ids fixed by the Phi-3 tokenizer.
ID_EOS = 32007  # <|end|>


@dataclasses.dataclass(frozen=True)
class RopeScalingConfig:
    """Su-scaled ("longrope") RoPE factors."""

    type: str = "longrope"
    long_factor: Tuple[float, ...] = ()
    short_factor: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Group quantization of the weights: ``mode="affine"`` is
    ``w ~= scales[g] * q + biases[g]`` with ``q`` in ``[0, 2**bits - 1]``;
    ``mode="symmetric"`` is ``w ~= scales[g] * (q - 2**(bits-1))``."""

    group_size: int = 64
    bits: int = 4
    mode: str = "affine"  # "affine" | "symmetric"


@dataclasses.dataclass(frozen=True)
class KVQuantConfig:
    """KV-cache quantization (4-bit group-32 by default)."""

    group_size: int = 32
    bits: int = 4


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP ViT-L/14-336 config (the vision tower is not ported yet; the
    config still parses, so a vision checkpoint is refused by name)."""

    hidden_size: int = 1024
    image_size: int = 336
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    num_attention_heads: int = 16
    num_channels: int = 3
    num_hidden_layers: int = 24
    patch_size: int = 14

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static configuration of the Phi-3 decoder family: the fields read
    from ``config.json`` plus the runtime flags (``use_quantized_cache``,
    ``kv_quant``, ``dtype``)."""

    architecture: str = "Phi3ForCausalLM"
    vocab_size: int = 32064
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 131072
    original_max_position_embeddings: int = 4096
    rope_scaling: Optional[RopeScalingConfig] = None
    vision: Optional[ClipVisionConfig] = None
    image_dim_out: int = 1024
    quantized: Optional[QuantConfig] = None
    use_quantized_cache: bool = False
    kv_quant: KVQuantConfig = KVQuantConfig()
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def has_vision(self) -> bool:
        return self.vision is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_VISION_KEYS = ("hidden_size", "image_size", "intermediate_size", "layer_norm_eps",
                "num_attention_heads", "num_channels", "num_hidden_layers", "patch_size")


def _rope_scaling_from_dict(d) -> Optional[RopeScalingConfig]:
    if not d:
        return None
    return RopeScalingConfig(
        type=d.get("type", d.get("rope_type", "longrope")),
        long_factor=tuple(float(x) for x in d.get("long_factor", ())),
        short_factor=tuple(float(x) for x in d.get("short_factor", ())),
    )


def config_from_dict(raw: dict, **overrides) -> ModelConfig:
    """A ModelConfig from a checkpoint's HF-style config dict, with runtime
    overrides applied to the dict first."""
    raw = dict(raw)
    raw.update(overrides)
    arch = raw.get("architectures", ["Phi3ForCausalLM"])[0]
    vision = None
    if arch.startswith("Phi3V"):
        vc = raw.get("vision_config") or {}
        vision = ClipVisionConfig(**{k: vc[k] for k in _VISION_KEYS if k in vc})
    quantized = None
    if raw.get("quantized"):
        q = raw["quantized"]
        quantized = QuantConfig(group_size=int(q["group_size"]), bits=int(q["bits"]),
                                mode=str(q.get("mode", "affine")))
    img_cfg = raw.get("img_processor") or {}
    return ModelConfig(
        architecture=arch,
        vocab_size=int(raw.get("vocab_size", 32064)),
        hidden_size=int(raw.get("hidden_size", 3072)),
        intermediate_size=int(raw.get("intermediate_size", 8192)),
        num_hidden_layers=int(raw.get("num_hidden_layers", 32)),
        num_attention_heads=int(raw.get("num_attention_heads", 32)),
        num_key_value_heads=int(raw.get("num_key_value_heads", 32)),
        rms_norm_eps=float(raw.get("rms_norm_eps", 1e-5)),
        rope_theta=float(raw.get("rope_theta", 10000.0)),
        max_position_embeddings=int(raw.get("max_position_embeddings", 131072)),
        original_max_position_embeddings=int(raw.get("original_max_position_embeddings", 4096)),
        rope_scaling=_rope_scaling_from_dict(raw.get("rope_scaling")),
        vision=vision,
        image_dim_out=int(img_cfg.get("image_dim_out", 1024)),
        quantized=quantized,
        use_quantized_cache=bool(raw.get("use_quantized_cache", False)),
        dtype=str(raw.get("jax_dtype", raw.get("dtype_override", "bfloat16"))),
    )


def config_to_dict(cfg: ModelConfig) -> dict:
    """The HF-style config dict a checkpoint's ``config.json`` holds (the
    inverse of :func:`config_from_dict` for the saved fields)."""
    d = {
        "architectures": [cfg.architecture],
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings,
        "original_max_position_embeddings": cfg.original_max_position_embeddings,
        "model_type": "phi3_v" if cfg.has_vision else "phi3",
        "sanitized": True,
        "jax_dtype": cfg.dtype,
    }
    if cfg.rope_scaling is not None:
        d["rope_scaling"] = {
            "type": cfg.rope_scaling.type,
            "long_factor": list(cfg.rope_scaling.long_factor),
            "short_factor": list(cfg.rope_scaling.short_factor),
        }
    if cfg.has_vision:
        d["img_processor"] = {"image_dim_out": cfg.image_dim_out}
        d["vision_config"] = {k: getattr(cfg.vision, k) for k in _VISION_KEYS}
    if cfg.quantized is not None:
        d["quantized"] = {"group_size": cfg.quantized.group_size, "bits": cfg.quantized.bits,
                          "mode": cfg.quantized.mode}
    return d


def _synthetic_su_factors(half_dim: int) -> RopeScalingConfig:
    """Smooth su-factors of the right length for random checkpoints (real
    checkpoints carry theirs in config.json)."""
    long = tuple(1.0 + 0.05 * i for i in range(half_dim))
    short = tuple(1.0 + 0.002 * i for i in range(half_dim))
    return RopeScalingConfig(type="longrope", long_factor=long, short_factor=short)


_TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, rope_scaling=_synthetic_su_factors(16),
             dtype="float32")


def preset(name: str, **overrides) -> ModelConfig:
    """Named configs: 'phi35_mini', 'phi35_vision', 'tiny', 'tiny_vision'."""
    if name == "phi35_mini":
        cfg = ModelConfig(rope_scaling=_synthetic_su_factors(48))
    elif name == "phi35_vision":
        cfg = ModelConfig(architecture="Phi3VForCausalLM", vision=ClipVisionConfig(),
                          rope_scaling=_synthetic_su_factors(48))
    elif name == "tiny":
        cfg = ModelConfig(max_position_embeddings=512, original_max_position_embeddings=128, **_TINY)
    elif name == "tiny_vision":
        cfg = ModelConfig(
            architecture="Phi3VForCausalLM", max_position_embeddings=2048,
            original_max_position_embeddings=1024,
            vision=ClipVisionConfig(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                                    num_hidden_layers=2),
            image_dim_out=64, **_TINY,
        )
    else:
        raise KeyError(f"unknown preset: {name}")
    if overrides:
        cfg = cfg.replace(**overrides)
        # Keep synthetic su-factors consistent with an overridden head_dim.
        if (cfg.rope_scaling is not None
                and len(cfg.rope_scaling.long_factor) != cfg.head_dim // 2
                and "rope_scaling" not in overrides):
            cfg = cfg.replace(rope_scaling=_synthetic_su_factors(cfg.head_dim // 2))
    return cfg
