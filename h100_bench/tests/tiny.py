"""Tiny cells for the benchmark's CPU tests: the harness's whole run on
the program's plain CPU paths, with configurations small enough for a test
run (the published ones are run on the card)."""

from __future__ import annotations

import copy
import json

from h100_bench import spec

FACTORS = {"type": "longrope", "long_factor": [1.0 + 0.05 * i for i in range(16)],
           "short_factor": [1.0 + 0.002 * i for i in range(16)]}
TEXT = {
    "architectures": ["Phi3ForCausalLM"], "hidden_size": 128, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "vocab_size": 32064, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
    "max_position_embeddings": 131072, "original_max_position_embeddings": 4096,
    "rope_scaling": FACTORS, "quantized": {"group_size": 64, "bits": 4, "mode": "affine"},
    "dtype_override": "float32",
}
VISION = {**TEXT, "architectures": ["Phi3VForCausalLM"], "img_processor": {"image_dim_out": 64},
          "vision_config": {"hidden_size": 64, "image_size": 336, "intermediate_size": 128,
                            "layer_norm_eps": 1e-05, "num_attention_heads": 4, "num_channels": 3,
                            "num_hidden_layers": 2, "patch_size": 14},
          "num_crops": 4}


def parts(cell: str) -> dict:
    """A cell of ``BENCHMARK.json`` with the tiny configuration of its kind
    and its traffic cut to a few short requests."""
    p = spec.load(cell)
    p["config"] = copy.deepcopy(VISION if p["config"].get("vision_config") else TEXT)
    t = p["traffic"]
    t.update(clients=3, ramp_seconds=0.5, trace_seconds=0.5, block=8)
    t["server"] = {"slots": 2, "window": 512 if "images" not in t else 1024, "page_size": 64}
    t["prompt_tokens"] = ({"dist": "uniform", "min": 40, "max": 120} if "images" not in t
                          else {"dist": "uniform", "min": 4, "max": 12})
    t["max_tokens"] = {"dist": "uniform", "min": 6, "max": 14}
    if "images" in t:
        t["images"] = {"shapes": [[60, 80], [50, 40]]}
    p["limits"] = json.loads(json.dumps(p["limits"]))
    return p
