"""The reference's benchmark (counterpart of ``phi_3_vision_mlx_tpu/bench.py``):
trains a 1-sample LoRA for all four model dirs, then for each config
{vanilla, q_model, q_cache, lora} runs three tasks (text generation, image
captioning, the 15-prompt batch) at 100 tokens, records (prompt tok/s,
generation tok/s) to ``benchmark.json`` and prints the markdown table.

Offline, as in the JAX package: the image task falls back to a locally made
test image when the Met Museum URL cannot be fetched (here an in-memory
image, :func:`_local_test_image`: no Pillow needed); checkpoints fall back
to random weights under ``PHI3V_TPU_ALLOW_RANDOM=1``.  Everything runs on
``device`` (the card unless the caller names another).
"""

from __future__ import annotations

import json

BENCH_PROMPTS = [
    ("Write a mystery horror.",),
    (
        "What is shown in this image?",
        "https://collectionapi.metmuseum.org/api/collection/v1/iiif/344291/725918/main-image",
    ),
    (
        [
            "Write an executive summary for a communications business plan",
            "Explain quantum computing.",
            "Write a poem about the first snowfall of the year.",
            "Write a Python function to implement a neural network from scratch, with detailed comments.",
            "Write a resume.",
            "Explain the key concepts of quantum computing and provide a Rust code example demonstrating quantum superposition.",
            "Explain the concept of dark matter and its significance in the universe.",
            "Summarize the major events of the French Revolution.",
            "Describe the water cycle.",
            "Write a Neurology ICU Admission Note.",
            # The reference list's two adjacent literals concatenate (a
            # missing comma) — kept verbatim so the batch workload is 15
            # prompts from 16 literals, as in the reference.
            "Describe a bustling alien marketplace on a distant planet with unique goods and creatures."
            "Imagine you have a magic potion that grants one wish. What would you wish for and how would it change your life?",
            "Compose a limerick about a clumsy robot.",
            "Write a JavaScript function to sort an array of objects by a specific property.",
            "Design a database schema for a social media platform, considering user profiles, posts, and interactions.",
            "Implement a basic encryption algorithm in Python.",
        ],
        None,
    ),
]


def _local_test_image():
    """The deterministic 640 x 480 gradient of the JAX package's test image,
    pixel for pixel, as an in-memory image (``utils/media.py:ArrayImage``)."""
    import numpy as np

    from .utils.media import ArrayImage

    h, w = 480, 640
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.stack(
        [
            (xx * 255 // w),
            (yy * 255 // h),
            ((xx + yy) * 255 // (h + w)),
        ],
        axis=-1,
    ).astype(np.uint8)
    return ArrayImage(arr, "bench_test_image")


_TASKS = ("Text Generation", "Image Captioning", "Batched Generation")
_METHODS = (
    ("vanilla", "Vanilla Model"),
    ("q_model", "Quantized Model"),
    ("q_cache", "Quantized Cache"),
    ("lora", "LoRA Adapter"),
)


def _format_benchmark(json_path="benchmark.json"):
    """Print ``benchmark.json`` as the generation tok/s markdown table."""
    with open(json_path, "r") as f:
        data = json.load(f)
    header = ["Task", *(label for _, label in _METHODS)]
    rows = [
        [task, *(f"{data[key][i][2]:.2f} tps" for key, _ in _METHODS)]
        for i, task in enumerate(_TASKS)
    ]
    widths = [max(len(r[c]) for r in [header, *rows]) for c in range(len(header))]
    fmt = lambda r: "    | " + " | ".join(c.ljust(w) for c, w in zip(r, widths)) + " |"  # noqa: E731
    lines = [
        "",
        fmt(header),
        "    |" + "|".join("-" * (w + 2) for w in widths) + "|",
        *(fmt(r) for r in rows),
    ]
    print("\n".join(lines))


def benchmark(blind_model: bool = False, json_path: str = "benchmark.json",
              max_tokens: int = 100, train_first: bool = True,
              dataset_path: str = "JosefAlbers/akemiH_MedQA_Reason", device="cuda"):
    """The JAX ``benchmark``: ``_setup`` if a model dir is missing, a
    1-sample LoRA for each of the four dirs with ``train_first``, then
    ``generate(..., return_tps=True)`` for each config and task; returns
    and writes ``{config: [[task, prompt tok/s, generation tok/s], ...]}``."""
    import os

    from .api import (
        PATH_ORIGINAL_PHI3_BLIND,
        PATH_ORIGINAL_PHI3_VISION,
        PATH_QUANTIZED_PHI3_BLIND,
        PATH_QUANTIZED_PHI3_VISION,
        _load_image,
        _setup,
        generate,
        load,
    )
    from .train.trainer import train_lora

    if not (
        os.path.exists(PATH_ORIGINAL_PHI3_VISION)
        and os.path.exists(PATH_ORIGINAL_PHI3_BLIND)
    ):
        _setup(device=device)
    if train_first:
        for path in [
            PATH_ORIGINAL_PHI3_VISION,
            PATH_QUANTIZED_PHI3_VISION,
            PATH_ORIGINAL_PHI3_BLIND,
            PATH_QUANTIZED_PHI3_BLIND,
        ]:
            train_lora(model_path=path, take=1, dataset_path=dataset_path, device=device)

    prompts = [list(p) for p in BENCH_PROMPTS]
    # Resolve the image (URL online, the local test image offline).
    try:
        _load_image(prompts[1][1])
    except Exception:
        prompts[1][1] = _local_test_image()

    results = {"vanilla": [], "q_model": [], "q_cache": [], "lora": []}
    for method in results:
        kwargs = {"blind_model": blind_model}
        if method == "q_model":
            kwargs["quantize_model"] = True
        elif method == "q_cache":
            kwargs["quantize_cache"] = True
        elif method == "lora":
            kwargs["use_adapter"] = True
        preload = load(**kwargs, device=device)
        for i, prompt in enumerate(prompts):
            args = tuple(prompt)
            if blind_model and len(args) > 1 and args[1] is not None:
                args = (args[0], None)  # the blind model skips the image
            prompt_tps, gen_tps = generate(
                *args, preload=preload, max_tokens=max_tokens, return_tps=True,
                verbose=False, stream=False, mute=True,
            )
            results[method].append([i, prompt_tps, gen_tps])
        del preload
    with open(json_path, "w") as f:
        json.dump(results, f, indent=4)
    _format_benchmark(json_path)
    return results
