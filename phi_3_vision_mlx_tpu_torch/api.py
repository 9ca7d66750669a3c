"""Public API (counterpart of ``phi_3_vision_mlx_tpu/api.py``).

``load()`` / ``_load()`` return ``(LM, processor)``, the same preload tuple
the JAX package passes around; ``generate`` runs greedy generation, of text
prompts or of one prompt with images on the vision model (the default, as
in the JAX package).  Checkpoints are the (in, out) directories either
package writes, with 4-bit or 8-bit weights (kernel K1 or K8 on the card).
``load`` with no checkpoint on disk calls :func:`_setup`, which, as the JAX
``_setup`` does offline, writes both random checkpoint pairs (Phi-3.5-mini
and Phi-3.5-vision, each unquantized and 4-bit) under
``PHI3V_TPU_ALLOW_RANDOM=1`` and raises ``RuntimeError`` without it (the
port downloads nothing).  Full-size random weights can also be built on the
device with ``core.weights.synth_quantized_params``.  Models load onto
``device="cuda"`` unless a caller names another device; with no CUDA card
that raises instead of running on the CPU.  ``load(quantize_cache=True)``
(``_load(..., use_quantized_cache=True)``) serves from the 4-bit group-32
KV cache (kernels K4/K5 on the card).  ``generate`` samples with
``sample=True`` (``temperature``, ``top_p``, ``top_k``, ``min_p``,
``seed``) and speculates with ``speculative=True``
(``engine/speculative.py``).  ``choose``, ``constrain`` and adapters are
not ported yet.
"""

from __future__ import annotations

import json
import os

from .core import weights as W
from .core.registry import processor_for
from .engine.engine import LM, generate_text
from .utils.media import fetch_image, fetch_text

PATH_ORIGINAL_PHI3_VISION = "models/phi3_v"
PATH_QUANTIZED_PHI3_VISION = "models/phi3_v_Q"
PATH_ORIGINAL_PHI3_BLIND = "models/phi3_mini_128k"
PATH_QUANTIZED_PHI3_BLIND = "models/phi3_mini_128k_Q"

CHAT_TURN = "<|user|>\n{body}<|end|>\n<|assistant|>\n"


def _setup(allow_random: bool = None):
    """The JAX ``_setup`` offline: for each of the text and the vision model
    whose pair is not on disk, under ``PHI3V_TPU_ALLOW_RANDOM=1`` write a
    random-weight checkpoint and its 4-bit copy (``PHI3V_TPU_RANDOM_LAYERS``
    sets the decoder's depth, ``PHI3V_TPU_RANDOM_OVERRIDES`` any config
    fields as JSON); without it raise ``RuntimeError``.  Nothing is
    downloaded (``download_and_convert`` needs the network and is not
    ported)."""
    if allow_random is None:
        allow_random = os.environ.get("PHI3V_TPU_ALLOW_RANDOM", "") == "1"
    pairs = [
        (PATH_ORIGINAL_PHI3_BLIND, PATH_QUANTIZED_PHI3_BLIND, "phi35_mini"),
        (PATH_ORIGINAL_PHI3_VISION, PATH_QUANTIZED_PHI3_VISION, "phi35_vision"),
    ]
    for local, quant, preset_name in pairs:
        if os.path.exists(local) and os.path.exists(quant):
            continue
        if not allow_random:
            raise RuntimeError(
                f"no checkpoint at {local} and the port downloads none. "
                "Set PHI3V_TPU_ALLOW_RANDOM=1 to create random-weight checkpoints for offline "
                "testing, write one with core.weights.create_random_checkpoint and "
                "quantize_checkpoint (q_bits=4 or 8), or build full-size random weights with "
                "synth_quantized_params and pass preload=(LM(cfg, params, device=...), processor)"
            )
        n_layers = int(os.environ.get("PHI3V_TPU_RANDOM_LAYERS", "0")) or None
        overrides = {"num_hidden_layers": n_layers} if n_layers else {}
        extra = os.environ.get("PHI3V_TPU_RANDOM_OVERRIDES")
        if extra:
            overrides.update(json.loads(extra))
        W.create_random_checkpoint(local, preset_name, **overrides)
        W.quantize_checkpoint(local, quant)


def _load(model_path=PATH_ORIGINAL_PHI3_VISION, device="cuda", **kwargs):
    """Checkpoint dir in the (in, out) layout, unquantized or with 4-bit or
    8-bit weights -> (LM, processor).  The default is the unquantized vision
    checkpoint, as in the JAX package."""
    cfg, params = W.load_params(model_path, **kwargs)
    params = W.prepare_params(params, cfg)
    processor = processor_for(cfg.architecture)(model_path)
    return LM(cfg, params, model_path=model_path, device=device), processor


def load(blind_model: bool = False, quantize_model: bool = False, quantize_cache: bool = False,
         use_adapter: bool = False, device="cuda", **kwargs):
    """Flag-based model selection (JAX ``load``): the vision model unless
    ``blind_model``, the 4-bit checkpoint with ``quantize_model`` (default
    ``False``), the 4-bit KV cache with ``quantize_cache``."""
    if use_adapter:
        raise NotImplementedError("adapters are not ported yet")
    if blind_model:
        model_path = PATH_QUANTIZED_PHI3_BLIND if quantize_model else PATH_ORIGINAL_PHI3_BLIND
    else:
        model_path = PATH_QUANTIZED_PHI3_VISION if quantize_model else PATH_ORIGINAL_PHI3_VISION
    if not os.path.exists(model_path):
        _setup()
    return _load(model_path=model_path, device=device, use_quantized_cache=quantize_cache, **kwargs)


# The JAX package's names for the media fetchers.
_load_image = fetch_image
_load_text = fetch_text


def _image_tags(n: int) -> str:
    """``<|image_1|>`` .. ``<|image_n|>`` header lines."""
    return "".join(f"<|image_{i}|>\n" for i in range(1, n + 1))


def _print_io_banner(prompt, images=None) -> None:
    """The JAX ``_print_io_banner``: a list of prompts is shown stripped and
    joined, one per line, then the images, one per line."""
    if isinstance(prompt, list):
        prompt = "\n".join(map(str.strip, prompt)).strip()
    images_str = "\n".join(map(str, images)) if images else "None"
    print(f"*** Prompt ***\n{prompt}\n*** Images ***\n{images_str}\n*** Output ***")


def _apply_chat_template(prompt, images=None, verbose=False, apply_chat_template=True):
    """Wrap prompt(s) in the Phi-3 chat format, with an ``<|image_i|>`` line
    per image before the text, and decode the image sources
    (``fetch_image``).  Returns (prompt or prompts, images), as the JAX
    ``_apply_chat_template``; ``verbose`` prints its banner."""
    if apply_chat_template is False:
        if verbose:
            _print_io_banner(prompt, images)
        return prompt, images
    if images is not None:
        sources = images if isinstance(images, list) else [images]
        images = [fetch_image(src) for src in sources]
    header = _image_tags(len(images)) if images else ""
    prompts = [prompt] if isinstance(prompt, str) else prompt
    prompts = [CHAT_TURN.format(body=f"{header}{p.strip()}") for p in prompts]
    if verbose:
        _print_io_banner(prompts, images)
    return (prompts[0] if len(prompts) == 1 else prompts), images


def generate(
    prompt,
    images=None,
    preload=None,
    blind_model=False,
    quantize_model=False,
    quantize_cache=False,
    max_tokens=512,
    verbose=True,
    return_tps=False,
    early_stop=False,
    stream=True,
    apply_chat_template=True,
    mute=False,
    sample=False,
    temperature=1.0,
    top_p=1.0,
    top_k=0,
    min_p=0.0,
    seed=0,
    speculative=None,
    stop=None,
):
    """Generation with streaming (JAX ``generate``): text prompts, or one
    prompt with ``images`` (paths, URLs, decoded images, or any object with
    ``.size`` and ``.convert``).  Greedy by default; ``sample=True`` draws
    under ``temperature``, ``top_p``, ``top_k`` and ``min_p`` from ``seed``;
    ``speculative=True`` (default: ``PHI3V_TPU_SPEC=1``) runs prompt-lookup
    speculation for a single prompt.  Without ``preload`` it loads the
    model as :func:`load` does, with the same flags."""
    if preload is None:
        preload = load(blind_model=blind_model, quantize_model=quantize_model,
                       quantize_cache=quantize_cache)
    prompt, images = _apply_chat_template(prompt, images, verbose, apply_chat_template)
    return generate_text(
        *preload, prompt, images=images, max_tokens=max_tokens, verbose=verbose,
        return_tps=return_tps, early_stop=early_stop, stream=stream, mute=mute, sample=sample,
        temperature=temperature, top_p=top_p, top_k=top_k, min_p=min_p, seed=seed,
        speculative=speculative, stop=stop,
    )
