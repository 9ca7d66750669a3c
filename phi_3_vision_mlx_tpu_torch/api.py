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
(``engine/speculative.py``); with ``enable_api=True`` a prompt holding
``<|api_input|>`` goes to ``agent/tools.get_api`` instead.  ``choose``
selects an option in one cache-free pass and ``constrain`` runs
constrained decoding, greedy or with ``use_beam`` (``engine/constrain.py``);
``execute`` is the agent's code sandbox (``agent/sandbox.py``).
``use_adapter=True`` in ``load``, ``generate``, ``choose`` and ``constrain``
serves the LoRA adapter at ``adapters/<model name>``
(:func:`_get_adapter_path`; ``train/trainer.py:train_lora`` writes it
there), as in the JAX package; ``_load(..., adapter_path=)`` takes any
adapter either package wrote.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from .agent.sandbox import execute as sandbox_execute
from .core import weights as W
from .core.registry import processor_for
from .engine.constrain import choose_from, constrain_decode
from .engine.engine import LM, generate_text
from .utils.media import fetch_image, fetch_text

PATH_ADAPTERS = "adapters"
PATH_ORIGINAL_PHI3_VISION = "models/phi3_v"
PATH_QUANTIZED_PHI3_VISION = "models/phi3_v_Q"
PATH_ORIGINAL_PHI3_BLIND = "models/phi3_mini_128k"
PATH_QUANTIZED_PHI3_BLIND = "models/phi3_mini_128k_Q"

CHAT_TURN = "<|user|>\n{body}<|end|>\n<|assistant|>\n"


def _setup(allow_random: bool = None, device="cuda"):
    """The JAX ``_setup`` offline: for each of the text and the vision model
    whose pair is not on disk, under ``PHI3V_TPU_ALLOW_RANDOM=1`` write a
    random-weight checkpoint and its 4-bit copy, both drawn and quantized on
    ``device`` (``PHI3V_TPU_RANDOM_LAYERS`` sets the decoder's depth,
    ``PHI3V_TPU_RANDOM_OVERRIDES`` any config fields as JSON); without it
    raise ``RuntimeError``.  Nothing is downloaded (``download_and_convert``
    needs the network and is not ported)."""
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
        W.create_random_checkpoint(local, preset_name, device=device, **overrides)
        W.quantize_checkpoint(local, quant, device=device)


def _get_adapter_path(model_path: str) -> str:
    return f"{PATH_ADAPTERS}/{Path(model_path).name}"


def _load(model_path=PATH_ORIGINAL_PHI3_VISION, adapter_path=None, device="cuda", **kwargs):
    """Checkpoint dir in the (in, out) layout, unquantized or with 4-bit or
    8-bit weights -> (LM, processor), with the LoRA adapter at
    ``adapter_path`` applied (``core/weights.py:load_adapter``).  The
    default is the unquantized vision checkpoint, as in the JAX package."""
    cfg, params = W.load_params(model_path, **kwargs)
    params = W.prepare_params(params, cfg)
    if adapter_path:
        with open(f"{adapter_path}/adapter_config.json") as f:
            lora_cfg = json.load(f)
        if lora_cfg.get("model_path") and lora_cfg["model_path"] != model_path:
            print(
                f"WARNING: LoRA trained for {lora_cfg['model_path']} is being "
                f"used with {model_path}"
            )
        params = W.load_adapter(params, cfg, adapter_path)
    processor = processor_for(cfg.architecture)(model_path)
    return LM(cfg, params, model_path=model_path, device=device), processor


def load(blind_model: bool = False, quantize_model: bool = False, quantize_cache: bool = False,
         use_adapter: bool = False, device="cuda", **kwargs):
    """Flag-based model selection (JAX ``load``): the vision model unless
    ``blind_model``, the 4-bit checkpoint with ``quantize_model`` (default
    ``False``), the 4-bit KV cache with ``quantize_cache``, the model's
    adapter (:func:`_get_adapter_path`) with ``use_adapter``."""
    if blind_model:
        model_path = PATH_QUANTIZED_PHI3_BLIND if quantize_model else PATH_ORIGINAL_PHI3_BLIND
    else:
        model_path = PATH_QUANTIZED_PHI3_VISION if quantize_model else PATH_ORIGINAL_PHI3_VISION
    adapter_path = _get_adapter_path(model_path) if use_adapter else None
    if not os.path.exists(model_path):
        _setup(device=device)
    return _load(model_path=model_path, adapter_path=adapter_path, device=device,
                 use_quantized_cache=quantize_cache, **kwargs)


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
    use_adapter=False,
    max_tokens=512,
    verbose=True,
    return_tps=False,
    early_stop=False,
    stream=True,
    apply_chat_template=True,
    enable_api=False,
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
    speculation for a single prompt.  With ``enable_api`` a prompt string
    holding ``<|api_input|>`` returns ``agent/tools.get_api``'s formatted
    snippets, and no model runs.  Without ``preload`` it loads the model as
    :func:`load` does, with the same flags (``use_adapter`` too)."""
    if isinstance(prompt, str) and "<|api_input|>" in prompt and enable_api:
        from .agent.tools import get_api

        return get_api(prompt)
    if preload is None:
        preload = load(blind_model=blind_model, quantize_model=quantize_model,
                       quantize_cache=quantize_cache, use_adapter=use_adapter)
    prompt, images = _apply_chat_template(prompt, images, verbose, apply_chat_template)
    return generate_text(
        *preload, prompt, images=images, max_tokens=max_tokens, verbose=verbose,
        return_tps=return_tps, early_stop=early_stop, stream=stream, mute=mute, sample=sample,
        temperature=temperature, top_p=top_p, top_k=top_k, min_p=min_p, seed=seed,
        speculative=speculative, stop=stop,
    )


def choose(
    prompt,
    choices="ABCDE",
    images=None,
    preload=None,
    blind_model=False,
    quantize_model=False,
    quantize_cache=False,
    use_adapter=False,
    verbose=True,
    apply_chat_template=True,
):
    """Option selection in one cache-free pass (JAX ``choose``): the letter
    of ``choices`` whose token the model ranks highest after the prompt
    (one letter, or a list for a list of prompts).  ``images`` only reach
    the banner, as in the JAX package."""
    if preload is None:
        preload = load(blind_model=blind_model, quantize_model=quantize_model,
                       quantize_cache=quantize_cache, use_adapter=use_adapter)
    if apply_chat_template:
        prompt, _ = _apply_chat_template(prompt, images, verbose)
    return choose_from(*preload, prompt=prompt, choices=choices)


def constrain(
    prompt,
    constraints=[(0, "\nThe"), (100, " The correct answer is"), "ABCDE"],
    images=None,
    preload=None,
    blind_model=False,
    quantize_model=False,
    quantize_cache=False,
    use_adapter=False,
    verbose=True,
    apply_chat_template=True,
    use_beam=False,
):
    """Constrained decoding (JAX ``constrain``): for each ``(n_free, text)``
    up to ``n_free`` free tokens, then ``text`` forced where it scores best
    by mean log-prob (``use_beam``: also trying the top 3 tokens before it);
    a string of choices appends the chosen letter."""
    if preload is None:
        preload = load(blind_model=blind_model, quantize_model=quantize_model,
                       quantize_cache=quantize_cache, use_adapter=use_adapter)
    if apply_chat_template:
        prompt = _apply_chat_template(prompt, None, verbose)[0]
    return constrain_decode(*preload, prompt=prompt, constraints=constraints, use_beam=use_beam,
                            verbose=verbose)


execute = sandbox_execute
