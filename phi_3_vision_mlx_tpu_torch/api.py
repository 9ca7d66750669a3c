"""Public API, text generation
(counterpart of ``phi_3_vision_mlx_tpu/api.py``).

``load()`` / ``_load()`` return ``(LM, processor)``, the same preload tuple
the JAX package passes around; ``generate`` runs greedy text generation.
Checkpoints are the (in, out) directories either package writes, with 4-bit
or 8-bit weights (kernel K1 or K8 on the card).  ``load`` with no checkpoint
on disk calls :func:`_setup`, which, as the JAX ``_setup`` does offline,
writes a random text checkpoint pair under ``PHI3V_TPU_ALLOW_RANDOM=1`` and
raises ``RuntimeError`` without it (the port downloads nothing).  Full-size
random weights can also be built on the device with
``core.weights.synth_quantized_params``.  Models load onto
``device="cuda"`` unless a caller names another device; with no CUDA card
that raises instead of running on the CPU.  ``load(quantize_cache=True)``
(``_load(..., use_quantized_cache=True)``) serves from the 4-bit group-32
KV cache (kernels K4/K5 on the card).  ``choose``, ``constrain``, vision,
sampling and adapters are not ported yet.
"""

from __future__ import annotations

import json
import os

from .core import weights as W
from .core.registry import processor_for
from .engine.engine import LM, generate_text

PATH_ORIGINAL_PHI3_VISION = "models/phi3_v"
PATH_QUANTIZED_PHI3_VISION = "models/phi3_v_Q"
PATH_ORIGINAL_PHI3_BLIND = "models/phi3_mini_128k"
PATH_QUANTIZED_PHI3_BLIND = "models/phi3_mini_128k_Q"

CHAT_TURN = "<|user|>\n{body}<|end|>\n<|assistant|>\n"


def _setup(allow_random: bool = None):
    """The JAX ``_setup`` offline: under ``PHI3V_TPU_ALLOW_RANDOM=1`` write a
    random-weight Phi-3.5-mini checkpoint and its 4-bit copy
    (``PHI3V_TPU_RANDOM_LAYERS`` sets the depth, ``PHI3V_TPU_RANDOM_OVERRIDES``
    any config fields as JSON); without it raise ``RuntimeError``.  The
    checkpoints are not downloaded (``download_and_convert`` needs the
    network and is not ported), and only the text pair is written until
    vision is ported."""
    if allow_random is None:
        allow_random = os.environ.get("PHI3V_TPU_ALLOW_RANDOM", "") == "1"
    if os.path.exists(PATH_ORIGINAL_PHI3_BLIND) and os.path.exists(PATH_QUANTIZED_PHI3_BLIND):
        return
    if not allow_random:
        raise RuntimeError(
            f"no checkpoint at {PATH_ORIGINAL_PHI3_BLIND} and the port downloads none. "
            "Set PHI3V_TPU_ALLOW_RANDOM=1 to create random-weight checkpoints for offline "
            "testing, write one with core.weights.create_random_checkpoint and quantize_checkpoint "
            "(q_bits=4 or 8), or build full-size random weights with synth_quantized_params and pass "
            "preload=(LM(cfg, params, device=...), processor)"
        )
    n_layers = int(os.environ.get("PHI3V_TPU_RANDOM_LAYERS", "0")) or None
    overrides = {"num_hidden_layers": n_layers} if n_layers else {}
    extra = os.environ.get("PHI3V_TPU_RANDOM_OVERRIDES")
    if extra:
        overrides.update(json.loads(extra))
    W.create_random_checkpoint(PATH_ORIGINAL_PHI3_BLIND, "phi35_mini", **overrides)
    W.quantize_checkpoint(PATH_ORIGINAL_PHI3_BLIND, PATH_QUANTIZED_PHI3_BLIND)


def _load(model_path=PATH_ORIGINAL_PHI3_BLIND, device="cuda", **kwargs):
    """Checkpoint dir in the (in, out) layout, unquantized or with 4-bit or
    8-bit weights -> (LM, processor).  The default is the unquantized text
    checkpoint (the JAX default, the unquantized vision one, waits for
    vision)."""
    cfg, params = W.load_params(model_path, **kwargs)
    if cfg.has_vision:
        raise NotImplementedError("vision models are not ported yet")
    params = W.prepare_params(params, cfg)
    processor = processor_for(cfg.architecture)(model_path)
    return LM(cfg, params, model_path=model_path, device=device), processor


def load(blind_model: bool = True, quantize_model: bool = False, quantize_cache: bool = False,
         use_adapter: bool = False, device="cuda", **kwargs):
    """Flag-based model selection (JAX ``load``); text models only.
    ``quantize_model`` picks the 4-bit checkpoint over the unquantized one,
    as in the JAX package (default ``False``).  ``blind_model`` defaults to
    ``True`` where the JAX package has ``False``: the text model is the
    port's only one until vision is ported, and then the default goes back
    to ``False``.  ``quantize_cache`` selects the 4-bit KV cache."""
    if not blind_model:
        raise NotImplementedError("vision models are not ported yet")
    if use_adapter:
        raise NotImplementedError("adapters are not ported yet")
    model_path = PATH_QUANTIZED_PHI3_BLIND if quantize_model else PATH_ORIGINAL_PHI3_BLIND
    if not os.path.exists(model_path):
        _setup()
    return _load(model_path=model_path, device=device, use_quantized_cache=quantize_cache, **kwargs)


def _print_io_banner(prompt) -> None:
    """The JAX ``_print_io_banner``: a list of prompts is shown stripped and
    joined, one per line; no images are ported yet."""
    if isinstance(prompt, list):
        prompt = "\n".join(map(str.strip, prompt)).strip()
    print(f"*** Prompt ***\n{prompt}\n*** Images ***\nNone\n*** Output ***")


def _apply_chat_template(prompt, apply_chat_template=True, verbose=False):
    """Wrap prompt(s) in the Phi-3 chat format (JAX ``_apply_chat_template``,
    text only); ``verbose`` prints the JAX package's banner."""
    if apply_chat_template is False:
        if verbose:
            _print_io_banner(prompt)
        return prompt
    prompts = [prompt] if isinstance(prompt, str) else prompt
    prompts = [CHAT_TURN.format(body=p.strip()) for p in prompts]
    if verbose:
        _print_io_banner(prompts)
    return prompts[0] if len(prompts) == 1 else prompts


def generate(
    prompt,
    images=None,
    preload=None,
    blind_model=True,
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
    stop=None,
):
    """Greedy generation with streaming (JAX ``generate``, text prompts).
    Without ``preload`` it loads the model as :func:`load` does (the same
    defaults and their reasons) with ``quantize_cache``."""
    if images is not None:
        raise NotImplementedError("vision prompts are not ported yet")
    if preload is None:
        preload = load(blind_model=blind_model, quantize_model=quantize_model,
                       quantize_cache=quantize_cache)
    prompt = _apply_chat_template(prompt, apply_chat_template, verbose)
    return generate_text(
        *preload, prompt, max_tokens=max_tokens, verbose=verbose, return_tps=return_tps,
        early_stop=early_stop, stream=stream, mute=mute, sample=sample, stop=stop,
    )
