"""phi_3_vision_mlx_tpu_torch — the PyTorch/CUDA port of ``phi_3_vision_mlx_tpu``.

It serves 4-bit or 8-bit Phi-3.5-mini and Phi-3.5-vision (image prompts
through the CLIP tower), greedy or sampled, with or without speculation,
with a dense bf16 or a 4-bit KV cache, single-stream and continuously
batched, plus choice selection, constrained decoding, the agent toolchain
and its chat UI, GTE embeddings, LoRA fine-tuning, evaluation and adapter
serving, the reference's benchmark and the parity runbook (``verify``,
whose first config decodes an fp32 model), on one NVIDIA Hopper card
(H100), with hand-written CUDA kernels for the quantized matmuls and for
attention.  The JAX package beside it is the
reference the port is held against; the port keeps its own copies of the
host code it needs (config, tokenizer, processors, image processor, media
fetchers, stoppers, the training data pipeline).

Its public names are the JAX package's (import it as ``pv``)::

    import phi_3_vision_mlx_tpu_torch as pv
    pv.generate("Hello", blind_model=True)
    pv.train_lora(dataset_path="synthetic"); pv.test_lora(dataset_path="synthetic")
    pv.benchmark(dataset_path="synthetic")

Each resolves on first use (:data:`_LAZY`), so importing the package loads
neither a submodule nor any CUDA state.  Every name of the JAX package's
table is served (:data:`_WAITING`, the names still to port, is empty).

Layout mirrors the JAX package: core/ (weights, convert) -> ops/ (quant,
linear, norms, rope, attention, kernels/) -> models/ (phi3, vision, gte) ->
engine/ (state, engine, graphs, batching, paging, speculative, constrain)
-> train/ (lora, data, trainer, pretrain, checkpoint) -> api -> agent/
(sandbox, tools, agent), serve/ (server, ui), bench and verify; utils/
(media, timing, profiler); parallel/ (mesh, sharding, tensor,
ring_attention, dryrun) and models/retnet.  Nothing here imports ``jax``.
"""

__version__ = "0.1.0"

_LAZY = {
    # task API
    "load": ".api",
    "generate": ".api",
    "choose": ".api",
    "constrain": ".api",
    "execute": ".api",
    "_setup": ".api",
    "_load": ".api",
    "_apply_chat_template": ".api",
    "_load_image": ".api",
    "_load_text": ".api",
    "PATH_ADAPTERS": ".api",
    "PATH_ORIGINAL_PHI3_VISION": ".api",
    "PATH_QUANTIZED_PHI3_VISION": ".api",
    "PATH_ORIGINAL_PHI3_BLIND": ".api",
    "PATH_QUANTIZED_PHI3_BLIND": ".api",
    # training
    "train_lora": ".train.trainer",
    "test_lora": ".train.trainer",
    "TrainingCallback": ".train.trainer",
    # benchmark
    "benchmark": ".bench",
    # agent / tools
    "Agent": ".agent.agent",
    "add_code": ".agent.tools",
    "add_text": ".agent.tools",
    "rag": ".agent.tools",
    "get_api": ".agent.tools",
    "mistral_api": ".agent.external",
    "bark_api": ".agent.external",
    # embeddings / RAG
    "GteModel": ".models.gte",
    "VDB": ".models.gte",
    # serving / UI
    "chat_ui": ".serve.ui",
    "BatchEngine": ".engine.batching",
    "PagedBatchEngine": ".engine.paging",
    "ContinuousScheduler": ".serve.server",
    # config and presets
    "ModelConfig": ".core.config",
    "preset": ".core.config",
    "ID_EOS": ".core.config",
    "ID_ASS": ".core.config",
}

# The JAX package's public names the port has not ported yet, each with the
# ROADMAP item that brings it: none.
_WAITING: dict = {}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    if name in _WAITING:
        raise AttributeError(f"{name!r} is not ported yet: {_WAITING[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
