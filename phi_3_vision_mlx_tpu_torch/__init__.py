"""phi_3_vision_mlx_tpu_torch — the PyTorch/CUDA port of ``phi_3_vision_mlx_tpu``.

It serves 4-bit or 8-bit Phi-3.5-mini and Phi-3.5-vision (image prompts
through the CLIP tower), greedy or sampled, with or without speculation,
with a dense bf16 or a 4-bit KV cache, single-stream and continuously
batched, plus choice selection, constrained decoding, the agent toolchain
and GTE embeddings, on one NVIDIA Hopper card (H100), with hand-written
CUDA kernels for the quantized matmuls and for attention.  The JAX package beside it is the reference the port is held
against; the port keeps its own copies of the host code it needs (config,
tokenizer, processors, image processor, media fetchers, stoppers).

Layout mirrors the JAX package: core/ (weights, convert) -> ops/ (quant,
linear, norms, rope, attention, kernels/) -> models/ (phi3, vision, gte) ->
engine/ (state, engine, graphs, batching, paging, speculative, constrain)
-> api -> agent/ (sandbox, tools, agent) and serve/server.  Nothing here
imports ``jax``.
"""

__version__ = "0.1.0"
