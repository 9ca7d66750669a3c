"""phi_3_vision_mlx_tpu_torch — the PyTorch/CUDA port of ``phi_3_vision_mlx_tpu``.

It runs single-stream greedy serving of 4-bit Phi-3.5-mini, with a dense
bf16 or a 4-bit KV cache, on one NVIDIA Hopper card (H100), with
hand-written CUDA kernels for the W4A16 matmul and for attention.  The JAX package beside it is the reference the port is held
against; framework-free host code (config, tokenizer, processor, stoppers,
timing) is imported from it, never copied.

Layout mirrors the JAX package: core/ (weights, convert) -> ops/ (quant,
linear, norms, rope, attention, kernels/) -> models/phi3 -> engine/ (state,
engine) -> api -> serve/server.  Nothing here imports ``jax``.
"""

__version__ = "0.1.0"
