from setuptools import find_packages, setup

setup(
    name="phi-3-vision-mlx-tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) framework with the capabilities of "
        "Phi-3-Vision-MLX: VLM + LLM inference, constrained decoding, LoRA "
        "training, agents, RAG, serving."
    ),
    packages=find_packages(exclude=("tests",)),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "safetensors",
        "optax",
        "requests",
        "Pillow",
    ],
    extras_require={
        "full": ["transformers", "datasets", "huggingface_hub", "matplotlib", "gradio"],
        # phi_3_vision_mlx_tpu_torch: the PyTorch/CUDA port (kernels build with nvcc)
        "torch": ["torch"],
    },
    entry_points={
        "console_scripts": [
            "phi3v = phi_3_vision_mlx_tpu.serve.ui:main",
        ]
    },
)
