"""The benchmark of the PyTorch and CUDA port (``phi_3_vision_mlx_tpu_torch``) on
NVIDIA H100 cards: ``python3 h100_bench/run.py --workload <cell> ...``."""
