"""The yardstick's arithmetic against the port's kernel table and shapes."""

import pytest

from h100_bench import flops
from h100_bench.reference import image
from h100_bench.spec import load


def test_k1_qkv_bound_is_the_kernel_tables():
    # PERF.md's kernel table: K1a qkv K=3072 N=9216 M=1, bound 0.0048 ms (bytes).
    ms = flops.bound_s(flops.w4_call_bytes(3072, 9216, 1), 2 * 3072 * 9216) * 1e3
    assert round(ms, 4) == 0.0048
    # K1b lm_head K=3072 N=32064 M=1: 0.0166 ms.
    assert round(flops.w4_call_bytes(3072, 32064, 1) / flops.HBM_BYTES_PER_S * 1e3, 4) == 0.0166


def test_decode_step_bytes_cover_every_linear():
    cfg = load("mini-w4.chat")["config"]
    one = flops.decode_step_k1_bytes(cfg, 1)
    weights = (flops.layer_params(cfg) + 3072 * 32064) / 2  # 4-bit payload alone
    assert weights < one < 1.15 * weights
    assert 1.7e9 < one < 2.3e9  # PERF.md: about 2.09 GB of 4-bit weights


def test_prefill_is_the_sum_of_its_tokens():
    cfg = load("mini-w4.chat")["config"]
    n = 37
    head = 2.0 * 3072 * 32064
    by_token = sum(flops.decode_token_flops(cfg, p) - head for p in range(1, n + 1)) + head
    assert flops.prefill_flops(cfg, n) == pytest.approx(by_token, rel=1e-12)


@pytest.mark.parametrize("shape", [(900, 900), (700, 1000), (900, 600), (60, 80), (5376, 336)])
@pytest.mark.parametrize("crops", [4, 16])
def test_image_grid_matches_the_reference_and_the_program(shape, crops):
    from phi_3_vision_mlx_tpu_torch.models.image_processor import Phi3VImageProcessor
    from phi_3_vision_mlx_tpu_torch.utils.media import ArrayImage
    import numpy as np

    rows, cols = flops.image_grid(*shape, crops)
    assert (rows, cols) == image.grid(*shape, crops)[0]
    plan = Phi3VImageProcessor(crops).resize_plan(ArrayImage(np.zeros((*shape, 3), np.uint8)))
    assert (plan["out_h"] // 336, plan["out_w"] // 336) == (rows, cols)
    assert flops.image_tokens(rows, cols) == image.tokens(rows, cols)
