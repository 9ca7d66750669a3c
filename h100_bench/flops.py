"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of the work a window did, computed from the model's
shapes and the request lengths alone (never from a program's counters).

Peaks: NVIDIA H100 SXM data sheet, dense rates.  A bound is the larger of
the bytes over the memory rate and the operations over the bf16
tensor-core rate, as in the port's kernel table.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
GROUP = 64  # weight quantization group along K
CROP = 336


def bound_s(nbytes: float, flops: float, rate: float = BF16_FLOPS) -> float:
    """The least time the card could take for ``nbytes`` moved and
    ``flops`` done."""
    return max(nbytes / HBM_BYTES_PER_S, flops / rate)


def decoder_linears(cfg: dict) -> list:
    """(K, N) of each linear of one decoder layer: qkv, o, gate_up, down."""
    e, i = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = e // h
    return [(e, (h + 2 * kv) * d), (h * d, e), (e, 2 * i), (i, e)]


def head_linear(cfg: dict) -> tuple:
    return cfg["hidden_size"], cfg["vocab_size"]


def w4_call_bytes(k: int, n: int, m: int) -> float:
    """Bytes a 4-bit group-64 affine matmul of ``m`` bf16 rows must move:
    the packed weight, bf16 scales and biases, x read and y written."""
    return k * n / 2 + 2 * (k // GROUP) * n * 2 + m * k * 2 + m * n * 2


def decode_step_k1_bytes(cfg: dict, rows: int) -> float:
    """Bytes of every quantized matmul of one decode step over ``rows``
    slots: each layer's four linears and the lm_head."""
    per_layer = sum(w4_call_bytes(k, n, rows) for k, n in decoder_linears(cfg))
    return cfg["num_hidden_layers"] * per_layer + w4_call_bytes(*head_linear(cfg), rows)


def layer_params(cfg: dict) -> int:
    """Matmul parameters of the decoder layers (no embedding, no head)."""
    return cfg["num_hidden_layers"] * sum(k * n for k, n in decoder_linears(cfg))


def attention_flops(cfg: dict, keys: float) -> float:
    """QK^T and PV of one query token over ``keys`` keys, every layer."""
    return 4.0 * cfg["num_attention_heads"] * (cfg["hidden_size"] // cfg["num_attention_heads"]) \
        * keys * cfg["num_hidden_layers"]


def prefill_flops(cfg: dict, length: int) -> float:
    """Model FLOPs of prefilling ``length`` real prompt tokens: every layer
    for every token, causal attention, the lm_head at the last position."""
    k, n = head_linear(cfg)
    return (2.0 * layer_params(cfg) * length + 2.0 * k * n
            + attention_flops(cfg, length * (length + 1) / 2.0))


def decode_token_flops(cfg: dict, keys: int) -> float:
    """Model FLOPs of one decode step of one request over ``keys`` keys."""
    k, n = head_linear(cfg)
    return 2.0 * (layer_params(cfg) + k * n) + attention_flops(cfg, keys)


def image_grid(h: int, w: int, num_crops: int) -> tuple:
    """(rows, cols) of 336-pixel crops of an h x w image after the
    multi-crop transform (portrait images tiled as their transpose)."""
    trans = w < h
    if trans:
        h, w = w, h
    scale = int((num_crops * w / h) ** 0.5)
    rw, rh = scale * CROP, int(scale * CROP * h / w)
    rows, cols = -(-rh // CROP), rw // CROP
    return (cols, rows) if trans else (rows, cols)


def image_tokens(rows: int, cols: int) -> int:
    """Image placeholder tokens of a (rows, cols) crop grid: 144 a crop and
    the global view, a separator after each row of 12, one between."""
    return (rows * cols + 1) * 144 + 1 + (rows + 1) * 12


def clip_flops(vcfg: dict, hidden: int, image_dim_out: int, rows: int, cols: int) -> float:
    """Model FLOPs of one image: the tower over the global view and every
    crop (the penultimate layer's output: all layers but the last), the
    patch embedding, and the two-layer projection of every image token."""
    e, inter = vcfg["hidden_size"], vcfg["intermediate_size"]
    p = vcfg["patch_size"]
    grid = (vcfg["image_size"] // p) ** 2
    tokens = grid + 1
    crops = 1 + rows * cols
    per_layer = 2.0 * tokens * (4 * e * e + 2 * e * inter) + 4.0 * tokens * tokens * e
    tower = crops * ((vcfg["num_hidden_layers"] - 1) * per_layer + 2.0 * grid * p * p * 3 * e)
    c4 = 4 * image_dim_out
    return tower + 2.0 * image_tokens(rows, cols) * (c4 * hidden + hidden * hidden)
