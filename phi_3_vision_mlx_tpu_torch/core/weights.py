"""Checkpoint I/O, the Hopper weight layout, and synthetic full-size weights.

Counterpart of ``phi_3_vision_mlx_tpu/core/weights.py``:

* :func:`load_safetensors` / :func:`save_safetensors` read and write the
  safetensors format in pure Python (8-byte little-endian header length, a
  JSON header, then raw bytes), so neither the ``safetensors`` package nor
  ``ml_dtypes`` is needed; BF16 is read as int16 and reinterpreted.
* :func:`build_params` / :func:`load_params` stack the per-layer tensors of a
  checkpoint the JAX package wrote (linear weights stored ``(in, out)``,
  config ``"layout": "in_out"``).
* :func:`prepare_params` replaces the JAX ``kernelize_params``: it turns the
  checkpoint's plain ``(K, N)`` one-value-per-byte payload into the port's
  own layout for kernel K1 (ops/kernels/quant_matmul.py) — eight 4-bit
  values of one column per int32 word, ``(K/8, N)``, so decode reads 0.5 B
  per weight — plus bf16 scales and biases ``(K/64, N)``.  There is no
  tiling, no group-interleaved row permutation and no lm_head vocab padding:
  those were TPU constraints, and the kernel masks the ragged N edge itself.
* :func:`synth_quantized_params` builds full-size random quantized weights
  directly on the device from a seeded ``torch.Generator`` (the torch
  counterpart of ``bench.py:synth_quantized_params``).
"""

from __future__ import annotations

import glob
import json
import mmap
import re
import struct
from typing import Dict

import torch

from .config import ModelConfig, config_from_dict

# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read one ``.safetensors`` file into CPU tensors (copy-on-write mmap)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        shape = meta["shape"]
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - start, offset=base + start)
        if (base + start) % dtype.itemsize:
            raw = raw.clone()  # the format does not promise aligned offsets
        out[name] = raw.view(dtype).reshape(shape)
    return out


def save_safetensors(path: str, flat: Dict[str, torch.Tensor]) -> None:
    """Write tensors in the safetensors format (readable by the JAX package)."""
    header, blobs, offset = {}, [], 0
    # Widest dtypes first (as the safetensors package orders them), so every
    # tensor starts at an offset aligned to its element size.
    for name in sorted(flat, key=lambda k: (-flat[k].dtype.itemsize, k)):
        t = flat[name].detach().to("cpu").contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {
            "dtype": _ST_NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(data)],
        }
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    flat: Dict[str, torch.Tensor] = {}
    for wf in sorted(glob.glob(f"{path}/*.safetensors")):
        flat.update(load_safetensors(wf))
    if not flat:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    return flat


# ---------------------------------------------------------------------------
# flat dict -> nested params (JAX core/weights.py:build_params)
# ---------------------------------------------------------------------------

_LAYER_RE = re.compile(r"^(.*layers)\.(\d+)\.(.+)$")


def _assign(tree: dict, dotted: str, value):
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[name]


def build_params(cfg: ModelConfig, flat: Dict[str, torch.Tensor]) -> dict:
    """Nested params with every ``...layers.N.<rest>`` tensor stacked along a
    leading layer axis.  Floating tensors (scales and biases included) are
    cast to ``cfg.dtype`` as the JAX loader does; payloads stay as stored."""
    want = torch_dtype(cfg.dtype)
    groups: dict = {}
    tree: dict = {}
    for name, arr in flat.items():
        if arr.is_floating_point() and arr.dtype != want:
            arr = arr.to(want)
        m = _LAYER_RE.match(name)
        if m:
            groups.setdefault(m.group(1), {}).setdefault(m.group(3), {})[int(m.group(2))] = arr
        else:
            _assign(tree, name, arr)
    for prefix, fields in groups.items():
        for rest, by_idx in fields.items():
            n = max(by_idx) + 1
            _assign(tree, f"{prefix}.{rest}", torch.stack([by_idx[i] for i in range(n)]))
    return tree


def load_params(model_path: str, **cfg_overrides):
    """Checkpoint dir written by the JAX package -> (cfg, nested CPU params)."""
    with open(f"{model_path}/config.json") as f:
        raw_cfg = json.load(f)
    if raw_cfg.get("layout") != "in_out":
        raise ValueError(
            f"{model_path} is not in the (in, out) layout; convert it first with "
            "phi_3_vision_mlx_tpu.core.weights.sanitize_checkpoint"
        )
    cfg = config_from_dict(raw_cfg, **cfg_overrides)
    return cfg, build_params(cfg, load_safetensors_dir(model_path))


# ---------------------------------------------------------------------------
# The port's 4-bit layout
# ---------------------------------------------------------------------------

WORD = 8  # 4-bit values per int32 word


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) uint8 values in [0, 15] -> (..., K/8, N) int32 words.

    Nibble ``j`` (bits 4j..4j+3) of word ``[r, n]`` holds ``q[8r + j, n]``.
    """
    *lead, k, n = q.shape
    if k % WORD:
        raise ValueError(f"K={k} is not a multiple of {WORD}")
    q8 = q.reshape(*lead, k // WORD, WORD, n).to(torch.int64)
    shifts = (4 * torch.arange(WORD, dtype=torch.int64, device=q.device)).view(WORD, 1)
    words = (q8 << shifts).sum(dim=-2)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_int4(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., K/8, N) int32 -> (..., K, N) uint8."""
    *lead, kw, n = words.shape
    shifts = (4 * torch.arange(WORD, dtype=torch.int32, device=words.device)).view(WORD, 1)
    q = (words.unsqueeze(-2) >> shifts) & 15
    return q.reshape(*lead, kw * WORD, n).to(torch.uint8)


def prepare_linear(node: dict) -> dict:
    """A quantized linear leaf of the checkpoint -> the port's K1 layout."""
    out = {k: v for k, v in node.items() if k not in ("weight", "scales", "biases")}
    out["qweight"] = pack_int4(node["weight"])
    out["scales"] = node["scales"].to(torch.bfloat16)
    if node.get("biases") is not None:
        out["biases"] = node["biases"].to(torch.bfloat16)
    return out


def prepare_params(params: dict, cfg: ModelConfig) -> dict:
    """Convert every 4-bit linear leaf to the port's layout (the counterpart
    of the JAX ``kernelize_params``).  The quantized embedding keeps its plain
    ``(V, E)`` payload (only looked-up rows are read) with bf16 scales and
    biases.  No-op on unquantized checkpoints."""
    if cfg.quantized is None:
        return params
    if cfg.quantized.bits != 4:
        raise NotImplementedError("the port carries 4-bit weights only")

    def walk(node):
        if not isinstance(node, dict):
            return node
        if "scales" in node and torch.is_tensor(node.get("weight")):
            q, s = node["weight"], node["scales"]
            if s.shape[-1] == q.shape[-1]:  # linear: scales (K/g, N)
                return prepare_linear(node)
            out = dict(node)  # embedding: scales (V, E/g)
            out["scales"] = s.to(torch.bfloat16)
            if node.get("biases") is not None:
                out["biases"] = node["biases"].to(torch.bfloat16)
            return out
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def params_to(params: dict, device) -> dict:
    """Move every tensor of a nested params dict to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device) if torch.is_tensor(params) else params


def synth_quantized_params(cfg: ModelConfig, device, seed: int = 0) -> dict:
    """Full-size random 4-bit params in the port's layout, built on ``device``.

    Same distribution as the JAX ``bench.py:synth_quantized_params``:
    uniform nibbles, scales ``0.004 * (1 + 0.1 * N(0, 1))``, biases ``-0.03``
    (affine mode), unit norms.  ``torch.Generator`` gives other numbers than
    ``jax.random`` from the same seed.
    """
    if cfg.quantized is None or cfg.quantized.bits != 4:
        raise ValueError("synth_quantized_params needs a 4-bit QuantConfig")
    g = torch.Generator(device=device).manual_seed(seed)
    e, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    nl, gs = cfg.num_hidden_layers, cfg.quantized.group_size
    symmetric = cfg.quantized.mode == "symmetric"
    dt = torch_dtype(cfg.dtype)

    def scale_bias(shape):
        s = 0.004 * (1.0 + 0.1 * torch.randn(shape, generator=g, device=device))
        out = {"scales": s.to(torch.bfloat16)}
        if not symmetric:
            out["biases"] = torch.full(shape, -0.03, dtype=torch.bfloat16, device=device)
        return out

    def linear(*lead, k, n):
        words = torch.randint(
            -(2**31), 2**31, (*lead, k // WORD, n), dtype=torch.int32, generator=g, device=device
        )
        return {"qweight": words, **scale_bias((*lead, k // gs, n))}

    embed = {
        "weight": torch.randint(0, 16, (v, e), dtype=torch.uint8, generator=g, device=device),
        **scale_bias((v, e // gs)),
    }
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)  # noqa: E731
    return {
        "model": {
            "embed_tokens": embed,
            "layers": {
                "self_attn": {
                    "qkv_proj": linear(nl, k=e, n=(h + 2 * kv) * d),
                    "o_proj": linear(nl, k=h * d, n=e),
                },
                "mlp": {
                    "gate_up_proj": linear(nl, k=e, n=2 * i),
                    "down_proj": linear(nl, k=i, n=e),
                },
                "input_layernorm": {"weight": ones(nl, e)},
                "post_attention_layernorm": {"weight": ones(nl, e)},
            },
            "norm": {"weight": ones(e)},
        },
        "lm_head": linear(k=e, n=v),
    }
