"""Checkpoint I/O, the Hopper weight layouts, and random weights.

Counterpart of ``phi_3_vision_mlx_tpu/core/weights.py``:

* :func:`load_safetensors` / :func:`save_safetensors` read and write the
  safetensors format in pure Python (8-byte little-endian header length, a
  JSON header, then raw bytes), so neither the ``safetensors`` package nor
  ``ml_dtypes`` is needed; BF16 is read as int16 and reinterpreted.
  :func:`load_safetensors_dir` prefers the native zero-copy reader
  (``core/native.py``) and says once, on stderr, which reader it used.
* :func:`build_params` / :func:`load_params` stack the per-layer tensors of a
  checkpoint, either in the (in, out) layout (linear weights stored ``(in,
  out)``, config ``"layout": "in_out"``), written by either package, or a raw
  HuggingFace directory: its linears and their scales and biases, stored
  ``(out, in)``, are transposed, and its NCHW patch embedding becomes OHWI.
  :func:`sanitize_checkpoint` writes a raw directory out in the (in, out)
  layout (the reference's ``_sanitize``).
  :func:`load_adapter` adds a LoRA adapter either package wrote
  (``adapters.safetensors`` + ``adapter_config.json``); :func:`prepare_params`
  and :func:`params_to` keep its float32 leaves as they are.
* :func:`save_checkpoint`, :func:`quantize_checkpoint` and
  :func:`create_random_checkpoint` write that format: ``config.json``,
  per-layer keys, plain ``(K, N)`` uint8 payloads with their scales and
  biases.  A checkpoint either package writes loads in the other.
* :func:`prepare_params` replaces the JAX ``kernelize_params``: it turns the
  checkpoint's plain ``(K, N)`` one-value-per-byte payload into the port's
  own layout — eight 4-bit values of one column per int32 word, ``(K/8, N)``
  for kernel K1, or four 8-bit values, ``(K/4, N)`` for kernel K8
  (ops/kernels/quant_matmul.py) — plus bf16 scales and biases ``(K/64, N)``.
  There is no tiling, no group-interleaved row permutation, no signed cast
  of the 8-bit levels and no lm_head vocab padding: those were TPU
  constraints, and the kernels mask the ragged N edge themselves.
* :func:`to_packed_layout` / :func:`from_packed_layout` are the port's copies
  of the JAX package's flat packed 4-bit layout (``ops/kernels/
  quant_matmul.py:_perm_for, pack_nibbles, unpack_nibbles,
  unpermute_payload``): ``(K, N/2)`` uint8, rows group-interleaved within
  512-row blocks, two columns per byte.  :func:`packed_params` turns the
  eligible 4-bit linears of a prepared params tree into that layout (the
  counterpart of ``kernelize_params``, which emits another layout); kernel
  K9 reads it in place.  :func:`prepare_params` keeps such a leaf as it is.
* :func:`synth_quantized_params` builds full-size random quantized weights
  directly on the device from a seeded ``torch.Generator`` (the torch
  counterpart of ``bench.py:synth_quantized_params``), with the CLIP tower
  of a vision config.

Vision checkpoints load through the same path: the tower's per-layer keys
(``model.vision_embed_tokens.img_processor.vision_model.encoder.layers.N``)
stack like the decoder's, its linears (q/k/v/out_proj, fc1, fc2,
``img_projection.{0,2}``) quantize like the decoder's, and the patch
embedding's weight is OHWI (E, P, P, 3) in the (in, out) layout; a raw
HF directory's NCHW weight is transposed to it once, as it loads.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import re
import shutil
import struct
import sys
from typing import Dict

import torch

from ..ops.quant import quantize
from .config import ModelConfig, QuantConfig, config_from_dict, config_to_dict, preset

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
    header, offset = {}, 0
    # Widest dtypes first (as the safetensors package orders them), so every
    # tensor starts at an offset aligned to its element size.
    names = sorted(flat, key=lambda k: (-flat[k].dtype.itemsize, k))
    for name in names:
        t = flat[name]
        size = t.numel() * t.dtype.itemsize
        header[name] = {
            "dtype": _ST_NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + size],
        }
        offset += size
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in names:  # one tensor's bytes in memory at a time
            t = flat[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())  # the tensor's own bytes, no copy


_READER_SAID = []  # the reader load_safetensors_dir said it used, once a process


def safetensors_reader():
    """``(name, reader)`` of :func:`load_safetensors_dir`: the native
    zero-copy reader (``core/native.py``) unless ``PHI3V_TPU_NATIVE_IO=0``
    or it does not build here (no g++), else :func:`load_safetensors`
    (JAX ``core/weights.py:load_safetensors_dir``)."""
    if os.environ.get("PHI3V_TPU_NATIVE_IO", "1") == "1":
        from . import native

        if native.available():
            return "native", native.load_file_mmap
    return "python", load_safetensors


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every ``*.safetensors`` shard of a checkpoint directory."""
    name, reader = safetensors_reader()
    if name not in _READER_SAID:
        _READER_SAID.append(name)
        print(f"safetensors reader: {name}", file=sys.stderr, flush=True)
    flat: Dict[str, torch.Tensor] = {}
    for wf in sorted(glob.glob(f"{path}/*.safetensors")):
        flat.update(reader(wf))
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


def _is_linear_weight(name: str) -> bool:
    return _LINEAR_RE.search(name) is not None


def _from_hf(name: str, arr: torch.Tensor) -> torch.Tensor:
    """A raw HF tensor in the (in, out) layout (JAX ``build_params`` with
    ``pre_transposed=False``): a linear's weight (out, in) transposed,
    whether float or an integer payload others saved (out, in), every
    ``scales``/``biases`` plane transposed, and the NCHW patch embedding
    made OHWI."""
    field = name.rsplit(".", 1)[-1]
    if "patch_embedding.weight" in name and arr.dim() == 4 and arr.shape[1] == 3:
        return arr.permute(0, 2, 3, 1)
    if (field == "weight" and arr.dtype != torch.bool and _is_linear_weight(name)) or \
            field in ("scales", "biases"):
        return arr.transpose(-2, -1)
    return arr


def build_params(cfg: ModelConfig, flat: Dict[str, torch.Tensor], *,
                 pre_transposed: bool = True) -> dict:
    """Nested params with every ``...layers.N.<rest>`` tensor stacked along a
    leading layer axis.  Floating tensors (scales and biases included) are
    cast to ``cfg.dtype`` as the JAX loader does; payloads stay as stored.
    ``pre_transposed`` False reads a raw HF checkpoint (:func:`_from_hf`)."""
    want = torch_dtype(cfg.dtype)
    groups: dict = {}
    tree: dict = {}
    for name, arr in flat.items():
        if not pre_transposed:
            arr = _from_hf(name, arr)
        if arr.is_floating_point() and arr.dtype != want:
            arr = arr.to(want)
        m = _LAYER_RE.match(name)
        if m:  # stacked below, which lays out a transposed view
            groups.setdefault(m.group(1), {}).setdefault(m.group(3), {})[int(m.group(2))] = arr
        else:
            _assign(tree, name, arr.contiguous())
    for prefix, fields in groups.items():
        for rest, by_idx in fields.items():
            n = max(by_idx) + 1
            _assign(tree, f"{prefix}.{rest}", torch.stack([by_idx[i] for i in range(n)]))
    return tree


def load_params(model_path: str, **cfg_overrides):
    """Checkpoint dir, in the (in, out) layout or raw HF -> (cfg, nested CPU
    params)."""
    with open(f"{model_path}/config.json") as f:
        raw_cfg = json.load(f)
    cfg = config_from_dict(raw_cfg, **cfg_overrides)
    return cfg, build_params(cfg, load_safetensors_dir(model_path),
                             pre_transposed=raw_cfg.get("layout") == "in_out")


def sanitize_checkpoint(from_path: str, to_path: str, **cfg_overrides) -> ModelConfig:
    """Raw HF directory -> a checkpoint in the (in, out) layout, with the
    tokenizer's files copied (the reference's ``_sanitize``; JAX
    ``core/weights.py:sanitize_checkpoint``).  Like the JAX one it reads
    ``from_path`` as raw whatever its config says."""
    with open(f"{from_path}/config.json") as f:
        cfg = config_from_dict(json.load(f), **cfg_overrides)
    params = build_params(cfg, load_safetensors_dir(from_path), pre_transposed=False)
    save_checkpoint(to_path, cfg, params)
    _copy_tokenizer_files(from_path, to_path)
    return cfg


# ---------------------------------------------------------------------------
# LoRA adapters (JAX core/weights.py:load_adapter)
# ---------------------------------------------------------------------------

LORA_KEYS = ("lora_a", "lora_b", "lora_scale")  # float32 whatever the model's dtype
_ADAPTER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)\.(lora_a|lora_b)$")


def _copy_tree(node):
    """New dicts at every level over the same tensors."""
    return {k: _copy_tree(v) for k, v in node.items()} if isinstance(node, dict) else node


def load_adapter(params: dict, cfg: ModelConfig, adapter_path: str) -> dict:
    """``params`` with the LoRA adapter at ``adapter_path`` added (a new
    tree over the same tensors).

    ``adapters.safetensors`` holds per-layer ``model.layers.N.<target>.
    lora_a`` (K, r) and ``.lora_b`` (r, N) in float32, the reference's key
    format, which both packages write; ``adapter_config.json``'s
    ``lora_parameters`` give the scale ``scale * alpha / rank``.  Each
    target gets stacked float32 ``lora_a (nl, K, r)``, ``lora_b (nl, r,
    N)`` and ``lora_scale (nl,)`` on its weights' device; layers without
    adapter weights hold zeros (B = 0 is an exact no-op).
    """
    with open(f"{adapter_path}/adapter_config.json") as f:
        lp = json.load(f).get("lora_parameters", {})
    scale = float(lp.get("scale", 1.0) * (lp.get("alpha", 1.0) / max(lp.get("rank", 1), 1)))
    per_target: dict = {}
    for k, v in load_safetensors(f"{adapter_path}/adapters.safetensors").items():
        m = _ADAPTER_RE.match(k)
        if m:
            per_target.setdefault(m.group(2), {}).setdefault(int(m.group(1)), {})[m.group(3)] = v
    params = _copy_tree(params)
    nl = cfg.num_hidden_layers
    for target, by_layer in per_target.items():
        node = params["model"]["layers"]
        for part in target.split("."):
            node = node[part]
        first = next(iter(by_layer.values()))
        (kdim, r), ndim = first["lora_a"].shape, first["lora_b"].shape[-1]
        a = torch.zeros((nl, kdim, r), dtype=torch.float32)
        b = torch.zeros((nl, r, ndim), dtype=torch.float32)
        for i, fields in by_layer.items():
            a[i], b[i] = fields["lora_a"], fields["lora_b"]
        device = next(v.device for v in node.values() if torch.is_tensor(v))
        node["lora_a"], node["lora_b"] = a.to(device), b.to(device)
        node["lora_scale"] = torch.full((nl,), scale, dtype=torch.float32, device=device)
    return params


# ---------------------------------------------------------------------------
# The port's 4-bit and 8-bit layouts
# ---------------------------------------------------------------------------

WORD = 8  # 4-bit values per int32 word
WORD8 = 4  # 8-bit values per int32 word


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) uint8 values in [0, 15] -> (..., K/8, N) int32 words.

    Nibble ``j`` (bits 4j..4j+3) of word ``[r, n]`` holds ``q[8r + j, n]``.
    """
    *lead, k, n = q.shape
    if k % WORD:
        raise ValueError(f"K={k} is not a multiple of {WORD}")
    q8 = q.reshape(*lead, k // WORD, WORD, n)
    words = q8[..., 0, :].to(torch.int64)
    for j in range(1, WORD):  # a nibble plane at a time: no (..., K, N) int64 temporary
        words |= q8[..., j, :].to(torch.int64) << (4 * j)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_int4(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., K/8, N) int32 -> (..., K, N) uint8."""
    *lead, kw, n = words.shape
    shifts = (4 * torch.arange(WORD, dtype=torch.int32, device=words.device)).view(WORD, 1)
    q = (words.unsqueeze(-2) >> shifts) & 15
    return q.reshape(*lead, kw * WORD, n).to(torch.uint8)


def pack_int8(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) uint8 levels in [0, 255] -> (..., K/4, N) int32 words.

    Byte ``j`` (bits 8j..8j+7) of word ``[r, n]`` holds ``q[4r + j, n]``, as
    an unsigned level.  The bytes are reinterpreted in place, which assumes
    a little-endian host (as every PyTorch platform is).
    """
    *lead, k, n = q.shape
    if k % WORD8:
        raise ValueError(f"K={k} is not a multiple of {WORD8}")
    q4 = q.reshape(*lead, k // WORD8, WORD8, n).transpose(-1, -2).contiguous()
    return q4.view(torch.int32).squeeze(-1)


def unpack_int8(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int8`: (..., K/4, N) int32 -> (..., K, N) uint8."""
    *lead, kw, n = words.shape
    q = words.contiguous().unsqueeze(-1).view(torch.uint8)  # (..., K/4, N, 4)
    return q.transpose(-1, -2).reshape(*lead, kw * WORD8, n)


# bits -> (values per int32 word, pack, unpack)
LAYOUTS = {4: (WORD, pack_int4, unpack_int4), 8: (WORD8, pack_int8, unpack_int8)}


def leaf_bits(qweight: torch.Tensor, k: int) -> int:
    """The width of a prepared linear leaf, from its word count against K:
    ``(K/8, N)`` words hold 4-bit values, ``(K/4, N)`` 8-bit ones."""
    for bits, (per_word, _, _) in LAYOUTS.items():
        if qweight.shape[-2] * per_word == k:
            return bits
    raise ValueError(f"qweight {tuple(qweight.shape)} is no packed layout of K={k}")


def prepare_linear(node: dict, bits: int = 4) -> dict:
    """A quantized linear leaf of the checkpoint -> the port's K1 (4-bit) or
    K8 (8-bit) layout."""
    if bits == 8 and node.get("biases") is None:
        raise NotImplementedError("symmetric mode is 4-bit only (ops/quant.py)")
    out = {k: v for k, v in node.items() if k not in ("weight", "scales", "biases")}
    out["qweight"] = LAYOUTS[bits][1](node["weight"])
    out["scales"] = node["scales"].to(torch.bfloat16)
    if node.get("biases") is not None:
        out["biases"] = node["biases"].to(torch.bfloat16)
    return out


def is_packed_leaf(node: dict) -> bool:
    """A linear leaf in the flat packed 4-bit layout: a uint8 ``(..., K,
    N/2)`` payload beside ``(..., K/g, N)`` scales (the JAX rule,
    ``ops/linear.py:102,205``, ``models/phi3.py:77-80``)."""
    q, s = node.get("weight"), node.get("scales")
    return (torch.is_tensor(q) and s is not None and q.dtype == torch.uint8
            and q.shape[-1] * 2 == s.shape[-1])


def _bf16_planes(node: dict) -> dict:
    out = dict(node)
    out["scales"] = node["scales"].to(torch.bfloat16)
    if node.get("biases") is not None:
        out["biases"] = node["biases"].to(torch.bfloat16)
    return out


def prepare_params(params: dict, cfg: ModelConfig) -> dict:
    """Convert every quantized linear leaf to the port's layout for its
    width (the counterpart of the JAX ``kernelize_params``).  The quantized
    embedding keeps its plain ``(V, E)`` payload (only looked-up rows are
    read), and a linear leaf already in the packed layout keeps its payload,
    both with bf16 scales and biases.  No-op on unquantized checkpoints."""
    if cfg.quantized is None:
        return params
    bits = cfg.quantized.bits
    if bits not in LAYOUTS:
        raise NotImplementedError(f"the port carries 4-bit and 8-bit weights, not {bits}-bit")

    def walk(node):
        if not isinstance(node, dict):
            return node
        if "scales" in node and torch.is_tensor(node.get("weight")):
            if is_packed_leaf(node):
                if bits != 4 or node.get("biases") is None:
                    raise ValueError("the packed layout holds 4-bit affine weights")
                return _bf16_planes(node)
            if node["scales"].shape[-1] == node["weight"].shape[-1]:  # linear: scales (K/g, N)
                return prepare_linear(node, bits)
            return _bf16_planes(node)  # embedding: scales (V, E/g)
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


# ---------------------------------------------------------------------------
# The flat packed 4-bit layout (JAX ops/kernels/quant_matmul.py:39-100,274-282)
# ---------------------------------------------------------------------------

PACK_BLOCK_K = 512  # rows are group-interleaved within blocks of min(512, K)
PACK_BLOCK_N = 512  # byte j of a 512-column block: column j | column j + 256 << 4


def packed_block_k(k: int) -> int:
    return min(PACK_BLOCK_K, k)


def packed_row_perm(k: int, group: int = 64) -> torch.Tensor:
    """Packed row -> original row: within each ``block_k`` block, row
    ``i * gk + gl`` holds original row ``block_start + gl * group + i``
    (``gk = block_k / group``; JAX ``_perm_for``)."""
    bk = packed_block_k(k)
    return torch.arange(k).reshape(k // bk, bk // group, group).transpose(1, 2).reshape(k)


def packable(k: int, n: int, group: int = 64) -> bool:
    """The JAX kernel's own conditions (``quant_matmul.py:150,234``)."""
    bk = packed_block_k(k)
    return k % bk == 0 and bk % group == 0 and n % PACK_BLOCK_N == 0


def to_packed_layout(q: torch.Tensor, group: int = 64) -> torch.Tensor:
    """Plain ``(..., K, N)`` uint8 levels in [0, 15] -> the packed ``(..., K,
    N/2)`` uint8 payload (JAX ``pack_nibbles(q[_perm_for(...)])``)."""
    *lead, k, n = q.shape
    if not packable(k, n, group):
        raise ValueError(f"K={k}, N={n} do not fit the packed layout's blocks")
    half = PACK_BLOCK_N // 2
    qp = q[..., packed_row_perm(k, group).to(q.device), :].reshape(*lead, k, n // PACK_BLOCK_N,
                                                                   PACK_BLOCK_N)
    return (qp[..., :half] | (qp[..., half:] << 4)).reshape(*lead, k, n // 2)


def from_packed_layout(packed: torch.Tensor, group: int = 64) -> torch.Tensor:
    """Inverse of :func:`to_packed_layout` (JAX ``unpermute_payload(
    unpack_nibbles(...))``): ``(..., K, N/2)`` -> ``(..., K, N)`` uint8."""
    *lead, k, nh = packed.shape
    p = packed.reshape(*lead, k, nh * 2 // PACK_BLOCK_N, PACK_BLOCK_N // 2)
    q = torch.cat([p & 15, p >> 4], dim=-1).reshape(*lead, k, nh * 2)
    inv = torch.argsort(packed_row_perm(k, group)).to(packed.device)
    return q[..., inv, :]


def packed_params(params: dict, cfg: ModelConfig) -> dict:
    """The port's prepared 4-bit affine params with every linear whose (K,
    N) the packed layout takes (K a multiple of ``min(512, K)``, N of 512)
    moved to that layout: ``{'weight': (..., K, N/2) uint8, 'scales',
    'biases'}`` in bf16.  Others (lm_head at N = 32064) keep K1's layout.
    Stacked leaves convert one layer at a time.  Like the JAX
    ``kernelize_params`` it transforms a loaded tree; ``api.load`` does not
    call it."""
    q = cfg.quantized
    if q is None or q.bits != 4 or q.mode != "affine":
        raise ValueError("the packed layout holds 4-bit affine weights")

    def convert(node):
        qw = node["qweight"]
        k, n = qw.shape[-2] * WORD, qw.shape[-1]
        group = k // node["scales"].shape[-2]
        if not packable(k, n, group):
            return node
        flat = qw.reshape(-1, qw.shape[-2], n)
        payload = torch.stack([to_packed_layout(unpack_int4(w), group) for w in flat])
        out = {key: v for key, v in node.items() if key != "qweight"}
        out["weight"] = payload.reshape(*qw.shape[:-2], k, n // 2)
        return out

    def walk(node):
        if not isinstance(node, dict):
            return node
        if "qweight" in node and node.get("biases") is not None:
            return convert(node)
        return {key: walk(v) for key, v in node.items()}

    return walk(params)


def params_to(params: dict, device) -> dict:
    """Move every tensor of a nested params dict to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device) if torch.is_tensor(params) else params


def synth_quantized_params(cfg: ModelConfig, device, seed: int = 0) -> dict:
    """Full-size random 4-bit or 8-bit params (``cfg.quantized.bits``) in the
    port's layout, built on ``device``.

    At 4 bits the distribution of the JAX ``bench.py:synth_quantized_params``:
    uniform nibbles, scales ``0.004 * (1 + 0.1 * N(0, 1))``, biases ``-0.03``
    (affine mode), unit norms.  At 8 bits uniform bytes under the same law
    with the scale's step divided by 255 / 15, so the weights span the same
    range (-0.03 to 0.03 about zero) as an 8-bit quantization of the same
    weights would.  ``torch.Generator`` gives other numbers than
    ``jax.random`` from the same seed.
    """
    if cfg.quantized is None or cfg.quantized.bits not in LAYOUTS:
        raise ValueError("synth_quantized_params needs a 4-bit or 8-bit QuantConfig")
    g = torch.Generator(device=device).manual_seed(seed)
    e, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    nl, gs, bits = cfg.num_hidden_layers, cfg.quantized.group_size, cfg.quantized.bits
    symmetric = cfg.quantized.mode == "symmetric"
    if symmetric and bits != 4:
        raise NotImplementedError("symmetric mode is 4-bit only (ops/quant.py)")
    per_word = LAYOUTS[bits][0]
    step = 0.004 * (15 / ((1 << bits) - 1))
    dt = torch_dtype(cfg.dtype)

    def scale_bias(shape):
        s = step * (1.0 + 0.1 * torch.randn(shape, generator=g, device=device))
        out = {"scales": s.to(torch.bfloat16)}
        if not symmetric:
            out["biases"] = torch.full(shape, -0.03, dtype=torch.bfloat16, device=device)
        return out

    def linear(*lead, k, n):
        words = torch.randint(
            -(2**31), 2**31, (*lead, k // per_word, n), dtype=torch.int32, generator=g, device=device
        )
        return {"qweight": words, **scale_bias((*lead, k // gs, n))}

    embed = {
        "weight": torch.randint(0, 1 << bits, (v, e), dtype=torch.uint8, generator=g, device=device),
        **scale_bias((v, e // gs)),
    }
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)  # noqa: E731
    params = {
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
    if cfg.has_vision:
        params["model"]["vision_embed_tokens"] = _synth_vision(cfg, linear, g, device, dt)
    return params


def _synth_vision(cfg: ModelConfig, linear, g: torch.Generator, device, dt) -> dict:
    """The CLIP tower and projection of :func:`synth_quantized_params`:
    quantized linears (``linear``'s law) with zero float biases, the patch and
    position embeddings normal with scale 0.02 in ``dt``, unit LayerNorms,
    zero CLS and separators."""
    vc = cfg.vision
    e, nl, inter, hidden = vc.hidden_size, vc.num_hidden_layers, vc.intermediate_size, cfg.hidden_size
    c4 = 4 * cfg.image_dim_out

    def lin(*lead, k, n):
        return {**linear(*lead, k=k, n=n), "bias": torch.zeros((*lead, n), dtype=dt, device=device)}

    def nrm(*shape):
        return (0.02 * torch.randn(shape, generator=g, device=device)).to(dt)

    def ln(*lead):
        return {"weight": torch.ones((*lead, e), dtype=dt, device=device),
                "bias": torch.zeros((*lead, e), dtype=dt, device=device)}

    return {
        "img_processor": {"vision_model": {
            "embeddings": {
                "class_embedding": torch.zeros((e,), dtype=dt, device=device),
                "patch_embedding": {"weight": nrm(e, vc.patch_size, vc.patch_size, 3)},
                "position_embedding": {"weight": nrm(vc.num_positions, e)},
            },
            "pre_layrnorm": ln(),
            "encoder": {"layers": {
                "self_attn": {name: lin(nl, k=e, n=e) for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
                "layer_norm1": ln(nl),
                "layer_norm2": ln(nl),
                "mlp": {"fc1": lin(nl, k=e, n=inter), "fc2": lin(nl, k=inter, n=e)},
            }},
            "post_layernorm": ln(),
        }},
        "glb_GN": torch.zeros((1, 1, c4), dtype=dt, device=device),
        "sub_GN": torch.zeros((1, 1, 1, c4), dtype=dt, device=device),
        "img_projection": {"0": lin(k=c4, n=hidden), "2": lin(k=hidden, n=hidden)},
    }


# ---------------------------------------------------------------------------
# Writing checkpoints (JAX save_checkpoint, quantize_checkpoint,
# create_random_checkpoint)
# ---------------------------------------------------------------------------

# Tensors whose ``.weight`` is a linear matmul weight.
_LINEAR_RE = re.compile(
    r"(qkv_proj|o_proj|gate_up_proj|down_proj|lm_head"
    r"|q_proj|k_proj|v_proj|out_proj|fc1|fc2|img_projection\.\d+)\.weight$"
)


def flatten_params(params: dict) -> Dict[str, torch.Tensor]:
    """Nested params -> flat ``{dotted name: tensor}``, every stacked
    ``...layers`` subtree unstacked back to per-layer keys."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix, stacked):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k, stacked or k == "layers")
        elif stacked:
            base, rest = re.match(r"^(.*layers)\.(.+)$", prefix).groups()
            for i in range(node.shape[0]):
                out[f"{base}.{i}.{rest}"] = node[i]
        else:
            out[prefix] = node

    walk(params, "", False)
    return out


def save_checkpoint(path: str, cfg: ModelConfig, params: dict, shard_gb: float = 4.0) -> None:
    """Write ``config.json`` (``"layout": "in_out"``) and the model's
    safetensors, sharded by size, in the JAX package's format."""
    os.makedirs(path, exist_ok=True)
    d = config_to_dict(cfg)
    d["layout"] = "in_out"
    with open(f"{path}/config.json", "w") as f:
        json.dump(d, f, indent=2)
    shards: list = [{}]
    size, limit = 0, int(shard_gb * (1 << 30))
    for k, v in flatten_params(params).items():
        nbytes = v.numel() * v.dtype.itemsize
        if size + nbytes > limit and shards[-1]:
            shards.append({})
            size = 0
        shards[-1][k] = v
        size += nbytes
    for i, shard in enumerate(shards):
        suffix = f"-{i:05d}-of-{len(shards):05d}" if len(shards) > 1 else ""
        save_safetensors(f"{path}/model{suffix}.safetensors", shard)


def _quantize_tree(params: dict, qcfg: QuantConfig) -> dict:
    """Quantize every linear leaf (groups along K) and the token embedding
    (groups along E) of a nested params dict (JAX ``_quantize_tree``)."""

    def as_node(t):
        out = {"weight": t.q, "scales": t.scales}
        if t.biases is not None:
            out["biases"] = t.biases
        return out

    def walk(node, path):
        if not isinstance(node, dict):
            return node
        w = node.get("weight")
        if not torch.is_tensor(w):
            return {k: walk(v, path + [k]) for k, v in node.items()}
        g = qcfg.group_size
        if path and path[-1] == "embed_tokens":
            if w.shape[-1] % g:
                return node
            return as_node(quantize(w, g, qcfg.bits, axis=-1, mode=qcfg.mode))
        if _LINEAR_RE.search(".".join(path) + ".weight") and w.dim() >= 2 and w.shape[-2] % g == 0:
            out = as_node(quantize(w, g, qcfg.bits, axis=-2, mode=qcfg.mode))
            if "bias" in node:
                out["bias"] = node["bias"]
            return out
        return node

    return walk(params, [])


def _to_device(node, device):
    return {k: _to_device(v, device) for k, v in node.items()} if isinstance(node, dict) else node.to(device)


def _copy_tokenizer_files(from_path: str, to_path: str) -> None:
    """The tokenizer's ``*.json`` and ``*.model`` files, ``config.json``
    aside; a file that cannot be copied is skipped, as in the JAX package."""
    for f in glob.glob(f"{from_path}/*.json") + glob.glob(f"{from_path}/*.model"):
        if os.path.basename(f) != "config.json":
            try:
                shutil.copy(f, to_path)
            except OSError:
                pass


def quantize_checkpoint(from_path: str, to_path: str, q_group_size: int = 64, q_bits: int = 4,
                        device="cpu"):
    """A checkpoint, in the (in, out) layout or raw HF -> its group-quantized
    copy (the reference's ``_quantize``): 4-bit or 8-bit affine, groups of
    ``q_group_size``, computed on ``device``.  Floating weights are first
    cast to the config's dtype, as the JAX package does.  Returns the
    quantized config."""
    cfg, params = load_params(from_path)
    params = _to_device(params, device)
    qcfg = QuantConfig(group_size=q_group_size, bits=q_bits)
    cfg = cfg.replace(quantized=qcfg)
    save_checkpoint(to_path, cfg, _quantize_tree(params, qcfg))
    _copy_tokenizer_files(from_path, to_path)
    return cfg


def create_random_checkpoint(path: str, preset_name: str, seed: int = 0, device="cpu",
                             **overrides) -> ModelConfig:
    """Write a random-weight checkpoint of a preset (``models/phi3.py:
    init_params`` from a ``torch.Generator`` on ``device`` seeded with
    ``seed``; each device draws its own numbers); a vision preset
    (``phi35_vision``, ``tiny_vision``) carries the CLIP tower and
    projection under ``model.vision_embed_tokens``."""
    from ..models.phi3 import init_params

    cfg = preset(preset_name, **overrides)
    save_checkpoint(path, cfg, init_params(cfg, torch.Generator(device=device).manual_seed(seed)))
    return cfg
