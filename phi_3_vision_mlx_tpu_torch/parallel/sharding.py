"""Sharding rules: parameter, decode-state and batch specs, and each rank's
shards (counterpart of ``phi_3_vision_mlx_tpu/parallel/sharding.py``).

The specs are the JAX package's, rule for rule (:func:`_spec_for_param`):
a tuple with one mesh-axis name or None per dimension, as a
``PartitionSpec`` reads.  Megatron-style tensor parallelism of the Phi-3
decoder:

* fused qkv / gate_up projections: output dim N on ``model``;
* o_proj / down_proj: input dim K on ``model`` (partial sums, all-reduced);
* embed / lm_head: vocab on ``model``;
* KV cache: heads on ``model``, batch on ``data``;
* LoRA: A whole, B cut like its base's output (whole after o/down);
* vision tower, norms: whole.

The specs are the contract; the layout of a rank's shard is the port's
(:func:`shard_params`).  GSPMD cuts a fused projection's N into contiguous
pieces and reshards when the model splits q, k and v; explicit tensor
parallelism cannot reshard, so a rank must own whole heads.  Each segment
of a fused output (q, k, v; gate, up) is cut by heads and a rank's pieces
concatenated: rank r holds q heads ``[r H/tp, (r+1) H/tp)``, the same KV
heads' share of k and v, and the rows of o_proj that read its heads.  A
row-parallel linear (o_proj, down_proj) cuts its K rows with its ``(K/g,
N)`` scales and biases, so K/tp stays a multiple of the group (64) and of
the values a word holds (8 or 4).  Its LoRA A, whole in the spec, sees a
K-cut input: a rank holds A's rows of its K, and the sum after the linear
adds the ranks' ``(x_r @ A_r) @ B``, which is ``(x @ A) @ B``.  A packed
4-bit leaf (``{'weight': (K, N/2) uint8}``) is cut on its levels and laid
out again (packed where the shard fits the layout's 512-wide blocks, else
the word layout).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.config import ModelConfig
from ..core.weights import from_packed_layout, is_packed_leaf, pack_int4, packable, to_packed_layout
from .mesh import axis_size, batch_axes

MODEL = "model"  # the tensor-parallel mesh axis, the only one shard_params and sync_gradients cut
ROW_PARALLEL = ("o_proj", "down_proj")
COLUMN_PARALLEL = ("qkv_proj", "gate_up_proj")


def _spec_for_param(path: str, ndim: int) -> tuple:
    """The spec of a parameter leaf addressed by its dotted path (JAX
    ``_spec_for_param``, ``sharding.py:28-54``)."""
    def last(*axes):
        """Pad with leading Nones to ndim."""
        return tuple([None] * (ndim - len(axes)) + list(axes))

    if "vision_embed_tokens" in path:
        return ()
    if "lora_a" in path or "lora_scale" in path:
        return ()
    if "lora_b" in path:
        if "o_proj" in path or "down_proj" in path:
            return ()
        return last(MODEL)
    if "embed_tokens" in path:
        return (MODEL, None) if ndim == 2 else ()
    if "lm_head" in path:
        return last(MODEL)
    if "qkv_proj" in path or "gate_up_proj" in path:
        return last(MODEL)
    if "o_proj" in path or "down_proj" in path:
        return last(MODEL, None)
    return ()


def _walk(params: dict, fn, path: str = ""):
    if isinstance(params, dict):
        return {k: _walk(v, fn, f"{path}.{k}" if path else k) for k, v in params.items()}
    return fn(path, params)


def param_shardings(params: dict, mesh=None) -> dict:
    """The tree of specs matching ``params`` (the port's leaves: full,
    word 4-bit and 8-bit, packed, LoRA).  The specs do not depend on the
    mesh (the JAX package binds each to it in a ``NamedSharding``)."""
    return _walk(params, lambda path, t: _spec_for_param(path, getattr(t, "ndim", 0)))


def partial_over_model(path: str) -> bool:
    """Whether a rank's gradient of this leaf is a partial sum over the
    ``model`` ranks: LoRA's A (held whole) before a column-parallel linear,
    whose output each rank holds a cut of, and its B (held whole) after a
    row-parallel one, whose input is cut."""
    row = any(name in path for name in ROW_PARALLEL)
    return (path.endswith("lora_a") and not row) or (path.endswith("lora_b") and row)


@dataclasses.dataclass(frozen=True)
class LocalConfig(ModelConfig):
    """A ``ModelConfig`` as one tensor-parallel rank sees it: its heads, KV
    heads and MLP width (``local_head_dim`` keeps the head size, which the
    base class derives from the head count)."""

    local_head_dim: int = 0

    @property
    def head_dim(self) -> int:
        return self.local_head_dim


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """``cfg`` with a rank's share of the heads, KV heads and MLP width of a
    ``tp``-way tensor-parallel model (``cfg`` itself at one rank)."""
    if tp == 1:
        return cfg
    h, kv, i = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size
    if h % tp or kv % tp or i % tp:
        raise ValueError(f"{h} heads, {kv} KV heads and MLP width {i} do not split {tp} ways")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    fields.update(num_attention_heads=h // tp, num_key_value_heads=kv // tp, intermediate_size=i // tp)
    return LocalConfig(**fields, local_head_dim=cfg.head_dim)


def _cut(t: torch.Tensor, dim: int, segments, r: int, tp: int) -> torch.Tensor:
    """Rank ``r``'s share of each segment (widths along ``dim``), concatenated."""
    pieces, start = [], 0
    for width in segments:
        if width % tp:
            raise ValueError(f"a segment of {width} along dim {dim} of {tuple(t.shape)} does not split {tp} "
                             "ways (a row-parallel K must split into multiples of the group and the word)")
        share = width // tp
        pieces.append(t.narrow(dim, start + r * share, share))
        start += width
    return torch.cat(pieces, dim=dim).contiguous()


def _segments(path: str, n: int, hidden: int):
    """The widths of a column-parallel output of N columns: q, k, v (q is
    ``hidden`` wide: H x D = E in Phi-3), gate and up, or one."""
    if "qkv_proj" in path:
        return (hidden, (n - hidden) // 2, (n - hidden) // 2)
    if "gate_up_proj" in path:
        return (n // 2, n // 2)
    return (n,)


def _shard_packed(path: str, node: dict, r: int, tp: int, hidden: int) -> dict:
    """A packed 4-bit linear leaf, cut on its levels and laid out again."""
    group = node["weight"].shape[-2] // node["scales"].shape[-2]
    node = {**node, "weight": from_packed_layout(node["weight"], group)}
    out = {key: _shard_leaf(f"{path}.{key}", t, r, tp, hidden) for key, t in node.items()}
    q = out.pop("weight")
    if packable(q.shape[-2], q.shape[-1], group):
        out["weight"] = to_packed_layout(q, group)
    else:
        out["qweight"] = pack_int4(q)
    return out


def _shard_leaf(path: str, t: torch.Tensor, r: int, tp: int, hidden: int) -> torch.Tensor:
    """Rank ``r``'s shard of leaf ``path`` (layouts of the module docstring)."""
    row = any(name in path for name in ROW_PARALLEL)
    if "vision_embed_tokens" in path or path.endswith("lora_scale") or (path.endswith("lora_b") and row):
        return t
    if path.endswith("lora_a"):
        return _cut(t, -2, (t.shape[-2],), r, tp) if row else t
    if "embed_tokens" in path:
        return _cut(t, 0, (t.shape[0],), r, tp) if t.dim() == 2 else t
    if row:
        if path.endswith(".bias"):  # added once, after the sum
            return t if r == 0 else torch.zeros_like(t)
        return _cut(t, -2, (t.shape[-2],), r, tp)
    if "lm_head" in path or any(name in path for name in COLUMN_PARALLEL):
        return _cut(t, -1, _segments(path, t.shape[-1], hidden), r, tp)
    return t


def shard_params(params: dict, mesh) -> dict:
    """This rank's shards of ``params`` (on their devices) over the
    ``MODEL`` axis of ``mesh``: plain tensors of the layouts of the module
    docstring.  A rank runs them with ``local_config(cfg, tp)`` and a
    ``tensor.TensorParallel`` of the mesh (``models/phi3.py``)."""
    return local_shards(params, mesh.get_local_rank(MODEL), axis_size(mesh, MODEL))


def local_shards(params: dict, r: int, tp: int) -> dict:
    """Rank ``r``'s shards of ``params`` in a ``tp``-way split (the whole
    tree, its tensors unchanged, at ``tp`` 1)."""
    if tp == 1:
        return params
    hidden = params["model"]["norm"]["weight"].shape[-1]

    def walk(node, path):
        if not isinstance(node, dict):
            return _shard_leaf(path, node, r, tp, hidden)
        if is_packed_leaf(node):
            return _shard_packed(path, node, r, tp, hidden)
        return {k: walk(v, f"{path}.{k}" if path else k) for k, v in node.items()}

    return walk(params, "")


def state_shardings(cfg: ModelConfig, mesh=None, quantized_cache: Optional[bool] = None) -> dict:
    """Specs of a decode state's fields (``engine/state.py``): cache heads
    on ``model``, batch on ``data``.  The quantized cache's payload and
    scale planes keep layer first, batch second and KV heads third, as the
    dense ``k`` and ``v`` do, so one spec serves every cache tensor."""
    quantized_cache = cfg.use_quantized_cache if quantized_cache is None else quantized_cache
    kv = (None, "data", MODEL, None, None)
    return {"k": kv, "v": None if quantized_cache else kv, "k_scales": kv if quantized_cache else None,
            "pos": (), "valid": ("data", None), "cos": (None, None, None), "sin": (None, None, None)}


def batch_shard(mesh):
    """(this rank's index, the number of shards) of a batch dimension cut
    over the batch axes: over (dcn, data) jointly on a mesh with ``dcn``."""
    index, count = 0, 1
    for a in batch_axes(mesh):
        index, count = index * axis_size(mesh, a) + mesh.get_local_rank(a), count * axis_size(mesh, a)
    return index, count


def shard_batch(batch: dict, mesh, device=None) -> dict:
    """This rank's rows of host batch arrays (leading axis cut over the
    batch axes), as tensors on ``device`` (default: the mesh's)."""
    index, count = batch_shard(mesh)
    device = device or mesh.device_type

    def cut(x):
        x = torch.as_tensor(x)
        if x.shape[0] % count:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over {count} shards")
        rows = x.shape[0] // count
        return x[index * rows : (index + 1) * rows].to(device)

    return {k: cut(v) for k, v in batch.items()}
