"""Tensor parallelism's collectives: Megatron's conjugate operators over the
``model`` axis of a mesh.

Under ``jit`` the JAX package gets tensor parallelism from its sharding
specs alone: GSPMD inserts the all-reduces and all-gathers
(``parallel/sharding.py``).  Here the decoder calls them explicitly
(``models/phi3.py``: ``block``, the embedding and the lm_head take a
:class:`TensorParallel`), each a differentiable operator so that a LoRA
step's gradients come out right:

* :meth:`TensorParallel.enter` -- identity forward, all-reduce backward,
  before a column-parallel linear (qkv, gate_up, lm_head), whose input
  gradient is a partial sum on each rank;
* :meth:`TensorParallel.reduce` -- all-reduce forward, identity backward,
  after a row-parallel linear (o_proj, down_proj), whose output is;
* :meth:`TensorParallel.gather` -- the vocab-parallel logits gathered
  along the last axis, each rank's slice of the gradient backward;
* :meth:`TensorParallel.embed` -- the vocab-parallel embedding: each rank
  looks up the ids in its rows, zeros the others, and the ranks sum.

With one rank every collective is an identity, and the results are the
bits of the path without it.  :func:`sync_gradients` finishes a
data-parallel and tensor-parallel backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.linear import embedding
from .mesh import axis_size, batch_axes
from .sharding import MODEL, partial_over_model


class TensorParallel:
    """One rank's view of the tensor-parallel axis: its group, size and
    rank, and the collectives the model runs over it.  ``collectives``
    counts those this object ran (forward and backward)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.collectives = 0

    @classmethod
    def of(cls, mesh) -> "TensorParallel":
        return cls(mesh.get_group(MODEL))

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, in place on ``x`` (contiguous)."""
        self.collectives += 1
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along the last axis, in rank order."""
        self.collectives += 1
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _Enter.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        if not (torch.is_grad_enabled() and x.requires_grad):
            return self.all_reduce(x.contiguous())
        return _Reduce.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if not (torch.is_grad_enabled() and x.requires_grad):
            return self.all_gather(x)
        return _Gather.apply(x, self)

    def embed(self, p: dict, ids: torch.Tensor, dtype=None) -> torch.Tensor:
        """Lookup of ``ids`` in the vocab-parallel table leaf ``p`` (this
        rank's consecutive rows, quantized or not)."""
        rows = p["weight"].shape[0]
        local = ids.long() - self.rank * rows
        inside = (local >= 0) & (local < rows)
        x = embedding(p, local.clamp(0, rows - 1), dtype=dtype)
        return self.reduce(torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device)))


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.width = tp, x.shape[-1]
        return tp.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        r, w = ctx.tp.rank, ctx.width
        return g[..., r * w : (r + 1) * w].contiguous(), None


def sync_gradients(grads: dict, mesh) -> dict:
    """Finish the backward of a step over ``mesh``, in place: a leaf whose
    gradient is a partial sum over the ``model`` ranks
    (``sharding.partial_over_model``: LoRA's whole A before a
    column-parallel linear, its whole B after a row-parallel one) gets the
    sum; then every leaf takes the mean over the batch axes (``dcn`` and
    ``data``: each rank's loss is the mean over its rows of the batch).
    ``grads``: a nested dict of tensors in the trainable tree's shape."""
    model_group = mesh.get_group(MODEL) if axis_size(mesh, MODEL) > 1 else None
    batch = [(mesh.get_group(a), axis_size(mesh, a)) for a in batch_axes(mesh) if axis_size(mesh, a) > 1]
    n_batch = 1
    for _, n in batch:
        n_batch *= n

    def walk(node, path):
        for k, g in node.items():
            sub = f"{path}.{k}" if path else k
            if isinstance(g, dict):
                walk(g, sub)
                continue
            if model_group is not None and partial_over_model(sub):
                dist.all_reduce(g, group=model_group)
            for group, _ in batch:
                dist.all_reduce(g, group=group)
            if n_batch > 1:
                g.div_(n_batch)

    walk(grads, "")
    return grads
