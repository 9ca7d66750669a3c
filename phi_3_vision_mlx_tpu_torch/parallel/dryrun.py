"""The multi-rank dry run (counterpart of ``__graft_entry__.py:
dryrun_multichip``).

:func:`dryrun_multichip` builds an n-rank mesh (data x model), shards a
small but structurally real Phi-3 (8 heads, 2 layers, vocab 4096; hidden
256 as in the JAX dry run, 768 on the card, whose attention kernels take
heads of 96) with the sharding rules, and runs one data- and tensor-parallel LoRA
training step, a prefill and a decode step with the dense and the int4
cache sharded by KV heads, the teacher-forced sharded decode against one
rank's whole model, the (dcn, data, model) forward at 8 ranks and more,
and ring attention over every rank.  It prints the JAX package's
``dryrun_multichip OK: ...`` line.

The JAX dry run re-executes itself on a virtual CPU mesh when the chips
are too few; here the caller names the device: ``"cuda"`` needs a card a
rank, ``"cpu"`` runs a gloo world.  Inside a world of the right size
(``distributed_init`` already called) it runs in this process, as each
rank; otherwise it spawns the world (``mesh.run_world``).  On the card
the model runs in bf16 (the int4 cache's kernels take a bf16 query), on
the CPU in fp32 as the JAX one does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import preset
from ..core.weights import params_to
from ..engine.state import quantize_chunk
from ..models import phi3
from ..ops.attention import causal_valid_mask, masked_attention
from ..train.lora import inject_lora, mask_lora_grads, merge_lora, partition_lora
from .mesh import axis_size, make_mesh, run_world
from .ring_attention import make_ring_attention
from .sharding import batch_shard, local_config, shard_batch, shard_params
from .tensor import TensorParallel, sync_gradients


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _copy_dicts(tree: dict) -> dict:
    """``tree`` with new dicts and the same tensors."""
    return _tree_map(lambda t: t, tree)


def _batch_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the batch shards (each rank's value a shard's)."""
    x = x.detach().clone()
    for a in ("dcn", "data"):
        if a in mesh.mesh_dim_names and axis_size(mesh, a) > 1:
            dist.all_reduce(x, group=mesh.get_group(a))
    return x / batch_shard(mesh)[1]


def _train_step(cfg, lcfg, full, mesh, tp, dev, b: int, l: int, rng) -> float:
    """One dp+tp LoRA step (AdamW, lr 1e-4, optax's weight decay 1e-4) on
    qkv of the last layer, rank 2; returns the loss over the whole batch."""
    params, layer_mask = inject_lora(_copy_dicts(full), cfg, ["self_attn.qkv_proj"], 1, 2,
                                     torch.Generator().manual_seed(1))
    trainable, frozen = partition_lora(shard_params(params, mesh))
    leaves = []
    trainable = _tree_map(lambda t: leaves.append(t.requires_grad_()) or t, trainable)
    optimizer = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    batch = shard_batch({
        "ids": rng.integers(2, 4000, (b, l)).astype(np.int64),
        "pids": np.tile(np.arange(l, dtype=np.int64), (b, 1)),
        "valid": np.ones((b, l), bool),
        "targets": rng.integers(2, 4000, (b, l - 1)).astype(np.int64),
        "loss_masks": np.ones((b, l - 1), np.float32),
    }, mesh, device=dev)
    logits = phi3.forward_nocache(merge_lora(frozen, trainable), lcfg, batch["ids"], pids=batch["pids"],
                                  prompt_valid=batch["valid"], allow_flash=False, tp=tp).float()
    ce = -torch.log_softmax(logits[:, :-1], dim=-1).gather(-1, batch["targets"][..., None])[..., 0]
    loss = (ce * batch["loss_masks"]).mean()
    loss.backward()
    grads = sync_gradients(_tree_map(lambda t: t.grad, trainable), mesh)
    _tree_map(lambda g: g.copy_(mask_lora_grads(g, layer_mask)), grads)
    optimizer.step()
    return float(_batch_mean(loss, mesh))


class ReplayEntries:
    """A cache writer (``phi3.decode_forward``'s ``write``) for a run that
    writes another run's quantized cache entries in place of its own and
    counts where its own differ.  Two runs whose sums go in another order
    (a tensor-parallel all-reduce, another package) give k and v 1 ulp
    apart, and rounding to 16 levels turns that into a whole level
    wherever it crosses a boundary, which moves the logits by 1e-3 to
    1e-1; with the entries replayed, the logits hold the model's
    arithmetic to the run's tolerance and the flips are counted apart
    (:meth:`check`).

    ``payload``, ``scales``: the other run's cache (layers, B, KV, L, ...)
    in the port's layout; ``rows`` and ``heads`` cut out this run's batch
    rows and KV heads.  The dry run needs it on its own (on the card as on
    the CPU), so it lives here and not beside the tests that use it too."""

    MAX_FLIP_SHARE = 1e-3  # of the values written

    def __init__(self, payload, scales, bits: int, rows=slice(None), heads=slice(None)):
        self.payload, self.scales = payload[:, rows, heads], scales[:, rows, heads]
        self.bits, self.values, self.flips, self.max_step = bits, 0, 0, 0

    def _levels(self, payload):
        return torch.stack([payload & 15, payload >> 4]) if self.bits == 4 else payload

    def __call__(self, state, layer, pos, k_new, v_new):
        if isinstance(pos, int):
            pos = torch.arange(pos, pos + k_new.shape[2], device=k_new.device)
        want_p = self.payload[layer][:, :, pos.cpu()].to(state.k.device)
        want_s = self.scales[layer][:, :, pos.cpu()].to(state.k.device)
        own_p, _ = quantize_chunk(k_new, v_new, state.kv_quant)
        step = (self._levels(own_p).int() - self._levels(want_p).int()).abs()
        self.values += step.numel()
        self.flips += int((step > 0).sum())
        self.max_step = max(self.max_step, int(step.max()))
        state.k[layer][:, :, pos], state.k_scales[layer][:, :, pos] = want_p, want_s

    def check(self) -> None:
        if not (self.values > 0 and self.max_step <= 1 and self.flips <= self.MAX_FLIP_SHARE * self.values):
            raise AssertionError(f"the run's own entries differ by up to {self.max_step} levels at "
                                 f"{self.flips} of {self.values} values")


def _decode(params, cfg, ids, steps: int, tp=None, forced=None, max_tokens: int = 8, write=None):
    """Prefill, then ``steps`` greedy (or ``forced``) decode steps, the
    cache written by ``write`` (``phi3.decode_forward``): the last logits
    of each, f32 on the host, and the state."""
    res = phi3.prefill(params, cfg, ids, max_tokens=max_tokens, tp=tp, write=write)
    seq = [res.logits[:, -1].float().cpu().numpy()]
    state = res.state
    for t in range(steps):
        tok = (res.logits[:, -1:].argmax(-1) if forced is None
               else torch.full((ids.shape[0], 1), forced[t], dtype=torch.long, device=ids.device))
        res = phi3.decode_forward(params, cfg, state, tok, tp=tp, write=write)
        state = res.state
        seq.append(res.logits[:, -1].float().cpu().numpy())
    return seq, state


def _parity(single, sharded) -> bool:
    """The JAX bar: logits within rtol 1e-4, atol 1e-5, and an argmax that
    differs only at a tie under 1e-4."""
    ok = True
    for a, b in zip(single, sharded):
        ok &= bool(np.allclose(a, b, rtol=1e-4, atol=1e-5))
        if int(np.argmax(a[0])) != int(np.argmax(b[0])):
            top2 = np.sort(a[0])[-2:]
            ok &= bool(top2[1] - top2[0] < 1e-4)
    return ok


@torch.no_grad()
def _ring_check(cfg, n: int, dev, rng) -> tuple:
    """Ring attention over all ``n`` ranks against plain causal attention
    (fp32, within 2e-4); returns the whole output's shape."""
    mesh = make_mesh(data=n, model=1)
    ring = make_ring_attention(mesh, seq_axis="data")
    lr = 16 * n
    shape = (2, cfg.num_attention_heads, lr, cfg.head_dim)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev) for _ in range(3))
    valid = torch.ones((2, lr), dtype=torch.bool, device=dev)
    r = dist.get_rank(mesh.get_group("data"))
    cols = slice(r * 16, (r + 1) * 16)
    out = ring(q[:, :, cols], k[:, :, cols], v[:, :, cols], valid[:, cols])
    ref = masked_attention(q, k, v, causal_valid_mask(valid, torch.arange(lr, device=dev)), cfg.head_dim ** -0.5)
    if not torch.allclose(out, ref[:, :, cols], rtol=2e-4, atol=2e-4):
        raise AssertionError(f"ring attention differs from causal attention by {(out - ref[:, :, cols]).abs().max()}")
    return (2, cfg.num_attention_heads, lr, cfg.head_dim)


def _dryrun(n: int, device: str) -> tuple:
    """The dry run on this rank of a world of ``n``; returns the line of
    the int4 decode on each rank's own entries, and the OK line."""
    data = 2 if n % 2 == 0 and n >= 4 else 1
    model = n // data
    mesh = make_mesh(data=data, model=model)
    tp = TensorParallel.of(mesh)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
    # The card's attention kernels take Phi-3.5's head size, 96.
    width = 96 * 8 if device == "cuda" else 256
    cfg = preset("tiny", hidden_size=width, intermediate_size=2 * width, num_attention_heads=8,
                 num_key_value_heads=8, num_hidden_layers=2, vocab_size=4096,
                 dtype="bfloat16" if device == "cuda" else "float32")
    full = params_to(phi3.init_params(cfg, torch.Generator().manual_seed(0)), dev)
    params = shard_params(full, mesh)
    lcfg = local_config(cfg, model)
    b, l = 2 * data, 32
    rng = np.random.default_rng(0)

    loss = _train_step(cfg, lcfg, full, mesh, tp, dev, b, l, rng)

    with torch.no_grad():
        ids = torch.as_tensor(rng.integers(2, 4000, (b, l)), device=dev)
        ids_local = shard_batch({"ids": ids.cpu()}, mesh, device=dev)["ids"]
        shards = batch_shard(mesh)[1]
        shapes = {}
        for quantized in (False, True):  # prefill + one decode step, the cache's heads on model
            seq, _ = _decode(params, lcfg.replace(use_quantized_cache=quantized), ids_local, 1, tp=tp)
            shapes[quantized] = (seq[-1].shape[0] * shards, seq[-1].shape[1])

        # The sharded decode against one rank's whole model, teacher-forced
        # with the whole model's greedy tokens, with the dense cache and
        # with the int4 cache (the whole model's entries of this rank's
        # heads replayed, ``ReplayEntries``).  The int4 decode on each
        # rank's own entries is read beside the JAX bar and reported.
        parity = True
        for quantized in (False, True):
            single, state = _decode(full, cfg.replace(use_quantized_cache=quantized), ids[:1], 4, max_tokens=16)
            forced = [int(np.argmax(lg[0])) for lg in single[:-1]]
            heads = lcfg.num_key_value_heads
            replay = ReplayEntries(state.k, state.k_scales, cfg.kv_quant.bits,
                                   heads=slice(tp.rank * heads, (tp.rank + 1) * heads)) if quantized else None
            qcfg = lcfg.replace(use_quantized_cache=quantized)
            sharded, _ = _decode(params, qcfg, ids[:1], 4, tp=tp, forced=forced, max_tokens=16, write=replay)
            if quantized:
                replay.check()
                own, _ = _decode(params, qcfg, ids[:1], 4, tp=tp, forced=forced, max_tokens=16)
                diff = max(float(np.abs(a - b).max()) for a, b in zip(single, own))
                own_line = (f"dryrun_multichip int4 sharded decode on each rank's own entries: max |logit diff| "
                            f"{diff:.3g} against one rank's whole model, the JAX bar (rtol 1e-4, atol 1e-5) "
                            f"{'met' if _parity(single, own) else 'not met'}; replayed: {replay.flips} of "
                            f"{replay.values} entries of this rank a level apart (limit "
                            f"{replay.MAX_FLIP_SHARE:g} of them)")
            if not _parity(single, sharded):
                raise AssertionError(f"sharded decode logits ({'int4' if quantized else 'dense'} cache) diverged "
                                     f"from the whole model's by {[float(np.abs(a - b).max()) for a, b in zip(single, sharded)]}")

        if n % 2 == 0 and n >= 8:  # the multi-host shape: batch over (dcn, data)
            mesh3 = make_mesh(dcn=2, data=data, model=n // (2 * data))
            tp3 = TensorParallel.of(mesh3)
            batch3 = shard_batch({"ids": rng.integers(2, 4000, (4 * data, l)),
                                  "pids": np.tile(np.arange(l), (4 * data, 1)),
                                  "valid": np.ones((4 * data, l), bool)}, mesh3, device=dev)
            phi3.forward_nocache(shard_params(full, mesh3), local_config(cfg, tp3.size), batch3["ids"],
                                 pids=batch3["pids"], prompt_valid=batch3["valid"], tp=tp3)

        ring_shape = _ring_check(cfg, n, dev, rng)
    return own_line, (f"dryrun_multichip OK: mesh=({data}x{model}), train loss={loss:.3f}, "
            f"decode logits={shapes[False]}, quantized-cache decode logits={shapes[True]}, "
            f"sharded-decode parity={parity}, ring-attn out={ring_shape}")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """The dry run over ``n_devices`` ranks on ``device`` (``"cuda"``: a
    card a rank, or it raises; ``"cpu"``: gloo).  In a world of that size
    it runs here, as this rank; with no process group it spawns one.
    Prints (rank 0) the reading of the int4 decode on each rank's own
    entries, then the OK line, and returns the OK line."""
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}, device='cuda') needs {n_devices} CUDA devices, "
                           f"this machine has {torch.cuda.device_count()}; pass device='cpu' for a gloo world")
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"a world of {dist.get_world_size()} ranks cannot run the dry run over {n_devices}")
        lines = _dryrun(n_devices, device)
        if dist.get_rank() == 0:
            print(*lines, sep="\n", flush=True)
        return lines[1]
    lines = run_world(_dryrun, n_devices, n_devices, device, device=device, timeout=600.0)[0]
    print(*lines, sep="\n", flush=True)
    return lines[1]
