"""Rank functions of the port's multi-rank CPU tests (``test_torch_parallel.py``,
``test_torch_ring.py``), run by ``parallel/mesh.py:run_world`` in spawned
gloo worlds.  A spawned rank imports this module by name, so it imports
neither JAX nor the JAX package; the tests hand each rank numpy inputs
(weights from a numpy seed, JAX's tokens and cache entries) and compare
what the ranks return with the JAX package in the test process."""

import numpy as np
import torch

from phi_3_vision_mlx_tpu_torch.core.convert import from_numpy_params
from phi_3_vision_mlx_tpu_torch.engine.engine import LM, generate_text
from phi_3_vision_mlx_tpu_torch.models import phi3
from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3Processor
from phi_3_vision_mlx_tpu_torch.models.tokenizer import ByteTokenizer
from phi_3_vision_mlx_tpu_torch.parallel.dryrun import ReplayEntries
from phi_3_vision_mlx_tpu_torch.parallel.mesh import make_mesh
from phi_3_vision_mlx_tpu_torch.parallel.ring_attention import make_ring_attention
from phi_3_vision_mlx_tpu_torch.parallel.sharding import local_config, shard_batch, shard_params
from phi_3_vision_mlx_tpu_torch.parallel.tensor import TensorParallel, sync_gradients
from phi_3_vision_mlx_tpu_torch.train.lora import inject_lora, merge_lora, partition_lora


def numpy_params(cfg, seed: int) -> dict:
    """A text model's weights in the JAX ``init_params`` tree, drawn with
    numpy (norms around 1, so that they are not the identity)."""
    rng = np.random.default_rng(seed)
    e, i, v, nl = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_hidden_layers
    h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hidden_size // cfg.num_attention_heads

    def nrm(shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def norm(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "model": {
            "embed_tokens": {"weight": nrm((v, e), 0.02)},
            "layers": {
                "self_attn": {"qkv_proj": {"weight": nrm((nl, e, (h + 2 * kv) * d))},
                              "o_proj": {"weight": nrm((nl, h * d, e))}},
                "mlp": {"gate_up_proj": {"weight": nrm((nl, e, 2 * i))},
                        "down_proj": {"weight": nrm((nl, i, e))}},
                "input_layernorm": {"weight": norm(nl, e)},
                "post_attention_layernorm": {"weight": norm(nl, e)},
            },
            "norm": {"weight": norm(e)},
        },
        "lm_head": {"weight": nrm((e, v))},
    }


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _decode(params, cfg, ids, forced, tp=None, max_tokens: int = 16, write=None):
    """Prefill and one decode step per forced token, the cache written by
    ``write`` (``phi3.decode_forward``): each forward's logits."""
    res = phi3.prefill(params, cfg, ids, max_tokens=max_tokens, tp=tp, write=write)
    out, state = [res.logits.numpy()], res.state
    for tok in forced:
        res = phi3.decode_forward(params, cfg, state, torch.full((ids.shape[0], 1), tok), tp=tp, write=write)
        out.append(res.logits.numpy())
        state = res.state
    return out, state


def parallel_suite(tree, cfg, prefill_ids, decode_ids, forced, jax_entries, train):
    """One rank of a (data 2, model 2) world: the sharded prefill of
    ``prefill_ids`` (this rank's rows); the decode of ``decode_ids``
    teacher-forced with ``forced`` (the dense cache's tokens, the int4
    cache's), the int4 cache replaying ``jax_entries`` (payload, scales in
    the port's layout) for this rank's heads; and one dp+tp LoRA step's
    loss and synced gradients."""
    mesh = make_mesh(data=2, model=2)
    tp = TensorParallel.of(mesh)
    full = from_numpy_params(tree, cfg)
    params, lcfg = shard_params(full, mesh), local_config(cfg, 2)
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    with torch.no_grad():
        res = phi3.prefill(params, lcfg, shard_batch({"ids": prefill_ids}, mesh)["ids"], max_tokens=4, tp=tp)
        out["prefill"] = res.logits.numpy()
        out["state_shapes"] = {k: tuple(getattr(res.state, k).shape) for k in ("k", "v", "valid", "cos")}
        out["collectives"] = tp.collectives
        ids = torch.as_tensor(decode_ids)
        out["decode_dense"], _ = _decode(params, lcfg, ids, forced[0], tp=tp)
        kv = lcfg.num_key_value_heads
        replay = ReplayEntries(*jax_entries, cfg.kv_quant.bits, heads=slice(tp.rank * kv, (tp.rank + 1) * kv))
        out["decode_int4"], _ = _decode(params, lcfg.replace(use_quantized_cache=True), ids, forced[1], tp=tp,
                                        write=replay)
        out["replay"] = (replay.values, replay.flips, replay.max_step)

    lora_a, batch = train
    trainable, frozen = lora_tree(tree, cfg, lora_a, mesh)
    loss, grads = lora_loss_and_grads(trainable, frozen, lcfg, shard_batch(batch, mesh), tp)
    sync_gradients(grads, mesh)
    loss = torch.tensor(loss)
    torch.distributed.all_reduce(loss, group=mesh.get_group("data"))
    out["loss"], out["grads"] = float(loss) / 2, _tree_numpy(grads)
    return out


def lora_tree(tree, cfg, lora_a, mesh=None):
    """(trainable, frozen) of the model with LoRA on the last layer's qkv at
    rank 2, A given (JAX's), B zero, cut for this rank of ``mesh``; the
    trainable leaves take gradients."""
    params, _ = inject_lora(from_numpy_params(tree, cfg), cfg, ["self_attn.qkv_proj"], 1, 2,
                            torch.Generator().manual_seed(1))
    params["model"]["layers"]["self_attn"]["qkv_proj"]["lora_a"] = torch.tensor(lora_a)
    trainable, frozen = partition_lora(params if mesh is None else shard_params(params, mesh))
    for t in trainable["model"]["layers"]["self_attn"]["qkv_proj"].values():
        t.requires_grad_()
    return trainable, frozen


def lora_loss_and_grads(trainable, frozen, cfg, batch, tp=None):
    """The JAX ``train_step_loss`` loss (mean masked cross-entropy over the
    batch) of LoRA leaves ``trainable`` and its gradients (a tree of the
    trainable leaves' shape)."""
    logits = phi3.forward_nocache(merge_lora(frozen, trainable), cfg, batch["ids"], pids=batch["pids"],
                                  prompt_valid=batch["valid"], allow_flash=False, tp=tp).float()
    ce = -torch.log_softmax(logits[:, :-1], dim=-1).gather(-1, batch["targets"].long()[..., None])[..., 0]
    loss = (ce * batch["loss_masks"]).mean()
    loss.backward()

    def grads(node):
        return {k: grads(v) if isinstance(v, dict) else v.grad for k, v in node.items()}

    return float(loss.detach()), grads(trainable)


def ring_suite(cases, tree, cfg, ids, forced, int4, lm_tree, lm_cfg, prompt):
    """One rank of a ring of 4 (``data``): ``ring_self_attention`` on this
    rank's shards of each (q, k, v, valid) case; ``prefill_ring`` of
    ``ids`` with the dense cache, then the forced decode steps, and with
    the int4 cache (its last logits and the gathered cache); the int4
    ``prefill_ring`` and its decode forced with ``int4``'s tokens,
    replaying ``int4``'s entries (payload, scales in the port's layout);
    and ``generate_text`` through ``LM(sp_mesh=)``."""
    mesh = make_mesh(data=4)
    r = mesh.get_local_rank("data")
    ring = make_ring_attention(mesh, seq_axis="data")
    out = {"attention": []}
    with torch.no_grad():
        for q, k, v, valid in cases:
            n = q.shape[2] // 4
            cols = slice(r * n, (r + 1) * n)
            out["attention"].append(ring(*(torch.as_tensor(t[:, :, cols]) for t in (q, k, v)),
                                         torch.as_tensor(valid[:, cols])).numpy())
        params = from_numpy_params(tree, cfg)
        res = phi3.prefill_ring(params, cfg, torch.as_tensor(ids), mesh, max_tokens=8)
        logits, state = [res.logits.numpy()], res.state
        out["ring_kv"] = (state.k.clone().numpy(), state.v.clone().numpy())
        for tok in forced:
            res = phi3.decode_forward(params, cfg, state, torch.full((ids.shape[0], 1), tok))
            logits.append(res.logits.numpy())
            state = res.state
        out["prefill_ring"] = logits
        res = phi3.prefill_ring(params, cfg.replace(use_quantized_cache=True), torch.as_tensor(ids), mesh,
                                max_tokens=8, last_logit_only=True)
        out["prefill_ring_int4"] = (res.logits.numpy(), res.state.k.numpy(), res.state.k_scales.float().numpy())
        forced_int4, entries = int4
        replay = ReplayEntries(*entries, cfg.kv_quant.bits)
        qcfg = cfg.replace(use_quantized_cache=True)
        res = phi3.prefill_ring(params, qcfg, torch.as_tensor(ids), mesh, max_tokens=8, write=replay)
        logits, state = [res.logits.numpy()], res.state
        for tok in forced_int4:
            res = phi3.decode_forward(params, qcfg, state, torch.full((ids.shape[0], 1), tok), write=replay)
            logits.append(res.logits.numpy())
            state = res.state
        out["ring_int4_decode"], out["ring_int4_replay"] = logits, (replay.values, replay.flips, replay.max_step)

    lm = LM(lm_cfg, from_numpy_params(lm_tree, lm_cfg), device="cpu", sp_mesh=mesh)
    proc = Phi3Processor(tokenizer=ByteTokenizer())
    out["text"] = generate_text(lm, proc, prompt, max_tokens=6, verbose=False, stream=False, mute=True)
    out["ring_prefills"] = lm.ring_prefills
    return out


def linger_after_result(rank: int) -> int:
    """This rank's number; rank ``rank`` does not end after writing it (its
    ``os._exit`` sleeps), as a rank of a pytest-xdist worker now and then
    did not."""
    import os
    import time

    if torch.distributed.get_rank() == rank:
        os._exit = lambda code: time.sleep(3600)
    return torch.distributed.get_rank()


def fail_on(rank: int) -> int:
    """Rank ``rank`` raises; the others wait for it at a barrier."""
    if torch.distributed.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
    return torch.distributed.get_rank()


def hang_before_result(rank: int) -> int:
    """Rank ``rank`` never returns."""
    import time

    if torch.distributed.get_rank() == rank:
        time.sleep(3600)
    return torch.distributed.get_rank()
