"""Full-parameter causal-LM training and the synthetic induction corpus
(counterpart of ``phi_3_vision_mlx_tpu/train/pretrain.py``).

The reference trains only LoRA adapters; the JAX package adds from-scratch
training of tiny Phi-3 configs, whose first user is its speculative-decoding
benchmark: a tiny model trained on the induction corpus learns to copy
repeated phrases, so prompt-lookup drafts are accepted through phrase
bodies and rejected at phrase boundaries (:func:`train_induction_lm`, then
:func:`measure_tokens_per_pass`).  The port trains full-precision weights
through the plain paths (no kernel runs in the step: the linears are
``torch.matmul``, as the JAX package computes them outside any Pallas
kernel).  As the JAX package scans ``scan_steps`` optimizer steps in one
compiled dispatch, the port runs a chunk of ``scan_steps`` steps as one
static step (``engine/graphs.py:StaticStep`` over a stacked (m, B, L) batch
buffer and an (m,) rate buffer, the loss of each step its output): on the
card one CUDA graph a chunk length, captured at its first chunk and
replayed after, the graphs of a run in one memory pool; on the CPU, and
with ``graphs=False``, the same steps run eagerly, one at a time.  The
optimizer is ``train/adamw.py``'s (the step count and the rate on the
device).  :func:`measure_tokens_per_pass` serves the trained checkpoint
with prompt-lookup speculation: on the card the prefill runs K2 and the
verify passes K3, at the induction model's head dim of 32.
"""

from __future__ import annotations

import math
import os
import string
from typing import Iterable, List, Tuple

import numpy as np
import torch

from ..core.config import ModelConfig, preset
from ..engine.graphs import StaticStep
from ..models import phi3
from ..models.tokenizer import ByteTokenizer
from ..ops.rope import su_rope_tables
from .adamw import AdamW

# ---------------------------------------------------------------------------
# Loss and train loop
# ---------------------------------------------------------------------------


def make_clm_loss(cfg: ModelConfig):
    """Next-token cross-entropy over every parameter: one ``forward_nocache``
    pass, shifted targets, pad positions masked out (the LoRA loss without
    the adapter merge and dropout).  ``rope``: the (cos, sin) tables of the
    L positions, made beforehand (a captured step), or None."""

    def loss_fn(params, ids, valid, rope=None):
        logits = phi3.forward_nocache(params, cfg, ids, prompt_valid=valid, allow_flash=False, rope=rope)
        logits = logits[:, :-1].float()
        ce = -torch.log_softmax(logits, dim=-1).gather(-1, ids[:, 1:].long()[..., None])[..., 0]
        m = (valid[:, 1:] & valid[:, :-1]).float()
        return (ce * m).sum() / m.sum().clamp(min=1.0)

    return loss_fn


def warmup_cosine(step: int, lr: float, warmup: int, decay_steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps)``:
    linear from 0 to ``lr`` over ``warmup`` steps, then a cosine to 0 at
    ``decay_steps``."""
    if step < warmup:
        return lr * step / warmup
    span = decay_steps - warmup
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(step - warmup, span) / span))


def chunk_step(loss_fn, params: dict, leaves: List[torch.Tensor], optimizer: AdamW, rope):
    """``chunk(ids (m, B, L), valid (m, B, L), rates (m,)) -> losses (m,)``:
    ``m`` optimizer steps in turn (the JAX ``lax.scan`` body: the loss, its
    gradients, one AdamW step at ``rates[j]``), all on device tensors, in
    place, reading no host value."""

    def chunk(ids, valid, rates):
        losses = []
        for j in range(ids.shape[0]):
            loss = loss_fn(params, ids[j], valid[j], rope)
            optimizer.step(torch.autograd.grad(loss, leaves), lr=rates[j:j + 1])
            losses.append(loss.detach())
        return torch.stack(losses)

    return chunk


def pretrain(
    cfg: ModelConfig,
    params: dict,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    lr: float = 1e-3,
    warmup: int = 20,
    steps: int | None = None,
    scan_steps: int = 1,
    graphs: bool | None = None,
) -> Tuple[dict, List[float]]:
    """AdamW (weight decay 0.01) over ``batches`` of (ids (B, L) int32,
    valid (B, L) bool), cycled for ``steps`` steps (default: one pass), at
    :func:`warmup_cosine`'s rate, in chunks of ``scan_steps`` steps (step
    ``k + j`` of the chunk at ``k`` takes batch ``(k + j) % len(batches)``;
    the tail chunk has ``n - k`` steps).  All batches share one (B, L).
    ``graphs`` (default: on for CUDA) replays each chunk length's CUDA
    graph; without, the steps run eagerly.  Trains float copies of
    ``params``' float tensors on their device; returns (trained params, one
    loss a step)."""
    bl = list(batches)
    n = steps if steps is not None else len(bl)
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
    decay_steps = max(n, warmup + 1)

    def trainable(node):
        if isinstance(node, dict):
            return {k: trainable(v) for k, v in node.items()}
        t = node.detach().clone()
        return t.requires_grad_() if t.is_floating_point() else t

    params = trainable(params)
    leaves = []

    def collect(node):
        for v in node.values():
            if isinstance(v, dict):
                collect(v)
            elif v.requires_grad:
                leaves.append(v)

    collect(params)
    device = leaves[0].device
    graphs = device.type == "cuda" if graphs is None else bool(graphs)
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}; pass graphs=False")
    optimizer = AdamW(leaves, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    rope = su_rope_tables(cfg, bl[0][0].shape[1], None, device=device)
    chunk = chunk_step(make_clm_loss(cfg), params, leaves, optimizer, rope)
    pool = torch.cuda.graph_pool_handle() if graphs else None
    chunks = {}  # chunk length -> its static step
    losses: List[float] = []
    k = 0
    while k < n:
        m = min(scan_steps, n - k)  # the tail chunk: one more graph
        picked = [bl[(k + j) % len(bl)] for j in range(m)]
        args = (torch.as_tensor(np.stack([b[0] for b in picked]), device=device),
                torch.as_tensor(np.stack([b[1] for b in picked]), device=device),
                torch.as_tensor(np.asarray([warmup_cosine(k + j, lr, warmup, decay_steps) for j in range(m)],
                                           np.float32), device=device))
        if m not in chunks:
            chunks[m] = StaticStep(chunk, [torch.empty_like(a) for a in args],
                                   torch.zeros((m,), dtype=torch.float32, device=device), device, graphs,
                                   save=leaves + optimizer.state_tensors(), pool=pool)
        losses.extend(chunks[m](*args).tolist())
        k += m
    for t in leaves:
        t.requires_grad_(False)
    return params, losses


# ---------------------------------------------------------------------------
# Induction corpus
# ---------------------------------------------------------------------------


def induction_docs(
    rng: np.random.Generator,
    n_docs: int,
    n_phrases: int = 4,
    phrase_len: int = 8,
    phrases_per_doc: int = 14,
    shared_pool: int = 0,
) -> List[str]:
    """Docs made of repeated random phrases (the induction task): each doc
    draws ``n_phrases`` fresh random lowercase phrases of ``phrase_len``
    letters and joins ``phrases_per_doc`` uniform choices of them with
    spaces, so every phrase recurs 3-4 times and a next-byte model must
    learn to copy from its context.  ``shared_pool`` > 0 mixes in that many
    corpus-wide phrases (memorizable across docs)."""
    letters = np.array(list(string.ascii_lowercase))
    globals_pool = [
        "".join(rng.choice(letters, phrase_len)) for _ in range(shared_pool)
    ]
    docs = []
    for _ in range(n_docs):
        local = ["".join(rng.choice(letters, phrase_len)) for _ in range(n_phrases)]
        pool = local + globals_pool
        docs.append(" ".join(pool[rng.integers(len(pool))] for _ in range(phrases_per_doc)))
    return docs


def encode_docs(docs: List[str], seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """ByteTokenizer ids (N, seq_len) int32 and their valid mask."""
    tok = ByteTokenizer()
    ids = np.zeros((len(docs), seq_len), np.int32)
    valid = np.zeros((len(docs), seq_len), bool)
    for i, d in enumerate(docs):
        e = tok.encode(d)[:seq_len]
        ids[i, : len(e)] = e
        valid[i, : len(e)] = True
    return ids, valid


def induction_batches(
    seed: int, n_batches: int, bs: int, seq_len: int, **doc_kw
) -> List[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        ids, valid = encode_docs(induction_docs(rng, bs, **doc_kw), seq_len)
        out.append((ids, valid))
    return out


# ---------------------------------------------------------------------------
# End to end: train a tiny induction LM and save it as a checkpoint
# ---------------------------------------------------------------------------

# ByteTokenizer maps byte b -> id 1000 + b, BOS = 1; 1280 covers every id the
# raw (untemplated) corpus can produce while keeping the lm_head tiny.
INDUCTION_VOCAB = 1280


def train_induction_lm(
    path: str,
    steps: int = 240,
    bs: int = 8,
    seq_len: int = 128,
    lr: float = 1.5e-3,
    seed: int = 0,
    n_batches: int = 24,
    scan_steps: int = 1,
    device="cuda",
    **overrides,
):
    """Train the tiny induction LM (the ``tiny`` preset: hidden 128 over 4
    heads of 32, fp32) from scratch on ``device`` (the card unless the caller
    asks for the CPU) and write a checkpoint at ``path`` (``config.json`` +
    safetensors, which both packages' ``api._load`` read).  Returns (cfg,
    loss history).  Deterministic in ``seed``; the initial weights are the
    port's own draw (``phi3.init_params``), not JAX's."""
    from ..core import weights as W

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to train on the CPU")
    cfg = preset(
        "tiny",
        vocab_size=INDUCTION_VOCAB,
        max_position_embeddings=1024,
        original_max_position_embeddings=256,
        **overrides,
    )
    params = phi3.init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    batches = induction_batches(seed + 1, n_batches, bs, seq_len)
    params, losses = pretrain(cfg, params, batches, lr=lr, steps=steps, scan_steps=scan_steps)
    W.save_checkpoint(path, cfg, W.params_to(params, "cpu"))
    return cfg, losses


def measure_tokens_per_pass(
    preload,
    prompt: str,
    max_tokens: int = 96,
    spec_k: int = 7,
) -> Tuple[float, str]:
    """Greedy prompt-lookup generation through ``api.generate(speculative=
    True)`` (K from ``PHI3V_TPU_SPEC_K``, set to ``spec_k`` unless already
    set, as the JAX helper does); returns (tokens a verify pass, text)."""
    from .. import api

    lm, _ = preload
    os.environ.setdefault("PHI3V_TPU_SPEC_K", str(spec_k))
    text = api.generate(
        prompt,
        preload=preload,
        max_tokens=max_tokens,
        verbose=False,
        stream=False,
        mute=True,
        speculative=True,
        apply_chat_template=False,
    )
    st = lm._spec_stats
    tpp = st["emitted"] / max(st["iters"], 1)
    return tpp, text
