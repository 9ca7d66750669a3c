"""Full-parameter causal-LM training and the synthetic induction corpus
(counterpart of ``phi_3_vision_mlx_tpu/train/pretrain.py``).

The reference trains only LoRA adapters; the JAX package adds from-scratch
training of tiny Phi-3 configs, whose first user is its speculative-decoding
benchmark: a tiny model trained on the induction corpus learns to copy
repeated phrases, so prompt-lookup drafts are accepted through phrase
bodies and rejected at phrase boundaries.  The port trains full-precision
weights through the plain paths (no kernel runs), one optimizer step at a
time: the JAX package's ``scan_steps`` (several steps a compiled dispatch)
has no counterpart here.  The JAX package's end-to-end helpers over this
module (``train_induction_lm``, ``measure_tokens_per_pass``) serve its
``bench_extra.py``, which is not ported, and are left out with it.
"""

from __future__ import annotations

import math
import string
from typing import Iterable, List, Tuple

import numpy as np
import torch

from ..core.config import ModelConfig
from ..models import phi3
from ..models.tokenizer import ByteTokenizer

# ---------------------------------------------------------------------------
# Loss and train loop
# ---------------------------------------------------------------------------


def make_clm_loss(cfg: ModelConfig):
    """Next-token cross-entropy over every parameter: one ``forward_nocache``
    pass, shifted targets, pad positions masked out (the LoRA loss without
    the adapter merge and dropout)."""

    def loss_fn(params, ids, valid):
        logits = phi3.forward_nocache(params, cfg, ids, prompt_valid=valid, allow_flash=False)
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


def pretrain(
    cfg: ModelConfig,
    params: dict,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    lr: float = 1e-3,
    warmup: int = 20,
    steps: int | None = None,
) -> Tuple[dict, List[float]]:
    """AdamW (weight decay 0.01) over ``batches`` of (ids (B, L) int32,
    valid (B, L) bool), cycled for ``steps`` steps (default: one pass), at
    :func:`warmup_cosine`'s rate.  Trains float copies of ``params``' float
    tensors on their device; returns (trained params, loss history)."""
    bl = list(batches)
    n = steps if steps is not None else len(bl)
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
    opt = torch.optim.AdamW(leaves, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    loss_fn = make_clm_loss(cfg)
    losses: List[float] = []
    for k in range(n):
        ids, valid = bl[k % len(bl)]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, torch.as_tensor(ids, device=device), torch.as_tensor(valid, device=device))
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = warmup_cosine(k, lr, warmup, decay_steps)
        opt.step()
        losses.append(float(loss.detach()))
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


# ByteTokenizer maps byte b -> id 1000 + b, BOS = 1; 1280 covers every id the
# raw (untemplated) corpus can produce while keeping the lm_head tiny.
INDUCTION_VOCAB = 1280
