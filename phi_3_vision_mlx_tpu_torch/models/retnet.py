"""Byte-level RetNet x Phi hybrid (counterpart of
``phi_3_vision_mlx_tpu/models/retnet.py``).

A tokenizer-free byte-vocab Phi variant whose attention is replaced by
multi-scale-decay retention.  Per head with decay ``g``:

    parallel:   Y_n = sum_{m<=n} g^(n-m) (q_n . k_m) v_m
    recurrent:  S_n = g S_{n-1} + k_n^T v_n ;  Y_n = q_n S_n

with q and k rotated by xPos-style rotations at absolute positions
(interleaved pairs).  Both forms are one function: train with the O(L^2)
parallel form, serve with the recurrent form, whose state is O(heads x
d^2) with no cache window (``tests/test_torch_retnet.py`` holds them
equal).  Everything runs in float32; on the card TF32 stays off (the
matmuls are fp32 on the CUDA cores, as ``chip_smoke.py`` sets them).  No
kernel: the JAX module is plain XLA too.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

BOS = 256
VOCAB = 258  # 256 bytes + BOS + one spare (EOS)


@dataclasses.dataclass(frozen=True)
class RetNetConfig:
    hidden_size: int = 256
    intermediate_size: int = 512
    num_hidden_layers: int = 4
    num_heads: int = 4
    vocab_size: int = VOCAB

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def encode_bytes(s: str, add_bos: bool = True) -> list:
    ids = list(s.encode("utf-8"))
    return ([BOS] + ids) if add_bos else ids


def decode_bytes(ids) -> str:
    return bytes(int(i) for i in np.asarray(ids).reshape(-1) if int(i) < 256).decode("utf-8", errors="replace")


def init_params(cfg: RetNetConfig, generator: torch.Generator) -> dict:
    """Random float32 parameters on ``generator``'s device (the JAX law:
    linears ``(in, out)`` with scale ``in ** -0.5``, the embedding 0.02,
    unit norms; ``torch.Generator`` gives other numbers than
    ``jax.random``)."""
    d, f, dev = cfg.hidden_size, cfg.intermediate_size, generator.device

    def dense(d_in, d_out):
        return torch.randn((d_in, d_out), generator=generator, device=dev) * d_in ** -0.5

    def layer():
        return {"wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d), "wg": dense(d, d), "wo": dense(d, d),
                "w_gate_up": dense(d, 2 * f), "w_down": dense(f, d),
                "norm_ret": torch.ones(d, device=dev), "norm_mlp": torch.ones(d, device=dev)}

    return {
        "embed": torch.randn((cfg.vocab_size, d), generator=generator, device=dev) * 0.02,
        "layers": [layer() for _ in range(cfg.num_hidden_layers)],
        "norm_f": torch.ones(d, device=dev),
        "lm_head": dense(d, cfg.vocab_size),
    }


def _decays(cfg: RetNetConfig, device=None) -> torch.Tensor:
    """Multi-scale per-head decay ``g_h = 1 - 2^(-5-h)``."""
    h = torch.arange(cfg.num_heads, dtype=torch.float32, device=device)
    return 1.0 - torch.exp2(-5.0 - h)


def _rotate(x, pos):
    """xPos-style rotation of x (B, H, T, Dh) at absolute positions ``pos``
    (B|1, T), over interleaved pairs (dims 2i, 2i + 1)."""
    d = x.shape[-1]
    freqs = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = pos[..., None].float() * freqs  # (B, T, d/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def _heads(x, n: int):
    b, t, d = x.shape
    return x.reshape(b, t, n, d // n).transpose(1, 2)


def _unheads(x):
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _head_norm(y):
    """Per-position, per-head RMS normalization (the same in both forms)."""
    return y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + 1e-6)


def _rms(x, w):
    return w * x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6)


def _qkvg(p, x, cfg: RetNetConfig, pos):
    q = _rotate(_heads(x @ p["wq"], cfg.num_heads), pos)
    k = _rotate(_heads(x @ p["wk"], cfg.num_heads), pos) * (cfg.head_dim ** -0.5)
    v = _heads(x @ p["wv"], cfg.num_heads)
    gate = F.silu(x @ p["wg"])
    return q, k, v, gate


def _retention_parallel(q, k, v, decays):
    """(B, H, T, Dh) x3 -> (B, H, T, Dh) through the O(T^2) decay-masked form."""
    t = q.shape[2]
    n = torch.arange(t, dtype=torch.float32, device=q.device)
    delta = n[:, None] - n[None, :]  # n - m
    # D[h, n, m] = g_h^(n-m) for n >= m else 0, computed in log space.
    logd = torch.log(decays)[:, None, None] * delta
    dmask = torch.where(delta >= 0, torch.exp(logd), 0.0)
    scores = torch.einsum("bhnd,bhmd->bhnm", q, k) * dmask
    return torch.einsum("bhnm,bhmd->bhnd", scores, v)


class RetState(NamedTuple):
    """Recurrent carry: per-layer outer-product state + absolute position."""

    s: torch.Tensor  # (num_layers, B, H, Dh, Dh) float32
    pos: torch.Tensor  # () int64


def init_state(cfg: RetNetConfig, batch: int, params: dict) -> RetState:
    """A zero carry for ``batch`` rows on the device of ``params``."""
    dev = params["embed"].device
    shape = (cfg.num_hidden_layers, batch, cfg.num_heads, cfg.head_dim, cfg.head_dim)
    return RetState(s=torch.zeros(shape, dtype=torch.float32, device=dev),
                    pos=torch.zeros((), dtype=torch.long, device=dev))


def _retention_chunk(q, k, v, s_prev, decays):
    """Chunkwise-recurrent form: within-chunk parallel + cross-chunk state.
    q/k/v (B, H, T, Dh) at absolute rotations, s_prev (B, H, Dh, Dh).
    Returns (y, s_new) with y equal to the parallel form run from step 0."""
    t = q.shape[2]
    inner = _retention_parallel(q, k, v, decays)
    i = torch.arange(t, dtype=torch.float32, device=q.device)
    g = decays[None, :, None, None]  # (1, H, 1, 1)
    # cross contribution: Y_i += q_i g^(i+1) S_prev
    cross_w = g ** (i[None, None, :, None] + 1.0)
    y = inner + torch.einsum("bhtd,bhde->bhte", q * cross_w, s_prev)
    # state update: S = g^T S_prev + sum_i g^(T-1-i) k_i^T v_i
    kw = k * (g ** (t - 1.0 - i[None, None, :, None]))
    s_new = (g ** t) * s_prev + torch.einsum("bhtd,bhte->bhde", kw, v)
    return y, s_new


def _mlp(p, x):
    gate, up = (x @ p["w_gate_up"]).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ p["w_down"]


def _block(p, x, y_ret, gate):
    """Shared post-retention path: head-norm, gate, project, MLP residual."""
    y = _unheads(_head_norm(y_ret)) * gate
    x = x + y @ p["wo"]
    return x + _mlp(p, _rms(x, p["norm_mlp"]))


def forward_parallel(params: dict, cfg: RetNetConfig, ids) -> torch.Tensor:
    """Training/prefill form: (B, L) ids -> (B, L, V) logits, O(L^2)."""
    ids = torch.as_tensor(ids, device=params["embed"].device).long()
    decays = _decays(cfg, ids.device)
    x = params["embed"][ids]
    pos = torch.arange(ids.shape[1], device=ids.device).expand(ids.shape)
    for p in params["layers"]:
        q, k, v, gate = _qkvg(p, _rms(x, p["norm_ret"]), cfg, pos)
        x = _block(p, x, _retention_parallel(q, k, v, decays), gate)
    return _rms(x, params["norm_f"]) @ params["lm_head"]


def forward_recurrent(params: dict, cfg: RetNetConfig, ids, state: RetState):
    """Serving form: (B, T) chunk + state -> ((B, T, V) logits, new state)."""
    ids = torch.as_tensor(ids, device=params["embed"].device).long()
    decays = _decays(cfg, ids.device)
    x = params["embed"][ids]
    t = ids.shape[1]
    pos = (state.pos + torch.arange(t, device=ids.device)).expand(ids.shape)
    new_s = []
    for li, p in enumerate(params["layers"]):
        q, k, v, gate = _qkvg(p, _rms(x, p["norm_ret"]), cfg, pos)
        y, s = _retention_chunk(q, k, v, state.s[li], decays)
        new_s.append(s)
        x = _block(p, x, y, gate)
    logits = _rms(x, params["norm_f"]) @ params["lm_head"]
    return logits, RetState(s=torch.stack(new_s), pos=state.pos + t)


def _leaves(params: dict) -> list:
    out = [params["embed"], params["norm_f"], params["lm_head"]]
    for p in params["layers"]:
        out.extend(p[k] for k in sorted(p))
    return out


def train_byte_lm(params: dict, cfg: RetNetConfig, texts, steps: int = 100, lr: float = 1e-3):
    """Train on ``texts`` (one padded batch, the mean cross-entropy over the
    real next bytes) with Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8
    added to the root of the second moment).  Returns (new params, the loss
    of each step, before its update)."""
    rows = [encode_bytes(t) for t in texts]
    maxlen = max(len(r) for r in rows)
    ids = np.zeros((len(rows), maxlen), np.int64)
    mask = np.zeros((len(rows), maxlen - 1), np.float32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r) - 1] = 1.0
    dev = params["embed"].device
    ids, mask = torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)
    params = {
        **{k: v.detach().clone().requires_grad_() for k, v in params.items() if k != "layers"},
        "layers": [{k: v.detach().clone().requires_grad_() for k, v in p.items()} for p in params["layers"]],
    }
    opt = torch.optim.Adam(_leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        logits = forward_parallel(params, cfg, ids)
        ce = F.cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size), ids[:, 1:].reshape(-1),
                             reduction="none").reshape(mask.shape)
        loss = (ce * mask).sum() / mask.sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    detach = lambda t: t.detach()  # noqa: E731
    return ({**{k: detach(v) for k, v in params.items() if k != "layers"},
             "layers": [{k: detach(v) for k, v in p.items()} for p in params["layers"]]}, losses)


@torch.no_grad()
def generate_bytes(params: dict, cfg: RetNetConfig, prompt: str, max_tokens: int = 32) -> str:
    """Greedy bytes after ``prompt`` through the recurrent form, up to
    ``max_tokens`` or the first id past the byte range."""
    state = init_state(cfg, 1, params)
    logits, state = forward_recurrent(params, cfg, [encode_bytes(prompt)], state)
    out = []
    tok = logits[:, -1:].argmax(dim=-1)
    for _ in range(max_tokens):
        out.append(int(tok[0, 0]))
        if out[-1] >= 256:
            break
        logits, state = forward_recurrent(params, cfg, tok, state)
        tok = logits[:, -1:].argmax(dim=-1)
    return decode_bytes(out)
