"""Tiered KV cache: the prompt's int4 cache in (pinned) host memory, a small
hot window on the card (counterpart of ``phi_3_vision_mlx_tpu/engine/
tiered.py``).

One H100 holds a 128K-token window in HBM (the in-HBM path,
``engine/engine.py``); this engine serves windows whose cache should not sit
on the card: a 128K request beside other live ones, or a window whose cache
does not fit beside other models.

* **Cold tier**: the prompt's KV, immutable after prefill, in the port's own
  int4 layout (``engine/state.py``: payload ``(layers, B, KV, PC, D)`` uint8,
  scales ``(layers, B, KV, PC, 4G)`` bf16), one pair of tensors per prompt
  chunk of PC tokens.  On the card they are pinned host memory; on the CPU
  (the tests) plain host memory.  The TPU's D-permuted, transposed layout is
  not used.
* **Hot tier**: a ``DecodeState`` of ``hot`` positions on the device; fresh
  KV is quantized and written there as the in-HBM int4 path writes it.
* **Attention** is the JAX package's exact two-part online-softmax combine:
  stats (running max, sum, unnormalized output) over the cold tier, key
  block by key block with each block dequantized as it is read, merged with
  the stats over the hot window.  The JAX package computes it in XLA, with
  no Pallas kernel, so this is plain PyTorch: the same key blocks and the
  same running maxima, scored a group of blocks a pass (a decode step
  joins a layer's cold chunks on the device and takes them in a few
  groups, where one pass a chunk would launch ~20 operations for each of
  33 chunks in 32 layers at a 131072 window).  Its dots take bf16 inputs
  with f32 accumulation on the card and f32 inputs on the CPU;
  ``PHI3V_TPU_TIERED_BF16=0/1`` overrides (JAX ``_bf16_dots``).  The
  linears run the port's kernels (K1, K8, K9) through ``models/phi3.py:
  block``.

Prefill evicts as it goes: the prompt runs in chunks of PC tokens, each
chunk's quantized KV is copied to the host layer by layer (on the card:
``non_blocking`` on a copy stream) and no device copy of the whole prompt's
cache ever exists; later chunks stream the chunks already evicted.

Decode streams each layer's cold slices host-to-device.  With ``prefetch``
(default; ``PHI3V_TPU_TIERED_PREFETCH=0`` turns it off) layer i + 1's slices
are copied on the copy stream while layer i computes, into the other of two
device buffers, ordered by CUDA events (no host sync inside a step); layer
0's slices stay on the device (``TieredState.dev0``), as the JAX engine
keeps them, so a step's first layer waits for no copy.  Without prefetch
each layer's copy runs on the compute stream before it.  On the CPU there
is nothing to copy and both modes compute the same.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.weights import torch_dtype
from ..models import phi3
from ..ops.rope import su_rope_tables
from .state import dequantize_kv, init_state, quantize_chunk, read_kv, update_layer_chunk

NEG_INF = float(np.finfo(np.float32).min)


# ---------------------------------------------------------------------------
# Exact partial-attention stats (online-softmax pieces that combine exactly)
# ---------------------------------------------------------------------------


class AttnStats(NamedTuple):
    m: torch.Tensor  # (B, KV, G, Lq) running max
    l: torch.Tensor  # (B, KV, G, Lq) running sum of exp
    acc: torch.Tensor  # (B, KV, G, Lq, D) unnormalized output


def _zero_stats(b, kv, g, lq, d, device) -> AttnStats:
    return AttnStats(
        m=torch.full((b, kv, g, lq), NEG_INF, dtype=torch.float32, device=device),
        l=torch.zeros((b, kv, g, lq), dtype=torch.float32, device=device),
        acc=torch.zeros((b, kv, g, lq, d), dtype=torch.float32, device=device),
    )


def _fold_q(q, kv_heads: int):
    """(B, H, Lq, D) -> (B, KV, H // KV, Lq, D): GQA grouping."""
    b, h, lq, d = q.shape
    return q.reshape(b, kv_heads, h // kv_heads, lq, d)


def _bf16_dots(device) -> bool:
    """bf16-input / f32-accumulate attention dots (JAX ``_bf16_dots``):
    on by default on the card, off on the CPU (where the parity tests hold
    tiered against in-HBM in f32); ``PHI3V_TPU_TIERED_BF16=0/1``
    overrides."""
    env = os.environ.get("PHI3V_TPU_TIERED_BF16")
    if env is not None:
        return env != "0"
    return torch.device(device).type != "cpu"


# A group of key blocks is scored in one batched pass while it holds at most
# GROUP_SCORES f32 scores and GROUP_KEYS keys (their dequantized k and v: 384
# MiB of bf16 at 32 KV heads of 96): a decode step scores a layer's cold tier
# in a few groups, a prefill chunk (thousands of queries) a block at a time.
GROUP_SCORES = 1 << 24
GROUP_KEYS = 1 << 15


def _dot(a, b, bf16: bool):
    """Batched ``a @ b`` (leading dims broadcast) with an f32 result.
    ``bf16``: the inputs rounded to bf16 and the products summed in f32
    (JAX ``preferred_element_type=float32``): on the card one bf16
    tensor-core ``bmm`` with an f32 output; on the CPU, which has no such
    ``bmm``, the bf16 values widened to f32, whose products are exact."""
    if not bf16:
        return torch.matmul(a.float(), b.float())
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    if a.device.type == "cuda":
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
    else:
        out = torch.bmm(a3.float(), b3.float())
    return out.reshape(*lead, a.shape[-2], b.shape[-1])


def _update_stats(st: AttnStats, s, v, kb: int, bf16: bool) -> AttnStats:
    """Key blocks of ``kb``: s (B, KV, G, Lq, n * kb) f32 scores, masked
    with NEG_INF (overwritten); v (B, KV, n * kb, D).

    Block j's weights are exp(s - m_j), m_j the running max through block j,
    as the JAX package's scan takes them (so bf16 dots round the same
    values); the blocks' sums join the carry rescaled by exp(m_j - m_new),
    the product of the scan's exp(m_{i-1} - m_i) over the blocks after j."""
    b, kvh, g, lq, lk = s.shape
    n, d = lk // kb, v.shape[-1]
    s = s.view(b, kvh, g, lq, n, kb)
    m_run = torch.cummax(torch.cat([st.m[..., None], s.amax(dim=-1)], dim=-1), dim=-1).values
    m_new = m_run[..., -1]
    p = s.sub_(m_run[..., 1:, None]).exp_()
    # Rows masked so far keep m = NEG_INF; exp(NEG_INF - NEG_INF) would be 1,
    # so a rescale from such a max is 0, as the scan's guard makes it (and a
    # row masked throughout keeps its last block, as the scan's does).
    w = torch.where(m_run > NEG_INF / 2, torch.exp(m_run - m_new[..., None]), 0.0)
    w[..., -1] = 1.0
    w0, wb = w[..., 0], w[..., 1:]
    l_new = w0 * st.l + (p.sum(dim=-1) * wb).sum(dim=-1)
    if bf16:
        p = p.to(torch.bfloat16)
    upd = _dot(p.movedim(4, 2).reshape(b, kvh, n, g * lq, kb), v.reshape(b, kvh, n, kb, d), bf16)
    upd = torch.einsum("bkngqd,bkgqn->bkgqd", upd.view(b, kvh, n, g, lq, d), wb)
    return AttnStats(m=m_new, l=l_new, acc=st.acc * w0[..., None] + upd)


def _scores(q, k, scale: float, bf16: bool):
    """(B, KV, G, Lq, Lk) f32 scores, scaled as the JAX package scales
    them: bf16 dots scale the f32 products, f32 dots the queries."""
    kt = k.transpose(-1, -2)[:, :, None]
    if bf16:
        return _dot(q, kt, True).mul_(scale)
    return _dot((q * scale).float(), kt, False)


def _mask(s, key_ok, lk0: int, q_pos, key_pos0):
    """Set the scores of keys the queries may not see to NEG_INF, in place:
    keys ``key_ok`` (B, Lk) rules out (None: every key of the block is
    valid) and, with ``q_pos``, keys after a query's position."""
    lk = s.shape[-1]
    allowed = None if key_ok is None else key_ok[:, lk0 : lk0 + lk][:, None, None, None, :]
    if q_pos is not None:
        kp = key_pos0 + lk0 + torch.arange(lk, device=s.device)
        causal = (kp[None, :] <= q_pos[:, None])[None, None, None]
        allowed = causal if allowed is None else allowed & causal
    return s if allowed is None else s.masked_fill_(~allowed, NEG_INF)


def _block_size(k_block: int, lk: int) -> int:
    k_block = min(k_block, lk)
    while lk % k_block:
        k_block //= 2
    return k_block


def _stats_blocks(q, lk: int, kb: int, read, key_ok, scale, carry: AttnStats, q_pos, key_pos0,
                  bf16: bool) -> AttnStats:
    """Stats of q (B, KV, G, Lq, D) over ``lk`` keys in blocks of ``kb``
    (dividing ``lk``), a group of blocks a pass; ``read(j0, j1)`` gives keys
    [j0, j1)'s k, v (B, KV, j1 - j0, D)."""
    b, kvh, g, lq, _ = q.shape
    span = max(1, min(GROUP_SCORES // (b * kvh * g * lq * kb), GROUP_KEYS // kb)) * kb
    st = carry
    for j in range(0, lk, span):
        k, v = read(j, min(lk, j + span))
        s = _mask(_scores(q, k, scale, bf16), key_ok, j, q_pos, key_pos0)
        st = _update_stats(st, s, v, kb, bf16)
    return st


def _stats_over(q, k, v, key_ok, scale, k_block: int, carry: AttnStats, q_pos=None, key_pos0=0,
                bf16: bool = False) -> AttnStats:
    """Accumulate stats of q against (k, v) in key blocks.

    q (B, KV, G, Lq, D); k, v (B, KV, Lk, D); key_ok (B, Lk) bool, or None
    where every key is valid.  ``q_pos`` (Lq,) and ``key_pos0`` add the
    causal condition key_pos <= q_pos."""
    lk = k.shape[2]
    return _stats_blocks(q, lk, _block_size(k_block, lk),
                         lambda j0, j1: (k[:, :, j0:j1], v[:, :, j0:j1]),
                         key_ok, scale, carry, q_pos, key_pos0, bf16)


def _dequant_cold(payload, scales, bits: int, dtype):
    """A cold slice, payload (B, KV, PC, D | 2D) + scales (B, KV, PC, 4G) ->
    k, v (B, KV, PC, D) in ``dtype`` (``engine/state.py:dequantize_kv``)."""
    return dequantize_kv(payload, scales, dtype, bits)


def _stats_over_packed(q, payload, scales, key_ok, scale, k_block: int, carry: AttnStats,
                       bits: int, dtype, q_pos=None, key_pos0=0, bf16: bool = False) -> AttnStats:
    """:func:`_stats_over` over a quantized slice, each group of key blocks
    dequantized as it is read (the dequantized keys die with their pass)."""
    lk = payload.shape[2]
    return _stats_blocks(q, lk, _block_size(k_block, lk),
                         lambda j0, j1: _dequant_cold(payload[:, :, j0:j1], scales[:, :, j0:j1], bits, dtype),
                         key_ok, scale, carry, q_pos, key_pos0, bf16)


def _finalize(st: AttnStats, dtype):
    l = torch.where(st.l == 0.0, 1.0, st.l)
    o = st.acc / l[..., None]  # (B, KV, G, Lq, D)
    b, kvh, g, lq, d = o.shape
    return o.reshape(b, kvh * g, lq, d).to(dtype)


# ---------------------------------------------------------------------------
# The cold tier's streams
# ---------------------------------------------------------------------------


class _Cold:
    """Each layer's cold slices on the device, for one pass over the layers.

    ``host_k``/``host_s``: the chunks' host tensors (layers, B, KV, PC, ...);
    ``bufs``: two sets of device tensors, one slice of each chunk (the
    state's, reused every pass); ``dev0``: layer 0's slices kept on the
    device (prefetch only).  On the CPU the host tensors are read in place."""

    def __init__(self, host_k, host_s, device, prefetch: bool, bufs, dev0=None):
        self.host_k, self.host_s = host_k, host_s
        self.cuda = torch.device(device).type == "cuda" and bool(host_k)
        self.prefetch = prefetch and self.cuda
        self.bufs, self.dev0 = bufs, dev0
        if self.cuda:
            self.main = torch.cuda.current_stream(device)
            self.copy = _copy_stream(device) if self.prefetch else self.main
            self.ready = [torch.cuda.Event() for _ in range(2)]
            self.free = [torch.cuda.Event() for _ in range(2)]

    def _fetch(self, layer: int, slot: int) -> None:
        with torch.cuda.stream(self.copy):
            self.copy.wait_event(self.free[slot])  # no-op before the slot's first use
            for buf, host in zip(self.bufs[slot], self._hosts(layer)):
                buf.copy_(host, non_blocking=True)
            self.ready[slot].record(self.copy)

    def _hosts(self, layer: int):
        return [t[layer] for t in self.host_k] + [t[layer] for t in self.host_s]

    def start(self) -> None:
        """Before layer 0.  Prefetch: the copy stream first waits for the
        work already queued (an earlier pass may still read the buffers),
        then starts layer 1's copy."""
        if self.prefetch:
            self.copy.wait_stream(self.main)
            if len(self.host_k[0]) > 1:
                self._fetch(1, 1)

    def layer(self, i: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Layer ``i``'s (payload, scales) per chunk, ready to read."""
        n = len(self.host_k)
        if not self.cuda:
            return [(self.host_k[c][i], self.host_s[c][i]) for c in range(n)]
        if self.prefetch and i == 0:
            return list(zip(self.dev0[0], self.dev0[1]))
        slot = i % 2
        if self.prefetch:
            if i + 1 < len(self.host_k[0]):
                self._fetch(i + 1, (i + 1) % 2)
        else:
            self._fetch(i, slot)
        self.main.wait_event(self.ready[slot])
        bufs = self.bufs[slot]
        return list(zip(bufs[:n], bufs[n:]))

    def done(self, i: int) -> None:
        """After layer ``i``'s reads: its buffer may be written again."""
        if self.prefetch and i > 0:
            self.free[i % 2].record(self.main)


_COPY_STREAMS: dict = {}


def _copy_stream(device):
    device = torch.device(device)
    if device not in _COPY_STREAMS:
        _COPY_STREAMS[device] = torch.cuda.Stream(device)
    return _COPY_STREAMS[device]


def _device_bufs(host_k, host_s, device):
    """Two sets of device slices shaped like one layer of each chunk."""
    return [[torch.empty(t.shape[1:], dtype=t.dtype, device=device) for t in host_k + host_s]
            for _ in range(2)]


# ---------------------------------------------------------------------------
# The tiered layer pass (shared by prefill chunks and decode steps)
# ---------------------------------------------------------------------------


def _tiered_layers(cfg, layers, x, cold: _Cold, cold_valid, cold_full, cos, sin, *, hot=None,
                   hot_pos=None, valid_self=None, k_block: int, evict=None):
    """Run every decoder layer with two-tier attention.

    Decode (``hot`` a DecodeState): the chunk's k/v go into the hot window at
    ``hot_pos`` (Lq,) and the queries see the cold tier, then the hot
    window up to their own positions.  Prefill (``hot`` None): the chunk's
    k/v are quantized, the queries see the cold tier, then the chunk itself
    causally (quantize-then-read, as later steps will), and ``evict(layer,
    payload, scales)`` takes the chunk's quantized layer.  ``cold_full``:
    per cold chunk, whether every row's columns there are valid (the host
    knows the prompt's padding), so its scores need no mask."""
    scale = cfg.head_dim ** -0.5
    kvh, g = cfg.num_key_value_heads, cfg.num_attention_heads // cfg.num_key_value_heads
    bits, dtype = cfg.kv_quant.bits, x.dtype
    bf16 = _bf16_dots(x.device)
    b, lq, _ = x.shape

    def attend(q, k, v, i):
        qg = _fold_q(q, kvh)
        st = _zero_stats(b, kvh, g, lq, cfg.head_dim, x.device)
        slices, full = cold.layer(i), cold_full
        if slices:
            kb = _block_size(k_block, slices[0][0].shape[2])  # the JAX engine's blocks: within a chunk
        if hot is not None and len(slices) > 1:
            # A step's few queries score the whole cold tier in a few groups
            # of blocks: its chunks joined on the device.
            slices, full = [tuple(torch.cat(ts, dim=2) for ts in zip(*slices))], [all(cold_full)]
        col0 = 0
        for c, (payload, scales) in enumerate(slices):
            pc = payload.shape[2]
            ok = None if full[c] else cold_valid[:, col0 : col0 + pc]
            st = _stats_over_packed(qg, payload, scales, ok, scale, kb, st, bits, dtype, bf16=bf16)
            col0 += pc
        cold.done(i)
        if hot is not None:
            update_layer_chunk(hot, i, hot_pos, k, v)
            kh, vh = read_kv(hot, i, dtype)
            ok_h = hot.valid & (torch.arange(kh.shape[2], device=x.device) <= hot_pos[-1])[None]
            st = _stats_over(qg, kh, vh, ok_h, scale, k_block, st, q_pos=hot_pos, bf16=bf16)
        else:
            payload, scales = quantize_chunk(k, v, cfg.kv_quant)
            st = _stats_over_packed(qg, payload, scales, valid_self, scale, k_block, st, bits, dtype,
                                    q_pos=torch.arange(lq, device=x.device), bf16=bf16)
            evict(i, payload, scales)
        return _finalize(st, dtype)

    cold.start()
    for i in range(cfg.num_hidden_layers):
        x = phi3.block(cfg, x, layers, i, cos, sin, lambda q, k, v, i=i: attend(q, k, v, i))
    return x


# ---------------------------------------------------------------------------
# Tiered state + prefill + decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TieredState:
    """A request's two-tier decode state.

    cold_k / cold_s: per-chunk host tensors (layers, B, KV, PC, D | 2D)
    uint8 and (layers, B, KV, PC, 4G) bf16, pinned on the card; cold_valid
    (B, C) bool on the device; cold_full: per chunk, whether all of its
    columns are valid; hot: the DecodeState of the hot window
    (offsets relative to it); cos/sin: the whole window's RoPE tables;
    dev0: (payloads, scales), each chunk's layer-0 slice on the device
    (prefetch only); bufs: the two sets of device slices decode streams
    into."""

    cfg: object
    cold_k: List[torch.Tensor]
    cold_s: List[torch.Tensor]
    cold_valid: torch.Tensor
    hot: object
    cos: torch.Tensor
    sin: torch.Tensor
    C: int
    PC: int
    cold_full: Optional[List[bool]] = None
    dev0: Optional[tuple] = None
    bufs: Optional[list] = None

    @property
    def prefetch(self) -> bool:
        return self.dev0 is not None

    @property
    def window(self) -> int:
        return self.C + self.hot.window

    @property
    def offset_abs(self) -> int:
        return self.C + self.hot.offset

    def cold_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.cold_k + self.cold_s)


def _pad_to_chunks(dict_input, pc: int):
    from .engine import pad_prompt_inputs

    l = np.asarray(dict_input["input_ids"]).shape[1]
    l_pad = max(-(-l // pc) * pc, pc)
    return pad_prompt_inputs(dict_input, l_pad) + (l_pad,)


class TieredEngine:
    """Prefill with eviction + streamed decode over a tiered cache.

    Usage::

        eng = TieredEngine(lm, chunk=4096, hot=512)
        logits, state = eng.prefill(dict_input)   # the cold tier fills up
        logits, state = eng.decode_step(state, tok)
    """

    def __init__(self, lm, chunk: int = 4096, hot: int = 512, k_block: int = 2048,
                 prefetch: Optional[bool] = None):
        cfg = lm.cfg
        if not cfg.use_quantized_cache:
            cfg = cfg.replace(use_quantized_cache=True)
        if cfg.kv_quant.bits != 4:
            raise ValueError(f"the cold tier holds the int4 cache, not int{cfg.kv_quant.bits}")
        self.lm, self.cfg = lm, cfg
        self.pc, self.hot_window, self.k_block = int(chunk), int(hot), int(k_block)
        if prefetch is None:
            prefetch = os.environ.get("PHI3V_TPU_TIERED_PREFETCH", "1") != "0"
        self.prefetch = bool(prefetch)

    @property
    def device(self):
        return self.lm.device

    def _host_empty(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _cold(self, state: TieredState) -> _Cold:
        if state.bufs is None and self.device.type == "cuda":
            state.bufs = _device_bufs(state.cold_k, state.cold_s, self.device)
        return _Cold(state.cold_k, state.cold_s, self.device, state.prefetch, state.bufs, state.dev0)

    # -- prefill ---------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, dict_input: dict) -> Tuple[np.ndarray, TieredState]:
        """Chunked prefill with each chunk's cache evicted to the host.
        Returns (last-position logits (B, V) f32 numpy, state)."""
        lm, cfg, pc, dev = self.lm, self.cfg, self.pc, self.device
        ids_p, pids_p, valid_p, l_pad = _pad_to_chunks(dict_input, pc)
        b, n_chunks = ids_p.shape[0], l_pad // pc
        cos, sin = su_rope_tables(cfg, l_pad + self.hot_window, torch.as_tensor(pids_p), device=dev)
        valid = torch.as_tensor(valid_p, device=dev)
        ids = torch.as_tensor(ids_p, dtype=torch.long, device=dev)
        nl, kvh, d = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
        g = d // min(cfg.kv_quant.group_size, d)
        cold_k = [self._host_empty((nl, b, kvh, pc, d), torch.uint8) for _ in range(n_chunks)]
        cold_s = [self._host_empty((nl, b, kvh, pc, 4 * g), torch.bfloat16) for _ in range(n_chunks)]
        cuda = dev.type == "cuda"
        prefetch = self.prefetch and cuda
        dev0 = ([], []) if prefetch else None
        bufs = _device_bufs(cold_k, cold_s, dev) if cuda and n_chunks > 1 else None
        copy = _copy_stream(dev) if cuda else None
        full = [bool(valid_p[:, c * pc : (c + 1) * pc].all()) for c in range(n_chunks)]
        logits = None
        for c in range(n_chunks):
            if cuda and c:  # the chunks evicted so far have reached the host
                torch.cuda.current_stream(dev).wait_stream(copy)
            cold = _Cold(cold_k[:c], cold_s[:c], dev, prefetch,
                         [s[:c] + s[n_chunks : n_chunks + c] for s in bufs] if c and cuda else None, dev0)

            def evict(i, payload, scales, c=c):
                if prefetch and i == 0:
                    dev0[0].append(payload)
                    dev0[1].append(scales)
                if not cuda:
                    cold_k[c][i].copy_(payload)
                    cold_s[c][i].copy_(scales)
                    return
                copy.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(copy):
                    cold_k[c][i].copy_(payload, non_blocking=True)
                    cold_s[c][i].copy_(scales, non_blocking=True)
                payload.record_stream(copy)
                scales.record_stream(copy)

            x = phi3._embed(lm.params, cfg, ids[:, c * pc : (c + 1) * pc], None)
            x = _tiered_layers(cfg, lm.params["model"]["layers"], x, cold, valid[:, : c * pc], full[:c],
                               cos[:, c * pc : (c + 1) * pc], sin[:, c * pc : (c + 1) * pc],
                               valid_self=valid[:, c * pc : (c + 1) * pc], k_block=self.k_block,
                               evict=evict)
            logits = phi3._head(lm.params, cfg, x, last_logit_only=True)[:, 0].float()
        if cuda:
            torch.cuda.current_stream(dev).wait_stream(copy)
        hot = init_state(cfg, b, 0, self.hot_window, compute_dtype=torch_dtype(cfg.dtype), device=dev)
        state = TieredState(cfg, cold_k, cold_s, valid, hot, cos, sin, C=l_pad, PC=pc, cold_full=full,
                            dev0=dev0 if prefetch else None)
        return logits.cpu().numpy(), state

    # -- decode ----------------------------------------------------------------

    def _forward(self, state: TieredState, ids, hot_pos):
        """The (B, Lq) chunk ``ids`` at hot positions ``hot_pos`` (Lq,) on the
        device: its logits (B, Lq, V); the hot window's offset is the
        caller's to advance."""
        lm, cfg = self.lm, self.cfg
        b = ids.shape[0]
        x = phi3._embed(lm.params, cfg, ids, None)
        cols = state.C + hot_pos
        cos = phi3._rows(state.cos.index_select(1, cols), b)
        sin = phi3._rows(state.sin.index_select(1, cols), b)
        x = _tiered_layers(cfg, lm.params["model"]["layers"], x, self._cold(state), state.cold_valid,
                           state.cold_full, cos, sin, hot=state.hot, hot_pos=hot_pos, k_block=self.k_block)
        return phi3._head(lm.params, cfg, x)

    def _step_ids(self, tok):
        return torch.as_tensor(np.asarray(tok), dtype=torch.long).to(self.device).reshape(-1, 1)

    @torch.no_grad()
    def decode_step(self, state: TieredState, tok) -> Tuple[torch.Tensor, TieredState]:
        """One step: (B, 1) token ids -> ((B, V) f32 logits on the device,
        state)."""
        off = state.hot.offset
        if off + 1 > state.hot.window:
            raise ValueError(f"the hot window of {state.hot.window} is full")
        pos = torch.arange(off, off + 1, device=self.device)
        logits = self._forward(state, self._step_ids(tok), pos)[:, -1].float()
        state.hot.pos.add_(1)
        state.hot = dataclasses.replace(state.hot, offset=off + 1)
        return logits, state

    @torch.no_grad()
    def decode_chunk(self, state: TieredState, tok, n_steps: int):
        """``n_steps`` greedy steps, each token fed back on the device and
        fetched once at the end.  Returns ((n_steps, B) int numpy, state)."""
        off = state.hot.offset
        if off + n_steps > state.hot.window:
            raise ValueError(f"{n_steps} steps at offset {off} overflow the hot window "
                             f"of {state.hot.window}")
        ids, toks = self._step_ids(tok), []
        for s in range(n_steps):
            pos = torch.arange(off + s, off + s + 1, device=self.device)
            ids = self._forward(state, ids, pos)[:, -1].argmax(dim=-1, keepdim=True)
            toks.append(ids[:, 0])
            state.hot.pos.add_(1)
        state.hot = dataclasses.replace(state.hot, offset=off + n_steps)
        return torch.stack(toks).cpu().numpy(), state

    def generate(self, dict_input: dict, max_tokens: int, eos_id: Optional[int] = None,
                 chunk_steps: Optional[int] = None) -> List[int]:
        """Greedy tiered generation (B = 1): the emitted token ids.
        ``chunk_steps`` (``PHI3V_TPU_TIERED_CHUNK``, default 4) steps run
        per host fetch."""
        if max_tokens > self.hot_window:
            raise ValueError(f"max_tokens {max_tokens} exceeds the hot window {self.hot_window}; "
                             "raise hot= at construction")
        if chunk_steps is None:
            chunk_steps = int(os.environ.get("PHI3V_TPU_TIERED_CHUNK", "4"))
        logits, state = self.prefill(dict_input)
        tok = int(np.argmax(logits[0]))
        out = [tok]
        while len(out) < max_tokens and (eos_id is None or tok != eos_id):
            n = min(max(chunk_steps, 1), max_tokens - len(out))
            toks, state = self.decode_chunk(state, np.array([[tok]]), n)
            for t in toks[:, 0].tolist():
                out.append(int(t))
                tok = int(t)
                if eos_id is not None and tok == eos_id:
                    break
        return out

    # -- speculation -----------------------------------------------------------

    @torch.no_grad()
    def spec_generate(self, dict_input: dict, max_tokens: int, eos_id: Optional[int] = None,
                      k_draft: int = 7, n_iters: int = 8, temperature: float = 0.0,
                      top_p: float = 1.0, top_k: int = 0, min_p: float = 0.0,
                      seed: int = 0) -> List[int]:
        """Tiered generation with prompt-lookup speculation (B = 1): up to K +
        1 tokens share one pass over the cold tier.  Greedy by default (the
        stream of :meth:`generate`); ``temperature`` > 0 verifies by
        rejection sampling (``engine/speculative.py:verify_sampled``) with
        noise from ``seed`` (``engine/rng.py``; other numbers than JAX's)."""
        from .engine import filter_sample_logits
        from .rng import SAMPLE, NoiseGen
        from .speculative import init_token_buffer

        if max_tokens + k_draft + 1 > self.hot_window:
            raise ValueError(f"max_tokens {max_tokens} + k_draft {k_draft} + 1 exceeds the hot "
                             f"window {self.hot_window}; raise hot= at construction")
        logits, state = self.prefill(dict_input)
        gen = None
        if temperature > 0:
            gen = NoiseGen(1, self.device)
            gen.reset([seed])
            f = filter_sample_logits(torch.as_tensor(logits, device=self.device), temperature,
                                     top_p, top_k, min_p)
            tok = int((f + gen.gumbel(SAMPLE, f.shape[1:])).argmax(dim=-1)[0])
            gen.advance()
        else:
            tok = int(np.argmax(logits[0]))
        ids_p = _pad_to_chunks(dict_input, self.pc)[0]
        buf = init_token_buffer(ids_p, state.window).to(self.device)
        out, _ = self.spec_decode(state, tok, buf, max_tokens, eos_id=eos_id, k_draft=k_draft,
                                  n_iters=n_iters, temperature=temperature, top_p=top_p,
                                  top_k=top_k, min_p=min_p, seed=seed, gen=gen)
        return out

    @torch.no_grad()
    def spec_decode(self, state: TieredState, tok: int, buf, max_tokens: int,
                    eos_id: Optional[int] = None, k_draft: int = 7, n_iters: int = 8,
                    temperature: float = 0.0, top_p: float = 1.0, top_k: int = 0,
                    min_p: float = 0.0, seed: int = 0, gen=None):
        """The decode half of :meth:`spec_generate`: ``tok`` the first token,
        ``buf`` (1, window) the token history (``engine/speculative.py:
        init_token_buffer``).  Returns (emitted tokens, ``tok`` first,
        state).

        Each dispatch runs ``n_use`` verify passes with no host sync between
        them, where ``n_use`` fits the rest of the hot window at the worst
        case (K + 1 entries a pass), so a dispatch may overshoot the budget
        or ``eos_id`` by at most its own tokens: they are valid continuation
        in the hot window and are trimmed here (JAX ``spec_decode``)."""
        from .rng import NoiseGen
        from .speculative import greedy_verify, propose_drafts, verify_noise, verify_sampled

        sampled = temperature > 0
        if sampled and gen is None:
            gen = NoiseGen(1, self.device)
            gen.reset([seed])
        vocab = self.cfg.vocab_size
        lq = k_draft + 1
        valid_full = torch.cat([state.cold_valid, state.hot.valid], dim=1)
        steps = torch.arange(lq, device=self.device)
        out = [tok]
        while len(out) < max_tokens and (eos_id is None or tok != eos_id):
            room = (self.hot_window - state.hot.offset) // lq  # passes that fit the hot window
            if room <= 0:
                break
            n_use = min(n_iters, room)
            off = state.hot.pos.long().clone()  # (1,) the hot offset on the device
            cur = torch.tensor([[tok]], dtype=torch.long, device=self.device)
            toks, n_emits = [], []
            for _ in range(n_use):
                off_abs = state.C + off
                draft = propose_drafts(buf, valid_full, cur, off_abs, k_draft)
                ids = torch.cat([cur, draft], dim=1)  # (1, lq)
                buf.index_copy_(1, off_abs + steps, ids)
                logits = self._forward(state, ids, off + steps).float()
                if sampled:
                    emitted, n_emit = verify_sampled(logits, draft, verify_noise(gen, k_draft, vocab),
                                                     temperature, top_p, top_k, min_p)
                    gen.advance()
                    acc = n_emit - 1
                else:
                    emitted, acc = greedy_verify(logits, draft)
                cur = emitted.gather(1, acc[:, None])
                off = off + acc[:1] + 1
                toks.append(emitted)
                n_emits.append(acc[0] + 1)
            state.hot.pos.copy_(off.to(state.hot.pos.dtype))
            toks = torch.stack(toks).cpu().numpy()  # (n_use, B, lq): one fetch a dispatch
            n_emits = torch.stack(n_emits).cpu().numpy()
            state.hot = dataclasses.replace(state.hot, offset=state.hot.offset + int(n_emits.sum()))
            for it in range(toks.shape[0]):
                for t in toks[it, 0, : int(n_emits[it])].tolist():
                    out.append(int(t))
                    tok = int(t)
                    if (eos_id is not None and tok == eos_id) or len(out) >= max_tokens:
                        return out[:max_tokens], state
        return out[:max_tokens], state

    # -- consolidation ---------------------------------------------------------

    def consolidate(self, state: TieredState, group: int) -> TieredState:
        """Merge cold chunks in groups of ``group`` along the column axis:
        each layer pass then issues ``group`` times fewer host-to-device
        copies of the same bytes.  The stats loop sees the same columns in
        the same order, so the numerics do not change."""
        n = len(state.cold_k)
        if group <= 1 or n <= 1:
            return state
        if n % group:
            raise ValueError(f"{n} cold chunks do not group by {group}")

        def merge(ts):
            out = self._host_empty((*ts[0].shape[:3], sum(t.shape[3] for t in ts), ts[0].shape[4]),
                                   ts[0].dtype)
            return torch.cat(ts, dim=3, out=out)

        state.cold_k = [merge(state.cold_k[i : i + group]) for i in range(0, n, group)]
        state.cold_s = [merge(state.cold_s[i : i + group]) for i in range(0, n, group)]
        state.cold_full = [all(state.cold_full[i : i + group]) for i in range(0, n, group)]
        if state.prefetch:
            state.dev0 = tuple([torch.cat(ts[i : i + group], dim=2) for i in range(0, n, group)]
                               for ts in state.dev0)
        state.bufs = None  # the device slices take the new chunks' shapes
        state.PC *= group
        return state
