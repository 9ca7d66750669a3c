"""Continuous batching: the slot engine (counterpart of
``phi_3_vision_mlx_tpu/engine/batching.py``).

Requests join and leave a fixed pool of ``slots`` decode lanes at chunk
boundaries, so the card decodes every active request in each step.  The
cache is ``(layers, slots, KV, window, D)``, one window per slot, in the
layouts of ``engine/state.py``; each slot carries its own offset, left-pad
count and validity row, and RoPE runs per slot at ``offset - pads``.
Admission runs the ordinary bucketed prefill (``engine.run_prefill``: K1,
and K2 or K5 on the card) with its window pinned to the serving window, and
copies the request's cache columns into a free slot.

What differs from the JAX package, and why:

* The state lives on the device and is written in place (the JAX engine
  donates it to each jitted chunk and gets a new one).  So the per-chunk
  results and the seed snapshot that a :class:`_ChunkHandle` holds are the
  chunk's own tensors, and the device copies home start at dispatch
  (:class:`_Fetch`): a plain ``.cpu()`` would also wait for every chunk
  queued behind them.  Host page and window accounting reads host counts
  (``l_pad``, ``len(tokens)``, ``adopted_at``), never the device offsets.
* Host arrays go to the card through pinned memory without waiting
  (``rng.to_device``); a pageable copy would drain the queued chunks.
  Admission is always asynchronous: the first token stays on the device
  until a chunk fetch or a host path needs it.
* Sampling is per slot (``temperature``, ``top_p``, ``top_k``, ``min_p``
  and ``seed`` per request, JAX ``sample_token_rows``): a chunk with a
  sampled request runs the sampled step's own graph, with the slots' knobs
  copied into device tensors (:class:`~.engine.Knobs`); an all-greedy chunk
  runs the greedy graph, whose nodes sampling leaves alone.  Each slot
  draws from its request's seed (``engine/rng.py``), so a request samples
  the same stream in any slot; one without a seed draws from the engine's
  ``seed`` and its id.  A sampled request's first token is the prefill's
  argmax, as in the JAX engine (``batching.py:711-716``).
* ``spec_k`` > 0 verifies K prompt-lookup drafts a slot in every pass
  (:class:`SlotSpecStep`, the uniform (S, K + 1) dispatch of the JAX
  engine): a slot without room for a whole pass, or every slot with
  ``spec_accept=False`` (the forced-reject baseline through the same
  graph), commits one token a pass.  The JAX engine's legacy tail switch to
  one-row chunks (``PHI3V_TPU_SPEC_UNIFORM=0``), which drifts at near ties,
  and its blocking admission (``PHI3V_TPU_SYNC_ADMIT``) are not ported.
* An image request (``prepare(..., images=)``) prefills alone through
  ``run_prefill``'s vision path at the serving window and adopts into a
  slot like a text prefill: its image tokens are cache columns by then.  It
  is never batched (``prepare_many`` refuses it), and it carries
  ``has_images``, which the paged engine reads to exempt it from
  preemption.
* The slot engine's attention is the plain masked attention (the JAX
  package leaves it to XLA too); the paged engine (``engine/paging.py``)
  runs kernels K6 and K7.
* Each decode step is one replay of a CUDA graph on the card (the JAX
  engine compiles its chunk): :class:`SlotStep` runs it on static tensors,
  the ``active`` mask copied in before a chunk and a ring of outputs that
  the chunk's device-to-host copies read before the next chunk's replays
  overwrite it (stream order).  The graph holds the state's addresses, so
  the state is reset in place, never replaced; ``capture()`` captures it
  ahead of serving.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.weights import torch_dtype
from ..models import phi3
from ..ops.attention import masked_attention
from ..ops.linear import dense, embedding
from ..ops.norms import rms_norm
from ..ops.rope import su_rope_tables
from .engine import DECODE_CHUNK_MAX, Knobs, fp32_refusal, round_up, run_prefill, sample_token_rows
from .graphs import StepGraph, StepRing
from .rng import SAMPLE, VANILLA, to_device
from .speculative import (check_spec_k, greedy_verify, propose_drafts, verify_columns,
                          verify_mixed_rows, verify_noise)
from .state import alloc_cache, dequantize_kv, quantize_chunk
from .stream import LogitStopper, stop_tail_window, validate_stops

# Stands in for an async-admitted request's first token until its device
# value is fetched (no vocab id is negative).
_FIRST_PENDING = -1


@dataclasses.dataclass
class SlotState:
    """The slots' device state, updated in place.

    k, v, k_scales, kv_quant: the cache of ``engine/state.py`` with (slots,
    window) in place of (B, Lmax) — dense k/v ``(layers, S, KV, W, D)``, or
    the quantized payload in k ``(layers, S, KV, W, D | 2D)`` with v None
    and k_scales ``(layers, S, KV, W, 4G)``.  offsets (S,) int32: committed
    cache columns per slot; pads (S,) int32: left pads (RoPE position =
    offset - pads); valid (S, W) bool; cos/sin (1, W, D) f32: the window's
    RoPE tables; tokens (S,) int64: each slot's last token; hist (S, W)
    int64, with speculation only: the token history the drafts come from
    (column p holds the token whose k/v sit at cache column p).
    """

    k: torch.Tensor
    v: Optional[torch.Tensor]
    offsets: torch.Tensor
    pads: torch.Tensor
    valid: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    tokens: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    kv_quant: object = None
    hist: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.kv_quant is not None


def slot_fields(cfg, slots: int, window: int, device) -> dict:
    """The per-slot fields shared by both engines' states."""
    cos, sin = su_rope_tables(cfg, window, device=device)
    return dict(
        offsets=torch.zeros((slots,), dtype=torch.int32, device=device),
        pads=torch.zeros((slots,), dtype=torch.int32, device=device),
        valid=torch.zeros((slots, window), dtype=torch.bool, device=device),
        cos=cos, sin=sin,
        tokens=torch.zeros((slots,), dtype=torch.long, device=device),
    )


def _init_slots(cfg, slots: int, window: int, device) -> SlotState:
    lead = (cfg.num_hidden_layers, slots, cfg.num_key_value_heads, window)
    return SlotState(**alloc_cache(cfg, lead, torch_dtype(cfg.dtype), device),
                     **slot_fields(cfg, slots, window, device))


def _slot_attention(st: SlotState, active: torch.Tensor):
    """One step's ``attend(i, q, k, v)`` for the slot cache: write the fresh
    k/v at each slot's offset, then masked attention over the slot's window
    (past validity bits plus the fresh column, whose bit commits after the
    step)."""
    s, w = st.valid.shape
    rows = torch.arange(s, device=st.valid.device)
    off = st.offsets.long()
    col = off.clamp(max=w - 1)  # past the window only for a finished slot's discarded steps
    key = torch.arange(w, device=st.valid.device)
    allowed = (((key[None] <= off[:, None]) & st.valid) | (key[None] == off[:, None]))[:, None, None]

    def attend(i, q, k, v):
        scale = q.shape[-1] ** -0.5
        if st.quantized:
            payload, scales = quantize_chunk(k, v, st.kv_quant)
            st.k[i, rows, :, col] = payload[:, :, 0]
            st.k_scales[i, rows, :, col] = scales[:, :, 0]
            kc, vc = dequantize_kv(st.k[i], st.k_scales[i], q.dtype, st.kv_quant.bits)
        else:
            st.k[i, rows, :, col] = k[:, :, 0].to(st.k.dtype)
            st.v[i, rows, :, col] = v[:, :, 0].to(st.v.dtype)
            kc, vc = st.k[i].to(q.dtype), st.v[i].to(q.dtype)
        return masked_attention(q, kc, vc, allowed, scale)

    return attend


def _pass_rows(x, src):
    """The rows ``src`` (S, L) of a pass's fresh k or v (S, KV, L, D): the
    values :func:`~.speculative.verify_columns` writes at its columns."""
    return x.gather(2, src[:, None, :, None].expand(-1, x.shape[1], -1, x.shape[3]))


def _slot_spec_attention(st: SlotState, active, wpos, cols, src):
    """A verify pass's ``attend(i, q, k, v)`` for the slot cache: write the
    pass's K + 1 fresh columns (``cols``, clamped into the window), then
    masked attention, query ``i`` seeing the committed keys up to it and
    the pass's own columns up to it (JAX ``_spec_decode_chunk``)."""
    w = st.valid.shape[1]
    rows = torch.arange(st.valid.shape[0], device=st.valid.device)[:, None]
    key = torch.arange(w, device=st.valid.device)
    q_pos, off = wpos[:, :, None], st.offsets.long()[:, None, None]
    allowed = (((key <= q_pos) & st.valid[:, None]) | ((key >= off) & (key <= q_pos)))[:, None]

    def attend(i, q, k, v):
        k, v = _pass_rows(k, src), _pass_rows(v, src)
        if st.quantized:
            payload, scales = quantize_chunk(k, v, st.kv_quant)
            st.k[i, rows, :, cols] = payload.transpose(1, 2)
            st.k_scales[i, rows, :, cols] = scales.transpose(1, 2)
            kc, vc = dequantize_kv(st.k[i], st.k_scales[i], q.dtype, st.kv_quant.bits)
        else:
            st.k[i, rows, :, cols] = k.transpose(1, 2).to(st.k.dtype)
            st.v[i, rows, :, cols] = v.transpose(1, 2).to(st.v.dtype)
            kc, vc = st.k[i].to(q.dtype), st.v[i].to(q.dtype)
        return masked_attention(q, kc, vc, allowed, q.shape[-1] ** -0.5)

    return attend


def _layers(lm, x, cos, sin, attend):
    """The decoder layers, final norm and lm_head of a slot step or pass:
    logits (S, L, V) f32."""
    cfg, mdl = lm.cfg, lm.params["model"]
    for i in range(cfg.num_hidden_layers):
        x = phi3.block(cfg, x, mdl["layers"], i, cos, sin, functools.partial(attend, i))
    x = rms_norm(x, mdl["norm"]["weight"], cfg.rms_norm_eps)
    return dense(lm.params["lm_head"], x)[..., : cfg.vocab_size].float()


class SlotStep:
    """The slot engines' decode step over a state ``st``, on static tensors
    (a :class:`~.graphs.StepGraph` each): every slot computes, the
    ``active`` ones commit their column and advance, the next token feeds
    back through ``st.tokens`` (the argmax in ``graph``; in
    ``sampled_graph`` each slot's draw under ``knobs``), and the ring takes
    each step's tokens, max log-prob and EOS log-prob, the statistics the
    host's stoppers replay.  ``attention(st, active)`` makes one step's
    ``attend(i, q, k, v)`` (the slot or the paged cache)."""

    width = None  # tokens a step writes into the ring (None: one)

    def __init__(self, lm, st, attention, knobs):
        self.lm, self.st, self.attention, self.knobs = lm, st, attention, knobs
        s = st.valid.shape[0]
        dev = st.valid.device
        self.active = torch.zeros((s,), dtype=torch.bool, device=dev)
        self.rows = torch.arange(s, device=dev)
        self.ring = StepRing(DECODE_CHUNK_MAX, s, dev, width=self.width)
        save = (st.offsets, st.tokens, st.valid, self.ring.index) + (
            () if st.hist is None else (st.hist,))
        self.graph = StepGraph(functools.partial(self._step, False), dev, lm.graphs, save=save)
        self.sampled_graph = StepGraph(functools.partial(self._step, True), dev, lm.graphs,
                                       save=save + (knobs.gen.counters,))

    @torch.no_grad()
    def _step(self, sampled: bool) -> None:
        cfg, st, active = self.lm.cfg, self.st, self.active
        w = st.valid.shape[1]
        x = embedding(self.lm.params["model"]["embed_tokens"], st.tokens[:, None],
                      dtype=torch_dtype(cfg.dtype))
        # Per-slot RoPE at the slot's logical position: a left-padded prompt
        # continues from its true length, not from the cache column.
        pos = (st.offsets - st.pads).long().clamp(0, w - 1)
        cos, sin = st.cos[0, pos][:, None], st.sin[0, pos][:, None]
        logits = _layers(self.lm, x, cos, sin, self.attention(st, active))[:, -1]
        nxt = None
        if sampled:
            kn = self.knobs
            nxt = sample_token_rows(logits, kn.gen.gumbel(SAMPLE, logits.shape[-1:]), kn.temps,
                                    kn.top_ps, kn.top_ks, kn.min_ps)
            kn.gen.advance()
        nxt = self.ring.write(logits, self.lm.eos_id, nxt)
        col = st.offsets.long().clamp(max=w - 1)
        st.valid[self.rows, col] = st.valid[self.rows, col] | active
        st.offsets += active.to(torch.int32)
        st.tokens.copy_(torch.where(active, nxt, st.tokens))

    @torch.no_grad()
    def chunk(self, active, n_steps: int, sampled: bool = False):
        """``n_steps`` steps with the host mask ``active`` (S,) bool, greedy
        or ``sampled``.  Returns device views (n_steps, S) of the ring, valid
        until the next chunk's steps run."""
        self.active.copy_(to_device(active, self.active.device))
        graph = self.sampled_graph if sampled else self.graph
        self.ring.start(n_steps)
        for _ in range(n_steps):
            graph()
        return self.ring.rows(n_steps)


class SlotSpecStep(SlotStep):
    """The slot engines' verify pass of K drafts a slot (JAX
    ``_spec_decode_chunk``, uniform dispatch): every slot proposes drafts
    from ``st.hist`` and verifies them in one (S, K + 1) forward; a live
    slot commits 1..K + 1 tokens, one without room for a whole pass or with
    ``spec_ok`` False commits its first only (forced reject), an inactive
    one nothing.  Greedy rows argmax-match; sampled rows (``sampled_graph``)
    rejection-sample (``speculative.verify_mixed_rows``), and a sampled row
    forced to reject draws its token as a vanilla step does.
    ``attention(st, active, wpos, cols, src)`` makes the pass's ``attend``.
    """

    def __init__(self, lm, st, attention, knobs, k_draft: int, spec_accept: bool):
        self.k, self.width = k_draft, k_draft + 1
        self.spec_ok = torch.full((st.valid.shape[0],), bool(spec_accept), dtype=torch.bool,
                                  device=st.valid.device)
        super().__init__(lm, st, attention, knobs)

    @torch.no_grad()
    def _step(self, sampled: bool) -> None:
        lm, st, k, active = self.lm, self.st, self.k, self.active
        w = st.valid.shape[1]
        off = st.offsets.long()
        live = active & (off + 1 <= w)
        can_spec = live & self.spec_ok & (off + k + 1 <= w)
        draft = propose_drafts(st.hist, st.valid, st.tokens[:, None], off, k)
        ids = torch.cat([st.tokens[:, None], draft], dim=1)  # (S, K + 1)
        wpos, cols, src = verify_columns(off, k + 1, w)
        st.hist.scatter_(1, cols, ids.gather(1, src))
        x = embedding(lm.params["model"]["embed_tokens"], ids, dtype=torch_dtype(lm.cfg.dtype))
        pos = ((off - st.pads)[:, None] + torch.arange(k + 1, device=off.device)).clamp(0, w - 1)
        logits = _layers(lm, x, st.cos[0, pos], st.sin[0, pos],
                         self.attention(st, active, wpos, cols, src))  # (S, K + 1, V)
        if sampled:
            kn, vocab = self.knobs, logits.shape[-1]
            out, acc = verify_mixed_rows(logits, draft, verify_noise(kn.gen, k, vocab), kn.temps,
                                         kn.top_ps, kn.top_ks, kn.min_ps)
            vanilla = sample_token_rows(logits[:, 0], kn.gen.gumbel(VANILLA, (vocab,)), kn.temps,
                                        kn.top_ps, kn.top_ks, kn.min_ps)
            out[:, 0] = torch.where(can_spec | (kn.temps <= 0), out[:, 0], vanilla)
            kn.gen.advance()
        else:
            out, acc = greedy_verify(logits, draft)
        acc = torch.where(can_spec, acc, 0)
        n_emit = torch.where(live, acc + 1, 0)
        key = torch.arange(w, device=off.device)
        st.valid |= (key[None] >= off[:, None]) & (key[None] < (off + n_emit)[:, None])
        st.offsets += n_emit.to(torch.int32)
        st.tokens.copy_(torch.where(live, out.gather(1, acc[:, None])[:, 0], st.tokens))
        self.ring.write_pass(logits, lm.eos_id, out, n_emit)


def adopt_row(st, slot: int, p: "_Prepared") -> None:
    """Install a prefilled request's validity row, offset, pads, first
    token and, with speculation, its token history in ``slot`` (both
    engines; the cache columns are copied by the caller)."""
    l_pad = p.l_pad
    st.valid[slot] = False
    st.valid[slot, :l_pad] = p.src_state.valid[p.src_row, :l_pad]
    st.offsets[slot] = l_pad
    st.pads[slot] = p.n_pads
    st.tokens[slot] = p.first_dev[p.src_row] if p.first_dev is not None else p.first
    if st.hist is not None:
        row = np.zeros((l_pad,), np.int64)
        row[p.n_pads:] = np.maximum(np.asarray(p.ids if p.ids is not None else p.prompt_ids), 0)
        st.hist[slot, :l_pad] = to_device(row, st.hist.device)


def _adopt(st: SlotState, slot: int, p: "_Prepared") -> None:
    """Copy a prefilled request's ``l_pad`` cache columns (row ``src_row``
    of its prefill state) into ``slot``."""
    src, r, l_pad = p.src_state, p.src_row, p.l_pad
    st.k[:, slot, :, :l_pad] = src.k[:, r, :, :l_pad]
    if st.quantized:
        st.k_scales[:, slot, :, :l_pad] = src.k_scales[:, r, :, :l_pad]
    else:
        st.v[:, slot, :, :l_pad] = src.v[:, r, :, :l_pad]
    adopt_row(st, slot, p)


@dataclass
class _Request:
    rid: int
    slot: int
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    max_tokens: int = 512
    l_pad: int = 0
    stop: list = field(default_factory=list)
    error: str = ""
    prompt_ids: List[int] = field(default_factory=list)  # for a preemption resume
    stopper: object = None  # LogitStopper when early_stop is set
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    min_p: float = 0.0
    seed: int = 0
    adoptions: int = 0  # a resume draws a fresh noise stream: seed ^ (adoptions << 40)
    # Tokens already inside l_pad at (re-)admission: 1 for a fresh request
    # (the pending prefill token), len(tokens) after a preemption resume.
    adopted_at: int = 1
    # Async admission: the first token is row first_row of first_dev on the
    # device, and tokens[0] holds _FIRST_PENDING until it is fetched.
    first_dev: Optional[torch.Tensor] = None
    first_row: int = 0
    has_images: bool = False  # its cache cannot be rebuilt by a text recompute


class _Fetch:
    """A chunk's device results on their way to the host: the copies start
    at dispatch and :meth:`get` waits for them alone."""

    def __init__(self, tensors):
        self.event = None
        if tensors[0].device.type != "cuda":
            self.host = [None if t is None else t.clone() for t in tensors]  # the ring is reused
            return
        self.host = [None if t is None else torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors]
        for h, t in zip(self.host, tensors):
            if t is not None:
                h.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def get(self):
        if self.event is not None:
            self.event.synchronize()
        return [None if h is None else h.numpy() for h in self.host]


@dataclass
class _ChunkHandle:
    """A dispatched decode chunk.  ``slot_rids`` snapshots slot -> rid at
    dispatch, so that results survive slots being freed and refilled while
    the chunk is in flight."""

    fetch: _Fetch  # (toks, maxlp, eoslp[, n_emit], seed)
    slot_rids: Dict[int, int]
    n_steps: int  # steps, or verify passes
    growth: int = 0  # worst-case cache columns the chunk appends per slot
    spec: bool = False  # verify passes: (n, S, K + 1) rows and their committed counts


@dataclass
class _Prepared:
    """A prefilled request not yet admitted: made without touching engine
    state (the scheduler prefills outside its lock), adopted by
    :meth:`BatchEngine.admit` under it."""

    src_state: object
    first: int  # _FIRST_PENDING when the value is in first_dev
    l_pad: int
    n_pads: int
    prompt_ids: List[int]
    max_tokens: int
    stop: list = field(default_factory=list)
    early_stop: object = False
    rid: int = -1  # set by a resume: the request keeps its id
    first_dev: Optional[torch.Tensor] = None  # (B,) device argmax of the prefill
    src_row: int = 0  # this request's row of src_state
    has_images: bool = False
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    min_p: float = 0.0
    seed: Optional[int] = None
    ids: Optional[List[int]] = None  # the ids prefilled (a resume's), seeding the history


class BatchEngine:
    """Continuous batching over a fixed slot pool.

    Usage::

        eng = BatchEngine(lm, processor, slots=4, window=1024)
        rid = eng.submit("prompt", max_tokens=64)
        while eng.pending():
            eng.step(8)
        text = eng.result(rid)
    """

    def __init__(self, lm, processor, slots: int = 4, window: int = 1024,
                 pipeline_depth: int = 1, spec_k: int = 0, spec_accept: bool = True,
                 seed: int = 0):
        if window % 128:
            raise ValueError("window must be a multiple of 128 (engine bucketing)")
        if lm.device.type == "cuda" and lm.cfg.dtype == "float32":
            raise ValueError(fp32_refusal("the slot and paged engines"))
        check_spec_k(spec_k)
        self.lm = lm
        self.processor = processor
        self.slots = slots
        self.window = window
        self.seed = seed
        # spec_k > 0: every chunk is verify passes of K drafts a slot;
        # spec_accept=False forces every pass to commit one token (the
        # baseline of the same graph).
        self.spec_k, self.spec_accept = spec_k, bool(spec_accept)
        self.spec_stats = {"passes": 0, "emitted": 0}
        self.state = self._init_state()
        self.knobs = Knobs(slots, lm.device)
        self.decoder = SlotStep(lm, self.state, self._attention(), self.knobs)
        self.spec = None
        if spec_k:
            self.state.hist = torch.zeros(self.state.valid.shape, dtype=torch.long,
                                          device=lm.device)
            self.spec = SlotSpecStep(lm, self.state, self._spec_attention(), self.knobs, spec_k,
                                     self.spec_accept)
        self.free: List[int] = list(range(slots))
        self.requests: Dict[int, _Request] = {}
        self.by_slot: Dict[int, _Request] = {}
        self._next_rid = 0
        # Chunks enqueued by step_pipelined, oldest first.
        self._inflight: List[_ChunkHandle] = []
        self.pipeline_depth = max(1, int(pipeline_depth))
        # Tokens collected by an internal flush (paged reservation under pool
        # pressure) that no caller has picked up yet.
        self._orphan_out: Dict[int, List[int]] = {}

    def _init_state(self):
        return _init_slots(self.lm.cfg, self.slots, self.window, self.lm.device)

    def _attention(self):
        return _slot_attention

    def _spec_attention(self):
        return _slot_spec_attention

    @property
    def step_graphs(self):
        """The graphs this engine decodes with: greedy and sampled, of the
        decode step or (``spec_k`` > 0) of the verify pass."""
        step = self.spec or self.decoder
        return step.graph, step.sampled_graph

    def capture(self) -> None:
        """Capture the decode graphs now (a no-op without graphs): a server
        does so before its threads start launching."""
        for graph in self.step_graphs:
            graph.capture()

    def _reset_state(self) -> None:
        """Zero the state in place (its graph keeps its addresses): every
        slot empty, as a fresh state."""
        st = self.state
        for t in (st.k, st.v, st.k_scales, st.offsets, st.pads, st.valid, st.tokens, st.hist):
            if t is not None:
                t.zero_()

    # -- admission ----------------------------------------------------------

    def _prefill(self, dict_input, what: str):
        """Prefill with the window pinned to the serving window (the same
        RoPE regime, and the cache columns line up one to one)."""
        l = int(np.asarray(dict_input["input_ids"]).shape[1])
        l_guess = max(round_up(l, 64), 64)
        if l_guess >= self.window:
            raise ValueError(f"{what} ({l_guess} tokens bucketed) does not fit window {self.window}")
        logits, src_state, l_pad, src_window = run_prefill(
            self.lm, dict_input, max_tokens=self.window - l_guess)
        if src_window != self.window:
            raise RuntimeError(f"prefill window {src_window} is not the serving window {self.window}")
        return logits.argmax(dim=-1), src_state, l_pad

    def prepare(self, prompt: str, max_tokens: int = 512, temperature: float = 0.0,
                top_p: float = 1.0, top_k: int = 0, min_p: float = 0.0, stop=None,
                early_stop=False, images=None, seed: Optional[int] = None) -> _Prepared:
        """Tokenize and prefill a request without touching engine state.
        ``temperature`` > 0 samples it under ``top_p``, ``top_k``, ``min_p``
        from ``seed`` (default: the engine's seed and the request's id).
        ``images``: decoded images for the prompt's ``<|image_i|>`` tags (a
        vision model's processor), prefilled alone."""
        dict_input = self.processor(prompt, images)
        ids = np.asarray(dict_input["input_ids"])
        first_dev, src_state, l_pad = self._prefill(dict_input, "prompt")
        return _Prepared(
            src_state=src_state, first=_FIRST_PENDING, first_dev=first_dev, l_pad=l_pad,
            n_pads=l_pad - ids.shape[1], prompt_ids=[int(t) for t in ids[0]],
            max_tokens=max_tokens, stop=validate_stops(stop), early_stop=early_stop,
            has_images=images is not None, temperature=temperature, top_p=top_p, top_k=top_k,
            min_p=min_p, seed=seed,
        )

    def prepare_many(self, prompts: List[str], opts: List[dict]) -> List[_Prepared]:
        """Prefill several queued admissions in one batched prefill: the
        prompts are left-padded to a common bucket by the processor's batch
        path, and each row becomes a :class:`_Prepared` carrying its
        ``src_row``.  ``opts[i]``: keyword arguments of :meth:`prepare`."""
        if len(prompts) != len(opts):
            raise ValueError(f"{len(prompts)} prompts, {len(opts)} option sets")
        if len(prompts) == 1:
            return [self.prepare(prompts[0], **opts[0])]
        if any(o.get("images") is not None for o in opts):
            raise ValueError("an image request is never batched: prefill it with prepare()")
        dict_input = self.processor(list(prompts))
        ids = np.asarray(dict_input["input_ids"])
        mask = np.asarray(dict_input["mask"]).astype(bool)
        firsts, src_state, l_pad = self._prefill(dict_input, "batched prompts")
        out = []
        for r, o in enumerate(opts):
            real = ids[r][mask[r]]
            out.append(_Prepared(
                src_state=src_state, src_row=r, first=_FIRST_PENDING, first_dev=firsts,
                l_pad=l_pad, n_pads=l_pad - len(real), prompt_ids=[int(t) for t in real],
                max_tokens=o.get("max_tokens", 512), stop=validate_stops(o.get("stop")),
                early_stop=o.get("early_stop", False), temperature=o.get("temperature", 0.0),
                top_p=o.get("top_p", 1.0), top_k=o.get("top_k", 0), min_p=o.get("min_p", 0.0),
                seed=o.get("seed"),
            ))
        return out

    def can_admit(self, prepared: _Prepared) -> bool:
        return bool(self.free)

    def _adopt_prepared(self, p: _Prepared, slot: int) -> None:
        """Device-state adoption (the paged engine adds page accounting)."""
        _adopt(self.state, slot, p)

    def admit(self, prepared: _Prepared) -> int:
        """Adopt a prepared prefill into a free slot (mutates engine state:
        the scheduler calls this under its lock)."""
        if not self.free:
            raise RuntimeError("no free slots; call step() until one frees")
        p = prepared
        slot = self.free.pop()
        try:
            self._adopt_prepared(p, slot)
        except Exception:
            self.free.append(slot)
            self._on_slot_freed(slot)  # e.g. the paged engine's fresh pages
            raise
        if p.rid >= 0:  # a preemption resume keeps its request
            req = self.requests[p.rid]
            req.slot, req.l_pad = slot, p.l_pad
            # p.first is the pending token tokens[-1], re-seeded, not new.
            req.adopted_at = len(req.tokens)
            req.adoptions += 1
        else:
            rid = self._next_rid
            req = _Request(rid=rid, slot=slot, tokens=[p.first],
                           max_tokens=p.max_tokens, l_pad=p.l_pad, stop=p.stop,
                           prompt_ids=p.prompt_ids, has_images=p.has_images,
                           temperature=p.temperature, top_p=p.top_p, top_k=p.top_k,
                           min_p=p.min_p,
                           seed=(self.seed << 32) + rid if p.seed is None else p.seed)
            self._next_rid += 1
            if p.first_dev is not None:
                req.first_dev, req.first_row = p.first_dev, p.src_row
            if p.early_stop:
                req.stopper = LogitStopper(p.max_tokens, p.early_stop)
            self.requests[req.rid] = req
        self.knobs.gen.reset_row(slot, req.seed ^ (req.adoptions << 40))
        # An async first token's EOS/stop checks wait for its value
        # (_materialize_first); max_tokens is a host count.
        done_now = len(req.tokens) >= req.max_tokens
        if req.first_dev is None:
            done_now = done_now or p.first == self.lm.eos_id or self._stop_hit(req)
        if done_now:
            req.done = True
            self.free.append(slot)
            self._on_slot_freed(slot)
        else:
            self.by_slot[slot] = req
        return req.rid

    def submit(self, prompt: str, max_tokens: int = 512, temperature: float = 0.0,
               top_p: float = 1.0, top_k: int = 0, min_p: float = 0.0, stop=None,
               early_stop=False, images=None, seed: Optional[int] = None) -> int:
        return self.admit(self.prepare(prompt, max_tokens, temperature=temperature, top_p=top_p,
                                       top_k=top_k, min_p=min_p, stop=stop,
                                       early_stop=early_stop, images=images, seed=seed))

    def _stop_hit(self, req) -> bool:
        """True when the decoded tail of the generation holds a stop string."""
        if not req.stop:
            return False
        tail = req.tokens[-stop_tail_window(req.stop):]
        txt = self.processor.tokenizer.decode([t for t in tail if t >= 0])
        return any(s in txt for s in req.stop)

    def _materialize_first(self, req, value: Optional[int] = None) -> None:
        """Resolve an async-admitted first token (``value`` comes with a
        chunk fetch; without it this waits for the device) and run the
        EOS/stop checks that admission deferred."""
        if req.first_dev is None:
            return
        if value is None:
            value = int(req.first_dev[req.first_row])
        req.tokens[0] = int(value)
        req.first_dev = None
        if req.done:
            return
        if req.tokens[0] == self.lm.eos_id or self._stop_hit(req):
            req.done = True
            if self.by_slot.get(req.slot) is req:
                del self.by_slot[req.slot]
                self.free.append(req.slot)
                self._on_slot_freed(req.slot)

    # -- decode -------------------------------------------------------------

    def pending(self) -> bool:
        return bool(self.by_slot) or bool(self._inflight)

    def _try_resume(self) -> None:
        """Hook: the paged engine resumes preempted requests here."""

    def _growth(self, n_steps: int) -> int:
        """Worst-case cache columns a chunk of ``n_steps`` steps (verify
        passes) appends per slot."""
        return n_steps * (self.spec_k + 1)

    def _reserve(self, n_steps: int) -> bool:
        """Hook: make room for one chunk's cache growth (paged engine).
        False aborts the dispatch."""
        return True

    def _sampling(self) -> bool:
        """Copy the active slots' knobs in when any request samples (JAX
        ``_sampling_vectors``); False for an all-greedy chunk."""
        reqs = self.by_slot
        if all(r.temperature <= 0 for r in reqs.values()):
            return False
        vecs = (np.zeros(self.slots, np.float32), np.ones(self.slots, np.float32),
                np.zeros(self.slots, np.int64), np.zeros(self.slots, np.float32))
        for slot, r in reqs.items():
            for vec, value in zip(vecs, (r.temperature, r.top_p, r.top_k, r.min_p)):
                vec[slot] = value
        self.knobs.set(*vecs)
        return True

    def dispatch(self, n_steps: int = 1) -> Optional[_ChunkHandle]:
        """Enqueue one decode chunk (``n_steps`` steps, or verify passes
        with ``spec_k``) without waiting for its results; None when nothing
        is active."""
        self._try_resume()
        if not self.by_slot or not self._reserve(n_steps):
            return None
        active = np.zeros((self.slots,), bool)
        active[list(self.by_slot)] = True
        # The first tokens of async-admitted slots ride home with the chunk:
        # a copy of the tokens before the chunk overwrites them in place.
        seed = (self.state.tokens.clone()
                if any(r.first_dev is not None for r in self.by_slot.values()) else None)
        outs = (self.spec or self.decoder).chunk(active, n_steps, self._sampling())
        return _ChunkHandle(_Fetch([*outs, seed]), {s: r.rid for s, r in self.by_slot.items()},
                            n_steps, growth=self._growth(n_steps), spec=self.spec is not None)

    def collect(self, handle: Optional[_ChunkHandle]) -> Dict[int, List[int]]:
        """Wait for a dispatched chunk and trim its tokens into requests.

        Steps of slots whose request finished or was preempted after the
        dispatch are dropped.  Returns {rid: [tokens...]}, including tokens
        of internal flushes since the last collect."""
        if handle is not None and any(h is handle for h in self._inflight):
            self._inflight = [h for h in self._inflight if h is not handle]
        out, self._orphan_out = self._orphan_out, {}
        if handle is None:
            return out
        *rows, seed = handle.fetch.get()
        if handle.spec:  # toks (n, S, K + 1) and the (n, S) committed counts
            toks, maxlp, eoslp, n_emit = rows
        else:  # one token a step: (n, S)
            toks, maxlp, eoslp = (r[..., None] for r in rows)
            n_emit = np.ones(toks.shape[:2], np.int64)
        for slot, rid in handle.slot_rids.items():
            req = self.requests[rid]
            if req.first_dev is not None and seed is not None and req.slot == slot:
                # Collection is FIFO: the first chunk collected for this slot
                # was dispatched right after adoption, so its seed holds
                # exactly the adopted first token.
                self._materialize_first(req, value=int(seed[slot]))
            if req.done or req.slot != slot:
                continue  # finished or preempted while this chunk was in flight
            emitted = out.setdefault(rid, [])
            done = False
            for i in range(handle.n_steps):
                m = int(n_emit[i, slot])
                if handle.spec:
                    self.spec_stats["passes"] += m > 0
                    self.spec_stats["emitted"] += m
                for j in range(m):
                    tok = int(toks[i, slot, j])
                    req.tokens.append(tok)
                    emitted.append(tok)
                    hit_window = req.l_pad + len(req.tokens) - req.adopted_at + 1 >= self.window - 1
                    early = req.stopper is not None and req.stopper.update(
                        float(maxlp[i, slot, j]), float(eoslp[i, slot, j]), 1)
                    if (early or tok == self.lm.eos_id or len(req.tokens) >= req.max_tokens
                            or hit_window or self._stop_hit(req)):
                        done = True
                        break
                if done:
                    break
            # A verify chunk that emitted nothing found the window full.
            if done or (handle.spec and not n_emit[:, slot].any()):
                req.done = True
                # _project_completions may have freed (and admission
                # refilled) the slot already.
                if self.by_slot.get(slot) is req:
                    del self.by_slot[slot]
                    self.free.append(slot)
                    self._on_slot_freed(slot)
        return out

    def flush(self) -> Dict[int, List[int]]:
        """Collect every in-flight chunk, oldest first."""
        out = self.collect(None)
        while self._inflight:
            for rid, toks in self.collect(self._inflight.pop(0)).items():
                out.setdefault(rid, []).extend(toks)
        return out

    def _pending_growth(self) -> int:
        """Worst-case cache-column growth of every uncollected chunk."""
        return sum(h.growth for h in self._inflight)

    def step(self, n_steps: int = 1) -> Dict[int, List[int]]:
        """``n_steps`` decode steps for all active slots, dispatched and
        collected.  Returns {rid: [tokens...]}."""
        out = self.flush()
        h = self.dispatch(n_steps)
        if h is not None:
            for rid, toks in self.collect(h).items():
                out.setdefault(rid, []).extend(toks)
        return out

    def step_pipelined(self, n_steps: int = 1, depth: Optional[int] = None) -> Dict[int, List[int]]:
        """Enqueue the next chunk before collecting the oldest, keeping
        ``depth`` (default ``pipeline_depth``) chunks in flight.  Completion
        is seen up to ``depth`` chunks late; their extra steps are dropped.
        Call :meth:`flush` after the loop."""
        depth = self.pipeline_depth if depth is None else depth
        h = self.dispatch(n_steps)  # may flush internally under pool pressure
        if h is not None:
            self._inflight.append(h)
            self._project_completions()
        if len(self._inflight) > depth or (h is None and self._inflight):
            return self.collect(self._inflight.pop(0))
        return self.collect(None)

    def _project_completions(self) -> None:
        """Free the slots whose requests are sure to finish within the
        chunks in flight (max_tokens or the window), so admission can refill
        them before those chunks are collected; their tokens still arrive
        through collect()."""
        scheduled: Dict[int, int] = {}
        for h in self._inflight:
            for slot, rid in h.slot_rids.items():
                if self.by_slot.get(slot) is self.requests[rid]:
                    scheduled[slot] = scheduled.get(slot, 0) + h.n_steps
        for slot, n in scheduled.items():
            req = self.by_slot[slot]
            j_max = req.max_tokens - len(req.tokens)
            j_win = (self.window - 2) - req.l_pad - len(req.tokens) + req.adopted_at
            if n >= min(j_max, j_win):
                del self.by_slot[slot]
                self.free.append(slot)
                self._on_slot_freed(slot)

    def _on_slot_freed(self, slot: int) -> None:
        """Hook: the paged engine returns the slot's pages."""

    def fail_all_active(self, message: str) -> None:
        """Fail every request in flight and start from a fresh state (the
        scheduler's pump calls this when a step raises)."""
        for req in self.by_slot.values():
            req.error, req.done = message, True
        # Requests freed early by _project_completions still owe tokens to
        # in-flight chunks.
        for h in self._inflight:
            for rid in h.slot_rids.values():
                req = self.requests[rid]
                if not req.done:
                    req.error, req.done = message, True
        self.by_slot.clear()
        self.free = list(range(self.slots))
        for slot in range(self.slots):
            self._on_slot_freed(slot)
        self._inflight = []
        self._orphan_out = {}
        self._reset_state()

    # -- results ------------------------------------------------------------

    def first_token(self, rid: int) -> int:
        """The request's first (prefill argmax) token; may wait for the
        device."""
        req = self.requests[rid]
        self._materialize_first(req)
        return req.tokens[0]

    def tokens(self, rid: int) -> List[int]:
        """Generated token ids, cut at EOS."""
        req = self.requests[rid]
        if req.error:
            raise RuntimeError(f"request {rid} failed: {req.error}")
        self._materialize_first(req)
        toks = req.tokens
        if self.lm.eos_id in toks:
            toks = toks[: toks.index(self.lm.eos_id)]
        return list(toks)

    def result(self, rid: int) -> str:
        txt = self.processor.tokenizer.decode(self.tokens(rid))
        cuts = [txt.find(s) for s in self.requests[rid].stop if s in txt]
        return txt[: min(cuts)] if cuts else txt
