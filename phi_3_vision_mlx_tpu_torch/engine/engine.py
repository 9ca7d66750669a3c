"""Generation engine: bucketed prefill, chunked decode, sampling and
prompt-lookup speculation (counterpart of
``phi_3_vision_mlx_tpu/engine/engine.py``).

The contract of the JAX engine carries over: prompts are left-padded to a
64-token bucket and the window rounded to 128; prompts longer than
``PREFILL_CHUNK`` prefill in chunks through ``decode_forward``; decode runs
in chunks whose token feeds back on the device, and the host fetches the
tokens and the two logit statistics the stoppers need once per chunk, then
replays the stoppers in the reference order.  Chunk sizes ramp from
``DECODE_CHUNK_MIN`` by 4x up to ``DECODE_CHUNK_MAX``.

A :class:`Decoder` runs the decode steps (the JAX engine's ``chunk_fn``):
on the card each step is one replay of a CUDA graph (``engine/graphs.py``),
keyed by (rows, window) on the model's cache kind, with no key per chunk
length.  A graph holds the addresses it captured, so its entry owns its
decode state, and the next request of the same key prefills into those
buffers (``init_state(into=...)``); ``LM.decoders`` keeps the
``GRAPH_ENTRIES`` most recently finished entries within ``LM.keep_bytes``
(a share of the card, ``GRAPH_KEEP_SHARE``: a 128K-token dense entry, 48
GiB, is closed when its request ends), and an entry leaves it while a
request decodes with it (one request at a time).  ``LM(graphs=False)`` runs the same
steps eagerly on the card (the reference); the CPU always does.  Prefill and
extend chunks run eagerly.  A vision prompt (the vision processor's
``raw_images``, ``hd_images`` or ``pixel_values``) runs its image pipeline
(``models/vision.py``), writes each image's features over its placeholders
and prefills the whole prompt from those embeddings in one pass, never
chunked, as the JAX engine does; by decode time its image tokens are cache
columns like any other, so it decodes through the same :class:`Decoder`.

Sampling (``generate_text(sample=True, ...)``) runs its own graph of the
entry, beside the greedy one, as the JAX engine compiles a chunk per
sampler: the knobs are device tensors (:class:`Knobs`) and the noise comes
from the entry's counter-based generator (``engine/rng.py``), so one
capture serves every request's knobs and seed; the greedy graph keeps its
nodes.  The first token is sampled from the prefill logits, as in the JAX
engine.  ``speculative=True`` (or ``PHI3V_TPU_SPEC=1``) verifies K
prompt-lookup drafts a pass (``engine/speculative.py``), a third and fourth
graph of the entry over the same state, then finishes the window's tail
through the vanilla graph.  The continuous-batching engines are
``engine/batching.py`` and ``engine/paging.py``.

Constrained decoding's device steps (:meth:`LM.score_fn`,
:meth:`LM.beam_fn`, :meth:`LM.nocache_fn`; ``engine/constrain.py``) replay
graphs too, one a shape, as the JAX engine compiles one a shape: a question
prefills into an entry (:func:`prefill_entry`), whose score steps (keyed L
and ``advance``) and beam reads (L and ``n_beam``) are static steps over the
entry's state (``engine/graphs.py:StaticStep``); the cache-free pass is an
entry of its own (:class:`NocachePass`, keyed B and l_pad) under the same
budget, which counts each entry's graph pools beside its tensors.  With
graphs a step handed a state that belongs to no taken entry raises; without
them each step runs eagerly on the same route.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
import weakref
from collections import Counter, OrderedDict
from typing import Optional

import numpy as np
import torch

from ..core.config import ID_EOS, ModelConfig
from ..core.weights import params_to, torch_dtype
from ..models import phi3
from ..models.vision import compute_inputs_embeds
from ..ops.rope import su_rope_tables
from ..parallel.mesh import axis_size
from .graphs import StaticStep, StepGraph, StepRing
from .rng import SAMPLE, NoiseGen, to_device
from .state import cache_bytes, init_state, state_bytes
from .stream import LogitStopper, StopSequences, Streamer, TokenStopper

PROMPT_BUCKET = 64
WINDOW_BUCKET = 128
PREFILL_CHUNK = 16384
DECODE_CHUNK_MIN = 8
DECODE_CHUNK_MAX = 256
# Decoders (graph entries) a model keeps, least recently used dropped first.
# An entry holds its window's cache: at the 4352-position window of a
# 4207-token prompt the dense cache is 32 x 2 x 32 x 4352 x 96 x 2 B = 1.59
# GiB, so four such entries take 8% of an 80 GB card.  The count is an
# assumption, not chosen from traffic: the key is (B, window), the window
# rounds prompt bucket + max_tokens up to 128, and no request mix has been
# measured yet.  ``LM.entry_uses`` counts the requests that reused an entry
# and those that made one (and so capture), for a mix to be judged by.
GRAPH_ENTRIES = 4
# A model's finished entries are kept while they hold at most this share of
# the card's memory (``LM.keep_bytes``; least recently finished dropped
# first), and a larger entry is not kept at all.  At a 131072-position
# window the dense entry holds 48 GiB and the int4 one 15 GiB
# (``engine/state.py:cache_bytes``): on an 80 GB card the int4 entry is kept
# (its next request replays its graph) and the dense one is closed when its
# request ends, as the JAX engine keeps no finished request's cache.
GRAPH_KEEP_SHARE = 0.25


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# -- sampling (JAX engine.py:61-164) ------------------------------------------
# The filters keep the JAX semantics: each enabled threshold is computed over
# the temperature-scaled distribution and the thresholds are intersected (the
# top-1 token passes every one, so extreme settings degrade to greedy).  A
# categorical draw is ``argmax(filtered + gumbel)``, as ``jax.random.
# categorical`` computes it, with the Gumbel noise an argument.  Plain tensor
# ops, no host sync: the engines run them inside captured steps.


def _keep_threshold(sorted_desc, top_p):
    """Threshold of the nucleus: the smallest kept logit, where a token is
    kept while the mass before it is below ``top_p`` (top-1 always kept)."""
    probs = torch.softmax(sorted_desc, dim=-1)
    keep = ((torch.cumsum(probs, dim=-1) - probs) < top_p).sum(dim=-1, keepdim=True)
    return sorted_desc.gather(-1, (keep - 1).clamp(min=0))


def filter_sample_logits(logits, temperature: float, top_p: float, top_k: int = 0,
                         min_p: float = 0.0):
    """Temperature-scaled, filtered logits (..., V) f32 for static knobs:
    ``top_p >= 1``, ``top_k <= 0`` and ``min_p <= 0`` each disable their
    filter (JAX ``filter_sample_logits``)."""
    logits = logits / max(temperature, 1e-6)
    thresh = None
    if top_p < 1.0 or top_k > 0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        if top_p < 1.0:
            thresh = _keep_threshold(sorted_desc, top_p)
        if top_k > 0:
            k = min(int(top_k), logits.shape[-1])
            tk = sorted_desc[..., k - 1 : k]
            thresh = tk if thresh is None else torch.maximum(thresh, tk)
    if min_p > 0.0:
        log_min_p = torch.log(torch.tensor(float(min_p))).to(logits.device)
        tm = logits.amax(dim=-1, keepdim=True) + log_min_p
        thresh = tm if thresh is None else torch.maximum(thresh, tm)
    if thresh is not None:
        logits = logits.masked_fill(logits < thresh, float("-inf"))
    return logits


def sample_token(logits, gumbel, temperature: float, top_p: float, top_k: int = 0,
                 min_p: float = 0.0):
    """Temperature + top-p / top-k / min-p sampling of (B, V) f32 logits
    with Gumbel noise ``gumbel`` (B, V): (B,) int64 (JAX ``sample_token``)."""
    return (filter_sample_logits(logits, temperature, top_p, top_k, min_p) + gumbel).argmax(dim=-1)


def filter_sample_logits_rows(logits, temps, top_ps, top_ks=None, min_ps=None):
    """:func:`filter_sample_logits` with (B,) device knob vectors over
    logits (B, V) or (B, L, V) (JAX ``filter_sample_logits_rows``): top-p
    always applies (``top_ps`` of ``inf`` disables it), ``top_ks`` (0 = off)
    and ``min_ps`` (0 = off) may be None."""
    expand = lambda v: v.reshape(v.shape[0], *([1] * (logits.dim() - 1)))  # noqa: E731
    scaled = logits / expand(temps).clamp(min=1e-6)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    thresh = _keep_threshold(sorted_desc, expand(top_ps))
    if top_ks is not None:
        k = expand(top_ks)
        tk = sorted_desc.gather(-1, (k.clamp(1, scaled.shape[-1]) - 1).expand_as(thresh))
        thresh = torch.maximum(thresh, tk.masked_fill(k <= 0, float("-inf")))
    if min_ps is not None:
        p = expand(min_ps)
        tm = scaled.amax(dim=-1, keepdim=True) + torch.log(p.clamp(min=1e-38))
        thresh = torch.maximum(thresh, tm.masked_fill(p <= 0, float("-inf")))
    return scaled.masked_fill(scaled < thresh, float("-inf"))


def sample_token_rows(logits, gumbel, temps, top_ps, top_ks=None, min_ps=None):
    """Per-row sampling of (B, V) logits with Gumbel noise (B, V); rows with
    ``temps <= 0`` take the exact argmax (JAX ``sample_token_rows``)."""
    filtered = filter_sample_logits_rows(logits, temps, top_ps, top_ks, min_ps)
    return torch.where(temps > 0, (filtered + gumbel).argmax(dim=-1), logits.argmax(dim=-1))


class Knobs:
    """Per-row sampling knobs on the device, the static tensors a captured
    sampling step reads (temperature, top-p, top-k, min-p; JAX's rows
    semantics), and the rows' noise generator."""

    def __init__(self, rows: int, device):
        self.temps = torch.zeros((rows,), dtype=torch.float32, device=device)
        self.top_ps = torch.ones((rows,), dtype=torch.float32, device=device)
        self.top_ks = torch.zeros((rows,), dtype=torch.long, device=device)
        self.min_ps = torch.zeros((rows,), dtype=torch.float32, device=device)
        self.gen = NoiseGen(rows, device)

    def set(self, temps, top_ps, top_ks, min_ps) -> None:
        """Copy host vectors (one value a row) in, without waiting."""
        for t, v in zip((self.temps, self.top_ps, self.top_ks, self.min_ps),
                        (temps, top_ps, top_ks, min_ps)):
            t.copy_(to_device(v, t.device))

    def filtered(self, logits):
        return filter_sample_logits_rows(logits, self.temps, self.top_ps, self.top_ks, self.min_ps)

    def sample(self, logits):
        """Draw every row from its filtered ``logits`` (B, V)."""
        return (self.filtered(logits) + self.gen.gumbel(SAMPLE, logits.shape[1:])).argmax(dim=-1)


def check_cuda_dtype(cfg: ModelConfig) -> None:
    """On CUDA a model is bf16 or fp32: every kernel has an entry for each
    (fp32: f32 activations and queries, quantized weights and caches
    dequantized in f32); another dtype raises."""
    if cfg.dtype not in ("bfloat16", "float32"):
        raise ValueError(f"the CUDA kernels run bf16 or fp32 models, not {cfg.dtype}")


class LM:
    """A loaded model: config + params on the device the caller names.

    On CUDA the kernels take bf16 or fp32 activations
    (:func:`check_cuda_dtype`), with any weights, cache and engine; the CPU
    runs the plain paths in either dtype.  ``graphs`` (default: on for
    CUDA) replays each decode step of this model's engines as a CUDA graph;
    ``graphs=False`` runs them eagerly.

    ``sp_mesh`` (a ``parallel/mesh.py`` mesh): text prompts prefill through
    ring attention over its ``sp_axis`` (``phi3.prefill_ring``) when the
    bucketed prompt splits over that axis's ranks; every rank of the world
    runs the same request and decodes the gathered cache.
    ``ring_prefills`` counts them.
    """

    def __init__(self, cfg: ModelConfig, params: dict, model_path=None, *, device, graphs=None,
                 sp_mesh=None, sp_axis: str = "data"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the kernels need one; pass device='cpu' "
                               "to run the plain PyTorch path instead")
        if self.device.type == "cuda":
            check_cuda_dtype(cfg)
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}; pass graphs=False")
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.model_path = model_path
        self.eos_id = ID_EOS if cfg.vocab_size > ID_EOS else cfg.vocab_size - 1
        # Kept entries, newest last: (B, window) -> Decoder, ("nocache", B,
        # l_pad) -> NocachePass.
        self.decoders: OrderedDict = OrderedDict()
        self.taken = weakref.WeakSet()  # entries out of ``decoders``, serving a request
        self.lock = threading.Lock()  # guards decoders and taken
        self.entry_uses = Counter()  # requests that "reused" an entry or "made" one
        # Bytes this model's finished entries may hold (no limit on the CPU).
        self.keep_bytes = (GRAPH_KEEP_SHARE * torch.cuda.get_device_properties(self.device).total_memory
                           if self.device.type == "cuda" else float("inf"))
        self.sp_mesh, self.sp_axis = sp_mesh, sp_axis
        self.ring_prefills = 0

    # Constrained decoding's device steps (JAX ``LM.score_fn``, ``beam_fn``,
    # ``nocache_fn``): each returns a callable giving f32 log-softmax, as the
    # JAX ones do, and checks the shape it was made for.  With graphs the
    # callable replays the graph of its shape (captured at first use) and
    # returns its static output, which the next call of that shape
    # overwrites: read it first.

    def score_fn(self, b: int, l: int, window: int, advance: Optional[int]):
        """``f(params, ids (B, L), state) -> (log-probs (B, L, V), state)``:
        score a chunk through ``decode_forward`` on the decode route at any
        L, committing ``advance`` positions (0: written but not committed,
        the next call overwrites it; 1: a constrained step; None: all)."""

        @torch.no_grad()
        def f(params, ids, state):
            _check_step("score_fn", ids, (b, l), state, window)
            if not self.graphs:
                return score_logprobs(self, params, state, ids, advance)
            entry = self._entry_of(params, state, l)
            lp = entry.score_step(l, advance)(ids)
            entry.state = dataclasses.replace(state, offset=state.offset + (l if advance is None else advance))
            return lp, entry.state

        return f

    def beam_fn(self, b: int, l: int, window: int, n_beam: int):
        """``f(params, beam_ids (B * n_beam, L), state) -> log-probs (B *
        n_beam, L, V)``: the beam read path, which writes nothing."""

        @torch.no_grad()
        def f(params, beam_ids, state):
            _check_step("beam_fn", beam_ids, (b, l), state, window)
            if not self.graphs:
                return beam_logprobs(self, params, state, beam_ids, n_beam)
            return self._entry_of(params, state, l).beam_step(l, n_beam)(beam_ids)

        return f

    def nocache_fn(self, b: int, l: int):
        """``f(params, ids, pids, valid) -> log-probs (B, V)`` of the last
        position of a cache-free causal pass (``phi3.forward_nocache``);
        with graphs, through the (B, l) :class:`NocachePass` entry, taken
        for the call."""

        @torch.no_grad()
        def f(params, ids, pids, valid):
            if tuple(ids.shape) != (b, l):
                raise ValueError(f"nocache_fn made for {(b, l)}, called with {tuple(ids.shape)}")
            if not self.graphs:
                return nocache_logprobs(self, params, ids, pids, valid)
            _check_params(self, params)
            entry = take_entry(self, ("nocache", b, l)) or NocachePass(self, b, l)
            try:
                # A copy: the entry, back in ``decoders``, serves the next call.
                return entry(ids, pids, valid).clone()
            finally:
                release_decoder(self, entry)

        return f

    def _entry_of(self, params, state, l: int):
        """The taken entry whose state ``state`` is (its device offset),
        made current; raises for a state of no entry (no eager fallback)
        and for a chunk past the window (a replay checks nothing)."""
        _check_params(self, params)
        with self.lock:
            entry = next((e for e in self.taken if e.state is not None and e.state.pos is state.pos), None)
        if entry is None:
            raise ValueError("with graphs a constrained-decoding step runs on a state prefilled into "
                             "an entry (engine.prefill_entry); this one belongs to none")
        if state.offset + l > state.window:
            raise ValueError(f"chunk of {l} at offset {state.offset} overflows window {state.window}")
        entry.state = state
        return entry


def _check_params(lm: LM, params) -> None:
    if params is not lm.params:
        raise ValueError("a graph replays the model's own params (lm.params), not others")


def score_logprobs(lm: LM, params, state, ids, advance: Optional[int]):
    """A score step (:meth:`LM.score_fn`): (f32 log-probs (B, L, V), the
    state advanced by ``advance``)."""
    res = phi3.decode_forward(params, lm.cfg, state, ids, advance=advance, decode_route=True)
    return torch.log_softmax(res.logits.float(), dim=-1), res.state


def beam_logprobs(lm: LM, params, state, beam_ids, n_beam: int):
    """A beam read (:meth:`LM.beam_fn`): f32 log-probs (B * n_beam, L, V)."""
    res = phi3.decode_forward(params, lm.cfg, state, beam_ids, n_beam=n_beam)
    return torch.log_softmax(res.logits.float(), dim=-1)


def nocache_logprobs(lm: LM, params, ids, pids, valid, rope=None):
    """A cache-free pass (:meth:`LM.nocache_fn`): the last position's f32
    log-probs (B, V); ``rope`` as ``phi3.forward_nocache`` takes it."""
    logits = phi3.forward_nocache(params, lm.cfg, ids, pids=pids, prompt_valid=valid, rope=rope)
    return torch.log_softmax(logits[:, -1, :].float(), dim=-1)


def _check_step(name: str, ids, shape, state, window: int) -> None:
    if tuple(ids.shape) != shape or state.window != window:
        raise ValueError(f"{name} made for {shape} in a window of {window}, called with "
                         f"{tuple(ids.shape)} in {state.window}")


def pad_prompt_inputs(dict_input: dict, target_l: int):
    """Left-pad (ids, pids, mask) numpy inputs to ``target_l`` columns; pads
    get id 0, pid 1 and mask 0 (JAX engine ``pad_prompt_inputs``)."""
    ids = np.asarray(dict_input["input_ids"])
    b, l = ids.shape
    pad = target_l - l
    pids = dict_input.get("pids")
    pids = np.tile(np.arange(l, dtype=np.int32), (b, 1)) if pids is None else np.asarray(pids)
    mask = dict_input.get("mask")
    mask = np.ones((b, l), np.int32) if mask is None else np.asarray(mask)
    if pad > 0:
        ids = np.concatenate([np.zeros((b, pad), ids.dtype), ids], axis=1)
        pids = np.concatenate([np.ones((b, pad), pids.dtype), pids], axis=1)
        mask = np.concatenate([np.zeros((b, pad), mask.dtype), mask], axis=1)
    return ids, pids, mask.astype(bool)


def prefill_shape(dict_input: dict, max_tokens: int):
    """(B, l_pad, window) of a prompt's bucketed prefill."""
    b, l = np.asarray(dict_input["input_ids"]).shape
    l_pad = max(round_up(l, PROMPT_BUCKET), PROMPT_BUCKET)
    return b, l_pad, round_up(l_pad + max(int(max_tokens), 1), WINDOW_BUCKET)


def has_images(dict_input: dict) -> bool:
    """Whether a processor's output holds images (any of the vision
    processor's three modes)."""
    return any(dict_input.get(key) is not None for key in ("raw_images", "hd_images", "pixel_values"))


@torch.no_grad()
def run_prefill(lm: LM, dict_input: dict, max_tokens: int, into=None):
    """Bucketed (and above ``PREFILL_CHUNK``, chunked) prefill, into a fresh
    state or reusing ``into``'s tensors (``init_state``).  A vision prompt
    prefills in one pass from its embeddings with the image features
    written in (``models/vision.py:compute_inputs_embeds``; JAX
    ``engine.py:479-549``).  With ``lm.sp_mesh`` a text prompt whose bucket
    splits over the ring's ranks prefills through ``phi3.prefill_ring``
    (JAX ``engine.py:551-567``).

    Returns (last_logits (B, V) float32 on the device, state, l_pad, window).
    """
    b, l_pad, window = prefill_shape(dict_input, max_tokens)
    ids_p, pids_p, valid_p = pad_prompt_inputs(dict_input, l_pad)
    ids = torch.as_tensor(ids_p, dtype=torch.long, device=lm.device)
    pids = torch.as_tensor(pids_p, device=lm.device)
    valid = torch.as_tensor(valid_p, device=lm.device)
    if has_images(dict_input):
        res = phi3.prefill(
            lm.params, lm.cfg, None, max_tokens=window - l_pad, pids=pids, prompt_valid=valid,
            inputs_embeds=compute_inputs_embeds(lm.params, lm.cfg, dict_input, ids_p), last_logit_only=True,
            into=into,
        )
        return res.logits[:, -1, :].float(), res.state, l_pad, window
    if lm.sp_mesh is not None and l_pad % axis_size(lm.sp_mesh, lm.sp_axis) == 0:
        res = phi3.prefill_ring(
            lm.params, lm.cfg, ids, lm.sp_mesh, max_tokens=window - l_pad, seq_axis=lm.sp_axis,
            pids=pids, prompt_valid=valid, last_logit_only=True, into=into,
        )
        lm.ring_prefills += 1
        return res.logits[:, -1, :].float(), res.state, l_pad, window
    if l_pad <= PREFILL_CHUNK:
        res = phi3.prefill(
            lm.params, lm.cfg, ids, max_tokens=window - l_pad, pids=pids,
            prompt_valid=valid, last_logit_only=True, into=into,
        )
        return res.logits[:, -1, :].float(), res.state, l_pad, window
    state = init_state(
        lm.cfg, b, l_pad, window, pids=pids, prompt_valid=valid,
        compute_dtype=torch_dtype(lm.cfg.dtype), device=lm.device, into=into,
    )
    for pos in range(0, l_pad, PREFILL_CHUNK):
        res = phi3.decode_forward(
            lm.params, lm.cfg, state, ids[:, pos : pos + PREFILL_CHUNK], last_logit_only=True
        )
        state = res.state
    return res.logits[:, -1, :].float(), state, l_pad, window


class Decoder:
    """Decode of one state's rows, a step at a time through a
    :class:`~.graphs.StepGraph`: the static token ``(B, 1)`` feeds each step
    and takes its argmax (``graph``), or a draw under the sampling knobs
    (``sampled_graph``, made at the entry's first sampled request); the ring
    takes the statistics the stoppers need.  :meth:`spec_pass` gives the
    entry's speculative verify pass over the same state and token;
    :meth:`score_step` and :meth:`beam_step` its constrained-decoding steps.

    Usage: ``set_sampler(...)`` and ``first_token(logits)`` after a prefill
    into this decoder's state (the first request's own), ``start(state,
    token)``, then ``chunk(n)`` per chunk."""

    def __init__(self, lm: LM, state):
        self.lm, self.state = lm, state
        b = state.valid.shape[0]
        self.token = torch.zeros((b, 1), dtype=torch.long, device=lm.device)
        self.ring = StepRing(DECODE_CHUNK_MAX, b, lm.device)
        self.graph = StepGraph(functools.partial(self._step, False), lm.device, lm.graphs,
                               save=(state.pos, self.token, self.ring.index))
        self.sampling = False
        self.knobs = self.sampled_graph = None
        self.specs = {}  # (K, sampling) -> speculative.SpecPass
        self.steps = {}  # ("score", L, advance) | ("beam", L, n_beam) -> StaticStep

    @property
    def key(self):
        return self.state.valid.shape[0], self.state.window

    def held_bytes(self) -> int:
        """Bytes the entry holds: its state's tensors and its graphs' pools."""
        graphs = [self.graph, self.sampled_graph, *(s.graph for s in self.specs.values()),
                  *(s.graph for s in self.steps.values())]
        return state_bytes(self.state) + sum(g.pool_bytes for g in graphs if g is not None)

    def score_step(self, l: int, advance: Optional[int]) -> StaticStep:
        """This entry's score step of L ids (B, L) -> log-probs (B, L, V)
        over its state (made at first use); the caller sets ``state`` to
        the current one and advances its mirror after."""
        return self._static_step(("score", l, advance), self.token.shape[0],
                                 functools.partial(self._score, advance=advance), save=(self.state.pos,))

    def beam_step(self, l: int, n_beam: int) -> StaticStep:
        """This entry's beam read of (B * n_beam, L) ids -> log-probs (B *
        n_beam, L, V) over its state (made at first use)."""
        return self._static_step(("beam", l, n_beam), self.token.shape[0] * n_beam,
                                 functools.partial(self._beam, n_beam=n_beam))

    def _static_step(self, key, rows: int, fn, save=()) -> StaticStep:
        if key not in self.steps:
            l, dev = key[1], self.lm.device
            ids = torch.zeros((rows, l), dtype=torch.long, device=dev)
            out = torch.zeros((rows, l, self.lm.cfg.vocab_size), dtype=torch.float32, device=dev)
            self.steps[key] = StaticStep(fn, (ids,), out, dev, self.lm.graphs, save=save)
        return self.steps[key]

    @torch.no_grad()
    def _score(self, ids, advance):
        return score_logprobs(self.lm, self.lm.params, self.state, ids, advance)[0]

    @torch.no_grad()
    def _beam(self, ids, n_beam):
        return beam_logprobs(self.lm, self.lm.params, self.state, ids, n_beam)

    @torch.no_grad()
    def _step(self, sampled: bool) -> None:
        res = phi3.decode_forward(self.lm.params, self.lm.cfg, self.state, self.token)
        logits = res.logits[:, -1, :].float()
        nxt = None
        if sampled:
            nxt = self.knobs.sample(logits)
            self.knobs.gen.advance()
        self.token.copy_(self.ring.write(logits, self.lm.eos_id, nxt)[:, None])

    def set_sampler(self, sampler=None, seed: int = 0) -> None:
        """Decode greedily (``sampler`` None) or draw under ``sampler`` =
        (temperature, top_p, top_k, min_p) with the JAX ``sample_token``
        semantics, seeded: row ``r`` of the batch draws from ``seed ^ (r <<
        32)``."""
        self.sampling = sampler is not None
        if not self.sampling:
            return
        b, dev = self.token.shape[0], self.token.device
        if self.knobs is None:
            self.knobs = Knobs(b, dev)
            self.sampled_graph = StepGraph(
                functools.partial(self._step, True), dev, self.lm.graphs,
                save=(self.state.pos, self.token, self.ring.index, self.knobs.gen.counters))
        temperature, top_p, top_k, min_p = sampler
        # Top-p at 1 or above is off; the rows' filter disables it at inf.
        self.knobs.set([temperature] * b, [top_p if top_p < 1 else float("inf")] * b,
                       [top_k] * b, [min_p] * b)
        self.knobs.gen.reset([seed ^ (r << 32) for r in range(b)])

    @torch.no_grad()
    def first_token(self, logits) -> torch.Tensor:
        """The first token (B, 1) from the prefill's last logits (B, V): the
        argmax, or a draw under the sampler (JAX ``engine.py:646-655``)."""
        if not self.sampling:
            return logits.argmax(dim=-1)[:, None]
        token = self.knobs.sample(logits)[:, None]
        self.knobs.gen.advance()
        return token

    def start(self, state, token: torch.Tensor) -> None:
        """Decode from ``state`` (this decoder's buffers) after ``token``
        (B, 1) on the device."""
        if state.pos is not self.state.pos:
            raise ValueError("a decoder decodes the state it was made for (prefill into it)")
        self.state = state
        self.token.copy_(token)

    def spec_pass(self, k_draft: int):
        """This entry's verify pass of ``k_draft`` drafts in the current
        sampling mode (made at first use)."""
        from .speculative import SpecPass

        key = (k_draft, self.sampling)
        if key not in self.specs:
            self.specs[key] = SpecPass(self, k_draft)
        return self.specs[key]

    def close(self) -> None:
        """Let go of the state and the graphs (a dropped entry): the
        decoder and its graphs' steps refer to each other, so without this
        its cache would wait for the garbage collector."""
        for step in self.steps.values():
            step.graph = None  # a static step and its graph refer to each other
        self.graph = self.sampled_graph = self.knobs = None
        self.specs, self.steps = {}, {}
        self.state = None

    def advance_mirror(self, n: int) -> None:
        """Move the host mirror of the offset by ``n`` positions the device
        committed (a speculative chunk's emitted tokens)."""
        self.state = dataclasses.replace(self.state, offset=self.state.offset + n)

    @torch.no_grad()
    def chunk(self, n_steps: int):
        """``n_steps`` steps, greedy or sampled.  Returns device views
        (n_steps, B) of the tokens, max log-probs and EOS log-probs, valid
        until the next chunk."""
        st = self.state
        if st.offset + n_steps > st.window:
            raise ValueError(f"{n_steps} steps at offset {st.offset} overflow window {st.window}")
        graph = self.sampled_graph if self.sampling else self.graph
        self.ring.start(n_steps)
        for _ in range(n_steps):
            graph()
        self.state = dataclasses.replace(st, offset=st.offset + n_steps)
        return self.ring.rows(n_steps)


class NocachePass:
    """The cache-free pass of one (B, l_pad) (:meth:`LM.nocache_fn`), an
    entry of ``LM.decoders`` beside the decoders: static ids, RoPE tables
    and valid mask in, the last position's f32 log-probs (B, V) out.  The
    tables are made from the pids before the step (``su_rope_tables``
    copies host values to the device, which a capture refuses)."""

    def __init__(self, lm: LM, b: int, l: int):
        cfg, dev = lm.cfg, lm.device
        self.lm, self.key = lm, ("nocache", b, l)
        table = lambda: torch.zeros((b, l, cfg.head_dim), dtype=torch.float32, device=dev)  # noqa: E731
        inputs = (torch.zeros((b, l), dtype=torch.long, device=dev), table(), table(),
                  torch.zeros((b, l), dtype=torch.bool, device=dev))
        out = torch.zeros((b, cfg.vocab_size), dtype=torch.float32, device=dev)
        self.step = StaticStep(self._logprobs, inputs, out, dev, lm.graphs)

    @torch.no_grad()
    def _logprobs(self, ids, cos, sin, valid):
        return nocache_logprobs(self.lm, self.lm.params, ids, None, valid, rope=(cos, sin))

    def __call__(self, ids, pids, valid) -> torch.Tensor:
        b, l = self.key[1:]
        cos, sin = su_rope_tables(self.lm.cfg, l, pids, device=self.lm.device)
        return self.step(ids, cos.expand(b, -1, -1), sin.expand(b, -1, -1), valid)

    def held_bytes(self) -> int:
        return (sum(t.numel() * t.element_size() for t in (*self.step.inputs, self.step.out))
                + self.step.graph.pool_bytes)

    def close(self) -> None:
        self.step.graph = self.step = None  # the step and its graph refer to each other


def take_entry(lm: LM, key):
    """With graphs, the kept entry of ``key`` taken out of ``lm.decoders``
    (None if there is none); ``lm.entry_uses`` counts the request as one
    that reused an entry or made one."""
    if not lm.graphs:
        return None
    with lm.lock:
        entry = lm.decoders.pop(key, None)
        lm.entry_uses["reused" if entry is not None else "made"] += 1
    return entry


def prefill_entry(lm: LM, dict_input: dict, max_tokens: int):
    """Prefill a request into its (B, window) entry's buffers (with graphs:
    the kept entry, taken out of ``lm.decoders``, or a new one) and return
    (the :class:`Decoder`, its state set, the last logits (B, V) f32, the
    state, l_pad, window).  An entry serves one request at a time, so a
    second request of the key meanwhile makes its own.  Give it back with
    :func:`release_decoder` when the request ends."""
    b, _, window = prefill_shape(dict_input, max_tokens)
    entry = take_entry(lm, (b, window))
    if entry is None and lm.device.type == "cuda":
        # A freed cache's segment that a small tensor has since split cannot
        # hold a new cache of its size; the card's free memory can.
        if torch.cuda.mem_get_info(lm.device)[0] < cache_bytes(lm.cfg, b, window, torch_dtype(lm.cfg.dtype)):
            torch.cuda.empty_cache()
    last_logits, state, l_pad, window = run_prefill(lm, dict_input, max_tokens,
                                                    into=None if entry is None else entry.state)
    dec = entry or Decoder(lm, state)
    dec.state = state
    if lm.graphs:
        with lm.lock:
            lm.taken.add(dec)
    return dec, last_logits, state, l_pad, window


def prefill_decoder(lm: LM, dict_input: dict, max_tokens: int, sampler=None, seed: int = 0):
    """Prefill a request (:func:`prefill_entry`) and return (its Decoder,
    started on the first token, and that token (B, 1) on the device): the
    prefill's argmax, or with ``sampler`` a draw seeded by ``seed``
    (:meth:`Decoder.set_sampler`)."""
    dec, last_logits, state, _, _ = prefill_entry(lm, dict_input, max_tokens)
    dec.set_sampler(sampler, seed)
    token = dec.first_token(last_logits)
    dec.start(state, token)
    return dec, token


def release_decoder(lm: LM, dec) -> None:
    """Keep a finished request's entry (a :class:`Decoder` or a
    :class:`NocachePass`) as its key's newest (with graphs), dropping the
    least recently finished beyond ``GRAPH_ENTRIES`` or ``lm.keep_bytes``
    (each entry's tensors and graph pools); an entry larger than
    ``lm.keep_bytes`` is not kept.  A dropped entry is closed (its cache
    and graphs go now)."""
    if not lm.graphs:
        return
    key = dec.key
    with lm.lock:
        lm.taken.discard(dec)
        other = lm.decoders.pop(key, None)  # another request's entry of the key, made meanwhile
        if other is not None:
            other.close()
        if dec.held_bytes() > lm.keep_bytes:
            dec.close()
        else:
            lm.decoders[key] = dec
        while lm.decoders and (len(lm.decoders) > GRAPH_ENTRIES or
                               sum(d.held_bytes() for d in lm.decoders.values()) > lm.keep_bytes):
            lm.decoders.popitem(last=False)[1].close()


def spec_settings(lm: LM):
    """(K, passes a chunk at most) of single-stream speculation, from
    ``PHI3V_TPU_SPEC_K`` (7) and ``PHI3V_TPU_SPEC_ITERS`` (64) as the JAX
    engine reads them, K checked against the JAX range."""
    from .speculative import check_spec_k

    k = int(os.environ.get("PHI3V_TPU_SPEC_K", "7"))
    iters = int(os.environ.get("PHI3V_TPU_SPEC_ITERS", "64"))
    check_spec_k(k)
    if not 1 <= k or not 1 <= iters <= DECODE_CHUNK_MAX:
        raise ValueError(f"PHI3V_TPU_SPEC_K={k} and PHI3V_TPU_SPEC_ITERS={iters}: K must be "
                         f">= 1 and the passes a chunk in [1, {DECODE_CHUNK_MAX}]")
    return k, iters


def generate_text(
    lm: LM,
    processor,
    prompt,
    images=None,
    max_tokens: int = 512,
    verbose: bool = True,
    return_tps: bool = False,
    early_stop=False,
    stream: bool = True,
    mute: bool = False,
    sample: bool = False,
    temperature: float = 1.0,
    top_p: float = 1.0,
    top_k: int = 0,
    min_p: float = 0.0,
    seed: int = 0,
    speculative=None,
    stop=None,
):
    """Generation (JAX ``generate_text``): text prompts, or one prompt with
    ``images`` (decoded images, or any object with ``.size`` and
    ``.convert``) for a vision model.  Greedy by default; ``sample=True``
    draws under ``temperature``, ``top_p``, ``top_k`` and ``min_p`` from
    ``seed``.  ``speculative=True`` (default: ``PHI3V_TPU_SPEC=1``) runs
    prompt-lookup verify passes for a single prompt (greedy: the vanilla
    stream; sampled: rejection-sampled verification) while the window has
    room for a pass, then the vanilla steps; ``lm._spec_stats`` counts the
    passes that emitted (``iters``), their tokens and the dead passes."""
    if images is not None and isinstance(prompt, list):
        raise ValueError("Images cannot be provided when prompt is a list")
    sampler = (float(temperature), float(top_p), int(top_k), float(min_p)) if sample else None
    if speculative is None:
        speculative = os.environ.get("PHI3V_TPU_SPEC", "0") == "1"
    dict_input = processor(prompt, images)
    b = int(np.asarray(dict_input["input_ids"]).shape[0])
    use_spec = bool(speculative) and b == 1
    if use_spec:
        spec_k, spec_iters = spec_settings(lm)
    logit_stopper = LogitStopper(max_tokens, early_stop)
    token_stopper = TokenStopper(b, lm.eos_id)
    stop_seqs = StopSequences(processor.tokenizer, stop, b)
    streamer = Streamer(processor.tokenizer, stream, mute, stops=stop_seqs.stops)

    t0 = time.perf_counter()
    dec, tok_dev = prefill_decoder(lm, dict_input, max_tokens, sampler=sampler, seed=seed)
    token = tok_dev.cpu().numpy().astype(np.int32)
    streamer(token)
    t1 = time.perf_counter()
    prompt_time = t1 - t0

    n_emitted = 1
    stopped = bool(stop_seqs) and stop_seqs.update(token)
    # PHI3V_TPU_STEP_LOG=<path>: one latency sample per decode chunk (after
    # its host fetch, outside any captured step), the summary written there.
    step_log = os.environ.get("PHI3V_TPU_STEP_LOG")
    step_timer = None
    if step_log:
        from ..utils.profiler import StepTimer

        step_timer = StepTimer()
        step_timer.tick()

    def consume(tok, maxlp: float, eoslp: float) -> bool:
        """One emitted token (B,), in the reference order: stream it, the
        logit stopper takes the logits that produced it, then EOS, then
        stop strings.  True when the generation ends."""
        nonlocal n_emitted
        streamer(tok[:, None])
        n_emitted += 1
        return (logit_stopper.update(maxlp, eoslp, b) or token_stopper.update(tok)
                or bool(stop_seqs and stop_seqs.update(tok)) or n_emitted >= max_tokens)

    if use_spec:
        spec = dec.spec_pass(spec_k)
        spec.start(pad_prompt_inputs(dict_input, dec.state.offset)[0])
        stats = lm._spec_stats = {"iters": 0, "emitted": 0, "dead": 0}
    chunk = DECODE_CHUNK_MIN
    while n_emitted < max_tokens and not stopped:
        if use_spec and dec.state.window - dec.state.offset >= spec_k + 1:
            left = max_tokens - n_emitted
            n_passes = spec.passes_for(left, spec_iters)
            toks, maxlp, eoslp, n_emits = (t.cpu().numpy() for t in spec.chunk(n_passes, left))
            if step_timer is not None:
                step_timer.tick()
            dec.advance_mirror(int(n_emits.sum()))
            stats["dead"] += int((n_emits == 0).sum())  # budget or window used up on the device
            for it in range(n_passes):
                m = int(n_emits[it, 0])
                if stopped or m == 0:
                    continue
                stats["iters"] += 1
                stats["emitted"] += m
                for p in range(m):
                    if consume(toks[it, :, p].astype(np.int32), float(maxlp[it, 0, p]),
                               float(eoslp[it, 0, p])):
                        stopped = True
                        break
            continue
        # The window's tail (too short for a pass) decodes through the
        # vanilla steps of the same entry.
        n_steps = min(chunk, max_tokens - n_emitted)
        chunk = min(chunk * 4, DECODE_CHUNK_MAX)
        toks, maxlp, eoslp = dec.chunk(n_steps)
        toks = toks.cpu().numpy().astype(np.int32)  # one host transfer per chunk
        maxlp, eoslp = maxlp.cpu().numpy(), eoslp.cpu().numpy()
        if step_timer is not None:
            step_timer.tick()
        for i in range(n_steps):
            if consume(toks[i], float(maxlp[i, 0]), float(eoslp[i, 0])):
                stopped = True
                break
    release_decoder(lm, dec)  # not after a failure: that entry is dropped
    if step_timer is not None:
        step_timer.dump(step_log)

    result, gen_len = streamer.end()
    result = stop_seqs.trim(result)
    gen_time = time.perf_counter() - t1
    prompt_len = int(np.asarray(dict_input["input_ids"]).size)
    prompt_tps = prompt_len / prompt_time
    gen_tps = (gen_len - 1) / max(gen_time, 1e-9)
    if verbose:
        print(f"\nPrompt: {prompt_tps:.2f} tokens-per-sec ({prompt_len} tokens / {prompt_time:.1f} sec)")
        print(f"Generate: {gen_tps:.2f} tokens-per-sec ({gen_len} tokens / {gen_time:.1f} sec)")
    if return_tps:
        return prompt_tps, gen_tps
    return result
