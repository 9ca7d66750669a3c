"""Generation engine: bucketed prefill and greedy chunked decode
(counterpart of ``phi_3_vision_mlx_tpu/engine/engine.py``).

The contract of the JAX engine carries over: prompts are left-padded to a
64-token bucket and the window rounded to 128; prompts longer than
``PREFILL_CHUNK`` prefill in chunks through ``decode_forward``; decode runs
in chunks whose argmax feeds back on the device, and the host fetches the
tokens and the two logit statistics the stoppers need once per chunk, then
replays the stoppers in the reference order.  Chunk sizes ramp from
``DECODE_CHUNK_MIN`` by 4x up to ``DECODE_CHUNK_MAX``.

A :class:`Decoder` runs the decode steps (the JAX engine's ``chunk_fn``):
on the card each step is one replay of a CUDA graph (``engine/graphs.py``),
keyed by (rows, window) on the model's cache kind, with no key per chunk
length.  A graph holds the addresses it captured, so its entry owns its
decode state, and the next request of the same key prefills into those
buffers (``init_state(into=...)``); ``LM.decoders`` keeps the
``GRAPH_ENTRIES`` most recently finished entries, and an entry leaves it
while a request decodes with it (one request at a time).  ``LM(graphs=False)`` runs the same
steps eagerly on the card (the reference); the CPU always does.  Prefill and
extend chunks run eagerly.  A vision prompt (the vision processor's
``raw_images``, ``hd_images`` or ``pixel_values``) runs its image pipeline
(``models/vision.py``), writes each image's features over its placeholders
and prefills the whole prompt from those embeddings in one pass, never
chunked, as the JAX engine does; by decode time its image tokens are cache
columns like any other, so it decodes through the same :class:`Decoder`.
Sampling and speculation are not ported yet; the continuous-batching
engines are ``engine/batching.py`` and ``engine/paging.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import Counter, OrderedDict

import numpy as np
import torch

from ..core.config import ID_EOS, ModelConfig
from ..core.weights import params_to, torch_dtype
from ..models import phi3
from ..models.vision import compute_inputs_embeds
from .graphs import StepGraph, StepRing
from .state import init_state
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


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class LM:
    """A loaded model: config + params on the device the caller names.

    On CUDA the kernels take bf16 activations, so ``cfg.dtype`` must be
    ``"bfloat16"`` there; the CPU runs the plain paths in either dtype.
    ``graphs`` (default: on for CUDA) replays each decode step of this
    model's engines as a CUDA graph; ``graphs=False`` runs them eagerly.
    """

    def __init__(self, cfg: ModelConfig, params: dict, model_path=None, *, device, graphs=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the kernels need one; pass device='cpu' "
                               "to run the plain PyTorch path instead")
        if self.device.type == "cuda" and cfg.dtype != "bfloat16":
            raise ValueError(f"the CUDA kernels run bf16 models, not {cfg.dtype}")
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}; pass graphs=False")
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.model_path = model_path
        self.eos_id = ID_EOS if cfg.vocab_size > ID_EOS else cfg.vocab_size - 1
        self.decoders: OrderedDict = OrderedDict()  # (B, window) -> Decoder, newest last
        self.lock = threading.Lock()  # guards decoders
        self.entry_uses = Counter()  # requests that "reused" an entry or "made" one


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
    ``engine.py:479-549``).

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
    """Greedy decode of one state's rows, a step at a time through a
    :class:`~.graphs.StepGraph`: the static token ``(B, 1)`` feeds each step
    and takes its argmax; the ring takes the statistics the stoppers need.

    Usage: ``start(state, token)`` after a prefill into this decoder's state
    (the first request's own), then ``chunk(n)`` per chunk."""

    def __init__(self, lm: LM, state):
        self.lm, self.state = lm, state
        b = state.valid.shape[0]
        self.token = torch.zeros((b, 1), dtype=torch.long, device=lm.device)
        self.ring = StepRing(DECODE_CHUNK_MAX, b, lm.device)
        self.graph = StepGraph(self._step, lm.device, lm.graphs,
                               save=(state.pos, self.token, self.ring.index))

    @torch.no_grad()
    def _step(self) -> None:
        res = phi3.decode_forward(self.lm.params, self.lm.cfg, self.state, self.token)
        nxt = self.ring.write(res.logits[:, -1, :].float(), self.lm.eos_id)
        self.token.copy_(nxt[:, None])

    def start(self, state, token: torch.Tensor) -> None:
        """Decode from ``state`` (this decoder's buffers) after ``token``
        (B, 1) on the device."""
        if state.pos is not self.state.pos:
            raise ValueError("a decoder decodes the state it was made for (prefill into it)")
        self.state = state
        self.token.copy_(token)

    @torch.no_grad()
    def chunk(self, n_steps: int):
        """``n_steps`` greedy steps.  Returns device views (n_steps, B) of the
        tokens, max log-probs and EOS log-probs, valid until the next chunk."""
        st = self.state
        if st.offset + n_steps > st.window:
            raise ValueError(f"{n_steps} steps at offset {st.offset} overflow window {st.window}")
        self.ring.start(n_steps)
        for _ in range(n_steps):
            self.graph()
        self.state = dataclasses.replace(st, offset=st.offset + n_steps)
        return self.ring.rows(n_steps)


def prefill_decoder(lm: LM, dict_input: dict, max_tokens: int):
    """Prefill a request and return (its Decoder, started on the prefill's
    argmax, and that first token (B, 1) on the device).  With graphs the
    decoder is the (B, window) entry of ``lm.decoders``, taken out of it
    (reused) or made: an entry serves one request at a time, so a second
    request of the key meanwhile makes its own.  Give it back with
    :func:`release_decoder` when the request ends."""
    b, _, window = prefill_shape(dict_input, max_tokens)
    with lm.lock:
        entry = lm.decoders.pop((b, window), None)
        lm.entry_uses["reused" if entry is not None else "made"] += 1
    last_logits, state, _, _ = run_prefill(lm, dict_input, max_tokens,
                                           into=None if entry is None else entry.state)
    dec = entry or Decoder(lm, state)
    token = last_logits.argmax(dim=-1)[:, None]
    dec.start(state, token)
    return dec, token


def release_decoder(lm: LM, dec: Decoder) -> None:
    """Keep a finished request's decoder as its key's newest entry (with
    graphs), dropping the least recently used beyond ``GRAPH_ENTRIES``."""
    if not lm.graphs:
        return
    key = (dec.state.valid.shape[0], dec.state.window)
    with lm.lock:
        lm.decoders.pop(key, None)  # another request's entry of the key, made meanwhile
        lm.decoders[key] = dec
        while len(lm.decoders) > GRAPH_ENTRIES:
            lm.decoders.popitem(last=False)


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
    stop=None,
):
    """Greedy generation (JAX ``generate_text``): text prompts, or one
    prompt with ``images`` (decoded images, or any object with ``.size`` and
    ``.convert``) for a vision model."""
    if images is not None and isinstance(prompt, list):
        raise ValueError("Images cannot be provided when prompt is a list")
    if sample:
        raise NotImplementedError("sampling is not ported yet; the port decodes greedily")
    dict_input = processor(prompt, images)
    b = int(np.asarray(dict_input["input_ids"]).shape[0])
    logit_stopper = LogitStopper(max_tokens, early_stop)
    token_stopper = TokenStopper(b, lm.eos_id)
    stop_seqs = StopSequences(processor.tokenizer, stop, b)
    streamer = Streamer(processor.tokenizer, stream, mute, stops=stop_seqs.stops)

    t0 = time.perf_counter()
    dec, tok_dev = prefill_decoder(lm, dict_input, max_tokens)
    token = tok_dev.cpu().numpy().astype(np.int32)
    streamer(token)
    t1 = time.perf_counter()
    prompt_time = t1 - t0

    n_emitted = 1
    stopped = bool(stop_seqs) and stop_seqs.update(token)
    chunk = DECODE_CHUNK_MIN
    while n_emitted < max_tokens and not stopped:
        n_steps = min(chunk, max_tokens - n_emitted)
        chunk = min(chunk * 4, DECODE_CHUNK_MAX)
        toks, maxlp, eoslp = dec.chunk(n_steps)
        toks = toks.cpu().numpy().astype(np.int32)  # one host transfer per chunk
        maxlp, eoslp = maxlp.cpu().numpy(), eoslp.cpu().numpy()
        for i in range(n_steps):
            # Reference order: stream the token, the logit stopper consumes
            # the logits that produced it, then EOS, then stop strings.
            streamer(toks[i][:, None])
            n_emitted += 1
            if logit_stopper.update(float(maxlp[i, 0]), float(eoslp[i, 0]), b):
                stopped = True
                break
            if token_stopper.update(toks[i]):
                stopped = True
                break
            if stop_seqs and stop_seqs.update(toks[i]):
                stopped = True
                break
            if n_emitted >= max_tokens:
                break
    release_decoder(lm, dec)  # not after a failure: that entry is dropped

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
