"""Generation engine: bucketed prefill and greedy chunked decode
(counterpart of ``phi_3_vision_mlx_tpu/engine/engine.py``).

The contract of the JAX engine carries over: prompts are left-padded to a
64-token bucket and the window rounded to 128; prompts longer than
``PREFILL_CHUNK`` prefill in chunks through ``decode_forward``; decode runs
in chunks whose argmax feeds back on the device, and the host fetches the
tokens and the two logit statistics the stoppers need once per chunk, then
replays the stoppers in the reference order.  Chunk sizes ramp from
``DECODE_CHUNK_MIN`` by 4x up to ``DECODE_CHUNK_MAX``.  Decode runs eagerly
(one kernel launch at a time); CUDA graphs are later work.  Sampling,
speculation and vision prompts are not ported yet; the continuous-batching
engines are ``engine/batching.py`` and ``engine/paging.py``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.config import ID_EOS, ModelConfig
from ..core.weights import params_to, torch_dtype
from ..models import phi3
from .state import init_state
from .stream import LogitStopper, StopSequences, Streamer, TokenStopper

PROMPT_BUCKET = 64
WINDOW_BUCKET = 128
PREFILL_CHUNK = 16384
DECODE_CHUNK_MIN = 8
DECODE_CHUNK_MAX = 256


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class LM:
    """A loaded model: config + params on the device the caller names.

    On CUDA the kernels take bf16 activations, so ``cfg.dtype`` must be
    ``"bfloat16"`` there; the CPU runs the plain paths in either dtype.
    """

    def __init__(self, cfg: ModelConfig, params: dict, model_path=None, *, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the kernels need one; pass device='cpu' "
                               "to run the plain PyTorch path instead")
        if self.device.type == "cuda" and cfg.dtype != "bfloat16":
            raise ValueError(f"the CUDA kernels run bf16 models, not {cfg.dtype}")
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.model_path = model_path
        self.eos_id = ID_EOS if cfg.vocab_size > ID_EOS else cfg.vocab_size - 1


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


@torch.no_grad()
def run_prefill(lm: LM, dict_input: dict, max_tokens: int):
    """Bucketed (and above ``PREFILL_CHUNK``, chunked) text prefill.

    Returns (last_logits (B, V) float32 on the device, state, l_pad, window).
    """
    if any(dict_input.get(key) is not None for key in ("pixel_values", "hd_images", "raw_images")):
        raise NotImplementedError("vision prompts are not ported yet")
    b, l = np.asarray(dict_input["input_ids"]).shape
    l_pad = max(round_up(l, PROMPT_BUCKET), PROMPT_BUCKET)
    window = round_up(l_pad + max(int(max_tokens), 1), WINDOW_BUCKET)
    ids_p, pids_p, valid_p = pad_prompt_inputs(dict_input, l_pad)
    ids = torch.as_tensor(ids_p, dtype=torch.long, device=lm.device)
    pids = torch.as_tensor(pids_p, device=lm.device)
    valid = torch.as_tensor(valid_p, device=lm.device)
    if l_pad <= PREFILL_CHUNK:
        res = phi3.prefill(
            lm.params, lm.cfg, ids, max_tokens=window - l_pad, pids=pids,
            prompt_valid=valid, last_logit_only=True,
        )
        return res.logits[:, -1, :].float(), res.state, l_pad, window
    state = init_state(
        lm.cfg, b, l_pad, window, pids=pids, prompt_valid=valid,
        compute_dtype=torch_dtype(lm.cfg.dtype), device=lm.device,
    )
    for pos in range(0, l_pad, PREFILL_CHUNK):
        res = phi3.decode_forward(
            lm.params, lm.cfg, state, ids[:, pos : pos + PREFILL_CHUNK], last_logit_only=True
        )
        state = res.state
    return res.logits[:, -1, :].float(), state, l_pad, window


@torch.no_grad()
def decode_chunk(lm: LM, token: torch.Tensor, state, n_steps: int):
    """``n_steps`` greedy steps with the argmax fed back on the device.

    token (B, 1) int64 on the device.  Returns the last token, the state and
    device tensors (n_steps, B) of tokens, max log-prob and EOS log-prob.
    """
    b = token.shape[0]
    toks = torch.empty((n_steps, b), dtype=torch.long, device=lm.device)
    maxlp = torch.empty((n_steps, b), dtype=torch.float32, device=lm.device)
    eoslp = torch.empty((n_steps, b), dtype=torch.float32, device=lm.device)
    for step in range(n_steps):
        res = phi3.decode_forward(lm.params, lm.cfg, state, token)
        state = res.state
        logits = res.logits[:, -1, :].float()
        lp = torch.log_softmax(logits, dim=-1)
        nxt = logits.argmax(dim=-1)
        toks[step] = nxt
        maxlp[step] = lp.amax(dim=-1)
        eoslp[step] = lp[:, lm.eos_id]
        token = nxt[:, None]
    return token, state, toks, maxlp, eoslp


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
    """Greedy generation for text prompts (JAX ``generate_text``)."""
    if images is not None:
        raise NotImplementedError("vision prompts are not ported yet")
    if sample:
        raise NotImplementedError("sampling is not ported yet; the port decodes greedily")
    dict_input = processor(prompt, None)
    b = int(np.asarray(dict_input["input_ids"]).shape[0])
    logit_stopper = LogitStopper(max_tokens, early_stop)
    token_stopper = TokenStopper(b, lm.eos_id)
    stop_seqs = StopSequences(processor.tokenizer, stop, b)
    streamer = Streamer(processor.tokenizer, stream, mute, stops=stop_seqs.stops)

    t0 = time.perf_counter()
    last_logits, state, _, _ = run_prefill(lm, dict_input, max_tokens)
    tok_dev = last_logits.argmax(dim=-1)[:, None]
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
        tok_dev, state, toks, maxlp, eoslp = decode_chunk(lm, tok_dev, state, n_steps)
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
