"""Constrained decoding: choice selection, forced-suffix synthesis, beam
(counterpart of ``phi_3_vision_mlx_tpu/engine/constrain.py``; the
reference's ``_choose_from``, ``_constrain`` and ``_get_beam``).

At every free-token step the model scores both "emit a free token" and
"append the forced constraint now", keeping the best running synthesis by
mean log-prob.  The cache work is the port's ``LM`` steps: ``score_fn``
with ``advance=0`` writes the constraint's k/v past the offset without
committing them (the next step overwrites them), ``advance=1`` commits one
token of a chunk, and ``beam_fn`` scores ``n_beam`` candidates each followed
by the constraint against the shared cache, writing nothing.

The device hands back the (B, L, V) f32 log-probs, and the bookkeeping
(argmax, argpartition, gathers) runs in NumPy on the host, where the JAX
package and the reference run it: the code below follows the JAX module
line for line, so ties break the same way.  Each constraint's prompt
prefills into an entry of the model (``engine.prefill_entry``), which the
question holds until it ends and then gives back (``release_decoder``); on
the card the entry replays a CUDA graph of each step shape (a score step of
any length takes K3/K4 on the device offset), so the next question of the
same shape captures nothing.  ``LM(graphs=False)`` and the CPU run the same
steps eagerly.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.config import ID_EOS
from ..models.tokenizer import ByteTokenizer
from ..utils.timing import Tic
from .engine import LM, PROMPT_BUCKET, pad_prompt_inputs, prefill_entry, release_decoder, round_up


def _preprocess(s: str) -> str:
    """Prompt normalization (reference ``_preprocess``)."""
    for tag in ["<|system|>", "<|user|>", "<|end|>"]:
        s = s.replace(f"{tag} ", f"{tag}\n").replace(f"{tag}\n\n", f"{tag}\n")
    return s.replace("<|end|><|assistant|>", "<|end|>\n<|assistant|>")


def _already(tokens_2d: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Rows that have not yet emitted the constraint as their suffix (True
    while the row's tokens are shorter than it)."""
    if tokens_2d.shape[1] < ids.shape[0]:
        return np.ones(tokens_2d.shape[0], bool)
    return ~np.all(tokens_2d[:, -len(ids) :] == ids, axis=1)


def encode_suffix(tokenizer, text: str) -> np.ndarray:
    """Constraint text -> ids with no BOS or prefix artifact: a
    sentencepiece tokenizer's leading prefix token is dropped, as the
    reference does; the ByteTokenizer has none."""
    ids = tokenizer.encode(text, add_special_tokens=False)
    if not isinstance(tokenizer, ByteTokenizer) and len(ids) > 1:
        ids = ids[1:]
    return np.asarray(ids, np.int32)


def _device_ids(lm: LM, ids: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=lm.device)


def _run_nocache(lm: LM, dict_input: dict) -> np.ndarray:
    """Bucketed cache-free pass -> last-position log-softmax (B, V)."""
    ids = np.asarray(dict_input["input_ids"])
    b, l = ids.shape
    l_pad = max(round_up(l, PROMPT_BUCKET), PROMPT_BUCKET)
    ids_p, pids_p, valid_p = pad_prompt_inputs(dict_input, l_pad)
    fn = lm.nocache_fn(b, l_pad)
    lp = fn(lm.params, _device_ids(lm, ids_p), torch.as_tensor(pids_p, device=lm.device),
            torch.as_tensor(valid_p, device=lm.device))
    return lp.cpu().numpy()


def choose_from(lm: LM, processor, prompt, choices: str = "ABCDE", mute: bool = False):
    """Single-pass option selection (reference ``_choose_from``): the
    choice whose `` c`` token has the highest last-position log-prob."""
    option_ids = np.array([processor(f" {c}")["input_ids"][0, -1] for c in choices], np.int64)
    was_str = isinstance(prompt, str)
    dict_input = processor(prompt)
    lp = _run_nocache(lm, dict_input)
    indices = np.argmax(lp[:, option_ids], axis=-1).tolist()
    output = [choices[i] for i in indices]
    if not mute:
        if was_str:
            print(output[0])
        else:
            for i, o in enumerate(output):
                print(f"\n< Chosen option for prompt #{i} >\n{o}")
    return output[0] if was_str else output


def _log_mean(x: np.ndarray, log_norm: bool) -> np.ndarray:
    if log_norm:
        return x.sum(axis=-1) / np.log(x.shape[-1])
    return x.sum(axis=-1) / x.shape[-1]


def _get_beam(lm: LM, lp: np.ndarray, state, id_constraint: np.ndarray, window: int,
              beam_idx: int = 0, n_beam: int = 3):
    """Score the top-``n_beam`` candidate tokens at ``beam_idx``, each
    followed by the constraint, against the shared cache (reference
    ``_get_beam``).  Returns (argmax token (B,), best beam token (B,), its
    per-token scores (B, L + 1))."""
    b, _, v = lp.shape
    logits_at = lp[:, beam_idx, :]  # (B, V)
    token = np.argmax(logits_at, axis=-1)
    arg_beam = np.argpartition(-logits_at, n_beam, axis=-1)[:, :n_beam]  # (B, n)
    beam = arg_beam.reshape(-1)[:, None]  # (B*n, 1)
    tiled = np.tile(id_constraint, (beam.shape[0], 1))
    beam_ids = np.concatenate([beam, tiled], axis=1).astype(np.int32)  # (B*n, 1+L)
    fn = lm.beam_fn(b * n_beam, beam_ids.shape[1], window, n_beam)
    beam_lp = fn(lm.params, _device_ids(lm, beam_ids), state).cpu().numpy()
    lcons = beam_ids.shape[1] - 1
    rows = np.arange(beam_ids.shape[0])[:, None]
    cols = np.arange(lcons)[None, :]
    cont_scores = beam_lp[rows, cols, beam_ids[:, 1:]]  # (B*n, L)
    first_scores = logits_at[np.arange(b)[:, None], arg_beam].reshape(-1)[:, None]
    beam_score = np.concatenate([first_scores, cont_scores], axis=1)  # (B*n, L+1)
    argmax_beam = np.argmax(beam_score.mean(axis=1).reshape(b, n_beam), axis=-1)
    beam_token = arg_beam[np.arange(b), argmax_beam]
    beam_score = beam_score.reshape(b, n_beam, -1)[np.arange(b), argmax_beam]
    return token, beam_token, beam_score


def constrain_decode(
    lm: LM,
    processor,
    prompt,
    constraints,
    return_full_text: bool = False,
    mute: bool = False,
    use_beam: bool = False,
    verbose: bool = True,
    log_norm: bool = False,
):
    """Constrained generation (reference ``_constrain``).  ``constraints``:
    a list of ``(n_free, text)`` (up to ``n_free`` free tokens, then
    ``text`` forced where it scores best) and choice strings (``"ABCDE"``:
    :func:`choose_from` appends the chosen letter)."""
    was_str = isinstance(prompt, str)
    prompt = [prompt] if was_str else list(prompt)
    tic = Tic()
    prompt_time = 0.0
    constrain_time = 0.0

    prompt = [_preprocess(s) for s in prompt]
    len_ps = [len(p) for p in prompt]
    b = len(prompt)
    synth_pad = np.tile(np.array([ID_EOS], np.int32), (b, 1))
    output = prompt

    for constraint in constraints:
        if isinstance(constraint, str):
            chosen = choose_from(lm, processor, prompt, constraint, mute=True)
            output = [" ".join([p, o]) for p, o in zip(prompt, chosen)]
            prompt = output
            continue

        n_free, constraint_text = constraint
        id_constraint = encode_suffix(processor.tokenizer, constraint_text)
        lcons = len(id_constraint)
        dict_input = processor(prompt)
        ids = np.asarray(dict_input["input_ids"])
        max_tokens = n_free + lcons + 10

        entry, last_lp_raw, state, l_pad, window = prefill_entry(lm, dict_input, max_tokens)
        try:
            last_lp = last_lp_raw.cpu().numpy()
            last_lp = last_lp - _logsumexp(last_lp)  # log_softmax of last position

            score_0 = last_lp[:, id_constraint[0]]
            tiled = np.tile(id_constraint, (b, 1)).astype(np.int32)

            sfn = lm.score_fn(b, lcons, window, advance=0)
            lp_rest, state = sfn(lm.params, _device_ids(lm, tiled), state)
            lp_rest = lp_rest.cpu().numpy()
            rows = np.arange(b)[:, None]
            score_1 = lp_rest[rows, np.arange(lcons - 1)[None, :], tiled[:, 1:]]

            running_score = last_lp.max(axis=-1)[:, None]
            pre_beam_score = _log_mean(np.concatenate([score_0[:, None], score_1], axis=1), log_norm)
            pre_beam_synth = np.concatenate([tiled, synth_pad], axis=1)

            if use_beam and n_free > 0:
                lp3 = last_lp[:, None, :]  # beam_idx=-1 over a (B,1,V) view
                token, beam_token, beam_score = _get_beam(lm, lp3, state, id_constraint, window,
                                                          beam_idx=-1)
                post_beam_score = _log_mean(beam_score, log_norm)
                post_beam_synth = np.concatenate([beam_token[:, None], tiled], axis=1)
                win = pre_beam_score > post_beam_score
                score_sofar = np.where(win, pre_beam_score, post_beam_score)
                synth_sofar = np.where(win[:, None], pre_beam_synth, post_beam_synth)
            else:
                token = np.argmax(last_lp, axis=-1)
                score_sofar = pre_beam_score
                synth_sofar = pre_beam_synth

            token = token[:, None].astype(np.int32)
            tokens: List[np.ndarray] = []
            finished_rows = np.ones(b, bool)
            prompt_time += tic()

            cfn = lm.score_fn(b, 1 + lcons, window, advance=1)
            for _ in range(n_free):
                tokens.append(token)
                token_plus = np.concatenate([token, tiled], axis=1)
                lp_c, state = cfn(lm.params, _device_ids(lm, token_plus), state)
                lp_c = lp_c.cpu().numpy()  # (B, 1+L, V)
                cont = lp_c[rows, np.arange(lcons)[None, :], token_plus[:, 1:]]
                pre_beam_score = _log_mean(np.concatenate([running_score, cont], axis=1), log_norm)
                pre_beam_synth = np.concatenate(tokens + [tiled, synth_pad], axis=1)
                if use_beam:
                    token, beam_token, beam_score = _get_beam(lm, lp_c, state, id_constraint, window)
                    post_beam_score = _log_mean(np.concatenate([running_score, beam_score], axis=1),
                                                log_norm)
                    post_beam_synth = np.concatenate(tokens + [beam_token[:, None], tiled], axis=1)
                    win = pre_beam_score > post_beam_score
                    score = np.where(win, pre_beam_score, post_beam_score)
                    synth = np.where(win[:, None], pre_beam_synth, post_beam_synth)
                else:
                    token = np.argmax(lp_c[:, 0, :], axis=-1)
                    score = pre_beam_score
                    synth = pre_beam_synth
                synth_sofar = np.concatenate([synth_sofar, synth_pad], axis=1)
                finished_rows &= _already(np.concatenate(tokens, axis=1), id_constraint)
                rows_to_update = (score > score_sofar) & finished_rows
                synth_sofar = np.where(rows_to_update[:, None], synth, synth_sofar)
                score_sofar = np.where(rows_to_update, score, score_sofar)
                running_score = np.concatenate([running_score, lp_c[np.arange(b), 0, token][:, None]],
                                               axis=1)
                finished_rows &= token != ID_EOS
                if not finished_rows.any():
                    break
                token = token[:, None].astype(np.int32)
        finally:
            release_decoder(lm, entry)
        constrain_time += tic()
        out_rows = np.concatenate([ids, synth_sofar], axis=1).tolist()
        s_len = ids.shape[1]
        trimmed = []
        for row in out_rows:
            if ID_EOS in row[s_len:]:
                row = row[: row.index(ID_EOS, s_len)]
            trimmed.append([t for t in row if t not in (0, 1)])
        output = processor.tokenizer.batch_decode(trimmed)
        output = [_preprocess(s) for s in output]
        prompt = output

    if not return_full_text:
        output = [o[l:] for o, l in zip(output, len_ps)]
    if not mute:
        if was_str:
            print(output[0])
        else:
            for i, o in enumerate(output):
                print(f"\n< Constrained text for prompt #{i} >\n{o}")
    if verbose:
        print(f"Prompt: {prompt_time:.2f} sec\nConstrain: {constrain_time:.2f} sec")
    return output[0] if was_str else output


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))
