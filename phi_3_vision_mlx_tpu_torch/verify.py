"""The parity runbook — BASELINE configs 1-5 against golden files
(counterpart of ``phi_3_vision_mlx_tpu/verify.py``, with its CLI and its
schema-1 golden files: a golden written by either package is checked by the
other's ``check``, and ``recorded_by`` names the writer).

The gates (BASELINE.json) are token-exact fp32 parity with the MLX
reference, matched quantized perplexity and MedQA accuracy parity.  Usage::

    # record goldens with this package and the weights on disk
    python -m phi_3_vision_mlx_tpu_torch.verify record --golden goldens/ [--configs 1,2,3]

    # run the same configs and diff against recorded goldens
    python -m phi_3_vision_mlx_tpu_torch.verify check --golden goldens/

Everything runs on ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path).  Offline, ``PHI3V_TPU_ALLOW_RANDOM=1`` marks goldens as
recorded from random-weight checkpoints, ``--dataset synthetic`` takes the
synthetic QA rows, and ``check`` against goldens recorded from the same
checkpoints must pass bit for bit.

The configs: (1) fp32 greedy decode of the unquantized text model, 64
tokens, with the top-8 fp32 prefill logits (on the card K2 and K3 in fp32,
TF32 off for every matmul); (2) 8 prompts x 100 tokens over the int4 KV
cache; (3) ``choose``, ``constrain`` and beam answers of the 4-bit model on
QA rows, and its perplexity; (4) an image question on the unquantized
vision model, 32 tokens, with the top-8 logits; (5) a LoRA of rank 16 on 5
layers trained on the QA rows, the adapter's ``choose`` answers, then a
decode over the int4 cache at a ``--long-window`` window (its prompt sized
in tokens).  Token lists, answers and accuracies compare exactly,
``top_logits`` values to ``RTOL_LOGITS``, perplexity and losses to
``RTOL_PPL``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

TOPK = 8
RTOL_LOGITS = 2e-3
RTOL_PPL = 2e-2

CFG_NAMES = {
    1: "cfg1_fp32_greedy_blind",
    2: "cfg2_batch_quantized_cache",
    3: "cfg3_quantized_constrain_choose",
    4: "cfg4_vision_vqa",
    5: "cfg5_lora_long_context",
}

_PROMPT_CFG1 = "Write a mystery horror."
_PROMPTS_CFG2 = [
    "Explain quantum computing.",
    "Write a poem about the first snowfall of the year.",
    "Describe the water cycle.",
    "Summarize the major events of the French Revolution.",
    "Write a resume.",
    "Explain the concept of dark matter.",
    "Compose a limerick about a clumsy robot.",
    "Describe a bustling alien marketplace.",
]
_PPL_TEXT = (
    "The lighthouse keeper climbed the spiral staircase at dusk, pausing at "
    "the lamp room to wind the clockwork that turned the great lens. Below, "
    "the sea threw itself against the rocks as it had for a hundred years."
)
_CHUNK = 32  # decode steps between host fetches, as in the JAX runbook


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _greedy_tokens(lm, proc, prompt, max_tokens: int, images=None):
    """Greedy token ids per row + top-k fp32 prefill logits (the token-exact
    parity payload): the bucketed prefill, then the decode steps (a CUDA
    graph replay each on the card), replayed through the EOS stopper."""
    import torch

    from .engine.engine import Decoder, run_prefill
    from .engine.stream import TokenStopper

    dict_input = proc(prompt, images)
    b = int(np.asarray(dict_input["input_ids"]).shape[0])
    logits, state, _, _ = run_prefill(lm, dict_input, max_tokens)
    last = logits.float().cpu().numpy()  # (B, V)
    order = np.argsort(-last[0])[:TOPK]
    top = {"ids": [int(i) for i in order],
           "vals": [float(last[0, i]) for i in order]}
    token = np.argmax(last, axis=-1).astype(np.int32)[:, None]
    rows = [[int(token[r, 0])] for r in range(b)]
    stopper = TokenStopper(b, lm.eos_id)
    stopper.update(token[:, 0])
    dec = Decoder(lm, state)
    dec.start(state, torch.as_tensor(token, dtype=torch.long, device=lm.device))
    n = 1
    while n < max_tokens:
        n_steps = min(_CHUNK, max_tokens - n)
        toks = dec.chunk(n_steps)[0].cpu().numpy()  # (n_steps, B)
        done = False
        for i in range(n_steps):
            for r in range(b):
                rows[r].append(int(toks[i, r]))
            n += 1
            if stopper.update(toks[i]) or n >= max_tokens:
                done = True
                break
        if done:
            break
    eos = lm.eos_id
    rows = [r[: r.index(eos)] if eos in r else r for r in rows]
    return rows, top


def _perplexity(lm, proc, text: str) -> float:
    """exp(mean next-token CE) of ``text`` under the loaded model (fp32
    log-softmax over a cache-free pass) — the matched-quantized-perplexity
    gate's measurement."""
    import torch

    from .models import phi3

    ids = np.asarray(proc(text)["input_ids"])
    with torch.no_grad():
        logits = phi3.forward_nocache(lm.params, lm.cfg,
                                      torch.as_tensor(ids, dtype=torch.long, device=lm.device))
        lp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
    nll = -lp[0, np.arange(ids.shape[1] - 1), ids[0, 1:]]
    return float(np.exp(nll.mean()))


def _chat(p: str) -> str:
    from .api import CHAT_TURN

    return CHAT_TURN.format(body=p.strip())


def _qa_rows(dataset_path, take: int):
    from .train.data import load_qa_dataset

    return load_qa_dataset(dataset_path, take)


def _question_prompts(rows, suffix: str = "") -> List[str]:
    return [_chat(r["input"].rstrip() + suffix) for r in rows]


def _answers_key(rows) -> List[str]:
    return [str(r["output"]).strip()[:1] for r in rows]


def _accuracy(attempts: List[str], key: List[str]) -> float:
    hits = sum(a.strip()[:1] == k for a, k in zip(attempts, key))
    return round(hits / max(len(key), 1), 4)


def _long_prompt(proc, long_window: int):
    """(prompt, its token count) for cfg5's long window: ``long_window -
    192`` tokens, sized in tokens by tokenizing a growing, then trimmed
    string (a real SentencePiece tokenizer compresses the filler ~8:1, so a
    character-sized prompt would exercise a far smaller window)."""
    filler = "The lighthouse keeper wrote: " + "x" * 50
    target = long_window - 192
    long_prompt = filler * (target // 20)
    n_tok = len(proc(long_prompt)["input_ids"][0])
    while n_tok < target:
        long_prompt += filler * max((target - n_tok) // 10, 1)
        n_tok = len(proc(long_prompt)["input_ids"][0])
    while n_tok > target:  # trim by characters, re-measure
        excess = n_tok - target
        long_prompt = long_prompt[: -max(excess, 1)]
        n_tok = len(proc(long_prompt)["input_ids"][0])
    return long_prompt, n_tok


# ---------------------------------------------------------------------------
# Config runners — each returns the golden payload for its config
# ---------------------------------------------------------------------------


def run_cfg1(args) -> dict:
    """fp32 greedy blind decode, 64 tokens, token-exact (BASELINE config 1).
    On the card every fp32 matmul runs in full fp32 (no TF32: it keeps
    about three decimal digits)."""
    import torch

    from .api import PATH_ORIGINAL_PHI3_BLIND, _load

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # The checkpoint config's own key: the JAX runbook passes dtype="float32",
    # which its config reader ignores, so it decodes in the checkpoint's dtype.
    lm, proc = _load(args.blind_path or PATH_ORIGINAL_PHI3_BLIND, jax_dtype="float32", device=args.device)
    prompt = _chat(_PROMPT_CFG1)
    tokens, top = _greedy_tokens(lm, proc, prompt, 64)
    return {"cases": [{"prompt": prompt, "max_tokens": 64, "tokens": tokens,
                       "top_logits": top}]}


def run_cfg2(args) -> dict:
    """8 prompts x 100 tokens, quantized KV cache (BASELINE config 2)."""
    from .api import PATH_ORIGINAL_PHI3_BLIND, _load

    lm, proc = _load(args.blind_path or PATH_ORIGINAL_PHI3_BLIND, use_quantized_cache=True,
                     device=args.device)
    prompts = [_chat(p) for p in _PROMPTS_CFG2]
    tokens, _ = _greedy_tokens(lm, proc, prompts, 100)
    return {"cases": [{"prompt": prompts, "max_tokens": 100, "tokens": tokens}]}


def run_cfg3(args) -> dict:
    """4-bit model: choose / constrain / beam answers on QA rows + quantized
    perplexity (BASELINE config 3 + the matched-perplexity gate)."""
    from .api import PATH_QUANTIZED_PHI3_BLIND, _load
    from .engine.constrain import choose_from, constrain_decode

    lm, proc = _load(args.quant_path or PATH_QUANTIZED_PHI3_BLIND, device=args.device)
    rows = _qa_rows(args.dataset, args.take)
    key = _answers_key(rows)
    chosen = list(choose_from(
        lm, proc, _question_prompts(rows, "\nThe correct answer is"),
        "ABCDE", mute=True,
    ))
    constraints = [(0, "\nThe"), (100, " The correct answer is"), "ABCDE"]
    greedy = constrain_decode(lm, proc, _question_prompts(rows),
                              constraints=constraints, verbose=False, mute=True)
    beamed = constrain_decode(lm, proc, _question_prompts(rows),
                              constraints=constraints, verbose=False, mute=True,
                              use_beam=True)
    pick = lambda outs: [o.rsplit("The correct answer is ", 1)[-1][:1] for o in outs]  # noqa: E731
    ppl = _perplexity(lm, proc, _PPL_TEXT)
    return {
        "cases": [{
            "n_rows": len(rows),
            "chosen": chosen,
            "constrained": pick(greedy),
            "beamed": pick(beamed),
        }],
        "scores": {
            "choose_acc": _accuracy(chosen, key),
            "constrain_acc": _accuracy(pick(greedy), key),
            "beam_acc": _accuracy(pick(beamed), key),
            "quantized_ppl": round(ppl, 4),
        },
    }


def run_cfg4(args) -> dict:
    """Single-image VQA: the deterministic local image, greedy 32 tokens
    (BASELINE config 4)."""
    from .api import PATH_ORIGINAL_PHI3_VISION, _image_tags, _load
    from .bench import _local_test_image
    from .utils.media import fetch_image

    lm, proc = _load(args.vision_path or PATH_ORIGINAL_PHI3_VISION, device=args.device)
    img = fetch_image(_local_test_image())
    prompt = _chat(_image_tags(1) + "What is shown in this image?")
    tokens, top = _greedy_tokens(lm, proc, prompt, 32, images=[img])
    return {"cases": [{"prompt": prompt, "max_tokens": 32, "tokens": tokens,
                       "top_logits": top}]}


def run_cfg5(args) -> dict:
    """Rank-16 / 5-layer LoRA on the QA set, then adapter-loaded choose
    accuracy + a long-window quantized-cache decode (BASELINE config 5).
    The long window defaults to 2048; ``--long-window 32768`` is the real
    gate."""
    from .api import PATH_QUANTIZED_PHI3_BLIND, _load
    from .engine.constrain import choose_from
    from .engine.engine import LM
    from .train.trainer import train_lora

    model_path = args.quant_path or PATH_QUANTIZED_PHI3_BLIND
    adapter_path = os.path.join(args.golden, "cfg5_adapter")
    train_lora(
        model_path=model_path, adapter_path=adapter_path,
        lora_rank=args.lora_rank, lora_layers=args.lora_layers,
        take=args.take, dataset_path=args.dataset, seed=0, device=args.device,
    )
    with open(os.path.join(adapter_path, "adapter_train_log.json")) as f:
        losses = json.load(f)["step_loss"]
    lm, proc = _load(model_path, adapter_path=adapter_path, device=args.device)
    rows = _qa_rows(args.dataset, args.take)
    chosen = list(choose_from(
        lm, proc, _question_prompts(rows, "\nThe correct answer is"),
        "ABCDE", mute=True,
    ))
    # Long context: the prompt padded into a long window, quantized cache.
    lm_q = LM(lm.cfg.replace(use_quantized_cache=True), lm.params, device=lm.device)
    long_prompt, n_tok = _long_prompt(proc, args.long_window)
    tokens, _ = _greedy_tokens(lm_q, proc, long_prompt, 32)
    return {
        "cases": [{
            "chosen": chosen,
            "long_window": args.long_window,
            "long_prompt_tokens": n_tok,
            "long_tokens": tokens,
        }],
        "scores": {
            "choose_acc_after_lora": _accuracy(chosen, _answers_key(rows)),
            "first_loss": round(float(losses[0]), 4) if losses else None,
            "last_loss": round(float(losses[-1]), 4) if losses else None,
        },
    }


RUNNERS = {1: run_cfg1, 2: run_cfg2, 3: run_cfg3, 4: run_cfg4, 5: run_cfg5}


# ---------------------------------------------------------------------------
# Diffing
# ---------------------------------------------------------------------------


def _diff(config: str, golden: dict, fresh: dict) -> List[str]:
    """Compare a fresh run against a golden payload; returns failures."""
    fails: List[str] = []
    for i, (g, f) in enumerate(zip(golden["cases"], fresh["cases"])):
        for field in ("tokens", "chosen", "constrained", "beamed", "long_tokens"):
            if field in g and g[field] != f.get(field):
                fails.append(f"{config} case{i}: {field} mismatch "
                             f"(golden {str(g[field])[:80]}... vs "
                             f"{str(f.get(field))[:80]}...)")
        if "top_logits" in g:
            gl, fl = g["top_logits"], f.get("top_logits", {})
            if gl["ids"] != fl.get("ids"):
                fails.append(f"{config} case{i}: top-logit ids mismatch")
            elif not np.allclose(gl["vals"], fl["vals"], rtol=RTOL_LOGITS):
                fails.append(f"{config} case{i}: top-logit values drift "
                             f"> rtol {RTOL_LOGITS}")
    gs, fs = golden.get("scores", {}), fresh.get("scores", {})
    for k, v in gs.items():
        fv = fs.get(k)
        if v is None or fv is None:
            continue
        tol = RTOL_PPL if "ppl" in k or "loss" in k else 0.0
        if tol:
            if not np.isclose(v, fv, rtol=tol):
                fails.append(f"{config}: {k} {fv} vs golden {v} (rtol {tol})")
        elif v != fv:
            fails.append(f"{config}: {k} {fv} vs golden {v}")
    return fails


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="phi_3_vision_mlx_tpu_torch.verify")
    ap.add_argument("mode", choices=["record", "check"])
    ap.add_argument("--golden", default="goldens")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--dataset", default="JosefAlbers/akemiH_MedQA_Reason",
                    help="'synthetic' for the offline fixture")
    ap.add_argument("--take", type=int, default=10)
    ap.add_argument("--long-window", type=int, default=2048)
    ap.add_argument("--lora-rank", type=int, default=16)
    ap.add_argument("--lora-layers", type=int, default=5)
    ap.add_argument("--blind-path", default=None)
    ap.add_argument("--quant-path", default=None)
    ap.add_argument("--vision-path", default=None)
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    os.makedirs(args.golden, exist_ok=True)
    configs = [int(c) for c in args.configs.split(",") if c]
    weights = ("random" if os.environ.get("PHI3V_TPU_ALLOW_RANDOM") == "1"
               else "real")
    failures: List[str] = []
    for n in configs:
        name = CFG_NAMES[n]
        path = os.path.join(args.golden, f"{name}.json")
        payload = RUNNERS[n](args)
        payload.update({"schema": 1, "config": name, "weights": weights,
                        "recorded_by": "phi_3_vision_mlx_tpu_torch"})
        if args.mode == "record":
            with open(path, "w") as f:
                json.dump(payload, f, indent=2)
            print(f"recorded {path}")
        else:
            if not os.path.exists(path):
                failures.append(f"{name}: no golden at {path}")
                continue
            with open(path) as f:
                golden = json.load(f)
            fails = _diff(name, golden, payload)
            status = "PASS" if not fails else "FAIL"
            print(f"{name}: {status}")
            failures += fails
    for f in failures:
        print(f"  {f}")
    if args.mode == "check":
        print(f"verify: {'PASS' if not failures else 'FAIL'} "
              f"({len(configs)} configs, {len(failures)} failures)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
