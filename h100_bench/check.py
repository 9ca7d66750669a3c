"""Whether the served path answered correctly: the plain reference over a
seeded sample of the requests the window finished.

The sample holds the request with the most served tokens and, for each
slot that served a finished request, one of that slot's drawn from the
seed, so a fault in any one slot's rows shows.  The
reference runs once over each prompt with its served tokens (teacher
forcing); the number compared is the widest gap by which a served token's
logit lies below the reference's best at its position (greedy decoding
serves the program's own argmax, so a sound program reads near zero and a
wrong token reads as the gap it left).  The control puts the reference in
the program's place one precision below the configuration's (float8 e4m3
activations into every linear, scaled per row, for bfloat16) and reads the
same gap for the token the control puts first.
"""

from __future__ import annotations

import torch

from .reference import clip, decoder, image, tokenizer
from .traffic import rng


def sample(done: list, seed: int) -> list:
    """The longest finished request, then one request of each slot (each
    with a ``slot``), drawn from the seed."""
    if not done:
        return []
    order = sorted(done, key=lambda r: (-len(r["tokens"]), r["index"]))
    picked = [order[0]]
    by_slot = {}
    for r in order[1:]:
        by_slot.setdefault(r["slot"], []).append(r)
    g = rng(seed, "sample", 0)
    for slot in sorted(by_slot):
        rs = by_slot[slot]
        picked.append(rs[int(g.integers(len(rs)))])
    return picked


def fp8_rows(t: torch.Tensor) -> torch.Tensor:
    """The control's rounding of a linear's input: float8 e4m3, one scale
    a row."""
    scale = t.abs().amax(-1, keepdim=True).clamp(min=1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _inputs(cfg: dict, params: dict, items: list, device, act) -> list:
    out = []
    vp = params["model"].get("vision_embed_tokens")
    for it in items:
        counts, feats = [], None
        if it.get("pixels") is not None:
            crops, (rows, cols) = image.crops(it["pixels"], cfg["num_crops"], device)
            feats = clip.image_embedding(vp, cfg["vision_config"], crops, rows, cols, act)
            counts = [image.tokens(rows, cols)]
        ids = tokenizer.prompt_ids(it["prompt"], counts)
        seq = torch.tensor(ids + list(it["tokens"][:-1]), device=device)
        x = decoder.embed(params["model"]["embed_tokens"], seq.clamp(min=0))
        if feats is not None:
            x[seq < 0] = feats
        out.append((x, len(ids) - 1))
    return out


@torch.no_grad()
def gaps(cfg: dict, params: dict, items: list, device, control: bool = False) -> dict:
    """``served``: the widest gap of a served token below the reference's
    best, over ``items`` (each ``prompt``, ``tokens``, optional ``pixels``);
    with ``control``, also ``control``: the reference's gap of the token the
    lower-precision reference puts first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = decoder.logits(cfg, params, _inputs(cfg, params, items, device, lambda t: t))
    served = 0.0
    for lg, it in zip(ref, items):
        tok = torch.tensor(it["tokens"], device=device)[:, None]
        served = max(served, float((lg.max(-1).values - lg.gather(1, tok)[:, 0]).max()))
    out = {"served": served}
    if control:
        low = decoder.logits(cfg, params, _inputs(cfg, params, items, device, fp8_rows), fp8_rows)
        out["control"] = max(float((lg.max(-1).values - lg.gather(1, lo.argmax(-1)[:, None])[:, 0]).max())
                             for lg, lo in zip(ref, low))
    return out


def short_answers(done: list, eos: int) -> int:
    """Finished requests that stopped before ``max_tokens`` without an
    end token (the served window is never reached here)."""
    return sum(1 for r in done if len(r["tokens"]) < r["max_tokens"] and eos not in r["tokens"])
