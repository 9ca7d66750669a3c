"""Prompt-lookup speculative decoding (counterpart of
``phi_3_vision_mlx_tpu/engine/speculative.py``).

A decode step reads every weight once for one token.  A verify pass reads
them once for K + 1 query rows: the pending token and K drafts, proposed by
a 3 -> 2 -> 1-gram lookup over the committed window's token history (no
draft model).  Greedy acceptance is argmax-match, so the emitted stream is
the vanilla greedy stream; sampled decoding verifies by rejection sampling,
so each emitted token is distributed as a vanilla draw from the filtered
target.  A pass emits 1..K + 1 tokens.

The JAX engine scans passes inside one compiled chunk and skips a pass with
``lax.cond`` once the budget or the window is used up.  A CUDA graph has no
branch: a replayed pass always runs its forward.  So a pass here is
branch-free (:class:`SpecPass`): it computes ``live`` on the device, and a
pass that is not live commits nothing (``n_emit`` 0, the offset unmoved)
and writes only uncommitted columns, clamped into the window
(:func:`verify_columns`).  Such a dead pass costs a whole forward, so the
host sizes each chunk's passes from the budget left (:meth:`SpecPass.
passes_for`): no more than the budget can take at K + 1 tokens a pass.
The pass advances the device offset by its device ``n_emit``; the host's
mirror follows at the chunk's fetch.  Its attention takes the
decode route (K3/K4) at L = K + 1; those kernels take at most 16 query rows
a launch, so a pass of more rows runs as launches on groups of 16, each
with its ``row0`` (``ops/kernels/kv_attention.py:by_row_groups``), and K
takes the JAX engines' range [0, 32] on every device (:func:`check_spec_k`).

The sampling functions take their noise as arguments (uniforms for the
acceptance tests, Gumbel noise for the categorical draws:
``engine/rng.py``), so the tests hand them the JAX package's draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import phi3
from .engine import filter_sample_logits, filter_sample_logits_rows
from .graphs import StepGraph, StepRing
from .rng import ACCEPT, BONUS, RESAMPLE, VANILLA, to_device

MAX_SPEC_K = 32  # the JAX engines' range of K


def check_spec_k(k: int) -> None:
    """K in [0, MAX_SPEC_K], the JAX engines' range, on every device and
    path: the decode kernels (K3/K4 single-stream, K6/K7 paged) take the
    K + 1 rows in groups of 16."""
    if not 0 <= k <= MAX_SPEC_K:
        raise ValueError(f"spec_k must be in [0, {MAX_SPEC_K}], got {k}")


def propose_drafts(buf, valid, tok, off, k_draft: int):
    """N-gram continuation lookup over the committed window (JAX
    ``propose_drafts``).

    buf (B, W) int64 token history (column p holds the token whose k/v sit
    at cache column p); valid (B, W) bool; tok (B, 1) the pending token;
    off (B,) or (1,) committed offsets.  Finds the most recent position j
    whose trailing 3-gram, else 2-gram, else 1-gram matches the sequence
    ending at ``tok`` and returns the K tokens that followed it, clamped to
    the committed region; negative ids (a vision prompt's image
    placeholders) become 0.  No match is fine: the drafts are then
    rejected."""
    b, w = buf.shape
    idx = torch.arange(w, device=buf.device)
    off = off.long().reshape(-1).expand(b)
    committed = valid & (idx[None] <= off[:, None] - 2)  # j leaves a committed follower
    rows = torch.arange(b, device=buf.device)
    prev1 = buf[rows, (off - 1).clamp(min=0)]
    prev2 = buf[rows, (off - 2).clamp(min=0)]
    m1 = (buf == tok[:, :1]) & committed
    m2 = m1 & (torch.roll(buf, 1, 1) == prev1[:, None]) & (idx[None] >= 1)
    m3 = m2 & (torch.roll(buf, 2, 1) == prev2[:, None]) & (idx[None] >= 2)
    has3, has2, has1 = m3.any(dim=1), m2.any(dim=1), m1.any(dim=1)
    j3, j2, j1 = (torch.where(m, idx[None], -1).amax(dim=1) for m in (m3, m2, m1))
    j = torch.where(has3, j3, torch.where(has2, j2, j1))
    base = torch.where(has3 | has2 | has1, j + 1, 0)
    pos = base[:, None] + torch.arange(k_draft, device=buf.device)[None]
    pos = torch.minimum(pos.clamp(min=0), (off - 1).clamp(min=0)[:, None])
    return buf.gather(1, pos).clamp(min=0)


def _rejection(f, draft, noise):
    """Rejection-sampled verification of filtered logits ``f`` (B, K + 1,
    V) against ``draft`` (B, K) with ``noise`` = (uniforms (B, K), Gumbel
    (B, K, V) for the residual draws, Gumbel (B, V) for the bonus draw):
    draft t is accepted with probability p_t(d_t); at the first rejection
    the token is drawn from p_t with d_t removed; with all accepted, the
    bonus token from p_K.  Returns (out (B, K + 1), accepted (B,))."""
    u, g_res, g_bonus = noise
    k = draft.shape[1]
    probs = torch.softmax(f, dim=-1)
    p_draft = probs[:, :k].gather(-1, draft[..., None])[..., 0]
    acc = torch.cumprod((u < p_draft).long(), dim=1).sum(dim=1)
    residual = f[:, :k].scatter(-1, draft[..., None], float("-inf"))
    resample = (residual + g_res).argmax(dim=-1)
    bonus = (f[:, k] + g_bonus).argmax(dim=-1)
    taken = torch.arange(k, device=draft.device)[None] < acc[:, None]
    return torch.cat([torch.where(taken, draft, resample), bonus[:, None]], dim=1), acc


def verify_sampled(logits, draft, noise, temperature: float, top_p: float, top_k: int = 0,
                   min_p: float = 0.0):
    """JAX ``verify_sampled`` with static knobs: logits (B, K + 1, V) f32,
    draft (B, K); ``noise`` as :func:`_rejection` takes it.  Returns (out
    (B, K + 1), n_emit (B,)): out[:, t] = draft[:, t] for t < accepted, then
    the resampled or bonus token."""
    out, acc = _rejection(filter_sample_logits(logits, temperature, top_p, top_k, min_p),
                          draft, noise)
    return out, acc + 1


def greedy_verify(logits, draft):
    """Argmax-match acceptance: (out (B, K + 1) the argmax rows, accepted
    drafts (B,))."""
    out = logits.argmax(dim=-1)
    return out, torch.cumprod((draft == out[:, :-1]).long(), dim=1).sum(dim=1)


def verify_mixed_rows(logits, draft, noise, temps, top_ps, top_ks, min_ps):
    """Per-row verification for the slot engines (JAX
    ``verify_mixed_rows``): rows with ``temps <= 0`` argmax-match, the
    others rejection-sample against their own filtered target.  Returns
    (out (S, K + 1), accepted (S,))."""
    out_g, acc_g = greedy_verify(logits, draft)
    out_s, acc_s = _rejection(filter_sample_logits_rows(logits, temps, top_ps, top_ks, min_ps),
                              draft, noise)
    sampled = temps > 0
    return torch.where(sampled[:, None], out_s, out_g), torch.where(sampled, acc_s, acc_g)


def verify_noise(gen, k: int, vocab: int):
    """One pass's noise from ``gen`` (``engine/rng.py``), as the JAX pass
    splits its key: uniforms (R, K), Gumbel (R, K, V) and (R, V)."""
    return (gen.uniform(ACCEPT, (k,)), gen.gumbel(RESAMPLE, (k, vocab)),
            gen.gumbel(BONUS, (vocab,)))


def init_token_buffer(ids_padded, window: int) -> torch.Tensor:
    """(B, l_pad) padded prompt ids -> (B, window) int64 history."""
    ids = torch.as_tensor(np.asarray(ids_padded), dtype=torch.long)
    return torch.cat([ids, ids.new_zeros((ids.shape[0], window - ids.shape[1]))], dim=1)


def verify_columns(off, width: int, w: int):
    """A pass's columns for offsets ``off`` (B,) int64 in a window of ``w``:
    (wpos (B, width) the unclamped positions ``off + i``, cols (B, width)
    clamped into the window, src (B, width) the pass row each column's
    value comes from).  Past the window every entry names the last column
    with the value of the entry that lands there, so writes through
    duplicate columns agree (``off`` = ``w``, a full window, writes row 0
    there; such a request has emitted its last token)."""
    wpos = off[:, None] + torch.arange(width, device=off.device)[None]
    cols = wpos.clamp(max=w - 1)
    return wpos, cols, (cols - off[:, None]).clamp(min=0)


class SpecPass:
    """A single-stream verify pass of K drafts over a :class:`~.engine.
    Decoder`'s state and token, greedy or sampled (the decoder's mode when
    made), through its own :class:`~.graphs.StepGraph` (JAX
    ``spec_chunk_fn``'s scan body).  Static tensors: the token history
    ``hist`` (B, W), the budget ``left`` (1,), ``accept`` (1,) bool (False:
    every pass commits its first token only, the forced-reject baseline of
    the same graph), and a ring of (K + 1)-wide rows with ``n_emit``."""

    def __init__(self, dec, k_draft: int):
        self.dec, self.k = dec, k_draft
        self.sampled = dec.sampling
        st, dev = dec.state, dec.token.device
        b = dec.token.shape[0]
        self.hist = torch.zeros((b, st.window), dtype=torch.long, device=dev)
        self.left = torch.zeros((1,), dtype=torch.long, device=dev)
        self.accept = torch.ones((1,), dtype=torch.bool, device=dev)
        self.ring = StepRing(dec.ring.toks.shape[0], b, dev, width=k_draft + 1)
        save = (st.pos, dec.token, self.hist, self.left, self.ring.index)
        if self.sampled:
            save += (dec.knobs.gen.counters,)
        self.graph = StepGraph(self._pass, dev, dec.lm.graphs, save=save)

    def start(self, ids_padded, accept: bool = True) -> None:
        """Seed the history with the request's padded prompt ids (its
        prefill's columns) and set the acceptance mode."""
        self.hist.copy_(to_device(init_token_buffer(ids_padded, self.hist.shape[1]), self.hist.device))
        self.accept.fill_(accept)

    @torch.no_grad()
    def _pass(self) -> None:
        dec, k = self.dec, self.k
        lm, st = dec.lm, dec.state
        off = st.pos.long()
        live = (self.left > 0) & (off + k + 1 <= st.window)  # (1,)
        draft = propose_drafts(self.hist, st.valid, dec.token, off, k)
        ids = torch.cat([dec.token, draft], dim=1)  # (B, K + 1)
        _, cols, src = verify_columns(off.expand(ids.shape[0]), k + 1, st.window)
        self.hist.scatter_(1, cols, ids.gather(1, src))
        res = phi3.decode_forward(lm.params, lm.cfg, st, ids, advance=0, positions=cols[0])
        logits = res.logits.float()  # (B, K + 1, V)
        if self.sampled:
            knobs = dec.knobs
            f = knobs.filtered(logits)
            out, acc = _rejection(f, draft, verify_noise(knobs.gen, k, logits.shape[-1]))
            # A forced-reject pass draws its token as a vanilla step does.
            vanilla = (f[:, 0] + knobs.gen.gumbel(VANILLA, logits.shape[-1:])).argmax(dim=-1)
            out[:, 0] = torch.where(self.accept, out[:, 0], vanilla)
            knobs.gen.advance()
        else:
            out, acc = greedy_verify(logits, draft)
        acc = torch.where(self.accept, acc, 0)
        n_emit = torch.where(live, acc + 1, 0)
        dec.token.copy_(torch.where(live[:, None], out.gather(1, acc[:, None]), dec.token))
        st.pos.add_(n_emit.to(st.pos.dtype))
        self.left.sub_(n_emit)
        self.ring.write_pass(logits, lm.eos_id, out, n_emit)

    def passes_for(self, left: int, most: int) -> int:
        """Passes for a chunk with ``left`` tokens of budget: as many as
        cannot overshoot it (a pass emits at most K + 1), at most ``most``
        and no more than the window holds at one token a pass.  A pass past
        the budget or the window would be dead, a wasted forward; one more
        chunk costs a fetch."""
        st = self.dec.state
        room = st.window - st.offset - self.k
        return max(1, min(most, room, -(-left // (self.k + 1))))

    @torch.no_grad()
    def chunk(self, n_passes: int, left: int):
        """``n_passes`` passes with ``left`` tokens of budget on the device.
        Returns device views (n, B, K + 1) of tokens, max and EOS log-probs
        and (n, B) committed counts; the host's mirror of the offset moves
        by their sum (``Decoder.advance_mirror``)."""
        self.left.fill_(left)
        self.ring.start(n_passes)
        for _ in range(n_passes):
            self.graph()
        return self.ring.rows(n_passes)
