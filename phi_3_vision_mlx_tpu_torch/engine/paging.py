"""Paged KV cache for continuous batching (counterpart of
``phi_3_vision_mlx_tpu/engine/paging.py``).

One shared page pool plus a per-slot page table: pages are handed out on
demand (the prompt's pages at admission, then one at a time as decode
crosses page boundaries) and return to the free list when a request
finishes, so the pool size, not ``slots x window``, sets the cache memory.
Pool saturation preempts the youngest request, which resumes later by
recomputing its prefill.  That recompute is text only, so an image request
is never preempted: the youngest text request is, and with only image
requests left the youngest of them fails (JAX ``paging.py:935``).

Layouts (the token-major layouts of ``engine/state.py`` with pages in place
of the batch and window axes; page ``P`` is a spare):

* dense: ``k``, ``v`` ``(layers, P + 1, KV, page, D)`` in the compute dtype;
* int4: ``k`` ``(layers, P + 1, KV, page, D)`` uint8 ``k | v << 4``, ``v``
  None, ``k_scales`` ``(layers, P + 1, KV, page, 4G)`` bf16;
* int8: as int4 with ``2D`` payload bytes.

The page table ``(slots, window // page)`` int32 holds ``P`` where no page
is allocated.  The JAX package drops writes through that sentinel
(``mode="drop"``); torch indexing raises on an out-of-range index instead,
so here the sentinel names the spare page: inactive slots write into it,
with no host-side mask and no device sync, and nothing visible ever reads
it (keys past a slot's offset are masked).

Each decode step routes attention by cache (``batching.SlotStep``'s
``attention`` hook): dense -> kernel K6 (``paged_kv_attention``), int4 ->
K7 (``paged_quantized_kv_attention``), int8 -> the layer's pool dequantized
(plain, as ``read_kv`` does), then K6 on it.  On the CPU the wrappers run
their plain versions.  Sampling and speculation are the slot engine's
(``engine/batching.py``).  A verify pass writes K + 1 columns a slot
through the page tables and runs K6/K7 at Lq = K + 1, their fresh-region
rule showing each query the pass's own columns up to it; the host maps
every page a worst-case chunk can touch first (n passes x (K + 1) columns
a slot, JAX ``paging.py:893``).  K6/K7 take at most 16 query rows, so on
the card ``spec_k`` is at most 15.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.weights import torch_dtype
from ..ops.kernels.kv_attention import paged_kv_attention, paged_quantized_kv_attention
from .batching import BatchEngine, SlotState, _Prepared, adopt_row, slot_fields, to_device
from .engine import round_up, run_prefill
from .state import alloc_cache, dequantize_kv, quantize_chunk


@dataclasses.dataclass
class PagedState(SlotState):
    """:class:`~.batching.SlotState` with the pool in place of the per-slot
    windows (module docstring) and ``page_tables`` (S, W // page) int32."""

    page_tables: Optional[torch.Tensor] = None


def _init_paged(cfg, slots: int, window: int, page: int, pool_pages: int, device) -> PagedState:
    lead = (cfg.num_hidden_layers, pool_pages + 1, cfg.num_key_value_heads, page)
    return PagedState(
        **alloc_cache(cfg, lead, torch_dtype(cfg.dtype), device),
        **slot_fields(cfg, slots, window, device),
        page_tables=torch.full((slots, window // page), pool_pages, dtype=torch.int32,
                               device=device),
    )


def write_fresh(st: PagedState, layer: int, pid, row, k, v) -> None:
    """Write fresh k/v (S, KV, L, D) of ``layer`` at page ``pid``, row
    ``row``: (S,) for a decode step's column (L = 1), (S, L) for a verify
    pass's columns (quantized first for a quantized pool)."""
    if pid.dim() == 1:
        if st.quantized:
            payload, scales = quantize_chunk(k, v, st.kv_quant)
            st.k[layer, pid, :, row] = payload[:, :, 0]
            st.k_scales[layer, pid, :, row] = scales[:, :, 0]
        else:
            st.k[layer, pid, :, row] = k[:, :, 0].to(st.k.dtype)
            st.v[layer, pid, :, row] = v[:, :, 0].to(st.v.dtype)
        return
    if st.quantized:
        payload, scales = quantize_chunk(k, v, st.kv_quant)
        st.k[layer, pid, :, row] = payload.transpose(1, 2)
        st.k_scales[layer, pid, :, row] = scales.transpose(1, 2)
    else:
        st.k[layer, pid, :, row] = k.transpose(1, 2).to(st.k.dtype)
        st.v[layer, pid, :, row] = v.transpose(1, 2).to(st.v.dtype)


def _paged_read(st: PagedState, i: int, q, scale: float):
    """Attention of ``q`` (S, H, Lq, D) over layer ``i`` of the pool (the
    cache's kernel, module docstring)."""
    tables, valid, offsets = st.page_tables, st.valid, st.offsets
    if not st.quantized:
        return paged_kv_attention(q, st.k, st.v, tables, valid, offsets, i, scale)
    if st.kv_quant.bits == 4:
        return paged_quantized_kv_attention(q, st.k, st.k_scales, tables, valid, offsets, i, scale)
    kl, vl = dequantize_kv(st.k[i], st.k_scales[i], q.dtype, st.kv_quant.bits)
    return paged_kv_attention(q, kl[None], vl[None], tables, valid, offsets, 0, scale)


def _paged_attention(st: PagedState, active: torch.Tensor):
    """One step's ``attend(i, q, k, v)`` over the pool: write each slot's
    fresh k/v at page ``tables[s, offset // page]``, row ``offset % page``
    (the spare page for inactive slots and offsets past the window), then
    attend through the page tables."""
    w = st.valid.shape[1]
    spare, page = st.k.shape[1] - 1, st.k.shape[3]
    off = st.offsets.long()
    idx = (off // page).clamp(max=st.page_tables.shape[1] - 1)
    table_pid = st.page_tables.gather(1, idx[:, None])[:, 0].long()
    pid = torch.where(active & (off < w), table_pid, spare)
    row = off % page

    def attend(i, q, k, v):
        write_fresh(st, i, pid, row, k, v)
        return _paged_read(st, i, q, q.shape[-1] ** -0.5)

    return attend


def _paged_spec_attention(st: PagedState, active, wpos, cols, src):
    """A verify pass's ``attend`` over the pool: the K + 1 columns ``wpos``
    (S, K + 1) of each active slot go through its page table (the spare
    page past the window and for inactive slots), then K6/K7 at Lq = K + 1
    (JAX ``_paged_spec_decode_chunk``)."""
    w = st.valid.shape[1]
    spare, page = st.k.shape[1] - 1, st.k.shape[3]
    idx = (wpos // page).clamp(max=st.page_tables.shape[1] - 1)
    pid = torch.where(active[:, None] & (wpos < w), st.page_tables.gather(1, idx).long(), spare)
    row = wpos % page

    def attend(i, q, k, v):
        write_fresh(st, i, pid, row, k, v)
        return _paged_read(st, i, q, q.shape[-1] ** -0.5)

    return attend


def _paged_adopt(st: PagedState, slot: int, p: _Prepared, page_ids: List[int],
                 table_row: np.ndarray) -> None:
    """Scatter a prefilled request's ``l_pad`` cache columns into its pages
    and install the slot's table row.  When the page does not divide
    ``l_pad`` (pages above the 64-token prompt bucket) the last page's
    unused rows are written as zeros; the validity bits mask them."""
    src, r, l_pad = p.src_state, p.src_row, p.l_pad
    page = st.k.shape[3]
    n_pages = len(page_ids)
    ids = to_device(np.asarray(page_ids, np.int64), st.k.device)

    def pages_of(cols):  # (layers, KV, l_pad, X) -> (layers, n_pages, KV, page, X)
        nl, kvh, _, x = cols.shape
        if n_pages * page > l_pad:
            cols = torch.cat([cols, cols.new_zeros((nl, kvh, n_pages * page - l_pad, x))], dim=2)
        return cols.reshape(nl, kvh, n_pages, page, x).transpose(1, 2)

    st.k[:, ids] = pages_of(src.k[:, r, :, :l_pad]).to(st.k.dtype)
    if st.quantized:
        st.k_scales[:, ids] = pages_of(src.k_scales[:, r, :, :l_pad])
    else:
        st.v[:, ids] = pages_of(src.v[:, r, :, :l_pad]).to(st.v.dtype)
    st.page_tables[slot] = to_device(table_row, st.k.device)
    adopt_row(st, slot, p)


class PagedBatchEngine(BatchEngine):
    """Continuous batching over a shared page pool.

    ``pool_pages`` bounds the cache memory; the default gives every slot its
    whole window.  Pool saturation preempts the youngest request (its pages
    are released) and resumes it by recompute when pages free up.
    """

    spec_kernel_rows = True  # K6/K7 take at most 16 query rows

    def __init__(self, lm, processor, slots: int = 4, window: int = 1024, page_size: int = 64,
                 pool_pages: int = 0, pipeline_depth: int = 1, spec_k: int = 0,
                 spec_accept: bool = True, seed: int = 0):
        if 64 % page_size and page_size % 64:
            raise ValueError("page_size must divide or be a multiple of 64")
        if window % page_size:
            raise ValueError("window must be a multiple of page_size")
        self.page_size = page_size
        self.pool_pages = pool_pages or slots * (window // page_size)
        self._free_pages: List[int] = list(range(self.pool_pages))
        self._slot_pages: Dict[int, List[int]] = {}
        self.preempted: List[int] = []  # rids awaiting a recompute resume
        self.preemptions = 0  # evictions so far
        # A scheduler that resumes outside its lock sets this False.
        self.resume_in_step = True
        super().__init__(lm, processor, slots=slots, window=window,
                         pipeline_depth=pipeline_depth, spec_k=spec_k, spec_accept=spec_accept,
                         seed=seed)

    def _init_state(self):
        return _init_paged(self.lm.cfg, self.slots, self.window, self.page_size,
                           self.pool_pages, self.lm.device)

    def _attention(self):
        return _paged_attention

    def _spec_attention(self):
        return _paged_spec_attention

    def _reset_state(self) -> None:
        super()._reset_state()
        self.state.page_tables.fill_(self.pool_pages)

    # -- page accounting ----------------------------------------------------

    def _alloc_pages(self, n: int) -> List[int]:
        if len(self._free_pages) < n:
            raise RuntimeError(f"page pool exhausted (need {n}, free {len(self._free_pages)})")
        return [self._free_pages.pop() for _ in range(n)]

    def _release_slot(self, slot: int) -> None:
        self._free_pages.extend(self._slot_pages.pop(slot, []))

    # -- admission ----------------------------------------------------------

    def can_admit(self, prepared: _Prepared) -> bool:
        n_pages = -(-prepared.l_pad // self.page_size)
        if n_pages > self.pool_pages:
            # No amount of waiting frees more than the whole pool: a
            # scheduler looping on can_admit would hang its caller.
            raise ValueError(f"prompt needs {n_pages} pages; the pool has only "
                             f"{self.pool_pages} (pool_pages)")
        # Preempted requests resume first, or new admissions starve them.
        return bool(self.free) and not self.preempted and n_pages <= len(self._free_pages)

    def _adopt_prepared(self, p: _Prepared, slot: int) -> None:
        ids = self._alloc_pages(-(-p.l_pad // self.page_size))  # raises if the pool is short
        self._slot_pages[slot] = list(ids)
        table_row = np.full((self.window // self.page_size,), self.pool_pages, np.int32)
        table_row[: len(ids)] = ids
        _paged_adopt(self.state, slot, p, ids, table_row)

    # -- preemption ---------------------------------------------------------

    def pending(self) -> bool:
        # In-flight chunks may still owe tokens to requests that
        # _project_completions already took out of by_slot.
        return bool(self.by_slot) or bool(self._inflight) or bool(self.preempted)

    def _preempt(self, req) -> None:
        """Evict a running request and queue it for a recompute resume; its
        stale table row is harmless, as the slot is inactive."""
        slot = req.slot
        del self.by_slot[slot]
        self.free.append(slot)
        self._release_slot(slot)
        req.slot = -1
        self.preempted.append(req.rid)
        self.preemptions += 1

    def _fail_request(self, req, message: str) -> None:
        req.error, req.done = message, True

    def _resume_shape(self, req):
        """(l, l_pad, n_pages) of the recompute prefill of ``req``."""
        l = len(req.prompt_ids) + len(req.tokens) - 1
        l_pad = max(round_up(l, 64), 64)
        return l, l_pad, -(-l_pad // self.page_size)

    def resume_candidate(self) -> Optional[int]:
        """The oldest preempted rid whose resume fits now, or None (host
        work only: the scheduler runs it under its lock).  Requests that can
        never resume are failed and dropped here."""
        while self.preempted:
            rid = self.preempted[0]
            req = self.requests[rid]
            _, l_pad, n_pages = self._resume_shape(req)
            if l_pad >= self.window:
                self.preempted.pop(0)
                self._fail_request(req, f"cannot resume: prompt+generated ({l_pad}) fills "
                                        f"window {self.window}")
                continue
            if n_pages > self.pool_pages:
                self.preempted.pop(0)
                self._fail_request(req, f"cannot resume: needs {n_pages} pages, pool has "
                                        f"{self.pool_pages}")
                continue
            if not self.free or n_pages > len(self._free_pages):
                return None  # wait for running requests to release pages
            return rid
        return None

    def prepare_resume(self, rid: int) -> _Prepared:
        """The recompute prefill of a preempted request (prompt + every
        generated token but the pending last one, which is re-seeded).
        Touches no engine state, so a scheduler runs it outside its lock."""
        req = self.requests[rid]
        self._materialize_first(req)  # preempted before its first collect
        ids = req.prompt_ids + req.tokens[:-1]
        l, l_pad, _ = self._resume_shape(req)
        _, src_state, l_pad2, _ = run_prefill(
            self.lm, {"input_ids": np.asarray([ids], np.int32)}, max_tokens=self.window - l_pad)
        if l_pad2 != l_pad:
            raise RuntimeError(f"resume prefill bucketed to {l_pad2}, expected {l_pad}")
        return _Prepared(src_state=src_state, first=req.tokens[-1], l_pad=l_pad, n_pads=l_pad - l,
                         prompt_ids=req.prompt_ids, max_tokens=req.max_tokens, stop=req.stop,
                         rid=rid, ids=ids)

    def admit_resume(self, prepared: _Prepared) -> bool:
        """Admit a prepared resume if it is still the queue head and still
        fits; False leaves it queued (its prefill is discarded)."""
        if not self.preempted or self.preempted[0] != prepared.rid:
            return False
        _, _, n_pages = self._resume_shape(self.requests[prepared.rid])
        if not self.free or n_pages > len(self._free_pages):
            return False
        self.preempted.pop(0)
        self.admit(prepared)
        return True

    def _try_resume(self) -> None:
        if not self.resume_in_step:
            return
        while True:
            rid = self.resume_candidate()
            if rid is None or not self.admit_resume(self.prepare_resume(rid)):
                break

    # -- decode -------------------------------------------------------------

    def _on_slot_freed(self, slot: int) -> None:
        self._release_slot(slot)

    def fail_all_active(self, message: str) -> None:
        for rid in self.preempted:
            self._fail_request(self.requests[rid], message)
        self.preempted.clear()
        super().fail_all_active(message)
        self._free_pages = list(range(self.pool_pages))
        self._slot_pages = {}

    def _pages_needed(self, req, n_steps: int) -> int:
        start = req.l_pad + len(req.tokens) - req.adopted_at
        last = min(start + n_steps - 1, self.window - 1)
        return last // self.page_size + 1

    def _reserve(self, n_steps: int) -> bool:
        """Allocate every page this chunk can touch (``_growth``: K + 1
        columns a verify pass).  Uncollected chunks' growth counts too
        (their tokens are not in ``req.tokens`` yet).  On
        pool pressure: collect the in-flight chunks first (completions free
        pages), then preempt the youngest text request (with only image
        requests active, fail the youngest); a lone request that cannot fit
        fails."""
        growth = self._growth(n_steps)
        while True:
            pending = self._pending_growth()
            shortfall = sum(
                max(0, self._pages_needed(r, pending + growth) - len(self._slot_pages[r.slot]))
                for r in self.by_slot.values()
            ) - len(self._free_pages)
            if shortfall <= 0:
                break
            if self._inflight:
                for rid, toks in self.flush().items():
                    self._orphan_out.setdefault(rid, []).extend(toks)
                if not self.by_slot:
                    return False
                continue
            if len(self.by_slot) == 1:
                (req,) = self.by_slot.values()
                del self.by_slot[req.slot]
                self.free.append(req.slot)
                self._release_slot(req.slot)
                self._fail_request(req, f"page pool too small ({self.pool_pages} pages) for a "
                                        "lone request's next chunk")
                return False
            text = [r for r in self.by_slot.values() if not r.has_images]
            if text:
                self._preempt(max(text, key=lambda r: r.rid))
                continue
            victim = max(self.by_slot.values(), key=lambda r: r.rid)
            del self.by_slot[victim.slot]
            self.free.append(victim.slot)
            self._release_slot(victim.slot)
            self._fail_request(victim, "page pool exhausted with only image requests active: an "
                                       "image request cannot be recompute-resumed; raise pool_pages "
                                       "or admit fewer image requests at once")
        pending = self._pending_growth()
        for slot, req in self.by_slot.items():
            pages = self._slot_pages[slot]
            while self._pages_needed(req, pending + growth) > len(pages):
                (pid,) = self._alloc_pages(1)
                self.state.page_tables[slot, len(pages)] = pid
                pages.append(pid)
        return True
