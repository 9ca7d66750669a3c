"""CUDA graphs of the decode step (the port's counterpart of the JAX
engine's compiled chunk: ``LM._fn`` + ``chunk_fn``, a ``lax.scan`` of
``decode_forward``, argmax and the two log-prob statistics).

A decode step launches about 1700-2600 kernels.  Eagerly the host issues
each, and the card sits idle most of the step; a graph of the step replays
them all with one call.  A step is written against static tensors only —
its inputs (the token, or the slots' ``active`` mask), the decode state
(the device offset ``pos`` or the slots' offsets, the cache) and a
:class:`StepRing` for its outputs — so that one capture serves every step
of every chunk: the state advances in place on the device, and nothing the
step does depends on a host value that changes between steps.  The graph
is keyed by what fixes its shapes and addresses (rows, window, cache kind:
one state), not by the chunk's length: a chunk of n steps resets the
ring's step index and replays n times, so the 8 -> 32 -> 128 -> 256 ramp
and the tails need no new captures.

:class:`StepGraph` runs a step eagerly (the CPU, and ``graphs=False`` on the
card: the reference) or, on the card, captures it once and replays it.
There is no fallback: a capture or a replay that fails raises.  Launch
counts (``ops/kernels/_build.count_launch``) do not run in a replay, so the
capture records each wrapper's launches and every replay adds them.

Constrained decoding's device steps (the JAX engine's compiled
``score_fn``, ``beam_fn`` and ``nocache_fn``) are static steps
(:class:`StaticStep`): the caller copies its inputs into static tensors,
the step writes its f32 log-probs into a static output, and a graph per
shape replays it.  The score step and the beam read belong to a decode
entry (``engine/engine.py:Decoder``), keyed (L, advance) and (L, n_beam)
over the entry's state; the cache-free pass is an entry of its own
(``NocachePass``), keyed (B, l_pad).

Training steps are static steps too (the JAX trainer's compiled
``train_step`` and ``pretrain``'s scanned chunk): the inputs of a step (ids,
RoPE tables, masks, the rate, the dropout key) are static tensors, the
loss is the static output, and the step computes the loss, its gradients
(``torch.autograd.grad``) and the AdamW update (``train/adamw.py``) in
place.  ``save`` holds the trainable tensors, the moments and the step
count, so the warm-up's update is undone and the first replay takes the
batch's step once.  ``train/trainer.py`` keeps a graph per batch shape,
``train/pretrain.py`` one per chunk length; the graphs of one run share one
memory pool (``pool``: ``torch.cuda.graph_pool_handle()``).
"""

from __future__ import annotations

import gc
import time

import torch

from ..ops.kernels import _build


class StepRing:
    """A chunk's outputs on the device: rows ``(rows, B)`` of token (int64),
    max log-prob and EOS log-prob (f32), written by each step at the device
    step index ``index``, which the step advances.  With ``width`` (a
    speculative chunk: ``width`` = K + 1 tokens a pass) each row is ``(B,
    width)`` and ``n_emit`` (rows, B) int64 holds how many of them a pass
    committed."""

    def __init__(self, rows: int, b: int, device, width=None):
        shape = (rows, b) if width is None else (rows, b, width)
        self.index = torch.zeros((1,), dtype=torch.long, device=device)
        self.toks = torch.zeros(shape, dtype=torch.long, device=device)
        self.maxlp = torch.zeros(shape, dtype=torch.float32, device=device)
        self.eoslp = torch.zeros(shape, dtype=torch.float32, device=device)
        self.n_emit = None if width is None else torch.zeros((rows, b), dtype=torch.long,
                                                             device=device)

    def write(self, logits: torch.Tensor, eos_id: int, nxt=None) -> torch.Tensor:
        """One step's logits (B, V) f32 and its tokens (B,) (default: the
        argmax) -> the tokens; their row of the ring is written at
        ``index``, which advances by one."""
        lp = torch.log_softmax(logits, dim=-1)
        if nxt is None:
            nxt = logits.argmax(dim=-1)
        self.toks.index_copy_(0, self.index, nxt[None])
        self.maxlp.index_copy_(0, self.index, lp.amax(dim=-1)[None])
        self.eoslp.index_copy_(0, self.index, lp[:, eos_id][None])
        self.index += 1
        return nxt

    def write_pass(self, logits: torch.Tensor, eos_id: int, out, n_emit) -> None:
        """One verify pass: its logits (B, K + 1, V) f32, tokens (B, K + 1)
        and committed counts (B,)."""
        lp = torch.log_softmax(logits, dim=-1)
        for ring, row in ((self.toks, out), (self.maxlp, lp.amax(dim=-1)),
                          (self.eoslp, lp[..., eos_id]), (self.n_emit, n_emit)):
            ring.index_copy_(0, self.index, row[None])
        self.index += 1

    def start(self, n_steps: int) -> None:
        """Make room for a chunk of ``n_steps`` steps (from row 0)."""
        if not 1 <= n_steps <= self.toks.shape[0]:
            raise ValueError(f"a chunk of {n_steps} steps does not fit the ring of "
                             f"{self.toks.shape[0]}")
        self.index.zero_()

    def rows(self, n_steps: int):
        """Views of the chunk's (n_steps, B[, K + 1]) tokens, max and EOS
        log-probs (and with a width, the (n_steps, B) committed counts); the
        next chunk overwrites them (copy them out first)."""
        views = (self.toks, self.maxlp, self.eoslp) + (() if self.n_emit is None else (self.n_emit,))
        return tuple(v[:n_steps] for v in views)


class StepGraph:
    """``step()`` — one decode step on static tensors, in place — run
    eagerly (``graphs=False``) or replayed as a CUDA graph.

    The graph is captured at the first call (or by :meth:`capture`): the
    step runs once on a side stream first (first-launch set-ups such as
    ``cudaFuncSetAttribute``, cuBLAS's workspace and the caching allocator's
    blocks happen there, not during the capture), the tensors in ``save``
    are restored, and the step is captured with
    ``capture_error_mode="thread_local"``, with Python's garbage collector
    off until the capture ends.  The capture runs nothing, so
    ``save`` must hold every tensor whose value a step advances and a later
    step reads (the offsets, the fed-back token, the ring's step index; a
    training step's params and optimizer state): the first replay then
    redoes the warm-up's step, overwriting its cache and ring writes with
    the same values.  Replays run on the current stream.  ``pool`` (a
    ``torch.cuda.graph_pool_handle()``, or None for a pool of its own) is
    the memory pool the capture allocates in; graphs that share one must
    replay one at a time.  ``capture_ms`` and ``pool_bytes`` (the device
    memory the capture reserved for the graph's intermediates) describe the
    capture."""

    def __init__(self, step, device, graphs: bool, save=(), pool=None):
        self.step = step
        self.device = torch.device(device)
        self.graphs = bool(graphs)
        self.save = tuple(save)
        self.pool = pool
        self.graph = None
        self.launches: dict = {}  # wrapper -> kernel launches per replay
        self.capture_ms = None
        self.pool_bytes = 0

    def new_graph(self):
        return torch.cuda.CUDAGraph()

    def capturing(self, graph):
        return torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local")

    def warm_up(self) -> None:
        """Run the step once on a side stream, ordered after the current
        stream's work and before what follows it."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.step()
        current.wait_stream(side)

    def capture(self) -> None:
        """Warm up and capture the step (a no-op when eager or captured)."""
        if not self.graphs or self.graph is not None:
            return
        t0 = time.perf_counter()
        with torch.no_grad():  # a training step's save holds leaves that require grad
            saved = [t.clone() for t in self.save]
        self.warm_up()
        with torch.no_grad():
            for t, s in zip(self.save, saved):
                t.copy_(s)
        reserved = 0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()  # as the capture itself does first
            reserved = torch.cuda.memory_reserved(self.device)
        graph = self.new_graph()
        # No garbage collection inside the capture: a collection could free
        # a dead entry's graph (a Decoder and its StepGraph hold each other,
        # so only the collector frees them), and destroying a graph while a
        # stream captures breaks the capture.
        enabled = gc.isenabled()
        gc.disable()
        try:
            with _build.recording() as tally:
                with self.capturing(graph):
                    self.step()
        finally:
            if enabled:
                gc.enable()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self.launches = graph, tally
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def __call__(self) -> None:
        """One step: eager, or a replay of the graph (captured first)."""
        if not self.graphs:
            self.step()
            return
        self.capture()
        self.graph.replay()
        _build.add_launches(self.launches)


class StaticStep:
    """A device step with static inputs and a static output (constrained
    decoding's score step, beam read and cache-free pass).  A call copies
    its arguments into ``inputs``, runs ``fn(*inputs)`` through a
    :class:`StepGraph` (eager, or captured at the first call and replayed)
    with the result written into ``out``, and returns ``out``: the next call
    overwrites it, so read it first.  ``save`` and ``pool`` are the
    graph's (the tensors whose value the step advances; the memory pool)."""

    def __init__(self, fn, inputs, out: torch.Tensor, device, graphs: bool, save=(), pool=None):
        self.fn, self.inputs, self.out = fn, tuple(inputs), out
        self.graph = StepGraph(self._step, device, graphs, save=save, pool=pool)

    def _step(self) -> None:
        self.out.copy_(self.fn(*self.inputs))

    def __call__(self, *args) -> torch.Tensor:
        for buf, arg in zip(self.inputs, args, strict=True):
            if tuple(arg.shape) != tuple(buf.shape):
                raise ValueError(f"a static input of {tuple(buf.shape)} given {tuple(arg.shape)}")
            buf.copy_(arg)
        self.graph()
        return self.out
