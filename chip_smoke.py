#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero, nothing is
caught and carried on):

1. device   — requires a CUDA card; prints its name and power limit and
               builds the kernels from ``phi_3_vision_mlx_tpu_torch/csrc``.
2. kernels  — K1 (W4A16 matmul), K2 (flash attention), K3 (decode
               attention), K4 (decode attention over the int4 KV cache), K5
               (flash attention over the int4 KV cache) and K8 (W8A16
               matmul, levels over the full 0-255 range) against their plain
               PyTorch versions on the card at the main path's shapes, with
               CUDA-event times of both (K4 at Lq = 1, 4 and 16); causal-edge
               checks of K3, K4, and K4 over a row with no valid key; K2
               on a batch of two left pads, an extend chunk, ragged tiles,
               GQA and the 4207-token prompt's bucket; K3 at its split
               plan's edges (run boundaries, a masked run, no visible key,
               Lq = 4, GQA) and timed at a short offset in a 4352-key window
               (its plan takes the window only; K3 and K4 read the offset
               from device memory).
3. reference — a depth-cut (2-layer) full-width Phi-3.5-mini with 4-bit
               and with 8-bit weights, each with the dense and with the int4
               KV cache: prefill and decode logits through the kernels on
               the card against the plain path on the CPU, same weights and
               prompt.
4. serving  — full-size 4-bit Phi-3.5-mini (random weights from a seed)
               behind the port's HTTP handler answers three requests, once
               with the dense cache and once with the int4 cache
               (``use_quantized_cache``), each decode step a CUDA graph
               replay (``engine/graphs.py``); the launch counters (a
               graph's capture records its launches, each replay adds them)
               show that K1, K2 and K3 carried the first run and K1, K4 and
               K5 the second, and that neither launched the other cache's
               kernels; decode tok/s of the first request through
               ``api.generate``.
5. continuous — the same model behind the continuous handler and
               scheduler over the paged pool (4 slots, window 1024, page
               64): (a) dense pool, (b) int4 pool, six concurrent requests
               each; (c) the dense pool cut to 20 pages, which must preempt
               and resume.  Every request answers; the counters show K1 and
               K6 (dense) or K7 (int4) on decode, K2 or K5 on admission, and
               no K3 or K4.  Then the paged engine with both pools on one
               fixed schedule, eager and through its graph: equal streams
               and launch totals, with the graph captured inside the run
               (by its first chunk; plus its warm-up step) and before it.
               Then aggregate decode tok/s of 4 busy slots and one profiled
               paged decode chunk, eager and graph, beside the
               single-stream figure of phase 4.
6. profile  — each single-stream request at a short and a long window,
               with the dense, the int4 and the int8 cache (the last
               dequantizes the window, then runs K2/K3), eager and through
               the decode step's CUDA graph (a request whose first chunk
               captures it, then one that replays it): bitwise-equal tokens
               and max and EOS log-probs and equal launch totals (plus the
               capture's warm-up step), then host wall
               time per token, device busy time per token
               (``torch.profiler``), the idle share, kernels (graph nodes)
               per token, the graph's capture ms and entry bytes, and the
               largest device items.
7. 8-bit    — the port alone writes a 2-layer full-width random checkpoint,
               quantizes it to 8 bits, loads it on the card and generates
               from it; then full-size random 8-bit Phi-3.5-mini answers
               phase 4's requests with both caches and phase 5's run (a),
               with K8 launched and K1 not (the 4-bit runs launch K1 and not
               K8), and its decode token is profiled (eager against graph)
               at the short window.
8. packed   — the 4-bit weights moved to the JAX package's flat packed
               layout (``packed_params``): the 2-layer reference with packed
               leaves against the CPU (dense cache), then phase 4's three
               requests at full size with K9 on every decoder linear and K1
               once per forward pass (lm_head), and the packed decode token
               profiled (eager against graph) at the short window.
9. experiments — the port's entry points of the three kernel experiments
               run once each at their scripts' shapes (E1 against K1 at
               K = 3072, N = 9216; E2 and E3 over a 32-layer int4 cache of
               32768 positions), printing their tables.
10. vision  — full-size random 4-bit Phi-3.5-vision (CLIP ViT-L/14-336,
               24 x 1024, and the 32 x 3072 decoder) built on the card from
               a seed; the images are seeded uint8 arrays behind a small
               class with ``.size`` and ``.convert`` (the path needs no
               Pillow).  (a) A depth-cut copy (3 CLIP layers, so 2 run; 2
               decoder layers; 4 crops) against the plain path on the CPU on
               a landscape and a portrait image: the image features, then
               the prefill and one decode step's logits and max log-prob,
               with the dense and the int4 cache.  (b) Three image requests
               through ``api.generate`` (a square image, a portrait one, a
               prompt with two), with each cache, every decode step a graph
               replay: the counters must show K2 (dense) or K5 (int4) once a
               layer per prefill, K1 on every linear of a decode step and
               on lm_head of a prefill, K3 or K4 once a layer per step, and
               nothing else; then the square image's prefill timed (image
               pipeline and decoder apart), its decode tok/s, and a text
               prompt's of the same window.  (c) The continuous scheduler
               at 4 slots and window 4096, slot cache and page pool, with
               two image and two text requests at once (K6 on the paged
               decode), and the HTTP handler's 400 for several prompts
               with images; an image sent by file path runs only where
               Pillow imports (the script says whether it ran).

Phase 2 also holds K2 and K5 at phase 10's square-image prefill (its
prompt bucket over its window, one left pad; K2 beside SDPA and its bound),
SDPA against the CLIP tower's plain attention at the tower's shape, and
times SDPA over the visible keys beside K3 at offset 100 of 4352 keys.
It also checks K6 and K7 (paged decode attention over the dense and
the int4 page pool), K9 (the packed layout), E1 (W4A8: its dp4a GEMV at
M = 1 and its int8 tensor-core route at M = 2-256, timed at M = 1, 16, 192
and 256) and every mode of
E2/E3 (K4's kernel with another dequantization).  K1 (both modes) and K9 are
checked at every main-path (K, N) for M = 1, 4, 8, 15, 16, 17, 192 and 256
(K1 crosses from route A at M = 1 to route B), with scales and biases drawn
per column, each call repeated and required bit-identical, and timed at
M = 1-256 beside ``_weight_int4pack_mm``.  Each kernel's line in the
JSON carries its bound (its bytes at 3.35 TB/s or its operations at 989
TFLOP/s bf16, 1979 TOP/s int8, whichever is longer, from this run's inputs)
and the time of one PyTorch call computing the same function where there is
one (``library_ms``).  E1-E3's launches are counted over their experiment's
run, the others' over the served path.

It imports the port only, and fails if ``jax`` or any module of the JAX
package ``phi_3_vision_mlx_tpu`` was loaded by the end.

The last three lines are the card's name and power limit, one JSON object
describing each kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# Bench prompt of the JAX package (bench.py:112-116), without its chat markup:
# the server applies the chat template.
PROMPT_A = (
    "Write a detailed mystery story set in a lighthouse on a remote island, "
    "where the keeper discovers a coded journal from the previous keeper who "
    "vanished without a trace."
)
FILLER = (
    "The lighthouse keeper logged the weather, the passing ships and the state "
    "of the lamp every evening before the tide turned. "
)

K1_SHAPES = ((3072, 9216), (3072, 3072), (3072, 16384), (8192, 3072), (3072, 32064))
# K9 at every main-path (K, N) the packed layout takes (lm_head's N = 32064
# is no multiple of 512 and keeps K1's layout).
K9_SHAPES = K1_SHAPES[:4]
# K8 at every main-path (K, N), M = 1 (route A), and for qkv at M = 2, 4,
# 17, 192 and 256 (route B's row tiles, the 175-token prompt's bucket);
# timed at K8_TIMED_ROWS.
K8_CASES = (((3072, 9216), (1, 2, 4, 17, 192, 256)), ((3072, 3072), (1,)), ((3072, 16384), (1,)),
            ((8192, 3072), (1,)), ((3072, 32064), (1,)))
K8_TIMED_ROWS = (1, 4, 192, 256)
# K1 and K8 compare f32 outputs: both sides round W to bf16 and accumulate in
# f32, so only the order of the f32 sums differs.
K1_ATOL, K1_RTOL = 1e-3, 1e-3
# K2/K3 return bf16: the f32 sums run in another order, then round to bf16
# (one ulp is 2**-7 relative), so allow two ulps; the absolute term covers
# outputs near zero (an H100 run measured at most 2.4e-4 there, and one ulp
# of |x| < 0.25 is under 1e-3).
ATTN_ATOL, ATTN_RTOL = 2e-3, 2 * 2.0**-7
# K2 rounds its softmax weights to bf16 before p @ v, as the JAX kernel does
# (phi_3_vision_mlx_tpu/ops/kernels/flash_attention.py:86); its plain version
# keeps them in f32.  Outputs near zero of rows over few keys then differ by
# more than ATTN_ATOL beyond the relative term: H100 runs measured 1.6e-3 to
# 3.0e-3 over 24 draws (lq 1024 and 256) and 3.15e-3 at lq = 4224.  So K2's
# absolute term is 4e-3, its relative term ATTN_RTOL.
K2_ATOL = 4e-3
# The flash kernels' cases (K2 over the dense cache, K5 over the int4 cache):
# (lq, lk, q_pos0, left pad of each batch row, kv heads, timed).  Left-padded
# prompts (window = prompt bucket + decode budget), a batch of two prompts
# with different left pads (admission batches them), an extend chunk at
# q_pos0 = 1000, lq and lk off the 64-row and 64-key tiles, 16 kv heads
# (GQA), and the 4207-token prompt's bucket; 32 query heads of 96.
FLASH_CASES = ((64, 128, 0, (14,), 32, True), (1024, 1152, 0, (24,), 32, True),
               (256, 384, 0, (0, 100), 32, False), (100, 1152, 1000, (24,), 32, False),
               (333, 397, 0, (5,), 32, False), (200, 264, 0, (9,), 16, False),
               (4224, 4352, 0, (17,), 32, True))
KV_MEAN = (0.5, -0.3)  # k/v offsets: the int4 cache's bias planes carry signal
K4_ROWS = (1, 4, 16)  # K4's query rows: a decode step, a chunk, the kernel's limit
# Phase 3: bf16 activations through 2 layers on two devices (an H100 run
# measured 8.4e-3 relative L2 and 9.3e-5 in max log-prob).  The prefill and
# the decode step's logits are held to REF_REL_L2.
REF_REL_L2 = 1.5e-2
# The decode max log-prob comes from bf16 logits.  The two devices'
# activations differ by bf16 ulps upstream of lm_head, which moves the top
# logit's f32 value by about one bf16 step (2**-6 at 2-4); when that crosses
# a rounding boundary, the top logit and with it the max log-prob differ by
# the whole step while the other logits agree.  An H100 run with 8-bit
# weights and the dense cache measured a 1.574e-2 difference there, the
# difference of the two devices' top logits (phase 3 prints both).  So the
# max log-prob is held to REF_LOGPROB beyond the measured difference of the
# top logits: 1e-3 wherever they round alike.
REF_LOGPROB = 1e-3
# Phase 3 with the int4 cache, each device quantizing its own keys: rounding
# to 16 levels turns a 1-ulp bf16 difference into a whole step (1/15 of a
# group's range) wherever it crosses a level boundary.  On the CPU, 1-ulp
# noise on 2% of the embeddings moved these logits by 1.2e-2 relative L2
# with the dense cache and 4.1e-2 with the int4 cache; the int4 cache's own
# effect (int4 vs dense) is 0.156.  The limit sits above the amplified noise
# and below half of that effect.  With the card's cache entries replayed on
# the CPU, the comparison is held to REF_REL_L2.
REF_INT4_OWN_REL_L2 = 5 * REF_REL_L2
# The decode max log-prob of that comparison: it is taken from bf16 logits,
# whose ulp is 1.6e-2 at 2-4 and 3.1e-2 at 4-8, so a logit that moves by the
# noise above can move it by whole ulps.  On the CPU the same 1-ulp noise on
# 2% of the embeddings moved it by up to 6.4e-2 with the int4 cache (4-bit and
# 8-bit weights, four noise seeds each; 3.1e-2 with the dense cache).  An
# H100 run with 8-bit weights measured 1.6e-2, one ulp.
REF_INT4_OWN_LOGPROB = 0.1


# The card's published peaks (NVIDIA H100 SXM data sheet, dense): a kernel's
# bound is the larger of its bytes over the memory rate and its operations
# over the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


def bound(nbytes: float, flops: float, rate: float = BF16_FLOPS) -> dict:
    """The least time the card could take for work of ``nbytes`` moved and
    ``flops`` done at ``rate``, and which of the two sets it."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return ({"bound_ms": by_bytes, "bound_by": "bytes"} if by_bytes >= by_ops
            else {"bound_ms": by_ops, "bound_by": "operations"})


T_START = time.perf_counter()


def stamp(phase: str) -> None:
    """The command's time so far, after ``phase``."""
    log(f"[{time.perf_counter() - T_START:.1f} s] {phase} done")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Stream time per call between two CUDA events (includes any gap the
    host leaves between launches)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(torch, run, per: int, tries: int = 3, expected: int = 1):
    """(device ms by short kernel name, kernel launches) of ``run()`` under
    the profiler, times divided by ``per``.  The profiler now and then
    records no kernel of a window, or only some; a window with fewer than
    ``expected`` kernels is run again, and after ``tries`` such windows
    both are empty."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        per_name, launches = Counter(), 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_name[short_name(e.name)] += e.device_time_total / 1e3 / per
                launches += 1
        if sum(per_name.values()) > 0 and launches >= expected:
            return per_name, launches
    return Counter(), 0


def device_ms(torch, fn, iters: int):
    """Sum of the device time of every kernel a call launches (profiler).
    The window of ``iters`` calls must hold ``iters`` times the fewest
    kernels of two profiled calls (a plain version's library calls may add
    a memset), or it is profiled again; None if it never does."""
    fn()
    torch.cuda.synchronize()
    per_call = min(kernel_times(torch, fn, 1)[1] or 1 << 30 for _ in range(2))
    per_name, _ = kernel_times(torch, lambda: [fn() for _ in range(iters)], iters,
                               expected=iters * per_call if per_call < 1 << 30 else 1)
    ms = sum(per_name.values())
    return ms if ms > 0 else None  # None: the profiler saw no device time


def drop_below_bound(report, names) -> None:
    """A device time below its bound means the profiler lost some of the
    window's kernels: it is marked not measured (None)."""
    for n in names:
        for t in [report[n], *report[n].get("timings", [])]:
            for key in ("device_ms", "plain_device_ms"):
                if t.get(key) is not None and t.get("bound_ms") is not None and t[key] < t["bound_ms"]:
                    log(f"{n} {t.get('shape', '')}: {key} {t[key]:.4f} ms is below its bound "
                        f"{t['bound_ms']:.4f} ms: not measured")
                    t[key] = None


def dev_offset(torch, offset: int):
    """A decode offset as the engine keeps it for K3 and K4: a (1,) int32
    tensor on the card."""
    return torch.tensor([offset], dtype=torch.int32, device="cuda")


def timed(torch, kernel_fn, plain_fn, iters: int) -> dict:
    t = {
        "ms": cuda_ms(torch, kernel_fn, iters),
        "plain_ms": cuda_ms(torch, plain_fn, max(2, iters // 4)),
        "device_ms": device_ms(torch, kernel_fn, iters),
        "plain_device_ms": device_ms(torch, plain_fn, max(2, iters // 4)),
    }
    dev = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
    t["text"] = (f"kernel {t['ms']:.4f} ms (device {dev(t['device_ms'])}) "
                 f"plain {t['plain_ms']:.4f} ms (device {dev(t['plain_device_ms'])})")
    return t


def close(torch, out, ref, atol, rtol):
    """(max abs err, max rel err, within atol + rtol * |ref|)."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all()) and bool(torch.isfinite(out).all())
    rel = (diff / ref.float().abs().clamp_min(1e-6)).max().item()
    return diff.max().item(), rel, ok


def excess(out, ref) -> float:
    """max(|out - ref| - ATTN_RTOL |ref|): how much of the absolute term a check used."""
    return ((out.float() - ref.float()).abs() - ATTN_RTOL * ref.float().abs()).max().item()


def rotating(n: int):
    """0, 1, ..., n-1, 0, 1, ...: callers rotate buffers past the 50 MB L2."""
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % n
        return state["i"]

    return nxt


def int4pack_ms(torch, x, k: int, n: int, copies: int, g):
    """Time of PyTorch's own 4-bit group-64 matmul (``_weight_int4pack_mm``)
    on K1's shape, weights rotated like K1's; None where this PyTorch has no
    such kernel for the card."""
    try:
        ws = []
        for _ in range(copies):
            w = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device="cuda", generator=g)
            sz = (0.01 * torch.randn((k // 64, n, 2), generator=g, device="cuda")).to(torch.bfloat16)
            ws.append((torch._convert_weight_to_int4pack(w, 8), sz))
        nxt = rotating(copies)

        def call():
            packed, sz = ws[nxt()]
            return torch._weight_int4pack_mm(x, packed, 64, sz)

        call()
        torch.cuda.synchronize()
        return cuda_ms(torch, call, 20)
    except (AttributeError, RuntimeError, TypeError) as e:
        log(f"K1 library call: torch._weight_int4pack_mm unavailable ({type(e).__name__}: "
            f"{str(e)[:160]})")
        return None


# K1 and K9 are checked at every M of W4_CHECK_ROWS (K1's route A at M = 1,
# route B's row tiles and the prefill buckets) and timed at W4_TIMED_ROWS for
# the (K, N) of W4_TIMED (K9: the packed ones), beside PyTorch's own 4-bit
# matmul at the same M.
W4_CHECK_ROWS = (1, 4, 8, 15, 16, 17, 192, 256)
W4_TIMED_ROWS = (1, 4, 16, 64, 192, 256)
W4_TIMED = ((3072, 9216), (3072, 16384), (3072, 32064))


def w4_planes(torch, k: int, n: int, g):
    """Scales and biases of the synthetic weights' magnitude, both drawn per
    column, so that a kernel reading another column's scale or bias fails
    K1's limits."""
    s = 0.004 * (1 + 0.1 * torch.randn((k // 64, n), generator=g, device="cuda"))
    b = -0.03 + 0.001 * torch.randn((k // 64, n), generator=g, device="cuda")
    return s.to(torch.bfloat16), b.to(torch.bfloat16)


def w4_check(torch, call, ref, ref16):
    """``call(out_dtype=f32)`` against ``ref`` under K1's limits, repeated
    (bit-identical?); with ``ref16``, also the bf16 output within one ulp.
    Returns (max abs err, max rel err, within limits, repeat identical)."""
    out = call(out_dtype=torch.float32)
    torch.cuda.synchronize()
    ea, er, ok = close(torch, out, ref, K1_ATOL, K1_RTOL)
    same = torch.equal(out, call(out_dtype=torch.float32))
    if ref16 is not None:  # the decode path's bf16 output: one more rounding (1 ulp)
        ok = ok and close(torch, call(), ref16, K1_ATOL, 2.0**-7)[2]
    return ea, er, ok, same


def w4_timing(torch, name, kernel, plain, ws, x, k, n, m, g, report):
    """Time ``kernel`` and ``plain`` on ``ws`` rotated past the L2, log the
    line with the bound and ``_weight_int4pack_mm``'s time at the same M,
    and keep it in ``report[name]["timings"]``."""
    nxt = rotating(len(ws))
    t = timed(torch, lambda: kernel(ws[nxt()]), lambda: plain(ws[nxt()]), 20)
    nbytes = k * n // 2 + 2 * 2 * (k // 64) * n + 2 * m * k + 2 * m * n
    bd = bound(nbytes, 2 * m * k * n)
    lib = int4pack_ms(torch, x, k, n, len(ws), g)
    dev = t["device_ms"]
    ratio = "not measured" if dev is None or lib is None else f"{dev / lib:.2f}x"
    log(f"{name} K={k} N={n} M={m} timed: bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) {t.pop('text')}; "
        f"library " + ("not measured" if lib is None else f"{lib:.4f} ms") + f" (device / library {ratio})")
    t.update(bd, library_ms=lib)
    report[name].setdefault("timings", []).append({"shape": f"K={k} N={n} M={m}", **t})
    return t


def phase_kernels(torch, report):
    from phi_3_vision_mlx_tpu_torch.core.weights import WORD
    import torch.nn.functional as F

    from phi_3_vision_mlx_tpu_torch.ops.attention import causal_valid_mask
    from phi_3_vision_mlx_tpu_torch.ops.kernels import flash_attention as K2
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as K3
    from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as K1

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)

    # --- K1 at every main-path (K, N) and every M of W4_CHECK_ROWS, both
    # modes; timed (affine) at every shape for M = 1 and at W4_TIMED for
    # W4_TIMED_ROWS, beside _weight_int4pack_mm.
    errs = []
    for k, n in K1_SHAPES:
        nbytes = k * n // 2 + 4 * (k // 64) * n
        copies = max(1, math.ceil(150e6 / nbytes))  # weights read cold, as in decode
        ws = []
        for _ in range(copies):
            qw = torch.randint(-(2**31), 2**31, (k // WORD, n), dtype=torch.int32, generator=g, device=dev)
            ws.append((qw, *w4_planes(torch, k, n, g)))
        for mode in ("affine", "symmetric"):
            for m in W4_CHECK_ROWS:
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                qw, s, b = ws[0]
                b = b if mode == "affine" else None
                ref = K1.quant_matmul_plain(x, qw, s, b, out_dtype=torch.float32)
                ref16 = K1.quant_matmul_plain(x, qw, s, b) if m == 1 else None
                ea, er, ok, same = w4_check(torch, lambda **kw: K1.quant_matmul(x, qw, s, b, **kw), ref, ref16)
                errs.append(ea)
                log(f"K1 K={k} N={n} M={m} {mode} route {K1.route(m, 'k1')}: max_abs={ea:.3e} "
                    f"max_rel={er:.3e} (atol {K1_ATOL} + rtol {K1_RTOL}); repeat bit-identical {same}")
                if not ok or not same:
                    fail(f"K1 disagrees with its plain version (or itself) at K={k} N={n} M={m} {mode}")
        timed_rows = W4_TIMED_ROWS if (k, n) in W4_TIMED else (1,)
        for m in timed_rows:
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            t = w4_timing(torch, "K1", lambda w: K1.quant_matmul(x, *w), lambda w: K1.quant_matmul_plain(x, *w),
                          ws, x, k, n, m, g, report)
            if m == 1:
                report["k1_m1_device_ms"][k, n] = t["device_ms"]
            if (k, n, m) == (3072, 9216, 1):
                report["K1"].update(t, shape="K=3072 N=9216 M=1 affine")
        del ws
    report["K1"]["max_abs_err"] = max(errs)

    # --- K2 at FLASH_CASES and at phase 10's square-image prefill.
    b_, h, kvh, d = 1, 32, 32, 96
    scale = d**-0.5
    errs = []
    vision_case = vision_flash_case()
    for lq, lk, q_pos0, pads, kvh_, is_timed in FLASH_CASES + (vision_case,):
        nb = len(pads)
        q = torch.randn((nb, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
        kk = torch.randn((nb, kvh_, lk, d), generator=g, device=dev).to(torch.bfloat16)
        vv = torch.randn((nb, kvh_, lk, d), generator=g, device=dev).to(torch.bfloat16)
        valid = torch.ones((nb, lk), dtype=torch.bool, device=dev)
        for i, pad in enumerate(pads):
            valid[i, :pad] = False
        out = K2.flash_attention(q, kk, vv, valid, q_pos0, scale)
        ref = K2.flash_attention_plain(q, kk, vv, valid, q_pos0, scale)
        torch.cuda.synchronize()
        ea, er, ok = close(torch, out, ref, K2_ATOL, ATTN_RTOL)
        errs.append(ea)
        line = (f"K2 B={nb} lq={lq} lk={lk} q_pos0={q_pos0} pads={pads} H={h} KV={kvh_} D={d}: "
                f"max_abs={ea:.3e} max_rel={er:.3e} max(|err| - rtol |ref|)={excess(out, ref):.3e} "
                f"(atol {K2_ATOL} + rtol {ATTN_RTOL:.4f})")
        if is_timed:
            t = timed(torch, lambda: K2.flash_attention(q, kk, vv, valid, q_pos0, scale),
                      lambda: K2.flash_attention_plain(q, kk, vv, valid, q_pos0, scale),
                      12 if lq < 4096 else 4)
            line += " " + t.pop("text")
        if lq in (1024, 4224, vision_case[0]):
            mask = causal_valid_mask(valid, q_pos0 + torch.arange(lq, device=dev))
            keys = min(lk, q_pos0 + lq)  # keys past the last query are never needed
            nbytes = 2 * (2 * q.numel() + 2 * nb * kvh_ * keys * d) + nb * lk
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=mask, scale=scale), 12 if lq < 4096 else 4)
            b2 = bound(nbytes, 4 * h * d * int(mask.sum()))
            line += (f" bound {b2['bound_ms']:.4f} ms ({b2['bound_by']}) library (SDPA, same mask) "
                     f"{lib:.4f} ms")
            if lq == 1024:
                report["K2"].update(t, shape=f"lq=1024 lk={lk} H=32 D=96", library_ms=lib, **b2)
            if lq == vision_case[0]:
                line = "vision prefill: " + line
                report["K2"].setdefault("timings", []).append(
                    {"shape": f"vision prefill lq={lq} lk={lk} pad={pads[0]} H=32 D=96", **t, "library_ms": lib,
                     **b2})
            del mask
        log(line)
        if not ok:
            fail(f"K2 disagrees with its plain version at B={nb} lq={lq} lk={lk} q_pos0={q_pos0} "
                 f"KV={kvh_}")
        del q, kk, vv, out, ref
    report["K2"]["max_abs_err"] = max(errs)

    # --- The CLIP tower's attention on the card: F.scaled_dot_product_attention
    # (the JAX package runs no Pallas kernel there) against the tower's plain
    # version (float32 scores, softmax and P V), at the tower's shape: 17
    # crops, 16 heads of 64, 577 tokens.  SDPA rounds P to bf16 before P V,
    # as K2 does, so it is held to K2's limits.
    from phi_3_vision_mlx_tpu_torch.models.vision import clip_attention_plain

    q, kk, vv = (torch.randn((17, 16, 577, 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    out = F.scaled_dot_product_attention(q, kk, vv, scale=64**-0.5)
    ref = clip_attention_plain(q, kk, vv, 64**-0.5)
    torch.cuda.synchronize()
    ea, er, ok = close(torch, out, ref, K2_ATOL, ATTN_RTOL)
    sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, kk, vv, scale=64**-0.5), 12)
    plain_ms = cuda_ms(torch, lambda: clip_attention_plain(q, kk, vv, 64**-0.5), 4)
    log(f"CLIP attention (17 x 16 heads x 577 tokens, D=64): SDPA against the plain version max_abs={ea:.3e} "
        f"max_rel={er:.3e} (atol {K2_ATOL} + rtol {ATTN_RTOL:.4f}); SDPA {sdpa_ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"a layer")
    if not ok:
        fail("SDPA disagrees with the CLIP tower's plain attention")
    del q, kk, vv, out, ref

    # --- K3: one query against windows 640 and 4224; checked with the offset
    # mid-window, timed at the window's end (a decode step reads it all).
    # The offset goes in as the engine keeps it, a (1,) int32 on the device.
    errs = []
    nl = 8  # layers of the stacked cache, rotated so timing reads it cold
    for lmax in (640, 4224):
        ks = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev).to(torch.bfloat16)
        vs = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev).to(torch.bfloat16)
        q = torch.randn((b_, 1, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
        valid = torch.rand((b_, lmax), generator=g, device=dev) > 0.05
        valid[:, :10] = False  # left padding
        for offset in (lmax // 2, lmax - 1):
            for layer in (0, nl - 1):
                out = K3.dense_kv_attention(q, ks, vs, valid, dev_offset(torch, offset), layer, scale)
                ref = K3.dense_kv_attention_plain(q, ks, vs, valid, offset, layer, scale)
                torch.cuda.synchronize()
                ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
                errs.append(ea)
                if not ok:
                    fail(f"K3 disagrees with its plain version at Lmax={lmax} offset={offset} layer={layer}")
        # Causal edge: the last visible key (offset) and the first hidden one
        # (offset + 1) both score ~40 against every head's query (random keys
        # score ~1); their values are -64 and +64.  Right: -64; one key too
        # many: about 0; the edge key dropped: about 64 or noise.
        off, layer = lmax // 2, nl - 1
        edge_k = (4 * q[:, :, 0, :].float()).to(torch.bfloat16)  # H == KV here
        ks[layer, :, :, off], ks[layer, :, :, off + 1] = edge_k, edge_k
        vs[layer, :, :, off], vs[layer, :, :, off + 1] = -64.0, 64.0
        edge_valid = valid.clone()
        edge_valid[:, off : off + 2] = True
        out = K3.dense_kv_attention(q, ks, vs, edge_valid, dev_offset(torch, off), layer, scale)
        ref = K3.dense_kv_attention_plain(q, ks, vs, edge_valid, off, layer, scale)
        torch.cuda.synchronize()
        ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
        edge = (out.float() + 64).abs().max().item()
        log(f"K3 causal edge at offset {off}: max_abs={ea:.3e} vs plain, max |out + 64| = {edge:.3e} (limit 1)")
        if not ok or edge > 1:
            fail(f"K3 mishandles the causal edge at Lmax={lmax} offset={off}")
        errs.append(ea)
        nxt, end = rotating(nl), dev_offset(torch, lmax - 1)
        t = timed(torch, lambda: K3.dense_kv_attention(q, ks, vs, valid, end, nxt(), scale),
                  lambda: K3.dense_kv_attention_plain(q, ks, vs, valid, end, nxt(), scale), 20)
        nbytes = 2 * 2 * kvh * lmax * d + lmax + 2 * 2 * h * d
        t.update(bound(nbytes, 4 * h * d * int(valid.sum())), library_ms=None)
        report["K3"].setdefault("timings", []).append({"shape": f"Lq=1 Lmax={lmax} offset={lmax - 1}", **t})
        log(f"K3 Lq=1 Lmax={lmax} offsets {lmax // 2},{lmax - 1} H={h} D={d}: max_abs={max(errs):.3e} "
            f"(atol {ATTN_ATOL} + rtol {ATTN_RTOL:.4f}); at offset {lmax - 1}: {t.pop('text')} "
            f"({K3.dense_kv_split_plan(lmax)[0]} splits)")
        if lmax == 4224:
            mask = causal_valid_mask(valid, torch.tensor([lmax - 1], device=dev))

            def library():
                layer = nxt()
                return F.scaled_dot_product_attention(q, ks[layer], vs[layer], attn_mask=mask,
                                                      scale=scale)

            lib = cuda_ms(torch, library, 20)
            report["K3"].update(t, shape="Lq=1 Lmax=4224 offset=4223 H=32 D=96", library_ms=lib,
                                **bound(nbytes, 4 * h * d * int(mask.sum())))
        del ks, vs

    # K3's plan takes the window only: at a short offset in a 4352-key window
    # (a long prompt's first decode steps read few keys) all but the first
    # splits find no key and write their empty partials at once.
    lmax, off = 4352, 100
    ks = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev).to(torch.bfloat16)
    vs = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((b_, 1, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    valid = torch.rand((b_, lmax), generator=g, device=dev) > 0.05
    out = K3.dense_kv_attention(q, ks, vs, valid, dev_offset(torch, off), 1, scale)
    ref = K3.dense_kv_attention_plain(q, ks, vs, valid, off, 1, scale)
    torch.cuda.synchronize()
    ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
    errs.append(ea)
    if not ok:
        fail(f"K3 disagrees with its plain version at Lmax={lmax} offset={off}")
    nxt, off_t = rotating(nl), dev_offset(torch, off)
    t = timed(torch, lambda: K3.dense_kv_attention(q, ks, vs, valid, off_t, nxt(), scale),
              lambda: K3.dense_kv_attention_plain(q, ks, vs, valid, off_t, nxt(), scale), 20)
    keys = off + 1  # the keys the query can see, read once
    seen = valid[:, None, None, :keys]

    def library():  # SDPA over the visible keys computes the same function
        layer = nxt()
        return F.scaled_dot_product_attention(q, ks[layer][:, :, :keys], vs[layer][:, :, :keys],
                                              attn_mask=seen, scale=scale)

    t.update(bound(2 * 2 * kvh * keys * d + lmax + 2 * 2 * h * d, 4 * h * d * keys),
             library_ms=cuda_ms(torch, library, 20))
    report["K3"]["timings"].append({"shape": f"Lq=1 Lmax={lmax} offset={off}", **t})
    log(f"K3 Lq=1 Lmax={lmax} offset={off} ({K3.dense_kv_split_plan(lmax)[0]} splits, "
        f"{-(-(off + 1) // K3.K3_SPLIT_KEYS)} with keys): max_abs={ea:.3e}; {t.pop('text')} bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}) library (SDPA over the {keys} visible keys) "
        f"{t['library_ms']:.4f} ms")
    del ks, vs

    # K3 at the edges of its split plan (runs of K3_SPLIT_KEYS keys), Lq 1
    # and 4, 32 and 16 kv heads, over three runs and a part: the last row's
    # key just before, at and just after a run boundary; a run of invalid
    # keys longer than one split mid-window (split 1 wholly masked); a window
    # whose every visible key is invalid, which must give the uniform average
    # of all Lmax values.
    sk = K3.K3_SPLIT_KEYS
    lmax = 3 * sk + 128
    for kvh_ in (kvh, 16):
        ks = torch.randn((2, b_, kvh_, lmax, d), generator=g, device=dev).to(torch.bfloat16)
        vs = torch.randn((2, b_, kvh_, lmax, d), generator=g, device=dev).to(torch.bfloat16)
        mean_v = vs[1].float().mean(dim=2).repeat_interleave(h // kvh_, dim=1)  # (B, H, D)
        for lq in (1, 4):
            q = torch.randn((b_, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
            edges = ((f"last key {2 * sk - 2}", 2 * sk - 1 - lq, ()),
                     (f"last key {2 * sk - 1}", 2 * sk - lq, ()),
                     (f"last key {2 * sk}", 2 * sk + 1 - lq, ()),
                     (f"keys {sk - 8}-{2 * sk + 43} invalid", 3 * sk, ((sk - 8, 2 * sk + 44),)),
                     ("no visible key", sk + 44, ((0, sk + 44 + lq),)))
            for what, offset, holes in edges:
                valid = torch.rand((b_, lmax), generator=g, device=dev) > 0.05
                for lo, hi in holes:
                    valid[:, lo:hi] = False
                out = K3.dense_kv_attention(q, ks, vs, valid, dev_offset(torch, offset), 1, scale)
                ref = K3.dense_kv_attention_plain(q, ks, vs, valid, offset, 1, scale)
                torch.cuda.synchronize()
                ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
                if what == "no visible key":
                    ok = ok and close(torch, out, mean_v[:, :, None].expand_as(out), ATTN_ATOL,
                                      ATTN_RTOL)[2]
                errs.append(ea)
                n_split, _ = K3.dense_kv_split_plan(lmax)
                log(f"K3 edge Lmax={lmax} Lq={lq} KV={kvh_} offset={offset} ({what}, {n_split} "
                    f"splits of {sk}): max_abs={ea:.3e} (atol {ATTN_ATOL} + rtol {ATTN_RTOL:.4f})")
                if not ok:
                    fail(f"K3 disagrees with its plain version at Lmax={lmax} Lq={lq} KV={kvh_} "
                         f"offset={offset} ({what})")
        del ks, vs
    report["K3"]["max_abs_err"] = max(errs)


def phase_quantized_kernels(torch, report):
    """K4 and K5 against their plain versions over int4 caches made by the
    port's own quantizer from random bf16 k/v; K5 at K2's cases."""
    from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig
    from phi_3_vision_mlx_tpu_torch.engine.state import dequantize_kv, quantize_chunk
    from phi_3_vision_mlx_tpu_torch.ops.attention import causal_valid_mask
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as KV

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    kvq = KVQuantConfig(group_size=32, bits=4)
    b_, h, kvh, d = 1, 32, 32, 96
    scale = d**-0.5

    def int4_cache(nl, lmax, nb=b_, kvh_=kvh):
        k = torch.randn((nl, nb, kvh_, lmax, d), generator=g, device=dev) + KV_MEAN[0]
        v = torch.randn((nl, nb, kvh_, lmax, d), generator=g, device=dev) + KV_MEAN[1]
        return quantize_chunk(k.to(torch.bfloat16), v.to(torch.bfloat16), kvq)

    # --- K4: Lq 1, 4 and 16 against windows 640 and 4224; checked with the
    # offset mid-window and last, timed at the window's end.  The dequantized
    # values are bit-identical, so only the order of the sums differs.
    errs = []
    nl = 8  # layers of the stacked cache, rotated so timing reads it cold
    for lmax in (640, 4224):
        payload, scales = int4_cache(nl, lmax)
        valid = torch.rand((b_, lmax), generator=g, device=dev) > 0.05
        valid[:, :10] = False  # left padding
        qs = {lq: torch.randn((b_, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
              for lq in K4_ROWS}
        for lq, q in qs.items():
            for offset in (lmax // 2, lmax - lq):
                for layer in (0, nl - 1):
                    out = KV.quantized_kv_attention(q, payload, scales, valid, dev_offset(torch, offset),
                                                    layer, scale)
                    ref = KV.quantized_kv_attention_plain(q, payload, scales, valid, offset, layer, scale)
                    torch.cuda.synchronize()
                    ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
                    errs.append(ea)
                    if not ok:
                        fail(f"K4 disagrees with its plain version at Lmax={lmax} Lq={lq} "
                             f"offset={offset} layer={layer}")
        # A batch row with no valid key: every query row sees none and gets
        # the uniform average of all Lmax values (H == KV here).
        none = torch.zeros_like(valid)
        mean_v = dequantize_kv(payload[nl - 1], scales[nl - 1], torch.bfloat16)[1].float().mean(dim=2)
        for lq in (1, K4_ROWS[-1]):
            out = KV.quantized_kv_attention(qs[lq], payload, scales, none, dev_offset(torch, lmax // 2),
                                            nl - 1, scale)
            ref = KV.quantized_kv_attention_plain(qs[lq], payload, scales, none, lmax // 2, nl - 1, scale)
            torch.cuda.synchronize()
            ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
            ok = ok and close(torch, out, mean_v[:, :, None].expand_as(out), ATTN_ATOL, ATTN_RTOL)[2]
            log(f"K4 no valid key Lmax={lmax} Lq={lq}: max_abs={ea:.3e} vs plain (and the uniform average)")
            if not ok:
                fail(f"K4 misses the uniform average of a row with no valid key at Lmax={lmax} Lq={lq}")
            errs.append(ea)
        # Causal edge, as for K3.  A group of 32 equal values dequantizes
        # exactly (scale 1, q = 0, value = bias), so values of -64 and +64
        # at keys offset and offset + 1 survive quantization.  Right: -64.
        off, layer = lmax // 2, nl - 1
        q = qs[1]
        edge_k = (4 * q[:, :, 0, :].float()).to(torch.bfloat16)  # H == KV here
        edge_v = torch.tensor([-64.0, 64.0], device=dev)[:, None].expand(2, d).to(torch.bfloat16)
        p2, s2 = quantize_chunk(torch.stack([edge_k, edge_k], dim=2),
                                edge_v.expand(b_, kvh, 2, d), kvq)
        payload[layer, :, :, off : off + 2], scales[layer, :, :, off : off + 2] = p2, s2
        edge_valid = valid.clone()
        edge_valid[:, off : off + 2] = True
        out = KV.quantized_kv_attention(q, payload, scales, edge_valid, dev_offset(torch, off), layer, scale)
        ref = KV.quantized_kv_attention_plain(q, payload, scales, edge_valid, off, layer, scale)
        torch.cuda.synchronize()
        ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
        edge = (out.float() + 64).abs().max().item()
        log(f"K4 causal edge at offset {off}: max_abs={ea:.3e} vs plain, max |out + 64| = {edge:.3e} (limit 1)")
        if not ok or edge > 1:
            fail(f"K4 mishandles the causal edge at Lmax={lmax} offset={off}")
        errs.append(ea)
        n_split, block_keys = KV.quantized_split_plan(lmax)
        for lq, q in qs.items():
            nxt, end = rotating(nl), dev_offset(torch, lmax - lq)
            t = timed(torch, lambda: KV.quantized_kv_attention(q, payload, scales, valid, end, nxt(), scale),
                      lambda: KV.quantized_kv_attention_plain(q, payload, scales, valid, end, nxt(), scale),
                      20)
            pairs = int(causal_valid_mask(valid, lmax - lq + torch.arange(lq, device=dev)).sum())
            nbytes = kvh * lmax * (d + 8 * (d // 32)) + lmax + 2 * 2 * h * lq * d
            t.update(bound(nbytes, 4 * h * d * pairs), library_ms=None)
            shape = f"Lq={lq} Lmax={lmax} offset={lmax - lq} H=32 D=96 int4"
            log(f"K4 {shape} ({n_split} blocks of {block_keys} keys): {t.pop('text')} bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
            report["K4"].setdefault("timings", []).append({"shape": shape, **t})
            if lmax == 4224 and lq == 1:
                report["K4"].update(t, shape=shape)
        log(f"K4 Lq={','.join(map(str, K4_ROWS))} Lmax={lmax} offsets {lmax // 2},{lmax}-Lq H={h} D={d}: "
            f"max_abs={max(errs):.3e} (atol {ATTN_ATOL} + rtol {ATTN_RTOL:.4f})")
        del payload, scales
    report["K4"]["max_abs_err"] = max(errs)

    # --- K5 at FLASH_CASES over int4 caches.  K5's K and V tiles hold the
    # plain path's dequantized bits, and it rounds its softmax weights to
    # bf16 before P V, as K2 and the JAX kernel do
    # (phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:_qflash_kernel,
    # p.astype(v_t.dtype)); its plain version keeps them in f32.  So K5 is
    # held to K2's limits, K2_ATOL + ATTN_RTOL.
    errs = []
    vision_case = vision_flash_case()
    for lq, lk, q_pos0, pads, kvh_, is_timed in FLASH_CASES + (vision_case,):
        nb = len(pads)
        payload, scales = int4_cache(2, lk, nb, kvh_)
        q = torch.randn((nb, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
        valid = torch.ones((nb, lk), dtype=torch.bool, device=dev)
        for i, pad in enumerate(pads):
            valid[i, :pad] = False
        out = KV.quantized_flash_attention(q, payload, scales, valid, q_pos0, 1, scale)
        ref = KV.quantized_flash_attention_plain(q, payload, scales, valid, q_pos0, 1, scale)
        torch.cuda.synchronize()
        ea, er, ok = close(torch, out, ref, K2_ATOL, ATTN_RTOL)
        errs.append(ea)
        line = (f"K5 B={nb} lq={lq} lk={lk} q_pos0={q_pos0} pads={pads} H={h} KV={kvh_} D={d} int4: "
                f"max_abs={ea:.3e} max_rel={er:.3e} max(|err| - rtol |ref|)={excess(out, ref):.3e} "
                f"(atol {K2_ATOL} + rtol {ATTN_RTOL:.4f})")
        del ref
        if is_timed:
            t = timed(torch, lambda: KV.quantized_flash_attention(q, payload, scales, valid, q_pos0, 1, scale),
                      lambda: KV.quantized_flash_attention_plain(q, payload, scales, valid, q_pos0, 1, scale),
                      12 if lq < 4096 else 4)
            pairs = int(causal_valid_mask(valid, q_pos0 + torch.arange(lq, device=dev)).sum())
            keys = min(lk, q_pos0 + lq)  # keys past the last query are never needed
            nbytes = nb * kvh_ * keys * (d + 8 * (d // 32)) + nb * lk + 2 * 2 * q.numel()
            t.update(bound(nbytes, 4 * h * d * pairs), library_ms=None)
            line += f" {t.pop('text')} bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
            shape = f"lq={lq} lk={lk} H=32 D=96 int4"
            if (lq, lk) == vision_case[:2]:
                shape, line = f"vision prefill {shape} pad={pads[0]}", "vision prefill: " + line
            report["K5"].setdefault("timings", []).append({"shape": shape, **t})
            if lq == 1024:
                report["K5"].update(t, shape=shape)
        log(line)
        if not ok:
            fail(f"K5 disagrees with its plain version at B={nb} lq={lq} lk={lk} q_pos0={q_pos0} "
                 f"KV={kvh_}")
        del payload, scales, q, out
    report["K5"]["max_abs_err"] = max(errs)


def phase_w8_kernels(torch, report):
    """K8 against its plain version at every main-path shape under K1's
    limits, twice (bit-identical), levels drawn over the full 0-255 range (4
    uniform bytes per word), scales and biases of the synthetic weights drawn
    per column; weights rotated past the L2 for timing.  No PyTorch call
    computes group-64 affine W8A16: ``_weight_int8pack_mm`` takes one
    symmetric scale per column and no zero point, another function."""
    from phi_3_vision_mlx_tpu_torch.core.weights import WORD8
    from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as K

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)
    errs = []
    for (k, n), ms in K8_CASES:
        wbytes = k * n + 2 * 2 * (k // 64) * n
        copies = max(1, math.ceil(150e6 / wbytes))
        ws = [(torch.randint(-(2**31), 2**31, (k // WORD8, n), dtype=torch.int32, generator=g, device=dev),
               (0.004 * 15 / 255 * (1 + 0.1 * torch.randn((k // 64, n), generator=g, device=dev))
                ).to(torch.bfloat16),
               (-0.03 + 0.001 * torch.randn((k // 64, n), generator=g, device=dev)).to(torch.bfloat16))
              for _ in range(copies)]
        for m in ms:
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            ref = K.quant_matmul_w8_plain(x, *ws[0], out_dtype=torch.float32)
            ref16 = K.quant_matmul_w8_plain(x, *ws[0]) if m == 1 else None
            ea, er, ok, same = w4_check(torch, lambda **kw: K.quant_matmul_w8(x, *ws[0], **kw), ref, ref16)
            errs.append(ea)
            line = (f"K8 K={k} N={n} M={m} route {K.route(m, 'k8')}: max_abs={ea:.3e} max_rel={er:.3e} "
                    f"(atol {K1_ATOL} + rtol {K1_RTOL}); repeat bit-identical {same}")
            if not ok or not same:
                log(line)
                fail(f"K8 disagrees with its plain version (or itself) at K={k} N={n} M={m}")
            if m in K8_TIMED_ROWS and (m == 1 or (k, n) == (3072, 9216)):
                nxt = rotating(copies)
                t = timed(torch, lambda: K.quant_matmul_w8(x, *ws[nxt()]),
                          lambda: K.quant_matmul_w8_plain(x, *ws[nxt()]), 20)
                b8 = bound(wbytes + 2 * m * k + 2 * m * n, 2 * m * k * n)
                line += (f"; bound {b8['bound_ms']:.4f} ms ({b8['bound_by']}) {t.pop('text')}; library "
                         "none (_weight_int8pack_mm: one symmetric scale per column)")
                t.update(b8, library_ms=None)
                report["K8"].setdefault("timings", []).append({"shape": f"K={k} N={n} M={m}", **t})
                if (k, n, m) == (3072, 9216, 1):
                    report["K8"].update(t, shape="K=3072 N=9216 M=1 affine 8-bit")
            log(line)
        del ws
    report["K8"]["max_abs_err"] = max(errs)


def phase_packed_kernels(torch, report):
    """K9 (K10 is K9 on a ``w[layer]`` view) against its plain version at
    every main-path (K, N) of the packed layout and every M of
    W4_CHECK_ROWS, under K1's limits, twice (bit-identical); timed as K1 is:
    uniform random payload bytes (every byte is two valid levels),
    the synthetic weights' scales and biases, weights rotated past the L2
    for timing.  Its library call is K1's (``_weight_int4pack_mm``, the same
    function on the same shape)."""
    from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as K

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    errs = []
    for k, n in K9_SHAPES:
        wbytes = k * n // 2 + 2 * 2 * (k // 64) * n
        copies = max(1, math.ceil(150e6 / wbytes))
        ws = [(torch.randint(0, 256, (k, n // 2), dtype=torch.uint8, generator=g, device=dev),
               *w4_planes(torch, k, n, g)) for _ in range(copies)]
        for m in W4_CHECK_ROWS:
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            ref = K.quant_matmul_packed_plain(x, *ws[0], out_dtype=torch.float32)
            ref16 = K.quant_matmul_packed_plain(x, *ws[0]) if m == 1 else None
            ea, er, ok, same = w4_check(torch, lambda **kw: K.quant_matmul_packed(x, *ws[0], **kw), ref, ref16)
            errs.append(ea)
            log(f"K9 K={k} N={n} M={m}: max_abs={ea:.3e} max_rel={er:.3e} "
                f"(atol {K1_ATOL} + rtol {K1_RTOL}); repeat bit-identical {same}")
            if not ok or not same:
                fail(f"K9 disagrees with its plain version (or itself) at K={k} N={n} M={m}")
        for m in W4_TIMED_ROWS if (k, n) in W4_TIMED else (1,):
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            t = w4_timing(torch, "K9", lambda w: K.quant_matmul_packed(x, *w),
                          lambda w: K.quant_matmul_packed_plain(x, *w), ws, x, k, n, m, g, report)
            k1 = report["k1_m1_device_ms"].get((k, n))
            if m == 1 and k1 is not None and t["device_ms"] is not None:
                log(f"K9 K={k} N={n} M=1: {t['device_ms'] / k1:.2f}x K1's device time ({k1:.4f} ms)")
            if (k, n, m) == (3072, 9216, 1):
                report["K9"].update(t, shape="K=3072 N=9216 M=1 packed")
        del ws
    # An odd number of 512-column blocks, which route B's 128-column tiles
    # cross (no main-path shape has one).
    k, n = 1024, 1536
    w = (torch.randint(0, 256, (k, n // 2), dtype=torch.uint8, generator=g, device=dev), *w4_planes(torch, k, n, g))
    for m in (1, 4, 17):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        ea, er, ok = close(torch, K.quant_matmul_packed(x, *w, out_dtype=torch.float32),
                           K.quant_matmul_packed_plain(x, *w, out_dtype=torch.float32), K1_ATOL, K1_RTOL)
        errs.append(ea)
        log(f"K9 K={k} N={n} M={m}: max_abs={ea:.3e} max_rel={er:.3e}")
        if not ok:
            fail(f"K9 disagrees with its plain version at K={k} N={n} M={m}")
    report["K9"]["max_abs_err"] = max(errs)


# E1 (w4a8_bench.py's gate_up shape) at M = 1 (route A) and M = 2, 16, 64,
# 192, 256 (route B's row tiles of 16, 32, 64), and at an N off the
# 128-column tiles with K split four ways and, at K = 256, not split (the
# kernel writes the output itself); timed at E1_TIMED_ROWS on the main shape.
E1_SHAPE = (3072, 9216)
E1_CASES = ((*E1_SHAPE, (1, 2, 16, 64, 192, 256)), (1024, 1160, (1, 2, 17)), (256, 1160, (1, 64)))
E1_TIMED_ROWS = (1, 16, 192, 256)
# E2 (qkv_probe.py) and E3 (qdecode_sweep.py): the modes each reaches, and the
# one its kernel line reports (E2's convert; E3's default sweep is fp32, K4
# itself, and mxu).
E2_MODES = ("fp32", "convert", "nosoftmax")
E3_MODES = ("fp32", "bf16", "convert", "nomul", "fbias", "mxu")
E_SHOWN = {"E2": "convert", "E3": "mxu"}


def phase_experiment_kernels(torch, report):
    """E1 against its plain version at K = 3072, N = 9216, M = 1, 2, 16, 64,
    192 and 256 (route A, and route B's row tiles of 16, 32 and 64) and at a
    ragged N, under K1's f32 limits (the same int8 activations on both sides:
    only the order of the f32 sums differs), timed at M = 1, 16, 192 and 256;
    every E2/E3 mode against
    its plain version at K4's shapes and limits (no-softmax: plus 1e-5 of the
    largest output, the f32 order noise of its 4224 summed terms), at K4's
    plan and at each of E3's keys per block (``qdecode_sweep.SPLITS``), timed at
    Lq = 1, offset 4223, layers rotated past the L2.  No PyTorch call
    computes grouped W4A8 (``torch._int_mm`` has no group scales) or
    attention over the int4 cache."""
    from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig
    from phi_3_vision_mlx_tpu_torch.engine.state import quantize_chunk
    from phi_3_vision_mlx_tpu_torch.experiments import qdecode_sweep
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as KV
    from phi_3_vision_mlx_tpu_torch.ops.kernels import w4a8 as E1

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(6)
    errs = []
    for k, n, rows in E1_CASES:
        wbytes = k * n // 2 + 2 * (k // 64) * n
        copies = max(1, math.ceil(150e6 / wbytes)) if (k, n) == E1_SHAPE else 1
        ws = [(torch.randint(-(2**31), 2**31, (k // 8, n), dtype=torch.int32, generator=g, device=dev),
               (0.01 * torch.randn((k // 64, n), generator=g, device=dev)).to(torch.bfloat16))
              for _ in range(copies)]
        for m in rows:
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            out = E1.w4a8_matmul(x, *ws[0])
            ref = E1.w4a8_matmul_plain(*E1.quantize_activations(x), *ws[0])
            torch.cuda.synchronize()
            ea, er, ok = close(torch, out, ref, K1_ATOL, K1_RTOL)
            errs.append(ea)
            line = (f"E1 K={k} N={n} M={m} (route {E1.route(m)}, plan {E1.plan(m, k, n)}): max_abs={ea:.3e} "
                    f"max_rel={er:.3e} (atol {K1_ATOL} + rtol {K1_RTOL})")
            if (k, n) == E1_SHAPE and m in E1_TIMED_ROWS:
                bd = bound(wbytes + m * k + 4 * m + 4 * m * n, 2 * m * k * n, INT8_OPS)
                nxt = rotating(copies)
                t = timed(torch, lambda: E1.w4a8_matmul(x, *ws[nxt()]),
                          lambda: E1.w4a8_matmul_plain(*E1.quantize_activations(x), *ws[nxt()]), 20)
                line += f" bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) {t.pop('text')}; library none"
                t.update(bd, library_ms=None)
                report["E1"].setdefault("timings", []).append({"shape": f"K={k} N={n} M={m} symmetric", **t})
                if m == 1:
                    report["E1"].update(t, shape=f"K={k} N={n} M=1 symmetric")
            log(line)
            if not ok:
                fail(f"E1 disagrees with its plain version at K={k} N={n} M={m}")
        del ws
    report["E1"]["max_abs_err"] = max(errs)

    b_, h, kvh, d, nl, lmax = 1, 32, 32, 96, 8, 4224
    scale = d**-0.5
    kk = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev) + KV_MEAN[0]
    vv = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev) + KV_MEAN[1]
    payload, scales = quantize_chunk(kk.to(torch.bfloat16), vv.to(torch.bfloat16), KVQuantConfig(32, 4))
    del kk, vv
    valid = torch.rand((b_, lmax), generator=g, device=dev) > 0.05
    valid[:, :10] = False  # left padding
    qs = {lq: torch.randn((b_, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
          for lq in (1, 4)}
    modes = {}
    for mode in KV.VARIANT_MODES:
        merr = 0.0
        for lq, q in qs.items():
            for offset in (lmax // 2, lmax - lq):
                for layer in (0, nl - 1):
                    ref = KV.quantized_kv_attention_variant_plain(q, payload, scales, valid, offset, layer,
                                                                  scale, mode)
                    atol = ATTN_ATOL + (1e-5 * ref.float().abs().max().item() if mode == "nosoftmax" else 0)
                    # K4's plan, and E3's sweep of keys per block.
                    for split in (None, *qdecode_sweep.SPLITS):
                        out = KV.quantized_kv_attention_variant(q, payload, scales, valid,
                                                                dev_offset(torch, offset), layer,
                                                                scale, mode=mode, split_keys=split)
                        torch.cuda.synchronize()
                        ea, er, ok = close(torch, out, ref, atol, ATTN_RTOL)
                        merr = max(merr, ea)
                        if not ok:
                            fail(f"E2/E3 mode {mode} disagrees with its plain version at Lq={lq} "
                                 f"offset={offset} layer={layer} split_keys={split}")
        nxt, end = rotating(nl), dev_offset(torch, lmax - 1)
        q1 = qs[1]
        t = timed(torch, lambda: KV.quantized_kv_attention_variant(q1, payload, scales, valid, end,
                                                                   nxt(), scale, mode=mode),
                  lambda: KV.quantized_kv_attention_variant_plain(q1, payload, scales, valid, end,
                                                                  nxt(), scale, mode), 20)
        per_key = d + (0 if mode in ("convert", "nosoftmax") else 8 * (d // 32))
        keys = lmax if mode == "nosoftmax" else int(valid.sum())
        bm = bound(kvh * lmax * per_key + (0 if mode == "nosoftmax" else lmax) + 2 * 2 * h * d,
                   4 * h * d * keys)
        log(f"E2/E3 mode {mode} Lq=1,4 Lmax={lmax} H={h} D={d}: max_abs={merr:.3e} (atol {ATTN_ATOL} + "
            f"rtol {ATTN_RTOL:.4f}); Lq=1 at offset {lmax - 1}: bound {bm['bound_ms']:.4f} ms "
            f"({bm['bound_by']}) {t.pop('text')}; library none")
        modes[mode] = {**t, **bm, "max_abs_err": merr}
    for name, owned in (("E2", E2_MODES), ("E3", E3_MODES)):
        shown = modes[E_SHOWN[name]]
        report[name].update({key: shown[key] for key in ("ms", "plain_ms", "device_ms", "plain_device_ms",
                                                         "bound_ms", "bound_by")},
                            shape=f"Lq=1 Lmax=4224 offset=4223 H=32 D=96 int4, mode {E_SHOWN[name]}",
                            library_ms=None, max_abs_err=max(modes[m]["max_abs_err"] for m in owned),
                            modes={m: modes[m] for m in owned})


def full_config(bits: int = 4):
    from phi_3_vision_mlx_tpu_torch.core.config import QuantConfig, preset

    return preset("phi35_mini").replace(quantized=QuantConfig(group_size=64, bits=bits, mode="affine"))


def is_packed(params) -> bool:
    from phi_3_vision_mlx_tpu_torch.core.weights import is_packed_leaf

    return is_packed_leaf(params["model"]["layers"]["mlp"]["down_proj"])


def weights_of(lm) -> str:
    return f"{lm.cfg.quantized.bits}-bit" + (" packed" if is_packed(lm.params) else "")


def first_layers(node, n: int = 2):
    """The first ``n`` layers of a stacked params subtree."""
    if isinstance(node, dict):
        return {k: first_layers(v, n) for k, v in node.items()}
    return node[:n]


def compare_with_cpu(torch, cfg, params, dict_input, label: str) -> None:
    """The model ``cfg`` over ``params`` on the card against the plain path
    on the CPU, same weights and prompt: the prefill logits, one decode
    step's logits and its max log-prob.  The int4 cache (``cfg.
    use_quantized_cache``) is compared twice: with the CPU run writing the
    card's quantized entries (the kernels against the plain path on the same
    cache, at the dense limits), and with each device quantizing its own
    keys."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch.engine import state as S
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM, Decoder, run_prefill
    from phi_3_vision_mlx_tpu_torch.models import phi3

    written = {}  # (layer, first position) -> the card's quantized entries

    def record(state, layer, pos, k_new, v_new):
        S.update_layer_chunk(state, layer, pos, k_new, v_new)
        written[layer, int(pos[0])] = (state.k[layer, :, :, pos].cpu(), state.k_scales[layer, :, :, pos].cpu())

    def replay(state, layer, pos, k_new, v_new):
        state.k[layer, :, :, pos], state.k_scales[layer, :, :, pos] = written[layer, int(pos[0])]

    def run(device, token, write=S.update_layer_chunk):
        """(prefill logits, decode logits, decode max log-prob, token)."""
        decode_logits = []
        forward = phi3.decode_forward

        def captured(*a, **kw):
            res = forward(*a, **kw)
            decode_logits.append(res.logits[0, -1].float().cpu().numpy())
            return res

        phi3.update_layer_chunk = write
        try:
            lm = LM(cfg, params, device=device, graphs=False)  # eager: the host reads every write
            logits, state, _, _ = run_prefill(lm, dict_input, 8)
            token = int(logits[0].argmax()) if token is None else token
            phi3.decode_forward = captured
            dec = Decoder(lm, state)
            dec.start(state, torch.tensor([[token]], device=device))
            _, maxlp, _ = dec.chunk(1)
        finally:
            phi3.update_layer_chunk = S.update_layer_chunk
            phi3.decode_forward = forward
        return logits[0].float().cpu().numpy(), decode_logits[-1], float(maxlp[0, 0]), token

    quantized = cfg.use_quantized_cache
    a, a_dec, lp_a, token = run("cuda", None, record if quantized else S.update_layer_chunk)
    if a.shape != (cfg.vocab_size,) or not np.isfinite(a).all() or not np.isfinite(a_dec).all():
        fail(f"reference: bad logits shape {a.shape} or non-finite values")
    checks = [("dense KV cache", S.update_layer_chunk, REF_REL_L2, REF_LOGPROB)]
    if quantized:
        checks = [("int4 KV cache, the card's entries replayed", replay, REF_REL_L2, REF_LOGPROB),
                  ("int4 KV cache, each device quantizing", S.update_layer_chunk,
                   REF_INT4_OWN_REL_L2, REF_INT4_OWN_LOGPROB)]
    for what, write, limit, lp_limit in checks:
        b, b_dec, lp_b, _ = run("cpu", token, write)
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        rel_dec = float(np.linalg.norm(a_dec - b_dec) / np.linalg.norm(b_dec))
        dlp = abs(lp_a - lp_b)
        top_a, top_b = float(a_dec.max()), float(b_dec.max())
        lp_bound = max(lp_limit, REF_LOGPROB + abs(top_a - top_b))
        log(f"reference ({label}, {what}): prefill logits "
            f"rel L2 cuda-vs-cpu {rel:.3e}, decode logits {rel_dec:.3e} (limit {limit:.3g}); decode "
            f"max log-prob diff {dlp:.3e} (limit {lp_bound:.4g}; top logit {top_a} / {top_b})")
        if rel > limit or not rel_dec <= limit or not dlp <= lp_bound:
            fail(f"reference: the kernel path disagrees with the plain path ({label}, {what})")


def phase_reference(torch, params, proc, bits: int = 4, caches=(False, True)):
    """2-layer full-width slice with ``bits``-bit weights (in the packed
    layout if ``params`` holds it) against the plain path on the CPU
    (``compare_with_cpu``), with the dense and (``caches``) with the int4 KV
    cache."""
    from phi_3_vision_mlx_tpu_torch.api import _apply_chat_template

    small = {
        "model": {**params["model"], "layers": first_layers(params["model"]["layers"])},
        "lm_head": params["lm_head"],
    }
    dict_input = proc(_apply_chat_template(PROMPT_A)[0])
    label = f"{bits}-bit" + (" packed" if is_packed(params) else "")
    for quantized in caches:
        cfg = full_config(bits).replace(num_hidden_layers=2, use_quantized_cache=quantized)
        compare_with_cpu(torch, cfg, small, dict_input, f"2 layers, width 3072, {label} weights")


def post(port: int, body: dict, timeout: float = 600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(), headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as KV
    from phi_3_vision_mlx_tpu_torch.ops.kernels.flash_attention import flash_attention
    from phi_3_vision_mlx_tpu_torch.ops.kernels.quant_matmul import (quant_matmul, quant_matmul_packed,
                                                                      quant_matmul_w8)

    return {"K1": quant_matmul, "K2": flash_attention, "K3": KV.dense_kv_attention,
            "K4": KV.quantized_kv_attention, "K5": KV.quantized_flash_attention,
            "K6": KV.paged_kv_attention, "K7": KV.paged_quantized_kv_attention,
            "K8": quant_matmul_w8, "K9": quant_matmul_packed}


def cache_of(lm) -> str:
    """The KV cache a model serves from: dense, int4 or int8."""
    return f"int{lm.cfg.kv_quant.bits}" if lm.cfg.use_quantized_cache else "dense"


def matmul_kernel(lm) -> str:
    """K1 serves 4-bit weights, K8 8-bit ones; packed 4-bit decoder linears
    run K9 and lm_head K1."""
    return "K8" if lm.cfg.quantized.bits == 8 else "K9+K1" if is_packed(lm.params) else "K1"


def matmul_kernels(lm) -> tuple:
    return tuple(matmul_kernel(lm).split("+"))


def phase_serving(torch, lm, proc, report):
    """Three requests through the HTTP handler; the counters must show the
    cache's own kernels and none of the other cache's."""
    from http.server import HTTPServer

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine.engine import GRAPH_ENTRIES
    from phi_3_vision_mlx_tpu_torch.serve.server import make_handler

    from phi_3_vision_mlx_tpu_torch.models import phi3
    from phi_3_vision_mlx_tpu_torch.ops.kernels import _build

    counters = kernel_counters()
    cache = cache_of(lm)
    expected = matmul_kernels(lm) + (("K4", "K5") if cache == "int4" else ("K2", "K3"))
    label = f"{weights_of(lm)} weights, {cache} cache"
    forward = phi3.decode_forward

    def counted(*a, **kw):
        """A forward pass (each runs lm_head once), counted as a launch is:
        a graph's capture records it and each replay adds it."""
        _build.count_launch(counted)
        return forward(*a, **kw)
    requests = [
        ("a", PROMPT_A, 64),
        ("b", (FILLER * 20)[:1000], 32),
        ("c", (FILLER * 60)[:4200], 16),
    ]
    httpd = HTTPServer(("127.0.0.1", 0), make_handler((lm, proc)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    phi3.decode_forward = counted
    try:
        for fn in (*counters.values(), counted):
            fn.launches = 0
        for tag, prompt, max_tokens in requests:
            t0 = time.perf_counter()
            status, payload = post(httpd.server_address[1], {"prompt": prompt, "max_tokens": max_tokens})
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            resp = payload.get("responses")
            if status != 200 or not isinstance(resp, list) or not resp or not resp[0]:
                fail(f"request ({tag}, {label}): status {status}, payload {str(payload)[:200]}")
            n_prompt = len(proc(api._apply_chat_template(prompt)[0])["input_ids"][0])
            log(f"request ({tag}, {label}): {n_prompt} prompt tokens, max_tokens {max_tokens}: "
                f"HTTP {status}, {len(resp[0])} chars in {dt:.2f} s")
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        phi3.decode_forward = forward
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    log(f"launch counts over the three requests ({label}): {launches}; {counted.launches} forward passes")
    if "K9" in expected and launches["K1"] != counted.launches:
        fail(f"K1 ran {launches['K1']} times in {counted.launches} forward passes of {label}: "
             "packed weights leave it lm_head only")
    for name, n in launches.items():
        if name not in expected:
            if n != 0:
                fail(f"{name} was launched {n} times on the path of {label}")
            continue
        report[name].setdefault("launches", n)  # K1, K8: the first (4-bit / 8-bit dense) path's count
        if n <= 0:
            fail(f"{name} was never launched on the path of {label}")
    _, tps = api.generate(PROMPT_A, preload=(lm, proc), max_tokens=64, verbose=False,
                          stream=False, mute=True, return_tps=True)
    report[f"single_stream_tps_{weights_of(lm)}_{cache}"] = tps
    # The graph entries over this phase's requests (a, b, c, then a again
    # through api.generate): a request that made its entry paid a capture.
    entries = list(lm.decoders.values())
    captures = ", ".join(f"{d.graph.capture_ms or 0.0:.1f}" for d in entries)
    held = sum(state_bytes(d.state, d.token, d.ring) + d.graph.pool_bytes for d in entries)
    log(f"graph entries over the 4 requests ({label}): {lm.entry_uses['made']} made (each captured in its "
        f"first chunk: {captures} ms), {lm.entry_uses['reused']} reused; {len(entries)} kept of "
        f"GRAPH_ENTRIES {GRAPH_ENTRIES}, holding {held / 2**30:.3f} GiB")
    log(f"decode tok/s, request (a) through api.generate (64 tokens, CUDA graphs, {label}): "
        f"{tps:.2f} on {report['card']}")


def phase_paged_kernels(torch, report):
    """K6 and K7 against their plain versions at the continuous server's
    shapes: 4 slots, 32 heads of 96, a window of 16 pages of 64, a pool of
    64 pages and the spare, ragged offsets, Lq 1, 4 (the fresh region) and
    16, and at their runs' edges; pools rotated past the L2.  Timed at Lq =
    1, 4 and 16; K6's library time is SDPA on the gathered window with the
    same mask."""
    import random

    import torch.nn.functional as F

    from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig
    from phi_3_vision_mlx_tpu_torch.engine.state import quantize_chunk
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as KV

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    s_, h, kvh, d, page, window, pool = 4, 32, 32, 96, 64, 1024, 64
    paged_rows = (1, 4, KV.MAX_PAGED_ROWS)  # a decode step, the fresh region, the speculation limit
    offsets_l = (100, 400, 700, 1000)
    scale = d**-0.5
    rng = random.Random(3)
    ids = rng.sample(range(pool), pool)
    tables = torch.full((s_, window // page), pool, dtype=torch.int32)
    for i, off in enumerate(offsets_l):
        n = -(-(off + 4) // page)
        tables[i, :n] = torch.tensor([ids.pop() for _ in range(n)])
    tables = tables.to(dev)
    offsets = torch.tensor(offsets_l, dtype=torch.int32, device=dev)
    valid = torch.rand((s_, window), generator=g, device=dev) > 0.05
    valid[:, :10] = False  # left padding; the bits past each offset stay random
    shape = f"S=4 offsets {','.join(map(str, offsets_l))} window 1024 page 64 pool 64+1 H=32 D=96"

    def needed(lq, per_key):
        """Bytes a call must move and operations it must do: each slot's keys
        up to its last query, q in, out back."""
        keys = sum(o + lq for o in offsets_l)
        vis = int(KV.paged_visible(valid, offsets, lq).sum())
        nbytes = kvh * keys * per_key + s_ * window + 4 * tables.numel() + 2 * 2 * s_ * h * lq * d
        return bound(nbytes, 4 * h * d * vis)

    def check(name, kernel, plain, pools, nl):
        errs = []
        for lq in paged_rows:
            q = torch.randn((s_, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
            for layer in (0, nl - 1):
                out = kernel(q, *pools, tables, valid, offsets, layer, scale)
                ref = plain(q, *pools, tables, valid, offsets, layer, scale)
                torch.cuda.synchronize()
                ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
                errs.append(ea)
                if not ok:
                    fail(f"{name} disagrees with its plain version at Lq={lq} layer={layer}")
        nxt = rotating(nl)
        t = timed(torch, lambda: kernel(q1, *pools, tables, valid, offsets, nxt(), scale),
                  lambda: plain(q1, *pools, tables, valid, offsets, nxt(), scale), 20)
        log(f"{name} Lq={','.join(map(str, paged_rows))} {shape}: max_abs={max(errs):.3e} (atol {ATTN_ATOL} "
            f"+ rtol {ATTN_RTOL:.4f}); Lq=1: {t.pop('text')}")
        return t, max(errs)

    # Both kernels at the edges of their runs: slot 0 past its window with no
    # valid key (the uniform average of every value of its window, spare
    # pages included), slot 1 at offset 0 (fresh keys only), slot 2's last
    # row at a run's last key (Lq = 4), slot 3 mid-run.  Two table entries
    # lie outside [0, P] (slot 3's first page, slot 2's second), which the
    # kernels clamp into the pool: the plain version reads the clamped table.
    edge_offsets = torch.tensor([window, 0, 2 * page - 4, 130], dtype=torch.int32, device=dev)
    edge_valid = valid.clone()
    edge_valid[0] = False
    edge_tables = tables.clone()
    edge_tables[3, 0], edge_tables[2, 1] = pool + 7, -3
    clamped = edge_tables.clamp(0, pool)

    def edges(name, kernel, plain, pools, layer):
        for lq in paged_rows:
            q = torch.randn((s_, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
            out = kernel(q, *pools, edge_tables, edge_valid, edge_offsets, layer, scale)
            ref = plain(q, *pools, clamped, edge_valid, edge_offsets, layer, scale)
            torch.cuda.synchronize()
            ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
            log(f"{name} edges Lq={lq} offsets {edge_offsets.tolist()}: max_abs={ea:.3e} (atol {ATTN_ATOL} + "
                f"rtol {ATTN_RTOL:.4f})")
            if not ok:
                fail(f"{name} disagrees with its plain version at its edges, Lq={lq}")
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], ea)

    def timed_rows(name, kernel, plain, pools, nl, per_key, tag, library=None):
        """Lq = 4 and 16 timed as Lq = 1 (a slot's pages read once for all of
        its rows), each with its bound and ``library(q)``'s time where a
        PyTorch call computes the same function."""
        for lq in paged_rows[1:]:
            q = torch.randn((s_, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
            nxt = rotating(nl)
            t = timed(torch, lambda: kernel(q, *pools, tables, valid, offsets, nxt(), scale),
                      lambda: plain(q, *pools, tables, valid, offsets, nxt(), scale), 20)
            lib = library(q) if library else None
            t.update(needed(lq, per_key), library_ms=lib)
            lib_text = "" if lib is None else f"; library (SDPA on the gathered windows) {lib:.4f} ms"
            log(f"{name} Lq={lq} {shape}: bound {t['bound_ms']:.4f} ms ({t['bound_by']}) {t.pop('text')}"
                + lib_text)
            report[name]["timings"].append({"shape": f"{shape} Lq={lq}{tag}", **t})

    q1 = torch.randn((s_, 1, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    nl = 4  # 51 MB of k and v per layer
    pk = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev).to(torch.bfloat16)
    pv = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev).to(torch.bfloat16)
    t, err = check("K6", KV.paged_kv_attention, KV.paged_kv_attention_plain, (pk, pv), nl)
    wins = [(KV.gather_pages(pk[i], tables), KV.gather_pages(pv[i], tables)) for i in range(nl)]

    def sdpa_ms(q):
        """SDPA on the gathered windows with the (S, 1, Lq, W) fresh-region mask."""
        mask = KV.paged_visible(valid, offsets, q.shape[2])
        nxt = rotating(nl)
        return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, *wins[nxt()], attn_mask=mask, scale=scale), 20)

    lib = sdpa_ms(q1)
    t.update(needed(1, 2 * 2 * d), library_ms=lib)
    report["K6"].update(t, shape=shape + " Lq=1", max_abs_err=err)
    report["K6"]["timings"] = [{"shape": shape + " Lq=1", **t}]
    log(f"K6 library call (SDPA on the gathered windows): {lib:.4f} ms")
    edges("K6", KV.paged_kv_attention, KV.paged_kv_attention_plain, (pk, pv), nl - 1)
    timed_rows("K6", KV.paged_kv_attention, KV.paged_kv_attention_plain, (pk, pv), nl, 2 * 2 * d, "",
               library=sdpa_ms)
    del pk, pv, wins

    nl = 8  # 16 MB of payload and scales per layer
    k = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev) + KV_MEAN[0]
    v = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev) + KV_MEAN[1]
    pools = quantize_chunk(k.to(torch.bfloat16), v.to(torch.bfloat16), KVQuantConfig(group_size=32, bits=4))
    del k, v
    t, err = check("K7", KV.paged_quantized_kv_attention, KV.paged_quantized_kv_attention_plain,
                   pools, nl)
    t.update(needed(1, d + 8 * (d // 32)), library_ms=None)
    report["K7"].update(t, shape=shape + " Lq=1 int4", max_abs_err=err)
    report["K7"]["timings"] = [{"shape": shape + " Lq=1 int4", **t}]
    edges("K7", KV.paged_quantized_kv_attention, KV.paged_quantized_kv_attention_plain, pools, nl - 1)
    timed_rows("K7", KV.paged_quantized_kv_attention, KV.paged_quantized_kv_attention_plain, pools, nl,
               d + 8 * (d // 32), " int4")


SERVE_SLOTS, SERVE_WINDOW = 4, 1024  # the JAX server's defaults (page 64)


def phase_continuous(torch, lm, proc, report, run: str, pool_pages: int = 0):
    """Six concurrent requests (prompts of 100-700 tokens, 64-200 new
    tokens; run c: about 300 and 192-256) through the continuous handler over
    the paged pool: more requests than slots, so slots are reused.  All must
    answer; run c's pool of ``pool_pages`` must preempt.  The counters show
    which kernels decode (K6 dense, K7 int4) and admission (K2, K5) ran."""
    from http.server import ThreadingHTTPServer

    from phi_3_vision_mlx_tpu_torch.serve.server import ContinuousScheduler, make_continuous_handler

    cache = cache_of(lm)
    expected = set(matmul_kernels(lm)) | ({"K5", "K7"} if cache == "int4" else {"K2", "K6"})
    if pool_pages:
        # Five pages of prompt each, growing to nine or ten: three running
        # requests outgrow a 20-page pool whatever the admission timing.
        requests = [((FILLER * 3)[: 260 + 10 * i], 192 + 16 * (i % 5)) for i in range(6)]
    else:
        requests = [((FILLER * 6)[: 100 + 120 * i], (64, 200, 120, 90, 160, 100)[i]) for i in range(6)]
    sched = ContinuousScheduler(lm, proc, slots=SERVE_SLOTS, window=SERVE_WINDOW, paged=True,
                                pool_pages=pool_pages)
    eng = sched.engine
    # The pump's ticks, and the admission prefills, on the host clock: a tick
    # that overlaps a prefill shares the GIL with it.
    ticks, prefills = [], []

    def clocked(fn, log_to):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                log_to.append((t0, time.perf_counter()))
        return wrapper

    eng.step_pipelined = clocked(eng.step_pipelined, ticks)
    eng.prepare_many = clocked(eng.prepare_many, prefills)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_continuous_handler(sched))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    counters = kernel_counters()
    results = {}

    def worker(i, prompt, n):
        t0 = time.perf_counter()
        results[i] = (*post(httpd.server_address[1], {"prompt": prompt, "max_tokens": n}),
                      time.perf_counter() - t0)

    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        posts = [threading.Thread(target=worker, args=(i, p, n)) for i, (p, n) in enumerate(requests)]
        for t in posts:
            t.start()
        for t in posts:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    tag = f"continuous run ({run}, {weights_of(lm)} weights, {cache} pool of {eng.pool_pages} pages)"
    for i, (prompt, n) in enumerate(requests):
        if i not in results:
            fail(f"{tag}: request {i} did not answer")
        status, payload, dt = results[i]
        resp = payload.get("responses")
        if status != 200 or not isinstance(resp, list) or not resp or not resp[0]:
            fail(f"{tag}: request {i}: status {status}, payload {str(payload)[:200]}")
    tokens = sum(len(r.tokens) for r in eng.requests.values())
    lat = ", ".join(f"{results[i][2]:.2f}" for i in range(len(requests)))
    log(f"{tag}: {len(requests)} requests of {[len(p) + 1 for p, _ in requests]} prompt tokens, "
        f"max_tokens {[n for _, n in requests]}: all HTTP 200; {tokens} tokens in {wall:.2f} s "
        f"({tokens / wall:.2f} tok/s with admission); latencies {lat} s; preemptions "
        f"{eng.preemptions}")
    busy = [(a, b) for a, b in ticks[1:]]
    overlap = [b - a for a, b in busy if any(pa < b and a < pb for pa, pb in prefills)]
    alone = [b - a for a, b in busy if not any(pa < b and a < pb for pa, pb in prefills)]
    med = lambda xs: sorted(xs)[len(xs) // 2] * 1e3 if xs else float("nan")  # noqa: E731
    log(f"{tag}: pump tick (8-step chunk) median {med(alone):.1f} ms alone ({len(alone)} ticks), "
        f"{med(overlap):.1f} ms while an admission prefill runs ({len(overlap)} ticks); "
        f"{len(prefills)} batched prefills")
    log(f"{tag}: launch counts {launches}")
    for name, n in launches.items():
        if name in expected and n <= 0:
            fail(f"{name} was never launched on the {tag} path")
        if name not in expected and n != 0:
            fail(f"{name} was launched {n} times on the {tag} path")
        if name in ("K6", "K7") and name in expected:
            report[name].setdefault("launches", n)
            report[name].setdefault("per_request", n / len(requests))
    if pool_pages and eng.preemptions <= 0:
        fail(f"{tag}: the pool never preempted")


def eager_twin(lm):
    """The same model with CUDA graphs off: every decode step eager, one
    launch at a time (the reference the graph runs are held to)."""
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM

    return LM(lm.cfg, lm.params, model_path=lm.model_path, device="cuda", graphs=False)


def plus_warm_up(launches: dict, graph) -> dict:
    """Launch totals of an eager run plus one step of ``graph`` (the
    launches its capture recorded): a run that captures first runs its step
    once, eagerly, as the warm-up, and those launches are real."""
    names = {fn: name for name, fn in kernel_counters().items()}
    out = dict(launches)
    for fn, n in graph.launches.items():
        if fn in names:
            out[names[fn]] += n
    return out


def zero_counters() -> dict:
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def phase_paged_profile(torch, lm, proc, report, chunk: int = 8, profiled: int = 4):
    """Steady decode of 4 busy slots over the paged pool, eager and through
    the step's CUDA graph: aggregate tok/s over timed chunks, then one
    profiled chunk (device busy, idle share, kernels per step), beside the
    single-stream figure of this run; the graph's capture ms and bytes."""
    from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine

    cache = cache_of(lm)
    prompts = [(FILLER * 6)[: 150 + 150 * i] for i in range(SERVE_SLOTS)]
    single = report.get(f"single_stream_tps_{weights_of(lm)}_{cache}", float("nan"))
    for mode, model in (("eager", eager_twin(lm)), ("graph", lm)):
        eng = PagedBatchEngine(model, proc, slots=SERVE_SLOTS, window=SERVE_WINDOW)
        t0 = time.perf_counter()
        eng.capture()
        capture_ms = (time.perf_counter() - t0) * 1e3
        for p in eng.prepare_many(prompts, [dict(max_tokens=400)] * SERVE_SLOTS):
            eng.admit(p)
        for _ in range(2):
            eng.step(chunk)  # warm-up
        torch.cuda.synchronize()
        n_chunks = 6
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            eng.step_pipelined(chunk)
        eng.flush()
        wall = time.perf_counter() - t0
        if len(eng.by_slot) != SERVE_SLOTS:
            fail(f"paged profile ({cache}, {mode}): a slot finished early")
        t0 = time.perf_counter()
        eng.step(chunk)
        step_ms = (time.perf_counter() - t0) * 1e3 / chunk
        # A short profiled chunk: the profiler's events cost host seconds to read.
        per_name, launches = kernel_times(torch, lambda: eng.step(profiled), profiled)
        busy = sum(per_name.values())
        if busy <= 0:
            fail(f"paged profile ({cache}, {mode}): the profiler saw no device time")
        rate = SERVE_SLOTS * chunk * n_chunks / wall
        top = ", ".join(f"{name} {ms:.3f}" for name, ms in per_name.most_common(6))
        paged_by = {name: ms for name, ms in per_name.items() if name in SPLIT_RUN_KERNELS}
        g = eng.decoder.graph
        captured = (f"; capture {g.capture_ms:.1f} ms ({capture_ms:.1f} ms with the warm-up), graph pool "
                    f"{g.pool_bytes / 2**20:.1f} MiB beside the {state_bytes(eng.state) / 2**30:.3f} GiB "
                    f"state, {sum(g.launches.values())} wrapper launches a replay" if g.graphs else "")
        log(f"paged decode ({cache} pool, {mode}, {SERVE_SLOTS} busy slots, window {SERVE_WINDOW}, chunks "
            f"of {chunk}): {rate:.2f} tok/s aggregate ({rate / SERVE_SLOTS:.2f} per slot) against "
            f"{single:.2f} tok/s single-stream (graphs) in this run; step wall {step_ms:.2f} ms, device "
            f"busy {busy:.3f} ms, idle share {1 - busy / step_ms:.3f}, {launches / profiled:.0f} kernels "
            f"per step; paged attention {sum(paged_by.values()):.3f} ms per step ({by_text(paged_by)}); "
            f"largest (ms/step): {top}{captured} on {report['card']}")
        del eng
        torch.cuda.empty_cache()


def state_bytes(*objs) -> int:
    """Device bytes of the tensors that ``objs`` (decode states, rings)
    hold as fields or attributes, or are."""
    import torch

    def tensors(o):
        return [o] if isinstance(o, torch.Tensor) else [v for v in vars(o).values()
                                                        if isinstance(v, torch.Tensor)]

    return sum(t.numel() * t.element_size() for o in objs for t in tensors(o))


def phase_paged_parity(torch, lm, proc):
    """Six requests (prompts of 100-700 tokens) through the paged engine (4
    slots, window 1024, page 64) on one fixed schedule, eager and through
    the step's graph, pipelined two chunks deep: once with the graph
    captured inside the run, by its first chunk (an engine used without
    ``capture()``), and once captured before it (as the server does).  The
    token streams must equal the eager run's, and so must every kernel's
    launch total (the first graph run's plus its warm-up step)."""
    from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine

    plan = [(0, 0), (0, 1), (0, 2), (2, 3), (2, 4), (5, 5)]  # (tick, request)
    budgets = (24, 64, 40, 32, 48, 24)
    cache = cache_of(lm)
    runs = {}
    for mode, model in (("eager", eager_twin(lm)), ("graph captured in the run", lm),
                        ("graph captured before", lm)):
        eng = PagedBatchEngine(model, proc, slots=SERVE_SLOTS, window=SERVE_WINDOW, pipeline_depth=2)
        if mode == "graph captured before":
            eng.capture()
        counters = zero_counters()
        queue, rids, tick = list(plan), [], 0
        while queue or eng.pending():
            while queue and queue[0][0] <= tick:
                i = queue[0][1]
                prepared = eng.prepare((FILLER * 6)[: 100 + 120 * i], max_tokens=budgets[i])
                if not eng.can_admit(prepared):
                    break
                queue.pop(0)
                rids.append(eng.admit(prepared))
            eng.step_pipelined(8)
            tick += 1
        eng.flush()
        torch.cuda.synchronize()
        if mode != "eager" and eng.decoder.graph.graph is None:
            fail(f"paged parity ({cache}, {mode}): no graph was captured")
        runs[mode] = ([eng.tokens(r) for r in rids], {n: fn.launches for n, fn in counters.items()},
                      eng.decoder.graph)
        del eng
    e_toks, e_launch, _ = runs.pop("eager")
    for mode, (g_toks, g_launch, graph) in runs.items():
        n_tokens = sum(map(len, g_toks))
        want = plus_warm_up(e_launch, graph) if mode == "graph captured in the run" else e_launch
        log(f"paged parity ({weights_of(lm)} weights, {cache} pool, {mode}): {len(g_toks)} requests, "
            f"{n_tokens} tokens; streams graph == eager: {g_toks == e_toks}; launch totals eager "
            f"{e_launch}, graph {g_launch}, expected {want}")
        if g_toks != e_toks or n_tokens < len(plan):
            fail(f"paged parity ({cache}, {mode}): the graph's streams differ from the eager ones")
        if g_launch != want:
            fail(f"paged parity ({cache}, {mode}): launch totals differ from the eager run's")


# The quantized matmuls' kernels (K1, K8: route A or B and the split sum; K9: route B).
MATMUL_KERNELS = ("k1_gemv_kernel", "wq_mma_kernel", "sum_splits_kernel")
# The split-run decode attention's kernels (K4, K6, K7: csrc/split_runs.cuh).
SPLIT_RUN_KERNELS = ("split_run_kernel", "run_combine_kernel")


def by_text(by_name: dict) -> str:
    """``{kernel: ms}`` as ``"name ms, ..."``, largest first."""
    return ", ".join(f"{name} {ms:.3f}" for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]))


def short_name(kernel: str) -> str:
    """``void (anonymous namespace)::w4a16_partial_kernel<1>(...)`` -> ``w4a16_partial_kernel``."""
    name = kernel.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split("::")[-1]


# Phase 6's single-stream requests: (prompt, max_tokens): windows 768 and 4352.
PROFILE_PROMPTS = {"a": (PROMPT_A, 512), "c": ((FILLER * 60)[:4200], 16)}
# Chunks of the eager-against-graph parity run per request: the ramp's
# first chunks and a ragged tail.
PARITY_CHUNKS = {"a": (8, 32, 23), "c": (8, 7)}


def decode_run(torch, lm, dict_input, budget: int, chunks):
    """Prefill, then ``chunks`` through the model's Decoder, the counters
    zeroed first.  Returns the first token and the chunks' tokens, max and
    EOS log-probs as host arrays, the launch counts, the decoder and the
    prefill's ms (host clock, synchronized)."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch.engine.engine import prefill_decoder

    counters = zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec, first = prefill_decoder(lm, dict_input, budget)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    rows = [tuple(t.cpu().numpy() for t in dec.chunk(n)) for n in chunks]
    torch.cuda.synchronize()
    out = [first.cpu().numpy()] + [np.concatenate(parts) for parts in zip(*rows)]
    return out, {name: fn.launches for name, fn in counters.items()}, dec, prefill_ms


def step_profile(torch, dec, steps: int, profiled: int):
    """(wall ms per step over ``steps`` steps ending in the engine's one
    device-to-host copy, device ms per step by kernel, kernels per step)."""
    dec.chunk(2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, *_ = dec.chunk(steps)
    toks.cpu()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    per_name, launches = kernel_times(torch, lambda: dec.chunk(profiled), profiled)
    return wall, per_name, launches / profiled


def phase_profile(torch, lm, proc, steps: int = 16, profiled: int = 4, tags=("a", "c")):
    """Each single-stream request of ``tags`` (windows 768 and 4352) eager
    and twice through the decode step's CUDA graph, on a model with no
    graph entry yet: the first graph request captures the graph inside its
    own first chunk (capture ms, the entry's bytes), as a user's first
    request of a key does, and the second replays the entry it left.  Each
    run of ``PARITY_CHUNKS`` must give the eager run's tokens and max and
    EOS log-probs bit for bit, and its launch totals, kernel for kernel
    (the capturing run's plus its warm-up step); then wall and device time
    of a decode token, each way."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch.api import _apply_chat_template
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM, release_decoder

    cache = cache_of(lm)
    eager = eager_twin(lm)
    label = f"{weights_of(lm)} weights, {cache} cache"
    for tag in tags:
        prompt, budget = PROFILE_PROMPTS[tag]
        dict_input = proc(_apply_chat_template(prompt)[0])
        e_out, e_launch, e_dec, prefill_ms = decode_run(torch, eager, dict_input, budget, PARITY_CHUNKS[tag])
        fresh = LM(lm.cfg, lm.params, model_path=lm.model_path, device="cuda")  # no entries
        runs = {}
        for run in ("capturing", "replaying"):
            g_out, g_launch, g_dec, _ = decode_run(torch, fresh, dict_input, budget, PARITY_CHUNKS[tag])
            release_decoder(fresh, g_dec)
            same = [np.array_equal(a, b) for a, b in zip(e_out, g_out)]
            runs[run] = g_dec
            want = plus_warm_up(e_launch, g_dec.graph) if run == "capturing" else e_launch
            log(f"graph parity ({tag}, {label}, window {g_dec.state.window}, {run} request): "
                f"{len(g_out[1])} steps; tokens, max log-prob, EOS log-prob bitwise equal to eager: "
                f"{same[1:]} (first token {same[0]}); launch totals as expected: {g_launch == want} "
                f"{g_launch}")
            if not all(same):
                fail(f"graph parity ({tag}, {label}, {run} request): the graph run differs from the eager run")
            if g_launch != want:
                fail(f"graph parity ({tag}, {label}, {run} request): launch totals {g_launch}, expected "
                     f"{want} (eager {e_launch})")
        if runs["replaying"] is not runs["capturing"] or fresh.entry_uses != {"made": 1, "reused": 1}:
            fail(f"graph parity ({tag}, {label}): the second request did not reuse the first one's entry")
        g_dec = runs["replaying"]
        g = g_dec.graph
        entry_bytes = state_bytes(g_dec.state, g_dec.token, g_dec.ring) + g.pool_bytes
        window = g_dec.state.window
        cols = {}
        for mode, dec in (("eager", e_dec), ("graph", g_dec)):
            wall, per_name, kernels = step_profile(torch, dec, steps, profiled)
            busy = sum(per_name.values())
            if busy <= 0:
                fail(f"profile ({tag}, {mode}): the profiler saw no device time")
            cols[mode] = (wall, busy, kernels, per_name)
        e_wall, e_busy, e_kernels, _ = cols["eager"]
        wall, busy, kernels, per_name = cols["graph"]
        top = ", ".join(f"{name} {ms:.3f}" for name, ms in per_name.most_common(6))
        attn = sum(ms for name, ms in per_name.items()
                   if "kv_" in name or "flash" in name or name in SPLIT_RUN_KERNELS)
        matmul_by = {k: per_name[k] for k in MATMUL_KERNELS if per_name[k] > 0}
        log(f"profile ({tag}, {label}): {len(dict_input['input_ids'][0])} prompt tokens, window {window}: "
            f"prefill {prefill_ms:.1f} ms; eager: decode wall {e_wall:.2f} ms/token ({1e3 / e_wall:.2f} "
            f"tok/s), device busy {e_busy:.3f} ms/token, idle share {1 - e_busy / e_wall:.3f}, "
            f"{e_kernels:.0f} kernels/token; graph: decode wall {wall:.2f} ms/token ({1e3 / wall:.2f} "
            f"tok/s), device busy {busy:.3f} ms/token, idle share {1 - busy / wall:.3f}, {kernels:.0f} "
            f"graph nodes/token ({sum(g.launches.values())} through the port's wrappers); capture "
            f"{g.capture_ms or 0:.1f} ms, entry {entry_bytes / 2**30:.3f} GiB (graph pool "
            f"{g.pool_bytes / 2**20:.1f} MiB); attention kernels {attn:.3f} ms/token; {matmul_kernel(lm)} "
            f"{sum(matmul_by.values()):.3f} ms/token; largest (ms/token): {top}")
        del fresh, runs, e_dec, g_dec, g
        torch.cuda.empty_cache()


def phase_experiments(torch, report):
    """The port's three experiment entry points at their scripts' shapes:
    E1 at K = 3072, N = 9216 against K1; E2 over a 32-layer, 32-head int4
    cache of 32768 positions; E3 over the same size, every mode.  Each
    kernel's launches are its experiment's."""
    from phi_3_vision_mlx_tpu_torch.experiments import qdecode_sweep, qkv_probe, w4a8_bench
    from phi_3_vision_mlx_tpu_torch.ops.kernels.kv_attention import quantized_kv_attention_variant
    from phi_3_vision_mlx_tpu_torch.ops.kernels.w4a8 import w4a8_matmul

    runs = (("E1", w4a8_matmul, lambda: w4a8_bench.main([])),
            ("E2", quantized_kv_attention_variant, lambda: qkv_probe.main(["32768"])),
            ("E3", quantized_kv_attention_variant, lambda: qdecode_sweep.main([])))
    os.environ["QD_LMAX"] = "32768"
    os.environ["QD_MODES"] = ",".join(qdecode_sweep.MODES)
    for name, wrapper, run in runs:
        wrapper.launches = 0
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        report[name]["launches"] = wrapper.launches
        log(f"{name} experiment: {wrapper.launches} kernel launches in {time.perf_counter() - t0:.1f} s")
        if wrapper.launches <= 0:
            fail(f"{name} was never launched by its experiment")
        torch.cuda.empty_cache()


# Phase 10, vision.  The images are uint8 arrays from a seed (the path needs
# no Pillow), (height, width): a square one (a 4 x 4 crop
# grid, 2509 image tokens), a landscape one (3 x 4) and a portrait one (4 x
# 3, transposed before and after the resize).
VISION_IMAGES = {"square": (900, 900), "landscape": (700, 1000), "portrait": (900, 600)}
# Phase 10 (b)'s requests through api.generate: (text, images).
VISION_REQUESTS = {"square": ("Describe this image in detail.", ("square",)),
                   "portrait": ("What stands in the middle of this picture?", ("portrait",)),
                   "two images": ("Compare the two images.", ("landscape", "portrait"))}
VISION_MAX_TOKENS = 64
# Phase 10 (a)'s model: 3 CLIP encoder layers (the penultimate rule runs 2)
# and 2 decoder layers at full width; its processor cuts an image to at most
# 2 x 2 crops (num_crops 4), so the CPU's plain run stays short.
REF_CLIP_LAYERS, REF_DECODER_LAYERS, REF_NUM_CROPS = 3, 2, 4
# Phase 10 (c): the continuous server's slots and window.
VISION_SLOTS, VISION_WINDOW = 4, 4096


class ArrayImage:
    """A decoded image made from a uint8 (H, W, 3) array: ``.size`` is
    (width, height) and ``.convert("RGB")`` returns an object numpy reads
    as the array, the duck type ``fetch_image`` and ``Phi3VImageProcessor``
    accept."""

    def __init__(self, pixels, name):
        self.pixels, self.name = pixels, name
        self.size = (pixels.shape[1], pixels.shape[0])

    def convert(self, mode):
        if mode != "RGB":
            raise ValueError(mode)
        return self

    def __array__(self, dtype=None, copy=None):
        return self.pixels if dtype is None else self.pixels.astype(dtype)

    def __str__(self):
        return f"{self.name} ({self.size[0]} x {self.size[1]}, seeded uint8)"


def seeded_image(name: str) -> ArrayImage:
    import numpy as np

    h, w = VISION_IMAGES[name]
    rng = np.random.default_rng(list(VISION_IMAGES).index(name))
    return ArrayImage(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), name)


def vision_config():
    from phi_3_vision_mlx_tpu_torch.core.config import QuantConfig, preset

    return preset("phi35_vision").replace(quantized=QuantConfig(group_size=64, bits=4, mode="affine"))


def vision_processor(num_crops: int = 16):
    from phi_3_vision_mlx_tpu_torch.models.image_processor import Phi3VImageProcessor
    from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3VProcessor
    from phi_3_vision_mlx_tpu_torch.models.tokenizer import ByteTokenizer

    proc = Phi3VProcessor(tokenizer=ByteTokenizer())
    proc.img_processor = Phi3VImageProcessor(num_crops)
    return proc


def vision_request(tag: str):
    """(chat-templated prompt, images) of ``VISION_REQUESTS[tag]``."""
    from phi_3_vision_mlx_tpu_torch.api import _apply_chat_template

    text, names = VISION_REQUESTS[tag]
    return _apply_chat_template(text, [seeded_image(n) for n in names])


def vision_flash_case():
    """K2's and K5's case at phase 10's square-image prefill: (lq, lk,
    q_pos0, (left pad,), kv heads, timed) with lq its prompt bucket and lk
    its window."""
    from phi_3_vision_mlx_tpu_torch.engine.engine import prefill_shape

    d = vision_processor()(*vision_request("square"))
    _, l_pad, window = prefill_shape(d, VISION_MAX_TOKENS)
    return (l_pad, window, 0, (l_pad - d["input_ids"].shape[1],), 32, True)


def phase_vision_reference(torch, params):
    """(a) A full-width 4-bit bf16 Phi-3.5-vision cut to ``REF_CLIP_LAYERS``
    CLIP layers and ``REF_DECODER_LAYERS`` decoder layers, on the card
    against the plain path on the CPU with the same weights and image: the
    image features, then ``compare_with_cpu`` with the dense and the int4
    cache, for a landscape and a portrait image."""
    import dataclasses

    import numpy as np

    from phi_3_vision_mlx_tpu_torch.api import _apply_chat_template
    from phi_3_vision_mlx_tpu_torch.core.weights import params_to
    from phi_3_vision_mlx_tpu_torch.models.vision import image_features, image_token_count

    v = params["model"]["vision_embed_tokens"]
    vm = v["img_processor"]["vision_model"]
    small_v = {**v, "img_processor": {"vision_model": {
        **vm, "encoder": {"layers": first_layers(vm["encoder"]["layers"], REF_CLIP_LAYERS)}}}}
    small = {"model": {**params["model"], "layers": first_layers(params["model"]["layers"], REF_DECODER_LAYERS),
                       "vision_embed_tokens": small_v},
             "lm_head": params["lm_head"]}
    base = vision_config()
    cfg = base.replace(num_hidden_layers=REF_DECODER_LAYERS,
                       vision=dataclasses.replace(base.vision, num_hidden_layers=REF_CLIP_LAYERS))
    on_cpu = params_to(small, "cpu")
    proc = vision_processor(REF_NUM_CROPS)
    label = (f"vision, CLIP {REF_CLIP_LAYERS} layers x {cfg.vision.hidden_size}, decoder "
             f"{REF_DECODER_LAYERS} layers x {cfg.hidden_size}, 4-bit weights")
    for name in ("landscape", "portrait"):
        d = proc(*_apply_chat_template("Describe this image.", [seeded_image(name)]))
        with torch.no_grad():
            (card,), (cpu,) = image_features(small, cfg, d), image_features(on_cpu, cfg, d)
        a, b = card.float().cpu().numpy(), cpu.float().numpy()
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        log(f"reference ({label}, {name} image {seeded_image(name).size}, {image_token_count(d)} image "
            f"tokens of {d['input_ids'].shape[1]}, transposed {d['resize_plans'][0]['trans']}): image features "
            f"rel L2 cuda-vs-cpu {rel:.3e} (limit {REF_REL_L2:.3g})")
        if a.shape != b.shape or not np.isfinite(a).all() or not rel <= REF_REL_L2:
            fail(f"reference: the card's image features disagree with the CPU's ({name})")
        for quantized in (False, True):
            compare_with_cpu(torch, cfg.replace(use_quantized_cache=quantized), small, d, f"{label}, {name} image")


def timed_prefill(torch, lm, dict_input, reps: int = 3) -> dict:
    """Host wall ms (synchronized) of the image prefill, median of ``reps``:
    the image pipeline (resize, CLIP tower, pooling, projection) alone, the
    decoder prefill from the prompt's embeddings alone, and ``run_prefill``
    whole."""
    import statistics

    from phi_3_vision_mlx_tpu_torch.engine.engine import pad_prompt_inputs, prefill_shape, run_prefill
    from phi_3_vision_mlx_tpu_torch.models import phi3
    from phi_3_vision_mlx_tpu_torch.models.vision import compute_inputs_embeds, image_features

    _, l_pad, window = prefill_shape(dict_input, VISION_MAX_TOKENS)
    ids_p, pids_p, valid_p = pad_prompt_inputs(dict_input, l_pad)
    pids, valid = torch.as_tensor(pids_p, device="cuda"), torch.as_tensor(valid_p, device="cuda")

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def pipeline():
        return image_features(lm.params, lm.cfg, dict_input)

    def decoder():
        return phi3.prefill(lm.params, lm.cfg, None, max_tokens=window - l_pad, pids=pids, prompt_valid=valid,
                            inputs_embeds=emb, last_logit_only=True)

    times = {"pipeline": [], "decoder": [], "total": []}
    with torch.no_grad():
        emb = compute_inputs_embeds(lm.params, lm.cfg, dict_input, ids_p)
        for _ in range(reps):
            times["pipeline"].append(wall(pipeline)[0])
            times["decoder"].append(wall(decoder)[0])
            times["total"].append(wall(lambda: run_prefill(lm, dict_input, VISION_MAX_TOKENS))[0])
        out = {k: statistics.median(v) for k, v in times.items()}
        for name, fn in (("pipeline", pipeline), ("decoder", decoder)):
            per_name, launches = kernel_times(torch, fn, 1)
            out[f"{name}_busy"], out[f"{name}_kernels"] = sum(per_name.values()), launches
            out[f"{name}_top"] = by_text(dict(per_name.most_common(6)))
    return out


def phase_vision_generate(torch, lm, report):
    """(b) Full-size 4-bit Phi-3.5-vision: each request of
    ``VISION_REQUESTS`` through ``api.generate``, every decode step a graph
    replay.  The counters must show, per forward pass (a prefill or a decode
    step), the cache's flash kernel (K2 dense, K5 int4) once per layer of a
    prefill, its decode kernel (K3, K4) once per layer of a step, K1 on every
    linear of a step and on lm_head (M = 1) of a prefill, and no other
    kernel.  Then the square image's prefill timed (after those requests
    warmed up), its decode tok/s, and a text prompt's of the same window."""
    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine.engine import prefill_shape
    from phi_3_vision_mlx_tpu_torch.models import phi3
    from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3Processor
    from phi_3_vision_mlx_tpu_torch.models.tokenizer import ByteTokenizer
    from phi_3_vision_mlx_tpu_torch.models.vision import image_token_count
    from phi_3_vision_mlx_tpu_torch.ops.kernels import _build

    proc = vision_processor()
    cache = cache_of(lm)
    flash, decode = ("K5", "K4") if cache == "int4" else ("K2", "K3")
    label = f"full-size 4-bit Phi-3.5-vision, {cache} cache"
    counters = kernel_counters()
    forward = phi3.decode_forward

    def counted(*a, **kw):
        _build.count_launch(counted)
        return forward(*a, **kw)

    phi3.decode_forward = counted
    try:
        for fn in (*counters.values(), counted):
            fn.launches = 0
        for tag, (text, names) in VISION_REQUESTS.items():
            images = [seeded_image(n) for n in names]
            t0 = time.perf_counter()
            out = api.generate(text, images=images, preload=(lm, proc), max_tokens=VISION_MAX_TOKENS,
                               verbose=False, stream=False, mute=True)
            torch.cuda.synchronize()
            d = proc(*vision_request(tag))
            if not isinstance(out, list) or len(out) != 1 or not out[0]:
                fail(f"vision request ({tag}, {label}) gave {out!r}")
            log(f"vision request ({tag}, {label}): {image_token_count(d)} image tokens of "
                f"{d['input_ids'].shape[1]}, window {prefill_shape(d, VISION_MAX_TOKENS)[2]}, "
                f"{len(out[0])} chars in {time.perf_counter() - t0:.2f} s")
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        phi3.decode_forward = forward
    prefills = len(VISION_REQUESTS)
    steps = counted.launches - prefills
    layers = lm.cfg.num_hidden_layers
    want = {name: 0 for name in counters}
    want.update({"K1": steps * (4 * layers + 1) + prefills, flash: layers * prefills, decode: layers * steps})
    log(f"launch counts over the {prefills} vision requests ({label}): {launches}; {prefills} prefills, "
        f"{steps} decode steps; expected {want}")
    if launches != want or steps <= 0:
        fail(f"vision requests ({label}): launches {launches}, expected {want}")

    d = proc(*vision_request("square"))
    t = timed_prefill(torch, lm, d)
    n_img = image_token_count(d)
    report.setdefault("vision", {})[cache] = {"image_tokens": n_img, "prompt_tokens": d["input_ids"].shape[1], **t}
    log(f"image prefill (square image, {label}): {n_img} image tokens of {d['input_ids'].shape[1]}, "
        f"host wall after warm-up, median of 3: run_prefill {t['total']:.1f} ms = image pipeline (resize, "
        f"CLIP tower, pooling, projection) {t['pipeline']:.1f} ms + decoder prefill {t['decoder']:.1f} ms "
        f"(+ embed and scatter); on {report['card']}")
    for name in ("pipeline", "decoder"):
        log(f"image prefill profile ({name}, {label}): device busy {t[f'{name}_busy']:.2f} ms in "
            f"{t[f'{name}_kernels']} kernels; largest (ms): {t[f'{name}_top']}")
    text, names = VISION_REQUESTS["square"]
    _, tps = api.generate(text, images=[seeded_image(n) for n in names], preload=(lm, proc),
                          max_tokens=VISION_MAX_TOKENS, verbose=False, stream=False, mute=True, return_tps=True)
    # A text prompt of the same bucket, so the same window and graph key.
    tproc = Phi3Processor(tokenizer=ByteTokenizer())
    base = len(tproc(api._apply_chat_template("")[0])["input_ids"][0])
    filler = (FILLER * 40)[: d["input_ids"].shape[1] - base]
    if prefill_shape(tproc(api._apply_chat_template(filler)[0]), VISION_MAX_TOKENS) != prefill_shape(
            d, VISION_MAX_TOKENS):
        fail("the text prompt of phase 10 does not share the image prompt's window")
    _, text_tps = api.generate(filler, preload=(lm, tproc), max_tokens=VISION_MAX_TOKENS, verbose=False,
                               stream=False, mute=True, return_tps=True)
    report["vision"][cache].update(decode_tps=tps, text_decode_tps=text_tps)
    log(f"decode tok/s ({label}, {VISION_MAX_TOKENS} tokens through api.generate, CUDA graphs, window "
        f"{prefill_shape(d, VISION_MAX_TOKENS)[2]}): square image {tps:.2f}, text prompt of the same window "
        f"{text_tps:.2f}; on {report['card']}")


def phase_vision_server(torch, lm, paged: bool):
    """(c) The continuous scheduler at ``VISION_SLOTS`` slots and
    ``VISION_WINDOW``, slot cache or page pool: two image requests and two
    text requests submitted at once to ``ContinuousScheduler.complete`` (as
    the HTTP handler does after decoding the images).  All must answer; the
    counters show K1 and K2 (admission prefills) and, paged, K6 on decode.
    Paged, also the HTTP handler: 400 for several prompts with images, and
    an image sent as a file path when Pillow imports here."""
    import tempfile
    from http.server import ThreadingHTTPServer

    from phi_3_vision_mlx_tpu_torch.api import _apply_chat_template
    from phi_3_vision_mlx_tpu_torch.serve.server import ContinuousScheduler, make_continuous_handler

    proc = vision_processor()
    engine = "paged" if paged else "slots"
    requests = [vision_request("square"), vision_request("portrait"),
                (_apply_chat_template(PROMPT_A)[0], None), (_apply_chat_template((FILLER * 8)[:900])[0], None)]
    counters = kernel_counters()
    sched = ContinuousScheduler(lm, proc, slots=VISION_SLOTS, window=VISION_WINDOW, paged=paged)
    for fn in counters.values():
        fn.launches = 0
    results = [None] * len(requests)

    def worker(i, prompt, images):
        try:
            results[i] = sched.complete(prompt, 32, images=images)
        except Exception as e:  # reported below, and the phase fails
            results[i] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i, *r)) for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"continuous {engine} ({VISION_SLOTS} slots, window {VISION_WINDOW}, full-size 4-bit Phi-3.5-vision): "
        f"2 image + 2 text requests at once answered in {time.perf_counter() - t0:.2f} s: "
        f"{[type(r).__name__ if not isinstance(r, str) else len(r) for r in results]} (chars); launches {launches}")
    if not all(isinstance(r, str) and r for r in results):
        fail(f"continuous {engine}: a request failed or gave nothing: {results}")
    expected = {"K1", "K2"} | ({"K6"} if paged else set())
    for name, n in launches.items():
        if (n > 0) != (name in expected):
            fail(f"continuous {engine} with image requests: {name} launched {n} times")
    if not paged:
        return
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_continuous_handler(sched))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        try:
            post(port, {"prompt": ["a", "b"], "images": ["x.png"]})
            fail("several prompts with images were not refused")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                fail(f"several prompts with images: HTTP {e.code}, expected 400")
        try:
            import PIL
            from PIL import Image
        except ImportError:
            log("HTTP image request by file path: not run, Pillow is not installed on this machine "
                "(the image requests above went to ContinuousScheduler.complete as decoded images)")
            return
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/square.png"
            Image.fromarray(seeded_image("square").pixels).save(path)
            status, payload = post(port, {"prompt": VISION_REQUESTS["square"][0], "images": [path],
                                          "max_tokens": 16})
        if status != 200 or not payload.get("responses") or not payload["responses"][0]:
            fail(f"HTTP image request: status {status}, payload {str(payload)[:200]}")
        log(f"HTTP image request by file path (Pillow {PIL.__version__}): ran, HTTP {status}, "
            f"{len(payload['responses'][0])} chars")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def phase_checkpoint(torch):
    """The port alone makes an 8-bit model: a 2-layer full-width random
    checkpoint (``create_random_checkpoint``), quantized to 8 bits
    (``quantize_checkpoint``), loaded on the card (``api._load``) and
    generating through ``api.generate`` on K8 (K1 never launched)."""
    import tempfile

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.core.weights import create_random_checkpoint, quantize_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        create_random_checkpoint(f"{tmp}/raw", "phi35_mini", seed=0, num_hidden_layers=2)
        t1 = time.perf_counter()
        cfg = quantize_checkpoint(f"{tmp}/raw", f"{tmp}/q8", q_bits=8)
        t2 = time.perf_counter()
        lm, proc = api._load(f"{tmp}/q8", device="cuda")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        text = api.generate(PROMPT_A, preload=(lm, proc), max_tokens=16, verbose=False,
                            stream=False, mute=True)
        launches = {name: fn.launches for name, fn in counters.items()}
    if cfg.quantized.bits != 8 or lm.cfg.quantized.bits != 8 or not text or not text[0]:
        fail(f"checkpoint flow: bits {cfg.quantized.bits}/{lm.cfg.quantized.bits}, text {text!r}")
    log(f"checkpoint flow (2 layers, width 3072): create_random_checkpoint {t1 - t0:.1f} s, "
        f"quantize_checkpoint(q_bits=8) {t2 - t1:.1f} s, _load on cuda {t3 - t2:.1f} s; "
        f"api.generate gave {len(text[0])} chars; launches {launches}")
    if launches["K8"] <= 0 or launches["K1"] != 0:
        fail(f"checkpoint flow: K8 {launches['K8']} launches, K1 {launches['K1']}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a GPU")
    try:
        from phi_3_vision_mlx_tpu_torch.ops.kernels import _build
    except ImportError as e:
        fail(f"the port is not importable from {ROOT}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 1: device and build.
    card = nvidia_smi()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _, build_s = _build.library()
    log(f"kernels built in {build_s:.1f} s")
    source = "phi_3_vision_mlx_tpu_torch/csrc/"
    report = {
        "card": card,
        "K1": {"name": "w4a16_quant_matmul", "source": source + "quant_matmul.cu",
               "replaces": "phi_3_vision_mlx_tpu/ops/kernels/quant_matmul.py:541"},
        "K2": {"name": "flash_attention", "source": source + "attention.cu",
               "replaces": "phi_3_vision_mlx_tpu/ops/kernels/flash_attention.py:112"},
        "K3": {"name": "dense_kv_attention", "source": source + "attention.cu",
               "replaces": "phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:213"},
        "K4": {"name": "quantized_kv_attention", "source": source + "quant_kv_attention.cu",
               "replaces": "phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:603"},
        "K5": {"name": "quantized_flash_attention", "source": source + "quant_kv_attention.cu",
               "replaces": "phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:777"},
        "K6": {"name": "paged_kv_attention", "source": source + "paged_kv_attention.cu",
               "replaces": "phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:354"},
        "K7": {"name": "paged_quantized_kv_attention", "source": source + "paged_kv_attention.cu",
               "replaces": "phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:519"},
        "K8": {"name": "w8a16_quant_matmul", "source": source + "quant_matmul.cu",
               "replaces": "phi_3_vision_mlx_tpu/ops/kernels/quant_matmul.py:312"},
        "K9": {"name": "w4a16_packed_quant_matmul", "source": source + "quant_matmul.cu",
               "replaces": "phi_3_vision_mlx_tpu/ops/kernels/quant_matmul.py:139"},
        "E1": {"name": "w4a8_matmul", "source": source + "w4a8_matmul.cu",
               "replaces": "experiments/w4a8_bench.py:87"},
        "E2": {"name": "quantized_kv_attention_variant (qkv_probe)", "source": source + "quant_kv_attention.cu",
               "replaces": "experiments/qkv_probe.py:84"},
        "E3": {"name": "quantized_kv_attention_variant (qdecode_sweep)",
               "source": source + "quant_kv_attention.cu", "replaces": "experiments/qdecode_sweep.py:196"},
        "k1_m1_device_ms": {},
    }

    # Phase 2: each kernel against its plain version.
    phase_kernels(torch, report)
    phase_quantized_kernels(torch, report)
    phase_paged_kernels(torch, report)
    phase_w8_kernels(torch, report)
    phase_packed_kernels(torch, report)
    phase_experiment_kernels(torch, report)
    torch.cuda.empty_cache()
    stamp("phase 2")

    # Phases 3-5 share the full-size weights.
    from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig
    from phi_3_vision_mlx_tpu_torch.core.weights import synth_quantized_params
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM
    from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3Processor
    from phi_3_vision_mlx_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = full_config()
    t0 = time.perf_counter()
    params = synth_quantized_params(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"full-size weights: {cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, "
        f"vocab {cfg.vocab_size}, built in {time.perf_counter() - t0:.1f} s")
    proc = Phi3Processor(tokenizer=ByteTokenizer())
    phase_reference(torch, params, proc)
    stamp("phase 3")
    lm = LM(cfg, params, device="cuda")
    lm_int4 = LM(cfg.replace(use_quantized_cache=True), params, device="cuda")
    phase_serving(torch, lm, proc, report)
    phase_serving(torch, lm_int4, proc, report)
    stamp("phase 4")
    phase_continuous(torch, lm, proc, report, "a")
    phase_continuous(torch, lm_int4, proc, report, "b")
    phase_continuous(torch, lm, proc, report, "c", pool_pages=20)
    phase_paged_parity(torch, lm, proc)
    phase_paged_parity(torch, lm_int4, proc)
    phase_paged_profile(torch, lm, proc, report)
    phase_paged_profile(torch, lm_int4, proc, report)
    stamp("phase 5")
    phase_profile(torch, lm, proc)
    phase_profile(torch, lm_int4, proc)
    # The int8 cache dequantizes each layer's window (read_kv), then runs K2/K3.
    lm_int8 = LM(cfg.replace(use_quantized_cache=True, kv_quant=KVQuantConfig(group_size=32, bits=8)),
                 params, device="cuda")
    phase_profile(torch, lm_int8, proc)
    del lm_int8
    stamp("phase 6")

    # Phase 7: 8-bit weights, from the port's own checkpoint writers, then
    # at full size beside the 4-bit weights.
    phase_checkpoint(torch)
    stamp("phase 7 checkpoint flow")
    cfg8 = full_config(bits=8)
    t0 = time.perf_counter()
    params8 = synth_quantized_params(cfg8, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"full-size 8-bit weights built in {time.perf_counter() - t0:.1f} s")
    phase_reference(torch, params8, proc, bits=8)
    lm8 = LM(cfg8, params8, device="cuda")
    lm8_int4 = LM(cfg8.replace(use_quantized_cache=True), params8, device="cuda")
    phase_serving(torch, lm8, proc, report)
    phase_serving(torch, lm8_int4, proc, report)
    phase_continuous(torch, lm8, proc, report, "d")
    phase_profile(torch, lm8, proc, tags=("a",))
    del lm8, lm8_int4, params8
    torch.cuda.empty_cache()
    stamp("phase 7")

    # Phase 8: the flat packed layout (K9 on the decoder linears).
    from phi_3_vision_mlx_tpu_torch.core.weights import packed_params

    t0 = time.perf_counter()
    params_packed = packed_params(params, cfg)
    torch.cuda.synchronize()
    log(f"full-size 4-bit weights moved to the packed layout in {time.perf_counter() - t0:.1f} s")
    phase_reference(torch, params_packed, proc, caches=(False,))
    lm_packed = LM(cfg, params_packed, device="cuda")
    phase_serving(torch, lm_packed, proc, report)
    phase_profile(torch, lm_packed, proc, tags=("a",))
    del lm, lm_int4, lm_packed, params, params_packed
    torch.cuda.empty_cache()
    stamp("phase 8")

    # Phase 9: the experiments' entry points, each kernel's launches counted
    # over its own run.
    phase_experiments(torch, report)
    stamp("phase 9")

    # Phase 10: vision, full-size random 4-bit Phi-3.5-vision built on the card.
    vcfg = vision_config()
    t0 = time.perf_counter()
    vparams = synth_quantized_params(vcfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"full-size vision weights: CLIP {vcfg.vision.num_hidden_layers} layers x {vcfg.vision.hidden_size}, "
        f"decoder {vcfg.num_hidden_layers} layers x {vcfg.hidden_size}, built in {time.perf_counter() - t0:.1f} s")
    phase_vision_reference(torch, vparams)
    stamp("phase 10 reference")
    lmv = LM(vcfg, vparams, device="cuda")
    lmv_int4 = LM(vcfg.replace(use_quantized_cache=True), vparams, device="cuda")
    phase_vision_generate(torch, lmv, report)
    phase_vision_generate(torch, lmv_int4, report)
    del lmv_int4
    torch.cuda.empty_cache()
    phase_vision_server(torch, lmv, paged=False)
    phase_vision_server(torch, lmv, paged=True)
    stamp("phase 10")
    for pkg in ("jax", "phi_3_vision_mlx_tpu"):
        if any(m == pkg or m.startswith(pkg + ".") for m in sys.modules):
            fail(f"{pkg} was imported")

    keys = ("name", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "device_ms", "plain_device_ms", "shape")
    names = [f"K{i}" for i in range(1, 10)] + ["E1", "E2", "E3"]
    drop_below_bound(report, names)
    kernels = [{"route": "cuda", **{k: report[n][k] for k in keys},
                **{extra: report[n][extra] for extra in ("modes", "timings") if extra in report[n]}}
               for n in names]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
