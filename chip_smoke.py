#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero, nothing is
caught and carried on; phase 15 runs after phase 2, on a card nothing else
holds yet):

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
               with the dense and the int4 cache, and at the long window
               with the int8 cache (it dequantizes the window, then runs
               K2/K3), eager and through
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
               Pillow).  (a) A depth-cut copy (2 CLIP layers, so 1 runs; 1
               decoder layer; 4 crops) against the plain path on the CPU on
               a landscape and a portrait image: the image features, then
               the prefill and one decode step's logits and max log-prob,
               with the dense cache (and the int4 cache, landscape).  (b) Three image requests
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

11. sampling and speculation — on phases 3-6's full-size 4-bit weights.
               (a) Sampled decoding (temperature 0.8, top-p 0.9, top-k 50,
               min-p 0.05): the sampled step's graph against eager bitwise
               (tokens, max and EOS log-probs), the same seed twice, another
               seed another stream, ``api.generate(sample=True, top_k=1)``
               against greedy; the sampling functions on the card against
               the CPU on the same logits and noise; the sampled step's wall,
               device busy and nodes beside the greedy step's.  (b) Single-
               stream speculation at K = 7 on a looping and a plain prompt,
               dense and int4 cache: the stream against its forced-reject
               baseline through the same graph (bitwise) and against vanilla
               greedy (to the first token where they part, which must be a
               near tie); K1 and K3 (dense) or K4 (int4) launched, at Lq = 8;
               a verify pass's wall, busy and nodes; tok/s speculative and
               vanilla, greedy and sampled.  (c) The continuous server with
               ``--spec-k 7`` (4 slots, window 1024) over the slot cache, the
               dense and the int4 page pool and a 20-page pool that must
               preempt, six concurrent requests, three greedy and three
               sampled; K6 or K7 launched at Lq = 8; aggregate tok/s of 4
               busy slots with and without speculation.  (d) K1 (route B) at
               M = 8 and 32, K3 and K4 at Lq = 8 at the windows 768 and
               4352, K6 and K7 at Lq = 8, each against its plain version and
               timed beside its bound and a library call.
12. constrained decoding, choice selection, the agent and GTE — on the
               same weights.  (a) The repair of verify passes of 17-33
               rows: K3, K4, K6 and K7 at Lq = 16 from row0 = 16 and at Lq
               = 1 from row0 = 32 against their plain versions (timed at
               16 + 16); single-stream speculation at K = 31 (two launches
               of 16 rows a layer), dense and int4 cache, and the paged
               engine at spec_k = 20 (16 + 5 rows), dense and int4 pool,
               each bitwise equal to its forced-reject baseline.  (b) A
               2-layer full-width model: ``choose`` on three prompts of
               unequal length and ``constrain`` greedy and with beams on
               the card (each step a graph replay), each step repeated
               on the CPU's plain path (fp32) on the same inputs: the
               steps' log-probs within a stated limit, and the CPU's
               decisions (the run replayed on the host with its numbers)
               the card's but at ties.  (c) Dense and int4 cache, the
               JAX defaults and ``[(16, " A"), "ABCDE"]``: on the first 4
               layers, ``api.constrain`` greedy and with beams through the
               graphs and with ``graphs=False``, every step's log-probs
               bitwise equal, and a 23-row score step two K3/K4 launches
               a layer, no K2/K5; then at full depth (32 layers, every
               step replayed) ``api.choose`` on four prompts and each
               ``api.constrain`` twice (capturing, then replaying): the
               seconds per question, the launches (K1, K2, K3 dense; K1,
               K2, K4, K5 int4), wall ms per replayed step, each graph's
               capture ms and pool, and a replayed score step of 1 + 22
               and 1 + 2 rows and a 3 x 23-row beam step profiled beside
               the eager ones (idle share at most 0.5 replayed).  (d)
               ``Agent()`` with its
               default toolchain on a 2-layer model whose lm_head makes
               its greedy output a python block, which the sandbox runs;
               ``generate(enable_api=True)`` on a quoted prompt.  (e)
               GTE-large (24 x 1024, random weights) on 8 texts, card
               against CPU in f32.
13. LoRA training and adapter serving — on the same weights.  (a) K1
               (route A at M = 1, route B at M = 64 and 256), K8 and K9 at
               M = 64 and the dequantize route at M = 384, on the qkv shape,
               each behind its ``autograd.Function``: the forward and ``dx``
               against the plain version's autograd, no gradient to the
               payload, scales or biases, one counted launch a forward; the
               backward timed beside its bound, its dequantization alone,
               the plain backward and ``torch.matmul`` on a W dequantized
               beforehand.  (b) A 2-layer full-width checkpoint written by
               the port, 4-bit: ``train_lora`` (4 steps, ``mask_ratios=
               [0.0]``) on the card and on a CPU fp32 twin from the same
               initial A, each step's loss and each adapter tensor's cosine
               held to the twin's; then ``_load(adapter_path=)``,
               ``test_lora(take=2)`` and ``generate(use_adapter=True)``;
               ``train_lora`` with graphs (each step a CUDA graph replay)
               against ``graphs=False`` on the same weights, plain, with
               ``mask_ratios=[0.0, 0.1]`` and with ``lora_dropout=0.1``, and
               one step at 2048 positions (blockwise attention): losses and
               adapters bit for bit, or within an eager run's own spread;
               a run resumed from step 2 with graphs against the
               uninterrupted one, bit for bit.  (c) ``train_lora`` at full
               size through its entry point (its ``_load`` pointed at an
               ``LM`` over the built weights, graphs on): the JAX defaults,
               then 5 layers of rank 16 over batches of 768 rows (the
               dequantize route); step wall, a replayed step's and an eager
               step's wall, busy and idle share (a 192-row replay above 0.5
               idle, or a step not replayed, fails), the captures' ms and
               pools, one more step's forward and backward (wall, busy, idle
               share), the backward's dequantization, tokens/s, peak memory,
               K1 launches; a non-finite loss, a ``lora_b`` left 0 or a zero
               LoRA gradient below the top active layer fails.  (d) The wide
               run's adapter through ``load_adapter``: 64 greedy tokens
               through ``api.generate`` from graphs against the same model
               eager, dense and int4 cache, the adapter's effect on the
               logits, the graph step's wall, busy and idle share.  (e)
               ``train_induction_lm`` with the JAX defaults at
               ``scan_steps`` 16 and 1 (each must halve its first loss), K2
               and K3 at head dim 32 (bf16 and fp32; K3 at Lq 1 and 8)
               against their plain versions and timed, then
               ``measure_tokens_per_pass`` on 3 held-out docs (K2 and K3
               launched; tokens a pass strictly between 1 and K + 1).
14. the runbook, the benchmark, the chat session and the step log — in a
               temporary working directory (restored after), the port's
               ``_setup`` writes both random pairs (Phi-3.5-mini and
               Phi-3.5-vision, each unquantized and 4-bit) at full width and
               6 decoder layers.  (a) ``verify record``, then ``verify
               check``, of configs 1-5 (synthetic QA rows, config 5 at a
               32768-token window over the int4 cache, two prefill chunks of
               16384): each returns 0, each config's seconds and launches
               (config 1, the fp32 model: K2 and K3 in fp32 only; configs 2
               and 5: K4 and K5; 3 and 5: K1); then one flipped token in
               config 1's golden must make ``check`` return 1.  (b)
               ``benchmark(train_first=True, dataset_path="synthetic")`` on
               the vision default, the Met Museum URL refused at once (no
               socket opens): 4 configs x 3 tasks, every generation rate
               above 0, the table printed.  (c) A ``ChatSession`` over the
               port's ``Agent`` (text model): one turn, then reset.  (d)
               Config 1's fp32 model through ``api.generate``, twice, the
               second under ``PHI3V_TPU_STEP_LOG``: tok/s and the summary.
15. long context and checkpoint I/O — full width and depth, 4-bit weights
               from seed 0.  (a) A 130900-token prompt (bucket 130944) with
               max_tokens 128, so a 131072-position window, in HBM: with the
               int4 cache, then the dense one, a measured run (prefill ms;
               graph steps bitwise against eager steps on the same state;
               decode wall and device busy ms a token, the idle share), then
               a request through ``api.generate`` (prefill ms, tok/s,
               launches, peak memory against the cache's reckoned bytes);
               then the int4 request again, the second 128K request after
               the dense one.  (b) ``TieredEngine`` at the 131072 window (at
               65536 where the host cannot hold the ~16 GB cold tier twice):
               prefill ms, first logits and greedy tokens against (a)'s
               in-HBM int4 run up to the first near tie, decode ms a step
               with prefetch and with serial copies, the cold stream's
               host-to-device GB/s beside the PCIe link ``nvidia-smi``
               reports.  (c) A raw HF-layout directory of the full-size text
               model written from the weights, ``sanitize_checkpoint`` and
               ``quantize_checkpoint`` of it, each loaded through the native
               reader (seconds) and generating; then the 8-bit and the
               packed 4-bit vision checkpoints, generating with the local
               test image (K8; K9 and K1).
16. parallelism and RetNet — phase 4's weights at full width and depth,
               after phase 12.  (a) ``distributed_init(device="cuda")``: a
               world of one over NCCL and its (1, 1) mesh.  (b)
               ``LM(sp_mesh=)`` beside the plain ``LM``, dense and int4
               cache: the 4207-token prompt with max_tokens 32 through
               ``api.generate``; one ring prefill with no K2 or K5, decode
               graphs launching K3 or K4; the first logits against the plain
               route through 2 layers (phase 3's limits) and through 32
               (phase 11's bar for two routes), the int4 ring's bit for bit
               its dense ring's (the ring attends to fresh keys); the dense
               greedy tokens equal up to the first near tie, the int4 ring's
               graphs bit for bit its eager twin; prefill ms and peak memory
               of each route.  (c) The tensor-parallel hooks at one rank:
               prefill and 8 decode steps, dense and int4 cache, bit for bit
               the plain path, and the collectives a step.  (d)
               ``dryrun_multichip`` over the card.  (e) RetNet at its default
               size: both forms, 60 training steps, 4 more against a CPU
               twin, greedy bytes, ms a recurrent step.  One card shows no
               collective's cost: at one rank each is an identity.
17. fp32 over quantized weights, caches and engines — phase 4's 4-bit
               weights at full width and depth with ``dtype="float32"``
               (norms in f32), every kernel through its fp32 entry.  (a)
               ``api.generate`` of phase 3's prompt for 32 tokens over the
               dense, int4 and int8 caches, and with 8-bit and packed
               weights over the dense cache; each step's logits forced with
               the greedy tokens through the kernels and through the plain
               route on the card (the kernel run's quantized entries
               written in the plain run), within ``FP32_STEP_REL_L2``; the
               tokens equal the plain argmax up to a top-2 gap below
               ``FP32_TIE``; only fp32 entries launched.  (b) The continuous
               paged scheduler, 4 slots, window 1024: four concurrent
               requests over the dense pool, and over the int4 pool with
               ``spec_k=7``; each request's tokens against the plain route
               forced with them, to the first tie (the int4 pool's tie bound
               twice (a)'s own-quantization noise); the fp32 paged step
               profiled through its graph.  (c) One ``train_lora`` step of
               a 2-layer fp32 4-bit model against its CPU twin.

Phase 2 also holds K3 and K4 at phase 15's 131072-key window (Lq 1, offsets
130943, 131071 and 100, in the first layer and in a seventh whose offset
passes 2**31 elements) and K2 and K5 on its last prefill chunk (16384
queries at q_pos0 114688 over 131072 keys, held on 256-row slices: the plain
version of the whole chunk does not fit the card), each timed with its bound
and, for K2 and K3, SDPA.

Phase 2 also holds K2 and K3 in fp32 (an fp32 model's kernels) against
their plain versions in fp32 (``F32_ATOL`` and ``F32_RTOL``): K2 at the
runbook's config 1 prefill (lq 64 over 128 keys, left pad 34), at lq 1024
over 1152 keys, at the 4207-token prompt's bucket (lq 4224 over 4352 keys),
an extend chunk and a batch of two pads; K3 at Lq 1 in
config 1's 128-key window (its first decode step and the window's end), at
Lq 1 and 8 over 640 and 4224 keys, at offset 100 of 4352 keys and from row0
16; each timed beside fp32 SDPA over the same mask and a bound (K2's
operations at 165 TFLOP/s of 3xTF32 products, K3's at 67 TFLOP/s f32).  It holds K4 and K5 at the runbook's config 5 shapes in a
32768-position int4 cache: K4 at Lq 1 from offsets 32639, 32640 and 32767,
K5 on 256-row slices of the second 16384-row prefill chunk (q_pos0 16384,
32384 and 32512), each under the limits of its shorter cases.

Phase 2 also holds the other kernels' fp32 entries against their plain
fp32 versions: K1 (affine and symmetric), K8 and K9 at M = 1, 8 and 192
(K1 also at lm_head's ragged N) within ``F32_ATOL + F32_RTOL |ref|`` plus
``F32_MM_ULPS`` sqrt(K) f32 ulps of ``|x| @ |W|``, each call repeated
bit for bit; K4 at Lq 1, 8 and 16 over 640 and 4224 keys, from row0 16 and
over a row with no valid key; K5 at K2's fp32 cases; K6 (an f32 pool) and
K7 at Lq 1, 8 and 16, from row0 16 and through table entries outside the
pool; each timed beside its bound (bytes, or its products at 165 TFLOP/s
of 3xTF32: route B, K4-K7's split runs and K5 run 3xTF32 on the tensor
cores) and, for K6, fp32 SDPA over the gathered windows.

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
TFLOP/s bf16, 1979 TOP/s int8, 165 TFLOP/s of f32 products in 3xTF32 (fp32
K2) or 67 TFLOP/s f32 on the CUDA cores (fp32 K3), whichever is longer,
from this run's inputs)
and the time of one PyTorch call computing the same function where there is
one (``library_ms``).  E1-E3's launches are counted over their experiment's
run, the others' over the served path.

It imports the port only, and fails if ``jax`` or any module of the JAX
package ``phi_3_vision_mlx_tpu`` was loaded by the end.

The last three lines are the card's name and power limit, one JSON object
describing each kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

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
# K2 and K3 in fp32 (an fp32 model: the runbook's config 1) against their
# plain versions in fp32, TF32 off: both sides sum in f32, each in its own
# order (K2's products in 3xTF32, f32-accurate), with no rounding below f32.
# H100 runs measured at most 2.9e-6 (K2 at lq 64-4224) and 3.6e-7 (K3 at Lq
# 1-16, 128 to 4224 keys) over outputs of O(1).
F32_ATOL, F32_RTOL = 1e-5, 1e-5
# fp32 K2's cases, (lq, lk, q_pos0, left pad of each batch row, timed): the
# runbook's config 1 prefill (its 30-token chat prompt in the 64-token bucket
# of a 128-token window), K2's lq 1024 over 1152 keys, an extend chunk, a
# batch of two pads, the 4207-token prompt's bucket.  32 query and 32 kv
# heads of 96.
K2_F32_CASES = ((64, 128, 0, (34,), True), (1024, 1152, 0, (24,), True), (100, 1152, 1000, (24,), False),
                (256, 384, 0, (0, 100), False), (4224, 4352, 0, (17,), True))
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
# The runbook's config 5 (verify.py): a 32576-token prompt, bucketed to 32640
# (left pad 64), in a 32768-position int4 cache; prefilled in two chunks of
# PREFILL_CHUNK = 16384 rows, then decoded from offset 32640.  K4 at the last
# prompt key, the first decode step and the window's end; K5 on slices of
# LONG_SLICE rows of the second chunk: its first rows, the prompt's last rows
# and the window's last rows.
LONG_WINDOW, LONG_PAD = 32768, 64
LONG_DECODE_OFFSETS = (32639, 32640, 32767)
LONG_SLICE = 256
LONG_CHUNK_ROWS = (16384, 32640 - LONG_SLICE, 32768 - LONG_SLICE)
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
FP32_FLOPS = 67e12  # f32 on the CUDA cores: fp32 K3 uses no tensor cores
# The fp32 entries' products in 3xTF32 (K2, K5, route B of K1/K8/K9, K4, K6,
# K7): three tf32 products (495 TFLOP/s dense) a product.
TF32X3_FLOPS = 495e12 / 3


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
        # The raw Kineto events, the same device events as ``prof.events()``
        # without its event tree, which took 1.4 s for an eager decode
        # step's host ops on an H100 (the raw list 0.27 s).
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                per_name[short_name(e.name())] += e.duration_ns() / 1e6 / per
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
        mask = causal_valid_mask(valid, torch.tensor([lmax - 1], device=dev))

        def library():  # SDPA over the window with the same mask computes the same function
            layer = nxt()
            return F.scaled_dot_product_attention(q, ks[layer], vs[layer], attn_mask=mask, scale=scale)

        lib = cuda_ms(torch, library, 20)
        t.update(bound(nbytes, 4 * h * d * int(mask.sum())), library_ms=lib)
        report["K3"].setdefault("timings", []).append({"shape": f"Lq=1 Lmax={lmax} offset={lmax - 1}", **t})
        log(f"K3 Lq=1 Lmax={lmax} offsets {lmax // 2},{lmax - 1} H={h} D={d}: max_abs={max(errs):.3e} "
            f"(atol {ATTN_ATOL} + rtol {ATTN_RTOL:.4f}); at offset {lmax - 1}: {t.pop('text')} "
            f"({K3.dense_kv_split_plan(lmax)[0]} splits); library (SDPA, same mask) {lib:.4f} ms")
        if lmax == 4224:
            report["K3"].update(t, shape="Lq=1 Lmax=4224 offset=4223 H=32 D=96")
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


def phase_fp32_kernels(torch, report):
    """K2 and K3 in fp32 (an fp32 model's prefill and decode) against their
    plain versions in fp32, TF32 off: K2 at K2_F32_CASES, K3 at Lq 1 and 8
    over 640 and 4224 keys (the window's end), at offset 100 of 4352 keys
    and on a later row group (row0 16); each timed beside its bound (bytes at
    3.35 TB/s or operations, the longer: K2's at 165 TFLOP/s of 3xTF32
    products, K3's at 67 TFLOP/s f32) and fp32 SDPA
    over the same mask, kept in K2's and K3's ``timings``."""
    import torch.nn.functional as F

    from phi_3_vision_mlx_tpu_torch.ops.attention import causal_valid_mask
    from phi_3_vision_mlx_tpu_torch.ops.kernels import flash_attention as K2
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as K3

    dev, f32 = "cuda", torch.float32
    g = torch.Generator(device=dev).manual_seed(5)
    h = kvh = 32
    d = 96
    scale = d**-0.5

    def entry(name, shape, t, lib, bd, ea):
        report[name].setdefault("timings", []).append(
            {"shape": f"fp32 {shape}", **t, "library_ms": lib, **bd, "max_abs_err": ea})
        log(f"{name} fp32 {shape}: max_abs={ea:.3e} (atol {F32_ATOL} + rtol {F32_RTOL}) {t.pop('text')} bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}) library (fp32 SDPA, same mask) {lib:.4f} ms")

    for lq, lk, q_pos0, pads, is_timed in K2_F32_CASES:
        nb = len(pads)
        q = torch.randn((nb, lq, h, d), generator=g, device=dev).transpose(1, 2)
        kk = torch.randn((nb, kvh, lk, d), generator=g, device=dev)
        vv = torch.randn((nb, kvh, lk, d), generator=g, device=dev)
        valid = torch.ones((nb, lk), dtype=torch.bool, device=dev)
        for i, pad in enumerate(pads):
            valid[i, :pad] = False
        out = K2.flash_attention(q, kk, vv, valid, q_pos0, scale)
        ref = K2.flash_attention_plain(q, kk, vv, valid, q_pos0, scale)
        torch.cuda.synchronize()
        ea, er, ok = close(torch, out, ref, F32_ATOL, F32_RTOL)
        if out.dtype != f32 or not ok:
            fail(f"K2 in fp32 disagrees with its plain version at B={nb} lq={lq} lk={lk} q_pos0={q_pos0}: "
                 f"max_abs {ea:.3e}, {out.dtype}")
        shape = f"B={nb} lq={lq} lk={lk} q_pos0={q_pos0} pads={pads} H=32 D=96"
        if not is_timed:
            log(f"K2 fp32 {shape}: max_abs={ea:.3e} (atol {F32_ATOL} + rtol {F32_RTOL})")
            continue
        iters = 12
        t = timed(torch, lambda: K2.flash_attention(q, kk, vv, valid, q_pos0, scale),
                  lambda: K2.flash_attention_plain(q, kk, vv, valid, q_pos0, scale), iters)
        mask = causal_valid_mask(valid, q_pos0 + torch.arange(lq, device=dev))
        keys = min(lk, q_pos0 + lq)
        bd = bound(4 * (2 * q.numel() + 2 * nb * kvh * keys * d) + nb * lk, 4 * h * d * int(mask.sum()),
                   rate=TF32X3_FLOPS)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask, scale=scale),
                      iters)
        entry("K2", shape, t, lib, bd, ea)
        del mask
    del q, kk, vv, out, ref

    nl, b_ = 8, 1  # layers of the stacked cache, rotated so timing reads it cold
    for lmax, lqs, offset_of, row0, label in (
            (128, (1,), lambda lq: 64, 0, "config 1's first decode step"),
            (128, (1,), lambda lq: 127, 0, "config 1's window end"),
            (640, (1, 8), lambda lq: 640 - lq, 0, "window end"),
            (4224, (1, 8), lambda lq: 4224 - lq, 0, "window end"),
            (4352, (1,), lambda lq: 100, 0, "offset 100"),
            (768, (16,), lambda lq: 704, 16, "row0 16")):
        ks = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev)
        vs = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev)
        valid = torch.rand((b_, lmax), generator=g, device=dev) > 0.05
        valid[:, :10] = False  # left padding
        for lq in lqs:
            off = offset_of(lq)
            q = torch.randn((b_, lq, h, d), generator=g, device=dev).transpose(1, 2)
            off_t = dev_offset(torch, off)
            out = K3.dense_kv_attention(q, ks, vs, valid, off_t, nl - 1, scale, row0=row0)
            ref = K3.dense_kv_attention_plain(q, ks, vs, valid, off, nl - 1, scale, row0=row0)
            torch.cuda.synchronize()
            ea, er, ok = close(torch, out, ref, F32_ATOL, F32_RTOL)
            if out.dtype != f32 or not ok:
                fail(f"K3 in fp32 disagrees with its plain version at Lmax={lmax} Lq={lq} offset={off} "
                     f"row0={row0}: max_abs {ea:.3e}")
            nxt = rotating(nl)
            t = timed(torch, lambda: K3.dense_kv_attention(q, ks, vs, valid, off_t, nxt(), scale, row0=row0),
                      lambda: K3.dense_kv_attention_plain(q, ks, vs, valid, off_t, nxt(), scale, row0=row0),
                      20)
            keys = min(lmax, off + row0 + lq)  # the keys some row can see, read once
            q_pos = off + row0 + torch.arange(lq, device=dev)
            mask = causal_valid_mask(valid[:, :keys], q_pos)
            bd = bound(4 * (2 * kvh * keys * d + 2 * h * lq * d) + lmax, 4 * h * d * int(mask.sum()),
                       rate=FP32_FLOPS)

            def library():
                layer = nxt()
                return F.scaled_dot_product_attention(q, ks[layer][:, :, :keys], vs[layer][:, :, :keys],
                                                      attn_mask=mask, scale=scale)

            entry("K3", f"Lq={lq} Lmax={lmax} offset={off} row0={row0} ({label})", t, cuda_ms(torch, library, 20),
                  bd, ea)
        del ks, vs
    for name in ("K2", "K3"):
        fp32 = [t["max_abs_err"] for t in report[name]["timings"] if t["shape"].startswith("fp32")]
        log(f"{name} fp32: max_abs over the timed cases {max(fp32):.3e}")


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
    # Config 5's decode (verify.py): a 32576-token prompt (bucket 32640, left
    # pad 64) in a 32768-position int4 cache, decoded from offset 32640; also
    # the last prompt key's offset and the window's end.  Timed at 32640.
    nl, lmax = 2, LONG_WINDOW
    payload, scales = int4_cache(nl, lmax)
    valid = torch.ones((b_, lmax), dtype=torch.bool, device=dev)
    valid[:, :LONG_PAD] = False
    q = torch.randn((b_, 1, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    for offset in LONG_DECODE_OFFSETS:
        out = KV.quantized_kv_attention(q, payload, scales, valid, dev_offset(torch, offset), nl - 1, scale)
        ref = KV.quantized_kv_attention_plain(q, payload, scales, valid, offset, nl - 1, scale)
        torch.cuda.synchronize()
        ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
        errs.append(ea)
        log(f"K4 Lq=1 Lmax={lmax} offset={offset} pad={LONG_PAD} (config 5's window): max_abs={ea:.3e} "
            f"(atol {ATTN_ATOL} + rtol {ATTN_RTOL:.4f})")
        if not ok:
            fail(f"K4 disagrees with its plain version at Lmax={lmax} Lq=1 offset={offset}")
    offset = LONG_DECODE_OFFSETS[1]
    nxt, end = rotating(nl), dev_offset(torch, offset)
    t = timed(torch, lambda: KV.quantized_kv_attention(q, payload, scales, valid, end, nxt(), scale),
              lambda: KV.quantized_kv_attention_plain(q, payload, scales, valid, end, nxt(), scale), 12)
    keys = offset + 1
    t.update(bound(kvh * keys * (d + 8 * (d // 32)) + lmax + 2 * 2 * h * d, 4 * h * d * (keys - LONG_PAD)),
             library_ms=None)
    shape = f"Lq=1 Lmax={lmax} offset={offset} H=32 D=96 int4 (config 5's first decode step)"
    log(f"K4 {shape}: {t.pop('text')} bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    report["K4"].setdefault("timings", []).append({"shape": shape, **t})
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
    # Config 5's second prefill chunk (q_pos0 16384 over the 32768-position
    # window), held on slices of LONG_SLICE rows: its first rows, the
    # prompt's last rows and the window's last rows.  Timed at the first.
    lk = LONG_WINDOW
    payload, scales = int4_cache(2, lk)
    valid = torch.ones((b_, lk), dtype=torch.bool, device=dev)
    valid[:, :LONG_PAD] = False
    for i, q_pos0 in enumerate(LONG_CHUNK_ROWS):
        q = torch.randn((b_, LONG_SLICE, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
        out = KV.quantized_flash_attention(q, payload, scales, valid, q_pos0, 1, scale)
        ref = KV.quantized_flash_attention_plain(q, payload, scales, valid, q_pos0, 1, scale)
        torch.cuda.synchronize()
        ea, er, ok = close(torch, out, ref, K2_ATOL, ATTN_RTOL)
        errs.append(ea)
        line = (f"K5 lq={LONG_SLICE} lk={lk} q_pos0={q_pos0} pad={LONG_PAD} (config 5's second chunk) int4: "
                f"max_abs={ea:.3e} max(|err| - rtol |ref|)={excess(out, ref):.3e} "
                f"(atol {K2_ATOL} + rtol {ATTN_RTOL:.4f})")
        del ref
        if i == 0:
            t = timed(torch, lambda: KV.quantized_flash_attention(q, payload, scales, valid, q_pos0, 1, scale),
                      lambda: KV.quantized_flash_attention_plain(q, payload, scales, valid, q_pos0, 1, scale), 4)
            pairs = int(causal_valid_mask(valid, q_pos0 + torch.arange(LONG_SLICE, device=dev)).sum())
            keys = q_pos0 + LONG_SLICE
            t.update(bound(kvh * keys * (d + 8 * (d // 32)) + lk + 2 * 2 * q.numel(), 4 * h * d * pairs),
                     library_ms=None)
            line += f" {t.pop('text')} bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
            report["K5"].setdefault("timings", []).append(
                {"shape": f"lq={LONG_SLICE} lk={lk} q_pos0={q_pos0} H=32 D=96 int4 (config 5's second chunk)", **t})
        log(line)
        if not ok:
            fail(f"K5 disagrees with its plain version at lq={LONG_SLICE} lk={lk} q_pos0={q_pos0}")
        del q, out
    del payload, scales
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
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        if e.code >= 500:  # the handler's error, reported as JSON
            fail(f"HTTP {e.code} from the server: {e.read().decode(errors='replace')[:2000]}")
        raise


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
    report["K6"].setdefault("timings", []).append({"shape": shape + " Lq=1", **t})
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
    report["K7"].setdefault("timings", []).append({"shape": shape + " Lq=1 int4", **t})
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
        fn.fp32.launches = 0
    return counters


def phase_paged_profile(torch, lm, proc, report, chunk: int = 8, profiled: int = 4, modes=("eager", "graph")):
    """Steady decode of 4 busy slots over the paged pool, eager and (or,
    ``modes``) through the step's CUDA graph: aggregate tok/s over timed
    chunks, then one profiled chunk (device busy, idle share, kernels per
    step), beside the single-stream figure of this run; the graph's capture
    ms and bytes."""
    from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine

    cache = cache_of(lm)
    prompts = [(FILLER * 6)[: 150 + 150 * i] for i in range(SERVE_SLOTS)]
    single = report.get(f"single_stream_tps_{weights_of(lm)}_{cache}", float("nan"))
    for mode in modes:
        model = eager_twin(lm) if mode == "eager" else lm
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
        log(f"paged decode ({lm.cfg.dtype}, {cache} pool, {mode}, {SERVE_SLOTS} busy slots, window {SERVE_WINDOW}, chunks "
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


# The quantized matmuls' kernels (K1, K8: route A or B and the split sum; K9:
# route B; fp32 route B: wq_tf32_kernel).
MATMUL_KERNELS = ("k1_gemv_kernel", "wq_mma_kernel", "wq_tf32_kernel", "sum_splits_kernel")
# The split-run decode attention's kernels (K4, K6, K7: csrc/split_runs.cuh;
# the fp32 body split_run_tf32_kernel).
SPLIT_RUN_KERNELS = ("split_run_kernel", "split_run_tf32_kernel", "run_combine_kernel")


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


def phase_profile(torch, lm, proc, steps: int = 8, profiled: int = 4, tags=("a", "c")):
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
# Phase 10 (a)'s model: 2 CLIP encoder layers (the penultimate rule runs 1)
# and 1 decoder layer at full width; its processor cuts an image to at most
# 2 x 2 crops (num_crops 4), so the CPU's plain run stays short.
REF_CLIP_LAYERS, REF_DECODER_LAYERS, REF_NUM_CROPS = 2, 1, 4
# Phase 10 (c): the continuous server's slots and window.
VISION_SLOTS, VISION_WINDOW = 4, 4096


def seeded_image(name: str):
    """A seeded uint8 image without Pillow (``utils/media.py:ArrayImage``,
    the duck type ``fetch_image`` and ``Phi3VImageProcessor`` accept)."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch.utils.media import ArrayImage

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
    image features, then ``compare_with_cpu`` with the dense cache, for a
    landscape and a portrait image, and with the int4 cache for the
    landscape one."""
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
        for quantized in (False, True) if name == "landscape" else (False,):  # the int4 cache: one image
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


# --- Phase 11: sampling and speculation --------------------------------------

SPEC_K = 7  # drafts a verify pass: Lq = 8 query rows in K3/K4/K6/K7
# The sampler of phase 11 (a) and (c): temperature, top_p, top_k, min_p.
SAMPLER = (0.8, 0.9, 50, 0.05)
SAMPLE_KW = dict(sample=True, temperature=0.8, top_p=0.9, top_k=50, min_p=0.05)
# Random weights settle into loops, and a repetitive prompt gives the n-gram
# lookup drafts that match them; PROMPT_A is the non-repetitive one.
LOOP_PROMPT = "Count with me: " + "one two three four five six seven eight nine ten. " * 8
SPEC_PROMPTS = {"loop": LOOP_PROMPT, "plain": PROMPT_A}
SPEC_BUDGET = 96
# Phase 11 (b) at the first token where speculation and vanilla greedy part
# (a near tie: the vanilla step's route A at one row and the pass's route B
# at K + 1 rows round bf16 apart; on the TPU the JAX package pads both to
# one 8-row tile).  Both paths' logits over the vanilla prefix must agree
# within SPEC_ROUTE_REL_L2: phase 3 measured 8.4e-3 relative L2 between two
# devices through 2 layers of bf16, and the difference grows with depth (an
# H100 run of this phase measured 2.6e-2 at 32 layers); a pass that reads a
# wrong key or position moves the logits by O(1).  The vanilla step's
# top-two gap must be at most NEAR_TIE_ULPS bf16 ulps of its top logit (the
# lm_head's output is bf16) and within twice the change of those two
# tokens' log-probs between the paths.
SPEC_ROUTE_REL_L2 = 0.1
NEAR_TIE_ULPS = 4
SPEC_ITERS = 16  # verify passes a chunk of phase 11 (b)'s own runs


class RowsSeen:
    """Wrap kernel wrappers of a module so that every call (eager, a
    graph's warm-up or its capture: a replay calls no Python) records the
    query rows it was given; the wrapped functions still count their own
    launches."""

    def __init__(self, module, names):
        self.module, self.saved, self.rows = module, {}, {n: set() for n in names}
        self.row0s = {n: set() for n in names}  # the launches' first rows in their pass
        for name in names:
            fn = getattr(module, name)
            self.saved[name] = fn

            def wrapper(q, *a, _fn=fn, _name=name, **kw):
                self.rows[_name].add(int(q.shape[2]))
                self.row0s[_name].add(int(kw.get("row0", 0)))
                return _fn(q, *a, **kw)

            setattr(module, name, wrapper)

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def sampling_functions_check(torch):
    """The sampling functions on the card against themselves on the CPU,
    given the same logits and noise: the filters' kept sets, the per-row
    draws and the verification's tokens and acceptance counts.  Rows with a
    token whose preceding mass lies within 1e-6 of ``top_p`` (the two
    devices' sums may round across it) are left out and counted."""
    from phi_3_vision_mlx_tpu_torch.engine.engine import filter_sample_logits_rows, sample_token_rows
    from phi_3_vision_mlx_tpu_torch.engine.rng import SAMPLE, NoiseGen
    from phi_3_vision_mlx_tpu_torch.engine.speculative import verify_mixed_rows, verify_noise

    v, k = 32064, SPEC_K
    g = torch.Generator().manual_seed(11)
    logits = 3 * torch.randn((8, k + 1, v), generator=g)
    draft = torch.randint(0, v, (8, k), generator=g)
    draft[:, 0] = logits[:, 0].argmax(-1)  # some drafts the target likes
    knobs = (torch.tensor([0.0, 0.8, 1.0, 1.3, 0.8, 0.5, 2.0, 0.8]),
             torch.tensor([1.0, 0.9, 0.5, 0.95, 1.0, 0.3, 0.99, 0.9]),
             torch.tensor([0, 50, 0, 5, 0, 0, 1000, 50]),
             torch.tensor([0.0, 0.05, 0.0, 0.1, 0.2, 0.0, 0.0, 0.05]))
    gens = {dev: NoiseGen(8, dev) for dev in ("cpu", "cuda")}
    for gen in gens.values():
        gen.reset(range(100, 108))
    bits = {dev: gen.bits(SAMPLE, (v,)) for dev, gen in gens.items()}
    if not torch.equal(bits["cpu"], bits["cuda"].cpu()):
        fail("the noise generator's bits differ between the card and the CPU")
    noise = (gens["cpu"].gumbel(SAMPLE, (v,)), *verify_noise(gens["cpu"], k, v))
    gum_err = (gens["cuda"].gumbel(SAMPLE, (v,)).cpu() - noise[0]).abs().max().item()
    res = {}
    for dev in ("cpu", "cuda"):
        to = lambda t: t.to(dev)  # noqa: E731
        kn = tuple(map(to, knobs))
        kept = torch.isfinite(filter_sample_logits_rows(to(logits), *kn)).cpu()
        tok = sample_token_rows(to(logits[:, 0]), to(noise[0]), *kn).cpu()
        out, acc = verify_mixed_rows(to(logits), to(draft), tuple(map(to, noise[1:])), *kn)
        res[dev] = (kept, tok, out.cpu(), acc.cpu())
    scaled = logits / knobs[0].clamp(min=1e-6)[:, None, None]
    probs = torch.softmax(torch.sort(scaled, dim=-1, descending=True).values, dim=-1)
    margin = ((probs.cumsum(-1) - probs) - knobs[1][:, None, None]).abs().amin(-1).amin(-1)
    near = margin < 1e-6
    same = [all(torch.equal(a[r], b[r]) for a, b in zip(res["cpu"], res["cuda"])) for r in range(8)]
    log(f"phase 11 (a) sampling functions, card vs CPU (8 rows x {k + 1} positions x {v}, the same "
        f"logits and noise): bits of the generator bitwise equal; Gumbel noise within {gum_err:.2e}; "
        f"kept sets, draws, verified tokens and acceptance equal in {sum(same)} of 8 rows, "
        f"{int(near.sum())} rows left out at a top-p near tie")
    if not all(s or n for s, n in zip(same, near.tolist())):
        fail("the sampling functions on the card differ from the CPU's on the same logits and noise")


def sampled_run(torch, lm, dict_input, budget: int, chunks, sampler, seed: int):
    """Prefill and ``chunks`` of steps, sampled under ``sampler`` (None:
    greedy): the first token and the chunks' tokens, max and EOS log-probs
    as host arrays."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch.engine.engine import prefill_decoder, release_decoder

    dec, first = prefill_decoder(lm, dict_input, budget, sampler=sampler, seed=seed)
    rows = [tuple(t.cpu().numpy().copy() for t in dec.chunk(n)) for n in chunks]  # the ring is reused
    release_decoder(lm, dec)
    return [first.cpu().numpy()] + [np.concatenate(parts) for parts in zip(*rows)]


def top_k_one(torch, lm, dict_input, label: str, budget: int = 64) -> None:
    """``top_k = 1`` keeps every token whose logit equals the largest (the
    JAX filter's ``>=``), so it draws the greedy stream up to the first
    step whose top logit is tied in bf16, where it may take another of the
    tied tokens; that step's logits must show the tie."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch.engine.engine import prefill_decoder, release_decoder, run_prefill
    from phi_3_vision_mlx_tpu_torch.models import phi3

    chunks = (8, 32, budget - 41)
    greedy = np.concatenate([a.reshape(-1) for a in sampled_run(torch, lm, dict_input, budget, chunks,
                                                                None, 0)[:2]])
    drawn = np.concatenate([a.reshape(-1) for a in sampled_run(torch, lm, dict_input, budget, chunks,
                                                               (1.0, 1.0, 1, 0.0), 3)[:2]])
    diff = np.flatnonzero(greedy != drawn)
    tie = "none"
    if len(diff):
        d = int(diff[0])
        if d == 0:
            logits = run_prefill(lm, dict_input, budget)[0][0]
        else:
            dec, _ = prefill_decoder(lm, dict_input, budget)
            if d > 1:
                dec.chunk(d - 1)
            with torch.no_grad():
                logits = phi3.decode_forward(lm.params, lm.cfg, dec.state, dec.token,
                                             advance=0).logits[0, -1].float()
            release_decoder(lm, dec)
        top = logits.max()
        tie = (f"at token {d}: logits of the greedy token {logits[greedy[d]].item():.6f} and the drawn "
               f"{logits[drawn[d]].item():.6f}, top {top.item():.6f}")
        if logits[greedy[d]] != top or logits[drawn[d]] != top:
            fail(f"phase 11 (a) ({label}): top_k=1 parts from greedy at token {d} without a tie")
    log(f"phase 11 (a) top_k=1 against greedy ({label}, {budget} tokens): equal up to "
        f"{int(diff[0]) if len(diff) else budget}; first tie {tie}")


def graph_step_profile(torch, chunk, steps: int, profiled: int):
    """(wall ms per step over ``steps`` ending in one device-to-host copy,
    device busy ms per step, kernels per step) of ``chunk(n)``, which runs
    n steps (or verify passes) and returns the ring's views."""
    chunk(2)  # warm-up (and capture)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = chunk(steps)
    rows[0].cpu()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    per_name, launches = kernel_times(torch, lambda: chunk(profiled), profiled)
    busy = sum(per_name.values())
    if busy <= 0:
        fail("phase 11: the profiler saw no device time")
    return wall, busy, launches / profiled


def phase_sampling(torch, lm, proc, report):
    """Phase 11 (a): sampled single-stream decoding, graph against eager
    bitwise, the same seed twice, top_k = 1 against greedy, and the sampled
    step's device time and nodes beside the greedy step's."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine.engine import prefill_decoder, release_decoder

    cache = cache_of(lm)
    label = f"{weights_of(lm)} weights, {cache} cache"
    dict_input = proc(api._apply_chat_template(PROMPT_A)[0])
    runs = {}
    for mode, model, seed in (("eager", eager_twin(lm), 5), ("graph", lm, 5), ("graph again", lm, 5),
                              ("graph, seed 6", lm, 6)):
        runs[mode] = sampled_run(torch, model, dict_input, 64, (8, 32, 23), SAMPLER, seed)
    same = lambda a, b: all(np.array_equal(x, y) for x, y in zip(runs[a], runs[b]))  # noqa: E731
    other = not np.array_equal(runs["graph"][1], runs["graph, seed 6"][1])
    log(f"phase 11 (a) sampled decoding ({label}, sampler {SAMPLER}, 64 tokens): graph == eager bitwise "
        f"(tokens, max and EOS log-probs) {same('graph', 'eager')}; the same seed again "
        f"{same('graph', 'graph again')}; seed 6 gives another stream {other}")
    if not same("graph", "eager") or not same("graph", "graph again") or not other:
        fail(f"phase 11 (a) ({label}): sampled graph and eager streams, or the same seed twice, differ")
    kw = dict(preload=(lm, proc), max_tokens=48, verbose=False, stream=False, mute=True)
    texts = {mode: api.generate(PROMPT_A, **kw, **extra) for mode, extra in (
        ("greedy", {}), ("sampled", dict(SAMPLE_KW, seed=5)), ("sampled again", dict(SAMPLE_KW, seed=5)))}
    eager_text = api.generate(PROMPT_A, **dict(kw, preload=(eager_twin(lm), proc)), **SAMPLE_KW, seed=5)
    log(f"phase 11 (a) api.generate ({label}): sampled graph == eager {texts['sampled'] == eager_text}; "
        f"same seed twice {texts['sampled'] == texts['sampled again']}; sampled != greedy "
        f"{texts['sampled'] != texts['greedy']}")
    if texts["sampled"] != eager_text or texts["sampled"] != texts["sampled again"]:
        fail(f"phase 11 (a) ({label}): api.generate's sampled text is not reproducible")
    top_k_one(torch, lm, dict_input, label)
    cols = {}
    for mode, sampler in (("greedy", None), ("sampled", SAMPLER)):
        dec, _ = prefill_decoder(lm, dict_input, 512, sampler=sampler, seed=5)
        cols[mode] = graph_step_profile(torch, dec.chunk, 16, 4)
        release_decoder(lm, dec)
    (gw, gb, gn), (sw, sb, sn) = cols["greedy"], cols["sampled"]
    log(f"phase 11 (a) decode step ({label}, window 768, graphs): greedy wall {gw:.3f} ms, busy {gb:.3f} "
        f"ms, idle share {1 - gb / gw:.3f}, {gn:.0f} nodes; sampled wall {sw:.3f} ms, busy {sb:.3f} ms, "
        f"idle share {1 - sb / sw:.3f}, {sn:.0f} nodes (+{sn - gn:.0f}) on {report['card']}")


def spec_run(torch, lm, dict_input, budget: int, accept: bool, oracle=None, k: int = SPEC_K):
    """Single-stream speculation as ``generate_text`` runs it (passes while
    the window holds one, then vanilla steps), without stoppers: the
    emitted tokens with their max and EOS log-probs, passes that emitted,
    dead passes, and tok/s after the prefill (host clock, synchronized).
    ``oracle``: tokens written into the token history over the prompt's
    last columns, where the n-gram lookup finds them (the history only
    proposes drafts; verification decides what is emitted)."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch.engine.engine import (pad_prompt_inputs, prefill_decoder,
                                                          release_decoder)

    dec, first = prefill_decoder(lm, dict_input, budget)
    spec = dec.spec_pass(k)
    ids = pad_prompt_inputs(dict_input, dec.state.offset)[0]
    if oracle is not None:
        ids = ids.copy()
        ids[0, -1 - len(oracle):-1] = oracle
    spec.start(ids, accept=accept)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, maxlp, eoslp = [int(first[0, 0])], [], []
    passes = dead = 0
    while len(toks) < budget:
        st = dec.state
        if st.window - st.offset >= k + 1:
            left = budget - len(toks)
            n = spec.passes_for(left, SPEC_ITERS)
            t, m, e, n_emit = (x.cpu().numpy() for x in spec.chunk(n, left))
            dec.advance_mirror(int(n_emit.sum()))
            for i in range(n):
                c = int(n_emit[i, 0])
                passes, dead = passes + (c > 0), dead + (c == 0)
                toks += t[i, 0, :c].tolist()
                maxlp += m[i, 0, :c].tolist()
                eoslp += e[i, 0, :c].tolist()
            continue
        t, m, e = (x.cpu().numpy() for x in dec.chunk(min(8, budget - len(toks))))
        toks += t[:, 0].tolist()
        maxlp += m[:, 0].tolist()
        eoslp += e[:, 0].tolist()
    rate = (len(toks) - 1) / (time.perf_counter() - t0)
    release_decoder(lm, dec)
    n = budget
    return (np.array(toks[:n]), np.array(maxlp[: n - 1]), np.array(eoslp[: n - 1]), passes, dead,
            rate)


def near_tie(torch, lm, dict_input, budget: int, vanilla, spec, d: int):
    """At the first token ``d`` where speculation and vanilla greedy part:
    over the vanilla prefix, the log-probs of the vanilla step (route A,
    one row) and of a verify pass's row 0 (route B, K + 1 rows).  Returns
    (relative L2 of the two logit rows, the vanilla step's top-two gap,
    twice the larger change of the two tokens' log-probs, one bf16 ulp of
    the top logit)."""
    from phi_3_vision_mlx_tpu_torch.engine.engine import prefill_decoder, release_decoder
    from phi_3_vision_mlx_tpu_torch.engine.speculative import verify_columns
    from phi_3_vision_mlx_tpu_torch.models import phi3

    dec, _ = prefill_decoder(lm, dict_input, budget)
    if d > 1:
        dec.chunk(d - 1)
    st = dec.state
    with torch.no_grad():
        one = phi3.decode_forward(lm.params, lm.cfg, st, dec.token, advance=0).logits[0, -1].float()
        ids = torch.cat([dec.token, dec.token.new_zeros((1, SPEC_K))], dim=1)
        _, cols, _ = verify_columns(st.pos.long(), SPEC_K + 1, st.window)
        many = phi3.decode_forward(lm.params, lm.cfg, st, ids, advance=0,
                                   positions=cols[0]).logits[0, 0].float()
    release_decoder(lm, dec)
    lp1, lp8 = torch.log_softmax(one, -1), torch.log_softmax(many, -1)
    a, b = int(lp1.argmax()), int(spec[d])
    rel = ((one - many).norm() / one.norm()).item()
    gap = (lp1[a] - lp1[b]).item()
    moved = 2 * max(abs((lp1[a] - lp8[a]).item()), abs((lp1[b] - lp8[b]).item()))
    ulp = 2.0 ** (math.floor(math.log2(abs(one.max().item()))) - 7)
    if a != int(vanilla[d]):
        fail(f"phase 11 (b): the replayed vanilla step gives token {a}, the stream {int(vanilla[d])}")
    return rel, gap, moved, ulp


def phase_spec_single(torch, lm, proc, report):
    """Phase 11 (b): single-stream speculation at K = 7 on a looping and a
    plain prompt: the stream against its forced-reject baseline through the
    same graph (bitwise) and against vanilla greedy (to the first token
    where they part, a near tie: there both paths' logits over the vanilla
    prefix agree to REF_REL_L2, and the vanilla step's top-two gap is within
    twice the change of the two tokens' log-probs); the launches of the
    passes (K3 or K4 at Lq = 8); tok/s against vanilla."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.models import phi3

    cache = cache_of(lm)
    label = f"{weights_of(lm)} weights, {cache} cache"
    attn = "K4" if cache == "int4" else "K3"
    seen = RowsSeen(phi3, ("dense_kv_attention", "quantized_kv_attention"))
    try:
        for tag, prompt in SPEC_PROMPTS.items():
            dict_input = proc(api._apply_chat_template(prompt)[0])
            out = sampled_run(torch, lm, dict_input, SPEC_BUDGET, (8, 32, SPEC_BUDGET - 41), None, 0)
            vanilla = np.concatenate([out[0][:, 0], out[1][:, 0]])
            spec_run(torch, lm, dict_input, 16, False)  # a new key's first pass captures its graph
            counters = zero_counters()
            acc = spec_run(torch, lm, dict_input, SPEC_BUDGET, True)
            launches = {n: fn.launches for n, fn in counters.items()}
            forced = spec_run(torch, lm, dict_input, SPEC_BUDGET, False)
            # Drafts that verification accepts: the forced-reject stream
            # itself, seeded into the history.
            oracle = spec_run(torch, lm, dict_input, SPEC_BUDGET, True, oracle=forced[0])
            oracle_forced = spec_run(torch, lm, dict_input, SPEC_BUDGET, False, oracle=forced[0])
            same = all(np.array_equal(x, y) for x, y in zip(acc[:3], forced[:3]))
            same_oracle = all(np.array_equal(x, y) for r in (oracle, oracle_forced)
                              for x, y in zip(r[:3], forced[:3]))
            diff = np.flatnonzero(acc[0] != vanilla)
            per = lambda r: (f"{r[3]} passes ({(SPEC_BUDGET - 1) / r[3]:.2f} tokens a pass, "  # noqa: E731
                             f"{r[4]} dead, {r[5]:.2f} tok/s)")
            log(f"phase 11 (b) speculation ({label}, {tag} prompt, K={SPEC_K}, {SPEC_BUDGET} tokens): "
                f"{per(acc)}; forced-reject baseline {per(forced)}; stream == forced-reject bitwise "
                f"(tokens, max and EOS log-probs) {same}; with the forced-reject stream seeded as drafts "
                f"{per(oracle)}, its forced-reject run {per(oracle_forced)}, both == forced-reject bitwise "
                f"{same_oracle}; tokens equal to vanilla greedy up to {diff[0] if len(diff) else SPEC_BUDGET} "
                f"of {SPEC_BUDGET}; launches of the accepting run {launches} on {report['card']}")
            if not same or not same_oracle or oracle[3] >= forced[3]:
                fail(f"phase 11 (b) ({label}, {tag}): speculation differs from its forced-reject baseline "
                     "(or seeded drafts were never accepted)")
            if launches[attn] <= 0 or launches["K1"] <= 0:
                fail(f"phase 11 (b) ({label}, {tag}): K1 or {attn} never launched in the passes")
            log(f"phase 11 (b) ({label}, {tag}): vanilla greedy {len(set(vanilla.tolist()))} distinct "
                f"tokens of {SPEC_BUDGET}: {vanilla.tolist()}")
            if len(diff):
                rel, gap, moved, ulp = near_tie(torch, lm, dict_input, SPEC_BUDGET, vanilla, acc[0],
                                                int(diff[0]))
                log(f"phase 11 (b) ({label}, {tag}): at token {diff[0]} the two paths' logits over the "
                    f"vanilla prefix differ by {rel:.2e} relative L2 (limit {SPEC_ROUTE_REL_L2}); the "
                    f"vanilla step's gap between its token and speculation's {gap:.4f} (limit "
                    f"{NEAR_TIE_ULPS} bf16 ulps of its top logit, {NEAR_TIE_ULPS * ulp:.4f}), twice the "
                    f"change of those log-probs {moved:.4f}")
                if rel > SPEC_ROUTE_REL_L2 or gap > min(moved, NEAR_TIE_ULPS * ulp):
                    fail(f"phase 11 (b) ({label}, {tag}): speculation parts from vanilla greedy at token "
                         f"{diff[0]} beyond a near tie")
        if SPEC_K + 1 not in seen.rows[{"K3": "dense_kv_attention", "K4": "quantized_kv_attention"}[attn]]:
            fail(f"phase 11 (b) ({label}): {attn} never saw Lq = {SPEC_K + 1}: {seen.rows}")
        log(f"phase 11 (b) ({label}): query rows given to K3 / K4: {seen.rows}")
    finally:
        seen.restore()

    def tps(**extra):
        """Decode tok/s of api.generate on the looping prompt (128 tokens,
        graphs; the second of two runs: the first may capture) and the
        speculation's counts."""
        for _ in range(2):
            _, rate = api.generate(LOOP_PROMPT, preload=(lm, proc), max_tokens=128, verbose=False,
                                   stream=False, mute=True, return_tps=True, **extra)
        return rate, dict(lm._spec_stats) if extra.get("speculative") else ""

    rates = {what: tps(**extra) for what, extra in (
        ("speculative", dict(speculative=True)), ("vanilla", dict(speculative=False)),
        ("sampled speculative", dict(SAMPLE_KW, seed=5, speculative=True)),
        ("sampled", dict(SAMPLE_KW, seed=5, speculative=False)))}
    log(f"phase 11 (b) tok/s ({label}, looping prompt, 128 tokens, graphs): "
        + "; ".join(f"{what} {rate:.2f} {stats}" for what, (rate, stats) in rates.items())
        + f" on {report['card']}")


def phase_spec_profile(torch, lm, proc, report):
    """Phase 11 (b): one verify pass's wall, device busy and nodes at the
    window of 768 (graphs), beside the decode step of (a)."""
    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine.engine import (pad_prompt_inputs, prefill_decoder,
                                                          release_decoder)

    cache = cache_of(lm)
    dict_input = proc(api._apply_chat_template(PROMPT_A)[0])
    dec, _ = prefill_decoder(lm, dict_input, 512)
    spec = dec.spec_pass(SPEC_K)
    spec.start(pad_prompt_inputs(dict_input, dec.state.offset)[0])
    wall, busy, nodes = graph_step_profile(torch, lambda n: spec.chunk(n, 1 << 20), 16, 4)
    release_decoder(lm, dec)
    log(f"phase 11 (b) verify pass ({weights_of(lm)} weights, {cache} cache, K={SPEC_K}, window 768, "
        f"graphs): wall {wall:.3f} ms, busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, {nodes:.0f} "
        f"nodes a pass on {report['card']}")


def phase_spec_server(torch, lm, proc, report, paged: bool, pool_pages: int = 0):
    """Phase 11 (c): the continuous server with ``--spec-k 7`` (4 slots,
    window 1024), six concurrent requests, three greedy and three sampled;
    with ``pool_pages`` a pool that must preempt.  The counters show K6
    (dense pool) or K7 (int4 pool) launched, at Lq = 8."""
    from http.server import ThreadingHTTPServer

    from phi_3_vision_mlx_tpu_torch.engine import paging
    from phi_3_vision_mlx_tpu_torch.serve.server import ContinuousScheduler, make_continuous_handler

    cache = cache_of(lm)
    where = (f"{cache} pool of {pool_pages or 'all'} pages" if paged else f"{cache} slot cache")
    tag = f"phase 11 (c) continuous, --spec-k {SPEC_K} ({weights_of(lm)} weights, {where})"
    paged_attn = "K7" if cache == "int4" else "K6"
    if pool_pages:
        requests = [((FILLER * 3)[: 260 + 10 * i], 192 + 16 * (i % 5)) for i in range(6)]
    else:
        requests = [((FILLER * 6)[: 100 + 120 * i], (64, 200, 120, 90, 160, 100)[i]) for i in range(6)]
    bodies = [dict({"prompt": p, "max_tokens": n},
                   **({} if i % 2 == 0 else {"temperature": 0.8, "top_p": 0.9, "top_k": 50, "min_p": 0.05,
                                             "seed": i}))
              for i, (p, n) in enumerate(requests)]
    seen = RowsSeen(paging, ("paged_kv_attention", "paged_quantized_kv_attention"))
    counters = zero_counters()
    try:
        kw = dict(pool_pages=pool_pages) if paged else {}
        sched = ContinuousScheduler(lm, proc, slots=SERVE_SLOTS, window=SERVE_WINDOW, paged=paged,
                                    spec_k=SPEC_K, **kw)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_continuous_handler(sched))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        results = {}

        def worker(i, body):
            results[i] = post(httpd.server_address[1], body)

        try:
            t0 = time.perf_counter()
            posts = [threading.Thread(target=worker, args=(i, b)) for i, b in enumerate(bodies)]
            for t in posts:
                t.start()
            for t in posts:
                t.join(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
    finally:
        seen.restore()
    launches = {name: fn.launches for name, fn in counters.items()}
    eng = sched.engine
    for i in range(len(bodies)):
        status, payload = results.get(i, (None, {}))
        resp = payload.get("responses")
        if status != 200 or not isinstance(resp, list) or not resp or not resp[0]:
            fail(f"{tag}: request {i}: status {status}, payload {str(payload)[:200]}")
    tokens = sum(len(r.tokens) for r in eng.requests.values())
    st = eng.spec_stats
    log(f"{tag}: 6 requests (3 greedy, 3 sampled) all HTTP 200; {tokens} tokens in {wall:.2f} s; "
        f"{st['passes']} slot passes emitted {st['emitted']} ({st['emitted'] / max(st['passes'], 1):.2f} a "
        f"pass); preemptions {getattr(eng, 'preemptions', 0)}; launches {launches}; query rows given to "
        f"K6 / K7: {seen.rows}")
    if paged:
        name = {"K6": "paged_kv_attention", "K7": "paged_quantized_kv_attention"}[paged_attn]
        if launches[paged_attn] <= 0 or SPEC_K + 1 not in seen.rows[name]:
            fail(f"{tag}: {paged_attn} was not launched at Lq = {SPEC_K + 1}")
    if pool_pages and eng.preemptions <= 0:
        fail(f"{tag}: the pool never preempted")
    if st["passes"] <= 0:
        fail(f"{tag}: no verify pass emitted")


def phase_spec_busy(torch, lm, proc, report, chunk: int = 8):
    """Phase 11 (c): aggregate tok/s of 4 busy slots over the paged pool,
    greedy, with and without speculation, and one profiled chunk each."""
    from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine

    cache = cache_of(lm)
    prompts = [(LOOP_PROMPT + FILLER)[: 100 + 100 * i] for i in range(SERVE_SLOTS)]
    for spec_k in (0, SPEC_K):
        eng = PagedBatchEngine(lm, proc, slots=SERVE_SLOTS, window=SERVE_WINDOW, spec_k=spec_k)
        eng.capture()
        for p in eng.prepare_many(prompts, [dict(max_tokens=400)] * SERVE_SLOTS):
            eng.admit(p)
        eng.step(2)  # warm-up
        torch.cuda.synchronize()
        before = sum(len(r.tokens) for r in eng.requests.values())
        t0 = time.perf_counter()
        for _ in range(4):
            eng.step_pipelined(chunk)
        eng.flush()
        wall = time.perf_counter() - t0
        made = sum(len(r.tokens) for r in eng.requests.values()) - before
        busy_slots = len(eng.by_slot)
        per_name, launches = kernel_times(torch, lambda: eng.step(2), 2)
        busy = sum(per_name.values())
        what = f"verify passes of K={spec_k}" if spec_k else "greedy steps"
        log(f"phase 11 (c) 4 busy slots ({weights_of(lm)} weights, {cache} pool, window {SERVE_WINDOW}, "
            f"{what}, chunks of {chunk}): {made / wall:.2f} tok/s aggregate ({made} tokens in {wall:.3f} s, "
            f"{busy_slots} slots still busy); device busy {busy:.3f} ms and {launches / 2:.0f} kernels a "
            f"step or pass on {report['card']}")
        del eng
        torch.cuda.empty_cache()


def phase_spec_kernels(torch, report):
    """Phase 11 (d): each verify shape of the slice against its plain
    version, timed beside its bound and a library call: K1 (route B) at M =
    8 and 32 on qkv and lm_head, K3 and K4 at Lq = 8 at the windows 768 and
    4352 (the pass at the window's end), K6 and K7 at Lq = 8 at the
    continuous server's shapes."""
    import random

    import torch.nn.functional as F

    from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig
    from phi_3_vision_mlx_tpu_torch.core.weights import WORD
    from phi_3_vision_mlx_tpu_torch.engine.state import quantize_chunk
    from phi_3_vision_mlx_tpu_torch.ops.attention import causal_valid_mask
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as KV
    from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as K1

    dev, lq = "cuda", SPEC_K + 1
    g = torch.Generator(device=dev).manual_seed(14)
    for k, n in ((3072, 9216), (3072, 32064)):
        nbytes = k * n // 2 + 4 * (k // 64) * n
        ws = []
        for _ in range(max(1, math.ceil(150e6 / nbytes))):
            qw = torch.randint(-(2**31), 2**31, (k // WORD, n), dtype=torch.int32, generator=g, device=dev)
            ws.append((qw, *w4_planes(torch, k, n, g)))
        for m in (lq, SERVE_SLOTS * lq):
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            ref = K1.quant_matmul_plain(x, *ws[0], out_dtype=torch.float32)
            ea, er, ok, same = w4_check(torch, lambda **kw: K1.quant_matmul(x, *ws[0], **kw), ref, None)
            log(f"phase 11 (d) K1 K={k} N={n} M={m} route {K1.route(m, 'k1')}: max_abs={ea:.3e} "
                f"max_rel={er:.3e}; repeat bit-identical {same}")
            if not ok or not same:
                fail(f"K1 disagrees with its plain version at the verify shape K={k} N={n} M={m}")
            report["K1"]["max_abs_err"] = max(report["K1"]["max_abs_err"], ea)
            w4_timing(torch, "K1", lambda w: K1.quant_matmul(x, *w), lambda w: K1.quant_matmul_plain(x, *w),
                      ws, x, k, n, m, g, report)
        del ws

    b_, h, kvh, d, nl = 1, 32, 32, 96, 4
    scale = d**-0.5
    kvq = KVQuantConfig(group_size=32, bits=4)
    for lmax in (768, 4352):
        off = lmax - lq  # the window's last pass
        q = torch.randn((b_, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
        valid = torch.ones((b_, lmax), dtype=torch.bool, device=dev)
        valid[:, :17] = False
        mask = causal_valid_mask(valid, off + torch.arange(lq, device=dev))
        pairs = int(mask.sum())
        ks = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev).to(torch.bfloat16)
        vs = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev).to(torch.bfloat16)
        off_t, nxt = dev_offset(torch, off), rotating(nl)
        out = KV.dense_kv_attention(q, ks, vs, valid, off_t, 1, scale)
        ref = KV.dense_kv_attention_plain(q, ks, vs, valid, off, 1, scale)
        torch.cuda.synchronize()
        ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
        if not ok:
            fail(f"K3 disagrees with its plain version at Lq={lq} Lmax={lmax} offset={off}")
        report["K3"]["max_abs_err"] = max(report["K3"]["max_abs_err"], ea)
        t = timed(torch, lambda: KV.dense_kv_attention(q, ks, vs, valid, off_t, nxt(), scale),
                  lambda: KV.dense_kv_attention_plain(q, ks, vs, valid, off_t, nxt(), scale), 20)

        def library():  # SDPA with the causal-offset mask computes the same function
            layer = nxt()
            return F.scaled_dot_product_attention(q, ks[layer], vs[layer], attn_mask=mask, scale=scale)

        t.update(bound(2 * 2 * kvh * lmax * d + lmax + 2 * 2 * h * lq * d, 4 * h * d * pairs),
                 library_ms=cuda_ms(torch, library, 20))
        shape = f"Lq={lq} Lmax={lmax} offset={off} H=32 D=96 (verify pass)"
        log(f"phase 11 (d) K3 {shape}: max_abs={ea:.3e}; bound {t['bound_ms']:.4f} ms ({t['bound_by']}) "
            f"{t.pop('text')}; library (SDPA, causal-offset mask) {t['library_ms']:.4f} ms")
        report["K3"]["timings"].append({"shape": shape, **t})
        del ks, vs
        k_ = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev) + KV_MEAN[0]
        v_ = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev) + KV_MEAN[1]
        payload, scales = quantize_chunk(k_.to(torch.bfloat16), v_.to(torch.bfloat16), kvq)
        del k_, v_
        out = KV.quantized_kv_attention(q, payload, scales, valid, off_t, 1, scale)
        ref = KV.quantized_kv_attention_plain(q, payload, scales, valid, off, 1, scale)
        torch.cuda.synchronize()
        ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
        if not ok:
            fail(f"K4 disagrees with its plain version at Lq={lq} Lmax={lmax} offset={off}")
        report["K4"]["max_abs_err"] = max(report["K4"]["max_abs_err"], ea)
        t = timed(torch, lambda: KV.quantized_kv_attention(q, payload, scales, valid, off_t, nxt(), scale),
                  lambda: KV.quantized_kv_attention_plain(q, payload, scales, valid, off_t, nxt(), scale), 20)
        t.update(bound(kvh * lmax * (d + 8 * (d // 32)) + lmax + 2 * 2 * h * lq * d, 4 * h * d * pairs),
                 library_ms=None)
        shape = f"Lq={lq} Lmax={lmax} offset={off} H=32 D=96 int4 (verify pass)"
        log(f"phase 11 (d) K4 {shape}: max_abs={ea:.3e}; bound {t['bound_ms']:.4f} ms ({t['bound_by']}) "
            f"{t.pop('text')}")
        report["K4"]["timings"].append({"shape": shape, **t})
        del payload, scales

    # K6 / K7 at the continuous server's shapes (phase 2's), Lq = 8.
    s_, page, window, pool = SERVE_SLOTS, 64, SERVE_WINDOW, 64
    offsets_l = (100, 400, 700, 1000)
    rng = random.Random(14)
    ids = rng.sample(range(pool), pool)
    tables = torch.full((s_, window // page), pool, dtype=torch.int32)
    for i, o in enumerate(offsets_l):
        cnt = min(-(-(o + lq) // page), window // page)
        tables[i, :cnt] = torch.tensor([ids.pop() for _ in range(cnt)])
    tables, offsets = tables.to(dev), torch.tensor(offsets_l, dtype=torch.int32, device=dev)
    valid = torch.rand((s_, window), generator=g, device=dev) > 0.05
    valid[:, :10] = False
    vis = KV.paged_visible(valid, offsets, lq)
    q = torch.randn((s_, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    keys = sum(min(o + lq, window) for o in offsets_l)
    shape = f"S=4 offsets {','.join(map(str, offsets_l))} window 1024 page 64 Lq={lq} (verify pass)"
    pk = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev).to(torch.bfloat16)
    pv = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev).to(torch.bfloat16)
    k_ = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev) + KV_MEAN[0]
    v_ = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev) + KV_MEAN[1]
    qpools = quantize_chunk(k_.to(torch.bfloat16), v_.to(torch.bfloat16), kvq)
    del k_, v_
    wins = [(KV.gather_pages(pk[i], tables), KV.gather_pages(pv[i], tables)) for i in range(nl)]
    for name, kernel, plain, pools, per_key in (
            ("K6", KV.paged_kv_attention, KV.paged_kv_attention_plain, (pk, pv), 2 * 2 * d),
            ("K7", KV.paged_quantized_kv_attention, KV.paged_quantized_kv_attention_plain, qpools,
             d + 8 * (d // 32))):
        out = kernel(q, *pools, tables, valid, offsets, nl - 1, scale)
        ref = plain(q, *pools, tables, valid, offsets, nl - 1, scale)
        torch.cuda.synchronize()
        ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
        if not ok:
            fail(f"{name} disagrees with its plain version at Lq={lq}")
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], ea)
        nxt = rotating(nl)
        t = timed(torch, lambda: kernel(q, *pools, tables, valid, offsets, nxt(), scale),
                  lambda: plain(q, *pools, tables, valid, offsets, nxt(), scale), 20)
        lib = None
        if name == "K6":
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, *wins[nxt()], attn_mask=vis, scale=scale), 20)
        nbytes = kvh * keys * per_key + s_ * window + 4 * tables.numel() + 2 * 2 * s_ * h * lq * d
        t.update(bound(nbytes, 4 * h * d * int(vis.sum())), library_ms=lib)
        log(f"phase 11 (d) {name} {shape}: max_abs={ea:.3e}; bound {t['bound_ms']:.4f} ms ({t['bound_by']}) "
            f"{t.pop('text')}" + ("" if lib is None else f"; library (SDPA on the gathered windows) {lib:.4f} ms"))
        report[name]["timings"].append({"shape": shape, **t})
    del pk, pv, qpools, wins


def phase_spec(torch, lm, lm_int4, proc, report):
    """Phase 11: sampling and speculation on the card."""
    sampling_functions_check(torch)
    for model in (lm, lm_int4):
        phase_sampling(torch, model, proc, report)
    stamp("phase 11 (a)")
    for model in (lm, lm_int4):
        phase_spec_single(torch, model, proc, report)
        phase_spec_profile(torch, model, proc, report)
    stamp("phase 11 (b)")
    phase_spec_server(torch, lm, proc, report, paged=False)
    phase_spec_server(torch, lm, proc, report, paged=True)
    phase_spec_server(torch, lm_int4, proc, report, paged=True)
    phase_spec_server(torch, lm, proc, report, paged=True, pool_pages=20)
    for model in (lm, lm_int4):
        phase_spec_busy(torch, model, proc, report)
    stamp("phase 11 (c)")
    phase_spec_kernels(torch, report)
    stamp("phase 11")


# --- Phase 12: verify passes of 17-33 rows (row0), constrained decoding,
# choice selection, the agent and GTE ------------------------------------------

# (Lq, row0) of phase 12 (a)'s kernel checks: a pass's second group of 16
# rows, and the last row of a 33-row pass.
ROW0_CASES = ((16, 16), (1, 32))
LONG_SPEC_K = 31  # single stream: a pass of 32 rows, two launches of 16
PAGED_LONG_SPEC_K = 20  # paged: 21 rows, launches of 16 and 5
# As phase 11 (b)'s budget, every token of the run comes from a pass: a
# window with too little room for a pass ends in vanilla steps, whose single
# row rounds bf16 apart from a pass's rows.
LONG_SPEC_BUDGET = SPEC_BUDGET
CHOOSE_PROMPTS = ["Is the sea salty? A: yes B: no", "Pick a colour: A red, B green, C blue",
                  "Which is larger, 3 or 5? A: 3 B: 5", "Name the best answer."]
# Phase 12 (b): three prompts of unequal length (left padding); the long
# constraint's steps (1 + 22 rows) take K3 in two launches, the short one's
# (1 + 2) in one.
REF_PROMPTS = ["Is the sea salty?", "Which planet is the largest, Mars or Jupiter? Answer with a letter.",
               "Pick one."]
REF_CONSTRAINTS = [(2, " The correct answer is"), (2, " A"), "ABCDE"]
SHORT_CONSTRAINTS = [(16, " A"), "ABCDE"]
DEFAULT_CONSTRAINTS = [(0, "\nThe"), (100, " The correct answer is"), "ABCDE"]
CONSTRAIN_PROMPT = "Which planet is the largest? A: Mars B: Jupiter C: Venus"
# Phase 12 (b) holds each step's log-probs, card (bf16) against the CPU
# (fp32) on the same inputs, to STEP_LP_ATOL absolute: phase 3 measured
# 8.4e-3 relative L2 between the devices' logits through 2 layers of bf16,
# and an H100 run of this phase measured at most 0.0907 over its 25 steps
# (32064 log-probs a row).  Where the two devices' arrays are within it, a
# decision (an argmax, a choice, a top-3 set, a mean-score comparison) can
# part only where the CPU's margin between the two candidates is within
# 2 * STEP_LP_ATOL: a tie, logged.
STEP_LP_ATOL = 0.15
# Phase 12 (e): the cosine of each pair of GTE embeddings, card against
# CPU, both float32 (TF32 off): only the order of the f32 sums differs.
GTE_COS_ATOL = 1e-4
GTE_TEXTS = ["The lighthouse keeper logged the weather.", "Ships passed the island at dawn.",
             "A coded journal was found in the lamp room.", "Transcribe youtube video",
             "Text to speech", "Text to image", "The tide turned before the evening.",
             "Random words: apple, river, seven, quiet."]
# Phase 12 (d): the program the agent's generate must emit, and the prompt.
AGENT_PROGRAM = "```python\nprint(6*7)\n```"
AGENT_PROMPT = "Print six times seven with python."
AGENT_MAX_TOKENS = 64


def phase_row0_kernels(torch, report):
    """Phase 12 (a): K3, K4, K6 and K7 on a later row group of a verify pass
    (query i at offset + row0 + i) against their plain versions at
    ROW0_CASES, each timed at Lq = 16, row0 = 16 beside its bound and, for
    K3 and K6, SDPA with the same mask."""
    import random

    import torch.nn.functional as F

    from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig
    from phi_3_vision_mlx_tpu_torch.engine.state import quantize_chunk
    from phi_3_vision_mlx_tpu_torch.ops.attention import causal_valid_mask
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as KV

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(15)
    b_, h, kvh, d, nl, lmax = 1, 32, 32, 96, 4, 768
    scale = d**-0.5
    kvq = KVQuantConfig(group_size=32, bits=4)
    off = lmax - 64  # row0 + Lq <= 33 rows past it stay in the window
    valid = torch.ones((b_, lmax), dtype=torch.bool, device=dev)
    valid[:, :17] = False
    ks = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev).to(torch.bfloat16)
    vs = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev).to(torch.bfloat16)
    k_ = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev) + KV_MEAN[0]
    v_ = torch.randn((nl, b_, kvh, lmax, d), generator=g, device=dev) + KV_MEAN[1]
    payload, scales = quantize_chunk(k_.to(torch.bfloat16), v_.to(torch.bfloat16), kvq)
    del k_, v_
    off_t, nxt = dev_offset(torch, off), rotating(nl)
    for lq, row0 in ROW0_CASES:
        q = torch.randn((b_, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
        mask = causal_valid_mask(valid, off + row0 + torch.arange(lq, device=dev))
        pairs = int(mask.sum())
        shape = f"Lq={lq} row0={row0} Lmax={lmax} offset={off} H=32 D=96"
        for name, kernel, plain, cache, per_key in (
                ("K3", KV.dense_kv_attention, KV.dense_kv_attention_plain, (ks, vs), 2 * 2 * d),
                ("K4", KV.quantized_kv_attention, KV.quantized_kv_attention_plain, (payload, scales),
                 d + 8 * (d // 32))):
            out = kernel(q, *cache, valid, off_t, 1, scale, row0=row0)
            ref = plain(q, *cache, valid, off, 1, scale, row0=row0)
            torch.cuda.synchronize()
            ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
            log(f"phase 12 (a) {name} {shape}: max_abs={ea:.3e} max_rel={er:.3e}")
            if not ok:
                fail(f"{name} disagrees with its plain version at {shape}")
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], ea)
            if (lq, row0) != (16, 16):
                continue
            t = timed(torch, lambda: kernel(q, *cache, valid, off_t, nxt(), scale, row0=row0),
                      lambda: plain(q, *cache, valid, off_t, nxt(), scale, row0=row0), 20)
            lib = None
            if name == "K3":
                def sdpa(layer):
                    return F.scaled_dot_product_attention(q, ks[layer], vs[layer], attn_mask=mask, scale=scale)

                lib = cuda_ms(torch, lambda: sdpa(nxt()), 20)
            kend = min(lmax, off + row0 + lq)  # the keys a row of the launch can see
            t.update(bound(kvh * kend * per_key + lmax + 2 * 2 * h * lq * d, 4 * h * d * pairs),
                     library_ms=lib)
            log(f"phase 12 (a) {name} {shape} timed: bound {t['bound_ms']:.4f} ms ({t['bound_by']}) "
                f"{t.pop('text')}" + ("" if lib is None else f"; library (SDPA) {lib:.4f} ms")
                + f" on {report['card']}")
            report[name]["timings"].append({"shape": shape + " (verify pass, second row group)", **t})
    del ks, vs, payload, scales

    s_, page, window, pool = SERVE_SLOTS, 64, SERVE_WINDOW, 64
    offsets_l = (100, 400, 700, 960)
    rng = random.Random(15)
    ids = rng.sample(range(pool), pool)
    tables = torch.full((s_, window // page), pool, dtype=torch.int32)
    for i, o in enumerate(offsets_l):
        cnt = min(-(-(o + 33) // page), window // page)
        tables[i, :cnt] = torch.tensor([ids.pop() for _ in range(cnt)])
    tables, offsets = tables.to(dev), torch.tensor(offsets_l, dtype=torch.int32, device=dev)
    pvalid = torch.rand((s_, window), generator=g, device=dev) > 0.05
    pvalid[:, :10] = False
    pk = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev).to(torch.bfloat16)
    pv = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev).to(torch.bfloat16)
    k_ = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev) + KV_MEAN[0]
    v_ = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev) + KV_MEAN[1]
    qpools = quantize_chunk(k_.to(torch.bfloat16), v_.to(torch.bfloat16), kvq)
    del k_, v_
    wins = [(KV.gather_pages(pk[i], tables), KV.gather_pages(pv[i], tables)) for i in range(nl)]
    for lq, row0 in ROW0_CASES:
        q = torch.randn((s_, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
        vis = KV.paged_visible(pvalid, offsets, lq, row0)
        keys = sum(min(o + row0 + lq, window) for o in offsets_l)
        shape = f"S=4 offsets {','.join(map(str, offsets_l))} window 1024 page 64 Lq={lq} row0={row0}"
        for name, kernel, plain, pools, per_key in (
                ("K6", KV.paged_kv_attention, KV.paged_kv_attention_plain, (pk, pv), 2 * 2 * d),
                ("K7", KV.paged_quantized_kv_attention, KV.paged_quantized_kv_attention_plain, qpools,
                 d + 8 * (d // 32))):
            out = kernel(q, *pools, tables, pvalid, offsets, nl - 1, scale, row0=row0)
            ref = plain(q, *pools, tables, pvalid, offsets, nl - 1, scale, row0=row0)
            torch.cuda.synchronize()
            ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
            log(f"phase 12 (a) {name} {shape}: max_abs={ea:.3e} max_rel={er:.3e}")
            if not ok:
                fail(f"{name} disagrees with its plain version at {shape}")
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], ea)
            if (lq, row0) != (16, 16):
                continue
            t = timed(torch, lambda: kernel(q, *pools, tables, pvalid, offsets, nxt(), scale, row0=row0),
                      lambda: plain(q, *pools, tables, pvalid, offsets, nxt(), scale, row0=row0), 20)
            lib = None
            if name == "K6":
                lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, *wins[nxt()], attn_mask=vis, scale=scale), 20)
            nbytes = kvh * keys * per_key + s_ * window + 4 * tables.numel() + 2 * 2 * s_ * h * lq * d
            t.update(bound(nbytes, 4 * h * d * int(vis.sum())), library_ms=lib)
            log(f"phase 12 (a) {name} {shape} timed: bound {t['bound_ms']:.4f} ms ({t['bound_by']}) "
                f"{t.pop('text')}" + ("" if lib is None else f"; library (SDPA on the gathered windows) "
                                                                f"{lib:.4f} ms") + f" on {report['card']}")
            report[name]["timings"].append({"shape": shape + " (verify pass, second row group)", **t})
    del pk, pv, qpools, wins


def phase_long_verify(torch, lm, proc, report):
    """Phase 12 (a): single-stream speculation at K = LONG_SPEC_K (a pass of
    32 query rows: K3 or K4 launched on two groups of 16, the second at
    row0 16): the stream bitwise equal to its forced-reject baseline, also
    with that stream seeded as drafts (which verification then accepts)."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.models import phi3

    cache = cache_of(lm)
    label = f"{weights_of(lm)} weights, {cache} cache"
    attn = {"int4": "quantized_kv_attention"}.get(cache, "dense_kv_attention")
    dict_input = proc(api._apply_chat_template(LOOP_PROMPT)[0])
    k, budget = LONG_SPEC_K, LONG_SPEC_BUDGET
    seen = RowsSeen(phi3, (attn,))
    try:
        spec_run(torch, lm, dict_input, 16, False, k=k)  # the key's first pass captures its graph
        counters = zero_counters()
        acc = spec_run(torch, lm, dict_input, budget, True, k=k)
        launches = {n: fn.launches for n, fn in counters.items()}
        forced = spec_run(torch, lm, dict_input, budget, False, k=k)
        oracle = spec_run(torch, lm, dict_input, budget, True, oracle=forced[0], k=k)
    finally:
        seen.restore()
    same = all(np.array_equal(x, y) for r in (acc, oracle) for x, y in zip(r[:3], forced[:3]))
    log(f"phase 12 (a) speculation ({label}, K={k}: {k + 1} query rows a pass, {budget} tokens): "
        f"{acc[3]} passes, forced-reject {forced[3]}, seeded drafts {oracle[3]}; each == forced-reject "
        f"bitwise (tokens, max and EOS log-probs) {same}; query rows {sorted(seen.rows[attn])} from rows "
        f"{sorted(seen.row0s[attn])}; launches {launches}")
    if not same or oracle[3] >= forced[3]:
        fail(f"phase 12 (a) ({label}): the {k + 1}-row passes differ from their forced-reject baseline "
             "(or seeded drafts were never accepted)")
    if 16 not in seen.rows[attn] or 16 not in seen.row0s[attn] or max(seen.rows[attn]) > 16:
        fail(f"phase 12 (a) ({label}): a {k + 1}-row pass did not run as two groups of 16: "
             f"{seen.rows[attn]} from {seen.row0s[attn]}")


def phase_long_paged_verify(torch, lm, proc, report):
    """Phase 12 (a): the paged engine with spec_k = PAGED_LONG_SPEC_K (21
    query rows a pass: K6 or K7 launched at 16 rows and at 5 from row0 16),
    four requests, against its forced-reject baseline token for token."""
    from phi_3_vision_mlx_tpu_torch.engine import paging
    from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine

    cache = cache_of(lm)
    name = {"int4": "paged_quantized_kv_attention"}.get(cache, "paged_kv_attention")
    prompts = [(LOOP_PROMPT + FILLER)[: 100 + 100 * i] for i in range(SERVE_SLOTS)]

    def run(accept: bool):
        eng = PagedBatchEngine(lm, proc, slots=SERVE_SLOTS, window=SERVE_WINDOW,
                               spec_k=PAGED_LONG_SPEC_K, spec_accept=accept)
        rids = [eng.submit(p, max_tokens=48) for p in prompts]
        for _ in range(400):
            if not eng.pending():
                break
            eng.step(2)
        if eng.pending():
            fail(f"phase 12 (a): the paged engine at spec_k={PAGED_LONG_SPEC_K} did not finish")
        return [eng.tokens(r) for r in rids], dict(eng.spec_stats)

    seen = RowsSeen(paging, (name,))
    try:
        counters = zero_counters()
        acc, st_acc = run(True)
        launches = {n: fn.launches for n, fn in counters.items()}
        forced, st_forced = run(False)
    finally:
        seen.restore()
    log(f"phase 12 (a) paged speculation ({weights_of(lm)} weights, {cache} pool, spec_k="
        f"{PAGED_LONG_SPEC_K}, 4 requests of 48 tokens): {st_acc}, forced-reject {st_forced}; tokens == "
        f"forced-reject {acc == forced}; query rows {sorted(seen.rows[name])} from rows "
        f"{sorted(seen.row0s[name])}; launches {launches}")
    if acc != forced or any(len(t) != 48 for t in acc):
        fail(f"phase 12 (a): paged speculation at spec_k={PAGED_LONG_SPEC_K} differs from its baseline")
    if not {16, PAGED_LONG_SPEC_K + 1 - 16} <= seen.rows[name] or 16 not in seen.row0s[name]:
        fail(f"phase 12 (a): the {PAGED_LONG_SPEC_K + 1}-row paged pass ran as {seen.rows[name]} "
             f"from {seen.row0s[name]}")


class StepMirror:
    """Constrained decoding's device steps on the card, each call repeated
    on a CPU twin with the same inputs (the twin's state follows the same
    calls): ``records`` holds (kind, ids, card log-probs, CPU log-probs,
    extra) per call, in order, where ``extra`` is the prefill's (l_pad,
    window).  The card's host bookkeeping drives, its prefills into the
    model's entries and its steps through their graphs; the twin (eager on
    the CPU) only mirrors."""

    def __init__(self, torch, lm, twin, constrain):
        from phi_3_vision_mlx_tpu_torch.engine.engine import run_prefill

        self.torch, self.lm, self.twin, self.C = torch, lm, twin, constrain
        self.records, self.cpu_state = [], None
        self.prefill_entry, self.run_prefill = constrain.prefill_entry, run_prefill
        constrain.prefill_entry = self._prefill
        for name in ("score_fn", "beam_fn", "nocache_fn"):
            setattr(lm, name, getattr(self, "_" + name))

    def restore(self):
        self.C.prefill_entry = self.prefill_entry
        for name in ("score_fn", "beam_fn", "nocache_fn"):
            delattr(self.lm, name)

    def _keep(self, kind, ids, card, cpu, extra=None):
        self.records.append((kind, ids.cpu().numpy(), card.float().cpu().numpy().copy(), cpu.float().numpy(), extra))

    def _prefill(self, lm, dict_input, max_tokens):
        out = self.prefill_entry(lm, dict_input, max_tokens)  # (entry, logits, state, l_pad, window)
        cpu = self.run_prefill(self.twin, dict_input, max_tokens)
        self.cpu_state = cpu[1]
        import numpy as np

        self._keep("prefill", self.torch.as_tensor(np.asarray(dict_input["input_ids"])), out[1], cpu[0],
                   out[3:])
        return out

    def _score_fn(self, b, l, window, advance=None):
        f, g = type(self.lm).score_fn(self.lm, b, l, window, advance), self.twin.score_fn(b, l, window, advance)

        def call(params, ids, state):
            lp, st = f(params, ids, state)
            lp2, self.cpu_state = g(self.twin.params, ids.cpu(), self.cpu_state)
            self._keep(f"score{advance}", ids, lp, lp2)
            return lp, st

        return call

    def _beam_fn(self, b, l, window, n_beam):
        f, g = type(self.lm).beam_fn(self.lm, b, l, window, n_beam), self.twin.beam_fn(b, l, window, n_beam)

        def call(params, ids, state):
            lp = f(params, ids, state)
            self._keep("beam", ids, lp, g(self.twin.params, ids.cpu(), self.cpu_state))
            return lp

        return call

    def _nocache_fn(self, b, l):
        f, g = type(self.lm).nocache_fn(self.lm, b, l), self.twin.nocache_fn(b, l)

        def call(params, ids, pids, valid):
            lp = f(params, ids, pids, valid)
            self._keep("nocache", ids, lp, g(self.twin.params, ids.cpu(), pids.cpu(), valid.cpu()))
            return lp

        return call


class ReplayDiverged(Exception):
    pass


class ReplayLM:
    """A stand-in LM whose steps return the CPU's recorded log-probs in
    order, checking that each call's ids are the card run's: constrained
    decoding replayed on the host with the CPU's numbers, so its decisions
    are the CPU's.  A call whose ids differ raises ReplayDiverged: an
    earlier decision parted.  Only the replay checks the decisions that sum
    log-probs over several steps (``pre_beam_score > post_beam_score``, a
    row's ``score > score_sofar``) and so the synthesized ids: ``step_ties``
    sees one step's rows at a time.  Where a top-3 set parts at a tie, the
    replay parts after it, and those later decisions go unchecked."""

    def __init__(self, torch, records, constrain):
        self.torch, self.records, self.C, self.n = torch, records, constrain, 0
        self.device = torch.device("cpu")
        self.params, self.graphs = None, False  # no entry to give back
        self.prefill_entry = constrain.prefill_entry
        constrain.prefill_entry = lambda lm, dict_input, max_tokens: self._prefill(dict_input)

    def restore(self):
        self.C.prefill_entry = self.prefill_entry

    def _next(self, kind, ids, n_beam: int = 1):
        """The next record's CPU log-probs for ``ids``.  A beam call whose
        candidates are the card's in another order (``argpartition`` does
        not order its top n) gets the CPU's rows in that order."""
        import numpy as np

        if self.n >= len(self.records):
            raise ReplayDiverged(f"call {self.n} past the card run's {len(self.records)}")
        rec = self.records[self.n]
        if rec[0] != kind or rec[1].shape != ids.shape:
            raise ReplayDiverged(f"call {self.n} ({kind})")
        order = np.arange(len(ids))
        for r, row in enumerate(ids):  # each beam row among its cache row's n_beam
            g = r - r % n_beam
            hits = [g + j for j in range(n_beam) if np.array_equal(rec[1][g + j], row)]
            if not hits:
                raise ReplayDiverged(f"call {self.n} ({kind})")
            order[r] = hits[0]
        self.n += 1
        return self.torch.from_numpy(np.ascontiguousarray(rec[3][order]))

    def _prefill(self, dict_input):
        import numpy as np

        extra = self.records[min(self.n, len(self.records) - 1)][4]
        return None, self._next("prefill", np.asarray(dict_input["input_ids"])), None, *(extra or (0, 0))

    def score_fn(self, b, l, window, advance=None):
        return lambda params, ids, state: (self._next(f"score{advance}", ids.numpy()), state)

    def beam_fn(self, b, l, window, n_beam):
        return lambda params, ids, state: self._next("beam", ids.numpy(), n_beam)

    def nocache_fn(self, b, l):
        return lambda params, ids, pids, valid: self._next("nocache", ids.numpy())


def step_ties(records, option_ids, n_beam: int = 3):
    """The decisions that part between the card and the CPU on the same
    inputs: the free token (a prefill's or a step's first row), the beam's
    top-``n_beam`` candidates there, and a choice among ``option_ids``;
    each as (call, row, what, the CPU's margin between its own pick and
    the card's)."""
    import numpy as np

    ties = []
    for n, (kind, _, card, cpu, _) in enumerate(records):
        if kind == "nocache":
            card, cpu = card[:, option_ids], cpu[:, option_ids]
        elif kind == "score1":
            card, cpu = card[:, 0], cpu[:, 0]
        elif kind != "prefill":
            continue
        a, b = card.argmax(-1), cpu.argmax(-1)
        for r in np.flatnonzero(a != b):
            ties.append((n, int(r), "argmax", float(cpu[r, b[r]] - cpu[r, a[r]])))
        if kind == "nocache" or not n_beam:
            continue
        for r in range(len(card)):
            top_card, top_cpu = (set(np.argpartition(-x[r], n_beam)[:n_beam].tolist()) for x in (card, cpu))
            if top_card != top_cpu:
                margin = min(cpu[r, list(top_cpu)]) - max(cpu[r, list(top_card - top_cpu)])
                ties.append((n, r, f"top {n_beam}", float(margin)))
    return ties


def dequantized_linears(torch, node):
    """``node`` on the CPU with each 4-bit linear leaf as a float32
    ``weight``: the values K1's plain version dequantizes on every call
    (``dequantize`` to the activations' f32, then an f32 matmul), made once."""
    from phi_3_vision_mlx_tpu_torch.core.weights import unpack_int4
    from phi_3_vision_mlx_tpu_torch.ops.quant import QTensor, dequantize

    if not isinstance(node, dict):
        return node.cpu()
    if "qweight" not in node:
        return {k: dequantized_linears(torch, v) for k, v in node.items()}
    biases = node.get("biases")
    out = {"weight": dequantize(QTensor(unpack_int4(node["qweight"].cpu()), node["scales"].cpu(),
                                        None if biases is None else biases.cpu()), dtype=torch.float32)}
    if "bias" in node:
        out["bias"] = node["bias"].cpu()
    return out


def phase_constrain_reference(torch, params, proc):
    """Phase 12 (b): a 2-layer full-width model, ``choose`` on three prompts
    of unequal length and ``constrain`` (REF_CONSTRAINTS) greedy and with
    beams, on the card (bf16; each step a graph replay of the model's
    entries, the first of a shape capturing), each step repeated on the
    CPU's plain path (fp32, its 4-bit linears dequantized once:
    ``dequantized_linears``) on the same inputs: every step's log-probs
    within STEP_LP_ATOL; then the whole run replayed on the host with the
    CPU's numbers.  Every
    decision of the run (an argmax, a choice, a top-3 set, a mean-score
    comparison) compares sums of those log-probs, so where the steps agree
    within STEP_LP_ATOL the CPU's decisions part from the card's only at a
    margin within 2 * STEP_LP_ATOL: a tie.  The argmax ties and the call
    where the replay parts (if it does) are logged; without a parting the
    replay must give the card's choices and text."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine import constrain as C
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM

    cfg = full_config().replace(num_hidden_layers=2)
    small = {"model": {**params["model"], "layers": first_layers(params["model"]["layers"])},
             "lm_head": params["lm_head"]}
    lm = LM(cfg, small, device="cuda")
    twin = LM(cfg.replace(dtype="float32"), dequantized_linears(torch, small), device="cpu")
    prompts = api._apply_chat_template(REF_PROMPTS)[0]
    option_ids = np.array([proc(f" {c}")["input_ids"][0, -1] for c in "ABCDE"])
    runs = {"choose": lambda m: C.choose_from(m, proc, prompts, "ABCDE", mute=True)}
    for beam in (False, True):
        runs[f"constrain {'beam' if beam else 'greedy'}"] = (
            lambda m, beam=beam: C.constrain_decode(m, proc, prompts, REF_CONSTRAINTS, mute=True,
                                                    use_beam=beam, verbose=False))
    for what, run in runs.items():
        mirror = StepMirror(torch, lm, twin, C)
        t0 = time.perf_counter()
        try:
            card_out = run(lm)
        finally:
            mirror.restore()
        secs = time.perf_counter() - t0
        worst = max(float(np.abs(r[2] - r[3]).max()) for r in mirror.records)
        for kind, ids, card, cpu, _ in mirror.records:
            if card.shape != cpu.shape or not np.isfinite(card).all():
                fail(f"phase 12 (b) {what}: a {kind} step gave {card.shape} / {cpu.shape} or non-finite values")
        ties = step_ties(mirror.records, option_ids, n_beam=3 if "beam" in what else 0)
        replay = ReplayLM(torch, mirror.records, C)
        try:
            cpu_out, parted = run(replay), None
        except ReplayDiverged as e:
            cpu_out, parted = None, str(e)
        finally:
            replay.restore()
        kinds = sorted({r[0] for r in mirror.records})
        log(f"phase 12 (b) {what} (2 layers, width 3072, 3 prompts, card bf16 vs CPU fp32 on the same "
            f"inputs, {secs:.1f} s with the CPU): {len(mirror.records)} steps ({', '.join(kinds)}), largest "
            f"log-prob difference {worst:.4f} (limit {STEP_LP_ATOL}); ties {ties or 'none'}; card "
            f"{card_out!r}; CPU's decisions {'the same' if cpu_out == card_out else cpu_out!r}"
            + (f" (the replay parted at {parted}: a decision before it, an argmax or top-3 set above or "
               f"else a mean-score comparison, had a margin within 2 x {worst:.4f})" if parted else ""))
        if worst > STEP_LP_ATOL:
            fail(f"phase 12 (b) {what}: a step's log-probs differ by {worst:.4f} between the card and the CPU")
        if any(m > 2 * STEP_LP_ATOL for *_, m in ties):
            fail(f"phase 12 (b) {what}: a decision parts beyond a tie: {ties}")
        if parted is None and cpu_out != card_out:
            fail(f"phase 12 (b) {what}: the CPU's decisions give {cpu_out!r}, the card's {card_out!r}")
    del lm, twin


class StepClock:
    """Around ``lm``'s constrained-decoding steps (``score_fn``, ``beam_fn``,
    ``nocache_fn``): each call as (kind, rows, synchronized wall ms, whether
    it replayed a graph captured before it), ``kind`` being ``score0`` /
    ``score1`` (the ``advance``), ``beam`` or ``nocache``; with ``keep``, a
    host copy of each call's log-probs.  A replay is a call in which every
    ``StepGraph`` call found its graph already captured (an eager model
    calls none)."""

    def __init__(self, torch, lm, keep: bool = False):
        from phi_3_vision_mlx_tpu_torch.engine import graphs

        self.torch, self.lm, self.keep = torch, lm, keep
        self.calls, self.outs, self.seen = [], [], []
        self.graphs, self.graph_call = graphs, graphs.StepGraph.__call__
        graph_call = self.graph_call

        def seen_call(g):
            self.seen.append(g.graph is not None)
            return graph_call(g)

        graphs.StepGraph.__call__ = seen_call
        make = type(lm)
        lm.score_fn = lambda b, l, window, advance: self._timed(make.score_fn(lm, b, l, window, advance),
                                                                f"score{advance}", l)
        lm.beam_fn = lambda b, l, window, n_beam: self._timed(make.beam_fn(lm, b, l, window, n_beam), "beam", l)
        lm.nocache_fn = lambda b, l: self._timed(make.nocache_fn(lm, b, l), "nocache", l)

    def _timed(self, fn, kind: str, rows: int):
        def call(*a):
            n = len(self.seen)
            t0 = time.perf_counter()
            out = fn(*a)
            self.torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if self.keep:
                self.outs.append((kind, (out[0] if isinstance(out, tuple) else out).cpu().numpy().copy()))
            self.calls.append((kind, rows, ms, len(self.seen) > n and all(self.seen[n:])))
            return out

        return call

    def ms(self, kind: str):
        import numpy as np

        return np.array([ms for k, _, ms, replayed in self.calls if k == kind and replayed])

    def restore(self):
        self.graphs.StepGraph.__call__ = self.graph_call
        del self.lm.score_fn, self.lm.beam_fn, self.lm.nocache_fn


def step_profile_idle(torch, fn, reps: int = 8):
    """(host wall ms, device busy ms, idle share, kernels) of one call of
    ``fn``, its log-probs read back as constrained decoding reads them."""
    fn().cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn().cpu()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    per_name, launches = kernel_times(torch, lambda: fn().cpu(), 1)
    busy = sum(per_name.values())
    if busy <= 0:
        fail("phase 12: the profiler saw no device time")
    return wall, busy, 1 - busy / wall, launches


# Phase 12 (c)'s cut model for its graph-against-eager check (the eager
# steps are host-bound, about 1650-2200 launches a step at 32 layers); its
# timed runs take the full 32 layers, replayed.
CONSTRAIN_LAYERS = 4
CONSTRAIN_RUNS = (("defaults", DEFAULT_CONSTRAINTS), ("short", SHORT_CONSTRAINTS))
STEP_KINDS = ("score0", "score1", "beam", "nocache")
IDLE_MAX = 0.5  # a replayed step's idle share: a graph step should sit near its busy time


def constrain_answer_ok(tag: str, text) -> bool:
    want = "The correct answer is" if tag == "defaults" else " A"
    return isinstance(text, str) and want in text and text.rstrip()[-1] in "ABCDE"


def phase_constrain_parity(torch, params, model, proc, report):
    """Phase 12 (c), correctness, on the first ``CONSTRAIN_LAYERS`` layers of
    ``model``'s weights and cache: one greedy and one beam ``api.constrain``
    of each constraint set with graphs and again with ``graphs=False``
    (the same kernels on the same routes): every score, beam and cache-free
    output bitwise equal, the texts equal; then a replayed score step of 1 +
    22 rows runs two launches of K3 (K4 on the int4 cache) a layer and no
    K2/K5."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine.constrain import encode_suffix
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM, prefill_entry, release_decoder

    cut = {"model": {**params["model"], "layers": first_layers(params["model"]["layers"], CONSTRAIN_LAYERS)},
           "lm_head": params["lm_head"]}
    graph = LM(model.cfg.replace(num_hidden_layers=CONSTRAIN_LAYERS), cut, device="cuda")
    eager = eager_twin(graph)
    cache = cache_of(graph)
    label = f"{weights_of(graph)} weights, {cache} cache, {CONSTRAIN_LAYERS} layers"
    for tag, constraints in CONSTRAIN_RUNS:
        for beam in (False, True):
            runs = {}
            for mode, m in (("graph", graph), ("eager", eager)):
                clock = StepClock(torch, m, keep=True)
                try:
                    text = api.constrain(CONSTRAIN_PROMPT, constraints=constraints, preload=(m, proc),
                                         verbose=False, use_beam=beam)
                finally:
                    clock.restore()
                runs[mode] = (text, clock)
            (gt, g_clock), (et, e_clock) = runs["graph"], runs["eager"]
            kinds = [k for k, _ in g_clock.outs]
            equal = (gt == et and kinds == [k for k, _ in e_clock.outs]
                     and all(np.array_equal(a, b) for (_, a), (_, b) in zip(g_clock.outs, e_clock.outs)))
            replayed = sorted({k for k, _, _, r in g_clock.calls if r})
            log(f"phase 12 (c) graph vs eager ({label}, {tag} constraints, {'beam' if beam else 'greedy'}): "
                f"{len(kinds)} step outputs ({', '.join(f'{k} {kinds.count(k)}' for k in sorted(set(kinds)))}) "
                f"bitwise equal: {equal}; texts equal: {gt == et}; kinds replayed {replayed}")
            if not equal:
                fail(f"phase 12 (c) ({label}, {tag}, beam {beam}): the graph run's steps or text differ from "
                     f"the eager run's: {gt!r} / {et!r}")
            if not constrain_answer_ok(tag, gt):
                fail(f"phase 12 (c) ({label}, {tag}, beam {beam}): {gt!r}")
    ids = encode_suffix(proc.tokenizer, " The correct answer is")
    plus = torch.as_tensor(np.concatenate([ids[:1], ids])[None], dtype=torch.long, device="cuda")
    entry, _, state, _, window = prefill_entry(graph, proc(api._apply_chat_template(CONSTRAIN_PROMPT)[0]), 64)
    try:
        step = graph.score_fn(1, plus.shape[1], window, advance=0)
        step(graph.params, plus, state)  # captures
        counters = zero_counters()
        step(graph.params, plus, state)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
    finally:
        release_decoder(graph, entry)
    decode = "K4" if cache == "int4" else "K3"
    log(f"phase 12 (c) one replayed score step of {plus.shape[1]} rows ({label}): launches {launches}")
    if launches[decode] != 2 * CONSTRAIN_LAYERS or launches["K2"] or launches["K5"]:
        fail(f"phase 12 (c) ({label}): a {plus.shape[1]}-row score step launched {launches}, not two {decode} "
             f"launches a layer and no K2/K5")
    del graph, eager


def phase_constrain_full(torch, lm, proc, report):
    """Phase 12 (c), full depth (``lm``'s 32 layers, every step replayed):
    ``api.choose`` on four prompts and ``api.constrain`` with the JAX
    defaults and with SHORT_CONSTRAINTS, greedy and with beams, each
    question twice (the first captures its shapes' graphs, the second
    replays them): seconds per question, the launches of the runs (K1, K2
    and K3 with the dense cache; K1, K2, K4 and K5 with the int4 cache),
    wall ms per replayed step, each graph's capture ms and pool, and a
    replayed score step of 1 + 22 and 1 + 2 rows and a 3 x 23-row beam step
    profiled (wall, busy, idle share, kernels) beside the same step run
    eagerly.  Fails if a step kind never replayed or a replayed step's idle
    share passes IDLE_MAX."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine.constrain import encode_suffix
    from phi_3_vision_mlx_tpu_torch.engine.engine import prefill_entry, release_decoder, run_prefill

    cache = cache_of(lm)
    n_layers = lm.cfg.num_hidden_layers
    label = f"{weights_of(lm)} weights, {cache} cache, {n_layers} layers, replayed"
    card = report["card"]
    expected = ("K1", "K2") + (("K4", "K5") if cache == "int4" else ("K3",))
    clock = StepClock(torch, lm)
    counters = zero_counters()
    outs, choose_ms = {}, []
    try:
        for _ in range(2):  # the first captures the cache-free pass
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            letters = api.choose(CHOOSE_PROMPTS, preload=(lm, proc), verbose=False)
            choose_ms.append((time.perf_counter() - t0) * 1e3)
        for tag, constraints in CONSTRAIN_RUNS:
            for beam in (False, True):
                for question in ("first", "second"):
                    t0 = time.perf_counter()
                    outs[tag, beam, question] = (api.constrain(CONSTRAIN_PROMPT, constraints=constraints,
                                                               preload=(lm, proc), verbose=False, use_beam=beam),
                                                 time.perf_counter() - t0)
        launches = {n: fn.launches for n, fn in counters.items()}
    finally:
        clock.restore()
    log(f"phase 12 (c) api.choose ({label}, 4 prompts, one cache-free pass): {letters} in {choose_ms[0]:.1f} ms "
        f"(capturing), {choose_ms[1]:.1f} ms (replayed) on {card}")
    if len(letters) != 4 or any(c not in "ABCDE" for c in letters):
        fail(f"phase 12 (c) ({label}): choose gave {letters}")
    for (tag, beam, question), (text, secs) in outs.items():
        log(f"phase 12 (c) api.constrain ({label}, {tag} constraints, {'beam' if beam else 'greedy'}, "
            f"{question} question): {secs:.3f} s, {text!r} on {card}")
        if not constrain_answer_ok(tag, text):
            fail(f"phase 12 (c) ({label}, {tag}, beam {beam}): {text!r}")
    replays = {k: sum(1 for c in clock.calls if c[0] == k and c[3]) for k in STEP_KINDS}
    captures = {k: sum(1 for c in clock.calls if c[0] == k and not c[3]) for k in STEP_KINDS}
    log(f"phase 12 (c) calls ({label}): replayed {replays}, capturing {captures}; entries "
        f"{dict(lm.entry_uses)}")
    for kind, n in replays.items():
        if n == 0:
            fail(f"phase 12 (c) ({label}): no {kind} step replayed a graph")
    cfn, beam_ms = clock.ms("score1"), clock.ms("beam")
    log(f"phase 12 (c) replayed steps ({label}): {len(cfn)} constrained steps, wall {cfn.mean():.3f} ms mean "
        f"(median {np.median(cfn):.3f}); {len(beam_ms)} beam steps, wall {beam_ms.mean():.3f} ms mean "
        f"(median {np.median(beam_ms):.3f}) on {card}")
    row0 = sum(-(-rows // 16) - 1 for kind, rows, _, _ in clock.calls if kind.startswith("score")) * n_layers
    log(f"phase 12 (c) launches over choose and the eight constrain runs ({label}): {launches}; "
        f"{row0} of the {'K4' if cache == 'int4' else 'K3'} launches at row0 16")
    for name in expected:
        if launches[name] <= 0:
            fail(f"phase 12 (c) ({label}): {name} was never launched")
    graphs = [(key, g) for key, entry in lm.decoders.items()
              for g in ([entry.step.graph] if key[0] == "nocache" else [s.graph for s in entry.steps.values()])]
    log(f"phase 12 (c) graphs kept ({label}): " + "; ".join(
        f"{key} capture {g.capture_ms or 0.0:.1f} ms, pool {g.pool_bytes / 2**20:.1f} MiB" for key, g in graphs))
    # One profiled step of each kind, replayed and eager: the long
    # constraint's (1 + 22 rows), the short one's (1 + 2 rows) and a beam
    # read of 3 x (1 + 22) rows.
    eager = eager_twin(lm)
    prompt = api._apply_chat_template(CONSTRAIN_PROMPT)[0]
    for text in (" The correct answer is", " A"):
        ids = encode_suffix(proc.tokenizer, text)
        lcons = len(ids)
        tiled = torch.as_tensor(ids[None], dtype=torch.long, device="cuda")
        plus = torch.cat([tiled[:, :1], tiled], dim=1)
        beams = torch.cat([torch.tensor([[1005], [1006], [1007]], device="cuda"), tiled.expand(3, -1)], dim=1)
        rows = {}
        entry, _, state, _, window = prefill_entry(lm, proc(prompt), 100 + lcons + 10)
        try:
            for mode, m in (("replayed", lm), ("eager", eager)):
                if mode == "eager":
                    state = run_prefill(eager, proc(prompt), 100 + lcons + 10)[1]
                _, state = m.score_fn(1, lcons, window, advance=0)(m.params, tiled, state)
                step = m.score_fn(1, 1 + lcons, window, advance=0)
                bfn = m.beam_fn(3, 1 + lcons, window, 3)
                rows[mode, "score"] = step_profile_idle(torch, lambda: step(m.params, plus, state)[0])
                if lcons > 16:
                    rows[mode, "beam"] = step_profile_idle(torch, lambda: bfn(m.params, beams, state))
        finally:
            release_decoder(lm, entry)
        for (mode, kind), (wall, busy, idle, n) in rows.items():
            what = f"score step, {1 + lcons} rows" if kind == "score" else f"beam step, 3 x {1 + lcons} rows"
            log(f"phase 12 (c) {what} ({weights_of(lm)} weights, {cache} cache, {n_layers} layers, {mode}): "
                f"wall {wall:.3f} ms, busy {busy:.3f} ms, idle share {idle:.3f}, {n} kernels on {card}")
            if mode == "replayed" and idle > IDLE_MAX:
                fail(f"phase 12 (c) ({label}): a replayed {what} sits idle {idle:.3f} of its wall")
    del eager


def agent_params(torch, lm, proc, program: str, prompt: str, max_tokens: int):
    """Parameters of ``lm``'s model whose greedy ``api.generate`` of
    ``prompt`` (chat template, ``max_tokens``) emits ``program`` then EOS:
    the lm_head (dequantized to bf16) plus, for each position of the forced
    stream, a column term alpha * pinv(H) that scores its target token
    alpha above the rest, where H holds the final normed hidden states of
    the engine's own path (the prefill's last position, then each forced
    token's decode step), read with an identity lm_head."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.core.config import ID_EOS
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM, run_prefill
    from phi_3_vision_mlx_tpu_torch.models import phi3
    from phi_3_vision_mlx_tpu_torch.ops.linear import dense

    cfg, e, v = lm.cfg, lm.cfg.hidden_size, lm.cfg.vocab_size
    targets = proc.tokenizer.encode(program, add_special_tokens=False) + [ID_EOS]
    eye = torch.zeros((e, v), dtype=torch.bfloat16, device="cuda")
    eye[:, :e] = torch.eye(e, dtype=torch.bfloat16, device="cuda")
    probe = LM(cfg, {**lm.params, "lm_head": {"weight": eye}}, device="cuda", graphs=False)
    dict_input = proc(api._apply_chat_template(prompt)[0])
    with torch.no_grad():
        last, state, _, _ = run_prefill(probe, dict_input, max_tokens)
        hidden = [last[0, :e]]
        for t in targets[:-1]:
            res = phi3.decode_forward(probe.params, cfg, state, torch.tensor([[t]], device="cuda"))
            state = res.state
            hidden.append(res.logits[0, -1, :e].float())
        h = torch.stack(hidden).double().cpu().numpy()  # (N, E)
        w = dense(lm.params["lm_head"], torch.eye(e, dtype=torch.bfloat16, device="cuda")).float()
    base = (torch.from_numpy(h).float().to("cuda") @ w).abs().max().item()
    alpha = max(30.0, 4 * base)
    cols = np.linalg.pinv(h) * alpha  # (E, N): h @ cols = alpha * I
    add = np.zeros((e, v))
    for k, t in enumerate(targets):
        add[:, t] += cols[:, k]
    head = (w.double() + torch.from_numpy(add).to("cuda")).to(torch.bfloat16)
    log(f"phase 12 (d) agent weights: {len(targets)} forced tokens, largest base logit {base:.2f}, "
        f"alpha {alpha:.1f}")
    return {**lm.params, "lm_head": {"weight": head}}


def phase_agent(torch, lm, proc, report):
    """Phase 12 (d): ``Agent()`` with its default toolchain (add_code,
    generate, execute) on a 2-layer full-width model whose greedy output
    for AGENT_PROMPT is AGENT_PROGRAM (``agent_params``): the sandbox runs
    the block and prints 42; then ``api.generate(enable_api=True)`` on a
    quoted prompt returns its snippet, formatted."""
    import contextlib
    import io
    import tempfile

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.agent.agent import Agent
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM

    cfg = lm.cfg.replace(num_hidden_layers=2)
    small = {"model": {**lm.params["model"], "layers": first_layers(lm.params["model"]["layers"])},
             "lm_head": lm.params["lm_head"]}
    lm2 = LM(cfg, small, device="cuda")
    lm2 = LM(cfg, agent_params(torch, lm2, proc, AGENT_PROGRAM, AGENT_PROMPT, AGENT_MAX_TOKENS), device="cuda")
    cwd = os.getcwd()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            counters = zero_counters()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                agent = Agent(preload=(lm2, proc), max_tokens=AGENT_MAX_TOKENS)
                out = agent(AGENT_PROMPT)
            secs = time.perf_counter() - t0
            launches = {n: fn.launches for n, fn in counters.items()}
            logged = json.load(open("agent_log.json"))
        finally:
            os.chdir(cwd)
    printed = buf.getvalue()
    codes = agent.ongoing.get("codes")
    log(f"phase 12 (d) Agent (default toolchain, 2 layers, width 3072, {secs:.2f} s): responses "
        f"{out['responses']!r}, files {out['files']}, codes {codes}, launches {launches}")
    if (AGENT_PROGRAM not in str(out["responses"]) or codes != ["print(6*7)"]
            or "*** Execution ***\nprint(6*7)\nNone\n42\nNone" not in printed or len(logged) != 1):
        fail(f"phase 12 (d): the agent's generate or sandbox did not run the program: {printed[-400:]!r}")
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        fail(f"phase 12 (d): the agent's generate did not run on the kernels: {launches}")
    quoted = 'Text to speech "good morning"'.replace('"', "<|api_input|>")
    with contextlib.redirect_stdout(io.StringIO()):
        snippet = api.generate(quoted, enable_api=True)
    log(f"phase 12 (d) generate(enable_api=True) on a quoted prompt: {snippet!r}")
    if len(snippet) != 1 or 'text="good morning"' not in snippet[0] or "{prompt}" in snippet[0]:
        fail(f"phase 12 (d): generate(enable_api=True) gave {snippet!r}")


def phase_gte(torch, report):
    """Phase 12 (e): GTE-large (24 x 1024, random weights from a seed) on
    GTE_TEXTS, on the card and on the CPU, both float32: the cosine of each
    pair of embeddings within GTE_COS_ATOL; the card's time."""
    import hashlib

    from phi_3_vision_mlx_tpu_torch.core.weights import params_to
    from phi_3_vision_mlx_tpu_torch.models import gte as G

    cfg = G.GteConfig()
    params = G.init_gte_params(cfg, torch.Generator(device="cuda").manual_seed(12))
    rows = [[101] + [1000 + int(hashlib.md5(w.encode()).hexdigest(), 16) % (cfg.vocab_size - 1000)
                     for w in t.lower().split()] + [102] for t in GTE_TEXTS]
    n = max(len(r) for r in rows)
    ids = torch.tensor([r + [0] * (n - len(r)) for r in rows])
    mask = torch.tensor([[1] * len(r) + [0] * (n - len(r)) for r in rows])
    types = torch.zeros_like(ids)

    def embed(p, device):
        x = G.average_pool(G.gte_forward(p, cfg, ids.to(device), types.to(device), mask.to(device)),
                           mask.to(device))
        x = x / torch.linalg.norm(x, dim=1, keepdim=True)
        return x @ x.T

    embed(params, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = embed(params, "cuda").cpu()
    ms = (time.perf_counter() - t0) * 1e3
    cpu = embed(params_to(params, "cpu"), "cpu")
    err = float((card - cpu).abs().max())
    log(f"phase 12 (e) GTE-large (24 x 1024, {len(GTE_TEXTS)} texts of up to {n} tokens, f32): pairwise "
        f"cosines card vs CPU max abs diff {err:.3e} (limit {GTE_COS_ATOL}); {ms:.1f} ms on the card "
        f"({report['card']})")
    if not torch.isfinite(card).all() or err > GTE_COS_ATOL:
        fail(f"phase 12 (e): GTE embeddings differ between the card and the CPU by {err:.3e}")


def phase_constrain(torch, params, lm, lm_int4, proc, report):
    """Phase 12: verify passes of 17-33 rows, then constrained decoding,
    choice selection, the agent and GTE."""
    phase_row0_kernels(torch, report)
    for model in (lm, lm_int4):
        phase_long_verify(torch, model, proc, report)
        phase_long_paged_verify(torch, model, proc, report)
    stamp("phase 12 (a)")
    phase_constrain_reference(torch, params, proc)
    stamp("phase 12 (b)")
    for model in (lm, lm_int4):
        phase_constrain_parity(torch, params, model, proc, report)
    stamp("phase 12 (c) parity")
    for model in (lm, lm_int4):
        phase_constrain_full(torch, model, proc, report)
    stamp("phase 12 (c)")
    phase_agent(torch, lm, proc, report)
    stamp("phase 12 (d)")
    phase_gte(torch, report)
    stamp("phase 12")


def phase_checkpoint(torch, raw: str):
    """The port alone makes an 8-bit model: a 2-layer full-width random
    checkpoint (``create_random_checkpoint``) written at ``raw`` (phase 13
    (b) trains on its 4-bit copy), quantized to 8 bits
    (``quantize_checkpoint``), loaded on the card (``api._load``) and
    generating through ``api.generate`` on K8 (K1 never launched)."""
    import tempfile

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.core.weights import create_random_checkpoint, quantize_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        create_random_checkpoint(raw, "phi35_mini", seed=0, num_hidden_layers=2)
        t1 = time.perf_counter()
        cfg = quantize_checkpoint(raw, f"{tmp}/q8", q_bits=8)
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


# Phase 13: LoRA training and adapter serving.
# The seam's cases on the qkv shape: K1 at route A (M = 1) and route B (M =
# 64, 256), K8 and K9 at M = 64, the dequantize route at M = 384.
SEAM_SHAPE = (3072, 9216)
SEAM_CASES = (("K1", 1), ("K1", 64), ("K1", 256), ("K8", 64), ("K9", 64), ("dequantize", 384))
# dx through the seam (bf16 dy @ W^T on cuBLAS, W dequantized to bf16)
# against the plain version's autograd (the same W in an f32 product, then
# rounded to bf16): two bf16 ulps of |dx| (2-4 at these scales), plus an
# absolute term for elements near zero, where the f32 sums' order and
# cuBLAS's split reduction decide the last bits.
SEAM_DX_ATOL, SEAM_DX_RTOL = 2e-2, 2 * 2.0**-7
# Phase 13 (b): each step's loss on the card (bf16 base, f32 LoRA) against
# the fp32 CPU twin from the same initial A, and the cosine of each trained
# adapter tensor to the twin's.
LORA_LOSS_ATOL = 5e-2
LORA_COS_MIN = 0.9
TRAIN_RUNS = {"defaults": {}, "wide": dict(lora_layers=5, lora_rank=16, batch_size=2, epochs=2, mask_ratios=[0.0])}
# Phase 13 (b): train_lora with graphs against graphs=False on the same
# weights, in each of these settings (4 steps of 192-token rows: 1 row, 3
# rows, 1 row with dropout), and one step at 2048 positions (a 2000-character
# question: forward_nocache's blockwise attention from BLOCKWISE_MIN_LEN =
# 2048 positions on; a bucket of 2048 keeps its 512 x 1024 blocks, where
# 2176 halves them to 128 x 128).  Equal bit for bit (the same kernels in the
# same order), or within an eager run's own spread, printed.
GRAPH_PARITY_RUNS = {"plain": {}, "mask_ratios": dict(mask_ratios=[0.0, 0.1]), "dropout": dict(lora_dropout=0.1)}
LONG_QUESTION = (FILLER * 30)[:2000]
# A replayed 192-row step's idle share: the graph takes the host out of the step.
TRAIN_IDLE_MAX = 0.5
ADAPTER_TOKENS = 64
TM_PATHS = (("self_attn", "qkv_proj"), ("self_attn", "o_proj"), ("mlp", "gate_up_proj"), ("mlp", "down_proj"))
KERNEL_ROWS = 256  # ops/linear.py:KERNEL_MAX_ROWS: above it a linear takes the dequantize route


def phase_seam(torch, report):
    """Phase 13 (a): K1, K8 and K9 and the dequantize route under autograd
    (``ops/kernels/quant_matmul.py``'s Functions) at SEAM_CASES: the forward
    and ``dx`` against the plain version's autograd on the same inputs, no
    gradient to the payload, scales or biases, one counted launch a forward
    (none for the dequantize route or a backward); then the backward's ms
    beside its bound, the plain version's backward, the dequantization
    alone and ``torch.matmul`` on a W dequantized beforehand."""
    from phi_3_vision_mlx_tpu_torch.core.weights import (pack_int4, pack_int8, to_packed_layout, unpack_int4,
                                                         unpack_int8)
    from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as QM
    from phi_3_vision_mlx_tpu_torch.ops.quant import QTensor, dequantize

    k, n = SEAM_SHAPE
    g = torch.Generator(device="cuda").manual_seed(13)
    s4, b = w4_planes(torch, k, n, g)
    q4 = torch.randint(0, 16, (k, n), dtype=torch.uint8, device="cuda", generator=g)
    q8 = torch.randint(0, 256, (k, n), dtype=torch.uint8, device="cuda", generator=g)
    w4, w8, wp = pack_int4(q4), pack_int8(q8), to_packed_layout(q4)
    s8 = (s4.float() * 15 / 255).to(torch.bfloat16)  # 8-bit levels over the same range as 4-bit ones
    layouts = {  # name -> (Function, wrapper, plain, payload, unpack, payload bytes)
        "K1": (QM.QuantMatmulFn, QM.quant_matmul, QM.quant_matmul_plain, w4, unpack_int4, k * n // 2),
        "K8": (QM.QuantMatmulW8Fn, QM.quant_matmul_w8, QM.quant_matmul_w8_plain, w8, unpack_int8, k * n),
        "K9": (QM.QuantMatmulPackedFn, QM.quant_matmul_packed, QM.quant_matmul_packed_plain, wp,
               QM.packed_unpack(wp, s4), k * n // 2),
        "dequantize": (QM.DequantMatmulFn, None, None, w4, unpack_int4, k * n // 2),
    }
    for name, m in SEAM_CASES:
        fn, wrapper, plain, payload, unpack, wbytes = layouts[name]
        s = s8 if name == "K8" else s4
        w16 = dequantize(QTensor(unpack(payload), s, b), dtype=torch.bfloat16)
        if wrapper is None:
            last = (unpack,)
            plain = lambda x, *a, out_dtype=None: torch.matmul(x, w16)  # noqa: E731
        else:
            last = (torch.bfloat16,)
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16).requires_grad_()
        x2 = x.detach().clone().requires_grad_()
        sr, br = s.clone().requires_grad_(), b.clone().requires_grad_()
        dy = torch.randn((m, n), generator=g, device="cuda").to(torch.bfloat16)
        before = wrapper.launches if wrapper is not None else 0
        y = fn.apply(x, payload, sr, br, *last)
        launched = (wrapper.launches - before) if wrapper is not None else 0
        y_ref = plain(x2, payload, s, b, out_dtype=torch.bfloat16)
        y.backward(dy, retain_graph=True)
        y_ref.backward(dy, retain_graph=True)
        torch.cuda.synchronize()
        fwd_err, _, fwd_ok = close(torch, y, y_ref, K1_ATOL, 2.0**-7)
        dx_err, _, dx_ok = close(torch, x.grad, x2.grad, SEAM_DX_ATOL, SEAM_DX_RTOL)
        frozen = sr.grad is None and br.grad is None and payload.grad is None
        names = set()
        stack = [y.grad_fn]
        while stack:
            f = stack.pop()
            if f is not None:
                names.add(type(f).__name__)
                stack.extend(nf for nf, _ in f.next_functions)
        through = f"{fn.__name__}Backward" in names
        bwd = cuda_ms(torch, lambda: torch.autograd.grad(y, x, dy, retain_graph=True), 10)
        plain_bwd = cuda_ms(torch, lambda: torch.autograd.grad(y_ref, x2, dy, retain_graph=True), 10)
        deq = cuda_ms(torch, lambda: dequantize(QTensor(unpack(payload), s, b), dtype=torch.bfloat16), 10)
        lib = cuda_ms(torch, lambda: torch.matmul(dy, w16.t()), 10)
        bd = bound(wbytes + 2 * 2 * (k // 64) * n + 2 * m * n + 2 * m * k, 2 * m * k * n)
        log(f"phase 13 (a) seam {name} M={m} (qkv K={k} N={n}): forward max abs err {fwd_err:.3e} (limit "
            f"{K1_ATOL} + 2^-7 rel); dx max abs err {dx_err:.3e} (limit {SEAM_DX_ATOL} + {SEAM_DX_RTOL:.4f} rel) "
            f"against the plain version's autograd; through {fn.__name__}: {through}; no gradient to the "
            f"payload, scales, biases: {frozen}; forward launches {launched}; backward {bwd:.4f} ms (dequantize "
            f"alone {deq:.4f}, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}), plain backward "
            f"{plain_bwd:.4f} ms, torch.matmul on the pre-dequantized W {lib:.4f} ms")
        if not (fwd_ok and dx_ok and frozen and through):
            fail(f"phase 13 (a) seam {name} M={m}: forward ok {fwd_ok}, dx ok {dx_ok}, frozen {frozen}, "
                 f"through the Function {through}")
        if launched != (0 if wrapper is None else 1):
            fail(f"phase 13 (a) seam {name} M={m}: {launched} counted launches in one forward")
        entry = {"shape": f"seam backward qkv M={m}", "ms": bwd, "plain_ms": plain_bwd, "library_ms": lib,
                 "dequantize_ms": deq, "dx_max_abs_err": dx_err, **bd}
        report.setdefault("seam", []).append({"name": name, **entry})
        if wrapper is not None:
            report[name].setdefault("timings", []).append(entry)
        del y, y_ref, x, x2
    torch.cuda.empty_cache()


def lora_tensors(path: str) -> dict:
    from phi_3_vision_mlx_tpu_torch.core.weights import load_safetensors

    return load_safetensors(f"{path}/adapters.safetensors")


def train_losses(path: str) -> list:
    with open(f"{path}/adapter_train_log.json") as f:
        return json.load(f)["step_loss"]


def lora_run(torch, base, proc, path: str, graphs: bool, **kw):
    """``train_lora`` on the card through its entry point, its ``_load``
    pointed at an ``LM`` over ``base``'s weights with ``graphs`` on or off;
    returns (losses, adapter tensors, the run's static steps)."""
    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM
    from phi_3_vision_mlx_tpu_torch.train import trainer as TT

    lm = LM(base.cfg, base.params, device="cuda", graphs=graphs)
    runs = []

    class Kept(TT.TrainingCallback):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    with (mock.patch.object(api, "_load", lambda *a, **k: (lm, proc)),
          mock.patch.object(TT, "TrainingCallback", Kept)):
        TT.train_lora(adapter_path=path, device="cuda", **kw)
    return train_losses(path), lora_tensors(path), runs[0].steps


def run_gap(a, b) -> tuple:
    """(largest loss difference, largest adapter difference) of two runs."""
    return (max(abs(x - y) for x, y in zip(a[0], b[0], strict=True)),
            max(float((a[1][k] - b[1][k]).abs().max()) for k in a[1]))


def lora_graph_parity(torch, q: str) -> None:
    """Phase 13 (b), graphs: each GRAPH_PARITY_RUNS setting trained with
    graphs and with ``graphs=False`` on the 2-layer weights at ``q``; a run
    resumed from step 2 with graphs against the uninterrupted graph run; one
    step at the blockwise route's length.  Each pair bit for bit, or, where
    an eager run does not repeat itself, within its own spread (printed)."""
    import shutil

    import numpy as np

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.models.phi3 import BLOCKWISE_MIN_LEN

    base, proc = api._load(q, device="cuda")
    common = dict(model_path=q, dataset_path="synthetic", take=4, lora_layers=2, lora_rank=4)
    long_row = {"input": f"{LONG_QUESTION} A: x", "summary": "It is x.", "output": "A"}
    settings = {**{tag: {**common, **extra} for tag, extra in GRAPH_PARITY_RUNS.items()},
                "blockwise": {**common, "dataset_path": [long_row], "take": 1}}
    for tag, kw in settings.items():
        t0 = time.perf_counter()
        g = lora_run(torch, base, proc, f"adapters/{tag}-graph", True, **kw)
        t1 = time.perf_counter()
        e = lora_run(torch, base, proc, f"adapters/{tag}-eager", False, **kw)
        t2 = time.perf_counter()
        shapes = sorted(g[2])
        captured = all(st.graph.graphs and st.graph.graph is not None for st in g[2].values())
        gap = run_gap(g, e)
        line = (f"phase 13 (b) graphs, {tag}: {len(g[0])} steps of {shapes} (rows, length), graph run "
                f"{t1 - t0:.1f} s (captures {[round(st.graph.capture_ms, 1) for st in g[2].values()]} ms, pools "
                f"{[st.graph.pool_bytes for st in g[2].values()]} B), eager {t2 - t1:.1f} s; graph against eager: "
                f"losses {g[0]} / {e[0]}, largest differences {gap[0]!r} (loss), {gap[1]!r} (adapter)")
        ok = gap == (0.0, 0.0)
        if not ok:
            spread = run_gap(e, lora_run(torch, base, proc, f"adapters/{tag}-eager2", False, **kw))
            ok = gap[0] <= spread[0] and gap[1] <= spread[1]
            line += f"; the eager run's own spread {spread[0]!r} (loss), {spread[1]!r} (adapter)"
        log(line)
        long_enough = tag != "blockwise" or shapes[0][1] >= BLOCKWISE_MIN_LEN
        if not (ok and captured and long_enough and np.isfinite(g[0]).all()):
            fail(f"phase 13 (b) {tag}: graph and eager training runs differ beyond the eager spread, a step was "
                 f"not captured ({captured}), or the blockwise step was short ({shapes})")
        if tag == "plain":
            full = g
    # Resume: checkpoint every step, drop the last two states, resume with graphs.
    kw = settings["plain"]
    path = "adapters/resumed"
    lora_run(torch, base, proc, path, True, checkpoint_every=1, **kw)
    for step in ("3", "4"):
        shutil.rmtree(f"{path}/train_state/{step}")
    os.remove(f"{path}/adapters.safetensors")
    res = lora_run(torch, base, proc, path, True, resume=True, **kw)
    same = res[0] == full[0][2:] and all(torch.equal(res[1][k], full[1][k]) for k in full[1])
    log(f"phase 13 (b) graphs, resumed from step 2: losses {res[0]} against {full[0][2:]}, adapter bit for bit "
        f"{same}")
    if not same:
        fail("phase 13 (b): the resumed graph run differs from the uninterrupted one")
    del base


def phase_lora_reference(torch, raw: str):
    """Phase 13 (b): the 2-layer full-width checkpoint the port wrote in
    phase 7 (``raw``), quantized to 4 bits, ``train_lora`` through its entry point on the card
    (4 steps, 2 rows of 192 tokens: the dequantize route) and on the CPU in
    fp32 with the linears dequantized once (the trainer's ``_load`` pointed
    at that twin), both from the A the trainer draws on a CPU generator:
    each step's loss within LORA_LOSS_ATOL, each adapter tensor's cosine to
    the twin's at least LORA_COS_MIN.  Then the card's adapter through
    ``_load(adapter_path=)``, ``test_lora`` and ``generate(use_adapter=
    True)``."""
    import tempfile

    import numpy as np

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.core import weights as W
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM
    from phi_3_vision_mlx_tpu_torch.train import trainer as TT

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            q = api.PATH_QUANTIZED_PHI3_BLIND
            W.quantize_checkpoint(raw, q)
            kw = dict(model_path=q, dataset_path="synthetic", take=4, lora_layers=2, lora_rank=4, mask_ratios=[0.0])
            t0 = time.perf_counter()
            TT.train_lora(device="cuda", **kw)
            t1 = time.perf_counter()
            base, proc = api._load(q, device="cpu")
            twin = LM(base.cfg.replace(dtype="float32"), dequantized_linears(torch, base.params), device="cpu")
            with mock.patch.object(api, "_load", lambda *a, **k: (twin, proc)):
                TT.train_lora(adapter_path="adapters/cpu", device="cpu", **kw)
            t2 = time.perf_counter()
            card_dir = api._get_adapter_path(q)
            card, cpu = train_losses(card_dir), train_losses("adapters/cpu")
            dl = max(abs(a - b) for a, b in zip(card, cpu))
            ta, tb = lora_tensors(card_dir), lora_tensors("adapters/cpu")
            cos = {k: float(torch.nn.functional.cosine_similarity(ta[k].flatten(), tb[k].flatten(), dim=0))
                   for k in sorted(ta)}
            worst = min(cos, key=cos.get)
            log(f"phase 13 (b) train_lora, 2 layers, width 3072, 4 steps of 2 x 192 rows: card {t1 - t0:.1f} s, "
                f"CPU fp32 twin {t2 - t1:.1f} s; losses card {[round(x, 5) for x in card]}, CPU "
                f"{[round(x, 5) for x in cpu]}: largest difference {dl:.3e} (limit {LORA_LOSS_ATOL}); adapter "
                f"cosine to the twin's: least {cos[worst]:.5f} ({worst}), lora_b "
                f"{[round(v, 5) for k, v in cos.items() if k.endswith('lora_b')]} (limit {LORA_COS_MIN})")
            if (len(card) != 4 or len(cpu) != 4 or not np.isfinite(card).all() or dl > LORA_LOSS_ATOL
                    or cos[worst] < LORA_COS_MIN or sorted(ta) != sorted(tb)):
                fail("phase 13 (b): the card's training run disagrees with the CPU twin's")
            lora_graph_parity(torch, q)
            lm, proc = api._load(q, adapter_path=card_dir, device="cuda")
            node = lm.params["model"]["layers"]["self_attn"]["qkv_proj"]
            if node["lora_a"].dtype != torch.float32 or float(node["lora_b"].abs().max()) == 0:
                fail("phase 13 (b): _load(adapter_path=) did not apply the trained adapter")
            del lm
            t3 = time.perf_counter()
            scores = TT.test_lora(model_path=q, dataset_path="synthetic", take=2, device="cuda")
            t4 = time.perf_counter()
            text = api.generate(PROMPT_A, blind_model=True, quantize_model=True, use_adapter=True, max_tokens=16,
                                verbose=False, stream=False, mute=True)
            with open("test_result.csv", newline="") as f:
                rows = len(f.read().splitlines())
            log(f"phase 13 (b) test_lora(take=2) on the card in {t4 - t3:.1f} s: scores {scores}; CSV written "
                f"({rows} lines); generate(use_adapter=True) gave {len(text[0])} chars")
            if set(scores) != {"choose", "constrain", "beam"} or not text or not text[0]:
                fail(f"phase 13 (b): test_lora gave {scores}, generate gave {text!r}")
        finally:
            os.chdir(cwd)


def profile_window(torch, fn, tries: int = 3):
    """(device busy ms, device ms under the ``seam.dequantize`` range,
    kernels) of ``fn()`` under the profiler; a window with no kernel is
    profiled again (``fn`` must run more than once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels:
            busy = sum(e.device_time_total for e in kernels) / 1e3
            dq = sum(e.device_time_total for e in prof.events() if e.name == "seam.dequantize") / 1e3
            return busy, dq, len(kernels)
    return None, None, 0


def kernel_split(by_name: dict) -> dict:
    """Device ms by kind of kernel: K1's (``MATMUL_KERNELS``), cuBLAS's
    GEMMs and the rest (elementwise ops, the dequantization among them)."""
    out = {"K1": 0.0, "GEMM": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        kind = ("K1" if name in MATMUL_KERNELS else
                "GEMM" if any(w in name.lower() for w in ("gemm", "nvjet", "xmma", "cutlass")) else "other")
        out[kind] += ms
    return out


def step_walls(torch, graph, reps: int = 5) -> dict:
    """A training step's ``StepGraph`` replayed and its step run eagerly
    (on the same static inputs; each call takes one more optimizer step):
    wall (host clock around a synchronized call, median of ``reps``; eager
    3), busy (profiler, one call), idle share (None where the busy time
    exceeds the wall), kernels, and the replay's busy time by kind."""
    import numpy as np

    def wall(fn, n):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    out = {}
    for mode, fn, n in (("replay", graph, reps), ("eager", graph.step, 3)):
        w = wall(fn, n)
        by_name, kernels = kernel_times(torch, fn, 1)
        busy = sum(by_name.values()) or None
        out.update({f"{mode}_wall": w, f"{mode}_busy": busy, f"{mode}_kernels": kernels,
                    f"{mode}_idle": None if busy is None or busy > w else 1 - busy / w})
        if mode == "replay":
            out["replay_split"] = kernel_split(by_name)
    return out


def train_full(torch, cfg, params, proc, run: str, kw: dict, adapter_path: str):
    """One ``train_lora`` run at full size through its entry point, the
    trainer's ``_load`` pointed at an ``LM`` over the built weights; then
    one more step of that model profiled (forward, backward) and its
    gradients checked.  Returns the run's numbers."""
    import random

    import numpy as np

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM
    from phi_3_vision_mlx_tpu_torch.train import lora as L
    from phi_3_vision_mlx_tpu_torch.train import trainer as TT
    from phi_3_vision_mlx_tpu_torch.train.data import load_qa_dataset

    lm = LM(cfg, params, device="cuda")  # graphs: each batch shape's step is captured, then replayed
    stamps, callbacks = [], []

    class Timed(TT.TrainingCallback):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            callbacks.append(self)

        def __call__(self, step_loss):
            stamps.append(time.perf_counter())
            super().__call__(step_loss)

    kw = dict(dict(dataset_path="synthetic"), **kw)
    counters = zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the weights and whatever earlier phases hold
    t0 = time.perf_counter()
    with (mock.patch.object(api, "_load", lambda *a, **k: (lm, proc)),
          mock.patch.object(TT, "TrainingCallback", Timed)):
        TT.train_lora(adapter_path=adapter_path, device="cuda", **kw)
    total = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items() if fn.launches}
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30  # above what was held before
    losses = train_losses(adapter_path)
    walls = np.diff([t0] + stamps) * 1e3
    step_wall = float(np.median(walls[1:])) if len(walls) > 1 else float(walls[0])
    trained = lora_tensors(adapter_path)
    zero_b = [k for k, t in trained.items() if k.endswith("lora_b") and float(t.abs().max()) == 0]
    steps = callbacks[0].steps
    replayed = bool(steps) and all(st.graph.graphs and st.graph.graph is not None for st in steps.values())
    captures = {f"{r}x{l}": (st.graph.capture_ms, st.graph.pool_bytes) for (r, l), st in steps.items()}
    graph_step = step_walls(torch, next(iter(steps.values())).graph)

    # One more step of the trained model: forward and backward profiled
    # apart, the LoRA gradients checked.
    trainable, frozen = L.partition_lora(lm.params)
    leaves = L.lora_leaves(trainable)
    rows = TT._prompt_rows(load_qa_dataset("synthetic", kw.get("take", 10)))
    bs = kw.get("batch_size", 1)
    batch = TT.batch_to(TT._prepare_batch(proc, rows[:bs], kw.get("mask_ratios"), random.Random(0)), "cuda")
    loss_fn = TT.make_loss_fn(cfg)
    nl = cfg.num_hidden_layers
    active = list(range(nl - kw.get("lora_layers", 1), nl))
    mask = torch.zeros((nl,))
    mask[active] = 1.0
    out = {}

    def forward():
        out["loss"] = loss_fn(L.active_layers(trainable, mask), frozen, batch)

    def backward():
        out["loss"].backward(retain_graph=True)

    walls = {}
    for name, f in (("forward", forward), ("backward", backward)):  # host clock, synchronized
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            f()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t1) * 1e3)
        walls[name] = float(np.median(ts))
    fwd_busy, _, fwd_kernels = profile_window(torch, forward)
    for t in leaves:
        t.grad = None
    backward()
    torch.cuda.synchronize()
    node = lm.params["model"]["layers"]["self_attn"]["qkv_proj"]
    no_grad = [(i, key) for i in active[:-1] for key in ("lora_a", "lora_b")
               if float(node[key].grad[i].abs().max()) == 0]
    top_grad = float(node["lora_b"].grad[active[-1]].abs().max())
    bwd_busy, bwd_dq, bwd_kernels = profile_window(torch, backward)
    # The backward dequantizes W again for every linear whose input takes a
    # gradient: all four of each layer above the lowest active one, o,
    # gate_up and down of that one, and lm_head.  Their dequantization alone,
    # CUDA events, no profiler:
    from phi_3_vision_mlx_tpu_torch.core.weights import LAYOUTS
    from phi_3_vision_mlx_tpu_torch.ops.linear import layer_view
    from phi_3_vision_mlx_tpu_torch.ops.quant import QTensor, dequantize

    def deq_ms(leaf):
        unpack = LAYOUTS[cfg.quantized.bits][2]
        return cuda_ms(torch, lambda: dequantize(QTensor(unpack(leaf["qweight"]), leaf["scales"], leaf.get("biases")),
                                                 dtype=torch.bfloat16), 5)

    layers = lm.params["model"]["layers"]
    top = {path: deq_ms(layer_view(layers[path[0]][path[1]], nl - 1)) for path in TM_PATHS}
    bwd_deq = (sum(top.values()) * len(active) - top[("self_attn", "qkv_proj")]
               + deq_ms(lm.params["lm_head"]))
    tokens = int(batch["ids"].numel())

    def idle(b, w):  # None where the profiler's busy time exceeds the unprofiled wall
        return None if b is None or b > w else 1 - b / w

    res = dict(steps=len(losses), losses=losses, total_s=total, step_wall_ms=step_wall, rows=tokens,
               replayed=replayed, captures=captures, graph_step=graph_step,
               fwd_wall=walls["forward"], bwd_wall=walls["backward"], fwd_busy=fwd_busy, bwd_busy=bwd_busy,
               bwd_dq_profiled=bwd_dq, bwd_dequantize_ms=bwd_deq, dq_share=bwd_deq / walls["backward"],
               fwd_kernels=fwd_kernels, bwd_kernels=bwd_kernels, fwd_idle=idle(fwd_busy, walls["forward"]),
               bwd_idle=idle(bwd_busy, walls["backward"]), tok_s=tokens / step_wall * 1e3, peak_gib=peak,
               launches=launches)
    dev = lambda v: "not measured" if v is None else f"{v:.2f}"  # noqa: E731
    log(f"phase 13 (c) train_lora {run} {kw} at full size (32 layers, width 3072, 4-bit): {len(losses)} steps "
        f"of {tokens} rows in {total:.1f} s; losses {[round(x, 4) for x in losses]}; step wall median "
        f"{step_wall:.1f} ms; one more step: forward wall {walls['forward']:.2f} ms, busy {dev(fwd_busy)} ms "
        f"({fwd_kernels} kernels), idle share {dev(res['fwd_idle'])}; backward wall {walls['backward']:.2f} ms, "
        f"busy {dev(bwd_busy)} ms ({bwd_kernels} kernels; under seam.dequantize {dev(bwd_dq)} ms), idle share "
        f"{dev(res['bwd_idle'])}; the backward's dequantizations alone (CUDA events) {bwd_deq:.2f} ms, "
        f"{res['dq_share']:.3f} of its wall; {res['tok_s']:.1f} tokens/s; peak memory above the weights "
        f"{peak:.2f} GiB; "
        f"launches {launches}")
    gs = graph_step
    log(f"phase 13 (c) train_lora {run}, the step of {next(iter(steps))} (rows, length), replayed against eager: "
        f"wall {gs['replay_wall']:.2f} / {gs['eager_wall']:.2f} ms, busy {dev(gs['replay_busy'])} / "
        f"{dev(gs['eager_busy'])} ms ({gs['replay_kernels']} / {gs['eager_kernels']} kernels), idle share "
        f"{dev(gs['replay_idle'])} / {dev(gs['eager_idle'])}; the replay's busy time by kernel: "
        f"{by_text(gs['replay_split'])}; captures (ms, pool bytes) by shape {captures}; every step replayed: "
        f"{replayed}")
    if not np.isfinite(losses).all() or zero_b or no_grad or top_grad == 0:
        fail(f"phase 13 (c) {run}: non-finite loss {losses}, lora_b left 0 at {zero_b}, no LoRA gradient "
             f"below the top layer at {no_grad}, top layer's lora_b gradient {top_grad}")
    if not replayed or (tokens <= 192 and (gs["replay_idle"] is None or gs["replay_idle"] > TRAIN_IDLE_MAX)):
        fail(f"phase 13 (c) {run}: a step was not captured and replayed ({replayed}), or the replayed "
             f"{tokens}-row step's idle share {gs['replay_idle']} is above {TRAIN_IDLE_MAX}")
    k1_expected = tokens <= KERNEL_ROWS  # else every linear takes the dequantize route
    if (launches.get("K1", 0) > 0) != k1_expected or launches.get("K2", 0):
        fail(f"phase 13 (c) {run}: launches {launches} at {tokens} rows (K1 expected: {k1_expected}; no K2: "
             "training runs no flash)")
    for t in leaves:
        t.grad = None
    del lm, out
    torch.cuda.empty_cache()
    return res


def phase_adapter_serving(torch, cfg, params, proc, adapter_path: str, report):
    """Phase 13 (d): the trained adapter applied with ``load_adapter`` to
    the full-size weights; greedy ``api.generate`` of ADAPTER_TOKENS
    tokens with the dense and with the int4 cache, every decode step a graph
    replay over the LoRA leaves, against the same model with
    ``graphs=False``: the same text, the launch totals of the eager run plus
    the capture's warm-up step; the adapter moves the prefill's logits;
    then the graph step's wall, busy and idle share."""
    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.core.weights import load_adapter
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM, prefill_decoder, release_decoder, run_prefill

    params_ad = load_adapter(params, cfg, adapter_path)
    dict_input = proc(api._apply_chat_template(PROMPT_A)[0])
    for quantized in (False, True):
        c = cfg.replace(use_quantized_cache=quantized)
        lm = LM(c, params_ad, device="cuda")
        eager = eager_twin(lm)
        texts, launches = {}, {}
        for mode, m in (("eager", eager), ("graph", lm)):
            counters = zero_counters()
            texts[mode] = api.generate(PROMPT_A, preload=(m, proc), max_tokens=ADAPTER_TOKENS, verbose=False,
                                       stream=False, mute=True)
            launches[mode] = {name: fn.launches for name, fn in counters.items()}
        entry = next(iter(lm.decoders.values()), None)  # the graph run's decoder, released
        graph = None if entry is None else entry.graph
        want = launches["eager"] if graph is None else plus_warm_up(launches["eager"], graph)
        captured = graph is not None and graph.graph is not None
        with torch.no_grad():
            moved = float((run_prefill(eager, dict_input, 8)[0]
                           - run_prefill(LM(c, params, device="cuda", graphs=False), dict_input, 8)[0]).abs().max())
        dec, _ = prefill_decoder(lm, dict_input, ADAPTER_TOKENS)
        wall, per_name, kernels = step_profile(torch, dec, 16, 4)
        release_decoder(lm, dec)
        busy = sum(per_name.values())
        label = "int4" if quantized else "dense"
        log(f"phase 13 (d) adapter serving ({label} cache, 5 LoRA layers of rank 16 on qkv): {ADAPTER_TOKENS} "
            f"greedy tokens, graph text equal to eager: {texts['graph'] == texts['eager']}; graph captured: "
            f"{captured}; launch totals as expected: {launches['graph'] == want} "
            f"{launches['graph']}; the adapter moves the prefill logits by up to {moved:.4f}; graph step wall "
            f"{wall:.2f} ms, busy {busy:.3f} ms, idle share {1 - busy / wall if busy > 0 else float('nan'):.3f}, "
            f"{kernels:.0f} nodes")
        if texts["graph"] != texts["eager"] or launches["graph"] != want or not captured or moved == 0:
            fail(f"phase 13 (d) {label}: graph and eager adapter runs differ, or the adapter changed nothing")
        report.setdefault("adapter_serving", {})[label] = dict(wall=wall, busy=busy, nodes=kernels)
        del lm, eager
        torch.cuda.empty_cache()


# Phase 13 (e): the tiny induction model (train/pretrain.py), the JAX
# defaults: 240 steps of 8 x 128 tokens, scan_steps 16 (and 1); held-out
# docs of 24 phrases, 96 tokens each at K = SPEC_K.  Its attention is K2 and
# K3 at head dim 32 (4 heads over 2 kv heads), checked here at its shapes:
# a 216-token prompt's prefill (lq 256 over a 384-key window, left pad 40)
# and verify passes of Lq 1 and 8 at the window's offset 300.
INDUCTION_DOCS = 3
HD32 = dict(h=4, kvh=2, d=32, lq=256, lk=384, pad=40, offset=300)


def phase_hd32_kernels(torch, report) -> None:
    """Phase 13 (e): K2 (bf16, fp32) and K3 (bf16, fp32; Lq 1 and 8) at head
    dim 32 against their plain versions, at HD32's shapes, with phase 2's
    tolerances (K2_ATOL / ATTN_ATOL + ATTN_RTOL in bf16, F32_ATOL + F32_RTOL
    in fp32); the fp32 ones, which the induction model runs, timed
    (:func:`hd32_timing`)."""
    from phi_3_vision_mlx_tpu_torch.ops.kernels import flash_attention as K2
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as K3

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(23)
    h, kvh, d, lq, lk, pad, offset = (HD32[k] for k in ("h", "kvh", "d", "lq", "lk", "pad", "offset"))
    scale = d**-0.5
    nl = 8  # layers of the stacked cache, rotated in the timing
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        tag = "fp32" if f32 else "bf16"
        q = torch.randn((1, lq, h, d), generator=g, device=dev).to(dtype).transpose(1, 2)
        kk, vv = (torch.randn((1, kvh, lk, d), generator=g, device=dev).to(dtype) for _ in range(2))
        valid = torch.ones((1, lk), dtype=torch.bool, device=dev)
        valid[:, :pad] = False
        out = K2.flash_attention(q, kk, vv, valid, 0, scale)
        ref = K2.flash_attention_plain(q, kk, vv, valid, 0, scale)
        torch.cuda.synchronize()
        atol, rtol = (F32_ATOL, F32_RTOL) if f32 else (K2_ATOL, ATTN_RTOL)
        ea, _, ok = close(torch, out, ref, atol, rtol)
        shape = f"{tag} D=32 lq={lq} lk={lk} pad={pad} H={h} KV={kvh} (induction prefill)"
        if not ok or out.dtype != dtype:
            fail(f"phase 13 (e): K2 at head dim 32 ({tag}) disagrees with its plain version: {ea:.3e}")
        if not f32:  # checked only: the induction model (fp32) runs the fp32 entries
            log(f"phase 13 (e) K2 {shape}: max_abs={ea:.3e} (atol {atol} + rtol {rtol:.4g})")
        else:
            hd32_timing(torch, report, "K2", shape, q, kk, vv, valid, ea, atol, rtol)
        ks, vs = (torch.randn((nl, 1, kvh, lk, d), generator=g, device=dev).to(dtype) for _ in range(2))
        off_t = dev_offset(torch, offset)
        atol = F32_ATOL if f32 else ATTN_ATOL
        for lq3 in (1, SPEC_K + 1):
            q3 = torch.randn((1, lq3, h, d), generator=g, device=dev).to(dtype).transpose(1, 2)
            out = K3.dense_kv_attention(q3, ks, vs, valid, off_t, nl - 1, scale)
            ref = K3.dense_kv_attention_plain(q3, ks, vs, valid, offset, nl - 1, scale)
            torch.cuda.synchronize()
            ea, _, ok = close(torch, out, ref, atol, rtol)
            shape = f"{tag} D=32 Lq={lq3} Lmax={lk} offset={offset} H={h} KV={kvh} (induction verify)"
            if not ok or out.dtype != dtype:
                fail(f"phase 13 (e): K3 at head dim 32 ({tag}, Lq {lq3}) disagrees with its plain version: "
                     f"{ea:.3e}")
            if not f32:
                log(f"phase 13 (e) K3 {shape}: max_abs={ea:.3e} (atol {atol} + rtol {rtol:.4g})")
            else:
                hd32_timing(torch, report, "K3", shape, q3, ks, vs, valid, ea, atol, rtol)
        del q, kk, vv, ks, vs


def hd32_timing(torch, report, name, shape, q, k, v, valid, ea, atol, rtol) -> None:
    """Phase 13 (e): fp32 K2 (``k`` and ``v`` one layer's) or K3 (the
    stacked cache, layers rotated) at head dim 32 timed beside its plain
    version, its bound (bytes at 3.35 TB/s, or operations: K2's at 165
    TFLOP/s of 3xTF32 products, K3's at 67 TFLOP/s f32) and fp32 SDPA over
    the same mask; kept in ``report[name]["timings"]``."""
    import torch.nn.functional as F

    from phi_3_vision_mlx_tpu_torch.ops.attention import causal_valid_mask
    from phi_3_vision_mlx_tpu_torch.ops.kernels import flash_attention as K2
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as K3

    h, kvh, d, offset = HD32["h"], HD32["kvh"], HD32["d"], HD32["offset"]
    scale, lq, lk = d**-0.5, q.shape[2], valid.shape[1]
    if name == "K2":
        t = timed(torch, lambda: K2.flash_attention(q, k, v, valid, 0, scale),
                  lambda: K2.flash_attention_plain(q, k, v, valid, 0, scale), 20)
        mask = causal_valid_mask(valid, torch.arange(lq, device="cuda"))
        bd = bound(4 * (2 * q.numel() + 2 * kvh * lq * d) + lk, 4 * h * d * int(mask.sum()), rate=TF32X3_FLOPS)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale,
                                                                    enable_gqa=True), 20)
    else:
        nl = k.shape[0]
        off_t, nxt = dev_offset(torch, offset), rotating(nl)
        t = timed(torch, lambda: K3.dense_kv_attention(q, k, v, valid, off_t, nxt(), scale),
                  lambda: K3.dense_kv_attention_plain(q, k, v, valid, off_t, nxt(), scale), 20)
        keys = min(lk, offset + lq)
        mask = causal_valid_mask(valid[:, :keys], offset + torch.arange(lq, device="cuda"))
        bd = bound(4 * (2 * kvh * keys * d + 2 * h * lq * d) + lk, 4 * h * d * int(mask.sum()), rate=FP32_FLOPS)

        def library():
            layer = nxt()
            return F.scaled_dot_product_attention(q, k[layer][:, :, :keys], v[layer][:, :, :keys], attn_mask=mask,
                                                  scale=scale, enable_gqa=True)

        lib = cuda_ms(torch, library, 20)
    report[name].setdefault("timings", []).append({"shape": shape, **t, "library_ms": lib, **bd, "max_abs_err": ea})
    log(f"phase 13 (e) {name} {shape}: max_abs={ea:.3e} (atol {atol} + rtol {rtol:.4g}) {t.pop('text')} bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}) library (fp32 SDPA, same mask) {lib:.4f} ms")


def phase_induction(torch, report) -> None:
    """Phase 13 (e): ``train_induction_lm`` on the card with the JAX
    defaults at ``scan_steps`` 16 and 1 (each loss history must fall below
    half its first loss; the two runs' largest loss difference printed),
    K2/K3 at head dim 32 (:func:`phase_hd32_kernels`), then
    ``measure_tokens_per_pass`` on INDUCTION_DOCS held-out docs through
    ``api.generate(speculative=True)``: K2 and K3 launched, tokens a pass
    strictly between 1 and K + 1."""
    import tempfile

    import numpy as np

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.train import pretrain as TP

    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for scan in (16, 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cfg, losses = TP.train_induction_lm(f"{tmp}/scan{scan}", scan_steps=scan, device="cuda")
            runs[scan] = (losses, time.perf_counter() - t0)
        gap = max(abs(a - b) for a, b in zip(runs[16][0], runs[1][0]))
        log(f"phase 13 (e) train_induction_lm (JAX defaults: {len(runs[16][0])} steps of 8 x 128, head dim "
            f"{cfg.head_dim}): scan_steps 16 in {runs[16][1]:.2f} s ({runs[16][1] / len(runs[16][0]) * 1e3:.2f} ms a "
            f"step), scan_steps 1 in {runs[1][1]:.2f} s ({runs[1][1] / len(runs[1][0]) * 1e3:.2f} ms a step; both with "
            f"their captures); losses {runs[16][0][0]:.4f} -> {runs[16][0][-1]:.4f} / "
            f"{runs[1][0][0]:.4f} -> {runs[1][0][-1]:.4f}; largest loss difference between the runs {gap!r}")
        for scan, (losses, _) in runs.items():
            if not np.isfinite(losses).all() or not losses[-1] < 0.5 * losses[0]:
                fail(f"phase 13 (e): the induction model did not learn at scan_steps {scan}: {losses[0]} -> "
                     f"{losses[-1]}")
        phase_hd32_kernels(torch, report)
        lm, proc = api._load(f"{tmp}/scan16", device="cuda")
        rng = np.random.default_rng(99)  # held-out docs (training drew from seed 1)
        counters = zero_counters()
        tpps, walls, passes = [], [], 0
        with mock.patch.dict(os.environ, {"PHI3V_TPU_SPEC_K": str(SPEC_K)}):
            for _ in range(INDUCTION_DOCS):
                doc = TP.induction_docs(rng, 1, n_phrases=4, phrase_len=8, phrases_per_doc=24)[0]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tpp, _ = TP.measure_tokens_per_pass((lm, proc), doc, max_tokens=96, spec_k=SPEC_K)
                walls.append(time.perf_counter() - t0)
                tpps.append(tpp)
                passes += lm._spec_stats["iters"]
        launches = read_counts(counters)
        mean = float(np.mean(tpps))
        log(f"phase 13 (e) measure_tokens_per_pass on {INDUCTION_DOCS} held-out docs at K = {SPEC_K}: tokens a "
            f"pass {[round(x, 3) for x in tpps]} (mean {mean:.3f}; strictly between 1 and {SPEC_K + 1}); "
            f"{sum(walls):.2f} s for {passes} passes ({sum(walls) / passes * 1e3:.2f} ms a pass, prefill "
            f"included); launches (total, fp32) K2 {launches['K2']}, K3 {launches['K3']}")
        report["induction"] = dict(tokens_a_pass=tpps, train_s={k: v[1] for k, v in runs.items()},
                                   ms_a_pass=sum(walls) / passes * 1e3, launches=launches)
        if not 1.0 < mean < SPEC_K + 1 or launches["K2"][0] <= 0 or launches["K3"][0] <= 0:
            fail(f"phase 13 (e): tokens a pass {tpps}, launches {launches}")
        del lm


def phase_train(torch, cfg, params, proc, report, raw: str):
    """Phase 13: (a) the autograd seam, (b) 2 layers against the CPU
    through the entry points (the checkpoint ``raw`` of phase 7), graphs
    against eager, (c) full-size ``train_lora`` with the JAX defaults and a
    wider run, each step a graph replay, (d) the wider run's adapter served,
    (e) the induction model trained and served with speculation."""
    import gc
    import tempfile

    gc.collect()  # earlier phases' dropped models: their graphs and caches
    torch.cuda.empty_cache()
    phase_seam(torch, report)
    stamp("phase 13 (a)")
    phase_lora_reference(torch, raw)
    stamp("phase 13 (b)")
    with tempfile.TemporaryDirectory() as tmp:
        for run, kw in TRAIN_RUNS.items():
            report.setdefault("train", {})[run] = train_full(torch, cfg, params, proc, run, kw, f"{tmp}/{run}")
        stamp("phase 13 (c)")
        phase_adapter_serving(torch, cfg, params, proc, f"{tmp}/wide", report)
    stamp("phase 13 (d)")
    phase_induction(torch, report)
    stamp("phase 13")


# Phase 14: the runbook (verify.py) and the reference's benchmark at full
# width, cut to GATE_LAYERS decoder layers (config 5 trains LoRA on 5), config
# 5's long window at the real gate's GATE_WINDOW tokens.
GATE_LAYERS = 6
GATE_WINDOW = 32768
# The kernels each config must launch (verify record): config 1 runs K2 and K3
# in fp32 only, and no K1.
GATE_KERNELS = {1: ("K2", "K3"), 2: ("K4", "K5"), 3: ("K1",), 4: ("K2", "K3"), 5: ("K1", "K4", "K5")}
GATE_PROMPT = "Write a mystery horror."


def fp32_counters() -> dict:
    """The fp32 kernels' shares of K2's and K3's launches."""
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as KV
    from phi_3_vision_mlx_tpu_torch.ops.kernels.flash_attention import flash_attention

    return {"K2 fp32": flash_attention.fp32, "K3 fp32": KV.dense_kv_attention.fp32}


def refuse_network(*args, **kw):
    raise OSError("chip_smoke.py phase 14: no network")


def verify_config(torch, mode: str, n: int, common: list, tag: str) -> dict:
    """``verify <mode>`` of config ``n``: it must return 0 and launch the
    config's kernels (GATE_KERNELS; config 1 fp32 kernels only, the others
    none).  Logs its seconds; returns its launches."""
    from phi_3_vision_mlx_tpu_torch import verify

    counters = {**kernel_counters(), **fp32_counters()}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = verify.main([mode, "--configs", str(n), *common])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    log(f"{tag} verify {mode} {verify.CFG_NAMES[n]}: rc {rc} in {secs:.1f} s; launches {launches}")
    if rc != 0:
        fail(f"{tag}: verify {mode} of config {n} returned {rc}")
    if any(not launches.get(k) for k in GATE_KERNELS[n]):
        fail(f"{tag}: config {n} did not launch {GATE_KERNELS[n]}: {launches}")
    fp32 = launches.get("K2 fp32", 0), launches.get("K3 fp32", 0)
    if n == 1 and (fp32 != (launches.get("K2"), launches.get("K3")) or "K1" in launches):
        fail(f"{tag}: config 1 (fp32) ran other than fp32 K2 and K3 kernels: {launches}")
    if n != 1 and any(fp32):
        fail(f"{tag}: config {n} (bf16) launched an fp32 kernel: {launches}")
    return launches


def phase_verify(torch, report):
    """Phase 14 (a): ``verify record`` then ``verify check`` of configs 1-5
    (synthetic QA rows, config 5 at GATE_WINDOW), each config's seconds and
    launches; then one flipped token in config 1's golden must fail."""
    from phi_3_vision_mlx_tpu_torch import api, verify
    from phi_3_vision_mlx_tpu_torch.core.registry import processor_for

    common = ["--golden", "goldens", "--dataset", "synthetic", "--long-window", str(GATE_WINDOW),
              "--device", "cuda"]
    proc = processor_for("Phi3ForCausalLM")(api.PATH_QUANTIZED_PHI3_BLIND)
    t0 = time.perf_counter()
    prompt, n_tok = verify._long_prompt(proc, GATE_WINDOW)
    log(f"phase 14 (a) config 5's long prompt sized on the host: {n_tok} tokens ({len(prompt)} chars) in "
        f"{time.perf_counter() - t0:.2f} s")
    for mode in ("record", "check"):
        for n in sorted(verify.CFG_NAMES):
            launches = verify_config(torch, mode, n, common, "phase 14 (a)")
            if mode == "record" and n in (1, 2, 5):
                report.setdefault("gate_launches", {})[n] = launches
    with open(os.path.join("goldens", f"{verify.CFG_NAMES[5]}.json")) as f:
        case = json.load(f)["cases"][0]
    log(f"phase 14 (a) config 5: a {case['long_prompt_tokens']}-token prompt in a {case['long_window']}-token "
        f"window over the int4 cache, {len(case['long_tokens'][0])} tokens decoded")
    path = os.path.join("goldens", f"{verify.CFG_NAMES[1]}.json")
    with open(path) as f:
        golden = json.load(f)
    golden["cases"][0]["tokens"][0][0] ^= 1
    with open(path, "w") as f:
        json.dump(golden, f)
    rc = verify.main(["check", "--configs", "1", *common])
    log(f"phase 14 (a) verify check with one token of config 1's golden flipped: rc {rc}")
    if rc != 1:
        fail(f"phase 14 (a): a corrupted golden passed verify check (rc {rc})")


def phase_benchmark(torch):
    """Phase 14 (b): ``benchmark(train_first=True, dataset_path="synthetic")``
    on the vision default; the Met Museum URL fails at once (no socket
    opens) and the local test image stands in.  benchmark.json must hold 4
    configs x 3 tasks, every generation rate above 0."""
    import socket

    from phi_3_vision_mlx_tpu_torch import bench
    from phi_3_vision_mlx_tpu_torch.utils import media

    t0 = time.perf_counter()
    with mock.patch.object(media, "_http_get", refuse_network), \
            mock.patch.object(socket.socket, "connect", refuse_network), \
            mock.patch.object(socket, "create_connection", refuse_network):
        results = bench.benchmark(train_first=True, dataset_path="synthetic", device="cuda")
    secs = time.perf_counter() - t0
    with open("benchmark.json") as f:
        data = json.load(f)
    log(f"phase 14 (b) benchmark(train_first=True) at {GATE_LAYERS} layers in {secs:.1f} s: {json.dumps(data)}")
    if (set(data) != {"vanilla", "q_model", "q_cache", "lora"} or data != json.loads(json.dumps(results))
            or any(len(rows) != 3 or not all(r[2] > 0 for r in rows) for rows in data.values())):
        fail(f"phase 14 (b): benchmark.json is not 4 configs x 3 tasks with generation rates above 0: {data}")


def phase_chat_and_step_log(torch):
    """Phase 14 (c): a ChatSession over the port's Agent (text model), one
    turn, then reset.  (d): config 1's fp32 model through ``api.generate``,
    64 tokens, twice (the first captures the decode graph), the second under
    ``PHI3V_TPU_STEP_LOG``: its summary, and both runs' tok/s."""
    import contextlib
    import io

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.agent.agent import Agent
    from phi_3_vision_mlx_tpu_torch.serve.ui import ChatSession

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        session = ChatSession(Agent(blind_model=True, device="cuda", max_tokens=64))
        session.add_user_message("Say something about lighthouses.", [])
        history = list(session.run_agent())
        reset = session.reset()
    log(f"phase 14 (c) ChatSession over Agent: {len(history)} history entries, the reply "
        f"{str(history[-1][1])[:60]!r}...; reset gives {reset}")
    if len(history) < 2 or history[0] != ("Say something about lighthouses.", None) or reset != []:
        fail(f"phase 14 (c): the chat session's turn or reset went wrong: {history[:3]}")

    preload = api._load(api.PATH_ORIGINAL_PHI3_BLIND, jax_dtype="float32", device="cuda")
    if preload[0].cfg.dtype != "float32":
        fail(f"phase 14 (d): config 1's model loaded as {preload[0].cfg.dtype}")
    kw = dict(preload=preload, max_tokens=64, return_tps=True, verbose=False, stream=False, mute=True)
    first = api.generate(GATE_PROMPT, **kw)
    with mock.patch.dict(os.environ, {"PHI3V_TPU_STEP_LOG": "steps.json"}):
        second = api.generate(GATE_PROMPT, **kw)
    with open("steps.json") as f:
        summary = json.load(f)
    log(f"phase 14 (d) config 1's fp32 model ({GATE_LAYERS} layers), 64 tokens: prompt / decode tok/s "
        f"{first[0]:.2f} / {first[1]:.2f} (captures the graph), {second[0]:.2f} / {second[1]:.2f} (replays); "
        f"PHI3V_TPU_STEP_LOG summary {summary}")
    if summary.get("n", 0) < 1 or not second[1] > 0:
        fail(f"phase 14 (d): the step log holds no decode chunk: {summary}")


def phase_gates(torch, report):
    """Phase 14 in a temporary working directory (``_setup``, ``verify``,
    ``benchmark`` and the agent write there), restored afterwards:
    ``_setup`` writes both random pairs at full width and GATE_LAYERS
    layers, then (a)-(d)."""
    import tempfile

    from phi_3_vision_mlx_tpu_torch import api

    cwd = os.getcwd()
    env = {"PHI3V_TPU_ALLOW_RANDOM": "1", "PHI3V_TPU_RANDOM_LAYERS": str(GATE_LAYERS)}
    with tempfile.TemporaryDirectory() as work, mock.patch.dict(os.environ, env):
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            api._setup()
            with open(os.path.join(api.PATH_ORIGINAL_PHI3_BLIND, "config.json")) as f:
                width = json.load(f)["hidden_size"]
            log(f"phase 14 _setup: both random pairs at width {width}, {GATE_LAYERS} layers, written in "
                f"{time.perf_counter() - t0:.1f} s")
            phase_verify(torch, report)
            torch.cuda.empty_cache()
            stamp("phase 14 (a)")
            phase_benchmark(torch)
            torch.cuda.empty_cache()
            stamp("phase 14 (b)")
            phase_chat_and_step_log(torch)
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    stamp("phase 14")


# Phase 15 (and phase 2's checks at its shapes): long context and checkpoint
# I/O.  A 130900-token prompt, bucketed to 130944 (left pad 44), decoded in a
# 131072-position window (max_tokens 128).  The in-HBM path prefills it in
# chunks of PREFILL_CHUNK = 16384 rows, the last starting at 114688, and
# decodes from offset 130944.
WINDOW_128K = 131072
PROMPT_128K = 130900
BUCKET_128K = 130944
MAX_TOKENS_128K = WINDOW_128K - BUCKET_128K
OFFSETS_128K = (130943, 131071, 100)  # the last prompt key, the window's end, a short prefix
CHUNK_128K = 114688  # the last prefill chunk's first row
# Phase 2's 128K caches stack 7 layers: the last one starts past 2**31
# elements (6 x 32 x 131072 x 96 = 2.42e9), where an offset product in 32
# bits would read another layer.
LAYERS_128K = 7
ROW_SLICE = 256  # rows of a 16384-query chunk held against the plain version at once
PARITY_STEPS_128K = (8, 24)  # graph against eager on the 128K state, chunk by chunk
PROFILE_STEPS_128K = 16
# The tiered engine's chunk at each window: a divisor of the prompt's bucket
# (window - 128), so its prompt has the in-HBM path's padding and positions;
# one key block a chunk.  131072: 33 chunks of 3968 (= 130944); 65536: 7 of
# 9344 (= 65408).  Decode runs on the state as prefilled, through
# ``decode_step`` (the tokens) and ``decode_chunk`` (``generate``'s steps,
# timed).
TIERED_CHUNKS = {131072: 3968, 65536: 9344}
TIERED_STEPS = 8
# The tiered engine's logits against the in-HBM int4 path's on the same
# prompt: the tiered attention is plain PyTorch (bf16 dots, f32 sums, stats
# merged block by block, chunks of 3968) and the in-HBM path's K5 and K4
# (bf16 P, chunks of 16384), and each path quantizes its own keys, so their
# activations differ by bf16 rounding, which 32 layers of random weights
# amplify (phase 3).  H100 runs measured 2.14e-2 and 2.21e-2 in relative L2
# for the first logits and 2.14e-2 for the first decode step (fed the
# in-HBM first token), and 6.47e-2 for that step with a planted fault, one
# cold chunk of 33 (3968 of 130944 keys) masked; REF_INT4_OWN_REL_L2
# (7.5e-2) would pass that fault.  TIERED_REL_L2 sits between the two; the
# planted fault runs every time and must read above it.  Greedy tokens
# agree up to their first difference, which must be a near tie as phase 11
# (b) judges one: at that step, over the in-HBM prefix, the two paths'
# logits within TIERED_REL_L2 and the in-HBM step's gap between its token
# and the tiered one no larger than the change of those tokens' log-probs
# between the paths, nor than NEAR_TIE_ULPS bf16 ulps of its top logit.
TIERED_REL_L2 = 4e-2


def phase_long_kernels(torch, report):
    """K2, K3, K4 and K5 at phase 15's 128K shapes against their plain
    versions: K3 and K4 (Lq = 1) over a 131072-key window at the offsets of
    OFFSETS_128K, in the first layer and the seventh (past 2**31 elements);
    K2 (dense cache) and K5 (int4 cache) on the last 16384-query prefill
    chunk (q_pos0 114688) over 131072 keys, its rows held in slices of
    ROW_SLICE (the plain version of the whole chunk does not fit the card:
    its f32 scores are 256 GiB).  Each timed, with its bound and, where one
    call fits, SDPA's time."""
    import torch.nn.functional as F

    from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig
    from phi_3_vision_mlx_tpu_torch.engine.state import quantize_chunk
    from phi_3_vision_mlx_tpu_torch.ops.attention import causal_valid_mask
    from phi_3_vision_mlx_tpu_torch.ops.kernels import flash_attention as K2
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as KV

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(15)
    b_, h, kvh, d, lmax, nl = 1, 32, 32, 96, WINDOW_128K, LAYERS_128K
    scale = d**-0.5
    pad = BUCKET_128K - PROMPT_128K
    top = nl - 1
    valid = torch.ones((b_, lmax), dtype=torch.bool, device=dev)
    valid[:, :pad] = False
    q1 = torch.randn((b_, 1, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    lq = WINDOW_128K - CHUNK_128K
    qc = torch.randn((b_, lq, h, d), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    # Causal pairs of the chunk: row i at position q_pos0 + i sees keys pad..q_pos0 + i.
    chunk_pairs = lq * (CHUNK_128K + 1 - pad) + lq * (lq - 1) // 2
    slices = (0, BUCKET_128K - CHUNK_128K - ROW_SLICE, lq - ROW_SLICE)

    def stack():
        t = torch.empty((nl, b_, kvh, lmax, d), dtype=torch.bfloat16, device=dev)
        for layer in range(nl):
            t[layer].normal_(generator=g)
        return t

    def decode_checks(name, kernel, plain, *cache):
        errs = []
        for offset in OFFSETS_128K:
            for layer in (0, top):
                out = kernel(q1, *cache, valid, dev_offset(torch, offset), layer, scale)
                ref = plain(q1, *cache, valid, offset, layer, scale)
                torch.cuda.synchronize()
                ea, er, ok = close(torch, out, ref, ATTN_ATOL, ATTN_RTOL)
                errs.append(ea)
                log(f"{name} Lq=1 Lmax={lmax} offset={offset} layer {layer} of {nl} pad={pad}: max_abs={ea:.3e} "
                    f"(atol {ATTN_ATOL} + rtol {ATTN_RTOL:.4f})")
                if not ok:
                    fail(f"{name} disagrees with its plain version at Lmax={lmax} offset={offset} layer={layer}")
        return errs

    def chunk_checks(name, kernel, plain):
        """The whole chunk through the kernel once, its rows held on slices."""
        out = kernel(qc, CHUNK_128K)
        errs = []
        for r0 in slices:
            ref = plain(qc[:, :, r0 : r0 + ROW_SLICE], CHUNK_128K + r0)
            torch.cuda.synchronize()
            ea, er, ok = close(torch, out[:, :, r0 : r0 + ROW_SLICE], ref, K2_ATOL, ATTN_RTOL)
            errs.append(ea)
            log(f"{name} lq={lq} lk={lmax} q_pos0={CHUNK_128K} pad={pad}, rows {r0}-{r0 + ROW_SLICE - 1}: "
                f"max_abs={ea:.3e} max(|err| - rtol |ref|)={excess(out[:, :, r0 : r0 + ROW_SLICE], ref):.3e} "
                f"(atol {K2_ATOL} + rtol {ATTN_RTOL:.4f})")
            if not ok:
                fail(f"{name} disagrees with its plain version on rows {r0}-{r0 + ROW_SLICE - 1} of the "
                     f"128K chunk")
            del ref
        del out
        return errs

    def chunk_timing(name, kernel, plain, nbytes, library=None):
        """The whole chunk's kernel time; the plain version's on one slice."""
        ms = cuda_ms(torch, lambda: kernel(qc, CHUNK_128K), 2, warmup=1)
        dms = device_ms(torch, lambda: kernel(qc, CHUNK_128K), 2)
        s_ms = cuda_ms(torch, lambda: kernel(qc[:, :, :ROW_SLICE], CHUNK_128K), 4)
        p_ms = cuda_ms(torch, lambda: plain(qc[:, :, :ROW_SLICE], CHUNK_128K), 2, warmup=1)
        lib = None
        if library is not None:
            try:
                lib = cuda_ms(torch, library, 2, warmup=1)
            except torch.OutOfMemoryError:
                log(f"{name}: SDPA over the 128K chunk's mask does not fit beside the phase: library not measured")
            torch.cuda.empty_cache()
        b2 = bound(nbytes, 4 * h * d * chunk_pairs)
        entry = {"shape": f"lq={lq} lk={lmax} q_pos0={CHUNK_128K} pad={pad} H=32 D=96 (the 128K prompt's "
                          f"last prefill chunk)", "ms": ms, "device_ms": dms, "plain_ms": None,
                 "plain_device_ms": None, "slice_ms": s_ms, "slice_plain_ms": p_ms, "library_ms": lib, **b2}
        report[name].setdefault("timings", []).append(entry)
        dtext = "not measured" if dms is None else f"{dms:.3f}"
        ltext = "not measured" if lib is None else f"{lib:.3f} ms"
        log(f"{name} 128K chunk lq={lq} lk={lmax}: kernel {ms:.3f} ms (device {dtext}), bound {b2['bound_ms']:.3f} ms "
            f"({b2['bound_by']}), SDPA {ltext}; on rows 0-{ROW_SLICE - 1}: kernel {s_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms (the plain version of the whole chunk does not fit)")

    def decode_timing(name, kernel, plain, cache, offset, nbytes, library=None, extra=""):
        nxt, off = rotating(nl), dev_offset(torch, offset)
        t = timed(torch, lambda: kernel(q1, *cache, valid, off, nxt(), scale),
                  lambda: plain(q1, *cache, valid, off, nxt(), scale), 10)
        t.update(bound(nbytes, 4 * h * d * (offset + 1 - pad)),
                 library_ms=None if library is None else cuda_ms(torch, library, 10))
        shape = f"Lq=1 Lmax={lmax} offset={offset} pad={pad} H=32 D=96{extra} (128K window)"
        log(f"{name} {shape}: {t.pop('text')} bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
            + ("" if t["library_ms"] is None else f" library (SDPA, same mask) {t['library_ms']:.4f} ms"))
        report[name].setdefault("timings", []).append({"shape": shape, **t})

    # --- The dense cache: K3 (decode), K2 (the chunk).
    ks, vs = stack(), stack()
    errs = decode_checks("K3", KV.dense_kv_attention, KV.dense_kv_attention_plain, ks, vs)
    n_split, split_keys = KV.dense_kv_split_plan(lmax)
    log(f"K3 plan at {lmax} keys: {n_split} splits of {split_keys} keys, partials "
        f"{n_split * b_ * h * (d + 2) * 4 / 2**20:.1f} MiB a launch, merged by the combine kernel")
    mask = causal_valid_mask(valid, torch.tensor([lmax - 1], device=dev))
    decode_timing("K3", KV.dense_kv_attention, KV.dense_kv_attention_plain, (ks, vs), lmax - 1,
                  2 * 2 * kvh * lmax * d + lmax + 2 * 2 * h * d,
                  library=lambda: F.scaled_dot_product_attention(q1, ks[top], vs[top], attn_mask=mask,
                                                                 scale=scale))
    report["K3"]["max_abs_err"] = max(report["K3"]["max_abs_err"], *errs)
    k_top, v_top = ks[top], vs[top]
    errs = chunk_checks("K2", lambda q, p0: K2.flash_attention(q, k_top, v_top, valid, p0, scale),
                        lambda q, p0: K2.flash_attention_plain(q, k_top, v_top, valid, p0, scale))
    report["K2"]["max_abs_err"] = max(report["K2"]["max_abs_err"], *errs)
    cmask = causal_valid_mask(valid, CHUNK_128K + torch.arange(lq, device=dev))
    chunk_timing("K2", lambda q, p0: K2.flash_attention(q, k_top, v_top, valid, p0, scale),
                 lambda q, p0: K2.flash_attention_plain(q, k_top, v_top, valid, p0, scale),
                 2 * (2 * qc.numel() + 2 * kvh * lmax * d) + lmax,
                 library=lambda: F.scaled_dot_product_attention(qc, k_top, v_top, attn_mask=cmask, scale=scale))
    del ks, vs, k_top, v_top, mask, cmask
    torch.cuda.empty_cache()

    # --- The int4 cache: K4 (decode), K5 (the chunk).
    kvq = KVQuantConfig(group_size=32, bits=4)
    payload = torch.empty((nl, b_, kvh, lmax, d), dtype=torch.uint8, device=dev)
    scales = torch.empty((nl, b_, kvh, lmax, 4 * (d // 32)), dtype=torch.bfloat16, device=dev)
    for layer in range(nl):
        k = (torch.randn((b_, kvh, lmax, d), generator=g, device=dev) + KV_MEAN[0]).to(torch.bfloat16)
        v = (torch.randn((b_, kvh, lmax, d), generator=g, device=dev) + KV_MEAN[1]).to(torch.bfloat16)
        payload[layer], scales[layer] = quantize_chunk(k, v, kvq)
        del k, v
    errs = decode_checks("K4", KV.quantized_kv_attention, KV.quantized_kv_attention_plain, payload, scales)
    n_split, block_keys = KV.quantized_split_plan(lmax)
    log(f"K4 plan at {lmax} keys: {n_split} blocks of {block_keys} keys ({block_keys // KV.RUN_KEYS} runs of "
        f"{KV.RUN_KEYS}), partials {n_split * b_ * h * (d + 2) * 4 / 2**20:.1f} MiB a launch")
    for offset in (BUCKET_128K, lmax - 1):
        decode_timing("K4", KV.quantized_kv_attention, KV.quantized_kv_attention_plain, (payload, scales), offset,
                      kvh * (offset + 1) * (d + 8 * (d // 32)) + lmax + 2 * 2 * h * d, extra=" int4")
    report["K4"]["max_abs_err"] = max(report["K4"]["max_abs_err"], *errs)
    p_top, s_top = payload, scales
    errs = chunk_checks("K5", lambda q, p0: KV.quantized_flash_attention(q, p_top, s_top, valid, p0, top, scale),
                        lambda q, p0: KV.quantized_flash_attention_plain(q, p_top, s_top, valid, p0, top, scale))
    report["K5"]["max_abs_err"] = max(report["K5"]["max_abs_err"], *errs)
    chunk_timing("K5", lambda q, p0: KV.quantized_flash_attention(q, p_top, s_top, valid, p0, top, scale),
                 lambda q, p0: KV.quantized_flash_attention_plain(q, p_top, s_top, valid, p0, top, scale),
                 kvh * lmax * (d + 8 * (d // 32)) + lmax + 2 * 2 * qc.numel())
    del payload, scales, p_top, s_top, qc, q1
    torch.cuda.empty_cache()


def long_prompt(proc):
    """(text, processor output) of the 128K request: FILLER repeated to
    PROMPT_128K tokens with the chat template (the byte tokenizer: a token
    a byte)."""
    from phi_3_vision_mlx_tpu_torch.api import _apply_chat_template

    base = len(proc(_apply_chat_template("")[0])["input_ids"][0])
    text = (FILLER * (PROMPT_128K // len(FILLER) + 2))[: PROMPT_128K - base]
    dict_input = proc(_apply_chat_template(text)[0])
    if dict_input["input_ids"].shape[1] != PROMPT_128K:
        fail(f"the 128K prompt has {dict_input['input_ids'].shape[1]} tokens, not {PROMPT_128K}")
    return text, dict_input


def reset_decoder(dec, offset: int, token) -> None:
    """Move a decoder back to ``offset`` (the prompt's end) and ``token``:
    the columns past it are written again by the next steps before any
    query reads them."""
    import dataclasses

    dec.state = dataclasses.replace(dec.state, offset=offset)
    dec.state.pos.fill_(offset)
    dec.token.copy_(token)


def long_profile(torch, lm, first, report) -> list:
    """On the entry the 128K request left (``lm.decoders``), reset to the
    prompt's end and its first token: graph steps against eager steps on
    the same state (bit for bit), then the graph's decode wall, device busy
    and idle share a token.  The entry goes back through
    ``release_decoder`` (the dense one is then dropped).  Returns the first
    token and the graph's tokens."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch.engine.engine import Decoder, release_decoder

    cache = cache_of(lm)
    with lm.lock:
        dec = lm.decoders.pop((1, WINDOW_128K))
    reset_decoder(dec, BUCKET_128K, first)
    g_rows = [tuple(t.cpu().numpy().copy() for t in dec.chunk(n)) for n in PARITY_STEPS_128K]
    reset_decoder(dec, BUCKET_128K, first)
    eager = Decoder(eager_twin(lm), dec.state)
    eager.start(dec.state, first)
    e_rows = [tuple(t.cpu().numpy().copy() for t in eager.chunk(n)) for n in PARITY_STEPS_128K]
    g_out = [np.concatenate(p) for p in zip(*g_rows)]
    e_out = [np.concatenate(p) for p in zip(*e_rows)]
    same = [np.array_equal(a, b) for a, b in zip(g_out, e_out)]
    log(f"128K ({cache} cache): {len(g_out[0])} graph steps against eager steps on the request's state from "
        f"offset {BUCKET_128K}: tokens, max log-prob, EOS log-prob bitwise equal {same}")
    if not all(same):
        fail(f"128K ({cache} cache): the graph steps differ from the eager steps on the same state")
    del eager
    reset_decoder(dec, BUCKET_128K, first)
    wall, per_name, kernels = step_profile(torch, dec, PROFILE_STEPS_128K, 4)
    busy = sum(per_name.values())
    if busy <= 0:
        fail(f"128K ({cache} cache): the profiler saw no device time")
    attn = sum(ms for name, ms in per_name.items() if "kv_" in name or name in SPLIT_RUN_KERNELS)
    top = ", ".join(f"{name} {ms:.3f}" for name, ms in per_name.most_common(6))
    log(f"128K ({cache} cache) decode through the graph from offset {BUCKET_128K}: wall {wall:.3f} ms/token "
        f"({1e3 / wall:.2f} tok/s), device busy {busy:.3f} ms/token, idle share {1 - busy / wall:.3f}, "
        f"{kernels:.0f} kernels/token; attention kernels {attn:.3f} ms/token; largest (ms/token): {top}; on "
        f"{report['card']}")
    report.setdefault("long128", {})[cache] = {"decode_wall_ms": wall, "decode_busy_ms": busy,
                                              "idle_share": 1 - busy / wall}
    release_decoder(lm, dec)
    return [int(first[0, 0])] + [int(t) for t in g_out[0][:, 0]]


def long_request(torch, lm, text, proc, report, tag: str, keep: bool = False):
    """One 128K request through ``api.generate`` (max_tokens 128): prefill ms
    (synchronized, around the engine's ``run_prefill``), decode tok/s, the
    launch counts (the cache's flash and decode kernels and K1, nothing
    else), the peak memory against the cache's bytes reckoned from the
    shapes, and the kept graph entries.  ``keep``: the request's entry is
    kept whatever its bytes (``lm.keep_bytes`` lifted for the request), for
    ``long_profile``.  Returns the prefill's
    last logits (V,) f32 on the host and its first token (1, 1) on the
    card."""
    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine import engine as E
    from phi_3_vision_mlx_tpu_torch.engine.state import cache_bytes, state_bytes as entry_state_bytes

    cache = cache_of(lm)
    flash, decode = ("K5", "K4") if cache == "int4" else ("K2", "K3")
    run_prefill, seen = E.run_prefill, {}

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_prefill(*a, **kw)
        torch.cuda.synchronize()
        seen["ms"], seen["logits"] = (time.perf_counter() - t0) * 1e3, out[0][0].float()
        return out

    counters = zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    E.run_prefill, budget = timed_prefill, lm.keep_bytes
    if keep:
        lm.keep_bytes = float("inf")
    try:
        prompt_tps, gen_tps = api.generate(text, preload=(lm, proc), max_tokens=MAX_TOKENS_128K, verbose=False,
                                           stream=False, mute=True, return_tps=True)
    finally:
        E.run_prefill, lm.keep_bytes = run_prefill, budget
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    need = cache_bytes(lm.cfg, 1, WINDOW_128K)
    kept = [(key, round(entry_state_bytes(d.state) / 2**30, 3)) for key, d in lm.decoders.items()]
    log(f"128K request ({tag}) through api.generate: {PROMPT_128K} prompt tokens, max_tokens {MAX_TOKENS_128K}, "
        f"window {WINDOW_128K}: prefill {seen['ms']:.1f} ms (run_prefill; {PROMPT_128K / prompt_tps * 1e3:.1f} ms "
        f"to the first token with the processor), decode {gen_tps:.2f} tok/s ({1e3 / gen_tps:.3f} ms/token), "
        f"{total:.1f} s in all; launches {launches}; peak memory {peak / 2**30:.2f} GiB against a "
        f"{need / 2**30:.2f} GiB cache reckoned from the shapes; entry uses {dict(lm.entry_uses)}; kept entries "
        f"(key, GiB) {kept}; on {report['card']}")
    for name, n in launches.items():
        if name in ("K1", flash, decode):
            if n <= 0:
                fail(f"128K request ({tag}): {name} was never launched")
        elif n:
            fail(f"128K request ({tag}): {name} was launched {n} times")
    report.setdefault("long128_requests", []).append(
        {"tag": tag, "prefill_ms": seen["ms"], "decode_tps": gen_tps, "peak_gib": peak / 2**30,
         "cache_gib": need / 2**30, "launches": launches})
    logits = seen["logits"]
    return logits.cpu().numpy(), logits.argmax().reshape(1, 1)


def phase_long_context(torch, cfg, params, proc, report):
    """(a) The 128K prompt in HBM: a request through ``api.generate`` with
    the int4 cache, then the dense one, each followed by ``long_profile``
    on the entry it left; then the int4 request again, a second 128K
    request after the dense one, which replays the int4 entry.  Returns the
    int4 model, the prompt and the int4 run's prefill logits and tokens
    (the tiered engine's reference)."""
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM, prefill_shape

    text, dict_input = long_prompt(proc)
    if prefill_shape(dict_input, MAX_TOKENS_128K)[1:] != (BUCKET_128K, WINDOW_128K):
        fail(f"the 128K prompt's bucket and window are {prefill_shape(dict_input, MAX_TOKENS_128K)[1:]}")
    lm_int4 = LM(cfg.replace(use_quantized_cache=True), params, device="cuda")
    logits, first = long_request(torch, lm_int4, text, proc, report, "int4 cache")
    ref = (logits, long_profile(torch, lm_int4, first, report))
    lm = LM(cfg, params, device="cuda")
    _, first = long_request(torch, lm, text, proc, report, "dense cache", keep=True)
    long_profile(torch, lm, first, report)
    if lm.decoders:
        fail(f"128K (dense cache): its {WINDOW_128K}-position entry was kept after its request")
    del lm
    long_request(torch, lm_int4, text, proc, report, "int4 cache, again after the dense request")
    if lm_int4.entry_uses != {"made": 1, "reused": 1}:
        fail(f"128K (int4 cache): the second request did not replay the first one's entry: {lm_int4.entry_uses}")
    return lm_int4, dict_input, ref


def link_text() -> str:
    """The PCIe link as ``nvidia-smi`` reports it: generation and width,
    current and maximum."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=pcie.link.gen.current,pcie.link.width.current,"
                              "pcie.link.gen.max,pcie.link.width.max", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except OSError as e:
        return f"not read ({e})"
    return out.stdout.strip() if out.returncode == 0 else f"not read ({out.stderr.strip()})"


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def phase_tiered(torch, lm_int4, dict_input, ref, proc, report):
    """(b) The tiered engine at the 131072 window, if the host has room to
    pin its ~16 GB cold tier twice over, else at 65536: prefill ms, the
    first logits and greedy tokens against the in-HBM int4 path's at the
    same window (up to the first near tie), decode ms a step with and
    without prefetch on the state as prefilled, the cold stream's
    host-to-device rate against the PCIe link, and the first step against
    the in-HBM path's, with a planted fault."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch.engine.state import cache_bytes
    from phi_3_vision_mlx_tpu_torch.engine.tiered import TieredEngine

    window = WINDOW_128K
    cold = cache_bytes(lm_int4.cfg, 1, window)
    avail = host_available_bytes()
    if avail < 2 * cold:
        window = 65536
    chunk = TIERED_CHUNKS[window]
    log(f"tiered: host memory available {avail / 2**30:.1f} GiB for a {cold / 2**30:.1f} GiB cold tier at "
        f"{WINDOW_128K}: window {window}, chunks of {chunk}, hot window {MAX_TOKENS_128K}")
    if window != WINDOW_128K:
        from phi_3_vision_mlx_tpu_torch.engine.engine import prefill_decoder, release_decoder

        n = window - MAX_TOKENS_128K - (BUCKET_128K - PROMPT_128K)
        dict_input = {"input_ids": dict_input["input_ids"][:, -n:]}
        dec, first = prefill_decoder(lm_int4, dict_input, MAX_TOKENS_128K)
        toks = dec.chunk(sum(PARITY_STEPS_128K))[0].cpu().numpy().copy()
        release_decoder(lm_int4, dec)
        ref = (None, [int(first[0, 0])] + [int(t) for t in toks[:, 0]])
    ref_logits, ref_toks = ref
    tiered_dot_check(torch)
    eng = TieredEngine(lm_int4, chunk=chunk, hot=MAX_TOKENS_128K, k_block=chunk)
    counters = zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, state = eng.prefill(dict_input)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    if state.window != window or not state.cold_k[0].is_pinned():
        fail(f"tiered: window {state.window}, cold tier pinned {state.cold_k[0].is_pinned()}")
    line = (f"tiered prefill ({window} window, {len(state.cold_k)} chunks of {chunk}): {prefill_ms:.1f} ms, "
            f"cold tier {state.cold_bytes() / 2**30:.2f} GiB in pinned host memory, peak device memory "
            f"{peak / 2**30:.2f} GiB, launches {({k: f.launches for k, f in counters.items()})}")
    if ref_logits is not None:
        rel = float(np.linalg.norm(logits[0] - ref_logits) / np.linalg.norm(ref_logits))
        line += (f"; first logits against the in-HBM int4 path: relative L2 {rel:.3e} (limit "
                 f"{TIERED_REL_L2})")
        if not rel <= TIERED_REL_L2:
            fail(f"tiered: first logits {rel:.3e} from the in-HBM path's in relative L2")
    log(line)
    if counters["K1"].launches <= 0:
        fail("tiered: K1 was never launched")

    first = int(np.argmax(logits[0]))
    tok, toks, rows = first, [first], [torch.as_tensor(logits[0])]
    for _ in range(TIERED_STEPS):
        lg, state = eng.decode_step(state, np.array([[tok]]))
        tok = int(lg[0].argmax())
        toks.append(tok)
        rows.append(lg[0])
    diff = [i for i, (a, b) in enumerate(zip(toks, ref_toks)) if a != b]
    log(f"tiered greedy tokens (decode_step) against the in-HBM int4 path: {diff[0] if diff else len(toks)} of "
        f"{len(toks)} equal")
    if diff:
        tiered_near_tie(torch, lm_int4, dict_input, ref_logits, ref_toks, toks, rows[diff[0]], diff[0])
    counters = zero_counters()
    rates = {}
    for mode in ("prefetch", "serial"):
        dev0 = state.dev0
        if mode == "serial":
            state.dev0 = None  # each layer's copy on the compute stream, layer 0's too
        reset_decoder_hot(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, state = eng.decode_chunk(state, np.array([[first]]), TIERED_STEPS)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / TIERED_STEPS
        state.dev0 = dev0
        streamed = state.cold_bytes() * (1 if mode == "serial" else 1 - 1 / lm_int4.cfg.num_hidden_layers)
        rates[mode] = (step_ms, streamed / step_ms / 1e6)
        if [first] + [int(t) for t in out[:, 0]] != toks:
            fail(f"tiered: decode_chunk ({mode}) gives other tokens than decode_step")
    launches = {k: f.launches for k, f in counters.items()}
    if launches["K1"] <= 0 or any(n for k, n in launches.items() if k != "K1"):
        fail(f"tiered decode: launches {launches}")
    copy_ms = h2d_ms(torch, state)
    layer_bytes = state.cold_bytes() / lm_int4.cfg.num_hidden_layers
    log(f"tiered decode through decode_chunk (generate's steps) on the state as prefilled ({window} window, "
        f"{len(state.cold_k)} chunks of {state.PC}, {TIERED_STEPS} steps, launches {launches}): prefetch "
        f"{rates['prefetch'][0]:.1f} ms/step ({rates['prefetch'][1]:.2f} GB/s of cold tier streamed), serial "
        f"{rates['serial'][0]:.1f} ms/step ({rates['serial'][1]:.2f} GB/s); the copies alone: one layer's cold "
        f"slices {copy_ms:.3f} ms, {layer_bytes / copy_ms / 1e6:.2f} GB/s host to device; PCIe link "
        f"(gen, width current, gen, width max): {link_text()}; on {report['card']}")
    report["tiered"] = {"window": window, "prefill_ms": prefill_ms, "prefetch_ms": rates["prefetch"][0],
                        "serial_ms": rates["serial"][0], "h2d_gbs": layer_bytes / copy_ms / 1e6}
    tiered_planted_fault(torch, eng, state, lm_int4, window, ref_toks[0])
    del state, eng
    torch.cuda.empty_cache()


def tiered_dot_check(torch) -> None:
    """The tiered attention's bf16 product on the card (``torch.bmm`` with an
    f32 output) at a decode step's score shape: the bf16-rounded inputs'
    product in f64, within f32 summation error (a bf16 sum would miss it by
    ~0.1 at these values)."""
    from phi_3_vision_mlx_tpu_torch.engine.tiered import _dot

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 32, 1, 1, 96, device="cuda", generator=gen)
    kt = torch.randn(1, 32, 1, 96, 3968, device="cuda", generator=gen)
    got = _dot(q, kt, True)
    want = torch.matmul(q.bfloat16().double(), kt.bfloat16().double())
    err = (got.double() - want).abs().max().item()
    log(f"tiered bf16 dot (bmm, f32 output) at (32, 1, 96) x (96, 3968): max abs error {err:.3e} against the "
        f"bf16 inputs' product in f64 (limit 1e-3; the values reach {want.abs().max().item():.1f})")
    if got.dtype != torch.float32 or not err <= 1e-3:
        fail(f"tiered: the bf16 dot on the card is {got.dtype}, {err:.3e} from the rounded inputs' product")


def tiered_planted_fault(torch, eng, state, lm, window: int, tok: int) -> None:
    """The first decode step, fed the in-HBM first token ``tok``: the tiered
    step against the in-HBM request's (its kept entry, eager, K4), sound
    and with one cold chunk masked.  The entry is closed afterwards."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch.models import phi3

    with lm.lock:
        dec = lm.decoders.pop((1, window))
    reset_decoder(dec, state.C, torch.tensor([[tok]], device="cuda"))
    with torch.no_grad():
        ref = phi3.decode_forward(lm.params, lm.cfg, dec.state, dec.token, advance=0).logits[0, -1].float()
    dec.close()

    def tiered(masked=None):
        valid, full = state.cold_valid.clone(), list(state.cold_full)
        if masked is not None:
            state.cold_valid[:, masked * state.PC : (masked + 1) * state.PC] = False
            state.cold_full[masked] = False
        reset_decoder_hot(state)
        lg, _ = eng.decode_step(state, np.array([[tok]]))
        state.cold_valid, state.cold_full = valid, full
        return ((lg[0].float() - ref).norm() / ref.norm()).item()

    sound, fault = tiered(), tiered(len(state.cold_k) // 2)
    log(f"tiered first decode step against the in-HBM path's (K4, eager), relative L2: {sound:.3e}; with one cold "
        f"chunk of {len(state.cold_k)} masked {fault:.3e} (limit {TIERED_REL_L2}: the first within, the second "
        f"above)")
    if sound > TIERED_REL_L2:
        fail(f"tiered: the first decode step {sound:.3e} from the in-HBM path's in relative L2")
    if not fault > TIERED_REL_L2:
        fail(f"tiered: a planted fault (one cold chunk masked) reads {fault:.3e}, within TIERED_REL_L2")


def tiered_near_tie(torch, lm, dict_input, ref_logits, ref_toks, toks, row, d: int) -> None:
    """Judge the tiered engine's first token ``d`` that differs from the
    in-HBM path's: the in-HBM logits of that step over its own prefix (the
    prefill's, or a step replayed on the request's state) against the
    tiered step's logits ``row``."""
    from phi_3_vision_mlx_tpu_torch.engine.engine import prefill_decoder, release_decoder
    from phi_3_vision_mlx_tpu_torch.models import phi3

    if d == 0 and ref_logits is not None:
        one = torch.as_tensor(ref_logits).float()
    else:
        dec, _ = prefill_decoder(lm, dict_input, MAX_TOKENS_128K)
        if d > 1:
            dec.chunk(d - 1)
        with torch.no_grad():
            one = phi3.decode_forward(lm.params, lm.cfg, dec.state, dec.token, advance=0).logits[0, -1].float()
        release_decoder(lm, dec)
    row = row.to(one.device).float()
    lp1, lp2 = torch.log_softmax(one, -1), torch.log_softmax(row, -1)
    a, b = ref_toks[d], toks[d]
    if int(lp1.argmax()) != a:
        fail(f"tiered near tie: the replayed in-HBM step gives token {int(lp1.argmax())}, its stream {a}")
    rel = ((one - row).norm() / one.norm()).item()
    gap = (lp1[a] - lp1[b]).item()
    moved = 2 * max(abs((lp1[a] - lp2[a]).item()), abs((lp1[b] - lp2[b]).item()))
    ulp = 2.0 ** (math.floor(math.log2(abs(one.max().item()))) - 7)
    log(f"tiered near tie at token {d}: the two paths' logits over the in-HBM prefix differ by {rel:.2e} "
        f"relative L2 (limit {TIERED_REL_L2}); the in-HBM step's gap between its token {a} and the tiered "
        f"{b} {gap:.4f} (limit {NEAR_TIE_ULPS} bf16 ulps of its top logit, {NEAR_TIE_ULPS * ulp:.4f}), twice "
        f"the change of those log-probs {moved:.4f}")
    if rel > TIERED_REL_L2 or gap > min(moved, NEAR_TIE_ULPS * ulp):
        fail(f"tiered: token {d} differs from the in-HBM path's beyond a near tie")


def reset_decoder_hot(state) -> None:
    import dataclasses

    state.hot = dataclasses.replace(state.hot, offset=0)
    state.hot.pos.zero_()


def h2d_ms(torch, state, reps: int = 3) -> float:
    """Device ms of copying one layer's cold slices (every chunk's) from the
    pinned host tier into device buffers, CUDA events around the copies."""
    bufs = [torch.empty(t.shape[1:], dtype=t.dtype, device="cuda") for t in state.cold_k + state.cold_s]
    hosts = state.cold_k + state.cold_s

    def copy():
        for buf, host in zip(bufs, hosts):
            buf.copy_(host[1], non_blocking=True)

    return cuda_ms(torch, copy, reps, warmup=1)


def dequantized(torch, node, bits: int):
    """A prepared quantized linear leaf's bf16 weight (..., K, N)."""
    from phi_3_vision_mlx_tpu_torch.core.weights import LAYOUTS
    from phi_3_vision_mlx_tpu_torch.ops.quant import QTensor, dequantize

    return dequantize(QTensor(LAYOUTS[bits][2](node["qweight"]), node["scales"], node.get("biases")))


def write_hf_checkpoint(torch, path: str, cfg, params) -> int:
    """A raw HF-layout directory of the model ``params`` hold (the port's
    prepared 4-bit weights, dequantized to bf16): HF key names, linears
    ``(out, in)``, per-layer keys in two shards, a config without
    ``layout``.  Returns its bytes."""
    from phi_3_vision_mlx_tpu_torch.core.config import config_to_dict
    from phi_3_vision_mlx_tpu_torch.core.weights import save_safetensors
    from phi_3_vision_mlx_tpu_torch.ops.quant import QTensor, dequantize

    os.makedirs(path, exist_ok=True)
    d = config_to_dict(cfg.replace(quantized=None))
    for key in ("layout", "sanitized", "quantization"):
        d.pop(key, None)
    with open(f"{path}/config.json", "w") as f:
        json.dump(d, f)
    with open(f"{path}/tokenizer_config.json", "w") as f:
        json.dump({"model_max_length": WINDOW_128K}, f)
    bits, nl, size = cfg.quantized.bits, cfg.num_hidden_layers, 0
    layers = params["model"]["layers"]
    emb = params["model"]["embed_tokens"]
    for shard, (lo, hi) in enumerate(((0, nl // 2), (nl // 2, nl))):
        flat = {}
        for i in range(lo, hi):
            for part, names in (("self_attn", ("qkv_proj", "o_proj")), ("mlp", ("gate_up_proj", "down_proj"))):
                for name in names:
                    node = {k: v[i] for k, v in layers[part][name].items()}
                    flat[f"model.layers.{i}.{part}.{name}.weight"] = dequantized(torch, node, bits).t().cpu()
            for norm in ("input_layernorm", "post_attention_layernorm"):
                flat[f"model.layers.{i}.{norm}.weight"] = layers[norm]["weight"][i].cpu()
        if shard:
            flat["model.embed_tokens.weight"] = dequantize(
                QTensor(emb["weight"], emb["scales"], emb.get("biases")), axis=-1).cpu()
            flat["model.norm.weight"] = params["model"]["norm"]["weight"].cpu()
            flat["lm_head.weight"] = dequantized(torch, params["lm_head"], bits).t().cpu()
        save_safetensors(f"{path}/model-{shard + 1:05d}-of-00002.safetensors", flat)
        size += sum(t.numel() * t.element_size() for t in flat.values())
        del flat
    return size


def checkpoint_tree(params: dict, bits: int) -> dict:
    """The port's prepared params -> a checkpoint's tree: each K1/K8 leaf's
    words unpacked to the plain ``(K, N)`` uint8 payload; packed leaves,
    embeddings and float tensors as they are."""
    from phi_3_vision_mlx_tpu_torch.core.weights import LAYOUTS

    def walk(node):
        if not isinstance(node, dict):
            return node
        if "qweight" in node:
            out = {k: v for k, v in node.items() if k != "qweight"}
            out["weight"] = LAYOUTS[bits][2](node["qweight"])
            return out
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def generate_from(torch, path: str, label: str, want: dict, images=None, proc=None) -> None:
    """``api._load`` of ``path`` on the card (seconds), then a few tokens
    through ``api.generate``; ``want`` maps kernels that must launch (True)
    or must not (False)."""
    from phi_3_vision_mlx_tpu_torch import api

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm, tproc = api._load(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    counters = zero_counters()
    prompt = "Describe this image." if images else PROMPT_A
    out = api.generate(prompt, images=images, preload=(lm, proc or tproc), max_tokens=8, verbose=False,
                       stream=False, mute=True)
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"checkpoint I/O ({label}): api._load on cuda {load_s:.1f} s; api.generate gave {len(out[0])} chars; "
        f"launches {launches}")
    if not out or not out[0]:
        fail(f"checkpoint I/O ({label}): api.generate gave {out!r}")
    for name, on in want.items():
        if (launches[name] > 0) != on:
            fail(f"checkpoint I/O ({label}): {name} launched {launches[name]} times")
    del lm
    torch.cuda.empty_cache()


def phase_checkpoint_io(torch, cfg, params, report):
    """(c) A raw HF-layout directory of the full-size text model, written
    from the synthetic weights, sanitized and quantized by the port, each
    loaded with the native reader (seconds) and generating; then the 8-bit
    and the packed 4-bit vision checkpoints, generating with the local test
    image (K8, K9 launched)."""
    import shutil
    import tempfile

    from phi_3_vision_mlx_tpu_torch.bench import _local_test_image
    from phi_3_vision_mlx_tpu_torch.core import weights as W
    from phi_3_vision_mlx_tpu_torch.core.config import QuantConfig

    reader, _ = W.safetensors_reader()
    if reader != "native":
        fail(f"checkpoint I/O: the safetensors reader is {reader}, not the native one")
    tmp = tempfile.mkdtemp(prefix="ckpt_io_", dir=os.environ.get("TMPDIR"))
    try:
        raw, clean, q4 = (f"{tmp}/{n}" for n in ("raw", "clean", "q4"))
        t0 = time.perf_counter()
        nbytes = write_hf_checkpoint(torch, raw, cfg, params)
        t1 = time.perf_counter()
        W.sanitize_checkpoint(raw, clean)
        t2 = time.perf_counter()
        W.quantize_checkpoint(raw, q4, device="cuda")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        loads = {}
        for name, path in (("sanitized", clean), ("quantized", q4)):
            s0 = time.perf_counter()
            _, p = W.load_params(path)
            loads[name] = time.perf_counter() - s0
            if name == "sanitized":
                last = cfg.num_hidden_layers - 1
                qkv = p["model"]["layers"]["self_attn"]["qkv_proj"]["weight"][last]
                want = dequantized(torch, {k: v[last] for k, v in
                                           params["model"]["layers"]["self_attn"]["qkv_proj"].items()}, 4)
                if not torch.equal(qkv.to(want.device), want):
                    fail(f"checkpoint I/O: the sanitized qkv_proj of layer {last} is not the source weight")
            del p
        said = list(W._READER_SAID)
        log(f"checkpoint I/O (full-size text model, {cfg.num_hidden_layers} layers): raw HF-layout directory of "
            f"{nbytes / 1e9:.2f} GB written in {t1 - t0:.1f} s; sanitize_checkpoint {t2 - t1:.1f} s; "
            f"quantize_checkpoint (4-bit, on cuda) {t3 - t2:.1f} s; load_params with the {said} reader: "
            f"sanitized {loads['sanitized']:.1f} s, quantized {loads['quantized']:.1f} s (page cache warm: "
            f"each was just written); on {report['card']}")
        if said != ["native"]:
            fail(f"checkpoint I/O: readers used {said}")
        report["checkpoint_io"] = {"raw_gb": nbytes / 1e9, "write_s": t1 - t0, "sanitize_s": t2 - t1,
                                   "quantize_s": t3 - t2, **{f"load_{k}_s": v for k, v in loads.items()}}
        shutil.rmtree(raw)
        generate_from(torch, clean, "sanitized bf16", {"K1": False, "K2": True, "K3": True})
        shutil.rmtree(clean)
        generate_from(torch, q4, "quantized 4-bit", {"K1": True, "K2": True, "K3": True})
        shutil.rmtree(q4)

        from phi_3_vision_mlx_tpu_torch.core.weights import packed_params, synth_quantized_params

        proc = vision_processor()
        image = _local_test_image()
        for bits, packed in ((8, False), (4, True)):
            vcfg = vision_config().replace(quantized=QuantConfig(group_size=64, bits=bits, mode="affine"))
            vp = synth_quantized_params(vcfg, device="cuda", seed=0)
            if packed:
                vp = packed_params(vp, vcfg)
            path = f"{tmp}/vision_{bits}{'_packed' if packed else ''}"
            s0 = time.perf_counter()
            W.save_checkpoint(path, vcfg, checkpoint_tree(vp, bits))
            del vp
            torch.cuda.empty_cache()
            label = f"{bits}-bit{' packed' if packed else ''} vision checkpoint, written in " \
                    f"{time.perf_counter() - s0:.1f} s"
            want = {"K8": True, "K1": False, "K9": False} if bits == 8 else {"K9": True, "K1": True, "K8": False}
            generate_from(torch, path, label, want, images=[image], proc=proc)
            shutil.rmtree(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_long(torch, report):
    """Phase 15: long context and checkpoint I/O at full width and depth on
    the 4-bit weights from seed 0."""
    import gc

    from phi_3_vision_mlx_tpu_torch.core.weights import flatten_params, synth_quantized_params
    from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3Processor
    from phi_3_vision_mlx_tpu_torch.models.tokenizer import ByteTokenizer

    gc.collect()  # earlier phases' models and their graph entries refer to each other
    torch.cuda.empty_cache()
    cfg = full_config()
    params = synth_quantized_params(cfg, device="cuda", seed=0)
    proc = Phi3Processor(tokenizer=ByteTokenizer())
    log(f"phase 15 starts with {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (the weights "
        f"{sum(t.numel() * t.element_size() for t in flatten_params(params).values()) / 2**30:.2f} GiB)")
    # (c), the disk's part, first: the card's parts then run while the host
    # writes back what (c) wrote.
    phase_checkpoint_io(torch, cfg, params, report)
    stamp("phase 15 (c)")
    lm_int4, dict_input, ref = phase_long_context(torch, cfg, params, proc, report)
    stamp("phase 15 (a)")
    phase_tiered(torch, lm_int4, dict_input, ref, proc, report)
    del lm_int4, params
    gc.collect()
    torch.cuda.empty_cache()
    stamp("phase 15 (b)")


# Phase 16: the parallel layer (torch.distributed meshes, tensor-parallel
# hooks, the ring prefill, the dry run) in a world of one, and RetNet.  One
# card cannot show a collective's cost: at one rank each is an identity.
PARALLEL_PROMPT = (FILLER * 60)[:4200]  # 4207 tokens, bucket 4224 (phase 4's request (c))
PARALLEL_MAX_TOKENS = 32
TP_STEPS = 8
# The int4 ring's decode steps against the plain int4 route forced with
# the ring's tokens (phase 16 (b)).  The two prefills attend to other keys
# (fresh ones, the dequantized cache), so the caches they leave differ by
# about the int4 cache's own effect: an H100 run measured 0.236-0.281
# relative L2 a step over 31 steps (the int4 ring against the dense ring
# forced alike: 0.21-0.26), and 0.648-0.937 with misplaced_scales planted.
RING_INT4_REL_L2 = 0.4
RETNET_FORMS_ATOL = 2e-4  # parallel against recurrent (tests/test_retnet.py), fp32 on the CUDA cores
# The card's first 4 training losses against a CPU twin's, from the same
# weights, at RETNET_TWIN_LR: at the JAX test's lr 3e-3 Adam's sign-like
# first steps make the run chaotic (on the CPU, weights moved by 1e-7
# relative moved the third and fourth losses by 1.2e-3 and 1.6e-3); at 1e-4
# the same noise moved the first 4 losses by 2.5e-5 at most.
RETNET_LOSS_RTOL = 1e-4
RETNET_TWIN_LR = 1e-4


def parallel_request(torch, lm, proc, label: str) -> dict:
    """One request through ``api.generate``: the first logits, prefill ms
    (synchronized, around ``run_prefill``), the launches of the prefill and
    of the decode, the greedy tokens, and the peak memory above what was
    allocated before it."""
    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine import engine as E

    counters = zero_counters()
    run_prefill, chunk, seen, tokens = E.run_prefill, E.Decoder.chunk, {}, []

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_prefill(*a, **kw)
        torch.cuda.synchronize()
        seen["ms"], seen["logits"] = (time.perf_counter() - t0) * 1e3, out[0][0].float().cpu()
        seen["prefill"] = {name: fn.launches for name, fn in counters.items()}
        tokens.append(int(seen["logits"].argmax()))
        return out

    def recorded(self, n_steps):
        out = chunk(self, n_steps)
        tokens.extend(out[0][:, 0].cpu().tolist())
        return out

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    E.run_prefill, E.Decoder.chunk = timed_prefill, recorded
    try:
        api.generate(PARALLEL_PROMPT, preload=(lm, proc), max_tokens=PARALLEL_MAX_TOKENS, verbose=False,
                     stream=False, mute=True)
    finally:
        E.run_prefill, E.Decoder.chunk = run_prefill, chunk
    torch.cuda.synchronize()
    total = {name: fn.launches for name, fn in counters.items()}
    out = {"logits": seen["logits"], "ms": seen["ms"], "prefill": seen["prefill"], "tokens": tokens,
           "decode": {k: total[k] - seen["prefill"][k] for k in total},
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    log(f"phase 16 (b) {label}: prefill {out['ms']:.1f} ms, peak {out['peak_gib']:.3f} GiB above the "
        f"{base / 2**30:.2f} GiB held before; prefill launches {out['prefill']}, decode launches {out['decode']}; "
        f"{len(tokens)} tokens")
    return out


def median_prefill_ms(torch, lm, dict_input, reps: int = 3) -> float:
    """Host wall ms (synchronized) of ``run_prefill``, median of ``reps``."""
    import statistics

    from phi_3_vision_mlx_tpu_torch.engine.engine import run_prefill

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_prefill(lm, dict_input, PARALLEL_MAX_TOKENS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def split_step(torch, lm, dict_input, d: int, first_logits):
    """The logits (V,) f32 that chose token ``d`` of a greedy request: the
    prefill's for d = 0, else a step scored after d - 1 decode steps."""
    from phi_3_vision_mlx_tpu_torch.engine.engine import prefill_decoder, release_decoder
    from phi_3_vision_mlx_tpu_torch.models import phi3

    if d == 0:
        return first_logits.cuda()
    dec, _ = prefill_decoder(lm, dict_input, PARALLEL_MAX_TOKENS)
    if d > 1:
        dec.chunk(d - 1)
    with torch.no_grad():
        logits = phi3.decode_forward(lm.params, lm.cfg, dec.state, dec.token, advance=0).logits[0, -1].float()
    release_decoder(lm, dec)
    return logits


def forced_logits(torch, lm, dict_input, tokens, fault=None):
    """The f32 logits (1 + len(tokens), V) of ``lm``'s prefill of
    ``dict_input`` and of eager decode steps (``phi3.decode_forward``)
    forced with ``tokens``; ``fault(state)`` alters the cache after the
    prefill."""
    from phi_3_vision_mlx_tpu_torch.engine.engine import run_prefill
    from phi_3_vision_mlx_tpu_torch.models import phi3

    with torch.no_grad():
        last, state, _, _ = run_prefill(lm, dict_input, PARALLEL_MAX_TOKENS)
        if fault is not None:
            fault(state)
        rows = [last[0].float()]
        for tok in tokens:
            res = phi3.decode_forward(lm.params, lm.cfg, state, torch.full((1, 1), tok, device="cuda"),
                                      last_logit_only=True)
            state = res.state
            rows.append(res.logits[0, -1].float())
    return torch.stack(rows)


def misplaced_scales(state) -> None:
    """A planted fault of the ring's gathered int4 cache: the first half
    of the prompt's scales and biases written over the second half's, as
    a gather that put one rank's columns in another's place would.  The
    logits stay finite."""
    h = state.offset // 2
    state.k_scales[:, :, :, h : 2 * h] = state.k_scales[:, :, :, :h].clone()


def ring_int4_readings(torch, ring_lm, plain_lm, proc, tokens) -> dict:
    """The int4 ring's decode against the plain int4 route, both forced
    with the ring's greedy ``tokens``: each decode step's relative L2
    between the two routes' logits, for the ring's own cache and for the
    ring's cache with ``misplaced_scales`` planted; and whether the ring's
    forced steps give its own tokens again."""
    from phi_3_vision_mlx_tpu_torch.api import _apply_chat_template

    dict_input = proc(_apply_chat_template(PARALLEL_PROMPT)[0])
    plain = forced_logits(torch, plain_lm, dict_input, tokens[:-1])
    rel = {}
    for label, fault in (("own", None), ("planted", misplaced_scales)):
        ring = forced_logits(torch, ring_lm, dict_input, tokens[:-1], fault)
        rel[label] = ((ring - plain).norm(dim=-1) / plain.norm(dim=-1)).tolist()
        if fault is None:
            own_tokens = ring.argmax(-1).tolist() == list(tokens)
    return {"own": rel["own"], "planted": rel["planted"], "own_tokens": own_tokens}


def near_tie_split(torch, ring_lm, plain_lm, proc, ring, plain, label: str) -> int:
    """The ring's greedy tokens equal the plain route's up to the first
    near tie: where they first part (token d), the plain step's top-two gap
    is at most NEAR_TIE_ULPS bf16 ulps of its top logit and within twice the
    change of those two tokens' log-probs between the routes, and the two
    logit rows agree within SPEC_ROUTE_REL_L2 (phase 11's bar).  Returns
    the number of equal leading tokens."""
    from phi_3_vision_mlx_tpu_torch.api import _apply_chat_template

    a, b = ring["tokens"], plain["tokens"]
    n = min(len(a), len(b))
    d = next((i for i in range(n) if a[i] != b[i]), n)
    if d == n:
        log(f"phase 16 (b) {label}: the ring's {len(a)} greedy tokens equal the plain route's {len(b)}")
        return d
    dict_input = proc(_apply_chat_template(PARALLEL_PROMPT)[0])
    one = split_step(torch, plain_lm, dict_input, d, plain["logits"])
    other = split_step(torch, ring_lm, dict_input, d, ring["logits"])
    lp1, lp2 = torch.log_softmax(one, -1), torch.log_softmax(other, -1)
    rel = ((one - other).norm() / one.norm()).item()
    gap = (lp1[b[d]] - lp1[a[d]]).item()
    moved = 2 * max(abs((lp1[b[d]] - lp2[b[d]]).item()), abs((lp1[a[d]] - lp2[a[d]]).item()))
    ulp = 2.0 ** (math.floor(math.log2(abs(one.max().item()))) - 7)
    log(f"phase 16 (b) {label}: tokens part at {d} of {n} (ring {a[d]}, plain {b[d]}): the plain step's gap "
        f"{gap:.4g} (bf16 ulp {ulp:.4g}), twice the log-probs' change {moved:.4g}, rel L2 {rel:.3e}")
    if int(one.argmax()) != b[d] or int(other.argmax()) != a[d]:
        fail(f"phase 16 (b) {label}: the replayed step {d} does not give the runs' tokens")
    if not (gap <= NEAR_TIE_ULPS * ulp and gap <= moved and rel <= SPEC_ROUTE_REL_L2):
        fail(f"phase 16 (b) {label}: the ring's tokens part from the plain route's at {d}, no near tie")
    return d


def phase_parallel(torch, params, lm, lm_int4, proc, report):
    """Phase 16 on phase 4's weights at full width and depth: (a) a world
    of one over NCCL and its (1, 1) mesh; (b) ``LM(sp_mesh=)`` beside the
    plain ``LM``, dense and int4 cache, the 4207-token prompt through
    ``api.generate``, and the int4 ring's decode against the plain int4
    route forced with its tokens; (c) the tensor-parallel hooks at one rank, bitwise the
    plain path; (d) ``dryrun_multichip``; (e) RetNet."""
    import torch.distributed as dist

    from phi_3_vision_mlx_tpu_torch.engine.engine import LM
    from phi_3_vision_mlx_tpu_torch.models import phi3
    from phi_3_vision_mlx_tpu_torch.parallel.dryrun import dryrun_multichip
    from phi_3_vision_mlx_tpu_torch.parallel.mesh import distributed_init, make_mesh
    from phi_3_vision_mlx_tpu_torch.parallel.sharding import local_config, shard_params
    from phi_3_vision_mlx_tpu_torch.parallel.tensor import TensorParallel

    out = report["parallel"] = {}
    distributed_init(device="cuda")
    mesh = make_mesh(1, 1)
    log(f"phase 16 (a): backend {dist.get_backend()}, world size {dist.get_world_size()}, NCCL "
        f"{torch.cuda.nccl.version()}, mesh {mesh.mesh_dim_names} of shape {tuple(mesh.shape)}")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1 or tuple(mesh.shape) != (1, 1):
        fail("phase 16 (a): the world of one is not one NCCL rank")
    stamp("phase 16 (a)")

    # (b) The ring route beside the plain one.
    runs = {}
    for plain_lm in (lm, lm_int4):
        cache = cache_of(plain_lm)
        ring_lm = LM(plain_lm.cfg, plain_lm.params, device="cuda", sp_mesh=mesh)
        ring = parallel_request(torch, ring_lm, proc, f"ring, {cache} cache")
        plain = parallel_request(torch, plain_lm, proc, f"plain, {cache} cache")
        runs[cache] = (ring_lm, ring, plain)
        flash, decode = ("K5", "K4") if cache == "int4" else ("K2", "K3")
        if ring_lm.ring_prefills != 1:
            fail(f"phase 16 (b) {cache}: {ring_lm.ring_prefills} ring prefills, not 1")
        if ring["prefill"]["K2"] or ring["prefill"]["K5"] or not plain["prefill"][flash]:
            fail(f"phase 16 (b) {cache}: the ring prefill launched {ring['prefill']}, the plain one "
                 f"{plain['prefill']}")
        if ring["decode"][decode] <= 0 or not ring_lm.graphs or ring_lm.entry_uses["made"] != 1:
            fail(f"phase 16 (b) {cache}: the ring's decode replayed no graph of {decode}: {ring['decode']}")
        out[f"ring_prefill_ms_{cache}"], out[f"plain_prefill_ms_{cache}"] = ring["ms"], plain["ms"]
        out[f"ring_peak_gib_{cache}"], out[f"plain_peak_gib_{cache}"] = ring["peak_gib"], plain["peak_gib"]
    dense_ring, int4_ring = runs["dense"][1], runs["int4"][1]
    # The ring attends to fresh k and v whatever the cache (as the JAX
    # prefill_ring does): its int4 run's first logits are its dense run's.
    # They are held to the plain dense route at phase 3's limits through
    # phase 3's 2 layers, and at phase 11's bar for two routes through 32.
    if not torch.equal(int4_ring["logits"], dense_ring["logits"]):
        fail("phase 16 (b): the int4 ring prefill's first logits are not the dense ring's")
    from phi_3_vision_mlx_tpu_torch.api import _apply_chat_template
    from phi_3_vision_mlx_tpu_torch.engine.engine import run_prefill

    small = {"model": {**params["model"], "layers": first_layers(params["model"]["layers"])},
             "lm_head": params["lm_head"]}
    cfg2 = lm.cfg.replace(num_hidden_layers=2)
    dict_input = proc(_apply_chat_template(PARALLEL_PROMPT)[0])
    two = [run_prefill(LM(cfg2, small, device="cuda", graphs=False, sp_mesh=m), dict_input,
                       PARALLEL_MAX_TOKENS)[0][0].float().cpu() for m in (mesh, None)]
    for (a, b), limit, depth in ((two, REF_REL_L2, 2), ((dense_ring["logits"], runs["dense"][2]["logits"]),
                                                         SPEC_ROUTE_REL_L2, lm.cfg.num_hidden_layers)):
        rel = float((a - b).norm() / b.norm())
        dlp = abs(float(torch.log_softmax(a, -1).max() - torch.log_softmax(b, -1).max()))
        lp_bound = REF_LOGPROB + abs(float(a.max() - b.max()))
        log(f"phase 16 (b): first logits through {depth} layers, ring against plain (dense cache): rel L2 "
            f"{rel:.3e} (limit {limit}), max log-prob diff {dlp:.3e} (limit {lp_bound:.4g})")
        if rel > limit or dlp > lp_bound:
            fail(f"phase 16 (b): the ring prefill's first logits through {depth} layers disagree with the plain "
                 "route's")
        out[f"first_logits_rel_l2_{depth}_layers"] = rel
    for label, model in (("ring", runs["dense"][0]), ("plain", lm)):  # steady state, after the requests
        out[f"{label}_prefill_ms_steady"] = median_prefill_ms(torch, model, dict_input)
    log(f"phase 16 (b): prefill of the {len(dict_input['input_ids'][0])}-token prompt, median of 3 after the "
        f"requests (dense cache): ring {out['ring_prefill_ms_steady']:.1f} ms, plain "
        f"{out['plain_prefill_ms_steady']:.1f} ms, on {report['card']}")
    out["equal_tokens_dense"] = near_tie_split(torch, runs["dense"][0], lm, proc, dense_ring, runs["dense"][2],
                                               "dense cache")
    # The int4 ring decodes its own entries (the quantized fresh keys; the
    # plain int4 prefill attends to its dequantized cache and writes others):
    # its graphs are held to its eager twin, bit for bit.
    eager = parallel_request(torch, LM(lm_int4.cfg, lm_int4.params, device="cuda", graphs=False, sp_mesh=mesh),
                             proc, "ring, int4 cache, eager")
    if eager["tokens"] != int4_ring["tokens"] or not torch.equal(eager["logits"], int4_ring["logits"]):
        fail("phase 16 (b): the int4 ring's graph decode differs from its eager twin")
    plain4 = runs["int4"][2]["tokens"]
    out["equal_tokens_int4"] = next((i for i, (x, y) in enumerate(zip(int4_ring["tokens"], plain4)) if x != y),
                                    min(len(plain4), len(int4_ring["tokens"])))
    log(f"phase 16 (b): the int4 ring's tokens equal the plain int4 route's for {out['equal_tokens_int4']} of "
        f"{len(plain4)} (the two prefills attend to other keys), its eager twin's for all")
    # The int4 ring's decode against an independent route: the plain int4
    # route teacher-forced with the ring's tokens, each decode step within
    # RING_INT4_REL_L2; with a fault of the gathered scales planted, the
    # check must fail.
    readings = ring_int4_readings(torch, runs["int4"][0], lm_int4, proc, int4_ring["tokens"])
    own, planted = max(readings["own"][1:]), max(readings["planted"][1:])
    log(f"phase 16 (b): int4 ring against the plain int4 route forced with the ring's tokens, rel L2 of the "
        f"logits: prefill {readings['own'][0]:.3e}, decode steps max {own:.3e} (limit {RING_INT4_REL_L2}), "
        f"each {[round(x, 4) for x in readings['own'][1:]]}; with misplaced_scales planted max {planted:.3e}, "
        f"each {[round(x, 4) for x in readings['planted'][1:]]}; the ring's forced steps give its tokens: "
        f"{readings['own_tokens']}")
    if not (readings["own_tokens"] and own <= RING_INT4_REL_L2 < planted):
        fail("phase 16 (b): the int4 ring's decode disagrees with the plain int4 route forced with its tokens, "
             "or the planted fault passes the check")
    out["ring_int4_rel_l2"], out["ring_int4_planted_rel_l2"] = own, planted
    del runs, eager
    stamp("phase 16 (b)")

    # (c) The tensor-parallel hooks at one rank: every collective an identity.
    tp_params = shard_params(params, mesh)
    ids = torch.as_tensor(proc(_apply_chat_template(PROMPT_A)[0])["input_ids"], device="cuda")
    for model in (lm, lm_int4):
        cfg_local = local_config(model.cfg, 1)
        counters = zero_counters()
        logits, wall, coll = {}, {}, {}
        for route in ("plain", "tp"):
            tp = TensorParallel.of(mesh) if route == "tp" else None
            with torch.no_grad():
                res = phi3.prefill(tp_params, cfg_local, ids, max_tokens=16, tp=tp)
                seq, state = [res.logits], res.state
                before = tp.collectives if tp else 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(TP_STEPS):
                    res = phi3.decode_forward(tp_params, cfg_local, state, res.logits[:, -1:].argmax(-1), tp=tp)
                    seq.append(res.logits)
                    state = res.state
                torch.cuda.synchronize()
            wall[route] = (time.perf_counter() - t0) * 1e3 / TP_STEPS
            coll[route] = ((tp.collectives - before) / TP_STEPS) if tp else 0
            logits[route] = seq
        launches = {name: fn.launches for name, fn in counters.items()}
        cache = cache_of(model)
        log(f"phase 16 (c) {cache} cache: {coll['tp']:.0f} collectives a decode step (embedding, 2 a layer, "
            f"lm_head), eager ms a step plain {wall['plain']:.3f} / through the hooks {wall['tp']:.3f}; "
            f"launches {launches}")
        if not all(torch.equal(x, y) for x, y in zip(logits["plain"], logits["tp"])):
            fail(f"phase 16 (c) {cache}: the tensor-parallel hooks at one rank changed the logits")
        if launches["K3" if cache == "dense" else "K4"] <= 0 or launches["K1"] <= 0:
            fail(f"phase 16 (c) {cache}: the decode launched {launches}")
        out[f"tp_collectives_per_step_{cache}"] = coll["tp"]
        out[f"tp_step_ms_{cache}"], out[f"plain_step_ms_{cache}"] = wall["tp"], wall["plain"]
    stamp("phase 16 (c)")

    line = dryrun_multichip(torch.cuda.device_count(), device="cuda")
    if not line.startswith("dryrun_multichip OK:") or "sharded-decode parity=True" not in line:
        fail(f"phase 16 (d): {line}")
    stamp("phase 16 (d)")
    dist.destroy_process_group()

    phase_retnet(torch, out)
    stamp("phase 16")


def phase_retnet(torch, out):
    """Phase 16 (e): RetNet at its default config (hidden 256, 4 layers, 4
    heads) from a seeded CUDA generator, fp32: the parallel form against
    the recurrent one token by token and in chunks of 3; 60 training steps
    (the loss below half its start); 4 steps at RETNET_TWIN_LR against a CPU
    twin's within RETNET_LOSS_RTOL; greedy bytes; ms per recurrent step."""
    import numpy as np

    from phi_3_vision_mlx_tpu_torch.models import retnet as R

    cfg = R.RetNetConfig()
    params = R.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    ids = torch.as_tensor([R.encode_bytes(PROMPT_A[:63])], device="cuda")
    with torch.no_grad():
        par = R.forward_parallel(params, cfg, ids)
        errs = {}
        for chunk in (1, 3):
            state, rec = R.init_state(cfg, 1, params), []
            for t in range(0, ids.shape[1], chunk):
                lg, state = R.forward_recurrent(params, cfg, ids[:, t : t + chunk], state)
                rec.append(lg)
            errs[chunk] = float((torch.cat(rec, dim=1) - par).abs().max())
        if not (torch.isfinite(par).all() and max(errs.values()) <= RETNET_FORMS_ATOL):
            fail(f"phase 16 (e): RetNet's recurrent form differs from its parallel form by {errs}")
        state = R.init_state(cfg, 1, params)
        tok = ids[:, :1]
        step_ms = cuda_ms(torch, lambda: R.forward_recurrent(params, cfg, tok, state), 50)
    texts = ["ababab"] * 2
    trained, losses = R.train_byte_lm(params, cfg, texts, steps=60, lr=3e-3)
    cpu = {**{k: v.cpu() for k, v in params.items() if k != "layers"},
           "layers": [{k: v.cpu() for k, v in p.items()} for p in params["layers"]]}
    first = R.train_byte_lm(params, cfg, texts, steps=4, lr=RETNET_TWIN_LR)[1]
    twin = R.train_byte_lm(cpu, cfg, texts, steps=4, lr=RETNET_TWIN_LR)[1]
    rel = np.abs(np.array(first) - np.array(twin)) / np.abs(np.array(twin))
    text = R.generate_bytes(trained, cfg, "abab", max_tokens=16)
    log(f"phase 16 (e) RetNet (hidden {cfg.hidden_size}, {cfg.num_hidden_layers} layers, {cfg.num_heads} "
        f"heads): parallel vs recurrent max abs {errs[1]:.3e} token by token, {errs[3]:.3e} in chunks of 3; "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f} over 60 steps at lr 3e-3; 4 steps at lr {RETNET_TWIN_LR}: "
        f"{rel.max():.2e} relative at most from the CPU twin's; generate_bytes {text!r}; {step_ms:.3f} ms a recurrent step (CUDA events)")
    if not (losses[-1] < 0.5 * losses[0] and rel.max() <= RETNET_LOSS_RTOL and "ab" in text):
        fail("phase 16 (e): RetNet's training or generation is off")
    out["retnet_step_ms"], out["retnet_forms_err"] = step_ms, max(errs.values())


# --- fp32 beyond the dense single stream (phases 2 and 17) -------------------
#
# An fp32 model runs every kernel's fp32 entry: f32 activations and queries,
# quantized weights and cache entries dequantized in f32 (the JAX XLA path's
# function).  A quantized matmul's f32 sums run in another order than its
# plain version's: over K terms each order's rounding error is about sqrt(K)
# f32 ulps of the sum of |x w| (a random walk of K roundings), so the check
# allows F32_MM_ULPS * sqrt(K) * 2^-24 * (|x| @ |W|) beside F32_ATOL +
# F32_RTOL |ref|: 1.3e-5 of sum |x w| at K = 3072, 2.2e-5 at 8192.  Outputs
# of 8-bit weights (|w| up to 1) reach tens where rows cancel, so the
# relative term alone would reject a correct kernel.
F32_MM_ULPS = 4
F32_MM_ROWS = (1, 8, 192)  # a decode step, a verify pass, a prefill slice
F32_MM_TIMED = ((3072, 9216, 1), (3072, 9216, 192), (3072, 32064, 1))  # K1a decode and prefill, K1b (K8, K9: M = 1)
F32_ATTN_ROWS = (1, 8, 16)


def f32_matmul_check(torch, name, out, ref, x, w, k):
    """``out`` against ``ref`` within the fp32 matmul limit; returns the
    max abs error and the largest share of its limit used."""
    mag = x.abs() @ w.abs()
    limit = F32_ATOL + F32_RTOL * ref.abs() + F32_MM_ULPS * math.sqrt(k) * 2.0**-24 * mag
    err = (out - ref).abs()
    used = float((err / limit).max())
    if out.dtype != torch.float32 or not bool(torch.isfinite(out).all()) or used > 1:
        fail(f"{name} in fp32 disagrees with its plain version: max abs {float(err.max()):.3e}, "
             f"{used:.2f} of its limit, {out.dtype}")
    return float(err.max()), used


def f32_entry(report, name, shape, t, bd, ea, lib=None):
    """Keep an fp32 timing in ``report[name]["timings"]`` and log it."""
    report[name].setdefault("timings", []).append(
        {"shape": f"fp32 {shape}", **t, "library_ms": lib, **bd, "max_abs_err": ea})
    lib_text = "none" if lib is None else f"{lib:.4f} ms"
    log(f"{name} fp32 {shape}: max_abs={ea:.3e} {t.pop('text')} bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']}) library {lib_text}")


def phase_fp32_quantized_kernels(torch, report):
    """K1, K8 and K9 (M = 1, 8, 192; K1 also symmetric and at lm_head's
    ragged N; each called twice, bit-identical), K4 (Lq 1, 8, 16 over 640
    and 4224 keys, row0 16, a row with no valid key), K5 (K2's fp32 cases),
    K6 and K7 (phase 2's paged shapes, Lq 1, 8, 16, row0 16, clamped tables)
    in fp32 against their plain fp32 versions; each timed beside its bound
    (bytes, or its products at 165 TFLOP/s of 3xTF32, the tensor cores' tf32
    rate over three products; K1 and K8's route A at M = 1 runs on the CUDA
    cores but is bound by its bytes) and, for K6, fp32 SDPA over the
    gathered windows."""
    import random

    import torch.nn.functional as F

    from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig
    from phi_3_vision_mlx_tpu_torch.core.weights import pack_int4, pack_int8
    from phi_3_vision_mlx_tpu_torch.engine.state import dequantize_kv, quantize_chunk
    from phi_3_vision_mlx_tpu_torch.ops.attention import causal_valid_mask
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as KV
    from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as QM
    from phi_3_vision_mlx_tpu_torch.ops.quant import QTensor, dequantize

    dev, f32 = "cuda", torch.float32
    g = torch.Generator(device=dev).manual_seed(17)
    before = {name: fn.fp32.launches for name, fn in kernel_counters().items()}

    # --- K1, K8, K9: x f32, out f32, weights rotated past the L2 for timing.
    layouts = {"K1": (QM.quant_matmul, QM.quant_matmul_plain, 4), "K8": (QM.quant_matmul_w8, QM.quant_matmul_w8_plain, 8),
               "K9": (QM.quant_matmul_packed, QM.quant_matmul_packed_plain, 4)}
    for k, n in ((3072, 9216), (3072, 32064)):
        wbytes = k * n // 2 + 2 * 2 * (k // 64) * n
        copies = max(1, math.ceil(150e6 / wbytes))
        s, b = w4_planes(torch, k, n, g)
        for name, (kernel, plain, bits) in layouts.items():
            if n % 512 and name == "K9":
                continue
            if n == 32064 and name == "K8":
                continue
            levels = [torch.randint(0, 1 << bits, (k, n), dtype=torch.uint8, generator=g, device=dev)
                      for _ in range(copies)]
            sb = (s, b) if bits == 4 else ((s.float() * 15 / 255).to(torch.bfloat16), b)
            if name == "K9":
                from phi_3_vision_mlx_tpu_torch.core.weights import to_packed_layout

                ws = [(to_packed_layout(q), *sb) for q in levels]
            else:
                ws = [((pack_int4 if bits == 4 else pack_int8)(q), *sb) for q in levels]
            w = dequantize(QTensor(levels[0], *sb), dtype=f32)
            errs, used = [], []
            for m in F32_MM_ROWS:
                x = torch.randn((m, k), generator=g, device=dev)
                out = kernel(x, *ws[0])
                ref = plain(x, *ws[0])
                torch.cuda.synchronize()
                ea, u = f32_matmul_check(torch, f"{name} K={k} N={n} M={m}", out, ref, x, w, k)
                if not torch.equal(out, kernel(x, *ws[0])):
                    fail(f"{name} in fp32 at K={k} N={n} M={m}: two calls on the same inputs differ")
                errs.append(ea)
                used.append(u)
                if name == "K1" and m in (1, 8):  # symmetric mode: no biases
                    w_sym = dequantize(QTensor(levels[0], s, None), dtype=f32)
                    ea, u = f32_matmul_check(torch, f"K1 symmetric K={k} N={n} M={m}", kernel(x, ws[0][0], s, None),
                                             plain(x, ws[0][0], s, None), x, w_sym, k)
                    errs.append(ea)
                    used.append(u)
                if (k, n, m) in F32_MM_TIMED and (name == "K1" or n == 9216):
                    nxt = rotating(copies)
                    t = timed(torch, lambda: kernel(x, *ws[nxt()]), lambda: plain(x, *ws[nxt()]), 20)
                    wb = k * n * bits // 8 + 2 * 2 * (k // 64) * n
                    bd = bound(wb + 4 * m * k + 4 * m * n, 2 * m * k * n, rate=TF32X3_FLOPS)
                    f32_entry(report, name, f"K={k} N={n} M={m}", t, bd, ea)
            log(f"{name} fp32 K={k} N={n} M={','.join(map(str, F32_MM_ROWS))}: max_abs={max(errs):.3e}, at most "
                f"{max(used):.3f} of the limit (F32_ATOL + F32_RTOL |ref| + {F32_MM_ULPS} sqrt(K) 2^-24 |x| @ |W|); "
                f"repeat bit-identical")
            del ws, levels, w

    # --- K4: the int4 stacked cache, f32 queries.
    kvq = KVQuantConfig(group_size=32, bits=4)
    h = kvh = 32
    d = 96
    scale = d**-0.5

    def int4_cache(nl, rows, lmax):
        k_ = torch.randn((nl, rows, kvh, lmax, d), generator=g, device=dev) + KV_MEAN[0]
        v_ = torch.randn((nl, rows, kvh, lmax, d), generator=g, device=dev) + KV_MEAN[1]
        return quantize_chunk(k_, v_, kvq)

    def attn_check(name, out, ref, what):
        ea, er, ok = close(torch, out, ref, F32_ATOL, F32_RTOL)
        if out.dtype != f32 or not ok:
            fail(f"{name} in fp32 disagrees with its plain version at {what}: max_abs {ea:.3e}")
        return ea

    nl = 8
    for lmax in (640, 4224):
        payload, scales = int4_cache(nl, 1, lmax)
        valid = torch.rand((1, lmax), generator=g, device=dev) > 0.05
        valid[:, :10] = False
        errs = []
        for lq in F32_ATTN_ROWS:
            q = torch.randn((1, lq, h, d), generator=g, device=dev).transpose(1, 2)
            for offset, row0 in ((lmax // 2, 0), (lmax - lq, 0), (lmax - 2 * 16, 16)):
                if row0 and lq != 16:
                    continue
                out = KV.quantized_kv_attention(q, payload, scales, valid, dev_offset(torch, offset), nl - 1, scale,
                                                row0=row0)
                ref = KV.quantized_kv_attention_plain(q, payload, scales, valid, offset, nl - 1, scale, row0=row0)
                torch.cuda.synchronize()
                errs.append(attn_check("K4", out, ref, f"Lmax={lmax} Lq={lq} offset={offset} row0={row0}"))
            if lq == 1 or lmax == 4224 and lq == 8:
                nxt, end = rotating(nl), dev_offset(torch, lmax - lq)
                t = timed(torch, lambda: KV.quantized_kv_attention(q, payload, scales, valid, end, nxt(), scale),
                          lambda: KV.quantized_kv_attention_plain(q, payload, scales, valid, end, nxt(), scale), 20)
                pairs = int(causal_valid_mask(valid, lmax - lq + torch.arange(lq, device=dev)).sum())
                bd = bound(kvh * lmax * (d + 8 * (d // 32)) + lmax + 2 * 4 * h * lq * d, 4 * h * d * pairs,
                           rate=TF32X3_FLOPS)
                f32_entry(report, "K4", f"Lq={lq} Lmax={lmax} offset={lmax - lq} H=32 D=96 int4", t, bd, max(errs))
        none = torch.zeros_like(valid)  # a row with no valid key: the uniform average
        q = torch.randn((1, 1, h, d), generator=g, device=dev).transpose(1, 2)
        out = KV.quantized_kv_attention(q, payload, scales, none, dev_offset(torch, lmax // 2), nl - 1, scale)
        mean_v = dequantize_kv(payload[nl - 1], scales[nl - 1], f32)[1].mean(dim=2)
        torch.cuda.synchronize()
        errs.append(attn_check("K4", out, mean_v[:, :, None], f"Lmax={lmax}, no valid key"))
        log(f"K4 fp32 Lmax={lmax} Lq={','.join(map(str, F32_ATTN_ROWS))}: max_abs={max(errs):.3e} "
            f"(atol {F32_ATOL} + rtol {F32_RTOL})")
        del payload, scales

    # --- K5: K2's fp32 cases over int4 caches.
    errs = []
    for lq, lk, q_pos0, pads, is_timed in K2_F32_CASES[:4]:
        nb = len(pads)
        payload, scales = int4_cache(2, nb, lk)
        q = torch.randn((nb, lq, h, d), generator=g, device=dev).transpose(1, 2)
        valid = torch.ones((nb, lk), dtype=torch.bool, device=dev)
        for i, pad in enumerate(pads):
            valid[i, :pad] = False
        out = KV.quantized_flash_attention(q, payload, scales, valid, q_pos0, 1, scale)
        ref = KV.quantized_flash_attention_plain(q, payload, scales, valid, q_pos0, 1, scale)
        torch.cuda.synchronize()
        shape = f"B={nb} lq={lq} lk={lk} q_pos0={q_pos0} pads={pads} H=32 D=96 int4"
        errs.append(attn_check("K5", out, ref, shape))
        if lq == 1024:
            t = timed(torch, lambda: KV.quantized_flash_attention(q, payload, scales, valid, q_pos0, 1, scale),
                      lambda: KV.quantized_flash_attention_plain(q, payload, scales, valid, q_pos0, 1, scale), 12)
            pairs = int(causal_valid_mask(valid, q_pos0 + torch.arange(lq, device=dev)).sum())
            keys = min(lk, q_pos0 + lq)
            bd = bound(nb * kvh * keys * (d + 8 * (d // 32)) + nb * lk + 2 * 4 * q.numel(), 4 * h * d * pairs,
                       rate=TF32X3_FLOPS)
            f32_entry(report, "K5", shape, t, bd, errs[-1])
        del payload, scales, q, out, ref
    log(f"K5 fp32 at K2's fp32 cases: max_abs={max(errs):.3e} (atol {F32_ATOL} + rtol {F32_RTOL})")

    # --- K6 (f32 pool) and K7 (int4 pool): phase 2's paged shapes.
    s_, page, window, pool = 4, 64, 1024, 64
    offsets_l = (100, 400, 700, 1000 - 16)
    rng = random.Random(17)
    ids = rng.sample(range(pool), pool)
    tables = torch.full((s_, window // page), pool, dtype=torch.int32)
    for i, off in enumerate(offsets_l):
        need = -(-(off + 32) // page)
        tables[i, :need] = torch.tensor([ids.pop() for _ in range(need)])
    tables = tables.to(dev)
    offsets = torch.tensor(offsets_l, dtype=torch.int32, device=dev)
    valid = torch.rand((s_, window), generator=g, device=dev) > 0.05
    valid[:, :10] = False
    bad = tables.clone()
    bad[3, 0], bad[2, 1] = pool + 7, -3  # clamped into the pool by the kernels
    shape = f"S=4 offsets {','.join(map(str, offsets_l))} window 1024 page 64 pool 64+1 H=32 D=96"
    nl = 4
    pk = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev)
    pv = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev)
    kq = torch.randn((nl, pool + 1, kvh, page, d), generator=g, device=dev) + KV_MEAN[0]
    pools = {"K6": (KV.paged_kv_attention, KV.paged_kv_attention_plain, (pk, pv), 2 * 4 * d),
             "K7": (KV.paged_quantized_kv_attention, KV.paged_quantized_kv_attention_plain,
                    quantize_chunk(kq, pv + KV_MEAN[1], kvq), d + 8 * (d // 32))}
    del kq
    wins = [(KV.gather_pages(pk[i], tables), KV.gather_pages(pv[i], tables)) for i in range(nl)]
    for name, (kernel, plain, pl, per_key) in pools.items():
        errs = []
        for lq in F32_ATTN_ROWS:
            q = torch.randn((s_, lq, h, d), generator=g, device=dev).transpose(1, 2)
            for tb, ref_tb, row0 in ((tables, tables, 0), (bad, bad.clamp(0, pool), 0), (tables, tables, 16)):
                if row0 and lq != 16:
                    continue
                out = kernel(q, *pl, tb, valid, offsets, nl - 1, scale, row0=row0)
                ref = plain(q, *pl, ref_tb, valid, offsets, nl - 1, scale, row0=row0)
                torch.cuda.synchronize()
                errs.append(attn_check(name, out, ref, f"Lq={lq} row0={row0}"))
            if lq in (1, 8):
                nxt = rotating(nl)
                t = timed(torch, lambda: kernel(q, *pl, tables, valid, offsets, nxt(), scale),
                          lambda: plain(q, *pl, tables, valid, offsets, nxt(), scale), 20)
                keys = sum(o + lq for o in offsets_l)
                vis = int(KV.paged_visible(valid, offsets, lq).sum())
                bd = bound(kvh * keys * per_key + s_ * window + 4 * tables.numel() + 2 * 4 * s_ * h * lq * d,
                           4 * h * d * vis, rate=TF32X3_FLOPS)
                lib = None
                if name == "K6":
                    mask = KV.paged_visible(valid, offsets, lq)
                    nxt_l = rotating(nl)
                    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, *wins[nxt_l()], attn_mask=mask,
                                                                                scale=scale), 20)
                f32_entry(report, name, f"{shape} Lq={lq}" + (" int4" if name == "K7" else ""), t, bd, max(errs), lib)
        log(f"{name} fp32 Lq={','.join(map(str, F32_ATTN_ROWS))} {shape}: max_abs={max(errs):.3e} (atol {F32_ATOL} "
            f"+ rtol {F32_RTOL}), table entries outside the pool clamped")
    del pk, pv, pools, wins
    counts = {name: fn.fp32.launches - before[name] for name, fn in kernel_counters().items()}
    log(f"phase 2 fp32 entries launched: {counts}")
    if any(counts[n] <= 0 for n in ("K1", "K4", "K5", "K6", "K7", "K8", "K9")):
        fail(f"phase 2: an fp32 entry never launched: {counts}")
    torch.cuda.empty_cache()



# Phase 17: an fp32 model with quantized weights, caches and engines.
FP32_STEP_REL_L2 = 1e-4  # every forced step's logits, kernels against the plain route
FP32_TIE = 1e-4  # the JAX gate's tie rule: tokens agree up to a top-2 gap below it
FP32_TOKENS = 32
FP32_SERVE = ((FILLER * 4)[:300], (FILLER * 4)[:180], PROMPT_A, (FILLER * 4)[:420])  # four requests
FP32_SERVE_TOKENS = (20, 24, 28, 32)  # distinct, so each request is known by its length
FP32_LORA_RTOL = 1e-4
FP32_LORA_COS = 0.999


@contextlib.contextmanager
def plain_route():
    """Every kernel wrapper the model path calls replaced by its plain
    version, on the card: the reference route of phase 17."""
    from phi_3_vision_mlx_tpu_torch.models import phi3
    from phi_3_vision_mlx_tpu_torch.ops.kernels import flash_attention as FA
    from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as KV
    from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as QM

    swaps = [(QM, "quant_matmul", QM.quant_matmul_plain), (QM, "quant_matmul_w8", QM.quant_matmul_w8_plain),
             (QM, "quant_matmul_packed", QM.quant_matmul_packed_plain),
             (phi3, "flash_attention", FA.flash_attention_plain),
             (phi3, "dense_kv_attention", KV.dense_kv_attention_plain),
             (phi3, "quantized_kv_attention", KV.quantized_kv_attention_plain),
             (phi3, "quantized_flash_attention", KV.quantized_flash_attention_plain)]
    with contextlib.ExitStack() as stack:
        for mod, name, fn in swaps:
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


def entry_writes(torch):
    """(record, replay): ``update_layer_chunk`` seams that keep each
    quantized write of one run and write those entries in another."""
    from phi_3_vision_mlx_tpu_torch.engine import state as S

    written = {}

    def positions(pos, k_new):
        return torch.arange(pos, pos + k_new.shape[2], device=k_new.device) if isinstance(pos, int) else pos

    def record(state, layer, pos, k_new, v_new):
        S.update_layer_chunk(state, layer, pos, k_new, v_new)
        if state.quantized:
            p = positions(pos, k_new)
            written[layer, int(p[0])] = (state.k[layer, :, :, p].clone(), state.k_scales[layer, :, :, p].clone())

    def replay(state, layer, pos, k_new, v_new):
        if not state.quantized:
            return S.update_layer_chunk(state, layer, pos, k_new, v_new)
        p = positions(pos, k_new)
        state.k[layer, :, :, p], state.k_scales[layer, :, :, p] = written[layer, int(p[0])]

    return record, replay


def forced_both(torch, lm, dict_input, tokens, own: bool = False):
    """(kernel route, plain route) f32 logits of ``lm`` forced with
    ``tokens`` (``forced_logits``), eager; the plain route writes the kernel
    route's quantized entries, or (``own``) its own."""
    from phi_3_vision_mlx_tpu_torch.models import phi3

    record, replay = entry_writes(torch)
    with mock.patch.object(phi3, "update_layer_chunk", record):
        kern = forced_logits(torch, lm, dict_input, tokens)
    if own:
        with plain_route():
            return kern, forced_logits(torch, lm, dict_input, tokens)
    with plain_route(), mock.patch.object(phi3, "update_layer_chunk", replay):
        return kern, forced_logits(torch, lm, dict_input, tokens)


def tie_split(torch, tokens, plain, tie: float):
    """The first step where ``tokens`` part from the plain route's argmax
    (len(tokens) if never), and whether the plain top-2 gap there is below
    ``tie``."""
    top2 = plain.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    picks = plain.argmax(-1).tolist()
    for d, tok in enumerate(tokens):
        if tok != picks[d]:
            return d, gaps[d] < tie, gaps
    return len(tokens), True, gaps


def fp32_launches(tag: str, launches: dict, expected) -> None:
    """Every expected kernel launched, all of them through its fp32 entry,
    and no other kernel."""
    log(f"{tag}: launches (total, of which fp32) {launches}")
    for name, (total, fp32) in launches.items():
        if name in expected and (total <= 0 or fp32 != total):
            fail(f"{tag}: {name} launched {total} times, {fp32} through its fp32 entry")
        if name not in expected and total != 0:
            fail(f"{tag}: {name} launched {total} times")


def read_counts(counters) -> dict:
    return {name: (fn.launches, fn.fp32.launches) for name, fn in counters.items()}


def fp32_params(torch, params):
    """``params`` with the norm weights in f32 (an fp32 checkpoint's)."""
    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return node.float() if key == "weight" and node.dtype == torch.bfloat16 else node

    return walk(params)


def phase_fp32_generate(torch, lm, proc, report) -> float:
    """Phase 17 (a): ``api.generate`` of phase 3's prompt for FP32_TOKENS
    greedy tokens; the same tokens from the decode step's graphs; every
    step's logits forced with them through the kernels and through the plain
    route on the card (quantized caches: the kernel run's entries written in
    the plain run), within FP32_STEP_REL_L2; the tokens equal the plain
    route's argmax up to its first top-2 gap below FP32_TIE.  With the int4
    cache, the plain route quantizing its own entries is read too: returns
    the largest logit change that made (0 otherwise), the noise that bounds
    phase 17 (b)'s int4 tie rule."""
    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.api import _apply_chat_template

    tag = f"phase 17 (a) fp32, {weights_of(lm)} weights, {cache_of(lm)} cache"
    cache = cache_of(lm)
    expected = set(matmul_kernels(lm)) | {"dense": {"K2", "K3"}, "int4": {"K4", "K5"}, "int8": {"K2", "K3"}}[cache]
    counters = zero_counters()
    t0 = time.perf_counter()
    text = api.generate(PROMPT_A, preload=(lm, proc), max_tokens=FP32_TOKENS, verbose=False, stream=False, mute=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fp32_launches(f"{tag}, api.generate", read_counts(counters), expected)
    if not isinstance(text, list) or not text or not text[0]:
        fail(f"{tag}: api.generate gave {text!r}")
    dict_input = proc(_apply_chat_template(PROMPT_A)[0])
    out, *_ = decode_run(torch, lm, dict_input, FP32_TOKENS, (FP32_TOKENS - 1,))
    tokens = [int(out[0][0])] + [int(t) for t in out[1][:, 0]]
    kern, plain = forced_both(torch, lm, dict_input, tokens[:-1])
    rel = ((kern - plain).norm(dim=-1) / plain.norm(dim=-1)).tolist()
    d, tie_ok, gaps = tie_split(torch, tokens, plain, FP32_TIE)
    log(f"{tag}: api.generate {wall:.2f} s for {FP32_TOKENS} tokens ({len(text[0])} chars); "
        f"{len(dict_input['input_ids'][0])}-token prompt; forced logits, kernels against the plain route: rel L2 "
        f"max {max(rel):.3e} (limit {FP32_STEP_REL_L2}); tokens equal the plain argmax for {d} of {len(tokens)} "
        f"(least plain top-2 gap {min(gaps):.3e})")
    if not all(math.isfinite(r) for r in rel) or max(rel) > FP32_STEP_REL_L2:
        fail(f"{tag}: the kernel route's logits disagree with the plain route's")
    if d < len(tokens) and not tie_ok:
        fail(f"{tag}: token {d} parts from the plain route with a top-2 gap {gaps[d]:.3e} >= {FP32_TIE}")
    report.setdefault("fp32", {})[f"{weights_of(lm)} {cache}"] = {"rel_l2": max(rel), "equal_tokens": d}
    if cache != "int4":
        return 0.0
    _, own = forced_both(torch, lm, dict_input, tokens[:-1], own=True)
    noise = float((own - plain).abs().max())
    log(f"{tag}: the plain route quantizing its own entries moves the logits by at most {noise:.3e} "
        f"(rel L2 max {float(((own - plain).norm(dim=-1) / plain.norm(dim=-1)).max()):.3e})")
    return noise


def phase_fp32_serve(torch, lm, proc, report, spec_k: int, tie: float):
    """Phase 17 (b): a ContinuousScheduler (4 slots, window 1024, the
    paged pool) serving four concurrent requests of FP32_SERVE; each
    request's greedy tokens against the plain route forced with them
    (single stream, the prompt as the engine processes it) up to the first
    plain top-2 gap below ``tie``; the launch counters show the fp32
    entries of the cache's kernels only."""
    from phi_3_vision_mlx_tpu_torch.serve.server import ContinuousScheduler

    cache = cache_of(lm)
    tag = f"phase 17 (b) fp32 continuous, {cache} pool, spec_k={spec_k}"
    expected = set(matmul_kernels(lm)) | ({"K5", "K7"} if cache == "int4" else {"K2", "K6"})
    sched = ContinuousScheduler(lm, proc, slots=SERVE_SLOTS, window=SERVE_WINDOW, paged=True, spec_k=spec_k)
    counters = zero_counters()
    texts = {}

    def worker(i):
        texts[i] = sched.complete(FP32_SERVE[i], FP32_SERVE_TOKENS[i])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(FP32_SERVE))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fp32_launches(tag, read_counts(counters), expected)
    by_len = {len(r.tokens): r.tokens for r in sched.engine.requests.values()}
    if sorted(texts) != list(range(len(FP32_SERVE))) or sorted(by_len) != sorted(FP32_SERVE_TOKENS):
        fail(f"{tag}: answered {sorted(texts)}, token counts {sorted(by_len)}")
    splits = []
    for prompt, n in zip(FP32_SERVE, FP32_SERVE_TOKENS):
        tokens = list(by_len[n])
        with plain_route():
            plain = forced_logits(torch, lm, proc(prompt), tokens[:-1])
        d, tie_ok, gaps = tie_split(torch, tokens, plain, tie)
        splits.append(d)
        if d < len(tokens) and not tie_ok:
            fail(f"{tag}: request of {n} tokens parts from the plain route at token {d} with a top-2 gap "
                 f"{gaps[d]:.3e} >= {tie:.3e}")
    log(f"{tag}: {len(FP32_SERVE)} requests in {wall:.2f} s; tokens equal the plain route's for {splits} of "
        f"{list(FP32_SERVE_TOKENS)} (tie rule: plain top-2 gap below {tie:.3e})")
    report.setdefault("fp32", {})[f"continuous {cache} spec_k={spec_k}"] = {"equal_tokens": splits}
    del sched


def phase_fp32_lora(torch, cfg, params, proc):
    """Phase 17 (c): one ``train_lora`` step of a 2-layer fp32 model over
    4-bit weights on the card (phase 13's 192-token rows, one of them: K1's
    fp32 entry under the autograd seam, at most 256 rows) against its CPU twin (the linears dequantized once, fp32), from
    the same initial A: the loss within FP32_LORA_RTOL and each adapter
    tensor's cosine to the twin's at least FP32_LORA_COS."""
    import tempfile

    from phi_3_vision_mlx_tpu_torch import api
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM
    from phi_3_vision_mlx_tpu_torch.train import trainer as TT

    cfg2 = cfg.replace(num_hidden_layers=2)
    small = {"model": {**params["model"], "layers": first_layers(params["model"]["layers"])},
             "lm_head": params["lm_head"]}
    card = LM(cfg2, small, device="cuda", graphs=False)
    twin = LM(cfg2, dequantized_linears(torch, small), device="cpu")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            kw = dict(model_path="phi3_fp32_2_layers", dataset_path="synthetic", take=1, lora_layers=2,
                      lora_rank=4)  # one row of 192 tokens, no masked copy: K1's rows
            counters = zero_counters()
            with mock.patch.object(api, "_load", lambda *a, **k: (card, proc)):
                TT.train_lora(adapter_path="adapters/card", device="cuda", **kw)
            launches = read_counts(counters)
            with mock.patch.object(api, "_load", lambda *a, **k: (twin, proc)):
                TT.train_lora(adapter_path="adapters/cpu", device="cpu", **kw)
            card_loss, cpu_loss = train_losses("adapters/card"), train_losses("adapters/cpu")
            ta, tb = lora_tensors("adapters/card"), lora_tensors("adapters/cpu")
        finally:
            os.chdir(cwd)
    rel = abs(card_loss[0] - cpu_loss[0]) / abs(cpu_loss[0])
    cos = {k: float(torch.nn.functional.cosine_similarity(ta[k].flatten().float(), tb[k].flatten().float(), dim=0))
           for k in sorted(ta)}
    log(f"phase 17 (c) fp32 LoRA step, 2 layers, width 3072, 4-bit weights: loss card {card_loss[0]!r}, CPU twin "
        f"{cpu_loss[0]!r} ({rel:.3e} relative, limit {FP32_LORA_RTOL}); adapter cosine to the twin's: least "
        f"{min(cos.values()):.6f} (limit {FP32_LORA_COS}); launches (total, of which fp32) {launches}")
    if (len(card_loss) != 1 or not math.isfinite(card_loss[0]) or rel > FP32_LORA_RTOL
            or min(cos.values()) < FP32_LORA_COS or sorted(ta) != sorted(tb)):
        fail("phase 17 (c): the card's fp32 LoRA step disagrees with the CPU twin's")
    if launches["K1"][0] <= 0 or launches["K1"][1] != launches["K1"][0]:
        fail(f"phase 17 (c): K1's fp32 entry did not carry the forward: {launches}")


def phase_fp32_models(torch, cfg, params, proc, report):
    """Phase 17: fp32 Phi-3.5-mini at full size with synthetic 4-bit
    group-64 weights over the dense, int4 and int8 caches, and with 8-bit
    and packed weights over the dense cache (a); the continuous paged
    server, dense and int4 with speculation (b); a LoRA step (c)."""
    from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig
    from phi_3_vision_mlx_tpu_torch.core.weights import packed_params, synth_quantized_params
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM

    cfg32 = cfg.replace(dtype="float32")
    p32 = fp32_params(torch, params)
    lm = LM(cfg32, p32, device="cuda")
    phase_fp32_generate(torch, lm, proc, report)
    lm_int4 = LM(cfg32.replace(use_quantized_cache=True), p32, device="cuda")
    noise = phase_fp32_generate(torch, lm_int4, proc, report)
    lm_int8 = LM(cfg32.replace(use_quantized_cache=True, kv_quant=KVQuantConfig(group_size=32, bits=8)), p32,
                 device="cuda")
    phase_fp32_generate(torch, lm_int8, proc, report)
    del lm_int8
    packed = packed_params(p32, cfg32)
    phase_fp32_generate(torch, LM(cfg32, packed, device="cuda"), proc, report)
    del packed
    cfg8 = full_config(bits=8).replace(dtype="float32")
    p8 = synth_quantized_params(cfg8, device="cuda", seed=0)
    phase_fp32_generate(torch, LM(cfg8, p8, device="cuda"), proc, report)
    del p8
    torch.cuda.empty_cache()
    stamp("phase 17 (a)")
    phase_fp32_serve(torch, lm, proc, report, spec_k=0, tie=FP32_TIE)
    # The int4 pool quantizes its own entries, from f32 values that differ
    # from the single stream's in the last bits (other row tiles): a value
    # at a level boundary then rounds the other way, which moved (a)'s
    # logits by `noise`.  Below twice that, a top-2 gap is a tie.
    phase_fp32_serve(torch, lm_int4, proc, report, spec_k=SPEC_K, tie=max(FP32_TIE, 2 * noise))
    for model in (lm, lm_int4):  # the fp32 paged step, through its graph
        phase_paged_profile(torch, model, proc, report, modes=("graph",))
    del lm, lm_int4
    torch.cuda.empty_cache()
    stamp("phase 17 (b)")
    phase_fp32_lora(torch, cfg32, p32, proc)
    stamp("phase 17")


def owner_chain(obj, skip: set, depth: int = 12, max_nodes: int = 20000):
    """The shortest chain of referrers (``gc.get_referrers``) from ``obj``
    up to a root: a frame of a running thread, a module's namespace or an
    object nothing else refers to.  ``skip``: ids of the caller's own
    containers.  Returns the chain as a list of objects, ``obj`` first."""
    import gc
    import types
    from collections import deque

    names = {t.ident: t.name for t in threading.enumerate()}
    census = {id(sys._getframe()), id(sys._getframe(1))}
    roots = {id(m.__dict__) for m in list(sys.modules.values()) if hasattr(m, "__dict__")}
    thread_of = {}
    for tid, frame in sys._current_frames().items():
        while frame is not None:
            if id(frame) not in census:
                thread_of[id(frame)] = names.get(tid, str(tid))
            frame = frame.f_back
    objs = {id(obj): obj}
    parent = {id(obj): None}
    todo = deque([id(obj)])
    ignore = skip | {id(objs), id(parent), id(todo)}
    while todo and len(parent) < max_nodes:
        cur = todo.popleft()
        hops, up = 0, cur
        while parent[up] is not None:
            up, hops = parent[up], hops + 1
        if hops >= depth:
            continue
        refs = gc.get_referrers(objs[cur])
        for r in refs:
            if id(r) in parent or id(r) in ignore or id(r) == id(refs):
                continue
            if isinstance(r, types.FrameType) and id(r) not in thread_of:
                continue  # a frame of this census, or a finished one
            objs[id(r)], parent[id(r)] = r, cur
            if id(r) in thread_of or id(r) in roots or not gc.get_referrers(r):
                chain, at = [], id(r)
                while at is not None:
                    chain.append(objs[at])
                    at = parent[at]
                return chain[::-1], thread_of
            todo.append(id(r))
    return None, thread_of


def describe_chain(chain, thread_of) -> str:
    """``Tensor <- dict['k'] <- SlotState <- ...``: each link's type, the
    key or index holding the one before, a frame's function and thread."""
    import types

    parts = []
    for child, holder in zip([None] + chain[:-1], chain):
        if isinstance(holder, types.FrameType):
            parts.append(f"frame {holder.f_code.co_name} (thread {thread_of.get(id(holder), '?')})")
        elif isinstance(holder, dict) and child is not None:
            key = next((k for k, v in holder.items() if v is child), "?")
            parts.append(f"dict[{key!r}]" if holder is not getattr(sys.modules.get(holder.get("__name__", "")),
                                                                    "__dict__", None) else f"module {holder['__name__']}")
        else:
            parts.append(type(holder).__qualname__)
    return " <- ".join(parts)


def live_tensors(torch, top: int = 8, owners: int = 4) -> None:
    """The card's memory still allocated at the end, its largest live
    tensors by (shape, dtype), and what holds the ``owners`` largest single
    tensors (``owner_chain``)."""
    import gc
    from collections import Counter

    gc.collect()
    sizes, largest = Counter(), []
    objects = gc.get_objects()
    for obj in objects:
        try:
            if torch.is_tensor(obj) and obj.is_cuda:
                nbytes = obj.numel() * obj.element_size()
                sizes[(tuple(obj.shape), str(obj.dtype))] += nbytes
                largest.append((nbytes, id(obj), obj))
        except Exception:  # objects that refuse inspection
            continue
    largest = sorted(largest, key=lambda t: t[:2], reverse=True)[:owners]
    skip = {id(objects), id(largest), id(sizes)} | {id(t) for t in largest}
    del objects
    for nbytes, _, t in largest:
        chain, thread_of = owner_chain(t, skip)
        held = "no root found" if chain is None else describe_chain(chain, thread_of)
        log(f"live tensor {tuple(t.shape)} {t.dtype} {nbytes / 2**30:.2f} GiB held by: {held}")
    del largest
    log(f"left allocated at the end: {torch.cuda.memory_allocated() / 2**30:.2f} GiB; largest live tensors (GiB): "
        + ", ".join(f"{shape} {dtype} {n / 2**30:.2f}" for (shape, dtype), n in sizes.most_common(top)))


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
    # The agent's embedder (phase 12) downloads GTE weights only online;
    # this script needs no network.
    os.environ["HF_HUB_OFFLINE"] = "1"

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
    phase_fp32_kernels(torch, report)
    phase_fp32_quantized_kernels(torch, report)
    phase_quantized_kernels(torch, report)
    phase_paged_kernels(torch, report)
    phase_w8_kernels(torch, report)
    phase_packed_kernels(torch, report)
    phase_experiment_kernels(torch, report)
    phase_long_kernels(torch, report)
    torch.cuda.empty_cache()
    stamp("phase 2")
    # Phase 15 runs here, on a card nothing else holds yet: its dense 128K
    # request needs 48 GiB of cache beside the kept 15 GiB int4 entry, and
    # the later phases leave models and graph entries allocated.
    phase_long(torch, report)

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
    # The int8 cache dequantizes each layer's window (read_kv), then runs K2/K3;
    # profiled at the long window only, where read_kv costs most.
    lm_int8 = LM(cfg.replace(use_quantized_cache=True, kv_quant=KVQuantConfig(group_size=32, bits=8)),
                 params, device="cuda")
    phase_profile(torch, lm_int8, proc, tags=("c",))
    del lm_int8
    stamp("phase 6")

    # Phase 7: 8-bit weights, from the port's own checkpoint writers, then
    # at full size beside the 4-bit weights.  Its 2-layer checkpoint is kept
    # for phase 13 (b).
    import tempfile

    run_dir = tempfile.TemporaryDirectory()
    raw = f"{run_dir.name}/phi3_mini_2_layers"
    phase_checkpoint(torch, raw)
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
    del lm_packed, params_packed
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
    del lmv, vparams
    torch.cuda.empty_cache()
    stamp("phase 10")

    # Phase 11: sampling and speculation on phases 3-6's 4-bit weights.
    phase_spec(torch, lm, lm_int4, proc, report)
    # Phase 12: long verify passes, constrained decoding, the agent, GTE.
    phase_constrain(torch, params, lm, lm_int4, proc, report)
    # Phase 16: the parallel layer in a world of one, and RetNet.
    phase_parallel(torch, params, lm, lm_int4, proc, report)
    # Phase 17: fp32 over quantized weights, caches and engines.
    phase_fp32_models(torch, cfg, params, proc, report)
    del lm, lm_int4
    torch.cuda.empty_cache()
    # Phase 13: LoRA training and adapter serving on the same weights.
    phase_train(torch, cfg, params, proc, report, raw)
    del params
    run_dir.cleanup()
    torch.cuda.empty_cache()
    # Phase 14: the runbook, the reference's benchmark, the chat UI's session
    # and the step log, through the port's entry points.
    phase_gates(torch, report)
    live_tensors(torch)
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
