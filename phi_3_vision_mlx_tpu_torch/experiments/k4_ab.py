"""Time kernels of several source trees of this repository in turns, on one
card, each tree in its own process built from its own ``csrc/``.

    python -m phi_3_vision_mlx_tpu_torch.experiments.k4_ab [--kernels K1,...,K9,E1,E3,K4S,K2F,K1F,...] TREE [TREE ...]

Give the trees in the order to run them (parent, change, change, parent) so
that drift on the card shows.  Each run times every case of the chosen
kernels (K1-K9 by default) at chip_smoke.py's shapes:

* K1 (W4A16) at qkv (K = 3072, N = 9216) with M = 1 and 192, and at lm_head
  (N = 32064) with M = 1; K8 (W8A16, (K/4, N) words) at qkv with M = 1 and
  192 and at down (K = 8192, N = 3072) with M = 1; K9 (the packed layout) at
  qkv with M = 1 and 192; weights rotated past the 50 MB L2, as decode reads
  them;
* K2 (flash attention, dense): lq = 1024 over 1152 keys (24 left-pad rows)
  and lq = 4224 over 4352 keys (the 4207-token prompt's bucket);
* K2F (flash attention in fp32, an fp32 model's prefill): lq = 64 over 128
  keys (34 left-pad rows: the runbook's config 1), lq = 1024 over 1152 (24)
  and lq = 4224 over 4352 (17), each beside fp32 SDPA over the same mask
  (one PyTorch call, timed in every tree's run);
* K3 (decode, dense cache): Lq = 1 at the end of a 640- and a 4224-key
  window and at offset 100 of a 4352-key window, 8 stacked layers rotated
  past the L2; K4 (decode, int4 cache)
  the same at Lq = 1, 4 and 16, and at Lq = 8 (a verify pass of K = 7) at
  the end of a 768- and a 4352-key window;
* E1 (W4A8) and K1 (symmetric, bf16 out, as ``w4a8_bench`` calls it) on
  the same words and scales at w4a8_bench's shape (K = 3072, N = 9216) with
  M = 1, 2, 16, 64, 192 and 256, rotated past the L2;
* E3 (K4's kernels with a mode): modes fp32 and mxu at 256 and 1024 keys
  per block (qdecode_sweep's sweep), Lq = 1 at the end of 4224 keys;
* K4S (the sweep behind K4's plan, ``kv_attention.K4_BLOCK_KEYS``): K4's
  kernels (E3's fp32 mode, whose instantiation K4 is) at 64-1024 keys per
  block, Lq = 1 and 16, at the end of 640- and 4224-key windows, Lq = 1
  at the end of 2048 keys and at chip_smoke.py phase 6's decode shapes
  (offset 200 of a 768-key window, 4220 of 4352);
* K5 (flash attention, int4 cache): lq = 1024 over 1152 keys and lq = 4224
  over 4352 keys, as K2;
* K6 (paged, dense pool) at Lq = 1, 4 and 16 and K7 (paged, int4 pool)
  at Lq = 1, 4, 8 (a verify pass) and 16:
  the continuous server's shapes (4 slots at offsets 100, 400, 700
  and 1000, a window of 16 pages of 64, a pool of 64 pages and the spare),
  4 (K6) or 8 (K7) stacked layers rotated past the L2;
* the fp32 entries (an fp32 model's f32 activations and queries): K1F,
  K8F, K9F (K1, K8, K9 with f32 x and output) at qkv with M = 1, 4, 8 and
  192, weights rotated past the L2 as above; K4F (K4 with an f32 query) at
  Lq = 1 and 8 at the end of a 640- and a 4224-key window; K6F (K6 over an
  f32 pool) and K7F (K7, f32 queries) at Lq = 1 and 8 at the continuous
  server's shapes above;

attention with 32 heads of 96.  K1's route A (M = 1) against route B at a
few rows is timed with a sibling tree whose ``route()`` (and the C entry's
``launch_route``) sends M = 1 to route B.

For each case: rounds of CUDA-event time per call and the profiler's device
time per call (every kernel the call launches, and by kernel).  The timing
code is this module's own, so an older tree is timed the same way.  Prints
one JSON line per tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "E1", "E3", "K4S", "K2F",
           "K1F", "K8F", "K9F", "K4F", "K6F", "K7F")
DEFAULT = KERNELS[:9]

_RUN = r'''
import json, math, random, sys, torch
sys.path.insert(0, ".")
from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as QM
from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig
from phi_3_vision_mlx_tpu_torch.engine.state import quantize_chunk
from phi_3_vision_mlx_tpu_torch.ops.kernels import flash_attention as FA
from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as KV
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def cuda_ms(fn, iters, warmup):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """(device ms per call, {kernel: device ms per call}); a window in which
    the profiler recorded no kernel is profiled again, up to three times,
    and then the time is None."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.removeprefix("void ").replace("(anonymous namespace)::", "").split("<")[0]
                by[name] = by.get(name, 0.0) + e.device_time_total / 1e3 / iters
        if sum(by.values()) > 0:
            return sum(by.values()), by
    return None, {}


kernels = sys.argv[1].split(",")
g = torch.Generator(device="cuda").manual_seed(2)
b, h, d, nl = 1, 32, 96, 8
scale = d**-0.5
bf16 = lambda t: t.to(torch.bfloat16)
qrow = lambda lq: bf16(torch.randn((b, lq, h, d), generator=g, device="cuda")).transpose(1, 2)
cases = {}


def decode_window(lmax):
    valid = torch.rand((b, lmax), generator=g, device="cuda") > 0.05
    valid[:, :10] = False
    return valid


def flash_window(lq, lk, pad):
    valid = torch.ones((b, lk), dtype=torch.bool, device="cuda")
    valid[:, :pad] = False
    return valid


if "K2" in kernels:
    for lq, lk, pad, iters in ((1024, 1152, 24, 100), (4224, 4352, 17, 10)):
        q, valid = qrow(lq), flash_window(lq, lk, pad)
        k, v = (bf16(torch.randn((b, h, lk, d), generator=g, device="cuda")) for _ in range(2))
        cases[f"K2 lq={lq} lk={lk}"] = (lambda q=q, k=k, v=v, valid=valid: FA.flash_attention(
            q, k, v, valid, 0, scale), iters)
if "K2F" in kernels:
    from phi_3_vision_mlx_tpu_torch.ops.attention import causal_valid_mask
    for lq, lk, pad, iters in ((64, 128, 34, 200), (1024, 1152, 24, 50), (4224, 4352, 17, 5)):
        q = torch.randn((b, lq, h, d), generator=g, device="cuda").transpose(1, 2)
        valid = flash_window(lq, lk, pad)
        k, v = (torch.randn((b, h, lk, d), generator=g, device="cuda") for _ in range(2))
        mask = causal_valid_mask(valid, torch.arange(lq, device="cuda"))
        cases[f"K2F lq={lq} lk={lk}"] = (lambda q=q, k=k, v=v, valid=valid: FA.flash_attention(
            q, k, v, valid, 0, scale), iters)
        cases[f"K2F SDPA lq={lq} lk={lk}"] = (
            lambda q=q, k=k, v=v, mask=mask: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale), iters)
def int4_stack(lmax):
    kk = torch.randn((nl, b, h, lmax, d), generator=g, device="cuda") + 0.5
    vv = torch.randn((nl, b, h, lmax, d), generator=g, device="cuda") - 0.3
    return quantize_chunk(bf16(kk), bf16(vv), KVQuantConfig(32, 4))


def device_offset(offset):
    """The decode kernels read the offset on the device, as the engine keeps
    it; a tree from before that takes a host int."""
    if not hasattr(KV, "check_device_offset"):
        return offset
    return torch.tensor([offset], dtype=torch.int32, device="cuda")


def variant_case(name, q, cache, valid, offset, mode, split):
    turn, off = iter(range(10**9)), device_offset(offset)
    cases[name] = (lambda: KV.quantized_kv_attention_variant(
        q, *cache, valid, off, next(turn) % nl, scale, mode=mode, split_keys=split), 200)


for lmax in (640, 4224):
    q, valid = qrow(1), decode_window(lmax)
    if "K3" in kernels:
        ks, vs = (bf16(torch.randn((nl, b, h, lmax, d), generator=g, device="cuda")) for _ in range(2))
        turn = iter(range(10**9))
        cases[f"K3 Lq=1 Lmax={lmax}"] = (lambda q=q, ks=ks, vs=vs, valid=valid, off=device_offset(lmax - 1),
                                        turn=turn: KV.dense_kv_attention(q, ks, vs, valid, off,
                                                                         next(turn) % nl, scale), 200)
    if not {"K4", "E3", "K4S", "K4F"} & set(kernels):
        continue
    payload, scales = int4_stack(lmax)
    if "K4F" in kernels:
        for lq in (1, 8):
            turn = iter(range(10**9))
            cases[f"K4F Lq={lq} Lmax={lmax}"] = (
                lambda q=torch.randn((b, lq, h, d), generator=g, device="cuda").transpose(1, 2), p=payload,
                s=scales, valid=valid, off=device_offset(lmax - lq), turn=turn:
                KV.quantized_kv_attention(q, p, s, valid, off, next(turn) % nl, scale), 200)
    qs = {lq: qrow(lq) for lq in (1, 4, 16)}
    if "K4" in kernels:
        for lq, ql in qs.items():
            turn = iter(range(10**9))
            cases[f"K4 Lq={lq} Lmax={lmax}"] = (
                lambda q=ql, p=payload, s=scales, valid=valid, off=device_offset(lmax - lq), turn=turn:
                KV.quantized_kv_attention(q, p, s, valid, off, next(turn) % nl, scale), 200)
    if "E3" in kernels and lmax == 4224:
        for mode in ("fp32", "mxu"):
            for split in (256, 1024):
                variant_case(f"E3 {mode} split={split} Lq=1 Lmax={lmax}", q, (payload, scales), valid,
                             lmax - 1, mode, split)
    if "K4S" in kernels:
        for lq in (1, 16):
            for split in (64, 128, 256, 512, 1024):
                variant_case(f"K4S Lq={lq} Lmax={lmax} offset={lmax - lq} keys={split}", qs[lq],
                             (payload, scales), valid, lmax - lq, "fp32", split)
    del payload, scales
if "K4" in kernels:  # a verify pass of K = 7 drafts: Lq = 8 at the window's end
    for lmax in (768, 4352):
        payload, scales = int4_stack(lmax)
        turn = iter(range(10**9))
        cases[f"K4 Lq=8 Lmax={lmax}"] = (
            lambda q=qrow(8), p=payload, s=scales, valid=decode_window(lmax),
            off=device_offset(lmax - 8), turn=turn:
            KV.quantized_kv_attention(q, p, s, valid, off, next(turn) % nl, scale), 200)
if "K3" in kernels:  # a long prompt's first decode steps: few keys seen in a long window
    q, valid = qrow(1), decode_window(4352)
    ks, vs = (bf16(torch.randn((nl, b, h, 4352, d), generator=g, device="cuda")) for _ in range(2))
    turn = iter(range(10**9))
    cases["K3 Lq=1 Lmax=4352 offset=100"] = (lambda q=q, ks=ks, vs=vs, valid=valid, off=device_offset(100),
                                             turn=turn: KV.dense_kv_attention(q, ks, vs, valid, off,
                                                                              next(turn) % nl, scale), 200)
    del ks, vs
if "K4S" in kernels:  # chip_smoke.py phase 6's decode windows, short and long, and one between
    for lmax, offset in ((768, 200), (2048, 2047), (4352, 4220)):
        q, valid = qrow(1), decode_window(lmax)
        cache = int4_stack(lmax)
        for split in (64, 128, 256, 512, 1024):
            variant_case(f"K4S Lq=1 Lmax={lmax} offset={offset} keys={split}", q, cache, valid, offset,
                         "fp32", split)


def w_weights(k, n, layout):
    """Enough (payload, scales, biases) copies of one (K, N) to exceed the L2:
    ``layout`` "words4" (K/8, N) or "words8" (K/4, N) int32, "packed" (K,
    N/2) uint8."""
    per_weight = 1.0 if layout == "words8" else 0.5
    copies = max(1, math.ceil(150e6 / (k * n * per_weight + 4 * (k // 64) * n)))
    s = lambda: (0.004 * (1 + 0.1 * torch.randn((k // 64, n), generator=g, device="cuda"))).to(torch.bfloat16)
    b = lambda: torch.full((k // 64, n), -0.03, dtype=torch.bfloat16, device="cuda")
    if layout == "packed":
        q = lambda: torch.randint(0, 256, (k, n // 2), dtype=torch.uint8, generator=g, device="cuda")
    else:
        rows = k // (8 if layout == "words4" else 4)
        q = lambda: torch.randint(-(2**31), 2**31, (rows, n), dtype=torch.int32, generator=g, device="cuda")
    return [(q(), s(), b()) for _ in range(copies)]


def matmul_case(name, fn, ws, m, k, dtype=torch.bfloat16):
    x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    turn = iter(range(10**9))
    cases[name] = (lambda: fn(x, *ws[next(turn) % len(ws)]), 200)


MATMULS = {"K1": (QM.quant_matmul, "words4", ((3072, 9216, (1, 192)), (3072, 32064, (1,)))),
           "K8": (QM.quant_matmul_w8, "words8", ((3072, 9216, (1, 192)), (8192, 3072, (1,)))),
           "K9": (QM.quant_matmul_packed, "packed", ((3072, 9216, (1, 192)),))}
for name, (fn, layout, shapes) in MATMULS.items():
    if name not in kernels and name + "F" not in kernels:
        continue
    for k, n, ms in shapes:
        if name not in kernels and n != 9216:
            continue
        ws = w_weights(k, n, layout)
        if name in kernels:
            for m in ms:
                matmul_case(f"{name} K={k} N={n} M={m}", fn, ws, m, k)
        if name + "F" in kernels and n == 9216:  # fp32: f32 x and output at qkv
            for m in (1, 4, 8, 192):
                matmul_case(f"{name}F K={k} N={n} M={m}", fn, ws, m, k, torch.float32)
        del ws
if "E1" in kernels:
    from phi_3_vision_mlx_tpu_torch.ops.kernels import w4a8 as E1
    ws = [(q, s) for q, s, _ in w_weights(3072, 9216, "words4")]
    for m in (1, 2, 16, 64, 192, 256):
        matmul_case(f"E1 K=3072 N=9216 M={m}", E1.w4a8_matmul, ws, m, 3072)
        matmul_case(f"E1's K1 K=3072 N=9216 M={m}", lambda x, q, s: QM.quant_matmul(x, q, s), ws, m, 3072)
    del ws
if "K5" in kernels:
    for lq, lk, pad, iters in ((1024, 1152, 24, 100), (4224, 4352, 17, 10)):
        q, valid = qrow(lq), flash_window(lq, lk, pad)
        kk = torch.randn((2, b, h, lk, d), generator=g, device="cuda") + 0.5
        vv = torch.randn((2, b, h, lk, d), generator=g, device="cuda") - 0.3
        payload, scales = quantize_chunk(bf16(kk), bf16(vv), KVQuantConfig(32, 4))
        del kk, vv
        cases[f"K5 lq={lq} lk={lk}"] = (lambda q=q, p=payload, s=scales, valid=valid:
                                       KV.quantized_flash_attention(q, p, s, valid, 0, 1, scale), iters)
if {"K6", "K7", "K6F", "K7F"} & set(kernels):
    slots, page, window, pool, offs = 4, 64, 1024, 64, (100, 400, 700, 1000)
    ids = random.Random(3).sample(range(pool), pool)
    tables = torch.full((slots, window // page), pool, dtype=torch.int32)
    for i, off in enumerate(offs):
        n = -(-(off + 4) // page)
        tables[i, :n] = torch.tensor([ids.pop() for _ in range(n)])
    tables, offsets = tables.cuda(), torch.tensor(offs, dtype=torch.int32, device="cuda")
    pvalid = torch.rand((slots, window), generator=g, device="cuda") > 0.05
    pvalid[:, :10] = False
    srow = lambda lq: bf16(torch.randn((slots, lq, h, d), generator=g, device="cuda")).transpose(1, 2)
    shape = lambda nl: (nl, pool + 1, h, page, d)
    if "K6" in kernels:
        pk, pv = (bf16(torch.randn(shape(4), generator=g, device="cuda")) for _ in range(2))
        for lq in (1, 4, 16):
            turn = iter(range(10**9))
            cases[f"K6 Lq={lq}"] = (lambda q=srow(lq), turn=turn: KV.paged_kv_attention(
                q, pk, pv, tables, pvalid, offsets, next(turn) % 4, scale), 200)
    if "K6F" in kernels:
        fk, fv = (torch.randn(shape(4), generator=g, device="cuda") for _ in range(2))
        for lq in (1, 8):
            turn = iter(range(10**9))
            cases[f"K6F Lq={lq}"] = (lambda q=srow(lq).float(), turn=turn: KV.paged_kv_attention(
                q, fk, fv, tables, pvalid, offsets, next(turn) % 4, scale), 200)
    if "K7" in kernels or "K7F" in kernels:
        kk = torch.randn(shape(8), generator=g, device="cuda") + 0.5
        vv = torch.randn(shape(8), generator=g, device="cuda") - 0.3
        pools = quantize_chunk(bf16(kk), bf16(vv), KVQuantConfig(32, 4))
        del kk, vv
        for lq in (1, 4, 8, 16) if "K7" in kernels else ():
            turn = iter(range(10**9))
            cases[f"K7 Lq={lq}"] = (lambda q=srow(lq), turn=turn: KV.paged_quantized_kv_attention(
                q, *pools, tables, pvalid, offsets, next(turn) % 8, scale), 200)
        for lq in (1, 8) if "K7F" in kernels else ():
            turn = iter(range(10**9))
            cases[f"K7F Lq={lq}"] = (lambda q=srow(lq).float(), turn=turn: KV.paged_quantized_kv_attention(
                q, *pools, tables, pvalid, offsets, next(turn) % 8, scale), 200)
res = {}
for name, (call, iters) in cases.items():
    dev, by_kernel = device_ms(call, max(5, iters // 4))
    res[name] = {"events_ms": [cuda_ms(call, iters, warmup=3) for _ in range(5)],
                 "device_ms": dev, "device_ms_by_kernel": by_kernel}
print(json.dumps({"cases": res, "card": torch.cuda.get_device_name(0)}))
'''


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=",".join(DEFAULT),
                    help=f"comma-separated subset of {','.join(KERNELS)}")
    ap.add_argument("trees", nargs="+", help="source trees, in the order to time them")
    a = ap.parse_args(argv)
    bad = set(a.kernels.split(",")) - set(KERNELS)
    if bad:
        ap.error(f"unknown kernels {sorted(bad)}")
    results = []
    for tree in a.trees:
        out = subprocess.run([sys.executable, "-c", _RUN, a.kernels], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise SystemExit(f"{tree}: exit {out.returncode}\n{out.stderr[-3000:]}")
        res = {"tree": os.path.abspath(tree), **json.loads(out.stdout.strip().splitlines()[-1])}
        results.append(res)
        print(json.dumps(res), flush=True)
    return results


if __name__ == "__main__":
    main()
