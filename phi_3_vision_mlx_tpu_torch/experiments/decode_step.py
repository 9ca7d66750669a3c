"""One single-stream decode step of full-size Phi-3.5-mini, profiled: host
wall, device busy time, idle share and kernels a step, by weights, cache
and window (the runbook's decode paths: ``verify.py`` config 1 is fp32
weights over the dense cache, config 5 4-bit weights over the int4 cache at
a 32768-token window).

    python -m phi_3_vision_mlx_tpu_torch.experiments.decode_step --dtype float32 --prompt-tokens 49
    python -m phi_3_vision_mlx_tpu_torch.experiments.decode_step --bits 4 --cache int4 --prompt-tokens 32576
    python -m phi_3_vision_mlx_tpu_torch.experiments.decode_step --dtype float32 --bits 8 --cache int8
    python -m phi_3_vision_mlx_tpu_torch.experiments.decode_step --dtype float32 --bits 4 --packed

All 32 layers, random weights from seed 0 built on the card (fp32:
``models/phi3.py:init_params``; 4-bit and 8-bit: ``core/weights.py:
synth_quantized_params``, ``--packed`` moving the 4-bit linears to the
flat packed layout), a prompt of ``--prompt-tokens`` byte tokens, its
bucketed prefill and 64 tokens of budget (the window rounds their sum up to
128), then the decode step as the engine runs it: a CUDA graph replay (its
capture in a warm-up chunk).  Wall: host clock over 16 steps ending in the
chunk's device-to-host copy; busy: the profiler's kernel time over 4 steps;
prefill: host clock, synchronized, the first (``prefill_ms``, first-call
costs included) and, after the decode steps, the same prompt again
(``prefill_warm_ms``).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import card, device_from


def main(argv=None) -> dict:
    from ..core.config import KVQuantConfig, QuantConfig, preset
    from ..core.weights import packed_params, prepare_params, synth_quantized_params
    from ..engine.engine import LM, prefill_decoder, release_decoder
    from ..models import phi3
    from ..models.preprocess import Phi3Processor
    from ..models.tokenizer import ByteTokenizer
    from ..ops.kernels import flash_attention as K2
    from ..ops.kernels import kv_attention as KV
    from ..ops.kernels import quant_matmul as K1

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    parser.add_argument("--bits", type=int, default=0, choices=[0, 4, 8],
                        help="4 or 8 (0: unquantized weights)")
    parser.add_argument("--packed", action="store_true", help="4-bit linears in the flat packed layout (K9)")
    parser.add_argument("--cache", default="dense", choices=["dense", "int4", "int8"])
    parser.add_argument("--prompt-tokens", type=int, default=175)
    args, device = device_from(parser, argv)
    max_tokens, steps = 64, 16
    if device.type != "cuda":
        raise SystemExit("decode_step times the card: it has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.packed and args.bits != 4:
        parser.error("--packed takes 4-bit weights")
    cfg = preset("phi35_mini").replace(dtype=args.dtype, use_quantized_cache=args.cache != "dense")
    if args.cache == "int8":
        cfg = cfg.replace(kv_quant=KVQuantConfig(group_size=32, bits=8))
    t0 = time.perf_counter()
    if args.bits:
        cfg = cfg.replace(quantized=QuantConfig(group_size=64, bits=args.bits))
        params = synth_quantized_params(cfg, device=device, seed=0)
        if args.packed:
            params = packed_params(params, cfg)
    else:
        params = prepare_params(phi3.init_params(cfg, torch.Generator(device=device).manual_seed(0)), cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lm = LM(cfg, params, device=device)
    proc = Phi3Processor(tokenizer=ByteTokenizer())  # a byte a token
    prompt = "The lighthouse keeper logged the weather. " * (args.prompt_tokens // 40 + 1)
    dict_input = {"input_ids": proc(prompt)["input_ids"][:, -args.prompt_tokens:]}
    counters = {"K1": K1.quant_matmul, "K2": K2.flash_attention, "K3": KV.dense_kv_attention,
                "K4": KV.quantized_kv_attention, "K5": KV.quantized_flash_attention,
                "K8": K1.quant_matmul_w8, "K9": K1.quant_matmul_packed}
    counters.update({f"{name} fp32": fn.fp32 for name, fn in list(counters.items())})
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec, _ = prefill_decoder(lm, dict_input, max_tokens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dec.chunk(2)[0].cpu()  # warm-up: the graph's capture
    capture_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dec.chunk(steps)[0].cpu()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    busy, kernels = None, 0
    for _ in range(3):  # the profiler now and then loses a window's kernels
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dec.chunk(4)[0].cpu()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            busy, kernels = sum(e.device_time_total for e in events) / 1e3 / 4, len(events) / 4
            break
    release_decoder(lm, dec)
    launches = {k: fn.launches for k, fn in counters.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec, _ = prefill_decoder(lm, dict_input, max_tokens)  # again, warm: no first-call costs
    torch.cuda.synchronize()
    prefill_warm_ms = (time.perf_counter() - t0) * 1e3
    window = dec.state.window
    release_decoder(lm, dec)  # an entry too large to keep is closed here
    out = {"card": card(device), "dtype": args.dtype, "bits": args.bits, "packed": args.packed,
           "cache": args.cache,
           "prompt_tokens": int(dict_input["input_ids"].shape[1]),
           "window": window, "build_s": build_s, "prefill_ms": prefill_ms,
           "prefill_warm_ms": prefill_warm_ms,
           "first_chunk_ms": capture_ms, "wall_ms": wall, "busy_ms": busy,
           "idle": None if busy is None else 1 - busy / wall, "kernels": kernels,
           "tok_s": 1e3 / wall, "launches": launches}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
