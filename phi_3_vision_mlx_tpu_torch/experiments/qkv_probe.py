"""E2, the bottleneck probe of int4-cache decode attention (the port of
``experiments/qkv_probe.py``).

Three variants over the port's int4 cache (``engine/state.py``: token-major,
original D order) of Phi-3.5-mini (32 layers, 32 KV heads of 96, one query
per head at the window's last position), one decode step = all 32 layers:

  full     - K4, the production kernel (dequantize + online softmax)
  convert  - the dequantization replaced by a plain level -> float convert
             (no scale loads, no multiply-add): payload bytes + softmax
  mxuonly  - convert with no mask and no softmax (the output is the sum of
             score * value): payload bytes + the two dot products

If ``convert`` is about as fast as ``full``, dequantization is not what
bounds K4.  Bytes per step and GB/s count what each variant reads.

    python -m phi_3_vision_mlx_tpu_torch.experiments.qkv_probe [lmax] [--device cpu]

The window defaults to 32768.  A CPU run (give a small lmax) checks only
that each variant runs and is finite; it times nothing.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.kernels.kv_attention import quantized_kv_attention, quantized_kv_attention_variant
from . import card, cuda_ms, device_from, layer_sum

NL, B, KVH, D, G = 32, 1, 32, 96, 3
SCALE = D**-0.5
REPS = 8


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("lmax", nargs="?", type=int, default=32768)
    args, device = device_from(parser, argv)
    lmax = args.lmax
    g = torch.Generator(device=device).manual_seed(0)
    payload = torch.randint(0, 256, (NL, B, KVH, lmax, D), dtype=torch.uint8, generator=g, device=device)
    scales = (torch.rand((NL, B, KVH, lmax, 4 * G), generator=g, device=device) * 0.02).to(torch.bfloat16)
    q = (torch.randn((B, KVH, 1, D), generator=g, device=device) * 0.3).to(torch.bfloat16)
    valid = torch.ones((B, lmax), dtype=torch.bool, device=device)
    offset = torch.tensor([lmax - 1], dtype=torch.int32, device=device)  # the device offset
    variants = {
        "full": (lambda layer: quantized_kv_attention(q, payload, scales, valid, offset, layer, SCALE),
                 payload.numel() + 2 * scales.numel()),
        "convert": (lambda layer: quantized_kv_attention_variant(
            q, payload, scales, valid, offset, layer, SCALE, mode="convert"), payload.numel()),
        "mxuonly": (lambda layer: quantized_kv_attention_variant(
            q, payload, scales, valid, offset, layer, SCALE, mode="nosoftmax"), payload.numel()),
    }
    print(f"# int4-cache decode attention probe (E2): {NL} layers, {KVH} KV heads, D={D}, "
          f"window {lmax}, one step = {NL} layers, on {card(device)}")
    result = {"lmax": lmax, "rows": {}}
    for name, (attend, nbytes) in variants.items():
        out = layer_sum(attend, NL, q)
        if not bool(torch.isfinite(out).all()):
            raise SystemExit(f"{name}: non-finite output")
        if device.type != "cuda":
            print(f"{name:8s} ran, finite (CPU: no timing)")
            continue
        ms = cuda_ms(lambda: layer_sum(attend, NL, q), REPS, warmup=1)
        result["rows"][name] = {"step_ms": ms, "GBps": nbytes / ms / 1e6}
        print(f"{name:8s} {ms:8.2f} ms  {nbytes / ms / 1e6:6.1f} GB/s", flush=True)
    return result


if __name__ == "__main__":
    main()
