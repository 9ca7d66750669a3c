"""E3, the dequantization sweep of int4-cache decode attention (the port of
``experiments/qdecode_sweep.py``).

Question: at long windows, is K4 bound by its dequantization arithmetic, by
its softmax, or by bytes?  Each mode of ``quantized_kv_attention_variant``
(``ops/kernels/kv_attention.py``) runs one decode step of Phi-3.5-mini (32
layers, 32 heads of 96, one query at the window's last position) over the
port's int4 cache, at two split sizes (keys per block; the port's
counterpart of the TPU script's block size):

  fp32    - K4 (production)            bf16    - dequantize in bf16 arithmetic
  u8      - fp32 (the TPU variant has no branch of its own)
  noscale - raw levels (diagnostic: wrong numerics)
  nomul   - level + scale, no multiply (diagnostic: wrong numerics)
  fbias   - bias factored onto the scores and the output
  mxu     - scale and bias both factored

Each mode's error is taken against the fp32 step, never against another
mode.  Bytes per step are ``nl * b * kvh * (d + 8 * G) * L`` (payload and
bf16 scales).

    QD_LMAX=32768 QD_MODES=fp32,mxu python -m phi_3_vision_mlx_tpu_torch.experiments.qdecode_sweep [--device cpu]

A CPU run (give a small ``QD_LMAX``) reports the errors and times nothing.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..ops.kernels.kv_attention import quantized_kv_attention_variant
from . import card, cuda_ms, device_from, layer_sum

# The TPU script's mode names -> the kernel's modes.
MODES = {"fp32": "fp32", "u8": "fp32", "bf16": "bf16", "noscale": "convert", "nomul": "nomul",
         "fbias": "fbias", "mxu": "mxu"}
SPLITS = (256, 1024)
ITERS = 20


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args, device = device_from(parser, argv)
    nl, b, kvh, h, d, groups = 32, 1, 32, 32, 96, 3  # Phi-3.5-mini, G = 3 (group 32)
    lmax = int(os.environ.get("QD_LMAX", "32768"))
    modes = tuple(os.environ.get("QD_MODES", "fp32,mxu").split(","))
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise SystemExit(f"unknown QD_MODES {unknown}; known: {sorted(MODES)}")
    g = torch.Generator(device=device).manual_seed(0)
    payload = torch.randint(0, 256, (nl, b, kvh, lmax, d), dtype=torch.uint8, generator=g, device=device)
    scales = (0.01 * torch.randn((nl, b, kvh, lmax, 4 * groups), generator=g, device=device)).to(torch.bfloat16)
    q = torch.randn((b, h, 1, d), generator=g, device=device).to(torch.bfloat16)
    valid = torch.ones((b, lmax), dtype=torch.bool, device=device)
    scale = d**-0.5
    offset = torch.tensor([lmax - 1], dtype=torch.int32, device=device)  # the device offset

    def step(mode, split):
        return layer_sum(lambda layer: quantized_kv_attention_variant(
            q, payload, scales, valid, offset, layer, scale, mode=mode, split_keys=split), nl, q)

    print(f"# int4-cache decode dequantization sweep (E3): {nl} layers, {kvh} heads, D={d}, "
          f"window {lmax}, on {card(device)}")
    ref = step("fp32", SPLITS[0])
    bytes_moved = nl * b * kvh * (d + 8 * groups) * lmax
    result = {"lmax": lmax, "rows": {}}
    for mode in modes:
        for split in SPLITS:
            name = f"{mode}/split{split}"
            out = step(MODES[mode], split)
            err = float((out - ref).abs().max())
            if device.type != "cuda":
                result["rows"][name] = {"max_err": err}
                print(f"{name}: err={err} (CPU: no timing)")
                continue
            ms = cuda_ms(lambda: step(MODES[mode], split), ITERS, warmup=1)
            gbps = bytes_moved / ms / 1e6
            result["rows"][name] = {"step_ms": ms, "GBps": gbps, "max_err": err}
            print(f"{name}: {ms:.2f} ms/step  {gbps:.0f} GB/s  err={err}", flush=True)
    return result


if __name__ == "__main__":
    main()
