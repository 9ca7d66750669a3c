"""E1, the W4A8 experiment (the port of ``experiments/w4a8_bench.py``).

Question: a 4-bit decode matmul reads its payload once, so it is bound by
bytes; would int8 activations and an int8 contraction help?  E1 takes a
``dp4a`` GEMV at M = 1 and the int8 tensor cores above, K1 a bf16 GEMV and
the bf16 tensor cores.  Kernel E1
(``ops/kernels/w4a8.py``) against K1 (``ops/kernels/quant_matmul.py``) in
symmetric mode on the same ``(K/8, N)`` words and bf16 scales, at the
gate_up shape of the JAX script (K = 3072, N = 9216) and decode batches M
in {1, 2, 4, 8, 16, 64, 256}.  Weights are rotated past the 50 MB L2, as a
decode step reads them.

    python -m phi_3_vision_mlx_tpu_torch.experiments.w4a8_bench [--device cpu] [--k K --n N]

Correctness first: E1 against the bf16 path (K1) at M = 4 within 0.05 mean
relative error (the int8 activation error).  A CPU run checks only that (at
K = N = 512 unless given) and times nothing.
"""

from __future__ import annotations

import argparse
import math

import torch

from ..ops.kernels.quant_matmul import quant_matmul
from ..ops.kernels.w4a8 import w4a8_matmul
from . import card, cuda_ms, device_from, device_ms, ms_text

M_SWEEP = (1, 2, 4, 8, 16, 64, 256)
GROUP = 64
MAX_REL = 0.05


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--k", type=int, default=None)
    parser.add_argument("--n", type=int, default=None)
    args, device = device_from(parser, argv)
    on_card = device.type == "cuda"
    k = args.k or (3072 if on_card else 512)
    n = args.n or (9216 if on_card else 512)
    g = torch.Generator(device=device).manual_seed(0)
    nbytes = k * n // 2 + 2 * (k // GROUP) * n
    copies = max(1, math.ceil(150e6 / nbytes)) if on_card else 1
    weights = [(torch.randint(-(2**31), 2**31, (k // 8, n), dtype=torch.int32, generator=g, device=device),
                (0.01 * torch.randn((k // GROUP, n), generator=g, device=device)).to(torch.bfloat16))
               for _ in range(copies)]

    x = torch.randn((4, k), generator=g, device=device).to(torch.bfloat16)
    ref = quant_matmul(x, *weights[0], None, out_dtype=torch.float32)
    got = w4a8_matmul(x, *weights[0])
    rel = float((got - ref).abs().mean() / (ref.abs().mean() + 1e-6))
    print(f"# W4A8 (E1) vs the bf16 path (K1, symmetric)  (K={k}, N={n}, g={GROUP}) on {card(device)}")
    print(f"mean |d|/|y| vs bf16 path: {rel:.4f}  (int8 activation error; limit {MAX_REL})")
    if not rel < MAX_REL:
        raise SystemExit("E1 is numerically wrong, not just quantized")
    result = {"k": k, "n": n, "mean_rel_err": rel, "rows": []}
    if not on_card:
        print("(CPU: correctness only, no timing)")
        return result

    # Events: stream time per call, host launch gaps included.  Device: the
    # profiler's kernel time per call (E1's includes its activation
    # prologue; "E1 kernel" is the contraction, on E1's route for M, and
    # the split sum alone).
    print("| M | K1 ms (events / device) | E1 ms (events / device) | E1 kernel device ms | ratio (device) |")
    print("|---|---|---|---|---|")
    for m in M_SWEEP:
        x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
        turn = iter(range(10**9))
        k1 = lambda: quant_matmul(x, *weights[next(turn) % copies], None)  # noqa: E731
        e1 = lambda: w4a8_matmul(x, *weights[next(turn) % copies])  # noqa: E731
        e1_dev = device_ms(e1, 20)
        row = {"m": m, "k1_ms": cuda_ms(k1, 50), "e1_ms": cuda_ms(e1, 50),
               "k1_device_ms": device_ms(k1, 20)["all"], "e1_device_ms": e1_dev["all"],
               "e1_kernel_device_ms": None if e1_dev["all"] is None else sum(
                   ms for name, ms in e1_dev.items() if "e1_" in name or "sum_splits" in name)}
        result["rows"].append(row)
        measured = row["k1_device_ms"] is not None and row["e1_device_ms"] is not None
        ratio = f"{row['e1_device_ms'] / row['k1_device_ms']:.2f}x" if measured else "not measured"
        print(f"| {m} | {row['k1_ms']:.4f} / {ms_text(row['k1_device_ms'])} | {row['e1_ms']:.4f} / "
              f"{ms_text(row['e1_device_ms'])} | {ms_text(row['e1_kernel_device_ms'])} | {ratio} |")
    return result


if __name__ == "__main__":
    main()
