"""The port's entry points for the JAX package's three kernel experiments.

Each module keeps its JAX script's shapes and question and runs on the card
unless ``--device cpu`` is given (then at the size its arguments name, with
correctness checks only: a CPU run times nothing):

* ``python -m phi_3_vision_mlx_tpu_torch.experiments.w4a8_bench`` — E1
  (``experiments/w4a8_bench.py``): does quantizing activations to int8 help
  a 4-bit decode matmul?  Kernel E1 against K1 on the same bytes.
* ``python -m phi_3_vision_mlx_tpu_torch.experiments.qkv_probe [lmax]`` — E2
  (``experiments/qkv_probe.py``): K4 against its dequantization replaced by
  a plain convert, and by a convert with no softmax.
* ``QD_LMAX=32768 QD_MODES=fp32,mxu python -m
  phi_3_vision_mlx_tpu_torch.experiments.qdecode_sweep`` — E3
  (``experiments/qdecode_sweep.py``): K4's dequantization arithmetic swept,
  each mode's error taken against fp32.

Each prints its table to stdout and writes no file.
"""

from __future__ import annotations

import argparse

import torch


def device_from(parser: argparse.ArgumentParser, argv=None):
    """Parse ``argv`` with a ``--device`` option added; returns (args, device).
    Without a card, ``cuda`` raises instead of falling back to the CPU."""
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    return args, device


def card(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Stream time per call of ``fn`` between two CUDA events."""
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


def device_ms(fn, iters: int, tries: int = 3) -> dict:
    """Device time per call of ``fn`` by kernel name (the profiler's CUDA
    kernel events), with the total under ``"all"``.  The profiler now and
    then records no kernel of a window; such a window is profiled again, and
    after ``tries`` empty ones ``"all"`` is None (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {"all": 0.0}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms = e.device_time_total / 1e3 / iters
                out[e.name] = out.get(e.name, 0.0) + ms
                out["all"] += ms
        if out["all"] > 0:
            return out
    return {"all": None}


def ms_text(ms) -> str:
    """A time for a table: four decimals, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.4f}"


def layer_sum(attend, nl: int, q):
    """One decode step of ``nl`` layers: the sum of ``attend(layer)`` in f32
    (the JAX scripts' scan over the stacked cache)."""
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for layer in range(nl):
        out += attend(layer).float()
    return out
