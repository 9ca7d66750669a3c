"""Arithmetic the metric readers (``metrics/<name>.py``) share.  Each
reader returns None where its run has nothing to read, and the harness
then leaves the metric out."""

from __future__ import annotations

import math

from . import flops
from .trace import device_ms, short_name
from .traffic import p90

K1_KERNELS = ("k1_gemv_kernel", "wq_mma_kernel", "sum_splits_kernel")


def output_tokens(run) -> int:
    """Tokens the engine added to its requests between the window's edges."""
    return sum(n - run.at_open.get(rid, (0,))[0] for rid, (n, _, _) in run.at_close.items())


def latency_p90_ms(run) -> float:
    lat = [(x["done"] - x["sent"]) * 1e3 if x["error"] is None else math.inf for x in run.records]
    lat += [math.inf] * run.late
    return p90(lat) if lat else None


def _grids(run) -> dict:
    """Image tokens -> (rows, cols) of the traffic's image shapes."""
    shapes = (run.traffic.get("images") or {}).get("shapes", [])
    out = {}
    for h, w in shapes:
        rows, cols = flops.image_grid(h, w, run.cfg["num_crops"])
        out[flops.image_tokens(rows, cols)] = (rows, cols)
    return out


def window_flops(run, with_images: bool) -> float:
    """Model FLOPs of every token the window processed: each prompt
    admitted in it (and its image through the tower), each decode step of
    each request in it."""
    cfg, total = run.cfg, 0.0
    grids = _grids(run) if with_images else {}
    for rid, (n1, length, img_tokens) in run.at_close.items():
        n0 = run.at_open.get(rid, (0,))[0]
        if rid not in run.at_open:
            total += flops.prefill_flops(cfg, length)
            if img_tokens and with_images:
                rows, cols = grids[img_tokens]
                total += flops.clip_flops(cfg["vision_config"], cfg["hidden_size"],
                                          cfg["img_processor"]["image_dim_out"], rows, cols)
        for j in range(max(n0, 1), n1):
            total += flops.decode_token_flops(cfg, length + j)
    return total


def mfu_pct(run, with_images: bool):
    if not run.at_close:
        return None
    return 100.0 * window_flops(run, with_images) / (run.seconds * flops.BF16_FLOPS)


def idle_pct(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def decode_steps(run) -> int:
    return run.trace.launches_in("step_pipelined", "cudaGraphLaunch") if run.trace else 0


def decode_step_ms(run):
    steps = decode_steps(run)
    if not steps:
        return None
    ops = [op for ops in run.trace.ops_in("step_pipelined").values() for op in ops]
    return device_ms(ops) / steps


def k1_roofline_pct(run):
    steps = decode_steps(run)
    if not steps:
        return None
    ops = [op for ops in run.trace.ops_in("step_pipelined").values() for op in ops
           if short_name(op[0]) in K1_KERNELS]
    if not ops:
        return None
    rows = run.traffic["server"]["slots"]
    per_step = flops.bound_s(flops.decode_step_k1_bytes(run.cfg, rows),
                             2.0 * rows * (flops.layer_params(run.cfg)
                                           + math.prod(flops.head_linear(run.cfg))))
    return 100.0 * steps * per_step * 1e3 / device_ms(ops)


def range_ms(run, name: str):
    """Mean device ms of the ranges named ``name`` that launched work."""
    if run.trace is None:
        return None
    per = [device_ms(ops) for ops in run.trace.ops_in(name).values() if ops]
    return sum(per) / len(per) if per else None


def mean_occupancy(run):
    return sum(run.occupancy) / len(run.occupancy) if run.occupancy else None
