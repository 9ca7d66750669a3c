"""Time kernel K4 (decode attention over the int4 cache) of several source
trees of this repository in turns, on one card, each tree in its own
process built from its own ``csrc/``.

    python -m phi_3_vision_mlx_tpu_torch.experiments.k4_ab TREE [TREE ...]

Give the trees in the order to run them (parent, change, change, parent) so
that drift on the card shows.  Each run times K4 at chip_smoke.py's shape
(Lq = 1, 4224 keys at offset 4223, 32 heads of 96, 8 stacked layers rotated
past the L2): five rounds of CUDA-event time over 200 calls and the
profiler's device time over 50.  The timing code is this module's own, so a
tree from before this module existed times the same way.  Prints one JSON
line per tree.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_RUN = r'''
import json, sys, torch
sys.path.insert(0, ".")
from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig
from phi_3_vision_mlx_tpu_torch.engine.state import quantize_chunk
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
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA) / 1e3 / iters

g = torch.Generator(device="cuda").manual_seed(2)
nl, b, h, d, lmax = 8, 1, 32, 96, 4224
k = torch.randn((nl, b, h, lmax, d), generator=g, device="cuda") + 0.5
v = torch.randn((nl, b, h, lmax, d), generator=g, device="cuda") - 0.3
payload, scales = quantize_chunk(k.to(torch.bfloat16), v.to(torch.bfloat16), KVQuantConfig(32, 4))
valid = torch.rand((b, lmax), generator=g, device="cuda") > 0.05
valid[:, :10] = False
q = torch.randn((b, 1, h, d), generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
turn = iter(range(10**9))
call = lambda: KV.quantized_kv_attention(q, payload, scales, valid, lmax - 1, next(turn) % nl, d**-0.5)
events = [cuda_ms(call, 200, warmup=5) for _ in range(5)]
print(json.dumps({"events_ms": events, "device_ms": device_ms(call, 50),
                  "card": torch.cuda.get_device_name(0)}))
'''


def main(argv=None) -> list:
    trees = list(argv if argv is not None else sys.argv[1:])
    if not trees:
        raise SystemExit(__doc__)
    results = []
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", _RUN], cwd=tree, capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"{tree}: exit {out.returncode}\n{out.stderr[-3000:]}")
        res = {"tree": os.path.abspath(tree), **json.loads(out.stdout.strip().splitlines()[-1])}
        results.append(res)
        print(json.dumps(res), flush=True)
    return results


if __name__ == "__main__":
    main()
