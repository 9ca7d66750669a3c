"""The benchmark of ``phi_3_vision_mlx_tpu_torch`` on NVIDIA H100 cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One run: set up the cell's served system
(``h100_bench/harness.py``), load it for ``--seconds``, check its answers
against the plain reference, and print the result as the last line of
standard output, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``; with ``--trace 1`` the per-layer metrics and a
``breakdown``), with each number the check compared beside its limit as
the last lines of standard error and last in the result line.  A machine
without the cards the cell asks for, or a run that loaded JAX or the JAX
package, exits with a code other than 0 and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"  # fixed, inside the checkout: only a cell's first run builds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    sys.path.insert(0, str(ROOT))

    import torch

    from h100_bench import harness, spec

    parts = spec.load(a.workload)
    chips = int(parts["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = harness.run(a.workload, a.seed, a.seconds, bool(a.trace), T_PROCESS, "cuda", parts, chips)
    bad = harness.forbidden_modules()
    if bad:
        print(f"no result: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    out["metrics"] = {k: m for k, m in out["metrics"].items() if math.isfinite(m["value"])}
    for c in out["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
