"""The output check's readings on the card, for setting its limit: for
each seed, one run of the cell (``--seconds`` of window at the cell's own
load and sizes), the program's reading (the widest gap of a served token
below the reference's best, under ``served``) and the control's on the
same sample (the reference one precision below the configuration's,
``check.py``), which stands in the check in the program's place:
``correct`` is the harness's verdict on the control.  One
JSON line a seed; all seeds in one process, each with its own set-up.

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 15

The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench import harness, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    parts = spec.load(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run(a.workload, seed, a.seconds, False, t0, "cuda", parts, control=True)
        print(json.dumps({"seed": seed, "correct": out["correct"], "served": out["served"],
                          "checks": out["checks"], "metrics": out["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
