"""The result line: exactly the contract's keys (and ``checks`` last), with
and without the trace, from a whole run of each cell at tiny widths on the
CPU; and no result at all on a machine without the card."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from h100_bench import harness
from h100_bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["mini-w4.chat", "vision-w4.image-qa"])
def test_result_line_keys(cell, trace):
    parts = tiny.parts(cell)
    seconds = 5.0 if "vision" in cell else 3.0
    out = harness.run(cell, 2**31 + 3, seconds, trace, time.perf_counter(), "cpu", parts)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else [])
    assert list(out) == keys + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    names = {m["name"] for m in parts["per_layer" if trace else "end_to_end"]}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out, allow_nan=False)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "mini-w4.chat",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
