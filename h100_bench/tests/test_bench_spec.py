"""BENCHMARK.json against the contract, every cell's files found by name,
and a configuration, a traffic mix and a metric added as new files picked
up with no existing file edited."""

import json
import re
import shutil
from pathlib import Path

import pytest

from h100_bench import harness, spec
from h100_bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100_bench/") and (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_and_names_a_known_configuration(cell):
    parts = spec.load(cell)
    assert parts["cell"]["config"] in {c["name"] for c in BENCH["configs"]}
    assert parts["traffic"]["server"]["slots"] > 0 and parts["limits"]["logit_gap"]["limit"] > 0
    reported = {m["name"] for m in parts["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and parts["per_layer"]
    for m in parts["end_to_end"] + parts["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(spec.reader(m["name"]))


def test_a_new_configuration_mix_and_metric_are_files(tmp_path):
    """Add a cell by files alone in a copy of the checkout and run it."""
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    here = tmp_path / "h100_bench"
    (here / "configs" / "tiny-w4.json").write_text(json.dumps(tiny.TEXT))
    mix = json.loads((here / "traffic" / "chat.json").read_text())
    mix.update(clients=2, ramp_seconds=0.3, block=4,
               server={"slots": 2, "window": 256, "page_size": 64},
               prompt_tokens={"dist": "uniform", "min": 20, "max": 60},
               max_tokens={"dist": "uniform", "min": 4, "max": 8})
    (here / "traffic" / "tiny-chat.json").write_text(json.dumps(mix))
    (here / "limits" / "tiny-w4.tiny-chat.json").write_text(json.dumps({"logit_gap": {"limit": 0.1}}))
    (here / "metrics" / "requests_done.json.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    bench["configs"].append({"name": "tiny-w4", "source": "https://example.org/tiny",
                             "file": "h100_bench/configs/tiny-w4.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-w4.tiny-chat", "config": "tiny-w4",
                               "traffic": "tiny-chat", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "requests_done.json", "unit": "requests", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-w4.tiny-chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    parts = spec.load("tiny-w4.tiny-chat", root=tmp_path)
    out = harness.run("tiny-w4.tiny-chat", 5, 1.5, False, 0.0, "cpu", parts)
    assert out["correct"] and out["metrics"]["requests_done.json"]["value"] > 0
    assert set(out["metrics"]) == {"requests_done.json", "req_latency_p90_ms", "setup_s"}
