"""Finds a cell's parts by name: ``BENCHMARK.json`` names the cell's
configuration, traffic mix and metrics; each is a file of its own under
``h100_bench/`` (``configs/``, ``traffic/<name>.json``,
``metrics/<name>.py``, ``limits/<cell>.json``), so a later change adds a
cell, a mix or a metric by adding files."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration dict, traffic parameters, limits,
    the metrics (end-to-end and per-layer) that apply to it, and the
    checkout's root."""
    root = Path(root)
    here = root / "h100_bench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if work is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    return {
        "cell": work,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((here / "traffic" / f"{work['traffic']}.json").read_text()),
        "limits": json.loads((here / "limits" / f"{cell}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, cell)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, cell)],
        "root": root,
    }


def reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``h100_bench/metrics/<name>.py``."""
    path = Path(root) / "h100_bench" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location("h100_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
