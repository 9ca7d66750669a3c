"""Profiling hooks (counterpart of ``phi_3_vision_mlx_tpu/utils/profiler.py``).

:func:`trace` captures a ``torch.profiler`` trace of any flow (host and,
where a card is present, CUDA activity) and writes it as a Chrome trace
under ``log_dir`` (open it in Perfetto or ``chrome://tracing``);
:func:`annotate` names a range in that trace; :class:`StepTimer` records
decode-chunk latencies (``PHI3V_TPU_STEP_LOG`` in ``engine/engine.py:
generate_text``).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the body and write ``trace_<pid>_<ms>.json`` (a Chrome
    trace) under ``log_dir`` (default: ``phi3v_trace`` in the temporary
    directory), also when the body raises.  Yields ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "phi3v_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield log_dir
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns() // 10**6}.json"))


def annotate(name: str):
    """A named range that shows up in profiler traces."""
    from torch.profiler import record_function

    return record_function(name)


class StepTimer:
    """Per-step latency recorder for decode loops."""

    def __init__(self):
        self.samples: List[float] = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "n": n,
            "mean_ms": 1e3 * sum(s) / n,
            "p50_ms": 1e3 * s[n // 2],
            "p95_ms": 1e3 * s[min(n - 1, int(n * 0.95))],
            "max_ms": 1e3 * s[-1],
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
