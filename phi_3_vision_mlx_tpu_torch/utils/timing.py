"""Wall-clock timing (counterpart of ``phi_3_vision_mlx_tpu/utils/timing.py``;
the reference's ``Tic``)."""

from __future__ import annotations

import time


class Tic:
    """Seconds since the last call (or since construction)."""

    def __init__(self):
        self.last_time = time.perf_counter()

    def __call__(self) -> float:
        now = time.perf_counter()
        elapsed = now - self.last_time
        self.last_time = now
        return elapsed
