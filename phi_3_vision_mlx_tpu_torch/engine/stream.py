"""Streaming and stop criteria (``phi_3_vision_mlx_tpu/engine/stream.py``,
numpy only, shared with the JAX package)."""

from phi_3_vision_mlx_tpu.engine.stream import (  # noqa: F401
    LogitStopper,
    StopSequences,
    Streamer,
    TokenStopper,
    validate_stops,
)
