"""The port's random numbers for sampling: counter-based noise on the device
(the counterpart of the JAX package's ``jax.random.PRNGKey``, ``fold_in``
and ``split`` on its sampling paths).

A decode step that samples runs as a replay of a CUDA graph
(``engine/graphs.py``), so its noise must come from device tensors that the
step advances in place, with no host value and no host sync, and must be
the same eagerly and in a replay.  :class:`NoiseGen` keeps one stream per
row: a seed and a step counter, both ``(R,)`` int64 on the device.  Every
draw hashes (seed, counter, stream, element index) with integer tensor ops
into 24-bit uniforms, so the CPU and the card draw the same uniforms from
the same seed, and a replay draws what the eager step drew.  ``stream``
names the purpose of a draw within one step (:data:`SAMPLE`,
:data:`ACCEPT`, ...), as the JAX engines split their key.  The step that
draws calls :meth:`NoiseGen.advance` once at its end.

``jax.random`` gives other numbers from the same seed, so the port does not
reproduce the JAX package's sampled streams: its sampling functions take
their noise as arguments (``engine/engine.py``, ``engine/speculative.py``),
and the tests hand them the JAX package's own noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
# Odd multipliers below 2**31: a 32-bit value times one stays below 2**63,
# so the int64 products never overflow (the shifts are lowbias32's).
_MUL = (0x7FEB352D, 0x046CA68B)
# Streams of one step's draws.
SAMPLE, ACCEPT, RESAMPLE, BONUS, VANILLA = (0x1B873593, 0x2C1B3C6D, 0x297A2D39, 0x3B9AC9FF,
                                            0x68E31DA4)


def hash32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit mix of int64 values in [0, 2**32)."""
    for mul in _MUL:
        x = (x ^ (x >> 16)) * mul & MASK
    return x ^ (x >> 15)


def to_device(array, device) -> torch.Tensor:
    """A host array on ``device``; on CUDA through pinned memory and an
    asynchronous copy, so the host does not wait for queued work."""
    t = torch.as_tensor(np.asarray(array))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class NoiseGen:
    """Seeded noise for ``rows`` rows: ``seeds`` and ``counters`` (R,) int64
    on the device.  Row ``r``'s draws depend on its seed and counter only,
    never on the other rows (a slot's request samples the same stream in
    any slot)."""

    def __init__(self, rows: int, device):
        self.seeds = torch.zeros((rows,), dtype=torch.long, device=device)
        self.counters = torch.zeros((rows,), dtype=torch.long, device=device)

    def reset(self, seeds) -> None:
        """Seed every row (a host sequence of ints) and zero the counters."""
        self.seeds.copy_(to_device(np.asarray(seeds, dtype=np.int64), self.seeds.device))
        self.counters.zero_()

    def reset_row(self, row: int, seed: int) -> None:
        """Seed one row and zero its counter (no host sync)."""
        self.seeds[row] = seed
        self.counters[row] = 0

    def advance(self) -> None:
        self.counters += 1

    def bits(self, stream: int, shape) -> torch.Tensor:
        """(R, *shape) int64 hash values in [0, 2**32)."""
        folded = (self.seeds ^ (self.seeds >> 32)) & MASK
        key = hash32(hash32(folded ^ stream) ^ (self.counters & MASK))[:, None]
        idx = torch.arange(math.prod(shape), dtype=torch.long, device=self.seeds.device)
        return hash32(hash32(idx[None] ^ key) ^ stream).reshape(-1, *shape)

    def uniform(self, stream: int, shape) -> torch.Tensor:
        """(R, *shape) float32 uniforms in [0, 1), multiples of 2**-24."""
        return (self.bits(stream, shape) >> 8).float() * 2.0**-24

    def gumbel(self, stream: int, shape) -> torch.Tensor:
        """(R, *shape) float32 standard Gumbel noise, ``-log(-log(u))`` of
        uniforms in (0, 1): ``argmax(logits + gumbel)`` draws from
        ``softmax(logits)`` (``jax.random.categorical`` is that argmax).
        The logs run in float64: float32 cannot hold ``u`` = 1 - 2**-25 (it
        would round to 1 and give +inf), and its logs near 1 lose the
        digits a draw needs (the CPU's then differ from run to run)."""
        u = ((self.bits(stream, shape) >> 8).double() + 0.5) * 2.0**-24
        return (-torch.log(-torch.log(u))).float()
