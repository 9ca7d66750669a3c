"""The output check separates the program from its control and from a
broken served path.

The control (the reference put in the program's place one precision below
the configuration's: float8 e4m3 activations, ``check.py``) is run on the
card at each cell's size by ``h100_bench/control.py``, which sets the
cells' limits (PERF.md).  Here it runs at tiny widths on the CPU, where
the program computes in float32: its served tokens are the reference's
argmax (gap 0) and the control's are not.  The tiny limit sits between the
two readings (0 and at least 0.009 on the seeds tried).  The tiny vision
model's few sampled tokens repeat one token under either precision, so
its control is read on the card alone.

The fault test skips the look for a card and drives the rest of a run
with the served path broken underneath: a token altered where it is
produced (the step's argmax replaced), a step that leaves the cache as it
was (the paged pool never takes a step's keys and values), and half of the
batch left out (the step's later rows take the mean of the earlier rows'
logits).  Each must read ``correct`` false.  (A single card has no
exchange between chips.)"""

import time

import pytest

from h100_bench import harness
from h100_bench.tests import tiny

TINY_LIMIT = 0.003


def _run(cell, seed, control=False, seconds=3.0):
    parts = tiny.parts(cell)
    parts["limits"]["logit_gap"]["limit"] = TINY_LIMIT
    return harness.run(cell, seed, seconds, False, time.perf_counter(), "cpu", parts, control=control)


@pytest.mark.parametrize("seed", [101, 2**31 + 9])
def test_control_fails_where_the_program_passes(seed):
    # The same run judges the program and, in its place, the control.
    program = _run("mini-w4.chat", seed)
    assert program["correct"] is True
    out = _run("mini-w4.chat", seed, control=True)
    assert out["correct"] is False
    assert out["served"] < TINY_LIMIT < out["checks"]["logit_gap"]["value"]


def _token_altered(monkeypatch):
    import phi_3_vision_mlx_tpu_torch.engine.graphs as graphs

    write = graphs.StepRing.write

    def altered(self, logits, eos_id, nxt=None):
        if nxt is None:
            nxt = (logits.argmax(-1) + 1) % logits.shape[-1]
        return write(self, logits, eos_id, nxt)

    monkeypatch.setattr(graphs.StepRing, "write", altered)


def _half_batch_left_out(monkeypatch):
    import torch

    import phi_3_vision_mlx_tpu_torch.engine.graphs as graphs

    write = graphs.StepRing.write

    def half(self, logits, eos_id, nxt=None):
        b = logits.shape[0] // 2
        rest = logits[:b].mean(0, keepdim=True).expand(logits.shape[0] - b, -1)
        return write(self, torch.cat([logits[:b], rest]), eos_id, nxt)

    monkeypatch.setattr(graphs.StepRing, "write", half)


def _cache_unchanged(monkeypatch):
    import phi_3_vision_mlx_tpu_torch.engine.paging as paging

    monkeypatch.setattr(paging, "write_fresh", lambda *a, **k: None)


@pytest.mark.parametrize("fault", [_token_altered, _cache_unchanged, _half_batch_left_out])
def test_a_broken_served_path_reads_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    # The sample holds a request of every slot, so a fault in one slot's rows
    # shows whichever requests that slot served.
    out = _run("mini-w4.chat", 2**31 + 1)
    assert out["correct"] is False
    assert out["checks"]["logit_gap"]["value"] > TINY_LIMIT
