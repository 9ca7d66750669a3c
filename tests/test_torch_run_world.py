"""``parallel/mesh.py:run_world``, the spawned gloo worlds of the port's
multi-rank tests and of ``dryrun_multichip(device="cpu")``: results by
rank, a rank that never ends after writing its result, a failed rank and a
hung one.  Worlds of two ranks; the rank functions are in
``torch_world.py``."""

import time

import pytest

torch = pytest.importorskip("torch")

from phi_3_vision_mlx_tpu_torch.parallel import mesh as PM  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401
from torch_world import fail_on, hang_before_result, linger_after_result  # noqa: E402

TIMEOUT = 120.0  # seconds for a world that should end long before
HANG_TIMEOUT = 20.0  # seconds before a world with a rank that never returns fails


def test_results_come_back_though_a_rank_never_ends():
    """Once every rank has written its result the world is done: rank 1,
    which never ends, is killed EXIT_GRACE seconds later, not waited for
    until the timeout."""
    t0 = time.monotonic()
    assert PM.run_world(linger_after_result, 2, 1, timeout=TIMEOUT) == [0, 1]
    assert time.monotonic() - t0 < TIMEOUT / 2


def test_a_failed_rank_fails_the_world_with_its_traceback():
    """Rank 0 raises: the world fails with rank 0's traceback (rank 1's
    barrier may fail too, as its peer is gone)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[0(, 1)?\] of a world of 2 failed; rank 0:(.|\n)*rank 0 fails on purpose"):
        PM.run_world(fail_on, 2, 0, timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2


def test_a_hung_rank_times_out_with_its_stack():
    """Rank 0 sleeps and writes no result: after the timeout the world
    fails, and the error holds the hung rank's Python stack."""
    with pytest.raises(TimeoutError, match=r"ranks \[0\] still ran(.|\n)*hang_before_result"):
        PM.run_world(hang_before_result, 2, 0, timeout=HANG_TIMEOUT)
