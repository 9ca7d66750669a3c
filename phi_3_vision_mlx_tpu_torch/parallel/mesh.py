"""Process groups and device meshes (counterpart of
``phi_3_vision_mlx_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, one rank a card, with the JAX package's axis
names:

* ``dcn``   -- optional leading axis, data parallelism across hosts (only
  present when ``dcn > 1``);
* ``data``  -- batch (data parallelism; the trainer averages gradients
  over it), or the sequence of a ring-attention prefill;
* ``model`` -- tensor parallelism (heads and the MLP's hidden units,
  Megatron-style; ``parallel/sharding.py``, ``parallel/tensor.py``).

Ranks fill the mesh in the order of the JAX package's devices:
``reshape(dcn, data, model)`` of ranks ``0 .. n-1``, so that a host's
ranks (consecutive, as a launcher numbers them) share a ``dcn`` slice and
the chatty ``model`` collectives stay inside it.

The JAX package gets its devices from the runtime; here the caller starts
the process group (:func:`distributed_init`) and names the device: NCCL on
``"cuda"``, gloo on ``"cpu"``.  :func:`run_world` starts a world of spawned
processes on one machine, which the CPU tests and the multi-rank dry run
(``parallel/dryrun.py``) use.
"""

from __future__ import annotations

import datetime
import faulthandler
import multiprocessing
import multiprocessing.connection
import os
import pickle
import signal
import sys
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist


def _url(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
    timeout: Optional[float] = None,
) -> None:
    """Start this process's default process group: NCCL for ``device``
    ``"cuda"`` (a rank binds card ``process_id % device_count``), gloo for
    ``"cpu"``.  The backend follows the device named, never what the
    machine has: on ``"cuda"`` without NCCL or a card this raises.

    With no arguments it starts a world of one in this process, over an
    in-memory store (no TCP port).  Otherwise all three are given:
    ``coordinator_address`` is ``host:port`` (the JAX form) or an
    ``init_method`` URL (``tcp://...``, ``file://...``).  ``timeout``
    (seconds) bounds the rendezvous and every collective."""
    given = [a is not None for a in (coordinator_address, num_processes, process_id)]
    if any(given) and not all(given):
        raise ValueError("give coordinator_address, num_processes and process_id together, or none")
    if device == "cuda":
        if not dist.is_nccl_available() or not torch.cuda.is_available():
            raise RuntimeError("distributed_init(device='cuda') needs NCCL and a CUDA device; "
                               "pass device='cpu' for a gloo world")
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device is 'cuda' or 'cpu', not {device!r}")
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    rank = process_id or 0
    if device == "cuda":
        card = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kw["device_id"] = card
    if not any(given):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=_url(coordinator_address), rank=rank,
                                world_size=num_processes, **kw)


def make_mesh(data: int = 1, model: int = 1, dcn: int = 1, ranks=None):
    """A (``dcn`` x) ``data`` x ``model`` mesh over the first ranks of
    ``ranks`` (default: the whole world), on the device of the default
    group's backend.  Every rank of the world calls it with the same
    arguments (it makes a group per axis); a rank outside the mesh gets
    the mesh with no coordinate."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call distributed_init first")
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    need = dcn * data * model
    if len(ranks) < need:
        raise ValueError(f"need {need} devices, have {len(ranks)}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if dcn > 1:
        return DeviceMesh(device_type, torch.tensor(ranks[:need]).reshape(dcn, data, model),
                          mesh_dim_names=("dcn", "data", "model"))
    return DeviceMesh(device_type, torch.tensor(ranks[:need]).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def batch_axes(mesh):
    """The mesh axes a batch dimension shards over (dcn+data when present)."""
    return ("dcn", "data") if "dcn" in mesh.mesh_dim_names else ("data",)


def single_device_mesh():
    return make_mesh(1, 1)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


EXIT_GRACE = 10.0  # seconds a rank that has written its result has to exit before it is killed
POLL = 0.5  # seconds between the caller's looks for the ranks' results


def _write_file(path: str, data: bytes) -> None:
    """``data`` to ``path`` whole or not at all (written aside, then renamed)."""
    with open(f"{path}.part", "wb") as f:
        f.write(data)
    os.replace(f"{path}.part", path)


def _rank_main(fn, rank: int, n: int, device: str, tmp: str, args, timeout: float) -> None:
    """A spawned rank: its result or its traceback goes to a file, then the
    process ends at once (``os._exit``).  The interpreter's own teardown is
    skipped, and the caller does not wait for the exit either once every
    result is written (:func:`run_world`): in pytest-xdist workers a rank
    that had written its result now and then never ended, ``os._exit``
    included, until it was killed."""
    torch.set_num_threads(1)
    stack = open(f"{tmp}/stack_{rank}.txt", "w")
    faulthandler.register(signal.SIGUSR1, file=stack)  # the caller asks a rank that never ends where it is
    code = 1
    try:
        distributed_init(f"file://{tmp}/store", n, rank, device=device, timeout=timeout)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        _write_file(f"{tmp}/result_{rank}.pkl", pickle.dumps(out))
        code = 0
    except BaseException:
        _write_file(f"{tmp}/error_{rank}.txt", traceback.format_exc().encode())
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def run_world(fn, n: int, *args, device: str = "cpu", timeout: float = 300.0) -> list:
    """``fn(*args)`` on every rank of a new world of ``n`` spawned processes
    on this machine (gloo for ``"cpu"``, NCCL for ``"cuda"``, one card a
    rank), each with one torch thread and its process group started
    (:func:`distributed_init` over a file store).  ``fn`` is importable by
    name and its arguments and result pickle.  Returns the results by rank.

    A rank that fails, or a world that outlives ``timeout`` seconds, fails
    the call (the rendezvous and each collective are bounded by it too).
    Once every rank has written its result the call has what it needs: a
    rank that has not exited ``EXIT_GRACE`` seconds later is killed, not
    waited for.  Every process is stopped before this returns."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(fn, rank, n, device, tmp, args, timeout), daemon=True)
                 for rank in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout

        def returned(rank):
            return os.path.exists(f"{tmp}/result_{rank}.pkl")

        try:
            running = {p.sentinel: p for p in procs}
            while running and time.monotonic() < deadline:
                ready = multiprocessing.connection.wait(list(running), min(POLL, deadline - time.monotonic()))
                if any(running.pop(s).exitcode for s in ready):
                    break  # a failed rank: the others would wait for it
                if all(map(returned, range(n))):
                    break
        finally:
            grace = time.monotonic() + EXIT_GRACE
            for rank, p in enumerate(procs):
                if p.is_alive() and returned(rank):
                    p.join(max(0.0, grace - time.monotonic()))
            hung = [rank for rank, p in enumerate(procs) if p.is_alive() and not returned(rank)]
            for rank in hung:
                os.kill(procs[rank].pid, signal.SIGUSR1)
            time.sleep(1.0 if hung else 0.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()

        def read(name):
            with open(f"{tmp}/{name}", "rb") as f:
                return f.read()

        errors = {rank: read(f"error_{rank}.txt").decode() for rank in range(n)
                  if os.path.exists(f"{tmp}/error_{rank}.txt")}
        if errors:
            first = min(errors)
            raise RuntimeError(f"ranks {sorted(errors)} of a world of {n} failed; rank {first}:\n{errors[first]}")
        codes = [p.exitcode for p in procs]
        if any(code for rank, code in enumerate(codes) if rank not in hung and not returned(rank)):
            raise RuntimeError(f"a world of {n} failed: exit codes {codes}")
        if hung:
            done = [rank for rank in range(n) if returned(rank)]
            raise TimeoutError(f"a world of {n}: ranks {hung} still ran after {timeout} s (ranks {done} had "
                               f"returned); rank {hung[0]} was in:\n{read(f'stack_{hung[0]}.txt').decode()}")
        return [pickle.loads(read(f"result_{rank}.pkl")) for rank in range(n)]
