"""Build and load the port's CUDA kernels (``phi_3_vision_mlx_tpu_torch/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build
goes to ``csrc/build/`` (listed in ``.gitignore``) under a name keyed by a
hash of the sources and flags, so an edited source never reuses a stale
library.  Nothing is built or imported while a module is imported: the CPU
tests import every module on hosts without ``nvcc`` or a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argtypes.  Every pointer and the stream are c_void_p, or
# ctypes would pass them as 32-bit ints and cut them.
SIGNATURES = {
    "k1_w4a16_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "k8_w8a16_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "k9_w4a16_packed_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "e1_w4a8_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "k2_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _I, _F, _P],
    "k3_dense_kv_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _L, _L, _L, _L, _L, _L, _I, _P, _I, _F, _I, _I, _P],
    "k4_quantized_kv_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _L, _L, _L, _L, _L, _L, _I, _P, _I, _F, _I, _I, _P],
    "e23_quantized_kv_attention_variant": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                           _L, _L, _L, _L, _L, _L, _I, _P, _I, _F, _I, _I, _I, _P],
    "k5_quantized_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _L, _L, _L, _L, _L, _L, _I, _I, _F, _P],
    "k6_paged_kv_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _L, _L, _L, _L, _L, _L, _I, _I, _F, _I, _I, _P],
    "k7_paged_quantized_kv_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                        _I, _I, _L, _L, _L, _L, _L, _L, _I, _I, _F, _I, _I, _P],
}
# Each kernel's fp32 entry (an fp32 model's) takes its bf16 entry's arguments.
for _name in ("k1_w4a16_matmul", "k8_w8a16_matmul", "k9_w4a16_packed_matmul", "k2_flash_attention",
              "k3_dense_kv_attention", "k4_quantized_kv_attention", "k5_quantized_flash_attention",
              "k6_paged_kv_attention", "k7_paged_quantized_kv_attention"):
    SIGNATURES[_name + "_f32"] = SIGNATURES[_name]
del _name
# The continuous server prefills on its admission thread while its pump
# thread decodes: the first build and every launch count are shared.
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_CAPTURE = threading.local()  # .tally: the launches of a graph this thread captures


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library():
    """Compile (once per source hash) and load the kernel library.

    Returns ``(lib, build_seconds)``; ``build_seconds`` is 0.0 when a
    library built from the same sources was already on disk.  Safe to call
    from several threads."""
    with _BUILD_LOCK:
        return _library()


@functools.lru_cache(maxsize=1)
def _library():
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    target = BUILD_DIR / f"libphi3_kernels_{digest.hexdigest()[:16]}.so"
    seconds = 0.0
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(sources, objs)
        ]
        errors = []
        for src, proc in zip(sources, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        for obj in objs:
            obj.unlink()
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, seconds


class Launches:
    """A launch count kept beside a wrapper's own: the share of one of its
    kernels (``<wrapper>.fp32``, its fp32 entry's), counted like a wrapper."""

    def __init__(self):
        self.launches = 0


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (from any thread).  While this thread
    captures a CUDA graph (:func:`recording`) nothing runs: the launch is
    recorded into the graph's tally instead, and each replay adds it."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with _COUNT_LOCK:
        wrapper.launches += 1


@contextlib.contextmanager
def recording():
    """Within: this thread's :func:`count_launch` calls go to the yielded
    ``{wrapper: launches}`` tally of a graph being captured (a capture in
    ``thread_local`` mode is this thread's alone)."""
    outer = getattr(_CAPTURE, "tally", None)
    _CAPTURE.tally = {}
    try:
        yield _CAPTURE.tally
    finally:
        _CAPTURE.tally = outer


def add_launches(tally: dict, times: int = 1) -> None:
    """Count ``times`` replays of a graph whose capture recorded ``tally``."""
    with _COUNT_LOCK:
        for wrapper, n in tally.items():
            wrapper.launches += n * times


def entry_of(entry: str, dtype) -> str:
    """The C entry of a kernel for activations of ``dtype``: its bf16 entry,
    or its ``_f32`` one for an fp32 model."""
    import torch

    return entry + "_f32" if dtype == torch.float32 else entry


def count(wrapper, dtype) -> None:
    """Count a launch on ``wrapper``, and on ``wrapper.fp32`` for fp32."""
    import torch

    count_launch(wrapper)
    if dtype == torch.float32:
        count_launch(wrapper.fp32)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
