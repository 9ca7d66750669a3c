"""ctypes binding of the native zero-copy safetensors reader (counterpart of
``phi_3_vision_mlx_tpu/core/native.py``).

The port keeps its own copy of the C++ source, ``csrc/st_mmap.cpp``, which
g++ builds at first use into ``csrc/build/libst_mmap.so``.
:func:`load_file_mmap` returns torch tensors over the file's private
(copy-on-write) mapping: nothing is copied until a page is touched, and the
copy to the card reads the page cache.  BF16 is read as ``uint16`` and
viewed as ``torch.bfloat16``, so ``ml_dtypes`` is not needed.  A tensor at
an offset its element size does not divide is copied out (the format does
not promise aligned offsets), as the pure-Python reader does.

``core/weights.py:load_safetensors_dir`` prefers this reader (``PHI3V_TPU_
NATIVE_IO``, default 1) where :func:`available` is true, and otherwise reads
with its pure-Python ``load_safetensors``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import warnings
from typing import Dict

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "st_mmap.cpp")
_SO = os.path.join(_CSRC, "build", "libst_mmap.so")
MAX_DIMS = 8  # st_mmap.cpp: ST_MAX_DIMS

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}

_lib = None
_lock = threading.Lock()


def _build() -> str:
    """The shared library, built from the source when it is missing or
    older.  Each builder writes its own file and renames it into place, so
    processes that build at once never load a half-written library."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    compiler = shutil.which("g++")
    if compiler is None:
        raise OSError("g++ not found: the native safetensors reader cannot be built")
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    res = subprocess.run([compiler, "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise OSError(f"g++ failed on {_SRC}: {res.stderr.strip()}")
    os.replace(tmp, _SO)
    return _SO


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.st_open.restype = ctypes.c_void_p
            lib.st_open.argtypes = [ctypes.c_char_p]
            lib.st_error.restype = ctypes.c_char_p
            lib.st_count.restype = ctypes.c_int64
            lib.st_count.argtypes = [ctypes.c_void_p]
            lib.st_name.restype = ctypes.c_char_p
            lib.st_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.st_dtype.restype = ctypes.c_char_p
            lib.st_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.st_ndim.restype = ctypes.c_int64
            lib.st_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.st_shape.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
            lib.st_data.restype = ctypes.c_void_p
            lib.st_data.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
            lib.st_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class _MappedFile:
    """One open file's mapping, unmapped when no tensor over it is left:
    every tensor's buffer holds a reference to it."""

    def __init__(self, path: str):
        self.lib = get_lib()
        self.handle = self.lib.st_open(os.fsencode(path))
        if not self.handle:
            raise OSError(f"st_mmap failed on {path}: {self.lib.st_error().decode()}")

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.st_close(self.handle)
            self.handle = None


def load_file_mmap(path: str) -> Dict[str, torch.Tensor]:
    """One ``.safetensors`` file -> ``{name: tensor over the mapping}``."""
    mf = _MappedFile(path)
    lib = mf.lib
    out: Dict[str, torch.Tensor] = {}
    shape_buf = (ctypes.c_int64 * MAX_DIMS)()
    nbytes = ctypes.c_int64()
    for i in range(lib.st_count(mf.handle)):
        name = lib.st_name(mf.handle, i).decode()
        dtype = _DTYPES[lib.st_dtype(mf.handle, i).decode()]
        lib.st_shape(mf.handle, i, shape_buf)
        shape = [shape_buf[d] for d in range(lib.st_ndim(mf.handle, i))]
        addr = lib.st_data(mf.handle, i, ctypes.byref(nbytes))
        if nbytes.value == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        buf = (ctypes.c_uint8 * nbytes.value).from_address(addr)
        buf.mapping = mf  # the tensor keeps its buffer, the buffer the mapping
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "not writable": the mapping is
            raw = torch.frombuffer(buf, dtype=torch.uint8)  # private, so writes stay in memory
        if addr % dtype.itemsize:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def available() -> bool:
    """Whether the reader builds and loads here (g++ is needed once)."""
    try:
        get_lib()
        return True
    except OSError:
        return False
