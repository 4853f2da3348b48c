"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface,
``nyxus_tpu_torch/_build/libnyxcuda.so``, and loaded with ``ctypes``.  A stamp
holding a hash of the sources and the flags sits next to the library; a
change to either rebuilds it.  A failed build or load raises: there is no
fallback to the plain PyTorch versions for tensors on the card.

Every C entry point launches on the stream it is given, allocates nothing,
does not synchronise and returns ``cudaGetLastError()``; ``check`` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
LIB_PATH = os.path.join(_DIR, "_build", "libnyxcuda.so")
SOURCES = ("batched_hist.cu", "glcm_cooc.cu", "glrlm_runs.cu", "stencil8.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (pointers and the stream as c_void_p, ints as c_int)
_SIGNATURES = {
    "nyx_batched_hist": [_P, _P, _P, _I, _I, _I, _I, _P],
    "nyx_glcm_cooc": [_P, _P, _P, _I, _I, _I, _I, _I] + [_I] * 8 + [_I, _I, _P],
    "nyx_glrlm_runs": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "nyx_stencil8": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""        # nvcc's output of the last build (ptxas resource usage)
build_seconds = None  # wall time of the last build in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _stamp() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def _build(stamp: str):
    global build_log, build_seconds
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = "%s.%d.tmp" % (LIB_PATH, os.getpid())
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", SRC_DIR, "-o", tmp,
           *(os.path.join(SRC_DIR, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError("nvcc build of %s failed (exit %d):\n%s"
                           % (LIB_PATH, proc.returncode, build_log))
    os.replace(tmp, LIB_PATH)
    with open(LIB_PATH + ".stamp", "w") as f:
        f.write(stamp)


def lib():
    """The loaded kernel library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            stamp = _stamp()
            try:
                with open(LIB_PATH + ".stamp") as f:
                    fresh = f.read() == stamp and os.path.exists(LIB_PATH)
            except OSError:
                fresh = False
            if not fresh:
                _build(stamp)
            loaded = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = loaded
        return _lib


def check(name: str, code: int):
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d"
                           % (name, code))


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on the tensor's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
