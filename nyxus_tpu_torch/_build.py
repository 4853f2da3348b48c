"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process a source, all started together, then linked into one
shared library with a plain C interface,
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
SOURCES = ("batched_hist.cu", "glcm_cooc.cu", "glrlm_runs.cu",
           "neigh_matrix.cu", "zone_dag.cu", "zone_cc4.cu", "zone_stats.cu",
           "erosion.cu", "binary_quads.cu", "power_sums.cu", "gabor.cu",
           "zernike.cu", "glcm3d_cooc.cu", "glrlm3d_runs.cu", "cc3d.cu",
           "stencil3d.cu", "ih_stats.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# entry point -> argtypes (pointers, host int tables and the stream as
# c_void_p, ints as c_int, doubles as c_double)
_SIGNATURES = {
    "nyx_batched_hist": [_P, _P, _P] + [_I] * 11 + [_P],
    "nyx_glcm_cooc": [_P] * 4 + [_I] * 24 + [_P],
    "nyx_glrlm_runs": [_P] * 4 + [_I] * 14 + [_P],
    "nyx_neigh_matrix": [_P, _P, _I] + [_P] * 4 + [_I] * 11 + [_P],
    "nyx_zone_dag": [_P, _P, _P] + [_I] * 7 + [_P],
    "nyx_zone_dag_chain": [_P, _I, _I, _I, _P],
    "nyx_zone_cc4": [_P] * 6 + [_I] * 6 + [_P],
    "nyx_zone_stats": [_P] * 8 + [_I] * 7 + [_P],
    "nyx_erosion": [_P] * 5 + [_I] * 8 + [_P],
    "nyx_binary_quads": [_P] * 4 + [ctypes.c_longlong] + [_I] * 9 + [_P],
    "nyx_power_sums": [_P] * 4 + [_I, _P, _P] + [_I] * 9 + [_P],
    "nyx_gabor": [_P] * 4 + [_I, _I] + [_P] * 4 + [_I] * 5
    + [_D, _I, _I, _I, ctypes.c_longlong, _I, _P],
    "nyx_zernike": [_P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _D, _P, _P, _P]
    + [_I] * 6 + [_P],
    "nyx_glcm3d_cooc": [_P] * 4 + [_I] * 3 + [_P] * 3 + [_I] * 14
    + [ctypes.c_longlong, _I, _P],
    "nyx_glrlm3d_runs": [_P] * 4 + [_I] * 11 + [_P],
    "nyx_cc3d": [_P] * 4 + [_I] * 2 + [_P] * 2 + [_I] * 10 + [_P],
    "nyx_stencil3d": [_P] * 3 + [_I] * 3 + [_P] * 3 + [_I] * 8 + [_P],
    "nyx_ih_stats": [_P] * 7 + [_I] * 5 + [_D, _P],
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
    out_dir = os.path.dirname(LIB_PATH)
    os.makedirs(out_dir, exist_ok=True)
    tag = "%d.tmp" % os.getpid()
    t0 = time.perf_counter()
    procs, objs = [], []
    for src in SOURCES:
        obj = os.path.join(out_dir, "%s.%s.o" % (src, tag))
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", SRC_DIR, "-c", "-o", obj,
             os.path.join(SRC_DIR, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate(timeout=600)
        logs.append(out)
        if proc.returncode != 0:
            failed.append("%s (exit %d)" % (src, proc.returncode))
    tmp = "%s.%s" % (LIB_PATH, tag)
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True, timeout=600)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append("link (exit %d)" % link.returncode)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError("nvcc build of %s failed: %s\n%s"
                           % (LIB_PATH, ", ".join(failed), build_log))
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


def stream_of(t, kernel: str) -> int:
    """Handle of PyTorch's current stream on the tensor's device, which
    must be the current CUDA device: the C side sets its attributes and
    launches on the current device, so a tensor on another card raises
    here, naming ``kernel``.  Callers enter the device first
    (``torch.cuda.device``; the runners do, once a shard)."""
    cur = torch.cuda.current_device()
    if t.device.index != cur:
        raise RuntimeError(
            "CUDA kernel %s: its tensor is on %s but the current CUDA "
            "device is cuda:%d; enter torch.cuda.device(%s) first"
            % (kernel, t.device, cur, t.device))
    return torch.cuda.current_stream(t.device).cuda_stream
