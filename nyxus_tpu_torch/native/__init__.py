"""Native (C++) host library of the port, bound with ctypes (reduced from
nyxus_tpu/native/__init__.py: the one-pass ROI discovery, the contour,
geometry and CSV writer entry points, the TIFF codec of ``io/tiff.py``
and the blosc / LZ4 chunk codec of ``io/zarr.py``).

``src/`` holds verbatim copies of the JAX package's ``discover.cpp``,
``contour.cpp``, ``geomfeats.cpp``, ``geomfeats_batch.cpp`` and
``csv_writer.cpp``, the port's own ``tiff_codec.cpp`` (TIFF LZW and
Predictor 2), and
``zarr_codec.cpp``, the JAX package's less zlib: a blosc container whose
blocks are coded with zlib is inflated by Python's ``zlib`` here
(``blosc_decompress``).  They link only against each other and the C++
standard library (no libtiff, no zlib).  They are
compiled with ``g++`` (or ``$CXX``), one process a source, at first use into
``nyxus_tpu_torch/_build/libnyxgeom.so``; a stamp holding a hash of the
sources, the compiler and the flags sits next to it, and a change to any of
them rebuilds it.

A failed build raises, and so does every later call: unlike the JAX
package's loader there is no fallback to the slow numpy host paths, so
``available()`` is True or raises the build error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
LIB_PATH = os.path.join(os.path.dirname(_DIR), "_build", "libnyxgeom.so")
SOURCES = ("discover.cpp", "contour.cpp", "geomfeats.cpp",
           "geomfeats_batch.cpp", "csv_writer.cpp", "tiff_codec.cpp",
           "zarr_codec.cpp")
# -march=native is safe: the library is built on first use on the machine
# that runs it and never committed.  -ffp-contract=off: FMA contraction
# would change the doubles and break parity with the JAX package's host
# results.
CFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC",
          "-std=c++17")

_lock = threading.Lock()
_lib = None
_build_err = None
build_seconds = None   # wall time of the last build in this process

_P = ctypes.c_void_p
_L = ctypes.c_long
_I = ctypes.c_int
_I64 = ctypes.c_int64
# entry point -> (restype, argtypes)
_SIGNATURES = {
    "nyx_discover": (_I, [_P, _P, _I, _L, _L]),
    "nyx_discover_fetch": (_I, [_P, _P, _I] + [_P] * 7),
    "nyx_contour": (_I, [_P, _P, _I, _I, _P, _I]),
    "nyx_caliper_feret": (None, [_P, _P, _P, _L, _P, _I]),
    "nyx_caliper_martin": (None, [_P, _P, _P, _L, _P, _I]),
    "nyx_caliper_nassenstein": (None, [_P, _P, _P, _L, _P, _I]),
    "nyx_chords": (None, [_P, _P, _P, _P, _P, _L, _P, _I]),
    "nyx_min_enclosing_circles": (None, [_P, _P, _P, _L, _P, _I]),
    "nyx_contour_sqdist_approx": (None, [_P, _P, _L, _P, _P, _L, _P, _P]),
    "nyx_contours_batch": (None, [_P, _P, _L, _L, _P, _L, _P, _P, _P, _I]),
    "nyx_convex_hull": (_I, [_P, _P, _I, _P]),
    "nyx_geom_width": (_I, []),
    "nyx_geom_batch": (None, [_P, _P, _P, _P, _P, _P, _P, _P, _L,
                              ctypes.c_uint32, ctypes.c_double, _P, _P, _I]),
    "nyx_neighbors_batch": (None, [_P, _P, _P, _P, _P, _P, ctypes.c_double,
                                   _L, _P, _I]),
    "nyxcsv_write": (_I, [ctypes.c_char_p, ctypes.c_char_p,
                          ctypes.POINTER(ctypes.c_char_p), _P,
                          ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
                          _I, _I, _I, _I]),
    "nyx_lzw_decode": (_I64, [_P, _I64, _P, _I64]),
    "nyx_lzw_encode": (_I64, [_P, _I64, _P, _I64]),
    "nyx_hdiff_decode": (_I, [_P, _I64, _I64, _I, _I, _I]),
    "nyx_hdiff_encode": (_I, [_P, _I64, _I64, _I, _I, _I]),
    "nyx_lz4_decompress": (_I, [_P, _I, _P, _I]),
    "nyx_lz4_compress": (_I, [_P, _I, _P, _I]),
    "nyx_blosc_decompress": (_I, [_P, _I, _P, _I]),
    "nyx_blosc_compress_lz4": (_I, [_P, _I, _I, _I, _P, _I]),
}


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _stamp() -> str:
    h = hashlib.sha256(" ".join((_cxx(),) + CFLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_SRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def _run(cmds):
    """Run the commands together; raise naming each one that failed."""
    try:
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in cmds]
    except OSError as e:
        raise RuntimeError("native build of %s failed: %s" % (LIB_PATH, e))
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            failed.append("%s (exit %d)\n%s" % (" ".join(cmd),
                                                proc.returncode, out))
    if failed:
        raise RuntimeError("native build of %s failed: %s"
                           % (LIB_PATH, "\n".join(failed)))


def _build(stamp: str):
    """One compiler process a source, all started together, then a link."""
    global build_seconds
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tag = "%d.tmp" % os.getpid()
    tmp = "%s.%s" % (LIB_PATH, tag)
    objs = [os.path.join(os.path.dirname(LIB_PATH), "%s.%s.o" % (s, tag))
            for s in SOURCES]
    t0 = time.perf_counter()
    try:
        _run([[_cxx(), *CFLAGS, "-c", "-o", obj, os.path.join(_SRC, s)]
              for s, obj in zip(SOURCES, objs)])
        _run([[_cxx(), "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, LIB_PATH)
    with open(LIB_PATH + ".stamp", "w") as f:
        f.write(stamp)


def _load():
    """The loaded library, built first if it is missing or stale; raises
    the build error (again on every later call) when it cannot be built."""
    global _lib, _build_err
    with _lock:
        if _lib is not None:
            return _lib
        if _build_err is not None:
            raise _build_err
        try:
            stamp = _stamp()
            try:
                with open(LIB_PATH + ".stamp") as f:
                    fresh = f.read() == stamp and os.path.exists(LIB_PATH)
            except OSError:
                fresh = False
            if not fresh:
                _build(stamp)
            lib = ctypes.CDLL(LIB_PATH)
        except Exception as e:
            _build_err = e
            raise
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded; raises if it cannot be."""
    return _load() is not None


def contour(mask, inten):
    """Merged multicontour of one ROI crop as [K, 3] (x, y, inten) int64 in
    +1-shifted local coordinates (nyxus_tpu/native/__init__.py contour)."""
    lib = _load()
    mask = np.ascontiguousarray(mask, np.uint8)
    inten = np.ascontiguousarray(inten, np.int64)
    h, w = mask.shape
    cap = int(mask.sum()) + 16
    out = np.empty((cap, 3), np.int64)
    k = lib.nyx_contour(mask.ctypes.data_as(ctypes.c_void_p),
                        inten.ctypes.data_as(ctypes.c_void_p), h, w,
                        out.ctypes.data_as(ctypes.c_void_p), cap)
    if k < 0:
        raise RuntimeError("contour buffer overflow")
    return out[:k].copy()


def contour_sqdist_approx(px, py, cx, cy, want_min=True, want_max=False):
    """Approximate min/max squared distance from points to an ORDERED contour
    (semantic port of the reference's sampling search, pixel.cpp:36-143).
    Returns (min_d2 | None, max_d2 | None) float64 arrays."""
    px = np.ascontiguousarray(px, np.float64)
    py = np.ascontiguousarray(py, np.float64)
    cx = np.ascontiguousarray(cx, np.float64)
    cy = np.ascontiguousarray(cy, np.float64)
    n = len(px)
    out_min = np.empty(n, np.float64) if want_min else None
    out_max = np.empty(n, np.float64) if want_max else None
    lib = _load()

    def run(lo, hi):
        lib.nyx_contour_sqdist_approx(
            px[lo:hi].ctypes.data_as(ctypes.c_void_p),
            py[lo:hi].ctypes.data_as(ctypes.c_void_p), hi - lo,
            cx.ctypes.data_as(ctypes.c_void_p),
            cy.ctypes.data_as(ctypes.c_void_p), len(cx),
            out_min[lo:hi].ctypes.data_as(ctypes.c_void_p)
            if want_min else None,
            out_max[lo:hi].ctypes.data_as(ctypes.c_void_p)
            if want_max else None)

    # the per-point search is independent and GIL-free: fan big point
    # sets over threads
    nthr = min(os.cpu_count() or 1, max(1, n // 65536))
    if nthr > 1:
        from concurrent.futures import ThreadPoolExecutor
        step = (n + nthr - 1) // nthr
        with ThreadPoolExecutor(nthr) as ex:
            list(ex.map(lambda lo: run(lo, min(n, lo + step)),
                        range(0, n, step)))
    else:
        run(0, n)
    return out_min, out_max


def convex_hull(xs, ys):
    """Monotone-chain hull, reference vertex order; [K, 2] float64 (x, y)."""
    lib = _load()
    xs = np.ascontiguousarray(xs, np.int64)
    ys = np.ascontiguousarray(ys, np.int64)
    out = np.empty((len(xs) + 4, 2), np.float64)
    k = lib.nyx_convex_hull(xs.ctypes.data_as(ctypes.c_void_p),
                            ys.ctypes.data_as(ctypes.c_void_p), len(xs),
                            out.ctypes.data_as(ctypes.c_void_p))
    return out[:k].copy()


def _concat_offsets(arrays, dtype):
    """Concatenate per-ROI 1-D arrays -> (flat, offsets[int64, N+1])."""
    offsets = np.zeros(len(arrays) + 1, np.int64)
    for i, a in enumerate(arrays):
        offsets[i + 1] = offsets[i] + len(a)
    if offsets[-1] == 0:
        return np.zeros(0, dtype), offsets
    flat = np.concatenate([np.ascontiguousarray(a, dtype) for a in arrays])
    return flat, offsets


def _n_threads():
    env = os.environ.get("NYXUS_NATIVE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


def caliper_batch(kind, hulls, fill):
    """Run a caliper family natively over all ROIs.

    kind: 'feret' (8 outputs) | 'martin' | 'nassenstein' (6 outputs);
    hulls: list of [K, 2] float arrays (global coords) or None.
    Returns [N, W] float64 initialized to ``fill``."""
    lib = _load()
    width = 8 if kind == "feret" else 6
    n = len(hulls)
    out = np.full((n, width), fill, np.float64)
    hx, off = _concat_offsets(
        [h[:, 0] if h is not None else np.zeros(0) for h in hulls], np.float64)
    hy, _ = _concat_offsets(
        [h[:, 1] if h is not None else np.zeros(0) for h in hulls], np.float64)
    fn = getattr(lib, "nyx_caliper_" + kind)
    fn(hx.ctypes.data_as(ctypes.c_void_p), hy.ctypes.data_as(ctypes.c_void_p),
       off.ctypes.data_as(ctypes.c_void_p), n,
       out.ctypes.data_as(ctypes.c_void_p), _n_threads())
    return out


def chords_batch(points, aabbs):
    """Chord statistics natively over all ROIs.

    points: list of (gx int64, gy int64, inten float64) in cloud order;
    aabbs: [N, 4] int64 (x0, x1, y0, y1).  Returns [N, 16] float64
    (-0.0 rows where no chords)."""
    lib = _load()
    n = len(points)
    out = np.full((n, 16), -0.0, np.float64)
    gx, off = _concat_offsets([p[0] for p in points], np.int64)
    gy, _ = _concat_offsets([p[1] for p in points], np.int64)
    it, _ = _concat_offsets([p[2] for p in points], np.float64)
    ab = np.ascontiguousarray(aabbs, np.int64)
    lib.nyx_chords(gx.ctypes.data_as(ctypes.c_void_p),
                   gy.ctypes.data_as(ctypes.c_void_p),
                   it.ctypes.data_as(ctypes.c_void_p),
                   off.ctypes.data_as(ctypes.c_void_p),
                   ab.ctypes.data_as(ctypes.c_void_p), n,
                   out.ctypes.data_as(ctypes.c_void_p), _n_threads())
    return out


def min_enclosing_circles(contours):
    """Min enclosing circle DIAMETER per ROI (float32 reference algorithm,
    circle.cpp:28-216).  contours: list of [K, 2] float arrays or None."""
    lib = _load()
    n = len(contours)
    out = np.zeros(n, np.float64)
    px, off = _concat_offsets(
        [c[:, 0] if c is not None else np.zeros(0) for c in contours],
        np.float64)
    py, _ = _concat_offsets(
        [c[:, 1] if c is not None else np.zeros(0) for c in contours],
        np.float64)
    lib.nyx_min_enclosing_circles(
        px.ctypes.data_as(ctypes.c_void_p), py.ctypes.data_as(ctypes.c_void_p),
        off.ctypes.data_as(ctypes.c_void_p), n,
        out.ctypes.data_as(ctypes.c_void_p), _n_threads())
    return out


def _labels_i32(labels_img, validated=False):
    """Contiguous int32 view of a label image; raises instead of silently
    wrapping labels >= 2**31 negative (uint32/uint64 label schemes).
    Callers that already ran pipeline.labels._native_labels_ok pass
    ``validated`` to skip the (full-image max) re-check."""
    labels_img = np.asarray(labels_img)
    if not validated and (labels_img.dtype == np.uint32
                          or (labels_img.dtype.kind in "iu"
                              and labels_img.dtype.itemsize > 4)) \
            and labels_img.size and int(labels_img.max()) >= 2 ** 31:
        raise ValueError("labels exceed int32 range; the native scan "
                         "cannot represent them")
    return np.ascontiguousarray(labels_img, np.int32)


_DISCOVER_DTYPES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
                    np.dtype(np.uint32): 2, np.dtype(np.int32): 3,
                    np.dtype(np.float32): 4, np.dtype(np.float64): 5,
                    np.dtype(np.int64): 6}
_discover_lock = threading.Lock()


def discover(labels_img, intens, want_clouds=False,
             labels_validated=False):
    """One-pass label discovery (+ optional raster-order cloud assembly)
    (nyxus_tpu/native/__init__.py discover, the same contract).

    labels_img: [H, W] int-like; intens: [H, W] numeric (same shape).
    Returns (recs int64 [n, 8] (label, area, y0, y1, x0, x1, 0, 0),
             fmm float64 [n, 2] (vmin, vmax), slide_min, slide_max,
             clouds | None) with clouds = (gx, gy, inten, offsets)
    concatenated per ascending label in raster order."""
    lib = _load()
    labels_img = _labels_i32(labels_img, validated=labels_validated)
    intens = np.ascontiguousarray(intens)
    if intens.dtype not in _DISCOVER_DTYPES:
        intens = np.ascontiguousarray(intens, np.float64)
    dt = _DISCOVER_DTYPES[intens.dtype]
    H, W = labels_img.shape
    lp = labels_img.ctypes.data_as(ctypes.c_void_p)
    ip = intens.ctypes.data_as(ctypes.c_void_p)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    with _discover_lock:   # the two calls share thread_local native state
        n = lib.nyx_discover(lp, ip, dt, H, W)
        if n < 0:
            raise RuntimeError("nyx_discover failed")
        recs = np.zeros((n, 8), np.int64)
        fmm = np.zeros((n, 2), np.float64)
        extrema = np.zeros(2, np.float64)
        clouds = None
        if want_clouds:
            total = int(np.count_nonzero(labels_img)) if n else 0
            clouds = (np.empty(total, np.int64), np.empty(total, np.int64),
                      np.empty(total, np.float64), np.zeros(n + 1, np.int64))
            gx, gy, gi, off = clouds
            lib.nyx_discover_fetch(lp, ip, dt, ptr(recs), ptr(fmm),
                                   ptr(extrema), ptr(off), ptr(gx), ptr(gy),
                                   ptr(gi))
        else:
            lib.nyx_discover_fetch(lp, ip, dt, ptr(recs), ptr(fmm),
                                   ptr(extrema), None, None, None, None)
    return recs, fmm, float(extrema[0]), float(extrema[1]), clouds


def geom_batch(clouds, contours, recs_mat, flags, groups, logw_eps=0.0,
               out=None, want_logw=False, n_threads=None):
    """One-call batched host-geometry pass (contour stats, fractal perimeter,
    convex hull features, 3 calipers, chords, ROI radius, radial
    distribution, weighted-moment log distances) over all ROIs.

    clouds: (gx int64, gy int64, inten float64, offsets int64[n+1]) global
    raster-order pixel clouds; contours: (flat [K,3] int64, offsets[n+1])
    merged contours in +1-shifted local coords; recs_mat: [n, 9] int64
    (x0, x1, y0, y1, rep_x0, rep_x1, rep_y0, rep_y1, area); flags: uint8[n]
    bit0 has_cloud, bit1 hull_from_contour; groups: bitmask (GEOM_GROUPS in
    pipeline.hostfeats); out: pre-filled [n, nyx_geom_width] sentinel matrix.
    Returns (out, logw_flat | None)."""
    lib = _load()
    gx, gy, it, coff = clouds
    ctr, koff = contours
    n = len(recs_mat)
    if out is None:
        out = np.zeros((n, lib.nyx_geom_width()), np.float64)
    logw = np.zeros(int(coff[-1]), np.float64) if want_logw else None
    gx = np.ascontiguousarray(gx, np.int64)
    gy = np.ascontiguousarray(gy, np.int64)
    it = np.ascontiguousarray(it, np.float64)
    coff = np.ascontiguousarray(coff, np.int64)
    ctr = np.ascontiguousarray(ctr, np.int64)
    koff = np.ascontiguousarray(koff, np.int64)
    recs_mat = np.ascontiguousarray(recs_mat, np.int64)
    flags = np.ascontiguousarray(flags, np.uint8)
    lib.nyx_geom_batch(
        gx.ctypes.data_as(ctypes.c_void_p), gy.ctypes.data_as(ctypes.c_void_p),
        it.ctypes.data_as(ctypes.c_void_p),
        coff.ctypes.data_as(ctypes.c_void_p),
        ctr.ctypes.data_as(ctypes.c_void_p),
        koff.ctypes.data_as(ctypes.c_void_p),
        recs_mat.ctypes.data_as(ctypes.c_void_p),
        flags.ctypes.data_as(ctypes.c_void_p), n, groups, logw_eps,
        out.ctypes.data_as(ctypes.c_void_p),
        logw.ctypes.data_as(ctypes.c_void_p) if want_logw else None,
        n_threads or _n_threads())
    return out, logw


def neighbors_batch(contours_global, aabbs, cenx, ceny, radius):
    """Cross-ROI neighbor features natively.  contours_global: list of
    [K, >=2] float arrays (global coords) or None; aabbs [n,4] int64
    (x0, x1, y0, y1); cenx/ceny float64 [n].  Returns [n, 9] float64."""
    lib = _load()
    n = len(contours_global)
    kx, koff = _concat_offsets(
        [c[:, 0] if c is not None else np.zeros(0) for c in contours_global],
        np.float64)
    ky, _ = _concat_offsets(
        [c[:, 1] if c is not None else np.zeros(0) for c in contours_global],
        np.float64)
    ab = np.ascontiguousarray(aabbs, np.int64)
    cenx = np.ascontiguousarray(cenx, np.float64)
    ceny = np.ascontiguousarray(ceny, np.float64)
    out = np.zeros((n, 9), np.float64)
    lib.nyx_neighbors_batch(
        kx.ctypes.data_as(ctypes.c_void_p), ky.ctypes.data_as(ctypes.c_void_p),
        koff.ctypes.data_as(ctypes.c_void_p),
        ab.ctypes.data_as(ctypes.c_void_p),
        cenx.ctypes.data_as(ctypes.c_void_p),
        ceny.ctypes.data_as(ctypes.c_void_p), float(radius), n,
        out.ctypes.data_as(ctypes.c_void_p), _n_threads())
    return out


def contours_batch(labels_img, intens_img, recs):
    """Merged multicontours of every ROI of a resident slide in one call.

    labels_img: [H, W] int-like; intens_img: [H, W] numeric; recs: iterable
    of RoiRecord-likes (label, y0, x0, height, width).  Returns a list of
    [K, 3] int64 (x, y, inten) arrays in +1-shifted local coordinates."""
    lib = _load()
    labels_img = _labels_i32(labels_img)
    intens_img = np.ascontiguousarray(intens_img, np.int64)
    H, W = labels_img.shape
    n = len(recs)
    rmat = np.zeros((n, 5), np.int64)
    caps = np.zeros(n + 1, np.int64)
    for i, r in enumerate(recs):
        rmat[i] = (r.label, r.y0, r.x0, r.height, r.width)
        caps[i + 1] = caps[i] + r.height * r.width + 16
    out = np.empty((int(caps[-1]), 3), np.int64)
    counts = np.zeros(n, np.int64)
    lib.nyx_contours_batch(
        labels_img.ctypes.data_as(ctypes.c_void_p),
        intens_img.ctypes.data_as(ctypes.c_void_p), H, W,
        rmat.ctypes.data_as(ctypes.c_void_p), n,
        caps.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p), _n_threads())
    return [out[caps[i]:caps[i] + counts[i]].copy() for i in range(n)]


def write_csv(path, header, row_prefixes, values, noval_text="nan",
              append=False, precision=6, sub_negzero=False):
    """Write a feature table to CSV natively (nyxus_tpu/native/__init__.py
    write_csv).  header: str or None; row_prefixes: list[str] pre-rendered
    string-column prefixes (no trailing comma); values: [nrows, ncols]
    float64."""
    lib = _load()
    values = np.ascontiguousarray(values, np.float64)
    n = values.shape[0]
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in row_prefixes])
    rc = lib.nyxcsv_write(
        path.encode(), header.encode() if header else None, arr,
        values.ctypes.data_as(ctypes.c_void_p), n, values.shape[1],
        noval_text.encode(), 1 if append else 0, precision,
        1 if sub_negzero else 0, _n_threads())
    if rc != 0:
        raise IOError("CSV write failed (rc=%d)" % rc)


def _blosc_inflate(buf: bytes, nbytes_out: int) -> bytes:
    """A c-blosc1 container whose blocks are coded with zlib (codec 3),
    decoded as ``nyx_blosc_decompress`` decodes the others: a block whose
    coded size is its size is stored raw, any other is inflated, and the
    byte shuffle is undone a block.  The header was checked by the C call
    that handed the container back (-4)."""
    import struct
    import zlib
    src = memoryview(buf)
    shuffled, typesize = src[2] & 0x1, src[3]
    nbytes, blocksize = struct.unpack_from("<ii", src, 4)
    nblocks = -(-nbytes // blocksize)
    out = bytearray(nbytes)
    for b in range(nblocks):
        bstart = struct.unpack_from("<i", src, 16 + 4 * b)[0]
        if bstart < 0 or bstart + 4 > len(src):
            raise ValueError("corrupt blosc stream")
        cbytes = struct.unpack_from("<i", src, bstart)[0]
        neblock = nbytes - b * blocksize if b == nblocks - 1 else blocksize
        if cbytes == neblock:
            if bstart + 4 + cbytes > len(src):
                raise ValueError("corrupt blosc stream")
            block = bytes(src[bstart + 4:bstart + 4 + cbytes])
        else:
            try:
                block = zlib.decompress(src[bstart + 4:bstart + 4 + cbytes])
            except zlib.error:
                raise ValueError("corrupt blosc stream")
            if len(block) != neblock:
                raise ValueError("corrupt blosc stream")
        if shuffled and typesize > 1 and neblock % typesize == 0:
            block = np.frombuffer(block, np.uint8).reshape(
                typesize, -1).T.tobytes()
        out[b * blocksize:b * blocksize + neblock] = block
    return bytes(out)


def blosc_decompress(buf: bytes, nbytes_out: int) -> bytes:
    """Decode one c-blosc1 container (lz4/zlib/memcpy codecs, byte shuffle)
    as nyxus_tpu/native/__init__.py blosc_decompress does, with its
    errors; zlib-coded blocks are inflated in Python (``_blosc_inflate``)."""
    lib = _load()
    out = ctypes.create_string_buffer(nbytes_out)
    rc = lib.nyx_blosc_decompress(buf, len(buf), out, nbytes_out)
    if rc == -4:
        return _blosc_inflate(buf, nbytes_out)
    if rc == -2:
        raise ValueError("blosc bitshuffle filter is not supported")
    if rc == -3:
        raise ValueError("unsupported blosc inner codec (only lz4/zlib)")
    if rc < 0:
        raise ValueError("corrupt blosc stream")
    return out.raw[:rc]


def blosc_compress_lz4(buf: bytes, typesize: int = 1,
                       shuffle: bool = True) -> bytes:
    """One c-blosc1 container of one LZ4 block (byte-shuffled by default),
    as nyxus_tpu/native/__init__.py blosc_compress_lz4 writes it."""
    lib = _load()
    cap = 16 + 8 + len(buf) + len(buf) // 128 + 64
    out = ctypes.create_string_buffer(cap)
    rc = lib.nyx_blosc_compress_lz4(buf, len(buf), typesize,
                                    1 if shuffle else 0, out, cap)
    if rc < 0:
        raise ValueError("blosc compress failed")
    return out.raw[:rc]
