"""Pair sources: region access over an in-memory pair or an on-disk TIFF,
OME-Zarr or tiled DICOM pair (nyxus_tpu/pipeline/sources.py
ArrayPairSource, TiffPairSource, WholeSlideTiffSource, ZarrPairSource,
DicomPairSource, the adapters AnisoResampledSource and MergedLabelSource,
and the lazy 2.5D z-stack LayoutAStack with its _LazyVol channels; the
last six are verbatim copies).

The runner asks a source for region [y0:y0+h, x0:x0+w) of the pair, so the
same core drives numpy arrays and slides too large to hold in memory: a
file-backed source decodes only the blocks, chunks or frames a region
touches; a layout-A stack decodes one slice file at a time through the
port's ``read_gray``.
"""

from __future__ import annotations

import threading

import numpy as np


class ArrayPairSource:
    """Whole-pair-in-memory source (the featurize() path)."""

    def __init__(self, intens: np.ndarray, label_img: np.ndarray):
        self.intens = intens
        self.labels = label_img
        self.shape = label_img.shape

    def read_pair(self, y0: int, x0: int, h: int, w: int):
        """(intens [h, w] float64, labels [h, w] int64); out-of-image
        margins are zero."""
        H, W = self.shape
        ii = np.zeros((h, w), np.float64)
        ll = np.zeros((h, w), np.int64)
        y1, x1 = min(y0 + h, H), min(x0 + w, W)
        ii[:y1 - y0, :x1 - x0] = self.intens[y0:y1, x0:x1]
        ll[:y1 - y0, :x1 - x0] = self.labels[y0:y1, x0:x1]
        return ii, ll

    def close(self):
        pass


class TiffPairSource:
    """Source over one (intensity, mask) TIFF pair through the port's
    ``io/tiff.TiffReader``.  Region reads serialise on one lock a source:
    the readers' file handles and block caches are not thread-safe, and a
    prefetching thread may read while the runner does."""

    def __init__(self, int_path: str, seg_path: str):
        from ..io.tiff import TiffReader
        self._ir = TiffReader(int_path)
        try:
            self._sr = TiffReader(seg_path)
        except BaseException:
            self._ir.close()
            raise
        if (self._ir.height, self._ir.width) != (self._sr.height,
                                                 self._sr.width):
            self.close()
            raise ValueError(
                "intensity/mask dimension mismatch: %s vs %s" %
                ((self._ir.height, self._ir.width),
                 (self._sr.height, self._sr.width)))
        self.shape = (self._ir.height, self._ir.width)
        self._lock = threading.Lock()

    def read_pair(self, y0: int, x0: int, h: int, w: int):
        """(intens [h, w] float64, labels [h, w] int64); out-of-image
        margins are zero."""
        with self._lock:
            ii = self._ir.read_region(y0, x0, h, w, "f64")
            ll = self._sr.read_region(y0, x0, h, w, "u32").astype(np.int64)
        return ii, ll

    def close(self):
        self._ir.close()
        self._sr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WholeSlideTiffSource:
    """Whole-slide mode over one intensity TIFF, read through the port's
    ``io/tiff.TiffReader``: the whole image is one ROI, its labels 1
    inside the slide and 0 in the margins beyond it (reference: nyxus.py
    wholeslide=True pairing).  Region reads serialise on one lock, as
    ``TiffPairSource``'s do."""

    def __init__(self, int_path: str):
        from ..io.tiff import TiffReader
        self._ir = TiffReader(int_path)
        self.shape = (self._ir.height, self._ir.width)
        self._lock = threading.Lock()

    def read_pair(self, y0: int, x0: int, h: int, w: int):
        """(intens [h, w] float64, labels [h, w] int64 of 1 inside the
        slide)."""
        with self._lock:
            ii = self._ir.read_region(y0, x0, h, w, "f64")
        H, W = self.shape
        ll = np.zeros((h, w), np.int64)
        ll[:max(0, min(y0 + h, H) - y0), :max(0, min(x0 + w, W) - x0)] = 1
        return ii, ll

    def close(self):
        self._ir.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ZarrPairSource:
    """Chunk-streamed source over one (intensity, mask) OME-Zarr pair.

    Region reads decode only the chunks a request touches through
    ``OmeZarrReader.read_plane_region`` (reference: the z5-backed tile
    loader, omezarr.h:10-48) so over-RAM zarr slides take the same
    streamed path as tiled TIFFs."""

    def __init__(self, int_path: str, seg_path: str = None):
        import threading

        from ..io.zarr import OmeZarrReader
        self._ir = OmeZarrReader(int_path)
        self._sr = OmeZarrReader(seg_path) if seg_path else None
        if self._sr is not None and \
                (self._ir.height, self._ir.width) != (self._sr.height,
                                                      self._sr.width):
            raise ValueError("intensity/mask dimension mismatch")
        self.shape = (self._ir.height, self._ir.width)
        kind = np.dtype(self._ir.arr.dtype).kind
        self.int_is_float = kind == "f"
        self.int_transfer_u32_ok = kind == "u"
        self._lock = threading.Lock()

    def read_pair(self, y0: int, x0: int, h: int, w: int):
        with self._lock:
            ii = self._ir.read_plane_region(y0, x0, h, w).astype(np.float64)
            if self._sr is None:    # wholeslide: constant-1 labels
                H, W = self.shape
                ll = np.zeros((h, w), np.int64)
                ll[:max(0, min(y0 + h, H) - y0),
                   :max(0, min(x0 + w, W) - x0)] = 1
            else:
                ll = self._sr.read_plane_region(
                    y0, x0, h, w).astype(np.int64)
        return ii, ll

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DicomPairSource:
    """Frame-streamed source over a tiled multi-frame (WSI) DICOM pair:
    region reads decode only the tile-frames a request touches (reference:
    nyxus_dicom_loader.h:4-19).  Raises for non-tiled DICOM, which takes
    the whole-image decode path instead."""

    def __init__(self, int_path: str, seg_path: str = None):
        import threading

        from ..io.dicom import DicomTiledReader
        self._ir = DicomTiledReader(int_path)
        self._sr = DicomTiledReader(seg_path) if seg_path else None
        if self._sr is not None and \
                (self._ir.height, self._ir.width) != (self._sr.height,
                                                      self._sr.width):
            raise ValueError("intensity/mask dimension mismatch")
        self.shape = (self._ir.height, self._ir.width)
        self.int_is_float = False
        self.int_transfer_u32_ok = (self._ir.meta["signed"] == 0
                                    and self._ir.meta["slope"] is None
                                    and self._ir.meta["intercept"] is None)
        self._lock = threading.Lock()

    def read_pair(self, y0: int, x0: int, h: int, w: int):
        with self._lock:
            ii = self._ir.read_region(y0, x0, h, w).astype(np.float64)
            if self._sr is None:
                H, W = self.shape
                ll = np.zeros((h, w), np.int64)
                ll[:max(0, min(y0 + h, H) - y0),
                   :max(0, min(x0 + w, W) - x0)] = 1
            else:
                ll = self._sr.read_region(y0, x0, h, w).astype(np.int64)
        return ii, ll

    def close(self):
        self._ir.close()
        if self._sr is not None:
            self._sr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AnisoResampledSource:
    """Nearest-neighbor anisotropic resampling view (x/y scale factors).

    The reference handles custom anisotropy by re-scanning the slide as a
    "virtual" slide of size (H*ay, W*ax) whose pixel (vr, vc) reads physical
    pixel (vr/ay, vc/ax) truncated (scanTrivialRois_anisotropic,
    phase2_2d.cpp:183-285).  This wrapper serves exactly those virtual
    regions so every downstream consumer (device crops, contours, host
    families, the oversized path) sees the virtual slide."""

    def __init__(self, inner, ax: float, ay: float):
        self._inner = inner
        self.ax, self.ay = float(ax), float(ay)
        H, W = inner.shape
        self.shape = (int(H * self.ay), int(W * self.ax))
        self.int_is_float = getattr(inner, "int_is_float", False)
        self.int_transfer_u32_ok = getattr(inner, "int_transfer_u32_ok",
                                           False)

    def read_pair(self, y0: int, x0: int, h: int, w: int):
        H, W = self._inner.shape
        vH, vW = self.shape
        ii = np.zeros((h, w), np.float64)
        ll = np.zeros((h, w), np.int64)
        vy1, vx1 = min(y0 + h, vH), min(x0 + w, vW)
        if vy1 <= y0 or vx1 <= x0:
            return ii, ll
        pr = np.minimum((np.arange(y0, vy1) / self.ay).astype(np.int64), H - 1)
        pc = np.minimum((np.arange(x0, vx1) / self.ax).astype(np.int64), W - 1)
        pi, pl = self._inner.read_pair(int(pr[0]), int(pc[0]),
                                       int(pr[-1] - pr[0] + 1),
                                       int(pc[-1] - pc[0] + 1))
        ii[:vy1 - y0, :vx1 - x0] = pi[pr - pr[0]][:, pc - pc[0]]
        ll[:vy1 - y0, :vx1 - x0] = pl[pr - pr[0]][:, pc - pc[0]]
        return ii, ll

    def close(self):
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MergedLabelSource:
    """Adapter implementing --mergerois: every nonzero mask label reads as 1
    (background 0 still excluded), so the whole foreground becomes one ROI
    (reference: environment.h:56-60 mergeLabels, phase1.cpp:76,392,
    phase2_2d.cpp:145,268,665)."""

    def __init__(self, inner):
        self._inner = inner
        self.shape = inner.shape
        self.int_is_float = getattr(inner, "int_is_float", False)
        self.int_transfer_u32_ok = getattr(inner, "int_transfer_u32_ok",
                                           False)

    def read_pair(self, y0: int, x0: int, h: int, w: int):
        ii, ll = self._inner.read_pair(y0, x0, h, w)
        return ii, (ll != 0).astype(ll.dtype)

    def close(self):
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# 2.5D layout-A lazy z-stack


class _LazyVol:
    """z-indexable lazy volume over a LayoutAStack channel.

    Supports exactly the volume access patterns of the 3D pipeline:
    ``v.shape``, ``v[z] -> 2D plane``, and ``v[z0:z1, y0:y1, x0:x1]``
    (another _LazyVol restricted to the window -- used by the streamed
    oversized pass, which then reads it per z)."""

    def __init__(self, stack, channel, zs=None, ysl=None, xsl=None):
        self._stack = stack
        self._ch = channel          # 0 = intensity, 1 = labels
        D, H, W = stack.full_shape
        self._zs = range(D) if zs is None else zs
        self._ysl = slice(0, H) if ysl is None else ysl
        self._xsl = slice(0, W) if xsl is None else xsl
        ny = len(range(*self._ysl.indices(H)))
        nx = len(range(*self._xsl.indices(W)))
        self.shape = (len(self._zs), ny, nx)
        self.ndim = 3

    def __getitem__(self, key):
        if isinstance(key, tuple):
            zk, yk, xk = key
            D = self.shape[0]
            zs = [self._zs[i] for i in range(*zk.indices(D))] \
                if isinstance(zk, slice) else [self._zs[zk]]
            # compose window slices
            H = self._stack.full_shape[1]
            W = self._stack.full_shape[2]
            ybase = range(*self._ysl.indices(H))
            xbase = range(*self._xsl.indices(W))
            yr = ybase[yk] if isinstance(yk, slice) else ybase[yk:yk + 1]
            xr = xbase[xk] if isinstance(xk, slice) else xbase[xk:xk + 1]
            return _LazyVol(self._stack, self._ch, zs,
                            slice(yr.start, yr.stop), slice(xr.start, xr.stop))
        plane = self._stack.plane(self._zs[key], self._ch)
        return plane[self._ysl, self._xsl]


class LayoutAStack:
    """A 2.5D layout-A z-stack (one 2D slice FILE per z) decoded lazily,
    slice-by-slice, with a small decoded-pair LRU -- the whole stack never
    materializes in host RAM (reference tile-streams 2.5D like 2D:
    phase1.cpp:130 gatherRoisMetrics_25D, phase2_25d.cpp).

    ``intens``/``labels`` are z-indexable lazy volumes consumable by the
    3D runner's streamed entry (discovery, host-side crop assembly, and
    the per-z oversized pass)."""

    def __init__(self, ipaths, lpaths, prep=None, cache_slices=8):
        from ..io import readers
        self._readers = readers
        self._ipaths = list(ipaths)
        self._lpaths = list(lpaths)
        self._prep = prep
        self._cache = {}
        self._order = []
        self._cap = max(2, cache_slices)
        first_i = readers.read_gray(self._ipaths[0])
        self.full_shape = (len(self._ipaths),) + first_i.shape
        self.intens = _LazyVol(self, 0)
        self.labels = _LazyVol(self, 1)

    def plane(self, z, channel):
        if z not in self._cache:
            ii = self._readers.read_gray(self._ipaths[z])
            if self._prep is not None:
                ii = self._prep(ii)
            ll = self._readers.read_gray(self._lpaths[z]).astype(np.int32)
            self._cache[z] = (ii, ll)
            self._order.append(z)
            while len(self._order) > self._cap:
                self._cache.pop(self._order.pop(0), None)
        return self._cache[z][channel]
