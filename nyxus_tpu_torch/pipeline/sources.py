"""Pair sources: region access over an in-memory pair or an on-disk TIFF
pair (nyxus_tpu/pipeline/sources.py ArrayPairSource and TiffPairSource).

The runner asks a source for region [y0:y0+h, x0:x0+w) of the pair, so the
same core drives numpy arrays and slides too large to hold in memory: a
file-backed source decodes only the blocks a region touches.  The Zarr,
DICOM, whole-slide, anisotropic, merged-label and layout-A sources of the
JAX package are not ported yet (ROADMAP.md queue 1 items 3, 7 and 13).
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
