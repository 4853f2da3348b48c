# Copied from nyxus_tpu/pipeline/labels.py (RoiRecord and the numpy discovery path only); pinned by tests/test_torch_tables.py.
"""Label discovery: per-ROI metrics from a labeled mask (phase-1 equivalent).

The reference streams tiles and updates per-label records pixel-by-pixel
(reference: src/nyx/phase1.cpp:24-124, pixel_feed.cpp).  Here a whole
in-memory pair is reduced at once with vectorized numpy segment reductions.
The native one-pass scan of the JAX package is not part of this port yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RoiRecord:
    """Per-ROI metrics gathered in phase 1 (reference: roi_cache.h:30-74)."""
    label: int
    area: int
    y0: int
    y1: int  # inclusive
    x0: int
    x1: int  # inclusive
    vmin: float
    vmax: float
    # anisotropy only: the apply_anisotropy-scaled AABB reported by BBOX_*
    # (may be SMALLER than y0..x1, which is widened to cover every virtual
    # member pixel -- the reference feeds those into raw_pixels even when
    # they fall outside its scaled AABB; see aniso_bbox)
    report_bbox: tuple | None = None

    @property
    def height(self):
        return self.y1 - self.y0 + 1

    @property
    def width(self):
        return self.x1 - self.x0 + 1


def _discover_rois_np(intens: np.ndarray, labels: np.ndarray):
    """Vectorized numpy fallback (parity oracle for the native kernel)."""
    labels = np.asarray(labels)
    intens = np.asarray(intens)
    H, W = labels.shape
    flat_lab = labels.ravel()
    flat_int = intens.ravel().astype(np.float64)

    nz = flat_lab != 0
    labs = flat_lab[nz]
    vals = flat_int[nz]
    if labs.size == 0:
        return [], float(intens.min(initial=0)), float(intens.max(initial=0))

    uniq, inv = np.unique(labs, return_inverse=True)
    k = uniq.size
    area = np.bincount(inv, minlength=k)

    vmin = np.full(k, np.inf)
    vmax = np.full(k, -np.inf)
    np.minimum.at(vmin, inv, vals)
    np.maximum.at(vmax, inv, vals)

    yy, xx = np.divmod(np.nonzero(nz)[0], W)
    y0 = np.full(k, H, dtype=np.int64)
    y1 = np.full(k, -1, dtype=np.int64)
    x0 = np.full(k, W, dtype=np.int64)
    x1 = np.full(k, -1, dtype=np.int64)
    np.minimum.at(y0, inv, yy)
    np.maximum.at(y1, inv, yy)
    np.minimum.at(x0, inv, xx)
    np.maximum.at(x1, inv, xx)

    recs = [
        RoiRecord(int(uniq[i]), int(area[i]), int(y0[i]), int(y1[i]),
                  int(x0[i]), int(x1[i]), float(vmin[i]), float(vmax[i]))
        for i in range(k)
    ]
    # slide min/max over MASKED pixels only: the reference's prescan skips
    # non-mask pixels (slideprops.cpp:146-162 'if (!msk) continue')
    return recs, float(vals.min()), float(vals.max())
