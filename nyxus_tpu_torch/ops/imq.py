# Copied verbatim from nyxus_tpu/ops/imq.py; pinned by tests/test_torch_tables.py.
"""Image-quality (IMQ) features: focus score, power spectrum slope,
saturation, sharpness.

References: src/nyx/features/focus_score.cpp, power_spectrum.cpp,
saturation.cpp, sharpness.cpp.  These run per-image (whole-slide virtual
ROI); host numpy implementations, faithful to the reference's conventions
(zero-boundary Laplacian, quadrant-only local focus at even dims, the
value-binned power spectrum, replicate-padded median blur).
"""

from __future__ import annotations

import math

import numpy as np

LAPLACIAN = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float64)


def _conv2_zero(img, k):
    from scipy import signal
    return signal.convolve2d(img, k[::-1, ::-1], mode="same", boundary="fill")


def _lap_variance(lap):
    a = np.abs(lap)
    m = a.mean()
    return ((a - m) ** 2).mean()


def focus_score(img):
    """FOCUS_SCORE + LOCAL_FOCUS_SCORE (focus_score.cpp:13-216, scale=2)."""
    img = img.astype(np.float64)
    fs = _lap_variance(_conv2_zero(img, LAPLACIAN))
    h, w = img.shape
    scale = 2
    M, N = h // scale, w // scale
    local = 0.0
    y = 0
    while y < h - M:
        x = 0
        while x < w - N:
            tile = img[y:y + M, x:x + N]
            local += _lap_variance(_conv2_zero(tile, LAPLACIAN))
            x += N
        y += M
    return fs, local / (scale * scale)


def saturation(img):
    """MIN_SATURATION, MAX_SATURATION (saturation.cpp:?)."""
    mn, mx = img.min(), img.max()
    return float((img == mn).sum()) / img.size, float((img == mx).sum()) / img.size


def power_spectrum_slope(img):
    """POWER_SPECTRUM_SLOPE (power_spectrum.cpp:60-193).

    Reproduces the reference's defined behavior: translation-invariant
    rescale, mean removal, pow2 zero-padding, normalized FFT magnitudes,
    value-keyed binning (floor(sqrt(v)) + 1), log-log least squares over
    radii 2.. (capped at the reference's raw_radii allocation -- the
    reference reads past that buffer; we stop at its length)."""
    img = np.asarray(img)
    rows, cols = img.shape
    if math.floor(min(rows, cols) / 8.0) < 3:
        return 0.0
    flat = img.astype(np.float64)
    ptp = flat.max() - flat.min()
    if ptp > 0:
        t = np.abs(flat - flat.mean()).ravel()
        part = np.partition(t, t.size // 2)
        med = part[t.size // 2]
        inv = flat / med if med != 0 else flat.copy()
    else:
        inv = flat.copy()
    inv = inv - inv.mean()

    S = 1
    while S < max(rows, cols):
        S *= 2
    pad = np.zeros((S, S))
    pad[:rows, :cols] = inv
    F = np.abs(np.fft.fft2(pad)) / S
    vals = F.ravel()

    n2 = S * S
    li = np.floor(np.sqrt(vals)).astype(np.int64) + 1
    ok = (li >= 0) & (li < n2)
    mag = np.bincount(li[ok], weights=vals[ok], minlength=n2)
    pw = np.bincount(li[ok], weights=vals[ok] ** 2, minlength=n2)

    cap = int(max(rows, cols))
    radii, power = [], []
    for i in range(min(len(mag), cap)):
        if mag[i] > 0 and pw[i] > 0 and np.isfinite(np.log(pw[i])):
            radii.append(i + 2)
            power.append(pw[i])
    if len(radii) < 2:
        return 0.0
    x = np.log(radii)
    y = np.log(power)
    A = np.stack([x, np.ones_like(x)], axis=1)
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    return float(sol[0])


# -- sharpness (sharpness.cpp:54-310) ---------------------------------------

def _pad_replicate(img, pr, pc):
    return np.pad(img, ((pr, pr), (pc, pc)), mode="edge")


def _median_blur(img, ksize=3):
    """median_blur with full-size replicate padding (sharpness.cpp:98-166)."""
    from scipy import ndimage
    rows, cols = img.shape
    padded = _pad_replicate(img.astype(np.float64), rows, cols)
    # reference takes window[floor(size/2)] of the sorted window == upper
    # median for the full 9-window; ndimage.median_filter matches for odd
    blurred = ndimage.median_filter(padded, size=ksize, mode="nearest")
    return blurred[rows:2 * rows, cols:2 * cols]


def _smooth_edges(img, edge_threshold=1e-4, eps=1e-8):
    rows, cols = img.shape
    k = np.array([-0.5, 0, 0.5])
    sm = np.zeros_like(img, np.float64)
    for i in range(rows):
        sm[i] = np.convolve(img[i].astype(np.float64), k[::-1], mode="same")
    smt = np.zeros_like(img, np.float64)
    for j in range(cols):
        smt[:, j] = np.convolve(img[:, j].astype(np.float64), k[::-1], mode="same")
    mx = sm.max()
    sm = np.abs(sm) / (mx + eps)
    smt = np.abs(smt) / (mx + eps)
    return (sm > edge_threshold).astype(np.float64), (smt > edge_threshold).astype(np.float64)


def sharpness(img, width=2):
    img = np.asarray(img)
    rows, cols = img.shape
    blurred = _median_blur(img) / 255.0
    edge_x, edge_y = _smooth_edges(img)

    dom_x = np.zeros_like(blurred)
    dom_y = np.zeros_like(blurred)
    up = np.zeros_like(blurred); up[2:] = blurred[:-2]
    dn = np.zeros_like(blurred); dn[:-2] = blurred[2:]
    dom_x = np.abs(up - 2 * blurred + dn)
    lf = np.zeros_like(blurred); lf[:, 2:] = blurred[:, :-2]
    rt = np.zeros_like(blurred); rt[:, :-2] = blurred[:, 2:]
    dom_y = np.abs(lf - 2 * blurred + rt)

    cx = np.zeros_like(blurred)
    cx[:-1] = np.abs(blurred[1:] - blurred[:-1])
    cx[-1] = np.abs(0 - blurred[-1])
    cy = np.zeros_like(blurred)
    cy[:, :-1] = np.abs(blurred[:, 1:] - blurred[:, :-1])
    cy[:, -1] = np.abs(0 - blurred[:, -1])
    cx *= edge_x
    cy *= edge_y

    sx = np.zeros_like(blurred)
    sy = np.zeros_like(blurred)
    for i in range(width, rows - width):
        num = np.abs(dom_x[i - width:i + width]).sum(axis=0)
        den = cx[i - width:i + width].sum(axis=0)
        val = np.where(den > 1e-3, num / np.where(den > 1e-3, den, 1), 0.0)
        sx[i, :cols - width] = val[:cols - width]
        num = np.abs(dom_y[i - width:i + width]).sum(axis=0)
        den = cy[i - width:i + width].sum(axis=0)
        val = np.where(den > 1e-3, num / np.where(den > 1e-3, den, 1), 0.0)
        sy[i, :cols - width] = val[:cols - width]

    EPS = 1e-8
    rx = sx.sum() / (edge_x.sum() + EPS)
    ry = sy.sum() / (edge_y.sum() + EPS)
    return math.sqrt(rx * rx + ry * ry)
