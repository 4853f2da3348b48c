# Ported from nyxus_tpu/pipeline/imq_streamed.py; pinned by tests/test_torch_tables.py.
"""Streamed (oversized-ROI) image-quality features.

Phase-3 variants of the four IMQ families over the dense masked AABB frame
(intensity where mask==label else 0 -- exactly what the trivial path feeds,
registry._imq_crop), accumulated block-row-wise so the frame never
materializes.  The reference implements real ``osized_calculate`` only for
focus score and saturation (focus_score.cpp:70, saturation.cpp:55 -- and
its focus variant switches to a windowed Welford algorithm that diverges
from its own trivial path); power spectrum and sharpness are EMPTY stubs
there (power_spectrum.h:28, sharpness.h:32).  This build streams all four
and keeps them consistent with its own trivial results.

Power spectrum needs one global FFT: the pow2-padded frame is assembled on
the host, shipped to the device once and transformed there
(``torch.fft.fft2``), its radial sums formed by K1; frames padding beyond
``_PS_MAX_SIDE`` stay unassigned.  Focus, saturation and sharpness are the
JAX package's numpy and scipy, verbatim.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-8


def _frame_reader(rec, source):
    """read(y0, h) -> [h, W] masked frame rows (float64)."""
    W = rec.width

    def read(y0, h):
        ii, ll = source.read_pair(rec.y0 + y0, rec.x0, h, W)
        return np.where(ll == rec.label, ii, 0.0)

    return read


# ---------------------------------------------------------------------------
# saturation (reference: saturation.cpp get_percent_max_pixels -- counts
# over the dense AABB matrix including non-member zeros)

def saturation_streamed(rec, source, block=2048):
    read = _frame_reader(rec, source)
    h, w = rec.height, rec.width
    mn, mx = np.inf, -np.inf
    for y0 in range(0, h, block):
        r = read(y0, min(block, h - y0))
        mn = min(mn, float(r.min()))
        mx = max(mx, float(r.max()))
    cmn = cmx = 0
    for y0 in range(0, h, block):
        r = read(y0, min(block, h - y0))
        cmn += int((r == mn).sum())
        cmx += int((r == mx).sum())
    n = h * w
    return {"MIN_SATURATION": cmn / n, "MAX_SATURATION": cmx / n}


# ---------------------------------------------------------------------------
# focus score (trivial semantics: variance of |zero-boundary Laplacian|;
# LOCAL = sum of per-quadrant-tile variances / scale^2, ops/imq.py)

def _lap_var_sums(read, y_off, x0, h, w, block):
    """(sum|lap|, sum lap^2, n) of the zero-boundary Laplacian over the
    subrect rows [y_off, y_off+h) cols [x0, x0+w) of the frame."""
    s1 = s2 = 0.0
    for yb in range(0, h, block):
        hb = min(block, h - yb)
        lo = max(0, yb - 1)
        hi = min(h, yb + hb + 1)
        r = read(y_off + lo, hi - lo)[:, x0:x0 + w]
        buf = np.zeros((hb + 2, w), np.float64)
        buf[lo - (yb - 1):lo - (yb - 1) + (hi - lo)] = r
        c = buf[1:hb + 1]
        lap = buf[0:hb] + buf[2:hb + 2] - 4.0 * c
        lap[:, 1:] += c[:, :-1]
        lap[:, :-1] += c[:, 1:]
        s1 += float(np.abs(lap).sum())
        s2 += float((lap * lap).sum())
    n = h * w
    return s1, s2, n


def focus_score_streamed(rec, source, block=2048):
    read = _frame_reader(rec, source)
    h, w = rec.height, rec.width
    s1, s2, n = _lap_var_sums(read, 0, 0, h, w, block)
    fs = s2 / n - (s1 / n) ** 2
    scale = 2
    M, N = h // scale, w // scale
    local = 0.0
    if M > 0 and N > 0:
        y = 0
        while y < h - M:
            x = 0
            while x < w - N:
                t1, t2, tn = _lap_var_sums(read, y, x, M, N, block)
                local += t2 / tn - (t1 / tn) ** 2
                x += N
            y += M
    return {"FOCUS_SCORE": fs, "LOCAL_FOCUS_SCORE": local / (scale * scale)}


# ---------------------------------------------------------------------------
# sharpness (ops/imq.py sharpness, width=2): all operators are local
# (3x3 median with replicate frame edges, +-1 smooth-edge convs, +-2
# second differences, 4-row window sums) except one global normalizer
# (max of the signed x-gradient); two streamed passes.

def sharpness_streamed(rec, source, block=2048, width=2):
    from scipy import ndimage  # noqa: F401  (import check up front)
    read = _frame_reader(rec, source)
    rows, cols = rec.height, rec.width
    k = np.array([-0.5, 0.0, 0.5])

    # pass 1: global normalizer mx = max of the SIGNED x-gradient rows
    mx = -np.inf
    for y0 in range(0, rows, block):
        r = read(y0, min(block, rows - y0))
        sm = np.zeros_like(r)
        for i in range(r.shape[0]):
            sm[i] = np.convolve(r[i], k[::-1], mode="same")
        mx = max(mx, float(sm.max()))

    halo = width + 2
    sx_sum = sy_sum = 0.0
    ex_sum = ey_sum = 0.0
    for y0 in range(0, rows, block):
        hb = min(block, rows - y0)
        lo = max(0, y0 - halo - 1)
        hi = min(rows, y0 + hb + halo + 1)
        raw = read(lo, hi - lo)
        # blurred rows lo..hi (median needs a 1-row halo of its own; the
        # frame edge replicates via mode="nearest")
        from scipy import ndimage as ndi
        blurred = ndi.median_filter(raw, size=3, mode="nearest")
        if lo > 0:
            blurred = blurred[1:]
            raw = raw[1:]
            lo += 1
        if hi < rows:
            blurred = blurred[:-1]
            raw = raw[:-1]
            hi -= 1
        blurred = blurred / 255.0
        nb = blurred.shape[0]

        # local operators over the block; zero-fill at window edges is the
        # frame's zero boundary where the halo was clipped at the frame
        # edge, and rows near interior window edges are never consumed
        # (the output loop stays `halo` rows inside the window)
        def shift_rows(a, d):
            out = np.zeros_like(a)
            if d > 0:
                out[:-d] = a[d:]
            elif d < 0:
                out[-d:] = a[:d]
            else:
                out[:] = a
            return out

        up = shift_rows(blurred, -2)
        dn = shift_rows(blurred, 2)
        dom_x = np.abs(up - 2 * blurred + dn)
        lf = np.zeros_like(blurred)
        lf[:, 2:] = blurred[:, :-2]
        rt = np.zeros_like(blurred)
        rt[:, :-2] = blurred[:, 2:]
        dom_y = np.abs(lf - 2 * blurred + rt)

        # cx[j] = |blurred[j+1] - blurred[j]|; the frame's last row sees
        # |0 - blurred[-1]| which the zero-filled shift supplies when the
        # window ends at the frame edge
        cx = np.abs(shift_rows(blurred, 1) - blurred)
        cy = np.zeros_like(blurred)
        cy[:, :-1] = np.abs(blurred[:, 1:] - blurred[:, :-1])
        cy[:, -1] = np.abs(0 - blurred[:, -1])

        sm = np.zeros_like(raw)
        for i in range(raw.shape[0]):
            sm[i] = np.convolve(raw[i], k[::-1], mode="same")
        smt = np.zeros_like(raw)
        for j in range(raw.shape[1]):
            smt[:, j] = np.convolve(raw[:, j], k[::-1], mode="same")
        edge_x = (np.abs(sm) / (mx + _EPS) > 1e-4).astype(np.float64)
        edge_y = (np.abs(smt) / (mx + _EPS) > 1e-4).astype(np.float64)
        cxe = cx * edge_x
        cye = cy * edge_y

        glob = np.arange(lo, hi)
        own = (glob >= y0) & (glob < y0 + hb)
        ex_sum += float(edge_x[own].sum())
        ey_sum += float(edge_y[own].sum())

        # window sums: output row i uses rows i-width..i+width-1
        for i in range(max(y0, width), min(y0 + hb, rows - width)):
            a, b = i - width - lo, i + width - lo
            num = np.abs(dom_x[a:b]).sum(axis=0)
            den = cxe[a:b].sum(axis=0)
            val = np.where(den > 1e-3, num / np.where(den > 1e-3, den, 1), 0.0)
            sx_sum += float(val[:cols - width].sum())
            num = np.abs(dom_y[a:b]).sum(axis=0)
            den = cye[a:b].sum(axis=0)
            val = np.where(den > 1e-3, num / np.where(den > 1e-3, den, 1), 0.0)
            sy_sum += float(val[:cols - width].sum())

    rx = sx_sum / (ex_sum + _EPS)
    ry = sy_sum / (ey_sum + _EPS)
    return {"SHARPNESS": math.sqrt(rx * rx + ry * ry)}


# ---------------------------------------------------------------------------
# power spectrum slope: one global FFT, assembled block-wise in device HBM

_PS_MAX_SIDE = 8192
# rows of the spectrum K1 bins on their own (its blocks), summed after
_PS_ROWS = 128


def _streamed_median_abs_dev(read, rows, cols, mean, block):
    """Exact upper median (np.partition semantics: element at index n//2)
    of |frame - mean| via histogram refinement -- O(blocks) passes, O(2^16)
    host memory."""
    n = rows * cols
    k = n // 2
    lo, hi = 0.0, 0.0
    for y0 in range(0, rows, block):
        r = np.abs(read(y0, min(block, rows - y0)) - mean)
        hi = max(hi, float(r.max()))
    if hi == 0.0:
        return 0.0
    for _ in range(8):
        nb = 1 << 16
        edges_w = (hi - lo) / nb or 1.0
        counts = np.zeros(nb + 1, np.int64)
        below = 0
        for y0 in range(0, rows, block):
            t = np.abs(read(y0, min(block, rows - y0)) - mean).ravel()
            below += int((t < lo).sum())
            sel = (t >= lo) & (t <= hi)
            idx = np.minimum(((t[sel] - lo) / edges_w).astype(np.int64), nb)
            counts += np.bincount(idx, minlength=nb + 1)
        cum = below + np.cumsum(counts)
        b = int(np.searchsorted(cum, k + 1))
        in_bin = int(counts[b])
        blo = lo + b * edges_w
        bhi = min(hi, lo + (b + 1) * edges_w)
        if in_bin <= (1 << 20) or bhi <= blo:
            cand = []
            for y0 in range(0, rows, block):
                t = np.abs(read(y0, min(block, rows - y0)) - mean).ravel()
                cand.append(t[(t >= blo) & (t <= bhi)])
            cand = np.sort(np.concatenate(cand))
            prev = int(cum[b - 1]) if b > 0 else below
            return float(cand[k - prev])
        lo, hi = blo, bhi
    return float(lo)


def spectrum_bins(buf, cap: int, device="cpu"):
    """(mag [cap], pw [cap]) float64 numpy: the sums of the S x S frame's
    spectrum magnitudes v = |FFT2(buf)| / S and of v^2 over the radial bins
    floor(sqrt(v)) + 1, bins at or past ``cap`` dropped
    (nyxus_tpu/pipeline/imq_streamed.py:325 spectrum_bins), in buf's dtype
    on ``device``: ``torch.fft.fft2``, then both sums in one K1 launch
    (``masked_bincount``, two channels of weights over one bin index) over
    ``_PS_ROWS`` rows of the spectrum, summed."""
    from ..ops.common import masked_bincount
    S = buf.shape[0]
    b = torch.from_numpy(buf).to(device)
    v = torch.abs(torch.fft.fft2(b)) / S
    li = (torch.floor(torch.sqrt(v)) + 1).to(torch.int32)
    R = min(_PS_ROWS, S)
    v = v.reshape(R, -1)
    sums = masked_bincount(li.reshape(R, -1), torch.stack([v, v * v]), cap)
    mag, pw = sums.sum(dim=1).to(torch.float64).cpu().numpy()
    return mag, pw


def power_spectrum_streamed(rec, source, dtype=np.float64, block=2048,
                            device="cpu"):
    read = _frame_reader(rec, source)
    rows, cols = rec.height, rec.width
    if math.floor(min(rows, cols) / 8.0) < 3:
        return {"POWER_SPECTRUM_SLOPE": 0.0}
    S = 1
    while S < max(rows, cols):
        S *= 2
    if S > _PS_MAX_SIDE:
        return {}                  # frame too large for a device FFT

    smin, smax, ssum = np.inf, -np.inf, 0.0
    for y0 in range(0, rows, block):
        r = read(y0, min(block, rows - y0))
        smin = min(smin, float(r.min()))
        smax = max(smax, float(r.max()))
        ssum += float(r.sum())
    mean = ssum / (rows * cols)
    if smax - smin > 0:
        med = _streamed_median_abs_dev(read, rows, cols, mean, block)
    else:
        med = 0.0

    # inv = frame/med (or frame) minus its own mean, streamed twice
    inv_sum = 0.0
    for y0 in range(0, rows, block):
        r = read(y0, min(block, rows - y0))
        inv_sum += float((r / med if med != 0 else r).sum())
    inv_mean = inv_sum / (rows * cols)

    # the spectrum's dtype: float64 when the request is f64
    # (nyxus_tpu/pipeline/imq_streamed.py:292-298); the frame is assembled
    # on the host (one S x S array) and shipped once
    np_dt = np.float64 if dtype == np.float64 else np.float32
    buf = np.zeros((S, S), np_dt)
    for y0 in range(0, rows, block):
        r = read(y0, min(block, rows - y0))
        buf[y0:y0 + r.shape[0], :cols] = (r / med if med != 0 else r) \
            - inv_mean

    cap = int(max(rows, cols))
    mag, pw = spectrum_bins(buf, cap, device)
    radii, power = [], []
    for i in range(cap):
        if mag[i] > 0 and pw[i] > 0 and np.isfinite(np.log(pw[i])):
            radii.append(i + 2)
            power.append(pw[i])
    if len(radii) < 2:
        return {"POWER_SPECTRUM_SLOPE": 0.0}
    x = np.log(radii)
    y = np.log(power)
    A = np.stack([x, np.ones_like(x)], axis=1)
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    return {"POWER_SPECTRUM_SLOPE": float(sol[0])}
