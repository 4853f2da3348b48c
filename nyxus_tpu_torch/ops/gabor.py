"""Gabor texture features, batched (PyTorch port of nyxus_tpu/ops/gabor.py).

Reference: src/nyx/features/gabor.cpp:46-120 (calculate), conv_dud full
convolution.  GABOR_i = fraction of AABB pixels whose filtered magnitude
exceeds ``thold * max(baseline magnitude)``, normalized by the count of
baseline pixels above the baseline minimum.  Magnitudes are truncated to
unsigned int after the convolution (the reference stores them in a
PixIntens matrix), and the thresholds operate on the truncated values.

The convolutions, the baseline statistics and the threshold counts are K11
``gabor`` (csrc/gabor.cu), written by hand for the card.  Its plain PyTorch
version beside it convolves as JAX defines it (the full convolution
cropped at ceil(n / 2)), adding the taps in the kernel's order so that the
two agree bit for bit, floors included: the only path for a tensor on the
CPU; a CUDA tensor launches the kernel or raises.  ``gabor_plan`` chooses
its launch.  The scores and the degenerate / blank substitutions stay
torch.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build
from .common import SMEM_MAX, _check_float, _kernel_device, roi_sizes


def gabor_kernel(f0, sig2lam, gamma, theta, n: int):
    """Complex Gabor kernel [n, n] (real, imag), magnitude-normalized.

    f0 == 0 (possible under the reference's swapped pair unpacking, see
    gabor_features) degenerates lambda/sigma to infinity: a flat unit
    envelope with zero phase."""
    lam = 2 * math.pi / f0 if f0 != 0 else math.inf
    sig = sig2lam * lam
    t = np.arange(n) - (n // 2 if n % 2 == 0 else (n - 1) // 2)
    txv = t[None, :].astype(np.float64)
    tyv = t[:, None].astype(np.float64)
    ct, st = math.cos(theta), math.sin(theta)
    xte = txv * ct + tyv * st
    yte = tyv * ct - txv * st
    rte = xte * xte + gamma * gamma * yte * yte
    ge = (np.exp(-rte / (2 * sig * sig)) if math.isfinite(sig)
          else np.ones_like(rte))
    argm = xte * f0
    kr = ge * np.cos(argm)
    ki = ge * np.sin(argm)
    s = np.sqrt(kr * kr + ki * ki).sum()
    return kr / s, ki / s


@functools.lru_cache(maxsize=16)
def _bank(n, sig2lam, gamma, f0, thetas, freqs, dtype, device):
    """[1 + F, 2, n, n] taps of the baseline filter (theta = pi/2 at f0)
    and of the F filters, in ``dtype`` on ``device``.

    Faithful quirk: the reference stores (theta, f0) pairs but unpacks them
    as ``f0 = pair.first; theta = pair.second`` (gabor.cpp:19-25, 107-111),
    so the ANGLE (radians) acts as the frequency and the FREQUENCY acts as
    the rotation angle; filter 0 (theta = 0) is a zero-frequency
    flat-envelope filter."""
    taps = [gabor_kernel(f0, sig2lam, gamma, math.pi / 2, n)]
    for theta_deg, freq in zip(thetas, freqs):
        taps.append(gabor_kernel(math.radians(theta_deg), sig2lam, gamma,
                                 float(freq), n))
    bank = np.stack([np.stack(kk) for kk in taps])
    return torch.from_numpy(bank).to(device=device, dtype=dtype)


def filter_bank(cfg, dtype, device):
    """The configuration's taps (see _bank), built once per (config,
    dtype, device)."""
    return _bank(cfg.gabor_kersize, cfg.gabor_sig2lam, cfg.gabor_gamma,
                 cfg.gabor_f0, tuple(cfg.gabor_thetas),
                 tuple(cfg.gabor_freqs), dtype, torch.device(device))


def gabor_magnitude_plain(img, taps):
    """Plain version of the magnitudes (nyxus_tpu/ops/gabor.py:49
    _gabor_magnitude, every filter at once): img [B, H, W], taps
    [K, 2, n, n] -> [B, K, H, W] floor(|C|), C the full convolution cropped
    at off = ceil(n / 2), C(y, x) = sum_{i, j < n} taps[.., i, j] *
    img[y + off - i, x + off - j] with zeros outside the crop.  The taps
    are added one at a time, i outer and j inner, each product and sum
    rounded on its own: K11's order, so the two agree bit for bit."""
    B, H, W = img.shape
    K, _, n, _ = taps.shape
    off = int(math.ceil(n / 2))
    pad = torch.nn.functional.pad(img, (n - 1, n - 1, n - 1, n - 1))
    acc = torch.zeros((B, K, 2, H, W), dtype=img.dtype, device=img.device)
    for i in range(n):
        y0 = off - i + n - 1
        for j in range(n):
            x0 = off - j + n - 1
            win = pad[:, None, None, y0:y0 + H, x0:x0 + W]
            acc = acc + win * taps[None, :, :, i, j, None, None]
    re, im = acc[:, :, 0], acc[:, :, 1]
    return torch.floor(torch.sqrt(re * re + im * im))


def _aabb(heights, widths, H, W, device):
    ys = torch.arange(H, device=device)
    xs = torch.arange(W, device=device)
    return ((ys[None, :, None] < heights[:, None, None]) &
            (xs[None, None, :] < widths[:, None, None]))


def gabor_counts_plain(img, heights, widths, cfg):
    """Plain version of K11.  img: [B, H, W] masked intensities (float32 or
    float64); heights, widths: [B] AABB extents.  Returns (counts int32
    [B, 1 + F]: the baseline pixels above the baseline minimum, then each
    filter's pixels above the threshold; maxval, cmpval [B]: the baseline
    magnitude's max and min over the AABB, -inf / +inf for an empty one)."""
    B, H, W = img.shape
    taps = filter_bank(cfg, img.dtype, img.device)
    mag = gabor_magnitude_plain(img, taps)
    in_aabb = _aabb(heights, widths, H, W, img.device)
    base = mag[:, 0]
    maxval = torch.where(in_aabb, base, -math.inf).reshape(B, -1).amax(dim=1)
    cmpval = torch.where(in_aabb, base, math.inf).reshape(B, -1).amin(dim=1)
    baseline = (in_aabb & (base > cmpval[:, None, None])).sum(
        dim=(1, 2), dtype=torch.int32)
    ratio = mag[:, 1:] / torch.clamp(maxval, min=1e-30)[:, None, None, None]
    hits = (in_aabb[:, None] & (ratio > cfg.gabor_thold)).sum(
        dim=(2, 3), dtype=torch.int32)
    return torch.cat([baseline[:, None], hits], dim=1), maxval, cmpval


# K11's cluster path: threads a block, the largest cluster (non-portable
# above 8), the most filters, the window rows a block may stage, the shared
# memory kept for the kernel's static arrays, and the threads that put four
# warps on each of the H100's 132 SMs (a launch plan aims at least at them)
GABOR_THREADS = 256
GABOR_CLUSTER_MAX = 16
GABOR_KMAX = 8
GABOR_ROWS_MAX = 512
GABOR_STATIC_SMEM = 4096
GABOR_FILL_THREADS = 132 * 4 * 32


@functools.lru_cache(maxsize=16)
def _tap_rows(n, sig2lam, gamma, f0, thetas, freqs, filters, dtype, device):
    bank = _bank(n, sig2lam, gamma, f0, thetas, freqs, dtype, device)
    K = bank.shape[0]
    vec = 16 // bank.element_size()
    kp = -(-2 * filters // vec) * vec
    rows = torch.zeros((n * n, kp), dtype=dtype, device=device)
    rows[:, :2 * K] = bank.permute(2, 3, 0, 1).reshape(n * n, 2 * K)
    return rows


def tap_rows(cfg, dtype, device, filters):
    """The cluster path's taps: [n * n, KP], row i * n + j holding tap (i,
    j)'s (re, im) of filters 0..filters-1 (zeros past the bank's K), KP =
    2 * filters rounded up to 16 bytes, built once per (config, dtype,
    device, filters)."""
    return _tap_rows(cfg.gabor_kersize, cfg.gabor_sig2lam, cfg.gabor_gamma,
                     cfg.gabor_f0, tuple(cfg.gabor_thetas),
                     tuple(cfg.gabor_freqs), filters, dtype,
                     torch.device(device))


def gabor_window_rows(sw: int, H: int, G: int):
    """The most output rows a cluster-path block spans when a row holds
    ``sw`` strips and a strip G items: its at most GABOR_THREADS
    consecutive items cover at most ceil((GABOR_THREADS - 1) / G) + 1
    strips, cut at the bucket's H rows."""
    strips = (GABOR_THREADS + G - 2) // G + 1
    return min(H, (strips - 1 + sw - 1) // sw + 1)


def _cluster_fit(H, W, n, K, esz, KG, P):
    """(holds, C, smem) of the cluster path with KG filters and P pixels a
    thread."""
    G = -(-K // KG)
    strips = -(-W // P)
    C = -(-H * strips * G // GABOR_THREADS)
    vec = 16 // esz
    taps = n * n * (-(-2 * G * KG // vec) * vec) * esz
    windows = [(gabor_window_rows(sw, H, G) + n - 1, sw * P + n - 1)
               for sw in range(1, strips + 1)]
    smem = taps + max(r * c for r, c in windows) * esz
    holds = (K <= GABOR_KMAX and C <= GABOR_CLUSTER_MAX
             and smem + GABOR_STATIC_SMEM <= SMEM_MAX
             and max(r for r, _ in windows) <= GABOR_ROWS_MAX)
    return holds, C, smem


@functools.lru_cache(maxsize=256)
def gabor_plan(B: int, H: int, W: int, n: int, K: int, esz: int):
    """(path, C, P, KG, smem) of K11's launch for B crops of H x W (the
    AABBs, whose sizes live on the card, are at most that), n x n taps, K
    filters and ``esz``-byte values.

    The cluster path ("cluster"): a cluster of C blocks of GABOR_THREADS
    threads a ROI, a thread owning one filter group (KG of the K filters)
    at a strip of P pixels along x, C the fewest blocks whose threads hold
    the bucket's H * ceil(W / P) strips times its ceil(K / KG) groups (a
    ROI's items are split evenly over the cluster, ``gabor_blocks``).  A
    block's shared memory holds the taps (``tap_rows``) and the input window
    of its rows (``gabor_window_rows`` rows plus n - 1, by the strips'
    width plus n - 1), the largest over every AABB width; smem is those
    dynamic bytes.  It holds the work when K <= GABOR_KMAX, C <=
    GABOR_CLUSTER_MAX, the window's rows <= GABOR_ROWS_MAX and smem plus
    the kernel's static arrays fit SMEM_MAX.  Of (KG, P) = (K, 2), (K, 1),
    (ceil(K / 2), 1), (1, 1) that hold it, in order of fewer operations
    and loads a pixel, the plan takes the first that gives the batch
    GABOR_FILL_THREADS threads, else the last (a small batch's threads
    then run shorter chains).  Otherwise the tile path ("tile", C = P = KG
    = smem = 0): two launches over 16 x 16 tiles, any AABB, any n."""
    if min(B, H, W, n, K) < 1 or esz not in (4, 8):
        raise ValueError("gabor_plan: bad batch %d, bucket %dx%d, n %d, K %d "
                         "or element size %d" % (B, H, W, n, K, esz))
    fits = []
    for KG, P in ((K, 2), (K, 1), (-(-K // 2), 1), (1, 1)):
        holds, C, smem = _cluster_fit(H, W, n, K, esz, KG, P)
        if holds and (KG, P) not in [f[:2] for f in fits]:
            fits.append((KG, P, C, smem))
    if not fits:
        return "tile", 0, 0, 0, 0
    for KG, P, C, smem in fits:
        if B * H * -(-W // P) * -(-K // KG) >= GABOR_FILL_THREADS:
            break
    return "cluster", C, P, KG, smem


def gabor_blocks(h: int, w: int, P: int, KG: int, K: int, C: int):
    """The (AABB pixel (y, x), filter group) pairs each cluster-path block
    of an h x w AABB convolves, by rank, and the output rows (r0, r1) its
    window spans (None for a block with nothing to do), as the kernel maps
    thread t of block r to item r * per + t, per = ceil(items / C) (the
    ROI's items split evenly over the cluster): strip item // G, group
    item % G."""
    G = -(-K // KG)
    sw = -(-w // P)
    items = h * sw * G
    per = -(-items // C)
    out = []
    for r in range(C):
        lo, hi = r * per, min(items, (r + 1) * per)
        px = []
        for it in range(lo, hi):
            s, g = divmod(it, G)
            y, x0 = s // sw, (s % sw) * P
            px += [((y, x0 + p), g) for p in range(P) if x0 + p < w]
        rows = (lo // G // sw, (hi - 1) // G // sw) if lo < hi else None
        out.append((px, rows))
    return out


def gabor_counts(img, heights, widths, cfg):
    """K11 gabor (csrc/gabor.cu), replacing nyxus_tpu/ops/gabor.py:49
    _gabor_magnitude and the statistics of :69 gabor_features.  See
    gabor_counts_plain for the arguments and results.

    Bucket padding is never convolved.  Where ``gabor_plan`` finds that a
    cluster holds the bucket, one launch: a thread-block cluster a ROI
    computes the filters' magnitudes at each AABB pixel in one pass
    (register-tiled strips of P pixels, KG filters a thread), reduces the
    baseline's max and min across the cluster and writes the counts, max
    and min once.  Larger AABBs or kernels take the tile path: two passes
    over 16 x 16 tiles (the baseline magnitudes into a scratch plane with
    their per-ROI max and min, then the counts).  Bound on the card: the
    4 n^2 multiplies and adds a filter and AABB pixel."""
    if not _kernel_device(img, "gabor"):
        return gabor_counts_plain(img, heights, widths, cfg)
    _check_float(img, "gabor")
    if img.dim() != 3 or heights.shape != (img.shape[0],) \
            or widths.shape != heights.shape \
            or heights.device != img.device or widths.device != img.device:
        raise ValueError("gabor: img %s must be [B, H, W] and heights %s, "
                         "widths %s [B] on its device"
                         % (tuple(img.shape), tuple(heights.shape),
                            tuple(widths.shape)))
    img = img.contiguous()
    B, H, W = img.shape
    K = 1 + min(len(cfg.gabor_thetas), len(cfg.gabor_freqs))  # _bank's
    n = cfg.gabor_kersize
    dev = img.device
    if B == 0 or H * W == 0:
        return (torch.zeros((B, K), dtype=torch.int32, device=dev),
                torch.full((B,), -math.inf, dtype=img.dtype, device=dev),
                torch.full((B,), math.inf, dtype=img.dtype, device=dev))
    hts, hs = roi_sizes(heights)
    wds, ws = roi_sizes(widths)
    path, C, P, KG, smem = gabor_plan(B, H, W, n, K, img.element_size())
    if path == "cluster":
        counts = torch.empty((B, K), dtype=torch.int32, device=dev)
        maxval = torch.empty((B,), dtype=img.dtype, device=dev)
        cmpval = torch.empty((B,), dtype=img.dtype, device=dev)
        taps = tap_rows(cfg, img.dtype, dev, -(-K // KG) * KG)
        base = None
    else:
        counts = torch.zeros((B, K), dtype=torch.int32, device=dev)
        maxval = torch.full((B,), -math.inf, dtype=img.dtype, device=dev)
        cmpval = torch.full((B,), math.inf, dtype=img.dtype, device=dev)
        base = torch.empty((B, H, W), dtype=img.dtype, device=dev)
        taps = filter_bank(cfg, img.dtype, dev)
    code = _build.lib().nyx_gabor(
        img.data_ptr(), taps.data_ptr(), hts.data_ptr(), wds.data_ptr(),
        hs, ws, None if base is None else base.data_ptr(),
        maxval.data_ptr(), cmpval.data_ptr(), counts.data_ptr(), B, H, W,
        n, K, float(cfg.gabor_thold), C, P, KG, smem,
        int(img.dtype == torch.float64), _build.stream_of(img, "gabor"))
    _build.check("gabor", code)
    gabor_counts.launches += 1
    return counts, maxval, cmpval


gabor_counts.launches = 0


def gabor_features(intens_masked, heights, widths, vmin, vmax, cfg, dtype):
    """GABOR: [B, n_pairs].  All statistics/counts are restricted to the
    per-ROI AABB region (the reference's matrix extent); bucket padding is
    excluded.  score = hits / max(baseline, 1), noval where the baseline
    magnitude is flat (max == min), 0.0 for a blank ROI (vmax == vmin), in
    that order (nyxus_tpu/ops/gabor.py:100-108)."""
    counts, maxval, cmpval = gabor_counts(intens_masked.to(dtype), heights,
                                          widths, cfg)
    c = counts.to(dtype)
    vals = c[:, 1:] / torch.clamp(c[:, :1], min=1)
    vals = torch.where((maxval == cmpval)[:, None],
                       torch.tensor(cfg.noval, dtype=dtype, device=c.device),
                       vals)
    return {"GABOR": torch.where((vmax == vmin)[:, None], 0.0, vals)}
