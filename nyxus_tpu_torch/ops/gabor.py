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
CPU; a CUDA tensor launches the kernel or raises.  The scores and the
degenerate / blank substitutions stay torch.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build
from .common import _check_float, _kernel_device


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


def gabor_counts(img, heights, widths, cfg):
    """K11 gabor (csrc/gabor.cu), replacing nyxus_tpu/ops/gabor.py:49
    _gabor_magnitude and the statistics of :69 gabor_features.  See
    gabor_counts_plain for the arguments and results.

    One call launches two passes over 16 x 16 tiles of every ROI's AABB
    (bucket padding is never convolved): the baseline magnitudes with their
    per-ROI max and min, then the baseline count and every filter's
    threshold count.  A block stages its input tile (with its n - 1 halo)
    and the taps in shared memory, each read from device memory instead
    when it does not fit.  Bound on the card: the 4 n^2 multiplies and adds
    a filter and AABB pixel."""
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
    taps = filter_bank(cfg, img.dtype, img.device)
    K, _, n, _ = taps.shape
    hts = heights.to(torch.int32).contiguous()
    wds = widths.to(torch.int32).contiguous()
    dev = img.device
    counts = torch.zeros((B, K), dtype=torch.int32, device=dev)
    maxval = torch.full((B,), -math.inf, dtype=img.dtype, device=dev)
    cmpval = torch.full((B,), math.inf, dtype=img.dtype, device=dev)
    if B == 0 or H * W == 0:
        return counts, maxval, cmpval
    base = torch.empty((B, H, W), dtype=img.dtype, device=dev)
    with torch.cuda.device(dev):
        code = _build.lib().nyx_gabor(
            img.data_ptr(), taps.data_ptr(), hts.data_ptr(), wds.data_ptr(),
            base.data_ptr(), maxval.data_ptr(), cmpval.data_ptr(),
            counts.data_ptr(), B, H, W, n, K, float(cfg.gabor_thold),
            int(img.dtype == torch.float64), _build.stream_of(img))
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
