"""Shared batched primitives for feature kernels (PyTorch port of
nyxus_tpu/ops/common.py).

Everything is batched over a leading ROI axis ``B`` and works on padded,
masked tensors.  Two of the functions here are kernels written by hand for
the card (``batched_hist`` = K1, ``stencil8`` = K4): each has a plain PyTorch
version beside it, which is the only path for a tensor on the CPU.  A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build

# shared memory a Hopper block can use (227 KB)
SMEM_MAX = 232448


def _kernel_device(t: torch.Tensor, name: str) -> bool:
    """True when ``t`` must go through the CUDA kernel, False for the plain
    version (CPU tensors only); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (name, t.device))
    return True


def _check_float(t: torch.Tensor, name: str):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError("%s: float32 or float64 expected, got %s"
                        % (name, t.dtype))


# ---------------------------------------------------------------------------
# K1: batched (joint) histogram


def batched_hist_plain(idx, weights, nbins: int):
    """Plain version of K1: out[b, k] = sum_a weights[b, a] * (idx[b, a] == k),
    entries with idx outside [0, nbins) dropped."""
    B = idx.shape[0]
    ok = (idx >= 0) & (idx < nbins)
    out = torch.zeros((B, nbins), dtype=weights.dtype, device=weights.device)
    out.scatter_add_(1, torch.where(ok, idx, 0).long(),
                     torch.where(ok, weights, 0))
    return out


def batched_hist(idx, weights, nbins: int):
    """K1 batched_hist (csrc/batched_hist.cu), replacing
    nyxus_tpu/ops/common.py:19 masked_bincount.

    idx: [B, A] integer; weights: [B, A] float32/float64 on the same device
    -> [B, nbins] of weights.dtype.  On the card one block per ROI keeps the
    histogram in shared memory: more than 227 KB of bins (IBSI-size level
    sets) raises NotImplementedError.  Bound on the card: the 8-12 bytes an
    entry read and shared-memory atomic contention on popular bins."""
    if not _kernel_device(idx, "batched_hist"):
        return batched_hist_plain(idx, weights, nbins)
    _check_float(weights, "batched_hist")
    if idx.dim() != 2 or idx.shape != weights.shape \
            or weights.device != idx.device:
        raise ValueError("batched_hist: idx %s and weights %s must be [B, A] "
                         "on one device" % (tuple(idx.shape),
                                            tuple(weights.shape)))
    if nbins * weights.element_size() > SMEM_MAX:
        raise NotImplementedError(
            "batched_hist: %d bins exceed one block's shared memory" % nbins)
    idx = idx.to(torch.int32).contiguous()
    weights = weights.contiguous()
    B, A = idx.shape
    out = torch.empty((B, nbins), dtype=weights.dtype, device=idx.device)
    if B == 0 or nbins == 0:
        return out.zero_()
    with torch.cuda.device(idx.device):
        code = _build.lib().nyx_batched_hist(
            idx.data_ptr(), weights.data_ptr(), out.data_ptr(), B, A, nbins,
            int(weights.dtype == torch.float64), _build.stream_of(idx))
    _build.check("batched_hist", code)
    batched_hist.launches += 1
    return out


batched_hist.launches = 0


# the JAX package's name for the batched bincount
masked_bincount = batched_hist


def _composite(i_idx, j_idx, ni: int, nj: int):
    ok = (i_idx >= 0) & (i_idx < ni) & (j_idx >= 0) & (j_idx < nj)
    return torch.where(ok, i_idx * nj + j_idx, -1)


def pair_hist(i_idx, j_idx, weights, ni: int, nj: int):
    """2D histogram out[b, i, j] through K1 on the composite index i*nj + j
    (the form of nyxus_tpu/ops/common.py:79 pair_hist_scatter).  Entries
    with either index out of range contribute nothing."""
    return batched_hist(_composite(i_idx, j_idx, ni, nj), weights,
                        ni * nj).reshape(weights.shape[0], ni, nj)


def pair_hist_plain(i_idx, j_idx, weights, ni: int, nj: int):
    return batched_hist_plain(_composite(i_idx, j_idx, ni, nj), weights,
                              ni * nj).reshape(weights.shape[0], ni, nj)


# ---------------------------------------------------------------------------
# elementwise / reduction helpers


def shifted2d(arr, dx: int, dy: int, fill=0):
    """arr[b, y + dy, x + dx] with constant fill outside."""
    B, H, W = arr.shape
    out = torch.full_like(arr, fill)
    y0, y1 = max(0, -dy), min(H, H - dy)
    x0, x1 = max(0, -dx), min(W, W - dx)
    if y0 < y1 and x0 < x1:
        out[:, y0:y1, x0:x1] = arr[:, y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


NEIGHBORS8 = ((0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1))


def safe_div(a, b, default=0.0):
    """a / b with ``default`` where b == 0."""
    ok = b != 0
    return torch.where(ok, a / torch.where(ok, b, 1), default)


def sort_masked_values(intens, mask, pad=float("inf")):
    """Flatten an [B, H, W] crop to sorted [B, A] values with +inf padding."""
    B = intens.shape[0]
    v = torch.where(mask, intens, pad).reshape(B, -1)
    return torch.sort(v, dim=1).values


def take_per_row(values, idx):
    """values: [B, A], idx: [B] -> [B] gather of values[b, idx[b]]."""
    return values.gather(1, idx.long()[:, None])[:, 0]


def last_true_value(cond, cand, default=0.0):
    """Per batch row: cand at the LAST index where cond is True, else default.
    cond, cand: [B, K] -> [B]."""
    K = cond.shape[-1]
    has = cond.any(dim=-1)
    last = (K - 1) - torch.argmax(cond.flip(-1).to(torch.int32), dim=-1)
    return torch.where(has, take_per_row(cand, last), default)


_LOG2_A = torch.tensor(-0.6296735, dtype=torch.float32)
_LOG2_B = torch.tensor(1.466967, dtype=torch.float32)


def fast_log2(x):
    """The reference's float32 quadratic log2 (helpers.h:283-327), bit for
    bit: every texture entropy flows through it, and an exact log differs by
    ~1e-3.  Works on the float32 bit pattern through an int32 view."""
    dt = x.dtype
    ui = x.to(torch.float32).contiguous().view(torch.int32)
    exp = ((ui >> 23) & 0xFF).to(torch.float32)
    frac = ui & 0x007FFFFF
    greater = (ui & 0x00400000) != 0
    sig_g = (frac | 0x3F000000).view(torch.float32)
    sig_l = (frac | 0x3F800000).view(torch.float32)
    fexp = torch.where(greater, exp - 126.0, exp - 127.0)
    signif = torch.where(greater, sig_g, sig_l) - 1.0
    a = _LOG2_A.to(x.device)
    b = _LOG2_B.to(x.device)
    lg2 = (fexp + (a * signif) * signif) + b * signif
    return lg2.to(dt)


# ---------------------------------------------------------------------------
# K4: 8-neighbour stencil shared by GLDM and NGTDM


def stencil8_plain(lev, part):
    """Plain version of K4.  lev: [B, H, W] int levels; part: [B, H, W] bool
    participation.  Returns int32 (same, nsum, ncnt), each [B, H, W]:
    same = participating neighbours with the centre's level; nsum / ncnt =
    sum / count of participating neighbours with level > 0."""
    lev = lev.to(torch.int32)
    same = torch.zeros_like(lev)
    nsum = torch.zeros_like(lev)
    ncnt = torch.zeros_like(lev)
    for dx, dy in NEIGHBORS8:
        p = shifted2d(part, dx, dy)
        m = shifted2d(lev, dx, dy)
        same += (p & (m == lev)).to(torch.int32)
        nz = p & (m > 0)
        nsum += torch.where(nz, m, 0)
        ncnt += nz.to(torch.int32)
    return same, nsum, ncnt


def stencil8(lev, part):
    """K4 stencil8 (csrc/stencil8.cu), replacing the 8-neighbour shifted2d
    loops of nyxus_tpu/ops/gldm.py:28-37 and nyxus_tpu/ops/ngtdm.py:37-46.
    See stencil8_plain for the outputs.  One thread a pixel; bound on the
    card: memory traffic (5 bytes read, 12 written a pixel)."""
    if not _kernel_device(lev, "stencil8"):
        return stencil8_plain(lev, part)
    if lev.dim() != 3 or part.shape != lev.shape or part.device != lev.device:
        raise ValueError("stencil8: lev %s and part %s must be [B, H, W] on "
                         "one device" % (tuple(lev.shape), tuple(part.shape)))
    lev = lev.to(torch.int32).contiguous()
    part = part.to(torch.bool).contiguous()
    B, H, W = lev.shape
    same = torch.empty_like(lev)
    nsum = torch.empty_like(lev)
    ncnt = torch.empty_like(lev)
    if lev.numel() == 0:
        return same, nsum, ncnt
    with torch.cuda.device(lev.device):
        code = _build.lib().nyx_stencil8(
            lev.data_ptr(), part.data_ptr(), same.data_ptr(), nsum.data_ptr(),
            ncnt.data_ptr(), B, H, W, _build.stream_of(lev))
    _build.check("stencil8", code)
    stencil8.launches += 1
    return same, nsum, ncnt


stencil8.launches = 0
