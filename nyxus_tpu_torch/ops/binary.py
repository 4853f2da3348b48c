"""Binary-mask features: erosion count, Euler number, box-count fractal
dimension (PyTorch port of nyxus_tpu/ops/binary.py).  Batched over the ROI
bucket.

References:
* ErosionPixelsFeature (erosion.cpp:16-80): iterated 3x3 cross erosion over
  the AABB INTERIOR (cols/rows 2..dim-2; border pixels are frozen at their
  initial value), counting iterations until the interior empties (cap 1000).
  The count is also a city-block distance transform: with I the interior,
  S its 0s and the 0s of the frame pixels 4-adjacent to I (not the frame's
  corners, never row 0 or column 0), and T the largest distance
  |dy| + |dx| from a pixel of I to S, it is 0 where I is empty, 1000 where
  S is, else min(max(T - 1, 0), 1000).  A 0 spreads one pixel a step
  through I and a frozen 1 never changes, so after k steps a pixel of I is
  0 exactly when a source lies within k steps along a path through I; I is
  a rectangle, so such a shortest path can stay inside it, and its length
  is |dy| + |dx|.  The interior first empties at step T, which is not
  counted.
* EulerNumberFeature (euler_number.cpp:10-100): 2x2 quad pattern counting
  over a 1-padded mask, mode 8: (C1 - C3 - 2*Cd) / 4 with C++ integer
  division.
* FractalDimensionFeature box count (fractal_dim.cpp:16-77): pow2 grids;
  for padded sides > 32, plain origin-0 tile counts; for small ROIs the
  minimum over a 2x2 grid of origin shifts; FD = -slope of log count vs
  log s.

Two kernels written by hand for the card serve this module, each with a
plain PyTorch version beside it that follows the JAX formulation (the only
path for a tensor on the CPU; a CUDA tensor launches the kernel or raises):

* K8 ``erosion_counts`` (csrc/erosion.cu): the mask in bit rows, a warp a
  ROI (``erosion_plan``), each ROI exiting on its own; from 256² and past
  a block's shared memory the count as a distance transform (below)
* K9 ``binary_quads`` (csrc/binary_quads.cu): the quad counts and every
  scale's and origin's box counts in one launch, from the mask packed into
  bit rows (``binary_quads_plan``)

The Euler number and the log-log fit stay torch, from K9's counts.
"""

from __future__ import annotations

import torch

from .. import _build
from .common import SMEM_MAX, SMS, _kernel_device

EROSION_CAP = 1000  # SANITY_MAX_NUM_EROSIONS (erosion.h:42)

# Euler quad patterns (euler_number.h:42-58): C1 singles, C3 triples, Cd diag
_P1 = (8, 4, 2, 1)
_P3 = (7, 11, 13, 14)
_PD = (9, 6)


def _check_mask(name, mask, *per_roi):
    if mask.dim() != 3:
        raise ValueError("%s: [B, H, W] mask expected, got %s"
                         % (name, tuple(mask.shape)))
    for t in per_roi:
        if t.shape != mask.shape[:1] or t.device != mask.device:
            raise ValueError("%s: per-ROI %s must be [B] on %s"
                             % (name, tuple(t.shape), mask.device))


# ---------------------------------------------------------------------------
# K8: erosions to vanish


def erosion_interior(mask, heights, widths):
    """[B, H, W] bool: the pixels an erosion step updates, 2 <= x <= w-2
    and 2 <= y <= h-2 (erosion.cpp:38-40)."""
    B, H, W = mask.shape
    xs = torch.arange(W, dtype=torch.int32, device=mask.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.int32, device=mask.device)[None, :, None]
    return ((xs >= 2) & (xs <= widths[:, None, None] - 2) &
            (ys >= 2) & (ys <= heights[:, None, None] - 2))


def erosion_step(img, interior):
    """One erosion step of [B, H, W] int32 images: min(centre, N, S, W, E)
    at the interior, every other pixel as it was."""
    padded = torch.nn.functional.pad(img, (1, 1, 1, 1))
    mn = torch.minimum(
        torch.minimum(padded[:, :-2, 1:-1], padded[:, 2:, 1:-1]),
        torch.minimum(padded[:, 1:-1, :-2], padded[:, 1:-1, 2:]))
    return torch.where(interior, torch.minimum(mn, img), img)


def erosion_counts_plain(mask, heights, widths):
    """Plain version of K8: the JAX loop (binary.py:27-61), every crop of
    the batch eroded each step until the last ROI is done.  [B] int32."""
    B = mask.shape[0]
    dev = mask.device
    interior = erosion_interior(mask, heights, widths)
    img = mask.to(torch.int32)
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    while not bool(done.all()):
        new = erosion_step(img, interior)
        nonzero = torch.where(interior, new, 0).sum(dim=(1, 2))
        now_done = nonzero == 0
        n = torch.where(done | now_done, n, n + 1)
        done = done | now_done | (n >= EROSION_CAP)
        img = torch.where(done[:, None, None], img, new)
    return n


def erosion_counts_dist_plain(mask, heights, widths):
    """Plain version of K8's "dist" path: the count as a city-block
    distance transform (csrc/erosion.cu's header has the proof sketch).
    I is the interior (erosion_interior); the sources S are the 0s of I
    and the 0s of the frame pixels 4-adjacent to I (rows 1 and h-1 at
    columns 2..w-2, columns 1 and w-1 at rows 2..h-2).  With T the largest
    distance |dy| + |dx| from a pixel of I to its nearest source, the count
    is min(max(T - 1, 0), EROSION_CAP): 0 where I is empty, the cap where
    S is (the distances are clamped at EROSION_CAP + 1, which leaves every
    count as it was).  Row distances first, then the column min-plus scans
    of slope 1 over them.  [B] int32."""
    B, H, W = mask.shape
    dev = mask.device
    far = EROSION_CAP + 1
    big = 1 << 24
    interior = erosion_interior(mask, heights, widths)
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.int32, device=dev)[None, :, None]
    h1 = heights.to(torch.int32)[:, None, None] - 1
    w1 = widths.to(torch.int32)[:, None, None] - 1
    cols = (xs >= 2) & (xs <= w1 - 1)
    rows = (ys >= 2) & (ys <= h1 - 1)
    frame = (((ys == 1) | (ys == h1)) & cols) | (((xs == 1) | (xs == w1))
                                                  & rows)
    src = (interior | frame) & ~mask.to(torch.bool)
    left = xs - torch.cummax(torch.where(src, xs, -big), dim=2).values
    right = torch.cummin(torch.where(src, xs, big).flip(2),
                         dim=2).values.flip(2) - xs
    g = torch.minimum(left, right).clamp(max=far)
    fwd = ys + torch.cummin(g - ys, dim=1).values
    d = torch.cummin((fwd + ys).flip(1), dim=1).values.flip(1) - ys
    T = torch.where(interior, d, 0).amax(dim=(1, 2)) if H * W else \
        torch.zeros(B, dtype=torch.int32, device=dev)
    return torch.clamp(T - 1, 0, EROSION_CAP).to(torch.int32)


# K8's launch plan: the warp path's largest W and H (past 128 rows a block
# of a thread a row's word ran faster: PERF.md); the block path's threads
# at most; the shorter side from which the dist path runs wherever the
# block path would (on disks filling 256², 512² and 968 x 960 it ran 7-70x
# faster than the block path, whose steps grow with the side: PERF.md);
# the dist path's rows a block of its row pass (a warp a row)
EROSION_WARP_W = 64
EROSION_WARP_H = 128
EROSION_THREADS_MAX = 1024
EROSION_DIST_SIDE = 256
EROSION_DIST_WARPS = 8


def erosion_plan(B: int, H: int, W: int):
    """(path, word bits, threads, smem) of K8's launch for B masks of H x
    W.  "warp": W <= EROSION_WARP_W and H <= EROSION_WARP_H, a warp a ROI
    (a block of 32 threads) holding its bit rows in registers: 32-bit words
    up to 32 columns (they ran faster than 64-bit ones there: PERF.md),
    else 64-bit; no shared memory.  "block": a block a ROI, two planes of
    H x ceil(W / 64) 64-bit words in shared memory (where they fit), a
    thread a column of words: the NW = ceil(W / 64) columns times as many
    rows as EROSION_THREADS_MAX threads take (at most H), rounded up to
    whole warps; taken below EROSION_DIST_SIDE on the shorter side (the
    long ROI's 1024 x 64 among them).  "dist": the distance transform
    (erosion_counts_dist_plain) in an int16 plane ("word bits" 16), its
    row pass EROSION_DIST_WARPS warps a block with 2 ceil(W / 32) ints of
    chunk tables a warp in shared memory: crops of EROSION_DIST_SIDE and
    more on both sides, and any the block path does not hold.  B does not
    change the plan: at 300 x 32² two or three warps a block ran no faster
    than one (PERF.md)."""
    if W <= EROSION_WARP_W and H <= EROSION_WARP_H:
        return "warp", 32 if W <= 32 else 64, 32, 0
    NW = -(-W // 64)
    smem = 16 * H * NW
    if min(H, W) < EROSION_DIST_SIDE and NW <= EROSION_THREADS_MAX \
            and smem <= SMEM_MAX:
        T = 32 * -(-NW * min(H, EROSION_THREADS_MAX // NW) // 32)
        return "block", 64, T, smem
    return ("dist", 16, 32 * EROSION_DIST_WARPS,
            EROSION_DIST_WARPS * 8 * -(-W // 32))


def erosion_counts(mask, heights, widths):
    """K8 erosion (csrc/erosion.cu), replacing nyxus_tpu/ops/binary.py:27
    erosions_to_vanish's while_loop.  mask: [B, H, W] bool; heights,
    widths: [B] AABB sizes -> [B] int32 EROSIONS_2_VANISH.  Each ROI exits
    on its own: the mask packed into bit rows, a warp a ROI with its rows
    in registers up to 128 x 64, else a block a ROI with two bit planes in
    shared memory, in one launch, below 256 on the shorter side; from 256²
    and past a block's shared memory no steps at all, the count as a
    city-block distance transform over each AABB, in two launches
    (``erosion_plan``, ``erosion_counts_dist_plain``)."""
    if not _kernel_device(mask, "erosion_counts"):
        return erosion_counts_plain(mask, heights, widths)
    _check_mask("erosion_counts", mask, heights, widths)
    mask = mask.to(torch.bool).contiguous()
    heights = heights.to(torch.int32).contiguous()
    widths = widths.to(torch.int32).contiguous()
    B, H, W = mask.shape
    out = torch.empty(B, dtype=torch.int32, device=mask.device)
    if B == 0:
        return out
    path, bits, T, smem = erosion_plan(B, H, W)
    scratch = None
    if path == "dist":
        scratch = torch.empty((B, H, W), dtype=torch.int16,
                              device=mask.device)
    vec = W % 16 == 0 and mask.data_ptr() % 16 == 0
    code = _build.lib().nyx_erosion(
        mask.data_ptr(), heights.data_ptr(), widths.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        B, H, W, ("warp", "block", "dist").index(path), bits, T, smem,
        int(vec), _build.stream_of(mask, "erosion"))
    _build.check("erosion", code)
    erosion_counts.launches += 1
    return out


erosion_counts.launches = 0


def erosions_to_vanish(mask, heights, widths, dtype):
    """EROSIONS_2_VANISH: [B]."""
    return erosion_counts(mask, heights, widths).to(dtype)


# ---------------------------------------------------------------------------
# K9: quad and box counts


def n_scales(H: int, W: int):
    """(SB, S): the power of two SB >= max(H, W) and the number S of box
    scales SB, SB/2, ..., 2 (binary.py:108-121)."""
    SB = 1
    while SB < max(H, W):
        SB *= 2
    return SB, max(SB.bit_length() - 1, 0)


def box_count_at_scale(mask, s: int, ox: int, oy: int):
    """# of s x s boxes (grid shifted by (ox, oy)) containing mask pixels
    (binary.py:93 _box_count_at_scale).  [B] int32."""
    B, H, W = mask.shape
    ph = (-(H + oy)) % s
    pw = (-(W + ox)) % s
    p = torch.nn.functional.pad(mask, (ox, pw, oy, ph))
    Hp, Wp = p.shape[1], p.shape[2]
    t = p.reshape(B, Hp // s, s, Wp // s, s)
    occupied = t.any(dim=4).any(dim=2)
    return occupied.sum(dim=(1, 2)).to(torch.int32)


def binary_quads_plain(mask):
    """Plain version of K9 (binary.py:70-102): (quads [B, 3] int32 = C1, C3,
    Cd; boxes [B, S, 4] int32, the box counts at scales SB >> i and origins
    (0, 0), (s/2, 0), (0, s/2), (s/2, s/2), the (0, 0) count in all four
    entries where s > 32)."""
    B, H, W = mask.shape
    p = torch.nn.functional.pad(mask, (1, 1, 1, 1)).to(torch.int32)
    # quads over every 2x2 window of the 1-padded image
    q = (p[:, :-1, :-1] * 8 + p[:, :-1, 1:] * 4
         + p[:, 1:, :-1] * 2 + p[:, 1:, 1:])
    quads = torch.stack(
        [sum((q == v).to(torch.int32).sum(dim=(1, 2)) for v in pats)
         for pats in (_P1, _P3, _PD)], dim=1).to(torch.int32)
    SB, S = n_scales(H, W)
    boxes = []
    for i in range(S):
        s = SB >> i
        plain = box_count_at_scale(mask, s, 0, 0)
        if s <= 32:
            boxes.append(torch.stack(
                [plain] + [box_count_at_scale(mask, s, ox, oy)
                           for ox, oy in ((s // 2, 0), (0, s // 2),
                                          (s // 2, s // 2))], dim=1))
        else:
            boxes.append(plain[:, None].expand(B, 4))
    boxes = (torch.stack(boxes, dim=1) if boxes else
             torch.zeros((B, 0, 4), dtype=torch.int32, device=mask.device))
    return quads, boxes.contiguous()


QUADS_WARP_SIDE = 64    # the warp path's largest H and W
QUADS_WARP_ROIS = 8     # at most this many ROIs (warps) a block
QUADS_STATIC_SMEM = 4 * (3 + 4 * 31)    # the block path's count slots


def binary_quads_plan(B: int, H: int, W: int):
    """(path, ROIs a block, words a row, smem bytes) of K9's launch for B
    masks of H x W.  "warp": H and W at most QUADS_WARP_SIDE, a warp a ROI
    holding a row a lane in a 32-bit word up to 32 x 32, else two rows a
    lane in 64-bit words (two words a row), as many ROIs a block as keep
    every SM busy (at most QUADS_WARP_ROIS), no shared memory.  "block": a
    block a ROI, the rows in ceil(W / 32) words each in shared memory with
    the half-height second buffer of the pyramid's even levels
    (``binary_quads_words``), where they fit beside the count slots.
    "device": the same two buffers in a device scratch, no shared memory
    beyond the count slots."""
    NW = -(-W // 32)
    if H <= QUADS_WARP_SIDE and W <= QUADS_WARP_SIDE:
        words = 1 if H <= 32 and W <= 32 else 2
        return "warp", min(QUADS_WARP_ROIS, max(1, -(-B // SMS))), words, 0
    smem = 4 * binary_quads_words(H, W)
    if smem + QUADS_STATIC_SMEM <= SMEM_MAX:
        return "block", 1, NW, smem
    return "device", 1, NW, 0


def binary_quads_words(H: int, W: int) -> int:
    """32-bit words of K9's bit rows a ROI on the block and device paths:
    level 1 (H rows of ceil(W / 32) words) and level 2 (ceil(H / 2) rows of
    ceil(ceil(W / 2) / 32) words), whose buffers the later levels reuse."""
    return H * -(-W // 32) + -(-H // 2) * -(-(-(-W // 2)) // 32)


def binary_quads(mask):
    """K9 binary_quads (csrc/binary_quads.cu), replacing
    nyxus_tpu/ops/binary.py:70 euler_number's pattern counts and :93
    _box_count_at_scale as :105 fract_dim_boxcount calls it.  mask:
    [B, H, W] bool -> (quads, boxes) as binary_quads_plain returns them.
    On the card one launch: the mask packed into bit rows, the quads as
    popcounts of row pairs and the boxes of every scale and origin from an
    OR pyramid of the rows, a warp a ROI up to 64 x 64 and a block a ROI
    beyond (``binary_quads_plan``).  Bound on the card: the read of the
    mask; at the main buckets the launch and the load latency."""
    if not _kernel_device(mask, "binary_quads"):
        return binary_quads_plain(mask)
    _check_mask("binary_quads", mask)
    mask = mask.to(torch.bool).contiguous()
    B, H, W = mask.shape
    SB, S = n_scales(H, W)
    quads = torch.empty((B, 3), dtype=torch.int32, device=mask.device)
    boxes = torch.empty((B, S, 4), dtype=torch.int32, device=mask.device)
    if B == 0:
        return quads, boxes
    if H * W == 0:
        quads.zero_()
        return quads, boxes.zero_()
    path, rois, words_a_row, smem = binary_quads_plan(B, H, W)
    scratch, words = None, binary_quads_words(H, W)
    if path == "device":
        scratch = torch.empty((B, words), dtype=torch.int32,
                              device=mask.device)
    aligned = mask.data_ptr() % 16 == 0
    vec = aligned and W % (16 if path == "warp" else 32) == 0
    code = _build.lib().nyx_binary_quads(
        mask.data_ptr(), quads.data_ptr(), boxes.data_ptr(),
        None if scratch is None else scratch.data_ptr(), words, B, H, W,
        S, ("warp", "block", "device").index(path), rois, words_a_row,
        smem, int(vec), _build.stream_of(mask, "binary_quads"))
    _build.check("binary_quads", code)
    binary_quads.launches += 1
    return quads, boxes


binary_quads.launches = 0


def euler_number(mask, dtype, quads=None):
    """EULER_NUMBER, mode 8: [B]. Mask crop is embedded in a (h+2, w+2)
    zero-padded image; bucket padding already supplies the zeros."""
    if quads is None:
        quads, _ = binary_quads(mask)
    c1, c3, cd = quads.unbind(dim=1)
    # C++ integer division truncates toward zero (torch's // floors)
    num = c1 - c3 - 2 * cd
    e = torch.sign(num) * (torch.abs(num) // 4)
    return e.to(dtype)


def fract_dim_boxcount(mask, heights, widths, dtype, boxes=None):
    """FRACT_DIM_BOXCOUNT: [B]."""
    B, H, W = mask.shape
    if boxes is None:
        _, boxes = binary_quads(mask)
    SB, S = n_scales(H, W)
    # per-ROI padded side (pow2 of max AABB dim), in float32 as JAX takes it
    big = torch.maximum(heights, widths)
    padded_side = (2 ** torch.ceil(torch.log2(
        torch.clamp(big, min=1).to(torch.float32)))).to(torch.int32)
    padded_side = torch.clamp(padded_side, min=2)

    # every scale at once: the (0, 0) count stands in all four origin
    # entries above s = 32, so the min over origins is the plain count there
    scale = SB >> torch.arange(S, device=mask.device)
    count = torch.where(padded_side[:, None] > 32, boxes[:, :, 0],
                        boxes.amin(dim=2)).to(dtype)
    use = (scale[None, :] <= padded_side[:, None]) & (count > 0)
    lx = torch.log(scale.to(dtype))[None, :]
    ly = torch.log(torch.where(count > 0, count, 1))
    w = use.to(dtype)
    sx = (w * lx).sum(dim=1)
    sy = (w * ly).sum(dim=1)
    sxy = (w * lx * ly).sum(dim=1)
    sx2 = (w * lx * lx).sum(dim=1)
    cnt_used = w.sum(dim=1)

    denom = cnt_used * sx2 - sx * sx
    ok = denom != 0
    slope = torch.where(ok, (cnt_used * sxy - sx * sy)
                        / torch.where(ok, denom, 1), 0.0)
    return -slope

