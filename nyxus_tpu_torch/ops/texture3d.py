"""3D texture families over batched voxel cubes [B, D, H, W] (PyTorch port
of nyxus_tpu/ops/texture3d.py): GLCM, GLRLM, GLSZM, GLDZM, GLDM, NGLDM and
NGTDM after the reference's 3D implementations (src/nyx/features/3d_*.cpp);
the per-matrix statistics are the 2D modules'.

Faithful 3D conventions (they differ from 2D):
* GLCM: 13 directions in (dx, dy, dz) order (3d_glcm.cpp:12-31); MATLAB mode
  counts the background (level 1) inside the AABB cube
* GLRLM: 13 directions in (dz, dy, dx) order (3d_glrlm.cpp:17-33)
* GLSZM: zones are 26-connected components; MATLAB zeroI = 1 keeps level-1
  voxels out of zones (3d_glszm.cpp:517-521)
* GLDZM: zones are 6-connected components; the distance is the in-plane
  4-direction border distance
* GLDM: 26-neighbour dependence, centre skipped at level zeroI
* NGLDM: interior voxels only, to_grayscale levels, the reference's 24
  shifts (not 26), background taking part over the whole cube
* NGTDM: Chebyshev-radius window over every in-cube voxel (background
  included), centre skipped at zeroI

Four functions here are kernels written by hand for the card, each with a
plain PyTorch version beside it (the only path for a tensor on the CPU; a
CUDA tensor launches the kernel or raises):

* K13 ``glcm3d_cooc`` (csrc/glcm3d_cooc.cu): 13-direction co-occurrences
  (``glcm3d_plan`` chooses its launch)
* K14 ``glrlm3d_runs`` (csrc/glrlm3d_runs.cu): 13-direction run matrices
* K15 ``cc3d`` (csrc/cc3d.cu): 26/6-connected zone labels, and with 6 the
  in-plane border distance (``cc3d_plan`` chooses its launch)
* K16 ``stencil3d`` (csrc/stencil3d.cu): same-level neighbour counts over a
  shift table, or window sums and counts (``stencil3d_plan`` chooses its
  launch)

The plain versions keep the JAX package's formulations (shifted copies,
pointer jumping, the min-index fixpoint), different algorithms from the
kernels', so their agreement on the card is a real check.  The histograms
go through K1 (``common.pair_hist`` / ``masked_bincount``), the zone lists
through K7 (``zones.zone_list``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import glcm as glcm2d
from . import gldzm as gldzm2d
from . import glrlm as glrlm2d
from . import glszm as glszm2d
from . import quant, zones
from .common import (SMEM_MAX, _kernel_device, masked_bincount, pair_hist,
                     pair_hist_plain, roi_sizes)
from .gldm import gldm_features
from .ngtdm import ngtdm_stats_chunked

# (dx, dy, dz), 3d_glcm.cpp:16-31
GLCM_SHIFTS = [(1, 1, 1), (1, 1, 0), (1, 1, -1), (1, 0, 1), (1, 0, 0),
               (1, 0, -1), (1, -1, 1), (1, -1, 0), (1, -1, -1), (0, 1, 1),
               (0, 1, 0), (0, 1, -1), (0, 0, 1)]
# (dz, dy, dx), 3d_glrlm.cpp:17-33
GLRLM_SHIFTS = [(1, 1, 1), (1, 1, 0), (1, 1, -1), (1, 0, 1), (1, 0, 0),
                (1, 0, -1), (1, -1, 1), (1, -1, 0), (1, -1, -1), (0, 1, 1),
                (0, 1, 0), (0, 1, -1), (0, 0, 1)]

# (dz, dy, dx) neighbourhoods
N26 = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
       for dx in (-1, 0, 1) if (dz, dy, dx) != (0, 0, 0)]
N6 = [(0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0)]
# the reference's 3D NGLDM shift table (3d_ngldm.cpp:12-40) repeats the 2D
# 8-neighbourhood at dz = 0, +1, -1 and leaves out the axial (0, 0, +-1)
# pair: 24 shifts, not 26 (3d_gldm.cpp:16-48 has all 26)
N24_NGLDM = [s for s in N26 if not (s[1] == 0 and s[2] == 0)]


def shifted3d(arr, dx: int, dy: int, dz: int, fill=0):
    """arr[b, z + dz, y + dy, x + dx] with constant fill outside."""
    B, D, H, W = arr.shape
    out = torch.full_like(arr, fill)
    z0, z1 = max(0, -dz), min(D, D - dz)
    y0, y1 = max(0, -dy), min(H, H - dy)
    x0, x1 = max(0, -dx), min(W, W - dx)
    if z0 < z1 and y0 < y1 and x0 < x1:
        out[:, z0:z1, y0:y1, x0:x1] = arr[:, z0 + dz:z1 + dz, y0 + dy:y1 + dy,
                                          x0 + dx:x1 + dx]
    return out


def _in_aabb3d(shape, depths, heights, widths):
    """[B, D, H, W] bool: the voxel lies in its ROI's AABB cube."""
    D, H, W = shape
    dev = depths.device
    zs = torch.arange(D, dtype=torch.int32, device=dev)[None, :, None, None]
    ys = torch.arange(H, dtype=torch.int32, device=dev)[None, None, :, None]
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, None, None, :]
    return ((zs < depths[:, None, None, None])
            & (ys < heights[:, None, None, None])
            & (xs < widths[:, None, None, None]))


def _check_cube(name, lev, *others):
    if lev.dim() != 4:
        raise ValueError("%s: [B, D, H, W] levels expected, got %s"
                         % (name, tuple(lev.shape)))
    for o in others:
        if o is not None and (o.shape != lev.shape or o.device != lev.device):
            raise ValueError("%s: %s and %s must be [B, D, H, W] on one device"
                             % (name, tuple(lev.shape), tuple(o.shape)))
    if math.prod(lev.shape[1:]) >= 2 ** 31:
        raise ValueError("%s: a %s cube has more voxels than int32 indexes"
                         % (name, tuple(lev.shape[1:])))


def _check_per_roi(name, lev, *per_roi):
    B = lev.shape[0]
    for t in per_roi:
        if t.shape != (B,) or t.device != lev.device:
            raise ValueError("%s: per-ROI sizes %s must be [%d] on the "
                             "levels' device" % (name, tuple(t.shape), B))


def _host_table(shifts):
    """A host int32 array of the flattened shifts for a C entry point."""
    flat = [int(v) for s in shifts for v in s]
    return (ctypes.c_int * max(1, len(flat)))(*flat)


# ---------------------------------------------------------------------------
# K13: GLCM 3D


def glcm3d_cooc_plain(levels, depths, heights, widths, offset: int, ng: int,
                      symmetric: bool, ibsi: bool, dtype):
    """Plain version of K13: the JAX formulation (nyxus_tpu/ops/texture3d.py
    :81), a shifted copy of the levels and the AABB per direction and a
    pair histogram."""
    B = levels.shape[0]
    aabb = _in_aabb3d(levels.shape[1:], depths, heights, widths)
    lev_idx = levels.to(torch.int32) - 1
    mats = []
    for dx, dy, dz in GLCM_SHIFTS:
        o = offset
        nb_lev = shifted3d(lev_idx, dx * o, dy * o, dz * o, fill=-1)
        nb_ok = shifted3d(aabb, dx * o, dy * o, dz * o, fill=False)
        valid = aabb & nb_ok
        if ibsi:  # IBSI skips zero levels
            valid = valid & (levels > 0) & (nb_lev >= 0)
        mats.append(pair_hist_plain(nb_lev.reshape(B, -1),
                                    lev_idx.reshape(B, -1),
                                    valid.reshape(B, -1).to(dtype), ng, ng))
    M = torch.stack(mats, dim=1)
    if symmetric:
        M = M + M.transpose(-1, -2)
    return M


# K13's cluster path: threads a block, and more where a block walks at least
# GLCM3_WIDE_VOXELS voxels; the voxels a block aims at; the largest cluster
# (8: clusters of 16 blocks of 1024 threads and 111 KB did not all fit the
# H100 at once); the shared memory a block's counts and stage aim at
# (several blocks an SM); and the most a 16-bit count holds
GLCM3_THREADS = 256
GLCM3_WIDE_THREADS = 512
GLCM3_WIDE_VOXELS = 16384
GLCM3_VOXELS = 8192
GLCM3_CLUSTER_MAX = 8
GLCM3_SMEM_AIM = 16 * 1024
GLCM3_NARROW = 65535


def _glcm3d_brick(D: int, H: int, W: int, C: int, offset: int, budget: int):
    """The largest brick (Zb, Yb) of at most ceil(D / C) planes whose 8-bit
    levels with the offset's halo on every side fit ``budget`` bytes: whole
    planes first, else one plane of as many rows as fit; None if not even
    one row does."""
    halo = 2 * offset
    row = W + halo
    for Zb in range(-(-D // C), 0, -1):
        if (Zb + halo) * (H + halo) * row <= budget:
            return Zb, H
    Yb = min(H, budget // ((1 + halo) * row) - halo)
    return (1, Yb) if Yb >= 1 else None


def glcm3d_counts_bytes(ng: int, directions: int, narrow: bool):
    """Shared-memory bytes of a block's counts of ``directions`` ng x ng
    matrices: 16-bit (``narrow``) or 32-bit cells, in whole 16-byte
    vectors."""
    return 16 * -(-directions * ng * ng // (8 if narrow else 4))


@functools.lru_cache(maxsize=64)
def _glcm3d_table(offset: int):
    """K13's host table: GLCM_SHIFTS as (dz, dy, dx) scaled by ``offset``."""
    return _host_table([(dz * offset, dy * offset, dx * offset)
                        for dx, dy, dz in GLCM_SHIFTS])


@functools.lru_cache(maxsize=256)
def glcm3d_plan(ng: int, D: int, H: int, W: int, offset: int,
                symmetric: bool = False):
    """(path, C, DG, T, Zb, Yb, narrow, smem) of K13's launch for ng levels, a
    bucket of D x H x W cubes (the AABBs, whose sizes live on the card, are
    at most that) and a pair ``offset`` apart.

    The cluster path ("cluster"): a cluster of C <= GLCM3_CLUSTER_MAX blocks
    of T threads (GLCM3_WIDE_THREADS where a block walks at least
    GLCM3_WIDE_VOXELS voxels, else GLCM3_THREADS) for each ROI and group of
    DG of the 13
    directions, about GLCM3_VOXELS voxels a block.  Each block holds its
    directions' matrices in shared memory (``glcm3d_counts_bytes``), 16-bit
    counts (``narrow``) when no block can count more than GLCM3_NARROW into
    one cell (a cell gains at most one a centre voxel, two with
    ``symmetric``'s transposed cell), else 32-bit.  The cube is cut into
    bricks of Zb planes x Yb rows x W (``glcm3d_bricks``), staged with the
    offset's halo as 8-bit levels (so ng <= 255).  DG is the most
    directions (up to all 13, the cube then staged once) whose counts and
    stage fit GLCM3_SMEM_AIM, at least one; smem is their bytes.  Where one
    direction's counts leave no room for a brick of one row (256 levels and
    up, or a halo too wide), the device-memory path ("device", C = DG = T =
    Zb = Yb = smem = 0)."""
    if ng < 1 or min(D, H, W) < 1 or offset < 0:
        raise ValueError("glcm3d_plan: bad levels %d, cube %dx%dx%d or "
                         "offset %d" % (ng, D, H, W, offset))
    C = min(GLCM3_CLUSTER_MAX, -(-D * H * W // GLCM3_VOXELS))
    halo = 2 * offset
    for narrow in ((True, False) if ng <= 255 else ()):
        brick = _glcm3d_brick(D, H, W, C, offset,
                              SMEM_MAX - glcm3d_counts_bytes(ng, 1, narrow))
        if brick is None:
            continue
        Zb, Yb = brick
        nbr = -(-D // Zb) * -(-H // Yb)
        Cb = min(C, nbr)
        vox = -(-nbr // Cb) * Zb * Yb * W
        if narrow and (2 if symmetric else 1) * vox > GLCM3_NARROW:
            continue
        stage = (Zb + halo) * (Yb + halo) * (W + halo)
        DG = max([g for g in range(2, 14) if glcm3d_counts_bytes(
            ng, g, narrow) + stage <= GLCM3_SMEM_AIM], default=1)
        T = GLCM3_WIDE_THREADS if vox >= GLCM3_WIDE_VOXELS else GLCM3_THREADS
        return ("cluster", Cb, DG, T, Zb, Yb, narrow,
                glcm3d_counts_bytes(ng, DG, narrow) + stage)
    return "device", 0, 0, 0, 0, 0, False, 0


def glcm3d_bricks(d: int, h: int, w: int, C: int, Zb: int, Yb: int):
    """The bricks (z0, y0, planes, rows) of a d x h x w AABB cube each
    cluster-path block counts, by rank, as the kernel cuts them."""
    nby = -(-h // Yb) if h > 0 else 0
    nbr = -(-d // Zb) * nby if w > 0 else 0
    out = [[] for _ in range(C)]
    for br in range(nbr):
        z0, y0 = (br // nby) * Zb, (br % nby) * Yb
        out[br % C].append((z0, y0, min(Zb, d - z0), min(Yb, h - y0)))
    return out


def glcm3d_cooc(levels, depths, heights, widths, offset: int, ng: int,
                symmetric: bool, ibsi: bool, dtype):
    """[B, 13, ng, ng] co-occurrence counts of GLCM_SHIFTS scaled by
    ``offset``: K13 glcm3d_cooc, replacing the matrix build of
    nyxus_tpu/ops/texture3d.py:81 glcm3d_all.

    levels: [B, D, H, W] binned int levels; depths/heights/widths: [B] AABB
    sizes (the cube both ends of a pair must lie in).  Axis 2 is the
    neighbour's level - 1, axis 3 the centre's.  ``ibsi``'s extra test
    (levels > 0 at both ends) is the kernel's level range test.  On the
    card, where ``glcm3d_plan`` finds a direction's matrix fits a block (up
    to 255 levels), one launch: a thread-block cluster for each ROI and
    group of directions stages the cube in bricks, counts in shared memory
    and writes each cell once; else a (ROI, direction, 8192-voxel chunk)
    block counts in shared memory when 4 * ng^2 fits 227 KB, otherwise in
    device memory, and a second launch writes the matrices.  Bound on the
    card: the level reads and the matrices' write-out."""
    if not _kernel_device(levels, "glcm3d_cooc"):
        return glcm3d_cooc_plain(levels, depths, heights, widths, offset, ng,
                                 symmetric, ibsi, dtype)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("glcm3d_cooc: float32 or float64 expected, got %s"
                        % dtype)
    _check_cube("glcm3d_cooc", levels)
    _check_per_roi("glcm3d_cooc", levels, depths, heights, widths)
    levels = levels.to(torch.int32).contiguous()
    B, D, H, W = levels.shape
    out = torch.empty((B, 13, ng, ng), dtype=dtype, device=levels.device)
    if B == 0 or ng == 0 or D * H * W == 0:
        return out.zero_()
    (dd, ds), (hh, hs), (ww, ws) = (roi_sizes(t) for t in (depths, heights,
                                                            widths))
    path, C, DG, T, Zb, Yb, narrow, smem = glcm3d_plan(ng, D, H, W, offset,
                                                       symmetric)
    gcnt = None if path == "cluster" else torch.zeros(
        (B, 13, ng, ng), dtype=torch.int32, device=levels.device)
    code = _build.lib().nyx_glcm3d_cooc(
        levels.data_ptr(), dd.data_ptr(), hh.data_ptr(), ww.data_ptr(),
        ds, hs, ws, _glcm3d_table(offset), out.data_ptr(),
        None if gcnt is None else gcnt.data_ptr(), B, D, H, W, ng,
        int(symmetric), int(4 * ng * ng <= SMEM_MAX), C, DG, T, Zb, Yb,
        offset,
        int(narrow), smem, int(dtype == torch.float64),
        _build.stream_of(levels, "glcm3d_cooc"))
    _build.check("glcm3d_cooc", code)
    glcm3d_cooc.launches += 1
    return out


glcm3d_cooc.launches = 0


def glcm3d_all(levels, depths, heights, widths, vmin, vmax, offset: int,
               ng: int, symmetric: bool, greyinfo: int, noval: float, dtype,
               ng_val=None):
    """GLCM over the 13 directions (nyxus_tpu/ops/texture3d.py:81; the JAX
    function takes the AABB mask, this one its sizes)."""
    M = glcm3d_cooc(levels, depths, heights, widths, offset, ng, symmetric,
                    greyinfo == 0, dtype)
    return glcm3d_finalize(M, vmin, vmax, greyinfo, noval, dtype, ng_val)


def glcm3d_finalize(M, vmin, vmax, greyinfo: int, noval: float, dtype,
                    ng_val=None):
    """Features from [B, 13, ng, ng] direction matrices
    (nyxus_tpu/ops/texture3d.py:111): the scalar is direction 0, ``_AVE``
    the mean over the 13 directions (HOM2 has none)."""
    ng = M.shape[-1]
    out = glcm2d.glcm_features_from_matrix(M, ng, noval, ng_val)
    degen = quant.binned_range_degenerate(vmin, vmax, greyinfo)
    final = {}
    for m in glcm2d.MEMBERS:
        v = torch.where(degen[:, None], noval, out[m])
        final[m] = v[:, 0]
        if m != "GLCM_HOM2":
            final[m + "_AVE"] = torch.where(degen, noval, v.mean(dim=-1))
    return final


# ---------------------------------------------------------------------------
# K14: GLRLM 3D


def glrlm3d_runs_plain(lev, valid, ng: int, nr: int, dtype):
    """Plain version of K14: the JAX pointer-jumping formulation
    (nyxus_tpu/ops/texture3d.py:134 _runs3d) per direction."""
    B = lev.shape[0]
    lev = lev.to(torch.int32)
    valid = valid.to(torch.bool)
    maxdim = max(lev.shape[1:])
    mats = []
    for dz, dy, dx in GLRLM_SHIFTS:
        same = valid & shifted3d(valid, dx, dy, dz, fill=False) \
            & (lev == shifted3d(lev, dx, dy, dz, fill=-99))
        length = torch.ones_like(lev)
        can = same
        k = 1
        while k <= maxdim:
            length = length + torch.where(
                can, shifted3d(length, dx * k, dy * k, dz * k), 0)
            can = can & shifted3d(can, dx * k, dy * k, dz * k, fill=False)
            k *= 2
        prev_same = shifted3d(same, -dx, -dy, -dz, fill=False)
        is_start = valid & ~prev_same
        mats.append(pair_hist_plain(
            (lev - 1).reshape(B, -1),
            torch.clamp(length - 1, 0, nr - 1).reshape(B, -1),
            is_start.reshape(B, -1).to(dtype), ng, nr))
    return torch.stack(mats, dim=1)


# K14's launch: threads a block (NYX_RUNS3_THREADS), the shared-memory bytes
# of counts a block aims at, the voxel steps a walking thread aims at, the
# largest portable cluster, and the most voxels a cube may have for 16-bit
# counts
RUNS3_THREADS = 256
RUNS3_SHARE = 64 * 1024
RUNS3_STEPS = 32
CLUSTER_MAX = 8
RUNS3_NARROW = 65535
_GLRLM_TABLE = _host_table(GLRLM_SHIFTS)


def glrlm3d_plan(ng: int, nr: int, voxels: int):
    """(S, L, P, narrow, smem) of K14's launch for an [ng, nr] matrix of
    cubes of ``voxels`` voxels.  P passes of S * L levels each (the last
    cut at ng), each counted by a cluster of S <= CLUSTER_MAX blocks, block
    r of pass p owning the levels [(p * S + r) * L, (p * S + r + 1) * L)
    cut at ng (``glrlm3d_ranges``) as L rows of nr counts in ``smem`` <=
    SMEM_MAX bytes of shared memory, L a power of two (a level's owner is a
    shift, not a division).  The counts are 16-bit (``narrow``) when a cube
    holds at most RUNS3_NARROW voxels (no cell can count more runs), which
    halves the clusters' shared memory, else 32-bit.  S is the fewest
    blocks whose RUNS3_SHARE bytes each hold the matrix, raised so that a
    thread walks about RUNS3_STEPS voxels of a direction, and never above
    ng; P > 1 when S blocks of SMEM_MAX bytes cannot hold it."""
    if ng < 1 or nr < 1:
        raise ValueError("glrlm3d_plan: ng %d and nr %d must be positive"
                         % (ng, nr))
    narrow = voxels <= RUNS3_NARROW
    row = (2 if narrow else 4) * nr
    lmax = SMEM_MAX // row
    if lmax == 0:
        raise ValueError("glrlm3d_runs: a run-length axis of %d does not fit "
                         "a block's shared memory" % nr)
    lmax = 1 << (lmax.bit_length() - 1)
    S = min(CLUSTER_MAX, ng, max(1, -(-ng * row // RUNS3_SHARE),
                                 -(-voxels // (RUNS3_THREADS * RUNS3_STEPS))))
    P = -(-ng // (S * lmax))
    L = 1 << (-(-ng // (P * S)) - 1).bit_length()
    S = -(-ng // (P * L))
    return S, L, P, narrow, -(-L * row // 16) * 16


def glrlm3d_ranges(ng: int, S: int, L: int, P: int):
    """The levels (0-based) K14's block (pass p, rank r) counts and writes,
    in (p, r) order, as the kernel computes them."""
    return [range(min(ng, (p * S + r) * L), min(ng, (p * S + r + 1) * L))
            for p in range(P) for r in range(S)]


def glrlm3d_runs(lev, valid, ng: int, nr: int, dtype):
    """[B, 13, ng, nr] run-length matrices along GLRLM_SHIFTS: K14
    glrlm3d_runs, replacing nyxus_tpu/ops/texture3d.py:134 _runs3d.

    lev: [B, D, H, W] int levels; valid: participation.  Entry (l, j) counts
    maximal runs of level l + 1 of length j + 1 (longer runs in the last
    column).  On the card one launch: a cluster of blocks per (ROI,
    direction, pass) holds the matrix in its distributed shared memory,
    each block walking its share of the scan lines and writing its levels
    of the output once (``glrlm3d_plan``).  Bound on the card: the walk of
    the lines, serial within a thread, then writing the output."""
    if not _kernel_device(lev, "glrlm3d_runs"):
        return glrlm3d_runs_plain(lev, valid, ng, nr, dtype)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("glrlm3d_runs: float32 or float64 expected, got %s"
                        % dtype)
    _check_cube("glrlm3d_runs", lev, valid)
    lev = lev.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    B, D, H, W = lev.shape
    out = torch.empty((B, 13, ng, nr), dtype=dtype, device=lev.device)
    if B == 0 or ng == 0 or nr == 0:
        return out
    S, L, P, narrow, _ = glrlm3d_plan(ng, nr, D * H * W)
    code = _build.lib().nyx_glrlm3d_runs(
        lev.data_ptr(), valid.data_ptr(), _GLRLM_TABLE, out.data_ptr(),
        B, D, H, W, ng, nr, S, L.bit_length() - 1, P, int(narrow),
        int(dtype == torch.float64), _build.stream_of(lev, "glrlm3d_runs"))
    _build.check("glrlm3d_runs", code)
    glrlm3d_runs.launches += 1
    return out


glrlm3d_runs.launches = 0


def glrlm3d_all(levels, valid, n_pixels, vmin, vmax, ng: int, nr: int,
                noval: float, dtype):
    """GLRLM over the 13 directions (nyxus_tpu/ops/texture3d.py:157): the
    scalar is direction 0, ``_AVE`` the mean over the 13."""
    P = glrlm3d_runs(levels, valid, ng, nr, dtype)
    out = glrlm2d.glrlm_features(P, n_pixels, vmin, vmax, noval, dtype)
    final = {}
    for m in glrlm2d.MEMBERS:
        final[m] = out[m][:, 0]
        final[m + "_AVE"] = out[m + "_AVE"]
    return final


# ---------------------------------------------------------------------------
# K15: 3D zone labels and border distance


def cc3d_labels_plain(lev, valid, neighborhood):
    """Plain version of K15's labels: the JAX min-index fixpoint
    (nyxus_tpu/ops/texture3d.py:173), min-pulls over ``neighborhood`` ((dz,
    dy, dx) shifts) until nothing changes."""
    B, D, H, W = lev.shape
    big = D * H * W
    lev = lev.to(torch.int32)
    valid = valid.to(torch.bool)
    ridx = torch.arange(big, dtype=torch.int32,
                        device=lev.device).reshape(1, D, H, W)
    oks = [((dz, dy, dx), valid & shifted3d(valid, dx, dy, dz, fill=False)
            & (lev == shifted3d(lev, dx, dy, dz, fill=-99)))
           for dz, dy, dx in neighborhood]

    def step(anc):
        for (dz, dy, dx), ok in oks:
            anc = torch.where(ok, torch.minimum(
                anc, shifted3d(anc, dx, dy, dz, fill=big)), anc)
        return anc

    anc = zones._fixpoint(step, torch.where(valid, ridx, big))
    return torch.where(valid, anc, big)


def border_distance3d_plain(levels, heights, widths):
    """Plain version of K15's distances (nyxus_tpu/ops/texture3d.py:271):
    the 2D border distance of every z-plane with the ROI's AABB sizes."""
    B, D, H, W = levels.shape
    d = zones.border_distance_plain(levels.reshape(B * D, H, W),
                                    heights.repeat_interleave(D),
                                    widths.repeat_interleave(D))
    return d.reshape(B, D, H, W)


def cc3d_plain(lev, valid, connectivity: int, heights=None, widths=None):
    """Plain version of K15: see ``cc3d``."""
    nbhd = {26: N26, 6: N6}[connectivity]
    anc = cc3d_labels_plain(lev, valid, nbhd)
    if connectivity != 6 or heights is None:
        return anc, None
    return anc, border_distance3d_plain(lev, heights, widths)


# K15's cluster path: the most blocks a cluster (16, beyond the portable 8),
# the most threads a block (a thread a voxel of its slab up to it), the
# blocks a batch aims at (about four on each of the card's 132 SMs), the
# fewest voxels a block takes, and the largest cube whose global indices
# (and BIG) fit 16-bit parents
CC3_CLUSTER_MAX = 16
CC3_THREADS_MAX = 1024
CC3_FILL = 512
CC3_MIN_VOXELS = 256
CC3_NARROW = 65535


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def cc3d_smem(H: int, W: int, Zs: int, wide: bool, dist: bool) -> int:
    """Shared-memory bytes of a K15 cluster-path block over slabs of Zs
    planes: the slab and the next plane's int32 levels and valid bytes
    (each rounded up to 16 bytes), then the 16- or 32-bit (``wide``)
    parents of the slab or, with ``dist``, its distance tiles of H rows at
    the pitch W | 1, whichever is larger (the tiles reuse the parents'
    memory)."""
    staged = (Zs + 1) * H * W
    pars = Zs * H * W * (4 if wide else 2)
    tiles = Zs * H * (W | 1) * 4 if dist else 0
    return _r16(4 * staged) + _r16(staged) + max(pars, tiles)


@functools.lru_cache(maxsize=256)
def cc3d_plan(B: int, D: int, H: int, W: int, dist: bool = False):
    """(path, C, Zs, T, wide, smem) of K15's launch for B cubes of D x H x W
    voxels, with the distances (``dist``) or not.

    The cluster path ("cluster"): a cluster of C <= CC3_CLUSTER_MAX blocks
    of T threads a ROI, block r owning the slab of Zs planes from r * Zs
    (every block at least one plane: C = ceil(D / Zs)), with ``wide``
    32-bit parents where D * H * W > CC3_NARROW, else 16-bit; smem is
    ``cc3d_smem``.  C starts at the fewest blocks that make B * C reach
    CC3_FILL, no more than give each block CC3_MIN_VOXELS, and grows until
    a slab fits a block's shared memory; T is a thread a voxel of the slab,
    at most CC3_THREADS_MAX.  Where no cluster of at most min(D,
    CC3_CLUSTER_MAX) slabs fits, and for the labels alone (no distances),
    the device-memory path ("device", C = Zs = T = smem = 0): without the
    distances' row and column walks to save, the device-memory path's
    launches over every voxel of the batch measured as fast or faster than
    a cluster of at most 16 blocks a ROI (PERF.md, section 6)."""
    if min(B, D, H, W) < 1:
        raise ValueError("cc3d_plan: bad batch %d of %dx%dx%d cubes"
                         % (B, D, H, W))
    A = D * H * W
    wide = A > CC3_NARROW
    if not dist:
        return "device", 0, 0, 0, wide, 0
    cmax = min(CC3_CLUSTER_MAX, D)
    first = max(1, min(cmax, -(-CC3_FILL // B), -(-A // CC3_MIN_VOXELS)))
    for c in range(first, cmax + 1):
        Zs = -(-D // c)
        smem = cc3d_smem(H, W, Zs, wide, dist)
        if smem <= SMEM_MAX:
            T = min(CC3_THREADS_MAX, 32 * -(-Zs * H * W // 32))
            return "cluster", -(-D // Zs), Zs, T, wide, smem
    return "device", 0, 0, 0, wide, 0


def cc3d(lev, valid, connectivity: int, heights=None, widths=None):
    """3D zone labels: K15 cc3d (csrc/cc3d.cu), replacing
    nyxus_tpu/ops/texture3d.py:173 cc3d_labels and, with 6-connectivity,
    :271 border_distance3d.

    lev: [B, D, H, W] int levels; valid: participation; connectivity: 26
    (GLSZM) or 6 (GLDZM); heights/widths: [B] AABB sizes, given with 6 for
    the distances.  Returns (anc, dist | None), int32 [B, D, H, W]: anc the
    lowest raster index of each voxel's same-level component (D * H * W off
    ``valid``), dist the in-plane dist2border.  On the card, with the
    distances where ``cc3d_plan`` finds the slabs fit a cluster (every
    main-path bucket up to 64^3), one launch: a thread-block cluster a ROI
    runs union-find on its slabs in shared memory, merges them through
    distributed shared memory and computes the distances from the same
    staged levels; else, and for the labels alone, union-find over every
    voxel of the batch in device memory (three launches, a fourth for the
    distances).  Bound on the card: the union-find's dependent finds and
    links."""
    if connectivity not in (26, 6):
        raise ValueError("cc3d: connectivity 26 or 6, not %r" % connectivity)
    if not _kernel_device(lev, "cc3d"):
        return cc3d_plain(lev, valid, connectivity, heights, widths)
    _check_cube("cc3d", lev, valid)
    want_dist = connectivity == 6 and heights is not None
    hh = ww = None
    hs = ws = 1
    if want_dist:
        _check_per_roi("cc3d", lev, heights, widths)
        (hh, hs), (ww, ws) = roi_sizes(heights), roi_sizes(widths)
    lev = lev.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    B, D, H, W = lev.shape
    anc = torch.empty_like(lev)
    dist = torch.empty_like(lev) if want_dist else None
    if lev.numel() == 0:
        return anc, dist
    _, C, Zs, T, wide, smem = cc3d_plan(B, D, H, W, want_dist)
    code = _build.lib().nyx_cc3d(
        lev.data_ptr(), valid.data_ptr(),
        hh.data_ptr() if want_dist else 0,
        ww.data_ptr() if want_dist else 0, hs, ws, anc.data_ptr(),
        dist.data_ptr() if want_dist else 0, B, D, H, W,
        int(connectivity == 26), C, Zs, T, int(wide), smem,
        _build.stream_of(lev, "cc3d"))
    _build.check("cc3d", code)
    cc3d.launches += 1
    return anc, dist


cc3d.launches = 0


# ---------------------------------------------------------------------------
# K16: neighbour stencils


def stencil3d_plain(lev, part, shifts=None, radius: int = 0):
    """Plain version of K16: shifted copies per shift (the JAX loops of
    nyxus_tpu/ops/texture3d.py:350,369,402).  See ``stencil3d``."""
    lev = lev.to(torch.int32)
    part = part.to(torch.bool)
    if shifts is not None:
        same = torch.zeros_like(lev)
        for dz, dy, dx in shifts:
            ok = shifted3d(part, dx, dy, dz, fill=False)
            nl = shifted3d(lev, dx, dy, dz, fill=-99)
            same += (ok & (nl == lev)).to(torch.int32)
        return same
    nsum = torch.zeros_like(lev)
    ncnt = torch.zeros_like(lev)
    r = radius
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if (dz, dy, dx) == (0, 0, 0):
                    continue
                ok = shifted3d(part, dx, dy, dz, fill=False)
                nsum += torch.where(ok, shifted3d(lev, dx, dy, dz), 0)
                ncnt += ok.to(torch.int32)
    return nsum, ncnt


# K16's slab path: the largest halo it stages (a table of unit shifts has
# 1, a window its radius), the most threads a block, the blocks a batch aims
# at (about one a streaming multiprocessor of the card's 132), the planes
# and rows a tile aims at, and the shared memory a tile may take
STENCIL3_HALO_MAX = 2
STENCIL3_THREADS = 512
STENCIL3_FILL = 128
STENCIL3_TILE = 8
STENCIL3_SMEM_AIM = 144 * 1024


def stencil3d_smem(W: int, Zt: int, Yt: int, halo: int) -> int:
    """Shared-memory bytes of a K16 slab-path tile of Zt planes x Yt rows x
    W with ``halo`` planes and rows on each side: int32 level rows padded
    by 4 zeros on each side (16 bytes) and part-byte rows padded by 16
    bytes on each side, each rounded up to 16 bytes."""
    PL = -(-W // 4) * 4 + 8
    PB = _r16(W) + 32
    return (Zt + 2 * halo) * (Yt + 2 * halo) * (4 * PL + PB)


@functools.lru_cache(maxsize=256)
def stencil3d_plan(B: int, D: int, H: int, W: int, halo: int):
    """(path, Zt, Yt, T, smem) of K16's launch for B cubes of D x H x W
    voxels and a neighbourhood of ``halo`` voxels (1 for a table of unit
    shifts, a window's radius; 0 where the slab path cannot take the
    table).

    The slab path ("slab"): a block of T threads (a thread a column (y, x)
    of the tile, at most STENCIL3_THREADS) for each ROI, slab of Zt planes
    and tile of Yt rows, staging the tile and its halo in
    ``stencil3d_smem`` bytes.  Zt and Yt start at STENCIL3_TILE (cut at D
    and H) and are halved, the larger first, while the tile passes
    STENCIL3_SMEM_AIM, then while the batch has fewer than STENCIL3_FILL
    blocks and a side is above 2.  A halo of 0 or beyond STENCIL3_HALO_MAX
    takes the voxel path ("voxel", Zt = Yt = T = smem = 0)."""
    if min(B, D, H, W) < 1:
        raise ValueError("stencil3d_plan: bad batch %d of %dx%dx%d cubes"
                         % (B, D, H, W))
    if not 1 <= halo <= STENCIL3_HALO_MAX:
        return "voxel", 0, 0, 0, 0
    Zt, Yt = min(D, STENCIL3_TILE), min(H, STENCIL3_TILE)

    def halve(Zt, Yt):
        return ((-(-Zt // 2), Yt) if Zt >= Yt else (Zt, -(-Yt // 2)))

    while stencil3d_smem(W, Zt, Yt, halo) > STENCIL3_SMEM_AIM \
            and max(Zt, Yt) > 1:
        Zt, Yt = halve(Zt, Yt)
    while B * -(-D // Zt) * -(-H // Yt) < STENCIL3_FILL and max(Zt, Yt) > 2:
        Zt, Yt = halve(Zt, Yt)
    return ("slab", Zt, Yt, min(STENCIL3_THREADS, 32 * -(-Yt * W // 32)),
            stencil3d_smem(W, Zt, Yt, halo))


# a shift table as a mask over the 3^3 neighbourhood, bit (dz + 1) * 9 +
# (dy + 1) * 3 + dx + 1 a shift (csrc/stencil3d.cu)
def _shift_bit(dz: int, dy: int, dx: int) -> int:
    return 1 << ((dz + 1) * 9 + (dy + 1) * 3 + dx + 1)


@functools.lru_cache(maxsize=16)
def _table_of(shifts: tuple):
    """(host table, n, mask) of a shift table: mask -1 where the slab path
    cannot count it (a shift beyond one voxel, a repeated shift, none)."""
    bits = [_shift_bit(*s) for s in shifts
            if max(abs(v) for v in s) <= 1 and s != (0, 0, 0)]
    mask = sum(set(bits))
    if not shifts or len(set(bits)) != len(shifts):
        mask = -1
    return _host_table(shifts), len(shifts), mask


def _stencil3d_table(shifts):
    """``_table_of`` the shifts, built once for N26 and N24_NGLDM."""
    if shifts is N26:
        return _N26_TABLE
    if shifts is N24_NGLDM:
        return _N24_TABLE
    return _table_of(tuple(tuple(int(v) for v in s) for s in shifts))


_N26_TABLE = _table_of(tuple(N26))
_N24_TABLE = _table_of(tuple(N24_NGLDM))


def stencil3d(lev, part, shifts=None, radius: int = 0):
    """K16 stencil3d (csrc/stencil3d.cu), replacing the shifted3d loops of
    nyxus_tpu/ops/texture3d.py:350 gldm3d_all, :402 ngldm3d_all and :369
    ngtdm3d_all.

    lev: [B, D, H, W] int levels; part: [B, D, H, W] bool, the neighbours
    that take part (neighbours outside the cube never do).  With ``shifts``
    (at most 26 (dz, dy, dx)) returns int32 ``same``, the number of shifts
    whose neighbour takes part with the centre's level; else returns int32
    (nsum, ncnt), the sum of the levels and the number of the neighbours
    taking part in the Chebyshev window of ``radius`` (centre excluded).
    On the card one launch: where ``stencil3d_plan`` takes the table (unit
    shifts, each once) or the window (radius 1 or 2), a block a (ROI, slab,
    row tile) stages its tile in shared memory and each thread walks a
    column along z; else one thread a voxel.  Bound on the card: memory
    traffic."""
    if not _kernel_device(lev, "stencil3d"):
        return stencil3d_plain(lev, part, shifts, radius)
    _check_cube("stencil3d", lev, part)
    if shifts is not None and len(shifts) > 26:
        raise ValueError("stencil3d: at most 26 shifts, got %d" % len(shifts))
    if shifts is None and radius < 0:
        raise ValueError("stencil3d: radius %d < 0" % radius)
    lev = lev.to(torch.int32).contiguous()
    part = part.to(torch.bool).contiguous()
    B, D, H, W = lev.shape
    same = torch.empty_like(lev) if shifts is not None else None
    nsum = torch.empty_like(lev) if shifts is None else None
    ncnt = torch.empty_like(lev) if shifts is None else None
    if lev.numel() > 0:
        ptr = lambda t: 0 if t is None else t.data_ptr()
        table, n, mask = (None, 0, -1) if shifts is None \
            else _stencil3d_table(shifts)
        halo = int(radius) if shifts is None else int(mask >= 0)
        _, Zt, Yt, T, smem = stencil3d_plan(B, D, H, W, halo)
        code = _build.lib().nyx_stencil3d(
            lev.data_ptr(), part.data_ptr(), table, n, mask, int(radius),
            ptr(same), ptr(nsum), ptr(ncnt), B, D, H, W, Zt, Yt, T, smem,
            _build.stream_of(lev, "stencil3d"))
        _build.check("stencil3d", code)
        stencil3d.launches += 1
    return same if shifts is not None else (nsum, ncnt)


stencil3d.launches = 0


# ---------------------------------------------------------------------------
# GLSZM / GLDZM 3D


def glszm3d_all(levels, valid, np_pixels, vmin, vmax, noval: float, dtype):
    """26-connected size zones (nyxus_tpu/ops/texture3d.py:217): K15 labels,
    K7 zone lists, and the 16 statistics of the 2D module, which are JAX's
    3D _glszm_from_zones (:227) term for term (ZE through fast_log2, its
    (level, size) cell key exact in int64)."""
    A = math.prod(levels.shape[1:])
    anc, _ = cc3d(levels, valid, 26)
    zlev, zsize, _, ok = zones.zone_list(anc, levels, valid)
    return glszm2d.glszm_features_from_zones(
        zlev.to(dtype), zsize.to(dtype), ok.to(dtype), np_pixels, vmin, vmax,
        noval, dtype, A + 1)


def gldzm3d_all(levels, valid, heights, widths, roi_area, vmin, vmax,
                noval: float, dtype):
    """6-connected zones with in-plane border distances
    (nyxus_tpu/ops/texture3d.py:282): labels and distances are one K15
    launch, the zone lists K7, and the 18 statistics the 2D module's, which
    are JAX's gldzm3d_from_zones (:300) term for term (ZDE through the
    exact log2)."""
    anc, dist = cc3d(levels, valid, 6, heights, widths)
    zlev_i, _, zd_i, ok = zones.zone_list(anc, levels, valid, dist=dist)
    wz = (ok & (zlev_i > 0)).to(dtype)
    maxd = levels.shape[2] + levels.shape[3] + 2
    return gldzm2d.gldzm_features_from_zones(zlev_i.to(dtype), zd_i.to(dtype),
                                             wz, roi_area, vmin, vmax, noval,
                                             dtype, maxd)


# ---------------------------------------------------------------------------
# GLDM / NGTDM / NGLDM 3D


def gldm3d_all(levels, valid, zeroI: int, ng: int, vmin, vmax, noval: float,
               dtype):
    """26-neighbour dependence matrix, centre skipped at level zeroI
    (nyxus_tpu/ops/texture3d.py:350): K16 counts, K1 the matrix."""
    B = levels.shape[0]
    levels = levels.to(torch.int32)
    center_ok = valid & (levels != zeroI)
    same = stencil3d(levels, valid, N26)      # nd - 1
    P = pair_hist((levels - 1).reshape(B, -1), same.reshape(B, -1),
                  center_ok.reshape(B, -1).to(dtype), ng, 27)
    return gldm_features(P, vmin, vmax, noval)


def ngtdm3d_all(levels, valid, zeroI: int, nmax: int, radius: int, vmin,
                vmax, noval: float, dtype, ibsi: bool):
    """Chebyshev-window NGTDM (nyxus_tpu/ops/texture3d.py:369): every
    in-cube voxel is a neighbour (background included).  K16 sums, one K1
    launch the per-level N, S and present levels, the statistics over
    chunks of ROIs
    (ngtdm_stats_chunked)."""
    B = levels.shape[0]
    lev = torch.where(valid, levels.to(torch.int32), 0)
    nsum, ncnt = stencil3d(lev, valid, radius=radius)
    is_zone = valid & (lev != zeroI) & (ncnt > 0)
    ave = torch.where(is_zone, nsum.to(dtype)
                      / torch.clamp(ncnt, min=1).to(dtype), 0)
    nb = nmax + 1
    wzone = is_zone.reshape(B, -1).to(dtype)
    diff = torch.abs(lev.to(dtype) - ave).reshape(B, -1)
    # N, S and the valid count per level: one K1 launch of three channels
    N, S, cnt = masked_bincount(lev.reshape(B, -1), torch.stack(
        (wzone, wzone * diff, valid.reshape(B, -1).to(dtype))), nb)
    present = cnt > 0
    present[:, 0] = False
    return ngtdm_stats_chunked(N, S, present, levels, valid, noval, dtype,
                               ibsi)


def ngldm3d_all(intens, aabb, vmax, n_levels: int, nmax: int, ibsi: bool,
                vmin, noval: float, dtype):
    """Interior-voxel NGLDM over the reference's 24 shifts with unclamped
    to_grayscale levels over the whole cube (nyxus_tpu/ops/texture3d.py
    :402).  aabb: {"interior": voxels 1..dim-2 of the AABB, "inbounds": the
    AABB}."""
    B = intens.shape[0]
    if ibsi:
        lev = intens.to(torch.int32)
    else:
        lev = (intens.to(dtype) * n_levels
               / torch.clamp(vmax[:, None, None, None], min=1e-30)
               ).to(torch.int32)
    inb = aabb["inbounds"]
    interior = aabb["interior"]
    matches = stencil3d(lev, inb, N24_NGLDM)
    nb = nmax + 1
    NR = 25                     # 24-neighbour dependence + the zero column
    lev_idx = torch.clamp(lev, 0, nb - 1).reshape(B, -1)
    m_idx = torch.clamp(matches, 0, NR - 1).reshape(B, -1)
    P = pair_hist(lev_idx, m_idx, interior.reshape(B, -1).to(dtype), nb, NR)
    present = masked_bincount(lev_idx, inb.reshape(B, -1).to(dtype), nb) > 0
    return ngldm3d_from_matrix(P, present, vmin, vmax, noval, dtype)


def ngldm3d_from_matrix(P, present, vmin, vmax, noval: float, dtype):
    """The 19 NGLDM statistics from the [B, nb, NR] dependence matrix and
    the cube's present-value mask (nyxus_tpu/ops/texture3d.py:444), with
    the 3D reference's conventions (3d_ngldm.cpp:261-357): per-grey sums
    over dependence columns j >= 1 only; LDE/HDE weight by j, the four
    mixed emphases by k = j + 1; grey weights are the binned values except
    GLV, which uses the 1-based ordinal of the value in the cube's present
    set; DCNU duplicates GLNU."""
    B, nb, NR = P.shape
    dev = P.device
    ordinal = torch.cumsum(present.to(dtype), dim=1)
    ns = P.sum(dim=(1, 2))
    s = torch.clamp(ns, min=1)
    gval = torch.arange(nb, dtype=dtype, device=dev)
    jval = torch.arange(NR, dtype=dtype, device=dev)
    kval = jval + 1.0
    jpos = jval >= 1
    j2 = torch.where(jpos, jval * jval, 1)
    k2 = kval * kval
    gnz = gval > 0
    g2 = torch.where(gnz, gval * gval, 1)
    Pj = torch.where(jpos[None, None, :], P, 0)
    sg = Pj.sum(dim=2)
    sr = Pj.sum(dim=1)
    p = Pj / s[:, None, None]
    inv_g2 = torch.where(gnz, 1 / g2, 0)
    out = {}
    out["NGLDM_LDE"] = (sr / j2).sum(dim=1) / s
    out["NGLDM_HDE"] = (sr * j2).sum(dim=1) / s
    out["NGLDM_LGLCE"] = torch.where(gnz, sg / g2, 0).sum(dim=1) / s
    out["NGLDM_HGLCE"] = (sg * gval * gval).sum(dim=1) / s
    out["NGLDM_LDLGLE"] = torch.einsum("bij,i,j->b", Pj, inv_g2, 1 / j2) / s
    out["NGLDM_LDHGLE"] = torch.einsum("bij,i,j->b", Pj, gval * gval,
                                       1 / k2) / s
    out["NGLDM_HDLGLE"] = torch.einsum("bij,i,j->b", Pj, inv_g2, k2) / s
    out["NGLDM_HDHGLE"] = torch.einsum("bij,i,j->b", Pj, gval * gval, k2) / s
    glnu = (sg * sg).sum(dim=1)
    out["NGLDM_GLNU"] = glnu / s
    out["NGLDM_GLNUN"] = glnu / (s * s)
    out["NGLDM_DCNU"] = glnu / s                # 3d_ngldm.cpp:308-325
    out["NGLDM_DCNUN"] = glnu / (s * s)
    out["NGLDM_DCP"] = torch.ones_like(ns)
    glm = torch.einsum("bij,i->b", p, gval)
    out["NGLDM_GLM"] = glm
    dcm = torch.einsum("bij,j->b", p, kval)
    out["NGLDM_DCM"] = dcm
    out["NGLDM_GLV"] = torch.einsum("bij,bi->b", p,
                                    (ordinal - glm[:, None]) ** 2)
    out["NGLDM_DCV"] = torch.einsum("bij,bj->b", p,
                                    (kval[None] - dcm[:, None]) ** 2)
    out["NGLDM_DCENT"] = -torch.where(
        p > 0, p * torch.log2(torch.where(p > 0, p, 1)), 0).sum(dim=(1, 2))
    out["NGLDM_DCENE"] = (p * p).sum(dim=(1, 2))
    bad = vmin == vmax
    return {k: torch.where(bad, noval, v) for k, v in out.items()}
