"""Zone labelling and zone lists for GLSZM / GLDZM (PyTorch port of
nyxus_tpu/ops/zones.py).

The reference grows zones by a backtracking scan (glszm.cpp:89-160,
gldzm.cpp:92-240).  A GLSZM zone is exactly the set of pixels whose
lowest-raster-index ancestor in the DAG of same-level E/SE/S/SW steps is the
same; a GLDZM zone is a full 4-connected same-level component, labelled by
its lowest raster index.

Three functions here are kernels written by hand for the card, each with a
plain PyTorch version beside it (the only path for a tensor on the CPU; a
CUDA tensor launches the kernel or raises):

* K5 ``zone_labels`` (csrc/zone_dag.cu): one top-to-bottom sweep, a warp
  a ROI with its rows in registers (``zone_dag_plan``)
* K6 ``zone_cc4`` (csrc/zone_cc4.cu): union-find, plus the GLDZM border
  distance in the same launch
* K7 zone_stats, ``zone_list`` (csrc/zone_stats.cu): a zone's size and
  minimum distance counted in shared memory, one atomic a run of one
  label, or past a cluster's by a grid of blocks adding into the output
  buffers; no sort (``zone_stats_plan``)

The plain versions keep the JAX package's fixpoint formulation (vertical
pulls plus segmented prefix-mins along x, repeated until nothing changes), a
different algorithm from the kernels', so their agreement on the card is a
real check.  ``zone_list`` returns the zones in raster order of their seeds
(JAX: sorted-label order, the same zones); callers only sum over zones.

``zone_seeds_and_sizes`` and ``grouped_run_counts`` are torch twins of the
JAX module's, held to it by tests; the zone statistics here group with
``grouped_weight_sums``.  The 3D zone labels are K15 (ops/texture3d.cc3d).
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .common import SMEM_MAX, _kernel_device, counted, shifted2d

# fill of the distance of a pixel outside any zone (nyxus_tpu zone_list)
_FAR = 1 << 30


def _check_planes(name, lev, *others):
    if lev.dim() != 3:
        raise ValueError("%s: [B, H, W] levels expected, got %s"
                         % (name, tuple(lev.shape)))
    for o in others:
        if o is not None and (o.shape != lev.shape or o.device != lev.device):
            raise ValueError("%s: %s and %s must be [B, H, W] on one device"
                             % (name, tuple(lev.shape), tuple(o.shape)))


# ---------------------------------------------------------------------------
# plain versions: the JAX fixpoint formulation


def _seg_min(a, conn, big: int):
    """Segmented inclusive prefix-min along the last axis, restarting where
    ``conn`` (element joins its predecessor) is False: a log-step
    (Hillis-Steele) scan of the JAX package's associative operator."""
    W = a.shape[-1]
    v, c = a, conn
    k = 1
    while k < W:
        pv = torch.full_like(v, big)
        pc = torch.zeros_like(c)
        pv[..., k:] = v[..., :-k]
        pc[..., k:] = c[..., :-k]
        v = torch.where(c, torch.minimum(v, pv), v)
        c = c & pc
        k *= 2
    return v


def _raster_seeds(valid):
    B, H, W = valid.shape
    ridx = torch.arange(H * W, dtype=torch.int32,
                        device=valid.device).reshape(1, H, W)
    return torch.where(valid, ridx, H * W)


def _same_level(lev, valid, dx: int, dy: int):
    """valid pixels whose (x + dx, y + dy) neighbour is valid with the same
    level."""
    return valid & shifted2d(valid, dx, dy, fill=False) \
        & (shifted2d(lev, dx, dy) == lev)


def _fixpoint(step, anc):
    anc = step(anc)
    while True:
        new = step(anc)
        if torch.equal(new, anc):
            return anc
        anc = new


def zone_labels_plain(lev, valid):
    """Plain version of K5 (nyxus_tpu/ops/zones.py:32): NW/N/NE pulls and a
    segmented prefix-min along W chains, iterated to the fixpoint."""
    B, H, W = lev.shape
    big = H * W
    lev = lev.to(torch.int32)
    valid = valid.to(torch.bool)
    same_w = _same_level(lev, valid, -1, 0)
    preds = [((dx, dy), _same_level(lev, valid, dx, dy))
             for dx, dy in ((-1, -1), (0, -1), (1, -1))]   # NW, N, NE

    def step(anc):
        for (dx, dy), ok in preds:
            anc = torch.where(ok, torch.minimum(
                anc, shifted2d(anc, dx, dy, fill=big)), anc)
        return _seg_min(anc, same_w, big)

    anc = _fixpoint(step, _raster_seeds(valid))
    return torch.where(valid, anc, big)


def zone_labels_cc4_plain(lev, valid):
    """Plain version of K6's labels (nyxus_tpu/ops/zones.py:85): N and S
    pulls plus segmented prefix-mins along W and E chains, iterated to the
    fixpoint."""
    B, H, W = lev.shape
    big = H * W
    lev = lev.to(torch.int32)
    valid = valid.to(torch.bool)
    same_w = _same_level(lev, valid, -1, 0)
    same_e_rev = _same_level(lev, valid, 1, 0).flip(-1)
    preds = [((dx, dy), _same_level(lev, valid, dx, dy))
             for dx, dy in ((0, -1), (0, 1))]              # N, S

    def step(anc):
        for (dx, dy), ok in preds:
            anc = torch.where(ok, torch.minimum(
                anc, shifted2d(anc, dx, dy, fill=big)), anc)
        anc = _seg_min(anc, same_w, big)
        return _seg_min(anc.flip(-1), same_e_rev, big).flip(-1)

    anc = _fixpoint(step, _raster_seeds(valid))
    return torch.where(valid, anc, big)


def border_distance_plain(levels, heights, widths):
    """Plain version of K6's distances (nyxus_tpu/ops/gldzm.py:35
    border_distance): 1 + the steps to the nearest zero level strictly
    left/right/up/down or to the AABB margin, at least 1."""
    B, H, W = levels.shape
    dev = levels.device
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.int32, device=dev)[None, :, None]
    zero = levels == 0
    neg = torch.tensor(-_FAR, dtype=torch.int32, device=dev)
    pos = torch.tensor(_FAR, dtype=torch.int32, device=dev)

    def cummax(a, dim):
        return torch.cummax(a, dim=dim).values

    def cummin_rev(a, dim):
        return torch.cummin(a.flip(dim), dim=dim).values.flip(dim)

    zl = shifted2d(cummax(torch.where(zero, xs, neg), 2), -1, 0, fill=-_FAR)
    zr = shifted2d(cummin_rev(torch.where(zero, xs, pos), 2), 1, 0, fill=_FAR)
    zt = shifted2d(cummax(torch.where(zero, ys, neg), 1), 0, -1, fill=-_FAR)
    zb = shifted2d(cummin_rev(torch.where(zero, ys, pos), 1), 0, 1, fill=_FAR)
    w1 = widths.to(torch.int32)[:, None, None] - 1
    h1 = heights.to(torch.int32)[:, None, None] - 1
    d_l = torch.minimum(xs - zl, xs)
    d_r = torch.minimum(zr - xs, w1 - xs)
    d_t = torch.minimum(ys - zt, ys)
    d_b = torch.minimum(zb - ys, h1 - ys)
    d = torch.minimum(torch.minimum(d_l, d_r), torch.minimum(d_t, d_b)) + 1
    return torch.clamp(d, min=1)


def zone_cc4_plain(lev, valid, heights, widths):
    """Plain version of K6: see ``zone_cc4``."""
    return (zone_labels_cc4_plain(lev, valid),
            border_distance_plain(lev, heights, widths))


def zone_list_plain(anc, lev, valid, dist=None):
    """Plain version of K7: scatter_add_ / scatter_reduce_("amin") into the
    same raster-seed layout (see ``zone_list``)."""
    B = anc.shape[0]
    A = math.prod(anc.shape[1:])
    vf = valid.reshape(B, -1).to(torch.bool)
    af = torch.where(vf, anc.reshape(B, -1).to(torch.int64), A)
    ok = vf & (af == torch.arange(A, device=anc.device))
    zeros = torch.zeros((), dtype=torch.int32, device=anc.device)
    size = torch.zeros((B, A + 1), dtype=torch.int32, device=anc.device)
    size.scatter_add_(1, af, vf.to(torch.int32))
    zlev = torch.where(ok, lev.reshape(B, -1).to(torch.int32), zeros)
    zsize = torch.where(ok, size[:, :A], zeros)
    zdist = None
    if dist is not None:
        dmin = torch.full((B, A + 1), _FAR, dtype=torch.int32,
                          device=anc.device)
        dmin.scatter_reduce_(1, af, dist.reshape(B, -1).to(torch.int32),
                             "amin")
        zdist = torch.where(ok, dmin[:, :A], zeros)
    return zlev, zsize, zdist, ok


# ---------------------------------------------------------------------------
# K5, K6, K7


# K5's warp path: columns a lane holds in registers (1, 2, 4 or 8, so rows
# of up to 256 pixels), ROIs (warps) a block at most, and the ROIs the card
# holds at one warp a block before blocks take more (132 SMs x 8)
DAG_COLS_MAX = 8
DAG_WARPS_MAX = 8
DAG_ONE_WARP_ROIS = 132 * 8


def zone_dag_plan(B: int, H: int, W: int):
    """(path, warps a row, ROIs a block, columns a lane) of K5's launch for
    B crops of H x W.  "warp": rows of at most 32 * DAG_COLS_MAX pixels, one
    warp a ROI and a row, lane j holding the C columns [jC, jC + C) (C the
    least power of two with 32 C >= W), one ROI a block up to
    DAG_ONE_WARP_ROIS ROIs and more beyond (at most DAG_WARPS_MAX).
    "block": wider rows, one block a ROI of 32 to 256 threads (the least
    power of two >= W, at most 256), warps a row = threads / 32, ROIs a
    block 1, columns a thread ceil(W / threads)."""
    if W <= 32 * DAG_COLS_MAX:
        C = 1
        while 32 * C < W:
            C *= 2
        R = min(DAG_WARPS_MAX, max(1, -(-B // DAG_ONE_WARP_ROIS)))
        return "warp", 1, R, C
    threads = 32
    while threads < W and threads < 256:
        threads *= 2
    return "block", threads // 32, 1, -(-W // threads)


def zone_labels(lev, valid):
    """GLSZM zone labels: K5 zone_dag (csrc/zone_dag.cu), replacing
    nyxus_tpu/ops/zones.py:32 zone_labels.

    lev: [B, H, W] int levels; valid: [B, H, W] participation mask.  Returns
    [B, H, W] int32: the raster index of each pixel's zone seed, BIG = H * W
    off ``valid``.  On the card one sweep of the rows, in one launch: a warp
    a ROI with the previous row in registers and a shuffle scan a row for
    rows of up to 256 pixels, else a block a ROI with the labels in device
    memory (``zone_dag_plan``).  Bound on the card: H dependent row
    steps."""
    if not _kernel_device(lev, "zone_dag"):
        return zone_labels_plain(lev, valid)
    _check_planes("zone_dag", lev, valid)
    lev = lev.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    B, H, W = lev.shape
    anc = torch.empty_like(lev)
    if lev.numel() == 0:
        return anc
    path, warps, R, C = zone_dag_plan(B, H, W)
    code = _build.lib().nyx_zone_dag(
        lev.data_ptr(), valid.data_ptr(), anc.data_ptr(), B, H, W,
        0 if path == "warp" else 1, C, R, 32 * warps,
        _build.stream_of(lev, "zone_dag"))
    _build.check("zone_dag", code)
    zone_labels.launches += 1
    return anc


zone_labels.launches = 0


def zone_dag_chain(B: int, H: int, device="cuda"):
    """K5's warp path with no loads: H dependent row steps (the edge
    shuffles, the ballot, the five-step scan and the carry) in B warps, one
    int32 a warp out.  Only for timing the floor of the sweep; not counted
    as a launch of K5."""
    out = torch.empty((B,), dtype=torch.int32, device=device)
    R = zone_dag_plan(B, H, 1)[2]
    code = _build.lib().nyx_zone_dag_chain(
        out.data_ptr(), B, H, R, _build.stream_of(out, "zone_dag_chain"))
    _build.check("zone_dag_chain", code)
    return out


# K6's tiled path: the tile side and its launch's shared memory (levels at
# an odd pitch, parents, valid bytes) and threads (its row and column
# launches run 256)
CC4_TILE = 64
CC4_TILE_SMEM = 4 * CC4_TILE * (CC4_TILE + 1) + 5 * CC4_TILE * CC4_TILE
CC4_TILE_THREADS = 512


def zone_cc4_plan(H: int, W: int):
    """(path, smem, threads) of K6's launch for H x W crops.  "smem": the
    crop's levels and parents (int32, rows of pitch W | 1) and its valid
    bytes in a block's shared memory, 8 * H * (W | 1) + H * W bytes, taken
    when that is at most SMEM_MAX (up to 160 x 160, 128 x 128, 256 x 64 or
    1024 x 16), with a warp a row or column, at most 1024 threads (the
    distance scans run a line a warp; fewer threads measured slower at
    every bucket, ``PERF.md``).  Larger crops (1024 x 64, 256 x 256) take
    the "tiled" path: CC4_TILE² tiles labelled in shared memory
    (CC4_TILE_SMEM bytes, CC4_TILE_THREADS threads), merged across their
    borders and flattened in device memory, three launches."""
    smem = 8 * H * (W | 1) + H * W
    if smem > SMEM_MAX:
        return "tiled", CC4_TILE_SMEM, CC4_TILE_THREADS
    return "smem", smem, min(1024, 32 * max(H, W))


def zone_cc4(lev, valid, heights, widths):
    """GLDZM zone labels and border distances: K6 zone_cc4
    (csrc/zone_cc4.cu), replacing nyxus_tpu/ops/zones.py:85
    zone_labels_cc4 and nyxus_tpu/ops/gldzm.py:35 border_distance.

    lev: [B, H, W] int levels (0 = zero level, as the GLDZM caller's
    ``where(valid, levels, 0)``; bucket padding beyond the AABB must be 0);
    valid: [B, H, W] participation mask; heights/widths: [B] AABB sizes.
    Returns (anc, dist), each [B, H, W] int32: anc the lowest raster index
    of each pixel's 4-connected same-level component (BIG = H * W off
    ``valid``), dist the dist2border.  ``valid`` is false beyond each
    AABB (the tiled path labels only the AABB).  On the card, where the
    crop fits shared memory (``zone_cc4_plan``), one block per ROI in one
    launch runs the union-find there and warps scan the rows and columns
    for the distance; larger crops take the tiled path in three launches:
    64² tiles labelled in shared memory, their borders merged and the rows'
    distances scanned a warp a row, then the labels flattened and the
    columns' distances scanned a warp a column.  Bound on the card:
    latency (dependent finds and scan steps), not bytes."""
    if not _kernel_device(lev, "zone_cc4"):
        return zone_cc4_plain(lev, valid, heights, widths)
    _check_planes("zone_cc4", lev, valid)
    B, H, W = lev.shape
    if heights.shape != (B,) or widths.shape != (B,) \
            or heights.device != lev.device or widths.device != lev.device:
        raise ValueError("zone_cc4: heights %s and widths %s must be [B] on "
                         "the levels' device" % (tuple(heights.shape),
                                                 tuple(widths.shape)))
    lev = lev.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    heights = heights.to(torch.int32).contiguous()
    widths = widths.to(torch.int32).contiguous()
    anc = torch.empty_like(lev)
    dist = torch.empty_like(lev)
    if lev.numel() == 0:
        return anc, dist
    path, smem, threads = zone_cc4_plan(H, W)
    code = _build.lib().nyx_zone_cc4(
        lev.data_ptr(), valid.data_ptr(), heights.data_ptr(),
        widths.data_ptr(), anc.data_ptr(), dist.data_ptr(), B, H, W,
        ("smem", "tiled").index(path), smem, threads,
        _build.stream_of(lev, "zone_cc4"))
    _build.check("zone_cc4", code)
    zone_cc4.launches += 1
    return anc, dist


zone_cc4.launches = 0


# K7's launch plan: threads a block at most; the cluster path's blocks a
# ROI at most, and the pixels a block aims at (a pass of 1024 threads of 4
# pixels, a grid block's most); the ROI size from which the grid path runs
# in place of a cluster (timed on the card, PERF.md), and the blocks a ROI
# the grid path aims at (two an SM of the card's 132)
ZS_THREADS_MAX = 1024
ZS_CLUSTER_MAX = 16
ZS_SLAB = 4096
ZS_GRID_PIXELS = 1 << 18
ZS_GRID_BLOCKS = 2 * 132


def zone_stats_slab(A: int, C: int) -> int:
    """Pixels (and labels) each of C blocks of a ROI of A pixels reads and
    owns: ceil(A / C) rounded up to a multiple of 4."""
    return (-(-A // C) + 3) // 4 * 4


def zone_stats_smem(S: int, has_dist: bool) -> int:
    """Shared memory of one ROI's (or cluster block's) S labels: the sizes
    (32-bit), the distance minima (32-bit) with ``has_dist``, a seed byte a
    label; each part 16-byte aligned."""
    return 4 * S + (4 * S if has_dist else 0) + (S + 15) // 16 * 16


def zone_stats_grid_plan(A: int):
    """K7's grid path for ROIs of A pixels: ("grid", blocks a ROI, threads,
    0), a thread a 4 pixels, the fewest whole warps a block that keep the
    ROI's blocks to ZS_GRID_BLOCKS, at most ZS_THREADS_MAX threads
    (ZS_SLAB pixels), the counters in the output buffers."""
    warps = min(ZS_THREADS_MAX // 32, max(1, -(-A // (128 * ZS_GRID_BLOCKS))))
    return "grid", -(-A // (128 * warps)), 32 * warps, 0


def zone_stats_plan(B: int, A: int, has_dist: bool):
    """(path, C, threads, smem) of K7's launch for B ROIs of A pixels.  C
    is the fewest blocks a ROI whose slabs' counters fit a block's
    SMEM_MAX, raised to ceil(A / ZS_SLAB) (at most ZS_CLUSTER_MAX) so that
    a large ROI spreads over SMs; a block has a thread (4 pixels) a slab
    pixel, at most ZS_THREADS_MAX.  "smem": C = 1, one block a ROI.
    "cluster": a cluster of C blocks a ROI.  "grid"
    (``zone_stats_grid_plan``): from ZS_GRID_PIXELS pixels a ROI, and
    wherever no cluster of ZS_CLUSTER_MAX blocks holds the counters.  B
    does not change the plan: at 300 x 32² two or three ROIs a block ran no
    faster than one (PERF.md)."""
    fit = next((c for c in range(1, ZS_CLUSTER_MAX + 1)
                if zone_stats_smem(zone_stats_slab(A, c), has_dist)
                <= SMEM_MAX), None)
    if fit is None or A >= ZS_GRID_PIXELS:
        return zone_stats_grid_plan(A)
    C = max(fit, min(ZS_CLUSTER_MAX, -(-A // ZS_SLAB)))
    S = zone_stats_slab(A, C)
    T = min(ZS_THREADS_MAX, 32 * max(1, -(-S // 128)))
    return ("cluster" if C > 1 else "smem"), C, T, zone_stats_smem(S, has_dist)


def zone_list(anc, lev, valid, dist=None):
    """Per-zone (level, size[, min dist]) lists: K7 zone_stats
    (csrc/zone_stats.cu), replacing nyxus_tpu/ops/zones.py:140 zone_list.

    anc: [B, ...] zone labels (seed raster index; >= prod(spatial) invalid);
    lev: [B, ...] levels; valid: participation mask; dist (optional):
    per-pixel int distance whose ZONE MINIMUM is wanted.

    Returns (zlev, zsize, zdist | None, ok): [B, A] int32 arrays (ok bool)
    in raster order of the zone seeds: position p holds zone p where ok[p]
    (p is valid and its own seed), zeros elsewhere.  The JAX package returns
    the same zones in sorted-label order.  On the card
    (``zone_stats_plan``): the counters of a ROI in a block's shared memory,
    or in a cluster's, in one launch, a warp's runs of one label each
    adding once; on the grid path, blocks of up to 4096 pixels, two an
    SM or more, adding a run once to the zeroed output buffers (the
    repeated runs of a zone from before the block summed in shared memory
    first, once a block), then a pass that keeps the seeds' counts.  No sort.  A < 2^31.  Bound on the card: bytes."""
    if not _kernel_device(anc, "zone_stats"):
        return zone_list_plain(anc, lev, valid, dist)
    B = anc.shape[0]
    for name, t in (("lev", lev), ("valid", valid), ("dist", dist)):
        if t is not None and (t.shape != anc.shape
                              or t.device != anc.device):
            raise ValueError("zone_stats: %s %s must match anc %s on one "
                             "device" % (name, tuple(t.shape),
                                         tuple(anc.shape)))
    A = math.prod(anc.shape[1:])
    if A >= 1 << 31:
        raise ValueError("zone_stats: %d pixels a ROI, at most 2^31 - 1"
                         % A)
    anc = anc.to(torch.int32).contiguous().reshape(B, A)
    lev = lev.to(torch.int32).contiguous().reshape(B, A)
    valid = valid.to(torch.bool).contiguous().reshape(B, A)
    zlev = torch.empty_like(anc)
    zsize = torch.empty_like(anc)
    ok = torch.empty((B, A), dtype=torch.bool, device=anc.device)
    zdist = None
    if dist is not None:
        dist = dist.to(torch.int32).contiguous().reshape(B, A)
        zdist = torch.empty_like(anc)
    if anc.numel() == 0:
        return zlev, zsize, zdist, ok
    path, C, T, smem = zone_stats_plan(B, A, dist is not None)
    ints = [anc, lev, zlev, zsize] + ([dist, zdist] if dist is not None
                                      else [])
    vec = A % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ints) \
        and valid.data_ptr() % 4 == 0 and ok.data_ptr() % 4 == 0
    code = _build.lib().nyx_zone_stats(
        anc.data_ptr(), lev.data_ptr(), valid.data_ptr(),
        0 if dist is None else dist.data_ptr(), zlev.data_ptr(),
        zsize.data_ptr(), 0 if zdist is None else zdist.data_ptr(),
        ok.data_ptr(), B, A, ("smem", "cluster", "grid").index(path),
        C, T, smem, int(vec),
        _build.stream_of(anc, "zone_stats"))
    _build.check("zone_stats", code)
    zone_list.launches += 1
    return zlev, zsize, zdist, ok


zone_list.launches = 0


# ---------------------------------------------------------------------------
# torch ops


def _invalid_key(keys):
    if keys.is_floating_point():
        return ~torch.isfinite(keys)
    return keys == torch.iinfo(keys.dtype).max


@counted
def grouped_weight_sums(keys, w):
    """For each element (in sorted-key order), the SUM of ``w`` over the
    elements sharing its key (nyxus_tpu/ops/zones.py:201).

    keys: [B, A], float with +inf for invalid entries, or integer with the
    dtype's maximum for invalid entries; w: [B, A], w >= 0.  Returns
    (sorted_keys, sorted_w, group_sums, valid) aligned with the sorted
    order.  A stable sort carries w; the group sums are one scatter_add_
    per segment and a gather back (the JAX package's gather-free scans were
    an XLA-on-TPU workaround)."""
    B, A = keys.shape
    ks, order = torch.sort(keys, dim=1, stable=True)
    ws = torch.gather(w, 1, order)
    v = ~_invalid_key(ks)
    is_start = torch.ones_like(v)
    is_start[:, 1:] = ks[:, 1:] != ks[:, :-1]
    seg = torch.cumsum(is_start.to(torch.int64), dim=1) - 1
    tot = torch.zeros_like(ws).scatter_add_(1, seg, ws)
    sums = torch.gather(tot, 1, seg)
    return ks, ws, torch.where(v, sums, torch.zeros_like(sums)), v


def cell_keys(w, major, minor, stride: int):
    """The (major, minor) cell key ``major * stride + minor`` of each counted
    zone (w > 0), as int64, with int64's maximum at the others: exact for
    every bucket, where the JAX package's key in the compute dtype stops
    being exact in float32 once it passes 2^24 (GLSZM at a 512 x 512 bucket
    and 64 levels) and then merges distinct cells."""
    key = major.round().to(torch.int64) * stride + minor.round().to(
        torch.int64)
    return torch.where(w > 0, key, torch.iinfo(torch.int64).max)


def zone_seeds_and_sizes(anc, valid):
    """(seed mask, zone size at seed) from zone labels
    (nyxus_tpu/ops/zones.py:181).  anc: [B, ...] labels (>= the spatial size
    off ``valid``); returns seed [B, ...] bool and size [B, ...] int32, the
    zone's pixel count, meaningful at seeds."""
    B = anc.shape[0]
    A = math.prod(anc.shape[1:])
    flat = anc.reshape(B, -1).to(torch.int64)
    ridx = torch.arange(A, device=anc.device)[None]
    counts = torch.zeros((B, A + 1), dtype=torch.int32, device=anc.device)
    counts.scatter_add_(1, torch.clamp(flat, max=A),
                        valid.reshape(B, -1).to(torch.int32))
    seed = valid & (flat == ridx).reshape(anc.shape)
    size = counts[:, :A].gather(1, torch.clamp(flat, max=A - 1))
    return seed, size.reshape(anc.shape)


def grouped_run_counts(keys):
    """For each valid element, the number of valid elements sharing its key
    (nyxus_tpu/ops/zones.py:245).  keys: [B, A], float with +inf (or
    integer with the dtype's maximum) at invalid entries.  Returns (sorted
    keys, counts, valid), aligned with the SORTED order."""
    B, A = keys.shape
    ks = torch.sort(keys, dim=1).values
    v = ~_invalid_key(ks)
    is_start = torch.ones_like(v)
    is_start[:, 1:] = ks[:, 1:] != ks[:, :-1]
    seg = torch.cumsum(is_start.to(torch.int64), dim=1) - 1
    size = torch.zeros((B, A), dtype=torch.int32, device=keys.device)
    size.scatter_add_(1, seg, torch.ones_like(seg, dtype=torch.int32))
    counts = size.gather(1, seg)
    return ks, torch.where(v, counts, 0), v
