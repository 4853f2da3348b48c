"""The launch plans of K1 ``batched_hist``, K2 ``glcm_cooc``, K3
``glrlm_runs``, K4
``neigh_matrix``, K5 ``zone_dag``, K7 ``zone_stats``, K8 ``erosion``, K9
``binary_quads``, K10 ``power_sums``, K11 ``gabor``, K12 ``zernike``, K13
``glcm3d_cooc``, K15 ``cc3d``, K16 ``stencil3d`` and K17 ``ih_stats``
(nyxus_tpu_torch/ops/common.py batched_hist_plan, neigh_matrix_plan,
ops/glcm.py glcm_cooc_plan, ops/glrlm.py glrlm_runs_plan, ops/zones.py zone_dag_plan, zone_stats_plan,
ops/binary.py erosion_plan, binary_quads_plan, ops/moments.py
power_sums_plan, ops/gabor.py gabor_plan, ops/zernike.py zernike_plan,
ops/texture3d.py glcm3d_plan, cc3d_plan, stencil3d_plan, ops/ih.py
ih_stats_plan; K1, K2, K3, K4, K5, K7, K8, K9, K10, K12 and K17 at the shapes
their own tests below name), checked in plain Python at every
bucket shape chip_smoke.py holds the kernels at (its CASES and CUBES), the
3D main path's 30 bucket shapes, the Gabor banks of chip_smoke.GABOR_BANKS
and 1 to 4096 grey levels: the shared memory a block asks for is within a
Hopper block's, clusters have at most 16 blocks, 16-bit counts and parents
are taken only where no cell can pass 65535, every AABB pixel or voxel is
owned by exactly one block (``gabor_blocks`` and ``glcm3d_bricks`` cut the
work as the kernels do), and the second path is taken exactly where the
first cannot hold the work.  No card and no JAX are needed."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig  # noqa: E402
from nyxus_tpu_torch.ops import binary as tbinary  # noqa: E402
from nyxus_tpu_torch.ops import common as tcommon  # noqa: E402
from nyxus_tpu_torch.ops import gabor as tgabor  # noqa: E402
from nyxus_tpu_torch.ops import glcm as tglcm  # noqa: E402
from nyxus_tpu_torch.ops import glrlm as tglrlm  # noqa: E402
from nyxus_tpu_torch.ops import ih as tih  # noqa: E402
from nyxus_tpu_torch.ops import moments as tmoments  # noqa: E402
from nyxus_tpu_torch.ops import texture3d as tt3  # noqa: E402
from nyxus_tpu_torch.ops import zernike as tzernike  # noqa: E402
from nyxus_tpu_torch.ops import zones as tzones  # noqa: E402
from nyxus_tpu_torch.ops.common import SMEM_MAX  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

BUCKETS_2D = sorted({(B, H, W) for B, H, W, _ in chip_smoke.CASES}
                    | {(3, 64, 128)})
BUCKETS_3D_SET = {c[1:] for c in chip_smoke.CUBES} | {(16, 16, 16),
                                                       (2, 255, 257)}
BUCKETS_3D = sorted(BUCKETS_3D_SET)


def _bank(name):
    cfg = EngineConfig(**chip_smoke.GABOR_BANKS[name])
    return cfg.gabor_kersize, 1 + len(cfg.gabor_thetas)


def _aabbs(H, W):
    """AABB sizes inside an H x W bucket: full, one pixel, one row, one
    column, and two in between."""
    return sorted({(H, W), (1, 1), (1, W), (H, 1),
                   (max(1, H // 2 + 1), max(1, W - 1)),
                   (max(1, H - 3), max(1, W // 3))})


@pytest.mark.parametrize("esz", [4, 8])
@pytest.mark.parametrize("bank", list(chip_smoke.GABOR_BANKS))
@pytest.mark.parametrize("bhw", BUCKETS_2D, ids=str)
def test_gabor_plan(bhw, bank, esz):
    B, H, W = bhw
    n, K = _bank(bank)
    path, C, P, KG, smem = tgabor.gabor_plan(B, H, W, n, K, esz)
    # every (KG, P) the plan weighs, and whether the cluster path holds it:
    # at most 16 blocks of threads over the strips and filter groups, the
    # taps and the largest window of a block within shared memory
    vec = 16 // esz
    fits = []
    for kg, p in ((K, 2), (K, 1), (-(-K // 2), 1), (1, 1)):
        G = -(-K // kg)
        strips = -(-W // p)
        c = -(-H * strips * G // tgabor.GABOR_THREADS)
        taps = n * n * (-(-2 * G * kg // vec) * vec) * esz
        rows = [tgabor.gabor_window_rows(sw, H, G) + n - 1
                for sw in range(1, strips + 1)]
        need = taps + max((r * (sw * p + n - 1)) * esz
                          for sw, r in zip(range(1, strips + 1), rows))
        if (K <= tgabor.GABOR_KMAX and c <= tgabor.GABOR_CLUSTER_MAX
                and max(rows) <= tgabor.GABOR_ROWS_MAX
                and need + tgabor.GABOR_STATIC_SMEM <= SMEM_MAX):
            fits.append((kg, p, c, need, B * H * strips * G))
    assert (path == "cluster") == bool(fits)
    if path == "tile":
        assert (C, P, KG, smem) == (0, 0, 0, 0)
        return
    # the first that fills the card, else the one with the most threads
    full = [f for f in fits if f[4] >= tgabor.GABOR_FILL_THREADS]
    assert (KG, P, C, smem) == (full[0] if full else fits[-1])[:4]
    assert 1 <= C <= tgabor.GABOR_CLUSTER_MAX and P in (1, 2)
    assert smem + tgabor.GABOR_STATIC_SMEM <= SMEM_MAX
    G = -(-K // KG)
    taps = n * n * (-(-2 * G * KG // vec) * vec) * esz
    for h, w in _aabbs(H, W):
        blocks = tgabor.gabor_blocks(h, w, P, KG, K, C)
        assert len(blocks) == C
        owned = np.zeros((G, h, w), np.int32)
        for px, rows in blocks:
            assert len({(y, x0 // P, g) for (y, x0), g in px}) \
                <= tgabor.GABOR_THREADS   # a thread a strip and group
            for (y, x), g in px:
                owned[g, y, x] += 1
            if rows is None:
                assert not px
                continue
            r0, r1 = rows
            assert all(r0 <= y <= r1 for (y, _), _ in px)
            assert r1 - r0 + 1 <= tgabor.gabor_window_rows(-(-w // P), H, G)
            window = (r1 - r0 + n) * (-(-w // P) * P + n - 1) * esz
            assert taps + window <= smem
        # every AABB pixel, of every filter group, in exactly one block
        assert (owned == 1).all()


def test_gabor_plan_paths_at_the_main_buckets():
    """The main path's buckets at the default bank run the cluster path:
    at 32^2 and 64^2 a thread computes all five filters at two pixels, at
    28 x 16^2 (too few pixels to fill the card) one filter at one pixel.
    128^2 and larger AABBs, the 160-tap bank and more than eight filters
    take the tile path."""
    plan = tgabor.gabor_plan
    assert plan(64, 32, 32, 16, 5, 4)[:4] == ("cluster", 2, 2, 5)
    assert plan(64, 64, 64, 16, 5, 4)[:4] == ("cluster", 8, 2, 5)
    assert plan(28, 16, 16, 16, 5, 4)[:4] == ("cluster", 5, 1, 1)
    assert plan(3, 64, 128, 16, 5, 8)[:2] == ("cluster", 16)
    for args in ((4, 128, 128, 16, 5, 4), (2, 256, 256, 16, 5, 4),
                 (2, 1024, 64, 16, 5, 4), (64, 32, 32, 160, 5, 4),
                 (64, 32, 32, 16, 9, 4)):
        assert plan(*args) == ("tile", 0, 0, 0, 0)


def test_gabor_tap_rows():
    """The cluster path's taps: row i * n + j holds tap (i, j)'s (re, im)
    of each filter in turn, then zeros up to a whole 16 bytes."""
    cfg = EngineConfig(**chip_smoke.GABOR_BANKS["n10x5"])
    bank = tgabor.filter_bank(cfg, torch.float32, "cpu")
    K, _, n, _ = bank.shape
    rows = tgabor.tap_rows(cfg, torch.float32, "cpu", 8)
    assert rows.shape == (n * n, 16)
    for i, j, f in ((0, 0, 0), (3, 7, 5), (n - 1, n - 1, 2)):
        assert rows[i * n + j, 2 * f] == bank[f, 0, i, j]
        assert rows[i * n + j, 2 * f + 1] == bank[f, 1, i, j]
    assert not rows[:, 2 * K:].any()


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("ng", [1, 8, 64, 256, 4096])
@pytest.mark.parametrize("cube", BUCKETS_3D, ids=str)
def test_glcm3d_plan(cube, ng, offset, symmetric):
    D, H, W = cube
    path, C, DG, T, Zb, Yb, narrow, smem = tt3.glcm3d_plan(ng, D, H, W,
                                                           offset, symmetric)
    halo = 2 * offset
    # the least a block can hold: one direction's counts and one row of a
    # brick with its halo
    least = (1 + halo) * (1 + halo) * (W + halo)
    if ng <= 255 and tt3.glcm3d_counts_bytes(ng, 1, False) + least \
            <= SMEM_MAX:
        assert path == "cluster"
    if ng > 255 or tt3.glcm3d_counts_bytes(ng, 1, True) + least > SMEM_MAX:
        assert path == "device"
    if path == "device":
        assert (C, DG, T, Zb, Yb, narrow, smem) == (0, 0, 0, 0, 0, False, 0)
        return
    assert 1 <= C <= tt3.GLCM3_CLUSTER_MAX and 1 <= DG <= 13
    assert T in (tt3.GLCM3_THREADS, tt3.GLCM3_WIDE_THREADS)
    assert 1 <= Zb <= D and 1 <= Yb <= H
    stage = (Zb + halo) * (Yb + halo) * (W + halo)
    assert smem == tt3.glcm3d_counts_bytes(ng, DG, narrow) + stage
    assert smem <= SMEM_MAX
    # the most directions that fit the aim (at least one)
    if DG < 13:
        assert tt3.glcm3d_counts_bytes(ng, DG + 1, narrow) + stage \
            > tt3.GLCM3_SMEM_AIM
    assert DG == 1 or smem <= tt3.GLCM3_SMEM_AIM
    for d, h, w in {(D, H, W), (1, 1, 1), (max(1, D // 2), H, max(1, W - 3)),
                    (D, max(1, H // 3), 1)}:
        bricks = tt3.glcm3d_bricks(d, h, w, C, Zb, Yb)
        assert len(bricks) == C
        owned = np.zeros((d, h), np.int32)
        most = 0
        for blk in bricks:
            vox = 0
            for z0, y0, zc, yc in blk:
                assert 1 <= zc <= Zb and 1 <= yc <= Yb
                owned[z0:z0 + zc, y0:y0 + yc] += 1
                vox += zc * yc * w
            most = max(most, vox)
        # every voxel (a whole row of x) in exactly one brick of one block
        assert (owned == 1).all()
        if (d, h, w) == (D, H, W):   # more threads for the longer walks
            assert T == (tt3.GLCM3_WIDE_THREADS
                         if most >= tt3.GLCM3_WIDE_VOXELS
                         else tt3.GLCM3_THREADS)
        if narrow:
            assert (2 if symmetric else 1) * most <= tt3.GLCM3_NARROW


def test_glcm3d_plan_main_cubes():
    """The main 3D bucket at 64 binned levels: a cluster of 4 blocks of
    eight planes for each ROI and direction, 16-bit counts; 64^3 clusters
    of 8 blocks of 512 threads; 8 levels, whose 13 matrices are small, put
    every direction in one block; raw 12-bit levels take the device-memory
    path; one 255 x 257 plane a block is the most a 16-bit count holds."""
    plan = tt3.glcm3d_plan
    assert plan(64, 32, 32, 32, 1)[:7] == ("cluster", 4, 1, 256, 8, 32, True)
    assert plan(64, 8, 8, 8, 1)[:7] == ("cluster", 1, 1, 256, 8, 8, True)
    assert plan(64, 64, 64, 64, 1)[:7] == ("cluster", 8, 1, 512, 8, 64,
                                           True)
    assert plan(8, 32, 32, 32, 1)[:4] == ("cluster", 4, 13, 256)
    assert plan(4096, 32, 32, 32, 1)[0] == "device"
    assert plan(8, 2, 255, 257, 1)[:7] == ("cluster", 2, 1, 512, 1, 255,
                                           True)
    assert plan(8, 2, 255, 257, 1, True)[6] is False


# the 3D main path's bucket shapes (D, H, W): the ROIs of
# chip_smoke.make_volume_3d(1) and (2), each padded up the batching ladder
MAIN_BUCKETS_3D = [
    (8, 8, 8), (8, 8, 16), (8, 8, 32), (8, 16, 8), (8, 16, 16), (8, 16, 32),
    (8, 32, 8), (8, 32, 16), (8, 32, 32), (16, 8, 8), (16, 8, 16),
    (16, 8, 32), (16, 16, 8), (16, 16, 16), (16, 16, 32), (16, 32, 8),
    (16, 32, 16), (16, 32, 32), (32, 8, 8), (32, 8, 16), (32, 8, 32),
    (32, 16, 8), (32, 16, 16), (32, 16, 32), (32, 32, 8), (32, 32, 16),
    (32, 32, 32), (64, 32, 64), (64, 64, 32), (64, 64, 64)]
PLAN_BUCKETS_3D = sorted(set(MAIN_BUCKETS_3D) | BUCKETS_3D_SET
                         | {(15, 17, 257), (16, 64, 64), (5, 7, 13),
                            (1, 1, 1), (16, 128, 128), (16, 128, 130)})


@pytest.mark.parametrize("dist", [False, True])
@pytest.mark.parametrize("B", [1, 8, 42])
@pytest.mark.parametrize("cube", PLAN_BUCKETS_3D, ids=str)
def test_cc3d_plan(cube, B, dist):
    D, H, W = cube
    path, C, Zs, T, wide, smem = tt3.cc3d_plan(B, D, H, W, dist)
    # 16-bit parents exactly while every global index and BIG fit them
    assert wide == (D * H * W > tt3.CC3_NARROW)
    # the cluster path exactly where slabs of one cluster's fewest planes
    # fit a block, and only with the distances
    cmax = min(tt3.CC3_CLUSTER_MAX, D)
    least = tt3.cc3d_smem(H, W, -(-D // cmax), wide, dist)
    assert (path == "cluster") == (least <= SMEM_MAX and dist)
    if path == "device":
        assert (C, Zs, T, smem) == (0, 0, 0, 0)
        return
    assert 1 <= C <= tt3.CC3_CLUSTER_MAX and 1 <= Zs <= D
    # every plane in exactly one block, every block at least one plane
    assert C * Zs >= D and (C - 1) * Zs < D
    assert smem == tt3.cc3d_smem(H, W, Zs, wide, dist) <= SMEM_MAX
    # a thread a voxel of the slab, at most CC3_THREADS_MAX
    assert T == min(tt3.CC3_THREADS_MAX, 32 * -(-Zs * H * W // 32))
    # no more blocks than fill the card, nor than give each CC3_MIN_VOXELS,
    # unless a slab of fewer planes would not fit
    first = max(1, min(cmax, -(-tt3.CC3_FILL // B),
                       -(-D * H * W // tt3.CC3_MIN_VOXELS)))
    if C > first:
        assert tt3.cc3d_smem(H, W, -(-D // (C - 1)), wide, dist) > SMEM_MAX


def test_cc3d_plan_main_path_and_limits():
    """Every main-path bucket takes the cluster path, one launch, for
    6-connected labels with the distances (GLDZM), and the device-memory
    path for the labels alone (GLSZM); with the distances 8 x 32^3 clusters
    of 16 blocks of two planes, 42 x 16^3 of 8 blocks of two planes, 2 x
    64^3 of 16 blocks of four planes with 32-bit parents; the 16/32-bit
    parent boundary at 65535 voxels; the 64 x 256 x 256 crop, whose planes
    do not fit, the device-memory path; 16 x 128 x 128 fits a block (one
    plane a block) where 16 x 128 x 130 does not."""
    plan = tt3.cc3d_plan
    for D, H, W in MAIN_BUCKETS_3D:
        for B in (1, 2, 42):
            assert plan(B, D, H, W, True)[0] == "cluster"
            assert plan(B, D, H, W)[0] == "device"
    assert plan(8, 32, 32, 32, True)[:5] == ("cluster", 16, 2, 1024, False)
    assert plan(42, 16, 16, 16, True)[:5] == ("cluster", 8, 2, 512, False)
    assert plan(2, 64, 64, 64, True)[:5] == ("cluster", 16, 4, 1024, True)
    assert plan(1, 15, 17, 257, True)[4] is False      # 65535 voxels
    assert plan(1, 16, 64, 64, True)[4] is True        # 65536 voxels
    assert plan(1, 64, 256, 256)[0] == "device"
    assert plan(1, 64, 256, 256, True)[0] == "device"
    assert plan(1, 16, 128, 128, True)[:3] == ("cluster", 16, 1)
    assert plan(1, 16, 128, 130, True)[0] == "device"


@pytest.mark.parametrize("halo", [0, 1, 2, 3])
@pytest.mark.parametrize("B", [1, 8, 42])
@pytest.mark.parametrize("cube", PLAN_BUCKETS_3D, ids=str)
def test_stencil3d_plan(cube, B, halo):
    D, H, W = cube
    path, Zt, Yt, T, smem = tt3.stencil3d_plan(B, D, H, W, halo)
    assert (path == "slab") == (1 <= halo <= tt3.STENCIL3_HALO_MAX)
    if path == "voxel":
        assert (Zt, Yt, T, smem) == (0, 0, 0, 0)
        return
    assert 1 <= Zt <= min(D, tt3.STENCIL3_TILE)
    assert 1 <= Yt <= min(H, tt3.STENCIL3_TILE)
    assert smem == tt3.stencil3d_smem(W, Zt, Yt, halo) <= SMEM_MAX
    assert smem <= tt3.STENCIL3_SMEM_AIM or (Zt, Yt) == (1, 1)
    # each side the tile aim halved some times (ceilings)
    for side, n in ((Zt, min(D, tt3.STENCIL3_TILE)),
                    (Yt, min(H, tt3.STENCIL3_TILE))):
        sizes = {n}
        while n > 1:
            n = -(-n // 2)
            sizes.add(n)
        assert side in sizes
    # halved only while the batch had fewer than STENCIL3_FILL blocks (or
    # the tile passed the aim), down to sides of 2
    blocks = B * -(-D // Zt) * -(-H // Yt)
    full = (min(D, tt3.STENCIL3_TILE), min(H, tt3.STENCIL3_TILE))
    if (Zt, Yt) != full and smem * 4 <= tt3.STENCIL3_SMEM_AIM:
        assert blocks <= 4 * tt3.STENCIL3_FILL
    assert blocks >= tt3.STENCIL3_FILL or max(Zt, Yt) <= 2 \
        or (Zt, Yt) == full
    # a thread a column of the tile, at most STENCIL3_THREADS
    assert T % 32 == 0 and T == min(tt3.STENCIL3_THREADS,
                                     32 * -(-Yt * W // 32))


def test_stencil3d_plan_main_path():
    """Every main-path bucket takes the slab path, one launch, for the N26
    and N24 tables (halo 1) and windows of radius 1 and 2; the shift tables
    the slab path counts (unit shifts, each once) carry their mask, others
    (a shift of two voxels, a repeated shift, none) take the voxel path."""
    for D, H, W in MAIN_BUCKETS_3D:
        for B in (1, 2, 42):
            for halo in (1, 2):
                assert tt3.stencil3d_plan(B, D, H, W, halo)[0] == "slab"
    _, n26, m26 = tt3._stencil3d_table(tt3.N26)
    _, n24, m24 = tt3._stencil3d_table(tt3.N24_NGLDM)
    assert (n26, m26) == (26, 0x7ffffff & ~(1 << 13))
    assert (n24, m24) == (24, m26 & ~((1 << 4) | (1 << 22)))
    assert tt3._stencil3d_table(tt3.N26) is tt3._stencil3d_table(tt3.N26)
    assert tt3._stencil3d_table(tt3.N6)[2] == sum(
        1 << ((dz + 1) * 9 + (dy + 1) * 3 + dx + 1) for dz, dy, dx in tt3.N6)
    for table in ([(0, 0, 2)], [(0, 0, 1), (0, 0, 1)], []):
        assert tt3._stencil3d_table(table)[2] == -1


# K5's shapes (B, H, W): the main buckets, the long ROI, an 8192-wide and an
# 8192-high rectangle, the warp path's widest rows and the block path's
# narrowest, the batching ladder's ends, and the widths the card tests hold
DAG_SHAPES = sorted({(64, 32, 32), (47, 64, 64), (28, 16, 16), (1, 1024, 64),
                     (2, 16, 8192), (1, 8192, 64), (2, 17, 256),
                     (2, 17, 257), (2, 16, 1024), (2, 1, 200), (4, 8, 8),
                     (1, 8192, 8192), (5000, 32, 32), (20000, 16, 16)}
                    | {(3, 17, w) for w in (1, 8, 33, 63, 96, 99, 130)})


@pytest.mark.parametrize("bhw", DAG_SHAPES, ids=str)
def test_zone_dag_plan(bhw):
    """The warp path exactly for rows of at most 32 * DAG_COLS_MAX pixels,
    with the fewest columns a lane (a power of two) that cover the row,
    every column in exactly one lane's range; at most DAG_WARPS_MAX ROIs a
    block and one while the card holds the batch a warp a block; the block
    path's threads cover the row in chunks of ceil(W / threads) columns.
    No cluster, and only the block path's static 1280 bytes of shared
    memory."""
    B, H, W = bhw
    path, warps, R, C = tzones.zone_dag_plan(B, H, W)
    assert (path == "warp") == (W <= 32 * tzones.DAG_COLS_MAX)
    if path == "warp":
        assert warps == 1 and C in (1, 2, 4, 8)
        assert 32 * C >= W and (C == 1 or 16 * C < W)
        owners = [x // C for x in range(W)]      # lane j: [jC, jC + C)
        assert all(0 <= o < 32 for o in owners)
        assert sorted(set(range(W))) == sorted(
            x for j in range(32) for x in range(j * C, min(W, j * C + C)))
        assert 1 <= R <= tzones.DAG_WARPS_MAX
        assert (R == 1) == (B <= tzones.DAG_ONE_WARP_ROIS)
        assert -(-B // R) * R >= B
    else:
        T = 32 * warps
        assert R == 1 and T in (32, 64, 128, 256)
        assert T * C >= W and (T == 256 or T >= W)
        assert C == -(-W // T)
        assert (256 * 4 + 256) <= SMEM_MAX       # sv and sc


def test_zone_dag_plan_main_path():
    """Every bucket of the main path (sides of the ladder up to 256) and the
    long ROI's 1024 x 64 take the warp path; one column a lane at 32 and 16
    wide, two at 64."""
    assert tzones.zone_dag_plan(64, 32, 32) == ("warp", 1, 1, 1)
    assert tzones.zone_dag_plan(28, 16, 16) == ("warp", 1, 1, 1)
    assert tzones.zone_dag_plan(47, 64, 64) == ("warp", 1, 1, 2)
    assert tzones.zone_dag_plan(1, 1024, 64) == ("warp", 1, 1, 2)
    for w in (8, 16, 32, 64, 128, 256):
        assert tzones.zone_dag_plan(225, 8192, w)[0] == "warp"
    assert tzones.zone_dag_plan(2, 16, 1024) == ("block", 8, 1, 4)


def _hist_shapes():
    """K1's (B, A, nbins): the main buckets' histograms (100 and 64 bins,
    NGTDM's 65, GLDM's 64 x 9) at 64 x 32², 47 x 64² and 28 x 16²; the long
    ROI's 1024 x 64 row; an 8192-wide rectangle; the 3D 8 x 32³ rows of
    four first-design chunks; GLDM's raw 4096 x 27 cells at 8 x 32³; IH's
    32768 bins; 1,000,000 bins (beyond 16 blocks); one entry; 91 entries."""
    out = set()
    for B, A in ((64, 1024), (47, 4096), (28, 256)):
        for nb in (100, 64, 65, 576):
            out.add((B, A, nb))
    out |= {(2, 65536, 64), (1, 16 * 8192, 100), (1, 8192 * 8192, 64),
            (8, 32768, 64), (8, 32768, 4096 * 27), (64, 1024, 32768),
            (2, 4096, 1000000), (1, 1, 5), (5, 91, 40), (42, 4096, 4097)}
    return sorted(out)


@pytest.mark.parametrize("esz", [4, 8])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", _hist_shapes(), ids=str)
def test_batched_hist_plan(shape, C, esz):
    """Shared memory within a Hopper block's; clusters of at most
    HIST_CLUSTER blocks, no more than a row needs at one step a thread (at
    HIST_SPLIT_CHUNK entries a block where the bins are split);
    every entry of a row in exactly one block's chunk; the row's bins cut
    into slices of L, one slice (the smem path) exactly where a block holds
    the C x nbins bins, else the fewest that fit or more up to
    HIST_SPLIT_FILL while the batch leaves SMs idle; every bin of every
    channel in exactly one slice, and within a slice written by exactly one
    block of its cluster."""
    B, A, nbins = shape
    path, S, chunk, threads, copies, L, smem = tcommon.batched_hist_plan(
        B, A, nbins, C, esz)
    assert smem == copies * C * L * esz <= SMEM_MAX
    per_block = tcommon.HIST_THREADS * tcommon.HIST_STEP if path == "smem" \
        else tcommon.HIST_SPLIT_CHUNK
    assert S == max(1, min(tcommon.HIST_CLUSTER, -(-A // per_block)))
    # chunks: block r of a cluster counts [r * chunk, (r + 1) * chunk)
    assert chunk % tcommon.HIST_STEP == 0
    ranges = [(min(A, r * chunk), min(A, r * chunk + chunk))
              for r in range(S)]
    assert sum(b - a for a, b in ranges) == A
    assert all(ranges[r][1] == ranges[r + 1][0] for r in range(S - 1))
    assert ranges[0][0] == 0 and ranges[-1][1] == A
    # threads: a power of two from 64 covering a chunk in one step of
    # HIST_STEP entries, or all of HIST_THREADS
    assert threads in (64, 128, 256, 512, 1024)
    assert threads * tcommon.HIST_STEP >= chunk \
        or threads == tcommon.HIST_THREADS
    assert copies >= 1 and copies & (copies - 1) == 0
    assert copies <= threads // 32
    slices = -(-nbins // L)
    assert (path == "smem") == (slices == 1) == (C * nbins * esz <= SMEM_MAX)
    if path == "smem":
        assert copies * C * nbins * esz <= max(tcommon.HIST_COPY_BYTES,
                                               C * nbins * esz)
    else:
        fits = [k for k in range(1, slices + 1)
                if C * -(-nbins // k) * esz <= SMEM_MAX]
        assert copies == 1 and slices == max(fits[0], min(
            tcommon.HIST_SPLIT_FILL, -(-tcommon.SMS // (B * S))))
    # bins: slice k holds [k * L, (k + 1) * L); in it, cluster block r
    # writes [r * Lr, (r + 1) * Lr) with Lr = ceil(n / S)
    owned = []
    for k in range(slices):
        n = min(L, nbins - k * L)
        Lr = -(-n // S)
        owned += [k * L + j for r in range(S)
                  for j in range(r * Lr, min(n, r * Lr + Lr))]
    assert owned == list(range(nbins))


def test_batched_hist_plan_main_path():
    """The main bucket's histograms take one block of 256 threads a row
    with a copy of the bins a warp; NGTDM's three channels the same; 47 x
    64^2 one block of 1024 threads; the 3D 8 x 32^3 rows a cluster of 8
    blocks (one launch, no zeroing launch); GLDM's raw 4096 x 27 cells at
    8 x 32^3 sixteen slices of one block a row (f32 and f64), at 2 x 64^3
    nine slices of a cluster of 8; the long ROI's rows clusters of 8."""
    plan = tcommon.batched_hist_plan
    assert plan(64, 1024, 100, 1, 4) == ("smem", 1, 1024, 256, 8, 100, 3200)
    assert plan(64, 1024, 65, 3, 4)[:5] == ("smem", 1, 1024, 256, 8)
    assert plan(47, 4096, 100, 1, 4)[:4] == ("smem", 1, 4096, 1024)
    assert plan(28, 256, 100, 1, 4)[:4] == ("smem", 1, 256, 64)
    assert plan(8, 32768, 64, 1, 4)[:4] == ("smem", 8, 4096, 1024)
    assert plan(2, 65536, 64, 1, 4)[:3] == ("smem", 8, 8192)
    for esz in (4, 8):
        assert plan(8, 32768, 4096 * 27, 1, esz)[:6] == (
            "split", 1, 32768, 1024, 1, 6912)
    assert plan(2, 262144, 4096 * 27, 1, 4)[:2] == ("split", 8)
    assert -(-4096 * 27 // plan(2, 262144, 4096 * 27, 1, 4)[5]) == 9


# K3's (B, H, W, ng, nr): the main path's three buckets at 64 levels, IBSI's
# 256 levels at 64 x 32², raw 12-bit levels (4096), the long ROI's 2 x 1024
# x 64 and 2 x 256² at 64 levels, 3 x 7 x 13; and 2048 levels (16-bit
# counts), 256 levels on the long ROI, an 8192-long column (too long a crop
# to stage) and 70000 levels (32-bit codes)
RUNS_SHAPES = [(64, 32, 32, 64, 32), (47, 64, 64, 64, 64),
               (28, 16, 16, 64, 16), (64, 32, 32, 256, 32),
               (64, 32, 32, 4096, 32), (2, 1024, 64, 64, 1024),
               (2, 256, 256, 64, 256), (3, 7, 13, 64, 13),
               (2, 32, 32, 2048, 32), (2, 1024, 64, 256, 1024),
               (1, 8192, 64, 16, 8192), (1, 64, 64, 70000, 64)]


@pytest.mark.parametrize("esz", [4, 8])
@pytest.mark.parametrize("shape", RUNS_SHAPES, ids=str)
def test_glrlm_runs_plan(shape, esz):
    """One (ROI, angle) a block; the crop staged as 16-bit codes below
    65535 levels (32-bit above) or, where it does not fit, read from device
    memory; the counts in 32-bit shared memory, else 16-bit shared memory
    where H * W <= 65535, each first with the crop staged and then without,
    else in device memory: the plan is the first of those that fits a
    Hopper block's shared memory, the same for both element sizes, and its
    layout is glrlm_runs_layout's: a row stride that keeps a column's warp
    on 32 banks and 16-byte aligned counts before the crop."""
    B, H, W, ng, nr = shape
    plan = tglrlm.glrlm_runs_plan(B, H, W, ng, nr, esz)
    assert plan == tglrlm.glrlm_runs_plan(B, H, W, ng, nr, 4)
    path, code, bits, rois, smem = plan
    assert rois == 1 and smem <= SMEM_MAX
    assert bits == (16 if path == "smem16" else 32)
    assert bits == 32 or H * W <= 65535
    full = 16 if ng < 65535 else 32
    assert code in (full, 0)
    options = [("smem32", full), ("smem16", full), ("smem32", 0),
               ("smem16", 0), ("device", full), ("device", 0)]
    fits = [(p, c) for p, c in options
            if (p != "smem16" or H * W <= 65535)
            and tglrlm.glrlm_runs_layout(H, W, ng, nr, p, c)[2] <= SMEM_MAX]
    assert (path, code) == fits[0]
    ws, cnt, total = tglrlm.glrlm_runs_layout(H, W, ng, nr, path, code)
    assert total == smem and cnt % 16 == 0
    assert cnt >= {"smem32": 4 * ng * nr, "smem16": 2 * ng * nr,
                   "device": 0}[path]
    assert smem == cnt + H * ws * code // 8
    assert ws >= W
    if code == 16:
        assert ws % 4 != 0 and (ws % 2 == 1 or (ws // 2) % 2 == 1)
    elif code == 32:
        assert ws % 2 == 1


def test_glrlm_runs_plan_main_path():
    """The main buckets and IBSI's 256 levels count in 32-bit shared memory
    beside the staged 16-bit crop (a row stride of W + 2); 2048 levels at
    32² in 16-bit counts; raw 12-bit levels and the long ROI's 64 x 1024
    matrices in device memory with the crop staged; 2 x 256² keeps shared
    memory (64 KB of counts, 129 KB of crop)."""
    plan = tglrlm.glrlm_runs_plan
    assert plan(64, 32, 32, 64, 32, 4) == ("smem32", 16, 32, 1,
                                           4 * 64 * 32 + 2 * 32 * 34)
    assert plan(47, 64, 64, 64, 64, 4) == ("smem32", 16, 32, 1,
                                           4 * 64 * 64 + 2 * 64 * 66)
    assert plan(28, 16, 16, 64, 16, 4) == ("smem32", 16, 32, 1,
                                           4 * 64 * 16 + 2 * 16 * 18)
    assert plan(64, 32, 32, 256, 32, 8) == ("smem32", 16, 32, 1,
                                            4 * 256 * 32 + 2 * 32 * 34)
    assert plan(2, 32, 32, 2048, 32, 4) == ("smem16", 16, 16, 1,
                                            2 * 2048 * 32 + 2 * 32 * 34)
    assert plan(64, 32, 32, 4096, 32, 4) == ("device", 16, 32, 1,
                                             2 * 32 * 34)
    assert plan(2, 1024, 64, 64, 1024, 4) == ("device", 16, 32, 1,
                                              2 * 1024 * 66)
    assert plan(2, 256, 256, 64, 256, 4) == ("smem32", 16, 32, 1,
                                             4 * 64 * 256 + 2 * 256 * 258)
    assert plan(1, 8192, 64, 16, 8192, 4) == ("device", 0, 32, 1, 0)


# K9's (B, H, W): the main path's three buckets, the long ROI's, 2 x 256²,
# 3 x 7 x 13, a row and a column past the 32-bit warp path and past the
# warp path, an 8192² crop (beyond shared memory) and a large batch of 32²
# masks
QUADS_SHAPES = [(64, 32, 32), (47, 64, 64), (28, 16, 16), (2, 1024, 64),
                (2, 256, 256), (3, 7, 13), (1, 1, 33), (1, 33, 1),
                (1, 1, 65), (1, 65, 1), (1, 8192, 8192), (5000, 32, 32),
                (3, 64, 128)]


@pytest.mark.parametrize("shape", QUADS_SHAPES, ids=str)
def test_binary_quads_plan(shape):
    """The warp path exactly where H and W are at most 64 (one 32-bit word
    a row up to 32 x 32, else two), with as many ROIs a block as keep
    every SM busy (at most QUADS_WARP_ROIS); else one ROI a block,
    ceil(W / 32) words a row, the block path where its two
    buffers fit a Hopper block's shared memory beside the count slots, the
    device path otherwise; every level of the pyramid fits the buffer it is
    built in (odd levels the first, even levels the second)."""
    B, H, W = shape
    path, rois, words, smem = tbinary.binary_quads_plan(B, H, W)
    warp = H <= 64 and W <= 64
    assert (path == "warp") == warp
    if warp:
        assert (words, smem) == (1 if H <= 32 and W <= 32 else 2, 0)
        assert rois == min(tbinary.QUADS_WARP_ROIS,
                           max(1, -(-B // tcommon.SMS)))
        return
    nw = -(-W // 32)
    assert rois == 1 and words == nw
    need = 4 * tbinary.binary_quads_words(H, W)
    fits = need + tbinary.QUADS_STATIC_SMEM <= SMEM_MAX
    assert path == ("block" if fits else "device")
    assert smem == (need if fits else 0)
    first, second = H * nw, tbinary.binary_quads_words(H, W) - H * nw
    gh, gw = H, W
    for level in range(tbinary.n_scales(H, W)[1]):
        size = gh * -(-gw // 32)
        assert size <= (first if level % 2 == 0 else second)
        gh, gw = -(-gh // 2), -(-gw // 2)


def test_binary_quads_plan_main_path():
    """The main buckets a warp a ROI, one ROI a block (64, 47 and 28 blocks
    of one warp), 64 x 64 in 64-bit words; the long ROI's 1024 x 64 and
    256² a block a ROI with the bit rows in shared memory; an 8192² crop in
    device memory."""
    plan = tbinary.binary_quads_plan
    assert plan(64, 32, 32) == ("warp", 1, 1, 0)
    assert plan(28, 16, 16) == ("warp", 1, 1, 0)
    assert plan(3, 7, 13) == ("warp", 1, 1, 0)
    assert plan(47, 64, 64) == ("warp", 1, 2, 0)
    assert plan(3, 64, 128) == ("block", 1, 4, 4 * (64 * 4 + 32 * 2))
    assert plan(2, 1024, 64) == ("block", 1, 2, 4 * (1024 * 2 + 512 * 1))
    assert plan(2, 256, 256) == ("block", 1, 8, 4 * (256 * 8 + 128 * 4))
    assert plan(1, 8192, 8192) == ("device", 1, 256, 0)


# K10's and K12's (B, H, W): every bucket of chip_smoke.CASES (2 x 256² and
# 2 x 1024 x 64 among them), 1 x 1024 x 64, a 64 x 128 bucket and an 8192²
# crop (beyond a cluster's shared memory)
MOMENT_SHAPES = sorted({(B, H, W) for B, H, W, _ in chip_smoke.CASES}
                       | {(1, 1024, 64), (3, 64, 128), (1, 8192, 8192)})


def _each_pixel_once(A, C, chunk):
    """Block r of C taking pixels [r * chunk, (r + 1) * chunk): the blocks'
    ranges are disjoint and contiguous, so each of A pixels is owned once
    exactly when they reach A and the last one starts inside it."""
    return C * chunk >= A and (C - 1) * chunk < max(A, 1)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("esz", [4, 8])
@pytest.mark.parametrize("shape", MOMENT_SHAPES, ids=str)
def test_power_sums_plan(shape, esz, P):
    """K10: at most 16 blocks a (ROI, plane, centre), each owning a pixel
    and every pixel owned by one; the staged chunk and the static shared
    memory within a Hopper block's; the plane staged exactly where its
    chunk fits; one block a (ROI, plane, centre) wherever a crop of at
    most PS_FILL_PX pixels fits, more for larger crops while the batch's P
    + 1 blocks a ROI leave SMs idle; threads a power of two from 64 to
    PS_THREADS taking a chunk at PS_PX pixels a thread where they can."""
    B, H, W = shape
    A = H * W
    path, C, chunk, threads, smem = tmoments.power_sums_plan(B, H, W, esz, P)
    assert 1 <= C <= tmoments.PS_CLUSTER
    assert _each_pixel_once(A, C, chunk)
    room = SMEM_MAX - tmoments.PS_STATIC_SMEM
    assert smem + tmoments.PS_STATIC_SMEM <= SMEM_MAX
    assert (path == "staged") == (chunk * esz <= room)
    assert smem == (chunk * esz if path == "staged" else 0)
    if A * esz <= room and A <= tmoments.PS_FILL_PX:
        assert C == 1
    if A > tmoments.PS_FILL_PX and C < tmoments.PS_CLUSTER:
        assert B * (P + 1) * C >= tcommon.SMS   # fills the card
    assert threads in (64, 128, 256) and threads <= tmoments.PS_THREADS
    assert threads == tmoments.PS_THREADS or threads * tmoments.PS_PX >= chunk
    assert threads == 64 or threads // 2 * tmoments.PS_PX < chunk


def test_power_sums_plan_main_path():
    """The main buckets one staged block a (ROI, plane, centre), a launch a
    call: 4 KB of plane at 32² f32, 16 KB at 64² (32 KB in f64); 2 x 256²
    a cluster of 14 blocks (140 for 132 SMs) and the long ROI's 1 x 1024 x
    64 of 16; an 8192² crop unstaged."""
    plan = tmoments.power_sums_plan
    assert plan(64, 32, 32, 4) == ("staged", 1, 1024, 256, 4096)
    assert plan(47, 64, 64, 4) == ("staged", 1, 4096, 256, 16384)
    assert plan(47, 64, 64, 8) == ("staged", 1, 4096, 256, 32768)
    assert plan(28, 16, 16, 4) == ("staged", 1, 256, 64, 1024)
    assert plan(2, 256, 256, 4) == ("staged", 14, 4682, 256, 18728)
    assert plan(1, 1024, 64, 8) == ("staged", 16, 4096, 256, 32768)
    assert plan(64, 32, 32, 4, 2)[:2] == ("staged", 1)
    assert plan(1, 8192, 8192, 4)[:3] == ("global", 16, 8192 * 8192 // 16)


@pytest.mark.parametrize("shape", MOMENT_SHAPES
                         + [(132, 32, 32), (133, 32, 32), (225, 32, 32)],
                         ids=str)
def test_zernike_plan(shape):
    """K12: at most ZK_CLUSTER (8) blocks a ROI, each owning a pixel and
    every pixel owned by one, a chunk a whole number of pixels a thread,
    the static shared memory within a Hopper block's; the batch in one
    wave of a block an SM where it can (more blocks only while they fit
    the SMs and each thread keeps a pixel), one block a ROI where it
    cannot.  The element size does not enter: a block takes an SM's
    registers in both types."""
    B, H, W = shape
    A = H * W
    C, chunk = tzernike.zernike_plan(B, H, W)
    T = tzernike.ZK_THREADS
    assert 1 <= C <= tzernike.ZK_CLUSTER
    assert chunk % T == 0 and _each_pixel_once(A, C, chunk)
    assert tzernike.ZK_STATIC_SMEM <= SMEM_MAX
    assert B * C <= tcommon.SMS or C == 1
    if C < tzernike.ZK_CLUSTER and chunk > T:
        assert B * (C + 1) > tcommon.SMS   # one more block a ROI would not fit


def test_zernike_plan_main_path():
    """One launch a call at the main buckets, in one wave: 64 x 32² a
    cluster of two blocks a ROI (two pixels a thread, 128 blocks for 132
    SMs), 47 x 64² two (eight pixels a thread), 28 x 16² one block a ROI
    (a pixel a thread); 2 x 256² and 1 x 1024 x 64 eight; a slide's 225 x
    32² one block a ROI in two waves."""
    plan = tzernike.zernike_plan
    assert plan(64, 32, 32) == (2, 512)
    assert plan(47, 64, 64) == (2, 2048)
    assert plan(28, 16, 16) == (1, 256)
    assert plan(2, 256, 256) == (8, 8192)
    assert plan(1, 1024, 64) == (8, 8192)
    assert plan(225, 32, 32) == (1, 1024)


# K7's (B, A, label shape): the main path's three 2D buckets, 5 x 32², 3 x
# 7 x 13, the long ROI's 1024 x 64 and 2 x 256², a large batch of 32²
# ROIs, the 3D cubes 8³ to 64³ and the 64 x 256 x 256 crop, A = 65535
# against 65536 and 65537 (16 slabs), the largest ROI of 4096-pixel slabs,
# the largest ROI a 16-block cluster holds with and without the distances
# (413184 and 743808 pixels) against the next, the grid path's threshold
# and the pixel before it, 1024 x 512, the whole-slide 2048² bucket, the
# whole-volume crop 128 x 512 x 512 and the largest A
ZS_SHAPES = [(64, 1024), (47, 4096), (28, 256), (5, 1024), (3, 91),
             (2, 65536), (500, 1024), (64, 512), (32, 4096), (8, 32768),
             (2, 262144), (1, 64 * 256 * 256), (1, 65535), (1, 65536),
             (1, 65537), (1, 16 * 4096), (1, 16 * 4096 + 1), (1, 413184),
             (1, 413185), (1, 743808), (1, 743809), (2, 4097), (1, 1),
             (1, 3), (1, tzones.ZS_GRID_PIXELS - 1),
             (2, tzones.ZS_GRID_PIXELS), (1, 1024 * 512),
             (1, 2048 * 2048), (1, 128 * 512 * 512), (1, 2 ** 31 - 1)]


@pytest.mark.parametrize("has_dist", [False, True])
@pytest.mark.parametrize("shape", ZS_SHAPES, ids=str)
def test_zone_stats_plan(shape, has_dist):
    """K7: 32-bit sizes and minima; the fewest blocks a ROI whose slabs'
    counters fit a Hopper block's shared memory (slabs of a multiple of 4
    pixels, every pixel owned by one block), raised to a block a ZS_SLAB
    pixels up to 16; one block a ROI on the smem path whatever the batch,
    a cluster beyond one block, the grid path from ZS_GRID_PIXELS pixels
    and wherever no 16-block cluster holds the counters; a thread a 4
    pixels of a slab, at most 1024."""
    B, A = shape
    plan = tzones.zone_stats_plan(B, A, has_dist)
    assert all(tzones.zone_stats_plan(b, A, has_dist) == plan
               for b in (1, 1000))
    path, C, T, smem = plan
    fits = [c for c in range(1, 17) if tzones.zone_stats_smem(
        tzones.zone_stats_slab(A, c), has_dist) <= SMEM_MAX]
    if not fits or A >= tzones.ZS_GRID_PIXELS:
        assert plan == tzones.zone_stats_grid_plan(A)
        return
    assert C == max(fits[0], min(16, -(-A // tzones.ZS_SLAB)))
    S = tzones.zone_stats_slab(A, C)
    assert S % 4 == 0 and C * S >= A and (C - 1) * S < A + 4 * C
    assert smem == tzones.zone_stats_smem(S, has_dist) \
        == 4 * S + (4 * S if has_dist else 0) + (S + 15) // 16 * 16
    assert T == min(1024, 32 * -(-S // 128)) and smem <= SMEM_MAX
    assert path == ("cluster" if C > 1 else "smem")


def test_zone_stats_plan_main_path():
    """The main buckets one block a ROI with 32-bit sizes (and GLDZM's
    minima): 64 x 32² of 256 threads in 9 KB with the distances, 5 KB
    without; 47 x 64² 1024 threads; a slide's 300 x 32² as 64 x 32²; the
    long ROI's 1024 x 64 and 2 x 256² (65536 pixels) clusters of 16; the
    3D cubes: 8³ and 16³ one block, 8 x 32³ a cluster of 8; from 2^18
    pixels a ROI (2 x 64³, where the grid path ran faster than a cluster
    of 16 on the card, PERF.md), the 64 x 256 x 256 crop, the whole-slide
    2048² bucket and the whole-volume crop the grid path, in blocks of
    1024 pixels at 2 x 64³ and of 4096 past a million."""
    plan = tzones.zone_stats_plan
    assert plan(64, 1024, True) == ("smem", 1, 256, 9216)
    assert plan(64, 1024, False) == ("smem", 1, 256, 5120)
    assert plan(47, 4096, True) == ("smem", 1, 1024, 36864)
    assert plan(28, 256, False) == ("smem", 1, 64, 1280)
    assert plan(300, 1024, True) == ("smem", 1, 256, 9216)
    assert plan(500, 1024, True) == ("smem", 1, 256, 9216)
    assert plan(2, 65536, True) == ("cluster", 16, 1024, 36864)
    assert plan(1, 65535, True)[:2] == ("cluster", 16)
    assert plan(64, 512, False) == ("smem", 1, 128, 2560)
    assert plan(8, 32768, True) == ("cluster", 8, 1024, 36864)
    assert tzones.ZS_GRID_PIXELS == 262144
    assert plan(2, 262143, True) == ("cluster", 16, 1024, 147456)
    assert plan(2, 262143, False) == ("cluster", 16, 1024, 81920)
    assert plan(2, 262144, True) == ("grid", 256, 256, 0)
    assert plan(2, 262144, False) == ("grid", 256, 256, 0)
    for has_dist in (False, True):
        assert plan(1, 64 * 256 * 256, has_dist) == ("grid", 1024, 1024, 0)
        assert plan(1, 2048 * 2048, has_dist) == ("grid", 1024, 1024, 0)
        assert plan(1, 128 * 512 * 512, has_dist) == ("grid", 8192, 1024, 0)
    assert plan(1, 413185, True)[0] == "grid"
    assert plan(1, 743809, False)[0] == "grid"


@pytest.mark.parametrize("has_dist", [False, True])
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("A", [tzones.ZS_GRID_PIXELS,
                               tzones.ZS_GRID_PIXELS + 1, 743809,
                               1024 * 1023 + 3, 2048 * 2048,
                               128 * 512 * 512, 2 ** 31 - 1])
def test_zone_stats_grid_plan(A, B, has_dist):
    """K7's grid path past the measured threshold, for 1 to 3 ROIs, with
    and without the distances: blocks of whole warps, a thread a 4
    pixels, as many blocks a ROI as cover it and no more, the fewest warps
    a block that keep a ROI's blocks to ZS_GRID_BLOCKS (two an SM), 1024
    threads (ZS_SLAB pixels) past that, no dynamic shared memory, and a
    launch of fewer than 2^31 blocks."""
    path, C, T, smem = tzones.zone_stats_plan(B, A, has_dist)
    assert (path, smem) == ("grid", 0) and T % 32 == 0 and T <= 1024
    assert (C - 1) * 4 * T < A <= C * 4 * T
    assert C <= tzones.ZS_GRID_BLOCKS or T == 1024
    assert T == 32 or -(-A // (4 * (T - 32))) > tzones.ZS_GRID_BLOCKS
    assert (T == 1024) == (A > 31 * 128 * tzones.ZS_GRID_BLOCKS)
    assert B * C < 2 ** 31


@pytest.mark.parametrize("A", [1, 3, 91, 128, 129, 1024, 4096, 4097,
                               65536, 262144])
def test_zone_stats_grid_plan_small(A):
    """The grid path at small A (forced by chip_smoke's zone_stats_plans):
    blocks of one warp up to ZS_GRID_BLOCKS a ROI, C = ceil(A / 4 T);
    chip_smoke also forces blocks of one warp and of 1024 threads."""
    path, C, T, smem = tzones.zone_stats_grid_plan(A)
    assert path == "grid" and smem == 0 and T % 32 == 0
    assert T == 32 * max(1, -(-A // (128 * tzones.ZS_GRID_BLOCKS)))
    assert C == -(-A // (4 * T))
    plans = chip_smoke.zone_stats_plans(1, A, False)
    for plan in ((path, C, T, smem), ("grid", -(-A // 128), 32, 0),
                 ("grid", -(-A // 4096), 1024, 0)):
        assert plans.count(plan) == 1


def _zone_list_args(monkeypatch, anc, lev, valid, dist):
    """The arguments zone_list passes to nyx_zone_stats for CPU tensors
    posing as the card's (the library, stream and check replaced)."""
    from nyxus_tpu_torch import _build
    seen = []

    class Lib:
        def nyx_zone_stats(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(tzones, "_kernel_device", lambda t, name: True)
    monkeypatch.setattr(_build, "lib", lambda: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda t, name: 0)
    monkeypatch.setattr(_build, "check", lambda name, code: None)
    tzones.zone_list(anc, lev, valid, dist)
    return seen


@pytest.mark.parametrize("has_dist", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 512, 513),
                                   (3, 1024, 1024)], ids=str)
def test_zone_stats_entry_point_args(monkeypatch, shape, has_dist):
    """zone_list hands nyx_zone_stats as many arguments as its declaration
    in csrc/zone_stats.cu has, in _build's types: 8 pointers (anc, lev,
    valid, dist or 0, zlev, zsize, zdist or 0, ok), B, A, the path's index
    (0 "smem", 1 "cluster", 2 "grid"), C, threads, smem, vec, the stream;
    the plan's values, vec only where A is a multiple of 4."""
    from nyxus_tpu_torch import _build
    import ctypes
    B = shape[0]
    A = shape[1] * shape[2]
    anc = torch.zeros(shape, dtype=torch.int32)
    dist = torch.ones(shape, dtype=torch.int32) if has_dist else None
    (args,) = _zone_list_args(monkeypatch, anc, anc, anc > 0, dist)
    types = _build._SIGNATURES["nyx_zone_stats"]
    assert types == _c_entry_points()["nyx_zone_stats"]
    assert len(args) == len(types)
    assert [type(a) is int for a in args] == [True] * len(args)
    assert types == [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    assert (args[3] == 0) == (args[6] == 0) == (not has_dist)
    path, C, T, smem = tzones.zone_stats_plan(B, A, has_dist)
    assert args[8:14] == (B, A, ("smem", "cluster", "grid").index(path), C,
                          T, smem)
    assert args[14] in (0, 1) and (args[14] == 0 or A % 4 == 0)


def test_zone_stats_past_int32(monkeypatch):
    """A ROI of 2^31 pixels or more raises on the card's path (the kernel
    indexes a ROI's pixels with 32-bit ints) before any launch."""
    shape = (1, 2 ** 16, 2 ** 15)
    big = torch.zeros((1, 1, 1), dtype=torch.int32).expand(shape)
    valid = torch.zeros((1, 1, 1), dtype=torch.bool).expand(shape)
    with pytest.raises(ValueError, match="2\\^31"):
        _zone_list_args(monkeypatch, big, big, valid, None)


# K8's (B, H, W): the main path's three buckets, 5 x 32², 3 x 7 x 13, the
# long ROI's 1 x 1024 x 64, 2 x 256², a large batch of 32² masks, widths
# 31/32/33/63/64/65, heights 128/129 and 1024/1025, and the block path's
# largest square (968 x 968, 15 words a row) against the first past it, a
# wide row
ERO_SHAPES = [(64, 32, 32), (47, 64, 64), (28, 16, 16), (5, 32, 32),
              (3, 7, 13), (1, 1024, 64), (2, 256, 256), (5000, 32, 32),
              (1, 32, 31), (1, 32, 33), (1, 32, 63), (1, 32, 65),
              (1, 128, 64), (1, 129, 64), (1, 128, 32), (1, 1024, 65),
              (1, 1025, 64), (1, 968, 960), (1, 969, 960), (1, 968, 961),
              (1, 4, 4096), (1, 0, 0)]


@pytest.mark.parametrize("shape", ERO_SHAPES, ids=str)
def test_erosion_plan(shape):
    """K8: the warp path exactly where W <= 64 and H <= 128 (32-bit rows
    up to 32 columns, else 64-bit), a block of one warp a ROI whatever the
    batch; else a block a ROI with two planes of H x ceil(W / 64) 64-bit
    words where they fit a Hopper block's shared memory and the shorter
    side is below 256, a thread a column of words; else the dist path's
    int16 plane, its row pass 8 warps a block with 2 ceil(W / 32) ints of
    chunk tables a warp."""
    B, H, W = shape
    plan = tbinary.erosion_plan(B, H, W)
    assert all(tbinary.erosion_plan(b, H, W) == plan for b in (1, 5000))
    path, bits, T, smem = plan
    if W <= 64 and H <= 128:
        assert plan == ("warp", 32 if W <= 32 else 64, 32, 0)
        return
    NW = -(-W // 64)
    if min(H, W) < 256 and NW <= 1024 and 16 * H * NW <= SMEM_MAX:
        assert (path, bits, smem) == ("block", 64, 16 * H * NW)
        # whole warps, a thread a column of words, every word held: RP
        # rows a pass of NW threads each, all H rows in one pass where 1024
        # threads take them
        assert T % 32 == 0 and NW <= T <= 1024
        RP = T // NW
        assert RP >= H or (RP >= 1024 // NW and RP * NW > T - 32)
    else:
        assert plan == ("dist", 16, 256, 8 * 8 * -(-W // 32))
        assert smem <= SMEM_MAX


def test_erosion_plan_main_path():
    """The main buckets a warp a ROI (32-bit rows to 32 columns, 64-bit
    to 64), a slide's 300 x 32² and 5000 x 32² as 64 x 32²; the long ROI's
    1024 x 64 and 255 x 255 a block a ROI, a thread a row's word; from
    256² (2 x 256², 968 x 960, which the block path's 227 KB would hold)
    and past the block path (969 x 960, the whole-slide 2048² bucket) the
    dist path."""
    plan = tbinary.erosion_plan
    assert plan(64, 32, 32) == ("warp", 32, 32, 0)
    assert plan(28, 16, 16) == ("warp", 32, 32, 0)
    assert plan(47, 64, 64) == ("warp", 64, 32, 0)
    assert plan(1, 128, 64) == ("warp", 64, 32, 0)
    assert plan(1, 1024, 64) == ("block", 64, 1024, 16384)
    assert plan(300, 32, 32) == ("warp", 32, 32, 0)
    assert plan(5000, 32, 32) == ("warp", 32, 32, 0)
    assert plan(1, 255, 255) == ("block", 64, 256 * 4, 16 * 255 * 4)
    assert plan(2, 256, 256) == ("dist", 16, 256, 512)
    assert plan(1, 968, 960) == ("dist", 16, 256, 1920)
    assert plan(1, 969, 960) == ("dist", 16, 256, 1920)
    assert plan(1, 2048, 2048) == ("dist", 16, 256, 4096)


# K4's (B, H, W): the main path's three buckets, a slide's 300 x 32², 5 x
# 32², 3 x 7 x 13, the long ROI's 1 x 1024 x 64, 2 x 256², one pixel and an
# empty crop; at 9 to 70000 levels (16-bit codes to 65534 levels, 32-bit
# past)
NM_SHAPES = [(64, 32, 32), (47, 64, 64), (28, 16, 16), (300, 32, 32),
             (5, 32, 32), (3, 7, 13), (1, 1024, 64), (2, 256, 256),
             (1, 1, 1), (1, 0, 0)]
NM_LEVELS = [9, 65, 4096, 65534, 65535, 70000]


@pytest.mark.parametrize("esz", [4, 8])
@pytest.mark.parametrize("nbins", NM_LEVELS)
@pytest.mark.parametrize("mode", tcommon.NM_MODES)
@pytest.mark.parametrize("shape", NM_SHAPES, ids=str)
def test_neigh_matrix_plan(shape, mode, nbins, esz):
    """K4: whatever the batch, the fewest blocks a ROI from one a 2048
    pixels (at most 16, at most a row each) whose shared memory holds the
    counts (32-bit; NGTDM's cnt and N and S in the compute type, each
    region 16-byte aligned), NGTDM's 32 terms a warp and
    the 16-bit codes of a block's R rows with a row and a column of halo
    each side: one block ("smem") or a cluster, every row owned by exactly
    one block; no matrix of 65535 levels or more fits (so every staged
    code fits 16 bits); else the device path with only NGTDM's terms in
    shared memory.  A thread a pixel of a block's rows, whole warps, at
    most 1024."""
    B, H, W = shape
    plan = tcommon.neigh_matrix_plan(mode, B, H, W, nbins, esz)
    assert all(tcommon.neigh_matrix_plan(mode, b, H, W, nbins, esz) == plan
               for b in (1, 5000))
    path, C, T, smem = plan
    a16 = lambda n: -(-n // 16) * 16
    counts = a16(8 * nbins) + a16(esz * nbins) if mode == "ngtdm" \
        else a16(36 * nbins)
    C0 = max(1, min(16, H, -(-H * W // 2048)))

    def fits(c):
        R = -(-H // c) if H else 0
        t = min(1024, 32 * max(1, -(-R * W // 32)))
        terms = a16(t * esz) if mode == "ngtdm" else 0
        return counts + terms + 2 * (R + 2) * (W + 2) <= SMEM_MAX
    first = next((c for c in range(C0, 17) if fits(c)), None)
    if first is None:
        px = H * W
        assert (path, C) == ("device", 0)
        assert T == min(1024, 32 * max(1, -(-px // 32)))
        assert smem == (a16(T * esz) if mode == "ngtdm" else 0)
        return
    assert nbins < 65535
    R = -(-H // first) if H else 0
    assert C == (-(-H // R) if R else 1) <= first
    assert path == ("smem" if C == 1 else "cluster")
    assert C * R >= H and (C == 1 or (C - 1) * R < H)
    assert T % 32 == 0 and 32 <= T <= 1024
    assert T == 1024 or T >= R * W > T - 32 or (R * W == 0 and T == 32)
    terms = a16(T * esz) if mode == "ngtdm" else 0
    assert smem == counts + terms + 2 * (R + 2) * (W + 2) <= SMEM_MAX


def test_neigh_matrix_plan_main_path():
    """The main buckets one block a ROI with the counts in shared memory:
    GLDM at 64 x 32² and 64 levels 4.6 KB of 1024 threads, NGTDM's 65
    levels 7.2 KB, NGLDM's 4.7 KB; 28 x 16² 256 threads; 47 x 64² a
    cluster of 2 blocks of 32 rows; the long ROI's 1024 x 64 crop and 2 x
    256² clusters
    of 16 blocks of 64 and 16 rows, also at IBSI's 4096 levels (144 KB of
    GLDM counts a block); NGTDM's 70000 and 65535 levels the device
    path."""
    plan = tcommon.neigh_matrix_plan
    assert plan("gldm", 64, 32, 32, 64, 4) == ("smem", 1, 1024, 4616)
    assert plan("ngtdm", 64, 32, 32, 65, 4) == ("smem", 1, 1024, 7208)
    assert plan("ngldm", 64, 32, 32, 65, 4) == ("smem", 1, 1024, 4664)
    assert plan("gldm", 28, 16, 16, 64, 4) == ("smem", 1, 256, 2952)
    assert plan("gldm", 47, 64, 64, 64, 8) == ("cluster", 2, 1024,
                                                2304 + 2 * 34 * 66)
    assert plan("ngtdm", 47, 64, 64, 65, 4) == ("cluster", 2, 1024, 9384)
    assert plan("gldm", 300, 32, 32, 64, 4) == ("smem", 1, 1024, 4616)
    assert plan("gldm", 1, 1024, 64, 64, 4) == ("cluster", 16, 1024,
                                                 2304 + 2 * 66 * 66)
    assert plan("gldm", 64, 32, 32, 4096, 4) == ("smem", 1, 1024,
                                                  147456 + 2 * 34 * 34)
    assert plan("gldm", 1, 1024, 64, 4096, 4) == ("cluster", 16, 1024,
                                                   147456 + 2 * 66 * 66)
    assert plan("gldm", 2, 256, 256, 64, 4) == ("cluster", 16, 1024,
                                                 2304 + 2 * 18 * 258)
    assert plan("ngtdm", 2, 256, 256, 70000, 8) == ("device", 0, 1024, 8192)
    assert plan("ngtdm", 64, 32, 32, 65535, 4) == ("device", 0, 1024, 4096)


# K17's N: a row of 2, the IBSI goldens' 6, each bins-a-lane step of the
# warp path (32 | 33, 64 | 65), the default 64, 100, the warp plan's last
# 128 against 129, 256, 1024, 1025, 32768 (IH_BINS' largest), 65536, and
# the rows about the float32 staging limit
IH_BINS_PLAN = [2, 6, 32, 33, 64, 65, 100, 127, 128, 129, 256, 1024, 1025,
                32768, 56064, 56065, 65536]


@pytest.mark.parametrize("esz", [4, 8])
@pytest.mark.parametrize("N", IH_BINS_PLAN)
def test_ih_stats_plan(N, esz):
    """K17: a block of one warp a ROI up to 128 bins, each lane the least
    power of two of bins that covers the row in 32 lanes (1, 2 or 4); past
    128 bins a block of 256 threads a ROI, ceil(N / 256) bins a thread,
    the row staged where it fits the block's shared memory beside its 8 KB
    of scan and reduction buffers."""
    path, K = tih.ih_stats_plan(N, esz)
    if N <= 128:
        k = tih.ih_bins_a_lane(N)
        assert k in (1, 2, 4)
        assert 32 * k >= N and (k == 1 or 16 * k < N)
        assert (path, K) == ("warp", k)
    else:
        assert (path, K) == (
            "block" if N * esz <= SMEM_MAX - 8192 else "device",
            -(-N // 256))


def test_ih_stats_plan_main_path():
    """The default 64 bins two a lane and 100 four; 256 and 1024 bins a
    block a ROI (the warp path's 8 bins a lane ran slower there); 32768
    bins staged in float32, read from device memory in float64."""
    plan = tih.ih_stats_plan
    assert plan(64, 4) == ("warp", 2)
    assert plan(100, 8) == ("warp", 4)
    assert plan(128, 4) == ("warp", 4)
    assert plan(6, 4) == ("warp", 1)
    assert plan(129, 4) == ("block", 1)
    assert plan(256, 4) == ("block", 1)
    assert plan(1024, 8) == ("block", 4)
    assert plan(1025, 4) == ("block", 5)
    assert plan(32768, 4) == ("block", 128)
    assert plan(32768, 8) == ("device", 128)


# K2's (B, H, W): the main path's three buckets, a slide's 300 x 32², 3 x
# 7 x 13, the long ROI's 1 and 2 x 1024 x 64, 2 x 256², one pixel, and the
# 16-bit counts' edge: a block of 255 x 257 = 65535 pixels, 181² and 256² =
# 65536
GLCM_SHAPES = [(64, 32, 32), (47, 64, 64), (28, 16, 16), (300, 32, 32),
               (3, 7, 13), (1, 1024, 64), (2, 1024, 64), (2, 256, 256),
               (1, 1, 1), (1, 255, 257), (1, 181, 181), (1, 256, 256)]


def _k2_fits(H, W, ng, na, C):
    """Whether any angle group of K2 fits a block with the rows split over
    C blocks (shared memory falls as C grows)."""
    return tglcm.glcm_cooc_blocks(H, W, ng, na, 1, C, 1) is not None


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("n_angles", [1, 2, 4])
@pytest.mark.parametrize("ng", [8, 64, 256, 4096])
@pytest.mark.parametrize("shape", GLCM_SHAPES, ids=str)
def test_glcm_cooc_plan(shape, ng, n_angles, symmetric):
    """K2 in both compute types: the shared memory within a block's (the
    static 16 bytes beside it); whole warps, at most 1024; every (ROI,
    angle) owned by exactly one block or cluster (the angles cut into
    groups of AG, the kernel's index math), every crop row by exactly one
    block of a cluster of at most 16, and, on the device path, every
    matrix row by exactly one band; 16-bit counts exactly where a block's
    pixels (the most a cell can count) stay within 65535; the device path
    exactly where no cluster's blocks hold an angle, its count width
    holding (1 + symmetric) H W."""
    B, H, W = shape
    for esz in (4, 8):
        path, bits, AG, C, T, smem = tglcm.glcm_cooc_plan(
            B, H, W, ng, n_angles, symmetric, esz)
        assert smem + tglcm.GLCM_STATIC_SMEM <= SMEM_MAX
        assert T % 32 == 0 and 32 <= T <= 1024
        assert 1 <= AG <= n_angles
        groups = -(-n_angles // AG)
        owners = [g for g in range(groups)
                  for a in range(g * AG, min(n_angles, g * AG + AG))]
        assert owners == sorted(owners) and len(owners) == n_angles
        fits = [_k2_fits(H, W, ng, n_angles, c) for c in range(1, 17)]
        if path == "device":
            assert not any(fits)
            assert AG == n_angles and T == 1024
            BR = -(-ng // C)
            assert 1 <= C <= ng and C * BR >= ng and (C - 1) * BR < ng
            assert bits in ((53 if esz == 8 else 24), 32)
            assert (1 + symmetric) * H * W <= tglcm.GLCM_COUNT_MAX[bits]
            assert smem in (0, 2 * (H + 2) * (W + 2))
            continue
        assert any(fits)
        assert (path == "smem") == (C == 1)
        assert C <= 16 and (C == 1 or C <= H)
        R = -(-H // C) if H else 0
        rows = [r for r in range(C) for y in range(r * R, min(H, r * R + R))]
        assert rows == sorted(rows) and len(rows) == H
        assert C == 1 or (C - 1) * R < H
        assert bits == (16 if R * W <= 65535 else 32)
        words = -(-AG * ng * ng // 2) if bits == 16 else AG * ng * ng
        assert smem == 16 * -(-words // 4) + 2 * (R + 2 * min(1, H)) \
            * (W + 2 * min(1, W))


def test_glcm_cooc_plan_main_path():
    """The main buckets one block a ROI and two angles at 64 levels (64 x
    32²: 256 threads of four pixels each; 47 x 64² 512 threads of eight),
    one angle on 16² crops (a pixel a thread); IBSI's 256 levels one angle
    a block in 16-bit counts (128 KB); the long ROI and 2 x 256² clusters
    of 16 blocks of 4096 pixels, also at 256 levels; IBSI's 4096 raw
    levels the device path, the long ROI's crop staged and 128 bands of 32
    rows, float adds (int32 where float32 cannot hold a count)."""
    plan = tglcm.glcm_cooc_plan
    assert plan(64, 32, 32, 64, 4, False, 4) == ("smem", 16, 2, 1, 256,
                                                  16384 + 2 * 34 * 34)
    assert plan(28, 16, 16, 64, 4, False, 4) == ("smem", 16, 1, 1, 256,
                                                  8192 + 2 * 18 * 18)
    assert plan(300, 32, 32, 64, 4, True, 8)[:5] == ("smem", 16, 2, 1, 256)
    assert plan(47, 64, 64, 64, 4, False, 8)[:5] == ("smem", 16, 2, 1, 512)
    assert plan(64, 32, 32, 256, 4, True, 4) == ("smem", 16, 1, 1, 256,
                                                  131072 + 2 * 34 * 34)
    assert plan(2, 1024, 64, 64, 4, False, 4)[:5] == ("cluster", 16, 2, 16,
                                                      512)
    assert plan(2, 256, 256, 64, 4, False, 4)[:5] == ("cluster", 16, 2, 16,
                                                      512)
    assert plan(2, 1024, 64, 256, 4, True, 4)[:5] == ("cluster", 16, 1, 16,
                                                      512)
    assert plan(1, 1024, 64, 4096, 4, True, 4) == ("device", 24, 4, 128,
                                                    1024, 2 * 1026 * 66)
    assert plan(1, 1024, 64, 4096, 4, True, 8)[:2] == ("device", 53)
    # levels past 16-bit codes: the crop read from device memory
    assert plan(1, 32, 32, 65536, 1, False, 4)[::5] == ("device", 0)
    assert plan(1, 32, 32, 65535, 1, False, 4)[5] > 0
    assert plan(1, 4096, 4096, 4096, 4, False, 4)[:2] == ("device", 24)
    assert plan(1, 4096, 4096, 4096, 4, True, 4)[:2] == ("device", 32)
    with pytest.raises(ValueError):
        plan(1, 65536, 65536, 64, 1, True, 4)   # 2 H W past 2^32 - 1


# ---------------------------------------------------------------------------
# the C entry points against the argument types the wrappers bind


def _c_entry_points():
    """{name: [ctypes type]} of every ``extern "C" int nyx_*`` in the
    kernels' sources: a pointer c_void_p, a double c_double, a long long
    c_longlong, any other int c_int."""
    import ctypes
    import glob
    import re
    from nyxus_tpu_torch import _build
    out = {}
    for path in sorted(glob.glob(os.path.join(_build.SRC_DIR, "*.cu"))):
        with open(path) as f:
            text = f.read()
        for name, params in re.findall(
                r'extern "C" int (nyx_\w+)\(([^)]*)\)', text):
            types = []
            for p in params.split(","):
                p = " ".join(p.split())
                types.append(ctypes.c_void_p if "*" in p
                             else ctypes.c_double if p.startswith("double")
                             else ctypes.c_longlong if "long long" in p
                             else ctypes.c_int)
            out[name] = types
    return out


def test_c_entry_points_all_bound():
    """Every C entry point of the kernels' sources has argument types in
    _build._SIGNATURES, and every bound name has an entry point."""
    from nyxus_tpu_torch import _build
    assert set(_c_entry_points()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(
    __import__("nyxus_tpu_torch._build", fromlist=["_SIGNATURES"])
    ._SIGNATURES))
def test_c_entry_point_signature(name):
    """The argument types _build binds for a C entry point are its
    declaration's, in number and kind, so that a changed C interface fails
    here on the CPU and not first at a launch on the card."""
    from nyxus_tpu_torch import _build
    assert _build._SIGNATURES[name] == _c_entry_points()[name]
