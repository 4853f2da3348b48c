"""The launch plans of K11 ``gabor`` and K13 ``glcm3d_cooc``
(nyxus_tpu_torch/ops/gabor.py gabor_plan, ops/texture3d.py glcm3d_plan),
checked in plain Python at every bucket shape chip_smoke.py holds the
kernels at (its CASES and CUBES), the Gabor banks of chip_smoke.GABOR_BANKS
and 1 to 4096 grey levels: the shared memory a block asks for is within a
Hopper block's, clusters have at most 16 blocks, 16-bit counts are taken
only where no cell can pass 65535, every AABB pixel or voxel is owned by
exactly one block (``gabor_blocks`` and ``glcm3d_bricks`` cut the work as
the kernels do), and the second path is taken exactly where the first
cannot hold the work.  No card and no JAX are needed."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig  # noqa: E402
from nyxus_tpu_torch.ops import gabor as tgabor  # noqa: E402
from nyxus_tpu_torch.ops import texture3d as tt3  # noqa: E402
from nyxus_tpu_torch.ops.common import SMEM_MAX  # noqa: E402

BUCKETS_2D = sorted({(B, H, W) for B, H, W, _ in chip_smoke.CASES}
                    | {(3, 64, 128)})
BUCKETS_3D = sorted({c[1:] for c in chip_smoke.CUBES}
                    | {(16, 16, 16), (2, 255, 257)})


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
