"""The port's CUDA kernels K1-K17 against their plain PyTorch versions, and
the slices (2D and 3D) in f32 on the card against the port's own f64 CPU
run.  Every test needs a CUDA device and skips without one.  This file
imports neither jax nor the JAX package, so it runs on a machine with a
card and no jax:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Counts, zone labels, border distances and erosion counts must be equal.
Weighted float sums hold rtol 1e-12 in f64 and, in f32, 1e-6 up to the main
path's 64 x 64 buckets and 1e-5 above: the kernel's atomics add in another
order, and a bin of a 256 x 256 crop sums ~1000 float32 terms, whose
rounding then differs by more than 1e-6.  K10's power sums (accumulated in
float64 by both versions) hold rtol 1e-6 (f32 inputs) or 1e-12 (f64) of the
sum of their terms' absolute values, the size of a sum's rounding when its
terms are added in another order: a central moment's terms cancel, so its
own value is no scale.  K10's centres are bit-equal to the plain ones where
the raw sums they read are, and its centred sums are held against the plain
sums around its own centres.  K11's counts and baseline extrema are equal
in both types (both versions add the taps in one order, each operation
rounded on its own); K12's sums (float64, the same terms in both versions)
hold 1e-12 of the sum of their terms' absolute values, its magnitudes the
Zernike tier (2e-2) beside that rounding, a blank ROI's value bit for bit.
K10 and K12 are held by their plans and on every path, forced.  K13-K16 (3D
matrices, runs, labels, distances, stencil counts and sums) are integers
and must be equal; K1's float sums over 3D rows hold rtol 1e-6 / 1e-12 on
the 4096 x 27 cells, or where a cell sums many terms (a uniform cube, the
64 x 256 x 256 crop) the rounding bound of a sum in another order, 2 n u
sum(w); they are exact on dyadic weights.  K1 on its own cases
(chip_smoke.hist_cases: channels, cluster-merged rows, split bins, uniform
ROIs) is equal on 0/1 weights and within that bound on float weights.
K2, K3, K7, K8 and K9 are equal on their own cases (chip_smoke.GLCM_CASES,
runs_cases, zone_stats_case, erosion_case, quads_cases) by their plans
and on every path their plans can take, forced; K2, K7 and K8 also on
every bucket and special crop.
K4's GLDM and NGLDM matrices and NGTDM's N and present levels are equal,
NGTDM's S within 2 n u S of a cell of n terms (the same positive terms
summed in another order), by its plan and with the device path forced.
K17's bin indices and counts are
equal, its values within 1e-5 (f32) / 1e-12 (f64) of their value plus
their row's scale (both versions form the same terms and sum them in
float64, in another order), on every plan forced."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from nyxus_tpu_torch import columns, taxonomy  # noqa: E402
from nyxus_tpu_torch.ops import binary  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig  # noqa: E402
from nyxus_tpu_torch.ops import common, gabor, glcm, glrlm, zones  # noqa: E402
from nyxus_tpu_torch.ops import ih, moments, zernike  # noqa: E402
from nyxus_tpu_torch.ops import texture3d as t3  # noqa: E402
from nyxus_tpu_torch.pipeline.runner import PairRunner  # noqa: E402

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# (B, H, W, ROI AABB) buckets: the main path's, a ROI that does not fill its
# bucket, a shape that is not a power of two, the 128/256 buckets whose run
# matrices need more than 48 KB of shared memory, an empty ROI, and a
# 1024 x 64 bucket whose 64 x 1024 run matrix exceeds a block's shared memory
CASES = [(64, 32, 32, (29, 31)), (64, 64, 64, (60, 47)), (28, 16, 16, (13, 9)),
         (5, 32, 32, (13, 21)), (3, 7, 13, (7, 13)), (4, 128, 128, (101, 77)),
         (2, 256, 256, (250, 199)), (1, 16, 16, (0, 0)),
         (2, 1024, 64, (600, 40))]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


def _bucket(case, dtype, seed=0):
    B, H, W, hw = case
    return chip_smoke.synth_bucket(B, H, W, hw, seed, dtype,
                                   empty=hw == (0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_batched_hist(prec, case):
    dtype = DTYPES[prec]
    orig, lev, aabb, roi = _bucket(case, dtype)
    B = orig.shape[0]
    flat = (lev - 1).reshape(B, -1)
    cnt = roi.reshape(B, -1).to(dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    w = torch.rand(cnt.shape, generator=g, device="cuda", dtype=dtype) * cnt
    for idx, nbins in ((flat, 64), (flat * 9 + flat % 9, 576),
                       (flat * 256 + flat, 64 * 256)):
        assert torch.equal(common.batched_hist(idx, cnt, nbins),
                           common.batched_hist_plain(idx, cnt, nbins))
    rtol = 1e-12 if prec == "f64" else 1e-6 if case[1] * case[2] <= 4096 \
        else 1e-5
    torch.testing.assert_close(common.batched_hist(flat, w, 65),
                               common.batched_hist_plain(flat, w, 65),
                               rtol=rtol, atol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_glcm_cooc(prec, case):
    """K2 by its plan and on every plan of chip_smoke.glcm_plans, forced
    (one block or a cluster of 2, 4 or 16 blocks at each angle group size,
    the device path into the output and into an int32 scratch, the crop
    staged or read from device memory), symmetric or not, for angle
    subsets at offsets 1-3: counts equal, one launch a call."""
    orig, lev, _, _ = _bucket(case, DTYPES[prec])
    for angles, offset in (((0, 45, 90, 135), 1), ((90,), 1),
                           ((45, 135), 3), ((0, 90, 135), 2)):
        for sym in (False, True):
            chip_smoke.glcm_agree(_Agree(), orig, lev, angles, offset, 64,
                                  sym)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("name", chip_smoke.GLCM_CASES)
def test_glcm_cooc_special_cases(prec, name):
    """K2 on uniform, checkerboard and empty crops, NaN and negative
    intensities beside levels outside the matrix, the 16-bit count at its
    most (65535, and 65522 symmetric) and one past it (65536, 32-bit),
    IBSI's 256 levels, 512 levels and IBSI's 4096 levels on the long ROI,
    by its plan and on every plan forced."""
    for call in chip_smoke.glcm_case(name, DTYPES[prec]):
        chip_smoke.glcm_agree(_Agree(), *call)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_glrlm_runs(prec, case):
    dtype = DTYPES[prec]
    _, lev, aabb, roi = _bucket(case, dtype)
    nr = max(lev.shape[1:])
    for valid in (aabb, roi):
        assert torch.equal(glrlm.run_matrices(lev, valid, 64, nr, dtype),
                           glrlm.run_matrices_plain(lev, valid, 64, nr, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("anti", [False, True])
def test_glrlm_runs_single_diagonal(anti):
    lev = torch.ones((1, 8, 8), dtype=torch.int32)
    valid = torch.zeros((1, 8, 8), dtype=torch.bool)
    for k in range(5):
        y, x = (1 + k, 6 - k) if anti else (2 + k, 1 + k)
        lev[0, y, x] = 3
        valid[0, y, x] = True
    P = glrlm.run_matrices(lev.cuda(), valid.cuda(), 4, 8, torch.float32)
    want = torch.zeros((4, 4, 8))
    for a in range(4):
        if a == (3 if anti else 1):
            want[a, 2, 4] = 1
        else:
            want[a, 2, 0] = 5
    assert torch.equal(P.cpu()[0], want)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_neigh_matrix(prec, case):
    """K4 on each family's call (GLDM, NGTDM over the AABB and over the
    ROI, NGLDM) by its plan and with the device path forced: P, N and
    present equal, S within 2 n u S; one K4 and no K1 launch a call."""
    dtype = DTYPES[prec]
    orig, lev, aabb, roi = _bucket(case, dtype)
    for call in chip_smoke.neigh_family_args(orig, lev, aabb, roi):
        chip_smoke.neigh_agree(_Agree(), *call, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("name", chip_smoke.NEIGH_CASES)
def test_neigh_matrix_special_cases(prec, name):
    """K4 on uniform, one-pixel and border ROIs, levels outside the matrix
    and past 16-bit codes, and IBSI's 256 and 4096 levels, on every
    path."""
    dtype = DTYPES[prec]
    for call in chip_smoke.neigh_case(name, dtype):
        chip_smoke.neigh_agree(_Agree(), *call, dtype)


@pytest.mark.cuda
def test_family_calls_launch_k4_once():
    """gldm_matrix, ngtdm_matrices and ngldm_features each make one K4
    launch and no K1 launch, and equal their plain versions."""
    from nyxus_tpu_torch.ops import gldm, ngldm, ngtdm
    orig, lev, aabb, roi = _bucket(CASES[0], torch.float32)
    B = orig.shape[0]
    vmin = torch.where(roi, orig, float("inf")).reshape(B, -1).amin(dim=1)
    vmax = orig.reshape(B, -1).amax(dim=1)
    for call, plain in (
            (lambda: gldm.gldm_matrix(orig, lev, 64, torch.float32),
             lambda: gldm.gldm_matrix_plain(orig, lev, 64, torch.float32)),
            (lambda: ngtdm.ngtdm_matrices(lev, aabb, 64, torch.float32)[0],
             lambda: ngtdm.ngtdm_matrices_plain(lev, aabb, 64,
                                                torch.float32)[0]),
            (lambda: ngldm.ngldm_features(orig, roi, vmin, vmax, 64, 64,
                                          False, -0.0, torch.float32),
             None)):
        k4, k1 = common.neigh_matrix.launches, common.batched_hist.launches
        got = call()
        assert common.neigh_matrix.launches == k4 + 1
        assert common.batched_hist.launches == k1
        if plain is not None:
            assert torch.equal(got, plain())


class _Agree:
    def __call__(self, name, got, want, rtol=0.0, scale=None):
        assert got.shape == want.shape, name
        if scale is None:
            assert torch.equal(got, want), name
        else:
            assert bool(((got - want).abs() <= rtol * scale).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=str)
def test_zone_kernels(case):
    """K5, K6 (labels and distances) and K7 on the plain labels, with the
    AABB (MATLAB binning) and the ROI (radiomics binning) as
    participation."""
    for _, lev, valid, hts, wds in chip_smoke.zone_cases(case,
                                                         torch.float32):
        chip_smoke.zone_kernels_agree(_Agree(), lev, valid, hts, wds)


@pytest.mark.cuda
@pytest.mark.parametrize("crop", ["checkerboard", "uniform", "empty"])
def test_zone_kernels_special_crops(crop):
    (_, lev, valid, hts, wds), = [c for c in chip_smoke.special_zone_cases()
                                  if c[0] == crop]
    chip_smoke.zone_kernels_agree(_Agree(), lev, valid, hts, wds)
    anc, _ = zones.zone_cc4(lev, valid, hts, wds)
    zlev, zsize, _, ok = zones.zone_list(anc, lev, valid)
    n_zones = {"checkerboard": 32 * 32, "uniform": 1, "empty": 0}[crop]
    assert int(ok.sum()) == n_zones
    assert int(zsize.sum()) == int(valid.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(chip_smoke.CC4_KINDS))
@pytest.mark.parametrize("hw,in_smem", [((160, 160), True),
                                        ((161, 161), False),
                                        ((256, 64), True),
                                        ((256, 256), False),
                                        ((1024, 64), False)], ids=str)
def test_zone_cc4_paths(hw, in_smem, kind):
    """K6 on both sides of its shared-memory limit (160 x 160 is the
    largest square crop of the shared-memory path, 161 x 161 the smallest
    of the tiled path) and on 256 x 64, 256 x 256 and 1024 x 64, on
    chip_smoke.cc4_crop's random, uniform, checkerboard and serpentine
    levels, the second crop's AABB smaller than its bucket: labels and
    distances equal to the plain version."""
    assert (zones.zone_cc4_plan(*hw)[0] == "smem") == in_smem
    lev, valid, hts, wds = chip_smoke.cc4_crop(*hw, kind)
    for got, want in zip(zones.zone_cc4(lev, valid, hts, wds),
                         zones.zone_cc4_plain(lev, valid, hts, wds)):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_shape_kernels(prec, case):
    """K8 (erosion), K9 (quad and box counts) and K10 (raw and centred
    power sums of one and two planes) on the ROI masks of a bucket."""
    for _, mask, hts, wds in chip_smoke.shape_cases(case, DTYPES[prec]):
        chip_smoke.shape_kernels_agree(_Agree(), mask, hts, wds, DTYPES[prec])


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("crop", ["empty", "full", "checkerboard", "disk256",
                                  "whole-slide 2048²", "disk 969x960",
                                  "box 2100²"])
def test_shape_kernels_special_crops(prec, crop):
    """Empty, full and checkerboard crops, and a 256 x 256 solid disk whose
    long erosion runs beside two short ones in one launch; past the block
    path (K8's dist path) the whole-slide ROI's mask, a 969 x 960 disk with
    holes and a 2100² box inside a zero frame; the erosion counts and
    Euler numbers are those of the shapes (a full AABB never erodes: its
    frozen border feeds the interior, and the count stops at the cap; the
    box reaches the cap with every distance finite)."""
    cases = {c[0]: c[1:] for c in chip_smoke.special_shape_cases()}
    mask, hts, wds = (cases[crop] if crop in cases
                      else chip_smoke.erosion_case(crop))
    chip_smoke.shape_kernels_agree(_Agree(), mask, hts, wds, DTYPES[prec])
    n = binary.erosion_counts(mask, hts, wds).tolist()
    assert n == binary.erosion_counts_dist_plain(mask, hts, wds).tolist()
    want = {"empty": [0], "full": [1000], "checkerboard": [0],
            "disk256": [131, 9, 4], "whole-slide 2048²": [1000],
            "box 2100²": [1000]}
    if crop in want:
        assert n == want[crop]
    quads, _ = binary.binary_quads(mask)
    euler = binary.euler_number(mask, torch.float64, quads).tolist()
    if crop != "disk 969x960":
        assert euler == {"empty": [0], "full": [1], "checkerboard": [-449],
                         "disk256": [1, 1, 1], "whole-slide 2048²": [1],
                         "box 2100²": [1]}[crop]


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("crop", [c[0] for c in chip_smoke.runs_cases(
    device="cpu")])
def test_glrlm_runs_paths(crop, prec):
    """K3 equal to its plain version on a uniform ROI (and with every run
    clamped to nr 8), a checkerboard, one valid pixel a ROI, an empty mask,
    valid levels outside 1..ng, widths that 4 and 32 do not divide, odd
    heights, the long ROI's 2 x 1024 x 64 and 2048 and 4096 levels: by its
    plan, then on every path its kernel can take there (32-bit, 16-bit or
    device-memory counts; the crop staged as 16- or 32-bit codes or read
    from device memory), each forced."""
    (_, lev, valid, ng, nr), = [c for c in chip_smoke.runs_cases()
                                if c[0] == crop]
    assert chip_smoke.runs_paths_agree(_Agree(), lev, valid, ng, nr,
                                       DTYPES[prec]) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("crop", [c[0] for c in chip_smoke.quads_cases(
    device="cpu")])
def test_binary_quads_paths(crop, prec, monkeypatch):
    """K9 equal to its plain version on full, checkerboard, one-pixel and
    empty masks, ragged and odd shapes, rows of 96 and 1000 pixels, the
    long ROI's 2 x 1024 x 64 and 2 x 256²: by its plan and with each of its
    paths forced (the warp path up to 32 x 32, the block path, the device
    path); and the Euler numbers and box-count dimensions in f32 and f64
    from the kernel's counts equal to those from the plain counts."""
    (_, mask), = [c for c in chip_smoke.quads_cases() if c[0] == crop]
    assert chip_smoke.quads_paths_agree(_Agree(), mask) >= 2
    dtype = DTYPES[prec]
    B, H, W = mask.shape
    hts = torch.full((B,), H, dtype=torch.int32, device="cuda")
    wds = torch.full((B,), W, dtype=torch.int32, device="cuda")
    for path in chip_smoke.quads_paths(B, H, W):
        monkeypatch.setattr(binary, "binary_quads_plan",
                            lambda B, H, W, path=path: path)
        quads, boxes = binary.binary_quads(mask)
        pq, pb = binary.binary_quads_plain(mask)
        assert torch.equal(binary.euler_number(mask, dtype, quads),
                           binary.euler_number(mask, dtype, pq))
        assert torch.equal(
            binary.fract_dim_boxcount(mask, hts, wds, dtype, boxes),
            binary.fract_dim_boxcount(mask, hts, wds, dtype, pb))


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.ZONE_STATS_CASES)
def test_zone_stats_paths(case):
    """K7 equal to its plain version on GLSZM's labels and on GLDZM's labels
    and distances of uniform (one zone) and per-pixel (a zone a pixel) 64 x
    32² crops, A = 65535 and 65536, 7 x 13, valid pixels labelled A or at
    a pixel that is no seed, a uniform and a per-pixel 1024² crop and two
    1023 x 1021 ROIs of different contents (the grid path by its plan),
    and the 3D 8 x 32³, 2 x 64³ and uniform 2 x 64³ cubes: by its plan and
    on every plan of chip_smoke.zone_stats_plans (one block a ROI,
    clusters of 2 and 16, the grid path as planned and in blocks of one
    warp), forced."""
    for anc, lev, valid, dist in chip_smoke.zone_stats_case(case):
        assert chip_smoke.zone_stats_paths_agree(_Agree(), anc, lev, valid,
                                                 dist) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("crop", chip_smoke.EROSION_CASES)
def test_erosion_paths(crop):
    """K8 equal to its plain version on two full 32² AABBs (the cap),
    ellipses of widths 31, 32, 33, 63, 64 and 65, 7 x 13 masks, an ellipse
    filling 128 x 64 and one 129 x 64, the 256² disk beside disks of 9 and
    4 steps, the long ROI's 1024 x 64 bucket, an ellipse filling 1024 x 64,
    the whole-slide ROI's mask, a 969 x 960 disk with holes and a 2100² box
    at the cap: by its plan and on every plan of chip_smoke.erosion_plans
    (the warp path in 32- and 64-bit words, the block path at its plan's
    threads and at 64, the dist path at 8 warps and 1 a row-pass block),
    forced, and the plain distance form."""
    mask, hts, wds = chip_smoke.erosion_case(crop)
    assert chip_smoke.erosion_paths_agree(_Agree(), mask, hts, wds) >= 2
    if crop == "full 32²":
        assert binary.erosion_counts(mask, hts, wds).tolist() == [1000, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_gabor_zernike_kernels(prec, case):
    """K11 at the main path's bank, a five-filter bank and (on the main
    buckets) odd and large kernels, and K12, on a synth bucket."""
    banks = ["n16", "n10x5"] + (["n9", "n31"] if case in CASES[:2] else [])
    chip_smoke.gz_kernels_agree(_Agree(),
                                *chip_smoke.gz_inputs(case, DTYPES[prec]),
                                banks)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("bank", ["n64", "n160"])
def test_gabor_large_kernels(prec, bank):
    """Kernels of 64 and 160 taps a side, whose taps (and, at 160 in f64,
    the input tile) are read from device memory instead of shared memory."""
    chip_smoke.gz_kernels_agree(
        _Agree(), *chip_smoke.gz_inputs((3, 7, 13, (7, 13)), DTYPES[prec]),
        [bank])


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("crop", ["blank+flat", "disk256"])
def test_gabor_zernike_special_crops(prec, crop):
    """A blank ROI beside a flat-baseline one (its baseline max equals its
    min), and the 256² disk beside two small ones."""
    (_, img, hts, wds), = [c for c in chip_smoke.special_gz_cases(
        DTYPES[prec]) if c[0] == crop]
    chip_smoke.gz_kernels_agree(_Agree(), img, hts, wds, ["n16", "n9"])
    if crop == "blank+flat":
        _, mx, mn = gabor.gabor_counts(img, hts, wds, EngineConfig())
        assert mx[0] > mn[0] and mx[1] == mn[1] == 0


def _gabor_path_inputs(name, dtype):
    """(img, heights, widths, bank) of a K11 path test: "pixel+flat" a
    32 x 32 bucket holding a 1-pixel AABB, a 3 x 3 ROI whose baseline is
    flat (the noval branch) and a blank ROI; "cluster8" the 64 x 64 bucket
    (a cluster of 8 blocks, two pixels a thread); "cluster16" a 64 x 128
    bucket (16 blocks, a non-portable cluster); "n160" the 160-tap bank,
    which only the tile path holds."""
    if name == "pixel+flat":
        img = np.zeros((3, 32, 32))
        img[0, 0, 0] = 500.0
        img[1, :3, :3] = 1 + np.arange(9).reshape(3, 3) % 2
        img[2, :20, :17] = 700.0
        hts = torch.tensor([1, 3, 20], dtype=torch.int32, device="cuda")
        wds = torch.tensor([1, 3, 17], dtype=torch.int32, device="cuda")
        return torch.from_numpy(img).to(dtype).cuda(), hts, wds, "n16"
    case, bank = {"cluster8": ((64, 64, 64, (60, 47)), "n16"),
                  "cluster16": ((3, 64, 128, (60, 120)), "n16"),
                  "n160": ((3, 7, 13, (7, 13)), "n160")}[name]
    return chip_smoke.gz_inputs(case, dtype) + (bank,)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["plan", "tile"])
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("name", ["pixel+flat", "cluster8", "cluster16",
                                  "n160"])
def test_gabor_paths(name, prec, path, monkeypatch):
    """K11 by the path its plan chooses (the cluster path but for the
    160-tap bank; one filter a thread on the small "pixel+flat" batch, all
    five at two pixels on the others) and with the tile path forced
    through the plan: counts, baseline max and min equal to the plain
    version's."""
    dtype = DTYPES[prec]
    img, hts, wds, bank = _gabor_path_inputs(name, dtype)
    cfg = EngineConfig(**chip_smoke.GABOR_BANKS[bank])
    B, H, W = img.shape
    planned = gabor.gabor_plan(B, H, W, cfg.gabor_kersize,
                               1 + len(cfg.gabor_thetas), img.element_size())
    assert planned[0] == ("tile" if name == "n160" else "cluster")
    if name.startswith("cluster"):
        assert planned[1] == int(name[7:])
    if path == "tile":
        monkeypatch.setattr(gabor, "gabor_plan",
                            lambda *a: ("tile", 0, 0, 0, 0))
    got = gabor.gabor_counts(img, hts, wds, cfg)
    for g, w in zip(got, gabor.gabor_counts_plain(img, hts, wds, cfg)):
        assert torch.equal(g, w)
    if name == "pixel+flat":
        _, mx, mn = got
        assert mx[1] == mn[1] and mx[0] == mn[0]


@pytest.mark.cuda
def test_gabor_zernike_refuse_bad_inputs():
    img = torch.zeros((2, 16, 16), dtype=torch.int32, device="cuda")
    hw = torch.full((2,), 16, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        gabor.gabor_counts(img, hw, hw, EngineConfig())
    with pytest.raises(ValueError):
        gabor.gabor_counts(img.double(), hw[:1], hw, EngineConfig())
    v = torch.ones(2, dtype=torch.float64, device="cuda")
    raw = torch.zeros((2, 4, 4), dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError):
        zernike.zernike_moments(img.double(), raw, hw, hw, v, v.float(), 0.0)
    with pytest.raises(ValueError):
        zernike.zernike_moments(img.double(), raw[:, :2], hw, hw, v, v, 0.0)
    with pytest.raises(TypeError):
        zernike.zernike_moments(img, raw, hw, hw, v, v, 0.0)


@pytest.mark.cuda
def test_power_sums_refuses_bad_inputs():
    """K10's wrapper raises on what its kernel does not take: an integer
    crop, a mask that is not bool, a logw plane of another dtype."""
    x = torch.ones((2, 16, 16), dtype=torch.float32, device="cuda")
    m = x > 0
    area = torch.full((2,), 256, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        moments.moment_power_sums(x.int(), m, area)
    with pytest.raises(ValueError):
        moments.moment_power_sums(x, m.float(), area)
    with pytest.raises(ValueError):
        moments.moment_power_sums(x, m, area, x.double())


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("name", ["blank+flat", "checkerboard", "disk256",
                                  "synth 64x32x32", "synth 2x1024x64"])
def test_k10_k12_paths(name, prec):
    """K10 (the fused sums and centres, with and without logw) and K12 (the
    60 sums and the 30 magnitudes) by their plans and on every forced path
    (K10: one block a (ROI, plane) and a cluster of three, each staged and
    not; K12: one block a ROI and a cluster of three) on a blank ROI beside
    a flat-baseline one, a checkerboard, the 256² disks and two synth
    buckets."""
    dtype = DTYPES[prec]
    (_, img, hts, wds), = [c for c in chip_smoke.k10_k12_cases(dtype)
                           if c[0] == name]
    mask = img != 0
    _, area, logw = chip_smoke.moment_inputs(mask, dtype)
    assert chip_smoke.moment_paths_agree(_Agree(), img, mask, area, logw) >= 3
    assert chip_smoke.zernike_paths_agree(_Agree(), img, hts, wds) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["plan", "block"])
@pytest.mark.parametrize("crop", [c[0] for c in chip_smoke.dag_cases(
    device="cpu")])
def test_zone_dag_cases(crop, path, monkeypatch):
    """K5 equal to its plain version on widths 1, 8, 33, 63, 96, 99, 130,
    256 and 257, the long ROI's 1024 x 64, a 16 x 1024 rectangle, a one-row crop
    and spiral, comb, checkerboard, uniform and empty crops, by its plan
    (the warp path up to 256 wide) and with the block path forced."""
    (_, lev, valid), = [c for c in chip_smoke.dag_cases() if c[0] == crop]
    if path == "block":
        monkeypatch.setattr(zones, "zone_dag_plan", chip_smoke.dag_block_plan)
    assert torch.equal(zones.zone_labels(lev, valid),
                       zones.zone_labels_plain(lev, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("case", [c[0] for c in chip_smoke.hist_cases(
    torch.float32, device="cpu")])
def test_batched_hist_cases(case, prec):
    """K1 equal to its plain version where the weights are 0/1 (f32 and
    f64), float weights within 2 n u sum|w| a bin: the channel form, rows of
    several chunks merged across a cluster, bins split over a cluster, a
    one-bin uniform ROI in both, all-zero weights, indices out of range,
    rows of one entry a load, and the device-memory path; no zeroing
    launch before the cluster paths (the output is torch.empty)."""
    (_, idx, w, nb), = [c for c in chip_smoke.hist_cases(DTYPES[prec])
                        if c[0] == case]
    chip_smoke.hist_agree(_Agree(), idx, w, nb)
    before = common.batched_hist.launches
    common.batched_hist(idx, w, nb)
    assert common.batched_hist.launches == before + 1


@pytest.mark.cuda
def test_batched_hist_refuses_bad_inputs():
    idx = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        common.batched_hist(idx, torch.ones((5, 2, 8), device="cuda"), 4)
    with pytest.raises(ValueError):
        common.batched_hist(idx, torch.ones((2, 9), device="cuda"), 4)
    with pytest.raises(TypeError):
        common.batched_hist(idx, torch.ones((2, 8), dtype=torch.int32,
                                            device="cuda"), 4)


@pytest.mark.cuda
def test_shared_memory_limits_raise():
    """K1 counts a histogram larger than a block's shared memory (30000
    float64 bins, 240 KB) over a cluster's blocks instead of refusing it,
    for a row of a few entries and of several blocks' worth."""
    for A in (4, 3 * 8192 + 5):
        idx = (torch.arange(A, dtype=torch.int32, device="cuda") * 7919
               % 30007)[None]
        w = torch.ones((1, A), dtype=torch.float64, device="cuda")
        assert 30000 * 8 > common.SMEM_MAX
        assert torch.equal(common.batched_hist(idx, w, 30000),
                           common.batched_hist_plain(idx, w, 30000))


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
def test_device_memory_counts(prec):
    """K2 at 256 levels and K3 at 256 x 512 and 64 x 1024 matrices (more
    than a block's shared memory as 32-bit counts: K2 counts one angle's
    256 x 256 matrix in 16-bit shared memory, on the 1024 x 64 crop in a
    cluster of 16 blocks; K3 counts the 64 x 1024 ones of a 32² crop in
    16-bit shared memory, the rest in device memory) equal their plain
    versions."""
    dtype = DTYPES[prec]
    for case in ((64, 32, 32, (29, 31)), (2, 1024, 64, (600, 40))):
        orig, lev, aabb, roi = _bucket(case, dtype)
        lev256 = (lev - 1) * 4 + 1 + (orig.long() % 4).to(torch.int32)
        for sym in (False, True):
            assert torch.equal(
                glcm.cooc_matrices(orig, lev256, (0, 45, 90, 135), 1, 256,
                                   sym),
                glcm.cooc_matrices_plain(orig, lev256, (0, 45, 90, 135), 1,
                                         256, sym))
        for lv, ng, nr in ((lev256, 256, 512), (lev, 64, 1024)):
            assert 4 * ng * nr > common.SMEM_MAX
            for valid in (aabb, roi):
                assert torch.equal(
                    glrlm.run_matrices(lv, valid, ng, nr, dtype),
                    glrlm.run_matrices_plain(lv, valid, ng, nr, dtype))


@pytest.mark.cuda
def test_slice_f32_on_card_against_f64_cpu():
    counters = [chip_smoke.counters()[k] for k in chip_smoke.TEXTURE_KERNELS]
    before = [f.launches for f in counters]
    fset = taxonomy.parse_feature_request(chip_smoke.FEATURES)
    intens, labels = chip_smoke.make_dsb_like(320, 320, 40, seed=11)
    labs, dev = PairRunner(fset, EngineConfig(precision="f32"),
                           "cuda").run(intens, labels)
    assert all(f.launches > b for f, b in zip(counters, before))
    labs64, ref = PairRunner(fset, EngineConfig(precision="f64"),
                             "cpu").run(intens, labels)
    np.testing.assert_array_equal(labs, labs64)
    hdr, _ = columns.build_header(fset, EngineConfig())
    bad, _ = chip_smoke.compare_tiers(hdr[4:], dev, ref)
    assert not bad, bad


@pytest.mark.cuda
def test_all_but_gabor_zernike_f32_on_card_against_f64_cpu():
    """The 747-column request *ALL*: every column within its tier, the
    pre-collect host columns bit-equal, K1-K12 launched."""
    counters = [chip_smoke.counters()[k] for k in chip_smoke.KERNELS_2D]
    before = [f.launches for f in counters]
    fset = taxonomy.parse_feature_request(chip_smoke.FEATURES_ALL)
    intens, labels = chip_smoke.make_dsb_like(320, 320, 40, seed=11)
    card = PairRunner(fset, EngineConfig(precision="f32"), "cuda")
    labs, dev = card.run(intens, labels)
    assert all(f.launches > b for f, b in zip(counters, before))
    labs64, ref = PairRunner(fset, EngineConfig(precision="f64"),
                             "cpu").run(intens, labels)
    hdr, slots = columns.build_header(fset, EngineConfig())
    assert len(hdr) - 4 == chip_smoke.WIDTH_ALL
    chip_smoke.check_output("320x320 slide", hdr[4:], labs, dev, labs64, ref)
    host = chip_smoke.pre_host_columns(card, slots)
    assert np.array_equal(dev[:, host].view(np.uint64),
                          ref[:, host].view(np.uint64))


class _Agree3D:
    def __call__(self, name, got, want, scale=None):
        assert got.shape == want.shape, name
        if scale is None:
            assert torch.equal(got, want), name
        else:
            assert bool(((got.double() - want.double()).abs()
                         <= scale).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("cube", chip_smoke.CUBES, ids=str)
def test_3d_kernels(prec, cube):
    """K13-K16, K7 on 3D labels and K1 (device-memory path at 4096 x 27
    cells, multi-chunk rows at 64 bins) against their plain versions at the
    3D buckets 8^3 to 64^3 and a 64 x 256 x 256 crop: 64 and 4096 levels,
    both connectivities, the GLDM and NGLDM tables, NGTDM radii 1 and 2."""
    dtype = DTYPES[prec]
    rtol = 1e-6 if prec == "f32" else 1e-12
    chip_smoke.kernels_3d_agree(_Agree3D(), chip_smoke.synth_cube(
        *cube, 20, dtype), dtype, rtol, big_glcm=cube[1] <= 16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["empty", "uniform"])
def test_3d_kernels_special_cubes(kind):
    cube = chip_smoke.synth_cube(4, 16, 16, 16, 30, torch.float32, kind)
    chip_smoke.kernels_3d_agree(_Agree3D(), cube, torch.float32, 1e-6)


def _runs_cube(B, D, H, W, ng, kind, seed=0):
    """Levels and participation of a K14 test cube: "mixed" levels 0..ng+1
    (0 and ng + 1 are dropped) with a one-level slab, so that runs of every
    length run along each direction, on ~95% of the voxels; "single" one
    level on every voxel; "empty" no voxel taking part."""
    r = np.random.default_rng(seed)
    lev = r.integers(0, ng + 2, (B, D, H, W))
    lev[:, :D // 2 + 1, :H // 2 + 1, :] = int(r.integers(1, ng + 1))
    valid = r.random(lev.shape) < 0.95
    if kind == "single":
        lev[:] = min(7, ng)
        valid[:] = True
    elif kind == "empty":
        valid[:] = False
    return (torch.from_numpy(lev.astype(np.int32)).cuda(),
            torch.from_numpy(valid).cuda())


# (B, D, H, W, ng, nr, kind, the launch plan's (S, P) or None)
RUNS3_CASES = [
    (2, 8, 8, 8, 4096, 8, "mixed", (1, 1)),      # one block's share exactly
    (2, 8, 8, 8, 4096, 9, "mixed", (2, 1)),      # just over it
    (1, 4, 4, 256, 4096, 256, "mixed", (8, 2)),  # over a cluster's: passes
    (1, 16, 16, 128, 4096, 128, "mixed", None),
    (2, 16, 16, 16, 64, 16, "single", None),     # one level
    (2, 16, 16, 16, 64, 4, "single", None),      # runs longer than nr
    (2, 16, 16, 16, 64, 3, "mixed", None),
    (2, 8, 8, 8, 4096, 8, "empty", None),
    (1, 1, 255, 257, 8, 4, "single", None),      # a count of 65535 runs
    (1, 64, 128, 128, 4096, 128, "mixed", (8, 2)),  # 32-bit counts, passes
]


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("case", RUNS3_CASES, ids=str)
def test_glrlm3d_runs_plans(prec, case):
    """K14 on matrices just under and just over one block's share of
    shared memory, over a whole cluster's (the pass axis), a single-level
    cube, runs longer than nr, an empty ROI, a cell counting 65535 runs
    (the most a 16-bit count holds: a cube of 65535 voxels) and a 64 x 128
    x 128 crop (32-bit counts): equal to the plain version."""
    B, D, H, W, ng, nr, kind, plan = case
    S, _, P, narrow, _ = t3.glrlm3d_plan(ng, nr, D * H * W)
    if plan is not None:
        assert (S, P) == plan
    assert narrow == (D * H * W <= 65535)
    lev, valid = _runs_cube(B, D, H, W, ng, kind)
    dtype = DTYPES[prec]
    got = t3.glrlm3d_runs(lev, valid, ng, nr, dtype)
    assert torch.equal(got, t3.glrlm3d_runs_plain(lev, valid, ng, nr, dtype))
    if kind == "empty":
        assert not got.any()
    if D * H * W == 65535:
        assert int(got.max()) == 65535


def _glcm3d_path_inputs(name, dtype):
    """(levels, depths, heights, widths, offset, ng, symmetric, ibsi) of a
    K13 path test: "uniform65535" two 255 x 257 planes of one level, whose
    block of the first plane counts 65535 pairs into one cell along
    (0, 0, 1) (the most a 16-bit count holds); "sym+ibsi" raw levels 0..63
    with the transpose added and the zero levels dropped; "offset2" the
    main 3D bucket at 64 levels two voxels apart; "cube64" the 64^3 bucket
    (bricks of four planes)."""
    if name == "uniform65535":
        lev = torch.ones((1, 2, 255, 257), dtype=torch.int32, device="cuda")
        dims = [torch.tensor([n], dtype=torch.int32, device="cuda")
                for n in (2, 255, 257)]
        return (lev, *dims, 1, 8, False, False)
    shape = {"sym+ibsi": (4, 16, 16, 16), "offset2": chip_smoke.MAIN_CUBE,
             "cube64": (2, 64, 64, 64)}[name]
    _, lev, raw, _, dd, hh, ww = chip_smoke.synth_cube(*shape, 7, dtype)
    if name == "sym+ibsi":
        return (raw % 64, dd, hh, ww, 1, 64, True, True)
    return (lev, dd, hh, ww, 2 if name == "offset2" else 1, 64, False, False)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["plan", "device"])
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("name", ["uniform65535", "sym+ibsi", "offset2",
                                  "cube64"])
def test_glcm3d_cooc_paths(name, prec, path, monkeypatch):
    """K13 by the cluster path its plan chooses and with the device-memory
    path forced through the plan: equal to the plain version."""
    dtype = DTYPES[prec]
    lev, dd, hh, ww, o, ng, sym, ibsi = _glcm3d_path_inputs(name, dtype)
    plan = t3.glcm3d_plan(ng, *lev.shape[1:], o, sym)
    assert plan[0] == "cluster"
    if name == "uniform65535":
        assert plan[6] and plan[1:2] + plan[4:6] == (2, 1, 255)
    if path == "device":
        monkeypatch.setattr(t3, "glcm3d_plan",
                            lambda *a: ("device", 0, 0, 0, 0, 0, False, 0))
    got = t3.glcm3d_cooc(lev, dd, hh, ww, o, ng, sym, ibsi, dtype)
    assert torch.equal(got, t3.glcm3d_cooc_plain(lev, dd, hh, ww, o, ng, sym,
                                                 ibsi, dtype))
    if name == "uniform65535":
        assert int(got[0, 12, 0, 0]) == 65535


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
def test_glrlm3d_runs_64_cube_raw_levels(prec):
    """K14 on the 64^3 bucket at raw 12-bit levels (a 4096 x 64 matrix, 1
    MB over a cluster of eight blocks)."""
    dtype = DTYPES[prec]
    _, _, raw, aabb, _, _, _ = chip_smoke.synth_cube(2, 64, 64, 64, 3, dtype)
    valid = aabb & (raw > 0)
    assert t3.glrlm3d_plan(4096, 64, 64 ** 3)[:3] == (8, 512, 1)
    assert torch.equal(t3.glrlm3d_runs(raw, valid, 4096, 64, dtype),
                       t3.glrlm3d_runs_plain(raw, valid, 4096, 64, dtype))


def _zone_cube(name, seed=0):
    """(levels, valid, heights, widths) of a K15 path test, int32 and bool
    on the card: "one-voxel" ROIs whose AABB is one voxel; "snake" a level-7
    path through 2 x 32^3 cubes that runs up one column, along the top
    plane, down another column and along the bottom plane again, so that it
    crosses every slab boundary of a cluster several times and its blocks'
    roots merge through the cluster; "zero-plane" levels 0..3 (0 a zero
    level for the distances) with a plane and a row of zeros and AABBs
    smaller than the bucket; the non-cubic buckets 3 x 8 x 16 x 32 and 2 x
    32 x 8 x 16; "narrow" a 15 x 17 x 257 cube of 65535 voxels (16-bit
    parents) and "wide" a 16 x 64 x 64 cube of 65536 (32-bit)."""
    r = np.random.default_rng(seed)
    shape = {"one-voxel": (6, 8, 8, 8), "snake": (2, 32, 32, 32),
             "zero-plane": (3, 16, 16, 32), "nc-8x16x32": (3, 8, 16, 32),
             "nc-32x8x16": (2, 32, 8, 16), "narrow": (1, 15, 17, 257),
             "wide": (1, 16, 64, 64)}[name]
    B, D, H, W = shape
    lev = r.integers(1, 4, shape)
    valid = r.random(shape) < 0.95
    hh = np.full(B, H, np.int32)
    ww = np.full(B, W, np.int32)
    if name == "one-voxel":
        valid[:] = False
        valid[:, 0, 0, 0] = True
        hh[:] = ww[:] = 1
    elif name == "snake":
        for x0, x1 in ((3, 20), (20, 28)):
            lev[:, :, 3, x0] = lev[:, :, 3, x1] = 7
            valid[:, :, 3, x0] = valid[:, :, 3, x1] = True
        lev[:, -1, 3, 3:21] = lev[:, 0, 3, 20:29] = 7
        valid[:, -1, 3, 3:21] = valid[:, 0, 3, 20:29] = True
    elif name == "zero-plane":
        lev = r.integers(0, 4, shape)
        lev[:, 5] = 0
        lev[:, :, 7] = 0
        valid = lev > 0
        hh[:] = H - 3
        ww[:] = W - 5
    return (torch.from_numpy(lev.astype(np.int32)).cuda(),
            torch.from_numpy(valid).cuda(), torch.from_numpy(hh).cuda(),
            torch.from_numpy(ww).cuda())


ZONE_CUBES = ["one-voxel", "snake", "zero-plane", "nc-8x16x32",
              "nc-32x8x16", "narrow", "wide"]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["plan", "cluster", "device"])
@pytest.mark.parametrize("name", ZONE_CUBES)
def test_cc3d_paths(name, path, monkeypatch):
    """K15 by the paths its plan chooses, with the cluster path forced
    through the plan (the labels alone, which the plan gives the
    device-memory path) and with the device-memory path forced, 26- and
    6-connected, the latter with the distances: equal to the plain
    version."""
    lev, valid, hh, ww = _zone_cube(name)
    B, D, H, W = lev.shape
    plan = t3.cc3d_plan(B, D, H, W, True)
    assert plan[0] == "cluster" and plan[4] == (D * H * W > 65535)
    assert t3.cc3d_plan(B, D, H, W)[0] == "device"
    if path == "cluster":
        monkeypatch.setattr(t3, "cc3d_plan", lambda *a: plan)
    elif path == "device":
        monkeypatch.setattr(t3, "cc3d_plan",
                            lambda *a: ("device", 0, 0, 0, False, 0))
    for conn in (26, 6):
        got = t3.cc3d(lev, valid, conn, hh, ww)
        want = t3.cc3d_plain(lev, valid, conn, hh, ww)
        assert torch.equal(got[0], want[0]), conn
        if conn == 6:
            assert torch.equal(got[1], want[1])
    if name == "snake":   # one component, labelled by its first voxel
        anc = got[0] if conn == 26 else t3.cc3d(lev, valid, 26)[0]
        assert bool((anc[:, :, 3, 3] == 3 * 32 + 3).all())


def _stencil_cube(name, seed=0):
    """(levels, part) of a K16 path test on the card: "one-voxel" ROIs
    whose only voxel taking part is (0, 0, 0); the non-cubic buckets 3 x 8
    x 16 x 32 and 2 x 32 x 8 x 16; "odd" 2 x 5 x 7 x 13 (rows not 16-byte
    aligned); "extremes" levels drawn from the int32 extremes, -1, 0 and 1,
    so that equal levels and wrapped window sums meet every sign."""
    r = np.random.default_rng(seed)
    shape = {"one-voxel": (6, 8, 8, 8), "nc-8x16x32": (3, 8, 16, 32),
             "nc-32x8x16": (2, 32, 8, 16), "odd": (2, 5, 7, 13),
             "extremes": (2, 16, 16, 16)}[name]
    lev = r.integers(-3, 4, shape)
    part = r.random(shape) < 0.8
    if name == "one-voxel":
        part[:] = False
        part[:, 0, 0, 0] = True
    elif name == "extremes":
        lev = r.choice(np.array([-2 ** 31, 2 ** 31 - 1, -1, 0, 1]), shape)
    return (torch.from_numpy(lev.astype(np.int32)).cuda(),
            torch.from_numpy(part).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["plan", "voxel"])
@pytest.mark.parametrize("name", ["one-voxel", "nc-8x16x32", "nc-32x8x16",
                                  "odd", "extremes"])
def test_stencil3d_paths(name, path, monkeypatch):
    """K16 by the slab path its plan chooses and with the voxel path forced
    through the plan: the N26 and N24 tables, N6 (a mask given at run
    time), a table with a two-voxel shift (the voxel path by the plan) and
    windows of radius 1, 2 and 3 (the last the voxel path by the plan):
    equal to the plain version."""
    lev, part = _stencil_cube(name)
    B, D, H, W = lev.shape
    for halo in (1, 2):
        assert t3.stencil3d_plan(B, D, H, W, halo)[0] == "slab"
    if path == "voxel":
        monkeypatch.setattr(t3, "stencil3d_plan",
                            lambda *a: ("voxel", 0, 0, 0, 0))
    for table in (t3.N26, t3.N24_NGLDM, t3.N6, [(0, 0, 2), (1, -1, 0)]):
        assert torch.equal(t3.stencil3d(lev, part, table),
                           t3.stencil3d_plain(lev, part, table)), table
    for radius in (1, 2, 3):
        for g, w in zip(t3.stencil3d(lev, part, radius=radius),
                        t3.stencil3d_plain(lev, part, radius=radius)):
            assert torch.equal(g, w), radius


@pytest.mark.cuda
def test_3d_f32_on_card_against_f64_cpu():
    """*3D_ALL* on the fixture volume at the default and binned
    configurations: every column within its tier (a 3D column taking its 2D
    twin's), the surface columns bit-equal, K13-K16 launched."""
    chip_smoke.check_3d(chip_smoke.counters())


# ---------------------------------------------------------------------------
# K17 ih_stats and IBSI mode


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("N", chip_smoke.IH_BINS)
def test_ih_stats(prec, N):
    """K17 against its plain version by its plan and on every plan of
    chip_smoke.ih_plans forced (a warp a ROI, also at twice the bins a
    lane up to 4, the block path staged and from device memory),
    one launch a call: bin indices equal, values within 1e-5 (f32) / 1e-12
    (f64) of their row's scale, the empty, single-level and one-bin rows
    included."""
    dtype = DTYPES[prec]
    inputs = chip_smoke.ih_inputs(64, N, dtype, seed=N)
    chip_smoke.ih_paths_agree(inputs, 1e-5 if prec == "f32" else 1e-12)


@pytest.mark.cuda
def test_ih_stats_refuses_bad_inputs():
    inputs = chip_smoke.ih_inputs(4, 6, torch.float32)
    with pytest.raises(ValueError):
        ih.ih_stats(inputs[0][:, :1], *inputs[1:4], -0.0, *inputs[4:])
    with pytest.raises(ValueError):
        ih.ih_stats(inputs[0], inputs[1][:3], *inputs[2:4], -0.0,
                    *inputs[4:])
    with pytest.raises(TypeError):
        ih.ih_stats(inputs[0].to(torch.int32), *inputs[1:4], -0.0,
                    *inputs[4:])


@pytest.mark.cuda
def test_ibsi_f32_on_card_against_f64_cpu():
    """The IBSI request *ALL* (793 columns) on the 320 x 320 slide with
    intensities % 59 + 1: every column within its tier, the IH members read
    off the histogram equal, K1-K12 and K17 launched."""
    counters = [chip_smoke.counters()[k]
                for k in chip_smoke.KERNELS_2D + chip_smoke.KERNELS_IH]
    before = [f.launches for f in counters]
    fset = taxonomy.parse_feature_request(chip_smoke.FEATURES_ALL, ibsi=True)
    intens, labels = chip_smoke.make_dsb_like(320, 320, 40, seed=11)
    intens = (intens % 59 + 1).astype(np.uint16)
    labs, dev = PairRunner(fset, EngineConfig(precision="f32", ibsi=True),
                           "cuda").run(intens, labels)
    assert all(f.launches > b for f, b in zip(counters, before))
    labs64, ref = PairRunner(fset, EngineConfig(precision="f64", ibsi=True),
                             "cpu").run(intens, labels)
    hdr, _ = columns.build_header(fset, EngineConfig(ibsi=True))
    assert len(hdr) - 4 == chip_smoke.WIDTH_IBSI
    chip_smoke.check_output("IBSI 320x320 slide", hdr[4:], labs, dev, labs64,
                            ref)
    chip_smoke.check_ih_columns("IBSI 320x320 slide", hdr[4:], dev, ref)


@pytest.mark.cuda
def test_bin_edges_on_the_card():
    """Integer intensities on the 100-bin percentile histogram's edges (a
    range of 140: edges every 1.4) and on radiomics bin edges fall into
    the same bins on the card as on the CPU: the widths are one rounded
    division on both (a CUDA tensor over a Python number is not)."""
    from nyxus_tpu_torch.ops import intensity, quant
    vals = torch.arange(36.0, 177.0, dtype=torch.float64)[None]
    w = (torch.arange(vals.shape[1]) % 5 + 1).to(torch.float64)[None]
    vmin, vmax = torch.tensor([36.0], dtype=torch.float64), \
        torch.tensor([176.0], dtype=torch.float64)
    n = w.sum(dim=1).to(torch.int64)
    want = intensity.histogram_stats(vals, n, vmin, vmax, 100, weights=w)
    got = intensity.histogram_stats(vals.cuda(), n.cuda(), vmin.cuda(),
                                    vmax.cuda(), 100, weights=w.cuda())
    for k in ("p01", "p10", "p25", "p75", "p90", "p99", "median",
              "robust_mean"):
        assert torch.equal(got[k].cpu(), want[k]), k
    x = vals.reshape(1, -1, 1)
    lo, hi = vmin.reshape(1, 1, 1), vmax.reshape(1, 1, 1)
    assert torch.equal(quant.bin_radiomics(x.cuda(), lo.cuda(), hi.cuda(),
                                           35).cpu(),
                       quant.bin_radiomics(x, lo, hi, 35))


# ---------------------------------------------------------------------------
# OME-Zarr and DICOM pairs streamed on the card


@pytest.mark.cuda
def test_zarr_and_tiled_dicom_stream_on_the_card(tmp_path, monkeypatch):
    """*ALL* on the 320 x 320 slide from an OME-Zarr v2 pair (blosc-LZ4,
    128² chunks) and a tiled multi-frame DICOM pair (128² frames) at
    ram_limit=1, through Nyxus.featurize_files on the card: each goes
    through run_streamed with its region source, and its rows are the
    in-memory rows of the same pair (PairRunner.run on the arrays, on the
    card) within the f32 tiers, labels equal."""
    from nyxus_tpu_torch import Nyxus
    from nyxus_tpu_torch.api import _force_finite
    from nyxus_tpu_torch.io.dicom import write_dicom_tiled
    from nyxus_tpu_torch.io.zarr import write_zarr
    intens, labels = chip_smoke.make_dsb_like(320, 320, 40, seed=11)
    lab16 = labels.astype(np.uint16)
    pairs = {"ZarrPairSource": (str(tmp_path / "i.zarr"),
                                str(tmp_path / "l.zarr")),
             "DicomPairSource": (str(tmp_path / "i.dcm"),
                                 str(tmp_path / "l.dcm"))}
    ip, lp = pairs["ZarrPairSource"]
    write_zarr(ip, intens, chunks=(1, 1, 1, 128, 128))
    write_zarr(lp, lab16, chunks=(1, 1, 1, 128, 128))
    ip, lp = pairs["DicomPairSource"]
    write_dicom_tiled(ip, intens, tile=128)
    write_dicom_tiled(lp, lab16, tile=128)
    fset = taxonomy.parse_feature_request(chip_smoke.FEATURES_ALL)
    cols = columns.build_header(fset, EngineConfig())[0][4:]
    card = PairRunner(fset, EngineConfig(precision="f32"), "cuda")
    labs, vals = card.run(intens, labels)
    want = (labs, _force_finite(vals, card.cfg.noval))
    for kind, (ip, lp) in pairs.items():
        nyx = Nyxus(chip_smoke.FEATURES_ALL, device="cuda", ram_limit=1)
        seen = []
        run_streamed = nyx._runner.run_streamed
        monkeypatch.setattr(nyx._runner, "run_streamed",
                            lambda src, **k: seen.append(type(src).__name__)
                            or run_streamed(src, **k))
        df = nyx.featurize_files([ip], [lp])
        assert seen == [kind]
        chip_smoke.rows_agree(kind, cols, chip_smoke.frame_rows(nyx, df),
                              want)


@pytest.mark.cuda
def test_kernel_off_the_current_card_raises():
    """Every wrapper launches on the current CUDA device: a tensor on
    another card raises, naming the kernel, and no plain version runs in
    its place; under ``torch.cuda.device`` of its card it launches and
    equals the plain version.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    g = torch.Generator().manual_seed(3)
    idx = torch.randint(0, 50, (8, 256), generator=g, dtype=torch.int32)
    w = torch.rand((8, 256), generator=g, dtype=torch.float64)
    want = common.batched_hist_plain(idx, w, 50)
    before = common.batched_hist.launches
    with torch.cuda.device(0):
        with pytest.raises(RuntimeError, match="batched_hist.*cuda:1"):
            common.batched_hist(idx.to("cuda:1"), w.to("cuda:1"), 50)
    assert common.batched_hist.launches == before
    with torch.cuda.device(1):
        got = common.batched_hist(idx.to("cuda:1"), w.to("cuda:1"), 50)
    assert got.device == torch.device("cuda", 1)
    assert common.batched_hist.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_two_shards_on_one_card():
    """The 320 x 320 slide's *ALL* rows through PairRunner with its
    buckets split into two shards on the card (devices cuda:0 twice):
    within the tiers of the one-device card run, and every kernel of the
    path launched by both shards."""
    fset = taxonomy.parse_feature_request(chip_smoke.FEATURES_ALL)
    intens, labels = chip_smoke.make_dsb_like(320, 320, 40, seed=11)
    cfg = EngineConfig(precision="f32")
    kern = chip_smoke.counters()
    labs1, one = PairRunner(fset, cfg, "cuda").run(intens, labels)
    before = {k: f.launches for k, f in kern.items()}
    labs2, two = PairRunner(fset, cfg, devices=["cuda:0", "cuda:0"]).run(
        intens, labels)
    np.testing.assert_array_equal(labs1, labs2)
    hdr, _ = columns.build_header(fset, EngineConfig())
    chip_smoke.check_output("two shards", hdr[4:], labs2, two, labs1, one)
    for k in chip_smoke.KERNELS_2D:
        assert kern[k].launches > before[k], k
