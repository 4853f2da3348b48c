#!/usr/bin/env python3
"""Smoke run of nyxus_tpu_torch on one CUDA card.

    python3 chip_smoke.py        (from the repository root; needs one card)
    python3 chip_smoke.py --kernel-times [ROOT [GROUP,...]]
                                 (K1-K13 and K15-K17 alone, the
                                 package under ROOT; GROUP one of k1_k5,
                                 k2, k3_k9, k4_k17, k7_k8, k6_k8,
                                 k10_k12, k11_k13, k15_k16)

Phases, each of which raises on failure (non-zero exit, no result line):

0. refuse to run without a CUDA device; print the card, its power limit and
   the torch / CUDA versions
1. build the seventeen CUDA kernels from nyxus_tpu_torch/csrc with nvcc
   (sm_90a, one nvcc process a source) and, at the same time, the
   host-geometry library from nyxus_tpu_torch/native/src with g++ (no
   libtiff, no zlib: ldd of the library is printed and checked)
2. hold each kernel against its plain PyTorch version on the card, f32 and
   f64 (counts, labels and distances exact, weighted sums within rtol 1e-6
   / 1e-12), and time both from a torch.profiler trace beside CUDA events.
   2D (K1-K12): the main path's bucket shapes and beyond (128², 256², a
   1024 x 64 bucket; K2 on every plan of glcm_plans forced (one block or
   a cluster of 2, 4 or 16 at each angle group size, the device path into
   the output or an int32 scratch, staged or not), both symmetries, and on
   GLCM_CASES: uniform, checkerboard and empty crops, NaN and levels out
   of range, 16-bit counts at 65535 and 32-bit at 65536, 256, 512 and
   4096 levels; K3 at 1024-long runs, whose matrices exceed a block's
   shared memory; checkerboard, uniform and empty
   crops for the zone and shape kernels; a 256² solid disk whose long
   erosion runs beside short ones; blank and flat-baseline ROIs and Gabor
   kernels of 9 to 160 taps a side for K11 and K12; K5 on crops of widths 1
   to 1024, a spiral, a comb, a checkerboard, uniform and empty crops, by
   its plan and with its block path forced, and K1 on every plan: NGTDM's
   three channels, rows merged across a cluster, bins split over a row's
   blocks, uniform ROIs, zero weights, indices out of range, unaligned
   rows; K3 on uniform, checkerboard, one-pixel and empty crops, levels
   outside 1..ng, ragged widths, odd heights, the long ROI and 2048 and
   4096 levels, and K9 on full, checkerboard, one-pixel, empty and ragged
   masks, the long ROI's and 256², each by its plan and on every path its
   plan can take, forced; K7 on every bucket and zone crop and on
   uniform and per-pixel crops, A = 65535 and 65536, 7 x 13 and labels
   off every zone or at pixels that are no seeds, and on its grid path by
   its plan past a cluster (a uniform 1024² crop, a zone a pixel of
   1024², two 1023 x 1021 ROIs of different contents), and K8 on every bucket
   and shape crop and on the cap, widths 31 to 65, the 256² disk, 1024 x
   64 and 1025 x 64, the whole-slide ROI, a 969 x 960 disk with holes and
   a 2100² box at the cap, each by its plan and on every plan forced (the
   dist path on every crop) and against the plain distance form; K6's
   tiled path on random, uniform, checkerboard and serpentine levels at
   161², 256² and 1024 x 64, an AABB smaller than its bucket; K4, each
   8-neighbour family's matrix (GLDM, NGTDM over the AABB and the ROI,
   NGLDM) in one launch and no K1 launch, on every bucket and on uniform,
   one-pixel and border ROIs, levels outside the matrix and past 16-bit
   codes and IBSI's 256 and 4096 levels, by its plan and on every plan of
   neigh_plans forced (one block, clusters of 2, 4 and 16 blocks, device
   memory; P, N and present equal, S within 2 n u S); K10, every moment
   sum and centre of a bucket in
   one launch, with and without logw, and K12, the Zernike sums and
   magnitudes, on blank, flat-baseline, checkerboard, 256² disk, 64 x 32²
   and 1024 x 64 crops by their plans and on every path forced).  3D
   (K13-K16, K7 on 3D labels on every plan forced, also on uniform 64³
   cubes, K1's split path): the buckets 8³ to 64³ and a 64 x 256 x 256 crop, 64 and 4096 (raw 12-bit) levels, both connectivities, the
   GLDM and NGLDM shift tables, NGTDM windows of radius 1 and 2, empty and
   uniform cubes; K14 is timed at raw levels and in the binned
   configuration (64 levels), its launch plan (cluster size, levels a
   block, count width, passes) printed.  IBSI (K17): B = 64 histograms of
   6, 64, 100, 256 and 32768 bins (the last beyond a block's shared memory
   in f64), with empty, single-level and one-bin rows, by its plan and on
   every plan of ih_plans forced (a warp a ROI up to 128 bins, the block
   path staged and from device memory), bin indices equal and values
   within 1e-5 / 1e-12 of their row's scale; and torch.sort
   (sort_masked_values) timed.  K1 and K5 are timed once more alone
   (k1_k5_times): K5 at 64 x 32², 47 x 64², 28 x 16² and 1 x 1024 x 64, by
   its plan, with its block path forced and its dependent chain alone; K1
   at 100 bins (64 x 32², 47 x 64²), NGTDM's three channels, 8 x 32³ at 64
   bins and GLDM's raw 4096 x 27 cells.  K11 and K13 are timed once more alone
   (k11_k13_times): K11 at 64 x 32², 64 x 64², 28 x 16² and 2 x 256² with
   the default bank and at 64 x 32² with the 64-tap bank, K13 at 8 x 32³,
   2 x 64³ and 1 x 64 x 256 x 256 at 64 levels and at 8 x 32³ at raw
   levels, each with its launch plan, its device launches a call (from the
   profiler) and its bound, K11's unfused floor beside it; and K15 and K16
   (k15_k16_times) in every mode the 3D families call them in (26- and
   6-connected labels, the latter with the distances; the N26 and N24
   tables; the window of radius 1) at 8 x 32³, 42 x 16³, 2 x 64³ and 1 x
   64 x 256 x 256, with the same figures.  K15 and K16 are also held
   exactly on a 16 x 64 x 64 bucket (K15's 32-bit parents) and with K15's
   device-memory and K16's voxel paths forced
3. run the request *ALL* (747 columns) through PairRunner in f32 on the
   card and in f64 on the CPU, compare per column at the p90 relative error
   with the tiers of tests/test_tpu_device.py, check that the columns of
   the host families that read no device result are bit-equal between the
   two runs, and that every kernel was launched: a 320 x 320 slide, and a
   slide with one 600 x 40 px ROI (bucket 1024 x 64) at 64 and at 256 grey
   levels, which takes K3's device-memory path and K2's cluster path (K2's
   plan a bucket printed).  Then *3D_ALL*
   (213 columns) through VolumeRunner the same way, a 3D column taking its
   2D twin's tier (the name without the leading 3): the reference
   fixture's volume and a subset of throughput volume 1, at the default
   configuration (raw levels for GLRLM/GLSZM/GLDM/NGTDM, NGTDM zero) and
   the binned one (grey depth 64, NGTDM radius 1: K16's window), the
   surface columns bit-equal, K13-K16 launched.  Then IBSI mode: *ALL*
   (793 columns, the 46 IH_* added) on the 320 x 320 slide with
   intensities % 59 + 1 (64 raw levels) and on the long-ROI slide at 12
   bits (intensities >> 4: 4096 raw levels, GLCM's matrices a ROI at a
   time, K2's device path), the IH members read off the histogram (bin count, mode and
   gradient bins) equal; and *3D_ALL* (ibsi) on the fixture volume
3b. the 2D file protocol: print which of PIL, pandas and pyarrow import
   (phase 3c's featurize_directory and phase 3d's ImageQuality.featurize
   need pandas); write three TIFF pairs with the port's libtiff-free
   writer (the 320 x 320 slide tiled LZW in 128-px tiles, the long-ROI
   slide stripped Deflate, make_dsb_like(seed=7) tiled LZW in 512-px tiles,
   bench.py's corpus format), read each back exactly with read_gray (the
   1024² pair's decode timed), then run *ALL* over the directory through
   Nyxus._iter_directory_raw in memory and with ram_limit=1 (every pair
   tile-streamed through run_streamed): labels equal to PairRunner.run's
   on the decoded arrays on the card, values within the f32 tiers of that
   run, K1-K12 launched by each; and the 1024² pair's warm wall through
   the file path (in memory, streamed) beside PairRunner.run's
3c. the 2D run modes (mergerois, whole-slide, anisotropy) in memory and
   streamed against the f64 CPU run, whole-slide *ALL* on the 8 corpus
   slides through featurize_directory, and the CLI as a subprocess
3d. oversized ROIs (phase 3) and ImageQuality, with the f64 CPU references
   in three worker processes meanwhile (check_oversized): the 700 x 800
   pair of tests/test_oversized.py at ram_limit=1, *ALL* and IBSI *ALL*,
   against the f64 CPU run of the same path and the card's trivial run;
   the four finish stages timed, the intensity, IH and texture stages on
   the card equal to the same stages on the CPU on every member (rtol
   1e-9); corpus slide 7 whole-slide at ram_limit=1, tile-streamed,
   against phase 3c's in-memory row; an 8704 x 1024 whole-slide run at
   the default budget (oversized by its height) against numpy;
   ImageQuality.featurize (no label image) on the stack of the 8 corpus
   slides against the f64 CPU, and at ram_limit=1 (streamed) against in
   memory.  Prints each run's wall (taken while the references run), its
   Pipeline/Phase3_oversized seconds, peak device memory and launches, and
   a "finish_stages" JSON line; the walls and that line again before the
   card's line
3e. *3D_ALL* beyond the default configuration, after phase 4's 3D pass,
   with f64 CPU references in four worker processes meanwhile
   (check_3d_beyond): (a) the two throughput volumes written as vol1.nii
   and vol2.nii.gz through Nyxus3D.featurize_directory, against the
   in-memory featurize rows; (b) volume 1 as a 96-slice layout-A stack of
   TIFF slices, in memory and over the RAM gate (read a plane at a time),
   against (a)'s rows; (c) anisotropy along z and along x, y and z,
   whole-volume mode and mergerois on volume 1 whole (timed; whole-volume
   mode also profiled: card busy share, K7 and K13-K16 totals) and on its
   first MODE_CPU_DEPTH planes against the f64 CPU run; (d) volume 1 at a
   RAM gate that puts its largest ROI alone over it, *3D_ALL* and IBSI:
   that ROI through 3D phase 3 against the f64 CPU trivial run at rtol
   1e-8, none of its columns unserved, then the eight 3D finish stages
   timed and held against the CPU on every member (a "finish3d_stages"
   JSON line); (e) K13-K16, K7 on every plan forced and K1 against their
   plain versions at the whole-volume crop (1 x 128 x 512 x 512), then
   timed there (a "whole_volume_kernels" JSON line); the walls again, and
   the smoke's wall, before the card's line
3f. OME-Zarr and DICOM through the entry points, after phase 3e
   (check_formats): (a) the 8 corpus slides written as OME-Zarr v2
   (blosc-LZ4, byte shuffle, 512² chunks), read back bit for bit, *ALL*
   through Nyxus.featurize_files in memory against PairRunner.run on the
   arrays (K1-K12 launched; decode s a slide and the wall beside phase
   3b's TIFF pair); (b) slide 7 as zarr v3 (gzip chunks; blosc-LZ4 in
   sharding_indexed shards) and DICOM (single-frame, RLE Lossless, tiled
   multi-frame in 256² frames, a signed int16 copy with intercept -1024,
   JPEG-LS where CharLS loads), each in memory and at ram_limit=1, the
   Zarr and tiled pairs through run_streamed and the others through run,
   against (a)'s rows; slide 7 whole-slide from Zarr, tile-streamed,
   against phase 3d (b)'s TIFF run; (c) the two throughput volumes as
   OME-Zarr through Nyxus3D.featurize_files against phase 3e (a)'s NIfTI
   rows (K13-K16 launched); the walls again before the card's line
3g. scale-out and the native discovery, after phase 3f (check_shards):
   (a) the 8 corpus slides at *ALL* through PairRunner(devices=[cuda:0,
   cuda:0]), each bucket in two shards on the card, against the one-device
   rows (EXACT and the pre-collect host columns bit for bit, the rest
   within the tiers), both walls and the launches; (b) volume 1 at
   *3D_ALL* the same way through VolumeRunner; (c) the card count
   Nyxus(n_devices=-1) resolves, n_devices=2 raising ValueError on one
   card (a real two-card pass where there are two); (d) two processes on
   cuda:0 joined by initialize_distributed over tcp://localhost, each
   featurize_directory(shard_slides=True) over four corpus slides, every
   pair in one shard, the union within the tiers of the one-process run;
   (e) the native discovery on the 8 slides against the numpy pass, ms a
   slide; the walls again before the card's line
4. throughput: the 8 slides make_dsb_like(1024, 1024, 300, seed=7..14), one
   untimed pass then one timed pass through PairRunner.run, for the
   337-column texture slice, the 713-column request *ALL* -GABOR
   -ZERNIKE2D and the 747-column *ALL*; the first slide of the last is also
   held against the f64 CPU run.  Then the IBSI *ALL* (793 columns) on the
   8 slides at 8 bits ((intensity >> 8) + 1, 256 raw levels), its first
   slide held against the f64 CPU run.  Then *3D_ALL* on the two 12-bit
   volumes make_volume_3d(1..2) (96 x 320 x 320, ~200 nuclei and 3 lesions
   each) through VolumeRunner.run: ROIs/s, ROI Mvoxels/s, peak device
   memory
5. torch.profiler traces of one warm slide of the 747-column request, of
   one warm volume of *3D_ALL* and of one warm 8-bit slide of the IBSI
   request: device time by kernel, host time of each runner stage (nyx:D3_*
   for the 3D families), and K2's device time and launches over each slide,
   K13-K16's over the volume

The last three lines are the card's name and power limit, the kernels'
JSON line (K1-K17; the 2D kernels' launches from the timed 747-column
pass, K13-K16's from the timed 3D pass, K17's from the timed IBSI pass)
and the result JSON line.  Imports torch, numpy, scipy and nyxus_tpu_torch
only (phase 3b tries PIL, pandas and pyarrow to report them).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
FEATURES = ["*ALL_INTENSITY*", "*ALL_GLCM*", "*ALL_GLRLM*", "*ALL_GLDM*",
            "*ALL_NGTDM*", "*ALL_GLSZM*", "*ALL_GLDZM*", "*ALL_NGLDM*"]
WIDTH = 337
# every 2D family: *ALL*, and the same without Gabor and Zernike
FEATURES_ALL = ["*ALL*"]
WIDTH_ALL = 747
FEATURES_713 = ["*ALL*", "-GABOR", "-ZERNIKE2D"]
WIDTH_713 = 713
# IBSI mode: *ALL* adds the 46 IH_* columns; *3D_ALL* keeps its 213
WIDTH_IBSI = 793
# the 3D path: *3D_ALL* through VolumeRunner
FEATURES_3D = ["*3D_ALL*"]
WIDTH_3D = 213
# the binned 3D configuration of tests/test_texture3d.py:40-42 (grey depth
# 64 for the four families that keep raw levels by default, and an NGTDM
# window of radius 1, which the default leaves empty)
BINNED_3D = dict(d3_glrlm_greydepth=64, d3_glszm_greydepth=64,
                 d3_gldm_greydepth=64, d3_ngtdm_greydepth=64,
                 d3_ngtdm_radius=1)

# the card's published peaks (H100 SXM at 700 W):
# device memory 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, the
# rate the bounds below charge each kernel's integer and float operations at
HBM_BYTES_S = 3.35e12
OPS_S = 67e12

# per-member-prefix relative tolerance of f32-on-device vs f64-on-CPU, p90
# over ROIs (copied from tests/test_tpu_device.py:27-63)
DEFAULT_TOL = 2e-3
PREFIX_TOL = {
    "IMOM": 5e-2, "SPAT_": 5e-2, "CENTRAL_": 5e-2, "NORM_": 5e-2,
    "HU_": 5e-1, "WEIGHTED_": 5e-2, "SMOM": 5e-2,
    "WT_": 5e-2,
    "GLCM_CLUPROM": 2e-2, "GLCM_CLUSHADE": 2e-1,
    "GLCM_": 5e-3, "GLRLM_": 5e-3, "GLSZM_": 5e-3, "GLDZM_": 5e-3,
    "GLDM_": 5e-3, "NGLDM_": 5e-3, "NGTDM_": 2e-2,
    "3GLCM_": 5e-3, "3GLRLM_": 5e-3, "3GLSZM_": 5e-3, "3GLDZM_": 5e-3,
    "3GLDM_": 5e-3, "3NGLDM_": 5e-3, "3NGTDM_": 2e-2,
    "GABOR": 5e-2,
    "ZERNIKE2D": 2e-2,
    "FRAC_AT_D": 2e-2, "MEAN_FRAC": 2e-2, "RADIAL_CV": 5e-2,
    "STDDEV": 5e-3, "SKEWNESS": 2e-2, "KURTOSIS": 2e-2,
    "EXCESS_KURTOSIS": 2e-2, "HYPER": 5e-2,
    "COV": 5e-3, "ENERGY": 5e-3, "VARIANCE": 5e-3,
    "EROSIONS": 1.01,
}
# order statistics and histogram modes, skipped by the tiers: an f32
# bin-edge flip moves one pixel between bins.  Matched on whole tokens of
# the member name, or of a 3D column's 2D twin (MEDIAN_ABSOLUTE_DEVIATION,
# ANG_BW_NEIGHBORS_MODE, 3P90), a
# subset of tests/test_tpu_device.py's substrings, which also skip MINOR_*,
# *_MIN_* and *_MAX_* members of the shape families
DISCRETE = ("MODE", "MEDIAN", "P01", "P10", "P25", "P75", "P90", "P99",
            "INTERQUARTILE")
# integer counts of the same mask on both sides: equal exactly (which makes
# the EROSIONS tier above moot)
EXACT = ("EULER_NUMBER", "EROSIONS_2_VANISH", "EROSIONS_2_VANISH_COMPLEMENT")
ZERO_BY_CONSTRUCTION = ("CENTRAL_MOMENT_01", "CENTRAL_MOMENT_10",
                        "IMOM_CM_01", "IMOM_CM_10")


def twin_2d(col):
    """A 3D column's 2D twin, whose tier and tokens it takes: the name
    without its leading 3 (3KURTOSIS -> KURTOSIS, 3MEDIAN -> MEDIAN)."""
    return col[1:] if col.startswith("3") else col


def tol_for(col):
    """The tier of the longest PREFIX_TOL key that starts the column or its
    2D twin (the explicit 3GLCM_... keys match the 3D name itself)."""
    best, best_len = DEFAULT_TOL, 0
    for pref, t in PREFIX_TOL.items():
        for name in (col, twin_2d(col)):
            if name.startswith(pref) and len(pref) > best_len:
                best, best_len = t, len(pref)
    return best


def compare_tiers(cols, dev, ref):
    """Columns whose p90 relative error of dev (f32 on the card) against
    ref (f64 on the CPU) exceeds its tier; also the worst p90 seen."""
    bad, worst = [], (0.0, None)
    for j, c in enumerate(cols):
        a, b = dev[:, j], ref[:, j]
        both = np.isfinite(a) & np.isfinite(b)
        if both.sum() == 0:
            continue
        if set(twin_2d(c).split("_")) & set(DISCRETE) \
                or c in ZERO_BY_CONSTRUCTION:
            continue
        rel = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), 1e-4)
        p90 = float(np.quantile(rel, 0.9))
        if p90 / tol_for(c) > worst[0]:
            worst = (p90 / tol_for(c), (c, p90))
        if p90 > tol_for(c):
            bad.append((c, p90))
    return bad, worst[1]


def make_dsb_like(h=1024, w=1024, n_blobs=300, seed=7):
    """Nucleus-like elliptical ROIs, DSB2018-ish density and sizes: the
    repository benchmark's slide (bench.make_dsb_like, which imports jax),
    computed per blob in a window around it with the same arithmetic and
    random stream, so the slide is identical (pinned by
    tests/test_torch_slice.py)."""
    r = np.random.default_rng(seed)
    labels = np.zeros((h, w), np.int32)
    intens = (r.normal(120, 30, (h, w))).clip(1, 255)
    lab = 1
    for _ in range(n_blobs):
        cy, cx = r.uniform(12, h - 12), r.uniform(12, w - 12)
        ry, rx = r.uniform(4, 18), r.uniform(4, 18)
        ang = r.uniform(0, np.pi)
        ca, sa = np.cos(ang), np.sin(ang)
        # every pixel of the ellipse lies within max(ry, rx) < 18 of its centre
        y0, y1 = max(0, int(cy) - 20), min(h, int(cy) + 21)
        x0, x1 = max(0, int(cx) - 20), min(w, int(cx) + 21)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        u = (yy - cy) * ca + (xx - cx) * sa
        v = -(yy - cy) * sa + (xx - cx) * ca
        win_l = labels[y0:y1, x0:x1]
        m = ((u / ry) ** 2 + (v / rx) ** 2 <= 1.0) & (win_l == 0)
        if m.sum() < 12:
            continue
        base = r.uniform(400, 40000)
        win_i = intens[y0:y1, x0:x1]
        win_i[m] = np.clip(base + r.normal(0, base * 0.15, m.sum()), 1, 65535)
        win_l[m] = lab
        lab += 1
    return np.floor(intens).astype(np.uint16), labels


def make_long_roi_slide(seed=3):
    """A 640 x 96 slide of make_dsb_like blobs plus one elliptical ROI about
    600 x 40 px (the highest label), whose bucket is 1024 x 64."""
    intens, labels = make_dsb_like(640, 96, 6, seed=seed)
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:640, 0:96]
    roi = (((yy - 319.5) / 300.0) ** 2 + ((xx - 69.5) / 20.0) ** 2 <= 1.0) \
        & (labels == 0)
    labels[roi] = labels.max() + 1
    intens[roi] = np.clip(3000 + 800 * np.sin(yy[roi] / 7.0)
                          + r.normal(0, 300, roi.sum()), 1, 65535)
    return intens, labels


def blob3d(seed=4, shape=(48, 56, 60)):
    """The reference fixture's volume pair (tests/test_oversized._blob3d,
    copied: the script cannot import the tests; pinned equal by
    tests/test_torch_3d.py): uniform intensities 1..899, one ellipsoid ROI
    (label 3) and a 4^3 cube (label 1)."""
    r = np.random.default_rng(seed)
    D, H, W = shape
    intens = r.integers(1, 900, shape).astype(np.uint16)
    labels = np.zeros(shape, np.int32)
    zz, yy, xx = np.mgrid[0:D, 0:H, 0:W]
    blob = (((zz - D / 2) / (D * 0.42)) ** 2 + ((yy - H / 2) / (H * 0.42)) ** 2
            + ((xx - W / 2) / (W * 0.42)) ** 2) <= 1.0
    labels[blob] = 3
    labels[2:6, 2:6, 2:6] = 1     # small trivial ROI
    return intens, labels


_T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def log_phase(text):
    log("%s (at %.1f s)" % (text, time.perf_counter() - _T0))


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_events(prof):
    """(name, microseconds) of every kernel and copy the card ran inside a
    torch.profiler window (not the device spans of the runner's nyx:*
    annotation ranges, which the trace lists as device events too)."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith("nyx:")]


def timed(fn, iters=20):
    """(ms a call between CUDA events, device ms a call, device launches a
    call) of fn() over ``iters`` calls after a warm-up.  The first includes
    the host's launch overhead whenever the host enqueues more slowly than
    the card runs; the second sums the kernels and copies the call ran,
    from a torch.profiler trace, and the third counts them.  The trace
    misses cluster launches now and then: the second is the mean event's
    time by the events a call rounded (at least one), which is the sum a
    call when no event is missed; where the trace holds no device event of
    the calls, the second is the first again and the third None, said so
    in the log (after three traced windows that held none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = device_events(prof)
        if seen:
            break
    if not seen:
        log("  (the profiler's trace holds no device event of these calls: "
            "the CUDA events' time stands for the device time)")
        return event_ms, event_ms, None
    per_call = max(1, round(len(seen) / iters))
    return (event_ms, sum(us for _, us in seen) / len(seen) * per_call / 1e3,
            len(seen) / iters)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def synth_bucket(B, H, W, roi_hw, seed, dtype, empty=False, device="cuda"):
    """A padded bucket of B elliptical ROIs of AABB roi_hw inside H x W
    crops on ``device``: (masked original intensities, MATLAB levels at 64,
    the AABB validity mask, the ROI mask)."""
    import torch
    from nyxus_tpu_torch.ops import quant
    r = np.random.default_rng(seed)
    h, w = roi_hw
    yy, xx = np.mgrid[0:H, 0:W]
    roi = (((yy - (h - 1) / 2) / max(h / 2, 0.5)) ** 2
           + ((xx - (w - 1) / 2) / max(w / 2, 0.5)) ** 2 <= 1.0)
    roi = np.broadcast_to(roi, (B, H, W)) & (r.random((B, H, W)) < 0.97)
    if empty:
        roi = np.zeros((B, H, W), bool)
    intens = np.floor(r.normal(2000, 500, (B, H, W))).clip(1, 65535)
    orig = torch.from_numpy(np.where(roi, intens, 0)).to(dtype).to(device)
    vmax = orig.reshape(B, -1).amax(dim=1).clamp(min=1)
    lev = quant.bin_levels(orig, vmax[:, None, None], vmax[:, None, None], 64)
    aabb = torch.from_numpy(np.broadcast_to((yy < h) & (xx < w),
                                            (B, H, W)).copy()).to(device)
    return orig, lev, aabb, torch.from_numpy(roi.copy()).to(device)


CASES = ((64, 32, 32, (29, 31)), (64, 64, 64, (60, 47)), (28, 16, 16, (13, 9)),
         (5, 32, 32, (13, 21)), (3, 7, 13, (7, 13)), (4, 128, 128, (101, 77)),
         (2, 256, 256, (250, 199)), (2, 1024, 64, (600, 40)),
         (1, 16, 16, (0, 0)))
TEXTURE_KERNELS = ("batched_hist", "glcm_cooc", "glrlm_runs", "neigh_matrix",
                   "zone_dag", "zone_cc4", "zone_stats")
SHAPE_KERNELS = ("erosion", "binary_quads", "power_sums")
GZ_KERNELS = ("gabor", "zernike")
KERNELS_2D = TEXTURE_KERNELS + SHAPE_KERNELS + GZ_KERNELS
KERNELS_3D = ("glcm3d_cooc", "glrlm3d_runs", "cc3d", "stencil3d")
KERNELS_IH = ("ih_stats",)
KERNELS = KERNELS_2D + KERNELS_3D + KERNELS_IH


def counters():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from nyxus_tpu_torch.ops import (binary, common, gabor, glcm, glrlm, ih,
                                     moments, texture3d, zernike, zones)
    return dict(zip(KERNELS, (common.batched_hist, glcm.cooc_matrices,
                              glrlm.run_matrices, common.neigh_matrix,
                              zones.zone_labels, zones.zone_cc4,
                              zones.zone_list, binary.erosion_counts,
                              binary.binary_quads, moments.moment_power_sums,
                              gabor.gabor_counts, zernike.zernike_moments,
                              texture3d.glcm3d_cooc, texture3d.glrlm3d_runs,
                              texture3d.cc3d, texture3d.stencil3d,
                              ih.ih_stats)))


def torch_routines():
    """The device routines that stay torch, by name: each counts its calls
    (``calls``, ops/common.py ``counted``)."""
    from nyxus_tpu_torch.ops import (common, gldzm, glszm, quant, radial,
                                     zones)
    return {"radial.extrema": radial.extrema,
            "zones.grouped_weight_sums": zones.grouped_weight_sums,
            "common.fast_log2": common.fast_log2,
            "common.sort_masked_values": common.sort_masked_values,
            "quant.bin_levels": quant.bin_levels,
            "glszm.glszm_features_from_zones": glszm.glszm_features_from_zones,
            "gldzm.gldzm_features_from_zones": gldzm.gldzm_features_from_zones}


def torch_bounds():
    """Bytes each torch routine must move at the main buckets, each input
    read once and each output written once: in 2D at B = 64 x 32² extrema
    (the ROI masks and four int32 sizes and origins a ROI in, 16 float32
    points a ROI out), grouped_weight_sums (GLSZM's H * W zone slots, int64
    keys and float32 weights in; sorted keys, weights, sums and valid bytes
    out), fast_log2 (GLCM's [B, 4, 64, 64] float32 in and out) and
    bin_levels (a float32 crop and two float32 values a ROI in, int32
    levels out); in 3D at B = 8 x 32³ the GLSZM and GLDZM statistics of
    K7's zone lists (three float32 values a voxel slot in, 16 or 18
    float32 features a ROI out)."""
    B, H, W = 64, 32, 32
    A = B * H * W
    V = 8 * 32 ** 3
    return {"radial.extrema": A + 4 * 4 * B + 16 * 4 * B,
            "zones.grouped_weight_sums": A * (8 + 4) + A * (8 + 4 + 4 + 1),
            "common.fast_log2": 2 * B * 4 * 64 * 64 * 4,
            "quant.bin_levels": A * (4 + 4) + 2 * 4 * B,
            "glszm.glszm_features_from_zones": 3 * 4 * V + 16 * 4 * 8,
            "gldzm.gldzm_features_from_zones": 3 * 4 * V + 18 * 4 * 8}


def zone_cases(case, dtype, seed=0):
    """(name, levels, valid, heights, widths) inputs of the zone kernels on
    a synth bucket, as GLSZM/GLDZM hand them over (levels zeroed off valid):
    MATLAB participation (the AABB) and radiomics participation (the ROI)."""
    import torch
    B, H, W, hw = case
    _, lev, aabb, roi = synth_bucket(B, H, W, hw, seed, dtype,
                                     empty=hw == (0, 0))
    hts = torch.full((B,), hw[0], dtype=torch.int32, device="cuda")
    wds = torch.full((B,), hw[1], dtype=torch.int32, device="cuda")
    return [("aabb", torch.where(aabb, lev, 0), aabb, hts, wds),
            ("roi", torch.where(roi, lev, 0), roi, hts, wds)]


def special_zone_cases():
    """Hand-made 32 x 32 crops: a checkerboard (every GLDZM zone a single
    pixel), a uniform crop (one zone) and an empty one (no zone)."""
    import torch
    yy, xx = np.mgrid[0:32, 0:32]
    full = np.ones((1, 32, 32), bool)
    out = []
    for name, lev, valid in (
            ("checkerboard", (1 + (yy + xx) % 2)[None], full),
            ("uniform", np.full((1, 32, 32), 7), full),
            ("empty", np.full((1, 32, 32), 7), ~full)):
        hw = torch.full((1,), 32, dtype=torch.int32, device="cuda")
        out.append((name, torch.from_numpy(np.where(valid, lev, 0).astype(
            np.int32)).cuda(), torch.from_numpy(valid).cuda(), hw, hw))
    return out


def zone_kernels_agree(agree, lev, valid, hts, wds):
    """K5, K6 and K7 against their plain versions on one input; K7 is fed
    the plain labels, so each kernel is checked on its own."""
    from nyxus_tpu_torch.ops import zones
    dag = zones.zone_labels_plain(lev, valid)
    agree("zone_dag", zones.zone_labels(lev, valid), dag)
    cc4, dist = zones.zone_cc4_plain(lev, valid, hts, wds)
    for got, want in zip(zones.zone_cc4(lev, valid, hts, wds), (cc4, dist)):
        agree("zone_cc4", got, want)
    for anc, d in ((dag, None), (cc4, dist)):
        zone_stats_paths_agree(agree, anc, lev, valid, d)


def cc4_crop(H, W, kind, seed=0, device="cuda"):
    """(levels, valid, heights, widths) of two H x W crops of K6: "random"
    64 levels on ~95% of the pixels with zero-level holes, "uniform" one
    level everywhere (one component across every tile, the longest union
    chains), "checkerboard" two levels (every component a single pixel),
    "serpentine" level 1 on the even rows joined at alternate ends through
    the odd rows, which are level 2 (one zone that crosses every tile
    border of a row); the second crop's AABB smaller than the bucket, its
    levels 0 and valid False beyond it."""
    import torch
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    if kind == "random":
        lev = r.integers(0, 65, (2, H, W))
    elif kind == "uniform":
        lev = np.full((2, H, W), 5)
    elif kind == "checkerboard":
        lev = np.broadcast_to(1 + (yy + xx) % 2, (2, H, W)).copy()
    else:
        end = np.where((yy // 2) % 2 == 0, W - 1, 0)
        snake = (yy % 2 == 0) | (xx == end)
        lev = np.broadcast_to(np.where(snake, 1, 2), (2, H, W)).copy()
    valid = r.random((2, H, W)) < (0.95 if kind == "random" else 1.0)
    hw = np.array([[H, W], [max(1, H - 7), max(1, W - 11)]], np.int32)
    inside = ((yy[None] < hw[:, 0, None, None])
              & (xx[None] < hw[:, 1, None, None]))
    valid &= inside
    lev = np.where(valid, lev, 0).astype(np.int32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return to(lev), to(valid), to(hw[:, 0]), to(hw[:, 1])


# K6's crops past its shared-memory path (the tiled path) and its kinds
CC4_SHAPES = ((161, 161), (256, 256), (1024, 64))
CC4_KINDS = ("random", "uniform", "checkerboard", "serpentine")


def cc4_paths_agree(agree):
    """K6 equal to zone_cc4_plain (labels and distances) on cc4_crop's
    kinds at CC4_SHAPES, each by its plan (the tiled path); returns the
    number of calls."""
    from nyxus_tpu_torch.ops import zones
    n = 0
    for H, W in CC4_SHAPES:
        if zones.zone_cc4_plan(H, W)[0] != "tiled":
            raise AssertionError("zone_cc4: %d x %d is not on the tiled "
                                 "path" % (H, W))
        for kind in CC4_KINDS:
            lev, valid, hts, wds = cc4_crop(H, W, kind)
            for got, want in zip(zones.zone_cc4(lev, valid, hts, wds),
                                 zones.zone_cc4_plain(lev, valid, hts, wds)):
                agree("zone_cc4", got, want)
            n += 1
    return n


def zone_stats_plans(B, A, has_dist):
    """Every K7 plan for B ROIs of A pixels: one block a ROI; clusters of 2
    and 16 blocks a ROI (slabs of 4 pixels and empty slabs included), each
    where its shared memory fits a block; the grid path as its plan gives
    it, with blocks of one warp (128 pixels: many blocks, so that runs
    cross blocks even on small crops) and of 1024 threads (runs joined
    across 32 warps).  On a tree without the grid path (an older tree
    under --kernel-times), its device path."""
    from nyxus_tpu_torch.ops import zones
    from nyxus_tpu_torch.ops.common import SMEM_MAX
    out = []
    for C in (1, 2, 16):
        S = zones.zone_stats_slab(A, C)
        smem = zones.zone_stats_smem(S, has_dist)
        T = min(zones.ZS_THREADS_MAX, 32 * max(1, -(-S // 128)))
        if smem <= SMEM_MAX:
            out.append(("smem" if C == 1 else "cluster", C, T, smem))
    grid = getattr(zones, "zone_stats_grid_plan", None)
    if grid is None:
        return out + [("device", 0, 256, 0)]
    for plan in (grid(A), ("grid", -(-A // 128), 32, 0),
                 ("grid", -(-A // 4096), 1024, 0)):
        if plan not in out:
            out.append(plan)
    return out


def forced_zone_stats_plan(plan):
    """K7's plan replaced by one that returns ``plan`` whatever the shape;
    returns the original (put it back with zones.zone_stats_plan = saved)."""
    from nyxus_tpu_torch.ops import zones
    saved = zones.zone_stats_plan
    zones.zone_stats_plan = lambda B, A, has_dist: plan
    return saved


def zone_stats_paths_agree(agree, anc, lev, valid, dist):
    """K7 against zone_list_plain by its plan and on every plan of
    zone_stats_plans, forced; returns the number of forced plans."""
    from nyxus_tpu_torch.ops import zones
    want = zones.zone_list_plain(anc, lev, valid, dist)

    def check():
        for got, w in zip(zones.zone_list(anc, lev, valid, dist), want):
            if w is not None:
                agree("zone_stats", got, w)
    check()
    plans = zone_stats_plans(anc.shape[0], anc[0].numel(), dist is not None)
    for plan in plans:
        saved = forced_zone_stats_plan(plan)
        try:
            check()
        finally:
            zones.zone_stats_plan = saved
    return len(plans)


# K7's own cases (zone_stats_case), beyond the synth buckets; those of
# ZONE_STATS_BEYOND on the grid path by its plan
ZONE_STATS_BEYOND = ("uniform 1024²", "per-pixel 1024²", "two 1023x1021")
ZONE_STATS_CASES = ("uniform 64x32²", "per-pixel 64x32²", "A=65535",
                    "A=65536", "7x13", "labels A and non-seeds") \
    + ZONE_STATS_BEYOND + ("3D 8x32³", "3D 2x64³", "3D uniform 2x64³")


def zone_stats_case(name, device="cuda", seed=0):
    """[(anc, lev, valid, dist | None)] of one of ZONE_STATS_CASES, the
    labels from the plain versions as GLSZM (K5's, no distances) and GLDZM
    (K6's, with the distances) hand them to K7; in 3D K15's 26-connected
    labels at raw levels and 6-connected labels and distances at 64 levels.
    "uniform": one level on every pixel (one zone a ROI); "per-pixel": a
    level a pixel (a zone a pixel); A = 65535 (255 x 257, scalar loads) and
    65536 (256 x 256, 16-byte loads), clusters of 16 blocks; 7 x 13 (A not
    a multiple of 4: scalar loads and stores); "labels A and non-seeds":
    valid pixels labelled A (off every zone) or with the raster index of a
    pixel that is no seed.  Past a cluster, on the grid path by its plan:
    "uniform 1024²" one zone over all 256 blocks of the ROI (its labels all
    0: the seed is pixel 0), "per-pixel 1024²" a zone a pixel, "two
    1023x1021" (A not a multiple of 4) two ROIs of different contents, the
    first random as "labels A and non-seeds", the second a zone a row (two
    levels in turn), each across warps and blocks."""
    import torch
    from nyxus_tpu_torch.ops import texture3d as t3, zones
    r = np.random.default_rng(seed)
    if name.startswith("3D"):
        B, D = (8, 32) if "8x32" in name else (2, 64)
        _, lev, raw, aabb, dd, hh, ww = synth_cube(
            B, D, D, D, seed, torch.float32,
            "uniform" if "uniform" in name else "blob", device)
        sv = aabb & (raw != 0)
        slev = torch.where(sv, raw, -1)
        dlev = torch.where(aabb, lev, 0)
        anc26, _ = t3.cc3d_plain(slev, sv, 26)
        anc6, dist6 = t3.cc3d_plain(dlev, aabb, 6, hh, ww)
        return [(anc26, slev, sv, None), (anc6, dlev, aabb, dist6)]
    shape = {"A=65535": (2, 255, 257), "A=65536": (2, 256, 256),
             "7x13": (3, 7, 13), "uniform 1024²": (1, 1024, 1024),
             "per-pixel 1024²": (1, 1024, 1024),
             "two 1023x1021": (2, 1023, 1021)}.get(name, (64, 32, 32))
    B, H, W = shape
    if name.startswith("uniform"):
        lev = np.full(shape, 5)
        valid = np.ones(shape, bool)
    elif name.startswith("per-pixel"):
        lev = np.broadcast_to(1 + np.arange(H * W).reshape(H, W), shape)
        valid = np.ones(shape, bool)
    else:
        lev = r.integers(1, 4, shape)
        valid = r.random(shape) < 0.95
    if name.startswith("two"):
        lev[1] = 1 + np.arange(H)[:, None] % 2
        valid[1] = True
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    lev = to(np.where(valid, lev, 0).astype(np.int32))
    valid = to(valid)
    hts = torch.full((B,), H, dtype=torch.int32, device=device)
    wds = torch.full((B,), W, dtype=torch.int32, device=device)
    if name == "uniform 1024²":
        # the plain labellings' fixpoints take a round a row here
        dag = cc4 = torch.zeros(shape, dtype=torch.int32, device=device)
        dist = zones.border_distance_plain(lev, hts, wds)
    else:
        dag = zones.zone_labels_plain(lev, valid)
        cc4, dist = zones.zone_cc4_plain(lev, valid, hts, wds)
    if name in ("labels A and non-seeds", "two 1023x1021"):
        pick = r.random(shape) < 0.05
        other = to(r.integers(0, H * W, shape).astype(np.int32))
        off = r.random(shape) < 0.05
        if name.startswith("two"):
            pick[1] = off[1] = False
        pick, off = to(pick), to(off)
        dag = torch.where(pick, other, torch.where(off, H * W, dag))
        cc4 = torch.where(pick, other, torch.where(off, H * W, cc4))
    return [(dag, lev, valid, None), (cc4, lev, valid, dist)]


def dag_cases(seed=0, device="cuda"):
    """(name, levels, valid) inputs of K5 beyond the synth buckets, levels
    0-2 on ~90% of the pixels (long zones): crops 17 high of widths 1, 8,
    33, 63, 96, 99 and 130 (2, 4 and 8 columns a lane, in vectors or one by
    one), 256 (the warp path's widest) and 257 (the block path's
    narrowest), the long ROI's 1024 x 64, a 16 x 1024 rectangle and a
    one-row crop, and 40 x 40 crops: a spiral of level 1 in level 2 (and
    its mirror), a comb (teeth joined along the bottom row), a
    checkerboard, a uniform crop and an empty one."""
    import torch
    r = np.random.default_rng(seed)
    out = []
    for B, H, W in ((3, 17, 1), (3, 17, 8), (3, 17, 33), (3, 17, 63),
                    (3, 17, 96), (3, 17, 99), (3, 17, 130), (2, 17, 256),
                    (2, 17, 257), (1, 1024, 64), (2, 16, 1024), (2, 1, 200)):
        out.append(("random %dx%dx%d" % (B, H, W), r.integers(0, 3, (B, H, W)),
                    r.random((B, H, W)) < 0.9))
    H = W = 40
    yy, xx = np.mgrid[0:H, 0:W]
    full = np.ones((1, H, W), bool)
    spiral = np.full((H, W), 2)
    t, lft, btm, rgt = 0, 0, H - 1, W - 1
    while t <= btm and lft <= rgt:
        spiral[t, lft:rgt + 1] = 1
        spiral[t:btm + 1, rgt] = 1
        spiral[btm, lft:rgt + 1] = 1
        spiral[t + 2:btm + 1, lft] = 1
        t, lft, btm, rgt = t + 2, lft + 2, btm - 2, rgt - 2
    for name, lev, valid in (
            ("spiral", spiral[None], full),
            ("spiral mirrored", spiral[None, :, ::-1], full),
            ("comb", np.where((xx % 2 == 0) | (yy == H - 1), 1, 2)[None],
             full),
            ("checkerboard", (1 + (yy + xx) % 2)[None], full),
            ("uniform", np.full((1, H, W), 7), full),
            ("empty", np.full((1, H, W), 7), ~full)):
        out.append((name, lev, valid))
    return [(name, torch.from_numpy(np.where(valid, lev, 0).astype(
        np.int32)).to(device), torch.from_numpy(np.ascontiguousarray(
            valid)).to(device)) for name, lev, valid in out]


def dag_block_plan(B, H, W):
    """A plan for K5 that sends every shape to its block path (a warp of
    threads a 32 columns, at most 8)."""
    return "block", min(8, max(1, -(-W // 32))), 1, 1


def forced_dag_block():
    """K5's plan replaced by dag_block_plan; returns the original (put it
    back with zones.zone_dag_plan = saved)."""
    from nyxus_tpu_torch.ops import zones
    saved = zones.zone_dag_plan
    zones.zone_dag_plan = dag_block_plan
    return saved


def hist_cases(dtype, seed=0, device="cuda"):
    """(name, idx, weights, nbins) inputs of K1 on each of its plans and
    edges: three channels over NGTDM's 65 bins at 64 x 32² (0/1, float and
    0/1 weights); rows of several chunks (2 x 1024 x 64, the 3D 8 x 32³ at
    64 bins and one 16 x 1024 row, a cluster merged through distributed
    shared memory); GLDM's raw 4096 x 27 cells at 8 x 32³ (bins cut into
    slices) and in two channels of rows of 65536 (slices of a cluster of
    two); a uniform ROI
    (every entry in one bin, in both paths); all-zero weights and indices
    all out of range; 91-entry rows and an unaligned view (one entry a
    load); and 1,000,000 bins (18 slices)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)

    def idx(B, A, lo, hi):
        return torch.randint(lo, hi, (B, A), generator=g, device=device,
                             dtype=torch.int32)

    def ones(B, A, p=0.8):
        return (torch.rand((B, A), generator=g, device=device) < p).to(dtype)

    def floats(B, A):
        return torch.rand((B, A), generator=g, device=device,
                          dtype=dtype) * 40 * ones(B, A)

    raw = RAW_NG * 27
    cells = idx(8, 32768, -1, raw)
    cells[:, ::3] = idx(8, cells[:, ::3].shape[1], 0, 200)  # popular cells
    uni = torch.full((4, 1024), 5, dtype=torch.int32, device=device)
    uni[:, ::7] = -1                # background entries, dropped
    rows91 = idx(5, 91, -1, 40)
    wide = idx(3, 1025, -1, 100)
    return [
        ("channels 64x32^2, 65 bins", idx(64, 1024, -1, 67),
         torch.stack((ones(64, 1024), floats(64, 1024), ones(64, 1024))), 65),
        ("2 rows of 1024x64, 64 bins", idx(2, 65536, -1, 64),
         ones(2, 65536), 64),
        ("2 rows of 1024x64, 64 bins, float", idx(2, 65536, -1, 64),
         floats(2, 65536), 64),
        ("8 rows of 32^3, 64 bins, two channels", idx(8, 32768, -1, 64),
         torch.stack((ones(8, 32768), floats(8, 32768))), 64),
        ("1 row of 16x1024, 100 bins", idx(1, 16384, -1, 101),
         floats(1, 16384), 100),
        ("4096 x 27 cells at 8 x 32^3", cells, ones(8, 32768), raw),
        ("4096 x 27 cells at 8 x 32^3, float", cells, floats(8, 32768), raw),
        ("4096 x 27 cells, 2 rows of 65536, two channels",
         torch.cat((cells[:2], cells[2:4]), dim=1),
         torch.stack((ones(2, 65536), floats(2, 65536))), raw),
        ("uniform ROI, one bin", uni, torch.ones((4, 1024), dtype=dtype,
                                                 device=device), 100),
        ("uniform ROI, one bin, float", uni, floats(4, 1024) + 1, 100),
        ("uniform ROI, split bins", torch.full((2, 32768), 100000,
                                               dtype=torch.int32,
                                               device=device),
         floats(2, 32768), raw),
        ("all-zero weights", idx(8, 1024, 0, 64),
         torch.zeros((8, 1024), dtype=dtype, device=device), 64),
        ("indices out of range", torch.where(
            idx(8, 1024, 0, 2) == 0, idx(8, 1024, -50, 0),
            idx(8, 1024, 64, 120)), floats(8, 1024), 64),
        ("91-entry rows", rows91, floats(5, 91), 40),
        ("unaligned view", wide[:, 1:], floats(3, 1025)[:, 1:], 100),
        ("1,000,000 bins", idx(2, 4096, -1, 1000000), floats(2, 4096),
         1000000),
    ]


def hist_agree(agree, idx, w, nbins):
    """K1 against its plain version: equal where every weight is 0 or 1
    (counts), else within the rounding of a sum of n terms taken in
    another order, 2 n u sum|w| (u the type's unit roundoff) a bin."""
    import torch
    from nyxus_tpu_torch.ops import common
    got = common.batched_hist(idx, w, nbins)
    want = common.batched_hist_plain(idx, w, nbins)
    if got.shape != want.shape:
        raise AssertionError("batched_hist: shape %s != %s"
                             % (tuple(got.shape), tuple(want.shape)))
    unit = torch.finfo(w.dtype).eps / 2
    n = common.batched_hist_plain(idx, torch.ones_like(idx, dtype=torch.float64),
                                  nbins)
    for c, wc in enumerate(w if w.dim() == 3 else [w]):
        g, x = (got[c], want[c]) if w.dim() == 3 else (got, want)
        if bool(((wc == 0) | (wc == 1)).all()):
            agree("batched_hist", g, x)
        else:
            tot = common.batched_hist_plain(idx, wc.abs().double(), nbins)
            agree("batched_hist", g, x, 1.0, 2 * n * unit * tot)


# ---------------------------------------------------------------------------
# K4 neigh_matrix: the 8-neighbour families' matrices


def neigh_family_args(orig, lev, aabb, roi, nbins=64):
    """K4's calls on one synth bucket as the families make them, (mode,
    levels, participation, matrix levels): GLDM the MATLAB levels with the
    original intensities (> 0 takes part), NGTDM the levels over the AABB
    and over the ROI, NGLDM the to_grayscale levels (0..nbins) over the
    ROI."""
    from nyxus_tpu_torch.ops import ngldm
    B = orig.shape[0]
    vmax = orig.reshape(B, -1).amax(dim=1).clamp(min=1)
    glev = ngldm.to_grayscale_levels(orig, vmax[:, None, None], nbins, False)
    return [("gldm", lev, orig, nbins), ("ngtdm", lev, aabb, nbins + 1),
            ("ngtdm", lev, roi, nbins + 1), ("ngldm", glev, roi, nbins + 1)]


# K4's cases beyond the synth buckets
NEIGH_CASES = ("uniform 64x32²", "one pixel 16 x 7x13", "border 8 x 16²",
               "levels -3..70 at 64", "levels past 65533", "IBSI 256 levels",
               "IBSI 4096 levels")


def neigh_case(name, dtype, device="cuda", seed=0):
    """K4's calls (mode, levels, participation, matrix levels) on one of
    NEIGH_CASES: a uniform 64 x 32² bucket (one cell takes every pixel);
    16 one-pixel ROIs of 7 x 13 at the corners, edges and middle; 8 crops of
    16² whose ROIs cover the crop to its border, at 4 levels (many equal
    neighbours); levels -3..70 against a 64-level matrix; levels up to
    70000 against 64 (NGTDM's codes past 16 bits, read again from the
    levels); IBSI's raw 256 and 4096 levels at 64 x 32² and 8 x 32².  Each
    case runs GLDM (the original intensities), NGTDM (over the ROI and over
    the AABB) and NGLDM (over the ROI)."""
    import torch
    r = np.random.default_rng(seed)
    if name.startswith("uniform"):
        B, H, W, nb = 64, 32, 32, 64
        lev = np.full((B, H, W), 5)
        roi = np.ones((B, H, W), bool)
    elif name.startswith("one pixel"):
        B, H, W, nb = 16, 7, 13, 64
        lev = r.integers(1, 65, (B, H, W))
        roi = np.zeros((B, H, W), bool)
        spots = [(0, 0), (0, 12), (6, 0), (6, 12), (3, 6), (0, 5), (6, 7),
                 (2, 0), (4, 12), (1, 1), (5, 11), (3, 0), (0, 3), (6, 3),
                 (2, 12), (4, 4)]
        for b, (y, x) in enumerate(spots):
            roi[b, y, x] = True
    elif name.startswith("border"):
        B, H, W, nb = 8, 16, 16, 64
        lev = r.integers(1, 5, (B, H, W))
        roi = r.random((B, H, W)) < 0.85
        roi[:, 0, :] = roi[:, -1, :] = roi[:, :, 0] = roi[:, :, -1] = True
    elif name.startswith("levels -3"):
        B, H, W, nb = 8, 32, 32, 64
        lev = r.integers(-3, 71, (B, H, W))
        roi = r.random((B, H, W)) < 0.8
    elif name.startswith("levels past"):
        B, H, W, nb = 4, 32, 32, 64
        lev = np.where(r.random((B, H, W)) < 0.5,
                       r.integers(0, 70001, (B, H, W)),
                       r.integers(0, 64, (B, H, W)))
        lev[:, 8:12, 8:12] = 65535
        roi = r.random((B, H, W)) < 0.9
    else:
        nb = int(name.split()[1])
        B, H, W = (64, 32, 32) if nb == 256 else (8, 32, 32)
        lev = r.integers(0, nb, (B, H, W))
        roi = r.random((B, H, W)) < 0.9
    aabb = np.ones((B, H, W), bool)
    orig = np.where(roi, np.abs(lev) + 0.5, 0.0)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(
        device)
    lev_t = t(lev, torch.int32)
    roi_t = t(roi, torch.bool)
    return [("gldm", lev_t, t(orig, dtype), nb),
            ("ngtdm", lev_t, roi_t, nb + 1),
            ("ngtdm", lev_t, t(aabb, torch.bool), nb + 1),
            ("ngldm", lev_t, roi_t, nb + 1)]


def neigh_plans(mode, B, H, W, nbins, esz):
    """Every launch plan K4 can take on a call: its own, then one block a
    ROI and clusters of 2, 4 and 16 blocks where their shared memory holds
    the call, and the device path."""
    from nyxus_tpu_torch.ops import common
    out = [common.neigh_matrix_plan(mode, B, H, W, nbins, esz)]
    for C in (1, 2, 4, 16, 0):
        alt = common.neigh_matrix_blocks(mode, H, W, nbins, esz, C)
        if alt is not None and alt not in out:
            out.append(alt)
    return out


def neigh_agree(agree, mode, lev, part, nbins, dtype, forced=True):
    """K4 against its plain version on one family call, by its plan and
    (``forced``) on every other plan of neigh_plans, forced: GLDM's and
    NGLDM's P and NGTDM's N and present equal, NGTDM's S within 2 n u S of
    a cell of n terms (the sum of n positive terms in two orders, u the
    unit roundoff); each call one K4 launch and no K1 launch.  Returns the
    number of plans held."""
    import torch
    from nyxus_tpu_torch.ops import common
    want = common.neigh_matrix_plain(mode, lev, part, nbins, dtype)
    B, H, W = lev.shape
    esz = torch.empty((), dtype=dtype).element_size()
    u = 2.0 ** -53 if esz == 8 else 2.0 ** -24
    plans = [None] + (neigh_plans(mode, B, H, W, nbins, esz)[1:]
                      if forced else [])
    saved = common.neigh_matrix_plan
    for plan in plans:
        if plan:
            common.neigh_matrix_plan = lambda *a, p=plan: p
        k4, k1 = common.neigh_matrix.launches, common.batched_hist.launches
        try:
            got = common.neigh_matrix(mode, lev, part, nbins, dtype)
        finally:
            common.neigh_matrix_plan = saved
        if (common.neigh_matrix.launches - k4,
                common.batched_hist.launches - k1) != (1, 0):
            raise AssertionError("neigh_matrix %s: %d K4 and %d K1 launches "
                                 "a call" % (mode,
                                             common.neigh_matrix.launches - k4,
                                             common.batched_hist.launches
                                             - k1))
        if mode == "ngtdm":
            agree("neigh_matrix", got[0], want[0])
            agree("neigh_matrix", got[2], want[2])
            agree("neigh_matrix", got[1], want[1], 2 * u,
                  want[0].double() * want[1].double().abs())
        else:
            agree("neigh_matrix", got, want)
    return len(plans)


def glcm_plans(B, H, W, ng, na, symmetric, esz, offset=1):
    """Every launch plan K2 can take on a call: its own, then one block a
    ROI and clusters of 2, 4 and 16 blocks, at each angle group size, where
    their shared memory holds the call, and the device path adding into the
    output (bits 24 / 53) and into an int32 scratch (bits 32), with the
    crop staged where it fits and read from device memory."""
    from nyxus_tpu_torch.ops import glcm
    out = [glcm.glcm_cooc_plan(B, H, W, ng, na, symmetric, esz, offset)]
    for C in (1, 2, 4, 16):
        if C > max(H, 1):
            continue
        for AG in sorted({-(-na // g) for g in range(1, na + 1)}):
            alt = glcm.glcm_cooc_blocks(H, W, ng, na, offset, C, AG)
            if alt is not None and alt not in out:
                out.append(alt)
    for bits in (53 if esz == 8 else 24, 32):
        alt = glcm.glcm_cooc_device(B, H, W, ng, na, bits, offset)
        for p in (alt, alt[:5] + (0,)):
            if p not in out:
                out.append(p)
    return out


def glcm_agree(agree, orig, lev, angles, offset, ng, symmetric, forced=True):
    """K2 against its plain version (counts equal) by its plan and
    (``forced``) on every other plan of glcm_plans, forced; one K2 launch a
    call.  Returns the number of plans held."""
    from nyxus_tpu_torch.ops import glcm
    want = glcm.cooc_matrices_plain(orig, lev, angles, offset, ng, symmetric)
    B, H, W = orig.shape
    plans = [None]
    if forced:
        plans += glcm_plans(B, H, W, ng, len(angles), symmetric,
                            orig.element_size(), offset)[1:]
    saved = glcm.glcm_cooc_plan
    for plan in plans:
        if plan:
            glcm.glcm_cooc_plan = lambda *a, p=plan: p
        k2 = glcm.cooc_matrices.launches
        try:
            got = glcm.cooc_matrices(orig, lev, angles, offset, ng, symmetric)
        finally:
            glcm.glcm_cooc_plan = saved
        if glcm.cooc_matrices.launches - k2 != 1:
            raise AssertionError("glcm_cooc: %d launches a call"
                                 % (glcm.cooc_matrices.launches - k2))
        agree("glcm_cooc", got, want)
    return len(plans)


GLCM_CASES = ("uniform 64x32²", "checkerboard 64x32²", "empty 4 x 32²",
              "NaN, negatives and levels -3..70", "65535 in a 16-bit cell",
              "65522 symmetric 181²", "65536 uniform 256²",
              "IBSI 256 levels", "512 levels 8 x 32²",
              "IBSI 4096 levels 1024 x 64")


def glcm_case(name, dtype, device="cuda", seed=0):
    """K2's calls (orig, levels, angles, offset, ng, symmetric) on one of
    GLCM_CASES: a uniform and a checkerboard (levels 1 and 64) 64 x 32²
    bucket, every angle, both symmetries; empty crops; intensities NaN or
    negative beside levels outside 1..64; a uniform 255 x 257 crop paired
    with itself (offset 0), whose one cell counts 65535 (the most a 16-bit
    count holds; its own plan a cluster, one block of 16-bit counts among
    the forced plans), its symmetric twin 181² (65522 after the transpose
    is added), and 256² (65536: 32-bit counts in one block); IBSI's 256 raw levels (symmetric) at 64 x
    32², 512 levels at 8 x 32² (the device path, several ROIs and bands)
    and IBSI's 4096 raw levels on the long ROI (1 x 1024 x 64 with a 600 x
    40 ROI)."""
    import torch
    r = np.random.default_rng(seed)
    all4 = (0, 45, 90, 135)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(
        device)
    if name.startswith("uniform"):
        lev = np.full((64, 32, 32), 5)
        orig = np.full(lev.shape, 3.0)
        calls = [(all4, 1, 64, s) for s in (False, True)]
    elif name.startswith("checkerboard"):
        yy, xx = np.mgrid[0:32, 0:32]
        lev = np.broadcast_to(np.where((yy + xx) % 2, 64, 1), (64, 32, 32))
        orig = lev * 7.0
        calls = [(all4, 1, 64, s) for s in (False, True)] \
            + [((45, 135), 2, 64, True)]
    elif name.startswith("empty"):
        lev = r.integers(1, 65, (4, 32, 32))
        orig = np.zeros(lev.shape)
        calls = [(all4, 1, 64, True)]
    elif name.startswith("NaN"):
        lev = r.integers(-3, 71, (8, 32, 32))
        orig = r.normal(5, 5, lev.shape)
        orig[r.random(lev.shape) < 0.1] = np.nan
        calls = [(all4, 1, 64, s) for s in (False, True)]
    elif name.startswith("65535"):
        lev = np.full((1, 255, 257), 3)
        orig = np.ones(lev.shape)
        calls = [((0,), 0, 8, False)]
    elif name.startswith("65522"):
        lev = np.full((1, 181, 181), 3)
        orig = np.ones(lev.shape)
        calls = [((0,), 0, 8, True)]
    elif name.startswith("65536"):
        lev = np.full((1, 256, 256), 3)
        orig = np.ones(lev.shape)
        calls = [((0,), 0, 8, False)]
    elif name.startswith("IBSI 256"):
        lev = r.integers(0, 257, (64, 32, 32))
        orig = np.where(r.random(lev.shape) < 0.9, lev + 0.5, 0.0)
        calls = [(all4, 1, 256, True), (all4, 1, 256, False)]
    elif name.startswith("512"):
        lev = r.integers(1, 513, (8, 32, 32))
        orig = np.where(r.random(lev.shape) < 0.9, lev + 0.5, 0.0)
        calls = [(all4, 1, 512, True), ((90,), 2, 512, False)]
    else:
        lev = np.zeros((1, 1024, 64), np.int64)
        lev[0, :600, :40] = r.integers(1, 4097, (600, 40))
        orig = np.where(lev > 0, lev + 0.5, 0.0)
        calls = [(all4, 1, 4096, True)]
    o, lv = t(orig, dtype), t(lev, torch.int32)
    return [(o, lv, a, off, ng, s) for a, off, ng, s in calls]


def runs_cases(seed=0, device="cuda"):
    """(name, levels, valid, ng, nr) inputs of K3 beyond the synth buckets:
    a uniform ROI (one run the length of each line; and with nr 8, every
    run clamped) and a checkerboard (every run of length 1) at 64 x 32²;
    one valid pixel a ROI; an empty mask; valid levels outside 1..ng (0,
    negative, ng + 1 and 1000: dropped, each ending its neighbours' runs);
    widths that 4 and 32 do not divide and odd heights (3 x 7 x 13, 3 x 33
    x 70, 2 x 17 x 30); the long ROI's 2 x 1024 x 64 at 64 levels and nr
    1024 (device-memory counts); 2048 levels at 2 x 32² (16-bit counts)
    and 4096 (device-memory counts)."""
    import torch
    r = np.random.default_rng(seed)
    out = []
    yy, xx = np.mgrid[0:32, 0:32]
    full = np.ones((64, 32, 32), bool)
    out.append(("uniform", np.full((64, 32, 32), 5), full, 64, 32))
    out.append(("uniform nr 8", np.full((64, 32, 32), 5), full, 64, 8))
    out.append(("checkerboard", np.broadcast_to(1 + (yy + xx) % 2,
                                                (64, 32, 32)), full, 64, 32))
    one = np.zeros((8, 16, 16), bool)
    one[np.arange(8), r.integers(0, 16, 8), r.integers(0, 16, 8)] = True
    out.append(("one pixel", r.integers(1, 65, (8, 16, 16)), one, 64, 16))
    out.append(("empty", r.integers(1, 65, (4, 32, 32)),
                np.zeros((4, 32, 32), bool), 64, 32))
    far = r.choice(np.array([-3, -1, 0, 17, 1000]), (4, 32, 32))
    out.append(("levels outside 1..ng",
                np.where(r.random((4, 32, 32)) < 0.6,
                         r.integers(1, 4, (4, 32, 32)), far),
                r.random((4, 32, 32)) < 0.9, 16, 32))
    for B, H, W in ((3, 7, 13), (3, 33, 70), (2, 17, 30)):
        out.append(("random %dx%dx%d" % (B, H, W),
                    r.integers(1, 4, (B, H, W)), r.random((B, H, W)) < 0.9,
                    8, max(H, W)))
    out.append(("long 2x1024x64", r.integers(1, 3, (2, 1024, 64)),
                r.random((2, 1024, 64)) < 0.95, 64, 1024))
    for ng in (2048, 4096):
        out.append(("%d levels" % ng,
                    np.where(r.random((2, 32, 32)) < 0.5,
                             r.integers(1, ng + 1, (2, 32, 32)), ng),
                    r.random((2, 32, 32)) < 0.95, ng, 32))
    return [(name, torch.from_numpy(np.ascontiguousarray(lev).astype(
        np.int32)).to(device), torch.from_numpy(np.ascontiguousarray(
            valid)).to(device), ng, nr) for name, lev, valid, ng, nr in out]


def runs_paths(H, W, ng, nr):
    """Every (path, code bits) K3's kernel can take for these sizes: counts
    in 32-bit or (H * W <= 65535) 16-bit shared memory or in device memory,
    the crop staged as 16-bit (ng < 65535) or 32-bit codes or read from
    device memory (code bits 0), where the block's shared memory holds
    them."""
    from nyxus_tpu_torch.ops import glrlm
    from nyxus_tpu_torch.ops.common import SMEM_MAX
    out = []
    for path in ("smem32", "smem16", "device"):
        for code in (16, 32, 0):
            if (code == 16 and ng >= 65535) or (path == "smem16"
                                                and H * W > 65535):
                continue
            if glrlm.glrlm_runs_layout(H, W, ng, nr, path,
                                       code)[2] <= SMEM_MAX:
                out.append((path, code))
    return out


def forced_runs_plan(path, code):
    """K3's plan replaced by one that takes (path, code bits) whatever the
    shape; returns the original (put it back with glrlm.glrlm_runs_plan =
    saved)."""
    from nyxus_tpu_torch.ops import glrlm
    saved = glrlm.glrlm_runs_plan

    def plan(B, H, W, ng, nr, esz):
        return (path, code, 16 if path == "smem16" else 32, 1,
                glrlm.glrlm_runs_layout(H, W, ng, nr, path, code)[2])
    glrlm.glrlm_runs_plan = plan
    return saved


def runs_paths_agree(agree, lev, valid, ng, nr, dtype):
    """K3 against its plain version on every path of runs_paths; returns
    the number of paths."""
    from nyxus_tpu_torch.ops import glrlm
    want = glrlm.run_matrices_plain(lev, valid, ng, nr, dtype)
    agree("glrlm_runs", glrlm.run_matrices(lev, valid, ng, nr, dtype), want)
    paths = runs_paths(*lev.shape[1:], ng, nr)
    for path, code in paths:
        saved = forced_runs_plan(path, code)
        try:
            agree("glrlm_runs", glrlm.run_matrices(lev, valid, ng, nr, dtype),
                  want)
        finally:
            glrlm.glrlm_runs_plan = saved
    return len(paths)


def quads_cases(seed=0, device="cuda"):
    """Masks of K9 beyond the synth buckets: full (uniform) and
    checkerboard 64 x 32² crops, one pixel a ROI, an empty mask, heights and
    widths that are odd or not a multiple of 4, 16 or 32 (3 x 7 x 13, 5 x
    31 x 32, 3 x 33 x 70, 2 x 17 x 30, 1 x 40 x 1000), rows of 96 (three
    words, 16-byte loads), the long ROI's 2 x 1024 x 64 and 2 x 256²."""
    import torch
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32]
    out = [("full", np.ones((64, 32, 32), bool)),
           ("checkerboard", np.broadcast_to((yy + xx) % 2 == 0,
                                            (64, 32, 32))),
           ("empty", np.zeros((4, 32, 32), bool))]
    one = np.zeros((8, 16, 16), bool)
    one[np.arange(8), r.integers(0, 16, 8), r.integers(0, 16, 8)] = True
    out.append(("one pixel", one))
    for B, H, W in ((3, 7, 13), (5, 31, 32), (3, 33, 70), (2, 17, 30),
                    (1, 40, 1000), (2, 100, 96), (2, 1024, 64),
                    (2, 256, 256)):
        out.append(("random %dx%dx%d" % (B, H, W),
                    r.random((B, H, W)) < r.choice([0.05, 0.5, 0.95])))
    return [(name, torch.from_numpy(np.ascontiguousarray(m)).to(device))
            for name, m in out]


def quads_paths(B, H, W):
    """Every K9 plan for B masks of H x W: the warp path in 32-bit words a
    row up to 32 x 32 and in 64-bit words two rows a lane up to 64 x 64,
    the block path where its bit rows fit shared memory, the device path."""
    from nyxus_tpu_torch.ops import binary
    from nyxus_tpu_torch.ops.common import SMEM_MAX, SMS
    NW = -(-W // 32)
    smem = 4 * binary.binary_quads_words(H, W)
    rois = min(binary.QUADS_WARP_ROIS, max(1, -(-B // SMS)))
    out = []
    if H <= 32 and W <= 32:
        out.append(("warp", rois, 1, 0))
    if H <= binary.QUADS_WARP_SIDE and W <= binary.QUADS_WARP_SIDE:
        out.append(("warp", rois, 2, 0))
    if smem + binary.QUADS_STATIC_SMEM <= SMEM_MAX:
        out.append(("block", 1, NW, smem))
    out.append(("device", 1, NW, 0))
    return out


def quads_paths_agree(agree, mask):
    """K9 against its plain version by its plan and with each plan of
    quads_paths forced; returns the number of paths."""
    from nyxus_tpu_torch.ops import binary
    want = binary.binary_quads_plain(mask)
    for got, w in zip(binary.binary_quads(mask), want):
        agree("binary_quads", got, w)
    paths = quads_paths(*mask.shape)
    saved = binary.binary_quads_plan
    for plan in paths:
        binary.binary_quads_plan = lambda B, H, W, plan=plan: plan
        try:
            for got, w in zip(binary.binary_quads(mask), want):
                agree("binary_quads", got, w)
        finally:
            binary.binary_quads_plan = saved
    return len(paths)


def shape_cases(case, dtype, seed=0):
    """(name, mask, heights, widths) inputs of the shape kernels K8-K10 on
    a synth bucket: the ROI mask (an ellipse with ~3% holes) and its AABB."""
    import torch
    B, H, W, hw = case
    _, _, _, roi = synth_bucket(B, H, W, hw, seed, dtype, empty=hw == (0, 0))
    hts = torch.full((B,), hw[0], dtype=torch.int32, device="cuda")
    wds = torch.full((B,), hw[1], dtype=torch.int32, device="cuda")
    return [("roi", roi, hts, wds)]


def special_shape_cases(device="cuda"):
    """Hand-made crops: 32 x 32 empty, full and checkerboard ones (a full
    AABB never erodes, its frozen border feeding the interior, so its count
    stops at the cap of 1000), and a 256 x 256 bucket holding a solid disk
    of radius 127.5 beside disks of radius 9.5 and 3.5, so that one ROI's
    long erosion (131 steps) runs beside short ones (9 and 4) in the same
    launch."""
    import torch
    yy, xx = np.mgrid[0:32, 0:32]
    out = []
    for name, m in (("empty", np.zeros((1, 32, 32), bool)),
                    ("full", np.ones((1, 32, 32), bool)),
                    ("checkerboard", ((yy + xx) % 2 == 0)[None])):
        hw = torch.full((1,), 32, dtype=torch.int32, device=device)
        out.append((name, torch.from_numpy(m).to(device), hw, hw))
    yy, xx = np.mgrid[0:256, 0:256]
    disk = np.zeros((3, 256, 256), bool)
    for k, r in enumerate((127.5, 9.5, 3.5)):
        disk[k] = (yy - r) ** 2 + (xx - r) ** 2 <= r * r
    out.append(("disk256", torch.from_numpy(disk).to(device),
                torch.tensor([256, 20, 8], dtype=torch.int32, device=device),
                torch.tensor([256, 20, 8], dtype=torch.int32, device=device)))
    return out


def moment_inputs(mask, dtype, seed=0, uniform=False):
    """(intens, area, logw) of K10 on a mask, as the runner hands them
    over: intensities in 1..4000 (or 1000 everywhere with ``uniform``) on
    and off the mask (the kernel masks them), the mask's pixel count (at
    least 1: a ROI has a pixel) and logw = log(d + 0.001) on the mask, d a
    random distance in 0..20 (negative and positive weights)."""
    import torch
    g = torch.Generator(device=mask.device).manual_seed(seed)
    inten = torch.floor(torch.rand(mask.shape, generator=g, device=mask.device,
                                   dtype=dtype) * 4000 + 1)
    if uniform:
        inten = torch.full_like(inten, 1000)
    lw = torch.log(torch.rand(mask.shape, generator=g, device=mask.device,
                              dtype=dtype) * 20 + 0.001) * mask.to(dtype)
    area = mask.reshape(mask.shape[0], -1).sum(dim=1).clamp(min=1)
    return inten, area.to(torch.int32), lw


def moment_planes_of(intens, mask, logw):
    """K10's four weight planes, as moments.moment_sums_plain forms them."""
    import torch
    from nyxus_tpu_torch.ops import moments
    mw = mask.to(intens.dtype)
    mi = torch.where(mask, intens, 0)
    return [mw, mi, moments.moment_planes(mi, logw)[1],
            moments.moment_planes(mw, logw)[1]]


def sums_scale(planes, centre=None):
    """float64 [B, P, 4, 4] sums of |w| |x - ox|^i |y - oy|^j: the scale of
    the rounding of a power sum whose terms are added in another order."""
    import torch
    B, H, W = planes[0].shape
    dev = planes[0].device
    xs = torch.arange(W, dtype=torch.float64, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.float64, device=dev)[None, :, None]
    out = []
    for k, w in enumerate(planes):
        x, y = xs, ys
        if centre is not None:
            x = (xs - centre[:, k, 0, None, None].double()).abs()
            y = (ys - centre[:, k, 1, None, None].double()).abs()
        a = w.abs().double()
        out.append(torch.stack([torch.stack(
            [(a * x ** i * y ** j).sum(dim=(1, 2)) for j in range(4)], dim=1)
            for i in range(4)], dim=1))
    return torch.stack(out, dim=1)


def bits(t):
    """The bit patterns of a float tensor (NaNs compare equal)."""
    import torch
    return t.contiguous().view(torch.int64 if t.dtype == torch.float64
                               else torch.int32)


def moment_sums_agree(agree, intens, mask, area, logw):
    """K10 (moments.moment_power_sums) against its plain version on one
    input, with and without logw: the raw sums within rtol 1e-6 (f32) /
    1e-12 (f64) of sums_scale; each centre bit-equal to the plain one
    where the three raw sums it reads are bit-equal, else within that
    rtol; the centred and the ellipse's sums within the same rtol of the
    plain sums around the kernel's own centres."""
    import torch
    from nyxus_tpu_torch.ops import moments
    dtype = intens.dtype
    rtol = 1e-6 if dtype == torch.float32 else 1e-12
    planes = moment_planes_of(intens, mask, logw)
    for lw in (logw, None):
        P = 4 if lw is not None else 2
        got = moments.moment_power_sums(intens, mask, area, lw)
        want = moments.moment_sums_plain(intens, mask, area, lw)
        agree("power_sums", got.raw, want.raw, rtol, sums_scale(planes[:P]))
        same = ((got.raw[:, :, 0, 0] == want.raw[:, :, 0, 0])
                & (got.raw[:, :, 1, 0] == want.raw[:, :, 1, 0])
                & (got.raw[:, :, 0, 1] == want.raw[:, :, 0, 1]))
        same = torch.cat([same, same[:, :1]], dim=1)
        if not torch.equal(bits(got.centres)[same], bits(want.centres)[same]):
            raise AssertionError("power_sums: a centre differs where its "
                                 "sums are equal")
        agree("power_sums", got.centres, want.centres, rtol,
              want.centres.abs().double() + 1)
        cen = got.centres[:, :P]
        agree("power_sums", got.central,
              moments.power_sums_plain(planes[:P], cen), rtol,
              sums_scale(planes[:P], cen))
        ell = got.centres[:, P:]
        agree("power_sums", got.ellipse,
              moments.power_sums_plain(planes[:1], ell)[:, 0], rtol,
              sums_scale(planes[:1], ell)[:, 0])


def power_sums_paths(B, H, W, esz, P):
    """K10's launch plans to force beside power_sums_plan's own: one block
    a (ROI, plane) with the plane staged where it fits, a cluster of three
    (chunks that end mid-row), and the same two reading the inputs again
    (no staging)."""
    from nyxus_tpu_torch.ops import moments
    A = H * W
    plan = moments.power_sums_plan(B, H, W, esz, P)
    threads = plan[3]
    room = moments.SMEM_MAX - moments.PS_STATIC_SMEM
    paths = []
    for C in (1, 3):
        chunk = -(-A // C)
        C = -(-A // chunk) if A else 1
        if chunk * esz <= room:
            paths.append(("staged", C, chunk, threads, chunk * esz))
        paths.append(("global", C, chunk, threads, 0))
    return [plan] + [p for p in paths if p != plan]


def moment_paths_agree(agree, intens, mask, area, logw):
    """moment_sums_agree by K10's plan and on each of power_sums_paths,
    forced; returns how many paths were held."""
    from nyxus_tpu_torch.ops import moments
    B, H, W = mask.shape
    paths = power_sums_paths(B, H, W, intens.element_size(), 4)
    saved = moments.power_sums_plan
    try:
        for path in paths:
            moments.power_sums_plan = lambda *a, p=path: p
            moment_sums_agree(agree, intens, mask, area, logw)
    finally:
        moments.power_sums_plan = saved
    return len(paths)


def erosion_plans(B, H, W):
    """Every K8 plan for B masks of H x W: the warp path in 32-bit (W <= 32)
    and 64-bit words (W <= 64) at H <= 128; the block path where its
    planes fit, with its plan's threads and with 64 (a thread walking many
    rows); the dist path with its plan's 8 warps a row-pass block and
    with one."""
    from nyxus_tpu_torch.ops import binary
    from nyxus_tpu_torch.ops.common import SMEM_MAX
    out = []
    if H <= binary.EROSION_WARP_H:
        for bits, wmax in ((32, 32), (64, binary.EROSION_WARP_W)):
            if W <= wmax:
                out.append(("warp", bits, 32, 0))
    NW = -(-W // 64)
    smem = 16 * H * NW
    if smem <= SMEM_MAX:
        T = 32 * -(-NW * min(H, binary.EROSION_THREADS_MAX // NW) // 32)
        out += [("block", 64, t, smem) for t in sorted({T, 64})]
    warps = getattr(binary, "EROSION_DIST_WARPS", None)  # None: a parent
    out += [("dist", 16, 32 * k, k * 8 * -(-W // 32))
            for k in ((warps, 1) if warps else ())]
    return out


def forced_erosion_plan(plan):
    """K8's plan replaced by one that returns ``plan`` whatever the shape;
    returns the original (put it back with binary.erosion_plan = saved)."""
    from nyxus_tpu_torch.ops import binary
    saved = binary.erosion_plan
    binary.erosion_plan = lambda B, H, W: plan
    return saved


def erosion_paths_agree(agree, mask, hts, wds):
    """K8 against erosion_counts_plain by its plan and on every plan of
    erosion_plans, forced, and the plain distance form against
    erosion_counts_plain; returns the number of forced plans."""
    from nyxus_tpu_torch.ops import binary
    want = binary.erosion_counts_plain(mask, hts, wds)
    agree("erosion", binary.erosion_counts_dist_plain(mask, hts, wds), want)
    agree("erosion", binary.erosion_counts(mask, hts, wds), want)
    plans = erosion_plans(*mask.shape)
    for plan in plans:
        saved = forced_erosion_plan(plan)
        try:
            agree("erosion", binary.erosion_counts(mask, hts, wds), want)
        finally:
            binary.erosion_plan = saved
    return len(plans)


# K8's own cases (erosion_case), beyond the synth buckets; the last three
# past the block path (held once in phase 2: the kernel reads no dtype)
EROSION_BEYOND = ("whole-slide 2048²", "disk 969x960", "box 2100²")
EROSION_CASES = ("full 32²", "w31", "w32", "w33", "w63", "w64", "w65",
                 "7x13", "128x64", "129x64", "disk256", "long 1024x64",
                 "tall 1024x64") + EROSION_BEYOND


def erosion_case(name, device="cuda", seed=0):
    """(mask, heights, widths) of one of EROSION_CASES: two full 32² AABBs
    (the cap: the frozen border feeds the interior); three solid ellipses of
    AABB 40 x W in a 44 x W bucket, W = 31 to 65 (32- and 64-bit rows, the
    block path past 64), the third with ~5% holes; 3 x 7 x 13 random
    masks (no 16-byte rows); an ellipse filling 128 x 64 (the warp path's
    largest: 4 rows a lane) and 129 x 64 (the block path's); the 256² disk
    beside disks of 9 and 4 steps (special_shape_cases); the long ROI's 2 x
    1024 x 64 bucket (a 600 x 40 ellipse); an ellipse filling 1024 x 64
    (150 steps); past the block path, the whole-slide ROI's mask (1024²
    ones, its 1025² box in a 2048² bucket: the cap, T = 1022), an ellipse
    filling 969 x 960 with ~0.2% holes, and a 2100² box of ones inside a
    zero frame (its 2102² AABB in a 4096² bucket: the count stops at the
    cap with the distance finite)."""
    import torch
    r = np.random.default_rng(seed)

    def ellipse(B, H, W, h, w):
        yy, xx = np.mgrid[0:H, 0:W]
        e = (((yy - (h - 1) / 2) / (h / 2)) ** 2
             + ((xx - (w - 1) / 2) / (w / 2)) ** 2 <= 1.0)
        return np.broadcast_to(e, (B, H, W)).copy()

    if name == "disk256":
        return [c for c in special_shape_cases(device) if c[0] == name][0][1:]
    if name == "full 32²":
        m, hw = np.ones((2, 32, 32), bool), (32, 32)
    elif name == "whole-slide 2048²":
        m, hw = np.zeros((1, WS_BUCKET, WS_BUCKET), bool), (WS_SLIDE + 1,) * 2
        m[0, :WS_SLIDE, :WS_SLIDE] = True
    elif name == "disk 969x960":
        m, hw = ellipse(1, 969, 960, 969, 960), (969, 960)
        m &= r.random(m.shape) >= 0.002
    elif name == "box 2100²":
        m, hw = np.zeros((1, 4096, 4096), bool), (2102, 2102)
        m[0, 1:2101, 1:2101] = True
    elif name.startswith("w"):
        W = int(name[1:])
        m, hw = ellipse(3, 44, W, 40, W), (40, W)
        m[2] &= r.random((44, W)) >= 0.05
    elif name == "7x13":
        m, hw = r.random((3, 7, 13)) < 0.9, (7, 13)
    elif name == "long 1024x64":
        m, hw = ellipse(2, 1024, 64, 600, 40), (600, 40)
    elif name == "tall 1024x64":
        m, hw = ellipse(1, 1024, 64, 1024, 64), (1024, 64)
    else:
        H = int(name.split("x")[0])
        m, hw = ellipse(2, H, 64, H, 64), (H, 64)
    B = m.shape[0]
    return (torch.from_numpy(np.ascontiguousarray(m)).to(device),
            torch.full((B,), hw[0], dtype=torch.int32, device=device),
            torch.full((B,), hw[1], dtype=torch.int32, device=device))


def shape_kernels_agree(agree, mask, hts, wds, dtype, seed=0):
    """K8, K9 and K10 against their plain versions on one input, K8 on every
    path (erosion_paths_agree), K10 on random and on uniform intensities
    (moment_sums_agree)."""
    from nyxus_tpu_torch.ops import binary
    erosion_paths_agree(agree, mask, hts, wds)
    for got, want in zip(binary.binary_quads(mask),
                         binary.binary_quads_plain(mask)):
        agree("binary_quads", got, want)
    for uniform in (False, True):
        inten, area, lw = moment_inputs(mask, dtype, seed, uniform)
        moment_sums_agree(agree, inten, mask, area, lw)


# Gabor banks K11 is held at: the main path's (16 taps a side, four
# filters), five filters at 10 (two filter groups in the count pass), odd
# and large kernels (9, 31: 78 KB of shared memory in f64), 64 (its taps
# read from device memory) and 160 (in f64 its input tile too)
GABOR_BANKS = {"n16": {}, "n10x5": {"gabor_kersize": 10,
                                    "gabor_thetas": (0, 30, 60, 90, 120),
                                    "gabor_freqs": (2, 4, 8, 16, 32)},
               "n9": {"gabor_kersize": 9}, "n31": {"gabor_kersize": 31},
               "n64": {"gabor_kersize": 64}, "n160": {"gabor_kersize": 160}}
# K12's sums (float64, both versions forming the same terms) against the
# plain version: a fraction of the sum of the terms' absolute values
ZERNIKE_RTOL = 1e-12


def gz_inputs(case, dtype, seed=0):
    """(img, heights, widths) of K11 and K12 on a synth bucket: the masked
    intensities and the AABB."""
    import torch
    B, H, W, hw = case
    orig, _, _, _ = synth_bucket(B, H, W, hw, seed, dtype, empty=hw == (0, 0))
    hts = torch.full((B,), hw[0], dtype=torch.int32, device="cuda")
    wds = torch.full((B,), hw[1], dtype=torch.int32, device="cuda")
    return orig, hts, wds


def special_gz_cases(dtype):
    """(name, img, heights, widths): a 32 x 32 bucket holding a blank ROI
    (one intensity) and a 3 x 3 ROI of intensities 1 and 2 whose baseline
    magnitudes are all 0 (flat: maxval == cmpval), a 32 x 32 checkerboard
    of intensities 1..4000, and the three 256² disks of special_shape_cases
    with intensities 1..4000."""
    import torch
    yy, xx = np.mgrid[0:32, 0:32]
    img = np.zeros((2, 32, 32))
    img[0] = np.where(((yy - 14.5) / 15) ** 2 + ((xx - 12) / 12.5) ** 2 <= 1,
                      700.0, 0.0)
    img[1, :3, :3] = 1 + np.arange(9).reshape(3, 3) % 2
    out = [("blank+flat", torch.from_numpy(img).to(dtype).cuda(),
            torch.tensor([30, 3], dtype=torch.int32, device="cuda"),
            torch.tensor([25, 3], dtype=torch.int32, device="cuda"))]
    for name, m, hts, wds in special_shape_cases():
        if name in ("checkerboard", "disk256"):
            out.append((name, moment_inputs(m, dtype)[0] * m, hts, wds))
    return out


# the Zernike tier of f32 against f64 (PREFIX_TOL), which the magnitudes
# hold against the plain version's beside the rounding of their sums; the
# blank ROIs' value, written by the kernel
ZERNIKE_TIER = PREFIX_TOL["ZERNIKE2D"]
ZERNIKE_NOVAL = 7.5


def roi_extrema(img):
    """(vmin, vmax) of each ROI's nonzero intensities (the synthetic ROIs
    hold no zero)."""
    import torch
    B = img.shape[0]
    nz = img != 0
    return (torch.where(nz, img, torch.inf).reshape(B, -1).amin(dim=1),
            torch.where(nz, img, -torch.inf).reshape(B, -1).amax(dim=1))


def zernike_agree(agree, img, hts, wds):
    """K12 (zernike.zernike_moments) against its plain version on one
    bucket, fed K10's plain raw sums: the 60 sums within ZERNIKE_RTOL of
    the sums of their terms' absolute values; the magnitudes within
    ZERNIKE_TIER of the plain ones plus those sums' rounding, the blank
    ROIs' ZERNIKE_NOVAL bit for bit."""
    import math
    import torch
    from nyxus_tpu_torch.ops import moments, zernike
    raw = moments.power_sums_plain([img])[:, 0]
    vmin, vmax = roi_extrema(img)
    args = (img, raw, hts, wds, vmin, vmax, ZERNIKE_NOVAL)
    got, got_sums = zernike.zernike_moments(*args, sums=True)
    want = zernike.zernike_moments_plain(*args)
    want_sums, scale = zernike.zernike_sums_plain(
        img, *zernike.zernike_inputs(raw, hts, wds, img.dtype), scale=True)
    agree("zernike", got_sums, want_sums, ZERNIKE_RTOL, scale)
    const = torch.tensor([(n + 1) / math.pi for n, _ in zernike.NM],
                         dtype=torch.float64, device=img.device)
    agree("zernike", got, want, 1.0,
          ZERNIKE_TIER * want.abs().double()
          + const * (scale[:, 0] + scale[:, 1]) * ZERNIKE_RTOL)
    blank = vmax == vmin
    if not torch.equal(bits(got[blank]), bits(want[blank])):
        raise AssertionError("zernike: a blank ROI's value differs")


def zernike_paths(B, H, W):
    """K12's launch plans to force beside zernike_plan's own: one block a
    ROI and a cluster of three."""
    from nyxus_tpu_torch.ops import zernike
    A = H * W
    T = zernike.ZK_THREADS
    plan = zernike.zernike_plan(B, H, W)
    paths = []
    for C in (1, 3):
        chunk = -(-A // C)
        chunk = -(-chunk // T) * T
        paths.append((-(-A // chunk) if A else 1, chunk))
    return [plan] + [p for p in dict.fromkeys(paths) if p != plan]


def zernike_paths_agree(agree, img, hts, wds):
    """zernike_agree by K12's plan and on each of zernike_paths, forced;
    returns how many paths were held."""
    from nyxus_tpu_torch.ops import zernike
    paths = zernike_paths(*img.shape)
    saved = zernike.zernike_plan
    try:
        for path in paths:
            zernike.zernike_plan = lambda *a, p=path: p
            zernike_agree(agree, img, hts, wds)
    finally:
        zernike.zernike_plan = saved
    return len(paths)


def gz_kernels_agree(agree, img, hts, wds, banks):
    """K11 (counts, baseline max and min) at each of ``banks`` and K12
    (zernike_agree) against their plain versions on one bucket.  Both K11
    versions add the taps in one order with every operation rounded on its
    own, so they agree bit for bit."""
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.ops import gabor
    for bank in banks:
        cfg = EngineConfig(**GABOR_BANKS[bank])
        for got, want in zip(gabor.gabor_counts(img, hts, wds, cfg),
                             gabor.gabor_counts_plain(img, hts, wds, cfg)):
            agree("gabor", got, want)
    zernike_agree(agree, img, hts, wds)


def gz_bounds(img, hts, wds, cfg):
    """(bytes, operations) K11 and K12 must move and do on these inputs,
    each input read once and each output written once.  K11: every AABB
    pixel convolved with the 1 + F filters, 4 operations (two multiplies,
    two adds) a tap and filter.  K12: the crop, three raw sums, the AABB
    sizes and the extrema in, 30 magnitudes out; 372 operations a nonzero
    pixel inside the unit disk (coordinates 10, angle recurrences 56,
    radius powers 10, radial polynomials 84, the 30 pairs of terms with
    their float64 sums 210) and 10 outside it, and 7 a magnitude, all
    charged at the float32 rate."""
    import torch
    from nyxus_tpu_torch.ops import moments, zernike
    B, H, W = img.shape
    esz = img.element_size()
    K = 1 + len(cfg.gabor_thetas)
    n = cfg.gabor_kersize
    px = float((hts.double() * wds.double()).sum())
    raw = moments.power_sums_plain([img])[:, 0]
    s = raw[:, 0, 0].clamp(min=1e-30)
    cx = raw[:, 1, 0] / s + 1
    cy = raw[:, 0, 1] / s + 1
    rad = torch.minimum(hts, wds).double()
    xs = torch.arange(1, W + 1, dtype=torch.float64, device=img.device)
    ys = torch.arange(1, H + 1, dtype=torch.float64, device=img.device)
    x = (xs[None, None, :] - cx[:, None, None]) / rad[:, None, None]
    y = (ys[None, :, None] - cy[:, None, None]) / rad[:, None, None]
    r = torch.sqrt(x * x + y * y)
    nz = img != 0
    disk = float((nz & (r >= zernike.EPS64) & (r <= 1)).sum())
    return {
        "gabor": (B * H * W * esz + K * 2 * n * n * esz + B * K * 4
                  + 2 * B * esz, 4.0 * n * n * K * px),
        "zernike": (B * H * W * esz + B * (3 * 8 + 2 * 4 + 2 * esz)
                    + B * 30 * esz,
                    372 * disk + 10 * (float(nz.sum()) - disk) + 7 * 30 * B),
    }


def neigh_bound(mode, B, H, W, nbins, part_bytes, esz=4):
    """(bytes, operations) K4 must move and do for one family's matrix:
    the int32 levels and the participation (part_bytes a pixel: 4 for
    GLDM's float32 intensities, 1 for a mask) read once, the matrix written
    once in the compute type (GLDM / NGLDM [B, nbins, 9]; NGTDM N and S and
    the 1-byte present [B, nbins]); 8 comparisons and a count a pixel, and
    NGTDM's 8 sums, a quotient, a difference and its add."""
    A = B * H * W
    if mode == "ngtdm":
        return A * (4 + part_bytes) + B * nbins * (2 * esz + 1), 20 * A
    return A * (4 + part_bytes) + B * nbins * 9 * esz, 9 * A


def bounds(B, H, W, ng=64, nbins=100, angles=4):
    """(bytes, operations) each kernel must move and do at a bucket of B
    crops of H x W at the timed arguments: each input read once, each output
    written once (int32 levels, labels and counts, 1-byte masks, float32
    values; K4 as NGTDM's matrices, neigh_bound)."""
    A = B * H * W
    return {
        "batched_hist": (A * 8 + B * nbins * 4, A),
        "glcm_cooc": k2_bound(B, H, W, ng, False, angles),
        "glrlm_runs": (A * 5 + B * 4 * ng * max(H, W) * 4, 4 * A),
        "neigh_matrix": neigh_bound("ngtdm", B, H, W, ng + 1, 1),
        "zone_dag": (A * 5 + A * 4, 4 * A),
        "zone_cc4": (A * 5 + B * 8 + A * 8, 6 * A),
        "zone_stats": (A * 13 + A * 13, 2 * A),
    }


def erosion_steps(mask, heights, widths):
    """Erosion steps of each ROI (the plain version's count)."""
    from nyxus_tpu_torch.ops import binary
    return binary.erosion_counts_plain(mask, heights, widths).tolist()


def erosion_work(mask, heights, widths):
    """[B] steps each ROI's count needs evaluated: up to the step that
    empties its interior, or to the first step that changes nothing (its
    count is then the cap), at most the cap; the plain version's loop with
    that second stop, on the plain version's own step."""
    import torch
    from nyxus_tpu_torch.ops import binary
    B = mask.shape[0]
    interior = binary.erosion_interior(mask, heights, widths)
    img = mask.to(torch.int32)
    steps = torch.zeros(B, dtype=torch.int64, device=mask.device)
    done = torch.zeros(B, dtype=torch.bool, device=mask.device)
    while not bool(done.all()):
        new = binary.erosion_step(img, interior)
        steps = torch.where(done, steps, steps + 1)
        stop = ((new * interior).sum(dim=(1, 2)) == 0) \
            | (new == img).all(dim=2).all(dim=1) \
            | (steps >= binary.EROSION_CAP)
        done = done | stop
        img = new
    return steps


def erosion_bound(mask, heights, widths):
    """(bytes, operations) K8 must move and do: the mask and the AABB sizes
    read once, the counts written once; the count as a distance transform
    (binary.erosion_counts_dist_plain), which needs no chain of steps: 10
    operations a pixel of the AABB's rows and columns 1 .. dim-1 (the
    source test, the row scans' two mins, the column scans' two adds and
    two mins, the max)."""
    B, H, W = mask.shape
    area = ((heights - 1).clamp(min=0) * (widths - 1).clamp(min=0))
    return B * H * W + 12 * B, 10 * float(area.double().sum())


def shape_bounds(mask, heights, widths, planes):
    """(bytes, operations) K8-K10 must move and do on these inputs, each
    input read once and each output written once.  K8: erosion_bound.  K9:
    quads_bound.  K10: power_sums_bound of its four planes."""
    B, H, W = mask.shape
    return {
        "erosion": erosion_bound(mask, heights, widths),
        "binary_quads": quads_bound(B, H, W),
        "power_sums": power_sums_bound(planes),
    }


def power_sums_bound(planes):
    """(bytes, operations) K10 must move and do on its four planes
    (moment_planes_of): the crop and logw of the planes' type and the
    1-byte mask read once, a 4-byte area a ROI; the nine sets of 16
    float64 sums and the five centres written once.  The two logw products
    a pixel; a nonzero weight's raw terms (24 multiplies, 16 additions),
    and 2 subtractions more around each of its centres (two for the
    mask's)."""
    B, H, W = planes[0].shape
    esz = planes[0].element_size()
    nz = [float((p != 0).sum()) for p in planes]
    return (B * H * W * (2 * esz + 1) + 4 * B
            + B * (9 * 16 * 8 + 5 * 2 * esz),
            2.0 * B * H * W + sum(82 * n for n in nz) + 42 * nz[0])


def k10_k12_cases(dtype):
    """(name, masked intensities, heights, widths) that K10 and K12 are
    held on by every plan: special_gz_cases (blank, flat-baseline,
    checkerboard, 256² disks), the 64 x 32² and 2 x 1024 x 64 synth
    buckets."""
    import torch
    out = special_gz_cases(dtype)
    for B, H, W, hw in (CASES[0], CASES[7]):
        orig = synth_bucket(B, H, W, hw, 1, dtype)[0]
        out.append(("synth %dx%dx%d" % (B, H, W), orig,
                    torch.full((B,), hw[0], dtype=torch.int32, device="cuda"),
                    torch.full((B,), hw[1], dtype=torch.int32,
                               device="cuda")))
    return out


def check_kernels():
    """Every kernel against its plain version; returns per-kernel results."""
    import torch
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.ops import (binary, common, gabor, glcm, glrlm,
                                     moments, ngtdm, zernike, zones)
    res = {k: {"max_abs_err": 0.0} for k in KERNELS_2D}

    def agree(name, got, want, rtol=0.0, scale=None):
        if got.shape != want.shape:
            raise AssertionError("%s: shape %s != %s" % (name, got.shape,
                                                          want.shape))
        diff = (got.double() - want.double()).abs()
        err = float(diff.max()) if got.numel() else 0.0
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        if scale is not None:
            if not bool((diff <= rtol * scale).all()):
                raise AssertionError("%s: beyond rtol %g of the sums' scale "
                                     "(max abs %g)" % (name, rtol, err))
        elif rtol == 0.0:
            if not torch.equal(got, want):
                raise AssertionError("%s: counts differ (max abs %g)"
                                     % (name, err))
        elif not torch.allclose(got, want, rtol=rtol, atol=rtol):
            raise AssertionError("%s: beyond rtol %g (max abs %g)"
                                 % (name, rtol, err))

    for prec, dtype, rtol in (("f32", torch.float32, 1e-6),
                              ("f64", torch.float64, 1e-12)):
        for ci, (B, H, W, hw) in enumerate(CASES):
            orig, lev, aabb, roi = synth_bucket(B, H, W, hw, ci, dtype,
                                                empty=hw == (0, 0))
            flat = (lev - 1).reshape(B, -1)
            cnt = roi.reshape(B, -1).to(dtype)
            g = torch.Generator(device="cuda").manual_seed(ci)
            wts = torch.rand(cnt.shape, generator=g, device="cuda",
                             dtype=dtype) * 40 * cnt
            idx100 = torch.randint(-1, 101, cnt.shape, generator=g,
                                   device="cuda", dtype=torch.int32)
            # a bin of a large crop sums ~1000 float32 terms in another order
            wtol = rtol if H * W <= 4096 else 10 * rtol
            for idx, w, nb, tol in ((flat, cnt, 64, 0.0),
                                    (idx100, cnt, 100, 0.0),
                                    (flat * 9 + (flat % 9), cnt, 576, 0.0),
                                    (flat, wts, 65, wtol)):
                agree("batched_hist", common.batched_hist(idx, w, nb),
                      common.batched_hist_plain(idx, w, nb), tol)
            for sym in (False, True):
                glcm_agree(agree, orig, lev, (0, 45, 90, 135), 1, 64, sym)
            nr = max(H, W)
            agree("glrlm_runs", glrlm.run_matrices(lev, aabb, 64, nr, dtype),
                  glrlm.run_matrices_plain(lev, aabb, 64, nr, dtype))
            for mode, nlev, part, nb in neigh_family_args(orig, lev, aabb,
                                                          roi):
                neigh_agree(agree, mode, nlev, part, nb, dtype)
            for _, zl, zv, hts, wds in zone_cases((B, H, W, hw), dtype, ci):
                zone_kernels_agree(agree, zl, zv, hts, wds)
            for _, sm, hts, wds in shape_cases((B, H, W, hw), dtype, ci):
                shape_kernels_agree(agree, sm, hts, wds, dtype, ci)
            banks = ["n16", "n10x5"] + (["n9", "n31"] if ci < 2 else []) \
                + (["n64", "n160"] if (H, W) == (7, 13) else [])
            gz_kernels_agree(agree, *gz_inputs((B, H, W, hw), dtype, ci),
                             banks)
            log("  %s B=%d %dx%d roi %s: all twelve kernels agree (Gabor "
                "banks %s)" % (prec, B, H, W, hw, banks))
        # K2 at 256 levels (one angle a block, 16-bit counts; the long ROI
        # a cluster of 16), K3 at 1024-long runs (and 256 levels x 512)
        for B, H, W, hw in ((64, 32, 32, (29, 31)), (2, 1024, 64, (600, 40))):
            orig, lev, aabb, roi = synth_bucket(B, H, W, hw, 5, dtype)
            lev256 = (lev - 1) * 4 + 1 + (orig.long() % 4).to(torch.int32)
            for sym in (False, True):
                agree("glcm_cooc",
                      glcm.cooc_matrices(orig, lev256, (0, 45, 90, 135), 1,
                                         256, sym),
                      glcm.cooc_matrices_plain(orig, lev256, (0, 45, 90, 135),
                                               1, 256, sym))
            for lv, ng, nr in ((lev, 64, 1024), (lev256, 256, 512)):
                for valid in (aabb, roi):
                    agree("glrlm_runs",
                          glrlm.run_matrices(lv, valid, ng, nr, dtype),
                          glrlm.run_matrices_plain(lv, valid, ng, nr, dtype))
        for name, zl, zv, hts, wds in special_zone_cases():
            zone_kernels_agree(agree, zl, zv, hts, wds)
        if prec == "f32":  # integer kernels past shared memory: one pass
            t0 = time.perf_counter()
            n6 = cc4_paths_agree(agree)
            n8 = [erosion_paths_agree(agree, *erosion_case(name))
                  for name in EROSION_BEYOND]
            beyond = [(name, inp) for name in ZONE_STATS_BEYOND
                      for inp in zone_stats_case(name)]
            for name, (anc, _, _, dist) in beyond:
                plan = zones.zone_stats_plan(anc.shape[0], anc[0].numel(),
                                             dist is not None)
                if plan[0] != "grid":
                    raise AssertionError("zone_stats: %s is not on the grid "
                                         "path: %s" % (name, plan))
            n7 = [zone_stats_paths_agree(agree, *inp) for _, inp in beyond]
            log("  K6 on %d calls of two crops (random, uniform, "
                "checkerboard and serpentine levels at %s, the second "
                "crop's AABB smaller than its bucket) on its tiled path, "
                "K8 on %s on its dist path (%d plans), and K7 on %d inputs "
                "of %s on the grid path by its plan and on %d forced plans, "
                "agree; %.2f s with the plain versions"
                % (n6, ", ".join("%dx%d" % hw for hw in CC4_SHAPES),
                   ", ".join(EROSION_BEYOND), sum(n8), len(n7),
                   ", ".join(ZONE_STATS_BEYOND), sum(n7),
                   time.perf_counter() - t0))
        # K5 on its own cases, by its plan and with the block path forced;
        # K1 on every plan and edge
        dag = dag_cases()
        for name, zl, zv in dag:
            agree("zone_dag", zones.zone_labels(zl, zv),
                  zones.zone_labels_plain(zl, zv))
        saved = forced_dag_block()
        try:
            for name, zl, zv in dag:
                agree("zone_dag", zones.zone_labels(zl, zv),
                      zones.zone_labels_plain(zl, zv))
        finally:
            zones.zone_dag_plan = saved
        for name, idx, w, nb in hist_cases(dtype):
            hist_agree(agree, idx, w, nb)
        n2 = [glcm_agree(agree, *call) for name in GLCM_CASES
              for call in glcm_case(name, dtype)]
        log("  %s: K2 on %d calls of %d cases (uniform, checkerboard and "
            "empty crops, NaN and levels out of range, 16-bit counts at "
            "65535 and 65522 and 32-bit at 65536, IBSI's 256 levels, 512 and "
            "IBSI's 4096 levels on the long ROI) by its plan and on every "
            "plan forced: %d calls agree, one launch each"
            % (prec, len(n2), len(GLCM_CASES), sum(n2)))
        n4 = [neigh_agree(agree, *call, dtype) for name in NEIGH_CASES
              for call in neigh_case(name, dtype)]
        log("  %s: K4 on %d family calls of %d cases (uniform, one-pixel "
            "and border ROIs, levels out of range and past 16-bit codes, "
            "IBSI's 256 and 4096 levels) by its plan and on %d forced "
            "plans agree, one K4 launch and no K1 launch a call"
            % (prec, len(n4), len(NEIGH_CASES), sum(n4) - len(n4)))
        log("  %s: K5 on %d more crops (widths 1 to 1024, spiral, comb, "
            "checkerboard, uniform, empty) by its plan and with the block "
            "path forced, and K1 on %d cases of its plans agree"
            % (prec, len(dag), len(hist_cases(dtype))))
        n3 = [runs_paths_agree(agree, lv, vv, ng, nr, dtype)
              for _, lv, vv, ng, nr in runs_cases()]
        n9 = [quads_paths_agree(agree, m) for _, m in quads_cases()]
        log("  %s: K3 on %d crops (uniform, checkerboard, one pixel, empty, "
            "levels outside 1..ng, ragged widths and odd heights, the long "
            "ROI, 2048 and 4096 levels) by its plan and on %d forced paths, "
            "and K9 on %d masks by its plan and on %d forced paths, agree"
            % (prec, len(n3), sum(n3), len(n9), sum(n9)))
        n7 = [zone_stats_paths_agree(agree, *inp)
              for name in ZONE_STATS_CASES if not name.startswith("3D")
              and name not in ZONE_STATS_BEYOND
              for inp in zone_stats_case(name)]
        n8 = [erosion_paths_agree(agree, *erosion_case(name))
              for name in EROSION_CASES if name not in EROSION_BEYOND]
        log("  %s: K7 on %d inputs (uniform and per-pixel crops, A = 65535 "
            "and 65536, 7 x 13, labels A and non-seeds) by its plan and on "
            "%d forced plans, and K8 on %d masks (the cap, widths 31 to 65, "
            "128 and 129 x 64, the 256² disk, 1024 x 64) by its plan and on "
            "%d forced plans, and the plain distance form, agree"
            % (prec, len(n7), sum(n7), len(n8), sum(n8)))
        steps = []
        for name, sm, hts, wds in special_shape_cases():
            shape_kernels_agree(agree, sm, hts, wds, dtype)
            steps.append((name, erosion_steps(sm, hts, wds)))
        for name, gi, hts, wds in special_gz_cases(dtype):
            gz_kernels_agree(agree, gi, hts, wds, ["n16", "n9"])
        n10 = n12 = 0
        for name, img, hts, wds in k10_k12_cases(dtype):
            n10 += moment_paths_agree(agree, img, img != 0,
                                      *moment_inputs(img != 0, dtype)[1:])
            n12 += zernike_paths_agree(agree, img, hts, wds)
        log("  %s: K10 on %d and K12 on %d forced paths and plans (blank, "
            "flat-baseline, checkerboard, 256² disk, 64 x 32² and 1024 x 64 "
            "crops) agree" % (prec, n10, n12))
        _, gi, hts, wds = special_gz_cases(dtype)[0]
        _, mx, mn = gabor.gabor_counts(gi, hts, wds, EngineConfig())
        if not (mx[0] > mn[0] and mx[1] == mn[1]):
            raise AssertionError("gabor: the flat ROI's baseline is not flat "
                                 "(max %s, min %s)" % (mx.tolist(),
                                                       mn.tolist()))
        log("  %s: K2 at 256 levels and K3's device-memory paths (1024 and "
            "512-long runs), the checkerboard, uniform and empty zone crops "
            "and the empty, full, checkerboard and 256² disk shape crops, "
            "K11 and K12 on blank, flat-baseline and 256² disk ROIs agree; "
            "erosion steps %s" % (prec, steps))

    wholeslide_kernels_agree(agree)

    # times at the main path's commonest bucket (f32, 64 ROIs of 32 x 32),
    # then at two more buckets and on the device-memory paths
    for B, H, W, hw in CASES[:3] + ((2, 1024, 64, (600, 40)),):
        orig, lev, aabb, roi = synth_bucket(B, H, W, hw, 0, torch.float32)
        flat = (lev - 1).reshape(B, -1)
        cnt = roi.reshape(B, -1).to(torch.float32)
        flat64 = flat.long()
        nr = max(H, W)
        _, zl, zv, hts, wds = zone_cases((B, H, W, hw), torch.float32)[0]
        anc, dist = zones.zone_cc4_plain(zl, zv, hts, wds)
        _, sm, shts, swds = shape_cases((B, H, W, hw), torch.float32)[0]
        inten, sarea, slw = moment_inputs(sm, torch.float32)
        planes = moment_planes_of(inten, sm, slw)
        gimg, ghts, gwds = gz_inputs((B, H, W, hw), torch.float32)
        gcfg = EngineConfig()
        zin = (gimg, moments.power_sums_plain([gimg])[:, 0], ghts, gwds,
               *roi_extrema(gimg), ZERNIKE_NOVAL)
        pairs = {
            "batched_hist": (lambda: common.batched_hist(flat, cnt, 100),
                             lambda: common.batched_hist_plain(flat, cnt, 100)),
            "glcm_cooc": (
                lambda: glcm.cooc_matrices(orig, lev, (0, 45, 90, 135), 1, 64,
                                           False),
                lambda: glcm.cooc_matrices_plain(orig, lev, (0, 45, 90, 135),
                                                 1, 64, False)),
            "glrlm_runs": (
                lambda: glrlm.run_matrices(lev, aabb, 64, nr, torch.float32),
                lambda: glrlm.run_matrices_plain(lev, aabb, 64, nr,
                                                 torch.float32)),
            # K4 as NGTDM's matrices, its slowest family
            "neigh_matrix": (
                lambda: ngtdm.ngtdm_matrices(lev, aabb, 64, torch.float32),
                lambda: ngtdm.ngtdm_matrices_plain(lev, aabb, 64,
                                                   torch.float32)),
            "zone_dag": (lambda: zones.zone_labels(zl, zv),
                         lambda: zones.zone_labels_plain(zl, zv)),
            "zone_cc4": (lambda: zones.zone_cc4(zl, zv, hts, wds),
                         lambda: zones.zone_cc4_plain(zl, zv, hts, wds)),
            "zone_stats": (lambda: zones.zone_list(anc, zl, zv, dist),
                           lambda: zones.zone_list_plain(anc, zl, zv, dist)),
            "erosion": (lambda: binary.erosion_counts(sm, shts, swds),
                        lambda: binary.erosion_counts_plain(sm, shts, swds)),
            "binary_quads": (lambda: binary.binary_quads(sm),
                             lambda: binary.binary_quads_plain(sm)),
            "power_sums": (
                lambda: moments.moment_power_sums(inten, sm, sarea, slw),
                lambda: moments.moment_sums_plain(inten, sm, sarea, slw)),
            "gabor": (lambda: gabor.gabor_counts(gimg, ghts, gwds, gcfg),
                      lambda: gabor.gabor_counts_plain(gimg, ghts, gwds,
                                                       gcfg)),
            "zernike": (lambda: zernike.zernike_moments(*zin),
                        lambda: zernike.zernike_moments_plain(*zin)),
        }
        main = (B, H, W) == (64, 32, 32)
        iters = 20 if main else 5   # the other buckets' times are printed only
        bnd = bounds(B, H, W)
        bnd.update(shape_bounds(sm, shts, swds, planes))
        bnd.update(gz_bounds(gimg, ghts, gwds, gcfg))
        for name, (kern, plain) in pairs.items():
            # plain, kernel, kernel, plain: the pairs share clocks and cache
            p1, k1, k2, p2 = (timed(f, iters) for f in (plain, kern, kern,
                                                        plain))
            ev, ms = (k1[0] + k2[0]) / 2, (k1[1] + k2[1]) / 2
            pev, plain_ms = (p1[0] + p2[0]) / 2, (p1[1] + p2[1]) / 2
            nbytes, ops = bnd[name]
            bytes_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, ops / OPS_S * 1e3
            log("  time %-12s f32 B=%d %dx%d: device %.4f ms (events %.4f "
                "ms) vs plain device %.4f ms (events %.4f ms); bound %.5f ms"
                % (name, B, H, W, ms, ev, plain_ms, pev,
                   max(bytes_ms, ops_ms)))
            if main:
                res[name].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=None)
        if main:
            # the one PyTorch call that computes K1's function: scatter_add_
            # into a zeroed [B, nbins] (the port never calls it on the card)
            lib = timed(lambda: torch.zeros((B, 100), device="cuda")
                        .scatter_add_(1, flat64, cnt))
            res["batched_hist"]["library_ms"] = lib[1]
            log("  time batched_hist library scatter_add_: device %.4f ms "
                "(events %.4f ms)" % (lib[1], lib[0]))
            # K7's sizes and minimum distances as scatter_add_ and
            # scatter_reduce_("amin") into filled [B, A + 1] rows (not
            # called by the port)
            lib = timed(zone_stats_library(anc, zv, dist))
            res["zone_stats"]["library_ms"] = lib[1]
            log("  time zone_stats library scatter_add_ + scatter_reduce_ "
                "amin: device %.4f ms (events %.4f ms)" % (lib[1], lib[0]))
            # K10's raw sums as one einsum over its four planes (not called
            # by the port; the centred sums need their centres first):
            # sum_hw w[b,h,w] Y[q,h] X[p,w], Y = h^q, X = w^p
            wcat = torch.cat(planes).contiguous()
            pw = torch.arange(4, device="cuda", dtype=torch.float32)
            X = torch.arange(W, device="cuda", dtype=torch.float32)[None, :] \
                ** pw[:, None]
            Y = torch.arange(H, device="cuda", dtype=torch.float32)[None, :] \
                ** pw[:, None]
            lib = timed(lambda: torch.einsum("bhw,qh,pw->bpq", wcat, Y, X))
            res["power_sums"]["library_ms"] = lib[1]
            log("  time power_sums library einsum: device %.4f ms (events "
                "%.4f ms)" % (lib[1], lib[0]))
            # K11's ten real convolutions (five complex filters) as one
            # cuDNN conv2d, TF32 off (not called by the port)
            n = gcfg.gabor_kersize
            wts = gabor.filter_bank(gcfg, torch.float32, "cuda").reshape(
                -1, 1, n, n).flip(-1, -2).contiguous()
            lib = timed(lambda: torch.nn.functional.conv2d(
                gimg[:, None], wts, padding=n - 1))
            res["gabor"]["library_ms"] = lib[1]
            log("  time gabor library conv2d (10 channels, cuDNN, TF32 "
                "%s): device %.4f ms (events %.4f ms)"
                % (torch.backends.cudnn.allow_tf32, lib[1], lib[0]))
        if (B, H, W) == (2, 1024, 64):
            ms = timed(lambda: glrlm.run_matrices(lev, aabb, 64, 1024,
                                                  torch.float32))
            log("  time glrlm_runs device-memory path 64 x 1024, B=2 "
                "1024x64: device %.4f ms (events %.4f ms)" % (ms[1], ms[0]))
        if main:
            (_, dm, dh, dw), = [c for c in special_shape_cases()
                                if c[0] == "disk256"]
            ms = timed(lambda: binary.erosion_counts(dm, dh, dw))
            log("  time erosion 256² disk (131 steps) beside disks of 9 and "
                "4 steps, B=3 256x256: device %.4f ms (events %.4f ms)"
                % (ms[1], ms[0]))
            lev256 = (lev - 1) * 4 + 1 + (orig.long() % 4).to(torch.int32)
            ms = timed(lambda: glcm.cooc_matrices(orig, lev256,
                                                  (0, 45, 90, 135), 1, 256,
                                                  False))
            log("  time glcm_cooc 256 levels, B=64 32x32, plan %s: device "
                "%.4f ms (events %.4f ms)"
                % (glcm.glcm_cooc_plan(B, H, W, 256, 4, False, 4), ms[1],
                   ms[0]))
    k1_k5_times()
    return res


# ---------------------------------------------------------------------------
# phase 2, whole slide: the kernels at the whole-slide ROI's crop

WS_SLIDE = 1024     # the whole-slide slides' side (phase 3c)
WS_BUCKET = 2048    # their ROI's inclusive 1025² box pads to this bucket


def wholeslide_crop(dtype, device="cuda"):
    """The whole-slide ROI of make_dsb_like(1024, 1024) as the runner hands
    it to the kernels: one 2048² bucket holding the slide's intensities in
    its top-left 1024², masked by the ROI (the slide: 1024² ones), the AABB
    mask (the inclusive 1025 x 1025 box, all ones), the box's height and
    width 1025, and the levels at 64 as the texture families bin them
    (bin_levels over the ROI's range): (orig, lev, aabb, roi, hts, wds)."""
    import torch
    from nyxus_tpu_torch.ops import quant
    intens, _ = make_dsb_like(WS_SLIDE, WS_SLIDE)
    n, S = WS_SLIDE, WS_BUCKET
    orig = np.zeros((1, S, S))
    orig[0, :n, :n] = intens
    roi = np.zeros((1, S, S), bool)
    roi[0, :n, :n] = True
    aabb = np.zeros((1, S, S), bool)
    aabb[0, :n + 1, :n + 1] = True
    t = lambda a, dt: torch.from_numpy(a).to(dt).to(device)
    orig_t = t(orig, dtype)
    lo = torch.full((1, 1, 1), float(intens.min()), dtype=dtype,
                    device=device)
    hi = torch.full((1, 1, 1), float(intens.max()), dtype=dtype,
                    device=device)
    lev = quant.bin_levels(orig_t, lo, hi, 64)
    hw = torch.full((1,), n + 1, dtype=torch.int32, device=device)
    return orig_t, lev, t(aabb, torch.bool), t(roi, torch.bool), hw, hw


def wholeslide_ibsi(orig, roi):
    """IBSI's raw levels of the whole-slide crop at 12 bits: the
    intensities >> 4 (up to 4095 here, so max_int 4096), as intensities and
    as int32 levels, 0 off the ROI."""
    import torch
    o12 = torch.where(roi, torch.floor(orig / 16), 0)
    return o12, o12.to(torch.int32)


def wholeslide_kernels_agree(agree):
    """Phase 2, whole slide: K1-K12 against their plain versions at the
    whole-slide ROI's crop (wholeslide_crop, f32, the card's precision),
    each by its plan and held as on the synth buckets: counts, labels and
    distances equal, K1's float weights (the intensities) within 2 n u
    sum|w| a bin, K4's NGTDM sums within 2 n u S, K10's sums within rtol
    1e-6 of their scale, K11 bit for bit, K12 within its tier; then K2 at
    IBSI's 4096 raw levels on the same crop.  Logs the seconds each group
    took, plain version and checks included."""
    import torch
    from nyxus_tpu_torch.ops import glrlm
    dtype = torch.float32
    t0 = time.perf_counter()
    orig, lev, aabb, roi, hts, wds = wholeslide_crop(dtype)
    secs = {"inputs": time.perf_counter() - t0}
    all4 = (0, 45, 90, 135)
    flat = (lev - 1).reshape(1, -1)

    def k1():
        for w, nb in ((roi.reshape(1, -1).to(dtype), 64),
                      (orig.reshape(1, -1), 65)):
            hist_agree(agree, flat, w, nb)

    def k3():
        for valid in (aabb, roi):
            agree("glrlm_runs",
                  glrlm.run_matrices(lev, valid, 64, WS_BUCKET, dtype),
                  glrlm.run_matrices_plain(lev, valid, 64, WS_BUCKET, dtype))

    def k2_4096():
        o12, l12 = wholeslide_ibsi(orig, roi)
        glcm_agree(agree, o12, l12, all4, 1, 4096, True, forced=False)

    groups = (
        ("K1", k1),
        ("K2", lambda: [glcm_agree(agree, orig, lev, all4, 1, 64, sym,
                                   forced=False) for sym in (False, True)]),
        ("K3", k3),
        ("K4", lambda: [neigh_agree(agree, mode, nl, part, nb, dtype,
                                    forced=False)
                        for mode, nl, part, nb in neigh_family_args(
                            orig, lev, aabb, roi)]),
        ("K5-K7", lambda: [zone_kernels_agree(
            agree, torch.where(valid, lev, 0), valid, hts, wds)
            for valid in (aabb, roi)]),
        ("K8-K10", lambda: shape_kernels_agree(agree, roi, hts, wds, dtype)),
        ("K11-K12", lambda: gz_kernels_agree(agree, orig, hts, wds,
                                             ["n16"])),
        ("K2 at 4096 levels", k2_4096))
    for name, fn in groups:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    log("  f32 whole-slide crop (make_dsb_like(1024, 1024) in a 2048² "
        "bucket, ROI 1024², box 1025²): K1-K12 and K2 at IBSI's 4096 "
        "levels agree with their plain versions by their plans; seconds "
        "(with the plain versions) %s"
        % ", ".join("%s %.2f" % kv for kv in secs.items()))


def wholeslide_ih_inputs(dtype, device="cuda"):
    """K17's inputs at the whole-slide crop under IBSI at 12 bits: the
    64-bin histogram (the grey depth IH uses) of the ROI's raw levels over
    their range, as ih.ih_freq forms it with K1, the pixel count, the range
    and the identity map into the reporting domain."""
    import torch
    from nyxus_tpu_torch.ops import ih
    orig, _, _, roi, _, _ = wholeslide_crop(dtype, device)
    o12, _ = wholeslide_ibsi(orig, roi)
    vals = torch.where(roi, o12, float("inf")).reshape(1, -1)
    vmin = o12[roi].min().reshape(1)
    vmax = o12[roi].max().reshape(1)
    freq = ih.ih_freq(vals, vmin, vmax, 64)
    counts = roi.reshape(1, -1).sum(dim=1).to(dtype)
    return (freq, counts, vmin, vmax, torch.ones_like(vmin),
            torch.zeros_like(vmin))


# ---------------------------------------------------------------------------
# phase 2, 3D: K13-K16 and K1's split path


# (B, D, H, W) batches of the 3D buckets 8^3 to 64^3 and a 64 x 256 x 256
# crop; the 32^3 batch is where the kernels are timed
CUBES = ((64, 8, 8, 8), (32, 16, 16, 16), (8, 32, 32, 32), (2, 64, 64, 64),
         (1, 64, 256, 256))
MAIN_CUBE = (8, 32, 32, 32)
RAW_NG = 4096   # the matrix size of raw 12-bit levels (GLRLM/GLSZM/GLDM)


def synth_cube(B, D, H, W, seed, dtype, kind="blob", device="cuda"):
    """A padded 3D bucket of B ellipsoid ROIs with ~3% holes, the first
    filling its D x H x W cube and the others AABBs of random sizes:
    (masked 12-bit intensities, MATLAB levels at 64, raw levels, the AABB
    mask, depths, heights, widths).  kind "empty": no ROI voxel; "uniform":
    every AABB voxel a ROI voxel of intensity 1000."""
    import torch
    from nyxus_tpu_torch.ops import quant, texture3d
    r = np.random.default_rng(seed)
    dims = np.stack([r.integers(max(1, n // 2), n + 1, B) for n in (D, H, W)],
                    axis=1)
    dims[0] = (D, H, W)
    zz, yy, xx = np.ogrid[0:D, 0:H, 0:W]
    roi = np.zeros((B, D, H, W), bool)
    for b, (d, h, w) in enumerate(dims):
        inside = (zz < d) & (yy < h) & (xx < w)
        if kind == "uniform":
            roi[b] = inside
            continue
        roi[b] = inside & ((((zz - (d - 1) / 2) / (d / 2)) ** 2
                            + ((yy - (h - 1) / 2) / (h / 2)) ** 2
                            + ((xx - (w - 1) / 2) / (w / 2)) ** 2) <= 1.0)
    if kind == "blob":
        roi &= r.random(roi.shape) < 0.97
    elif kind == "empty":
        roi[:] = False
    intens = np.floor(r.normal(2000, 500, roi.shape)).clip(1, 4095)
    if kind == "uniform":
        intens[:] = 1000.0
    orig = torch.from_numpy(np.where(roi, intens, 0)).to(dtype).to(device)
    vmax = orig.reshape(B, -1).amax(dim=1).clamp(min=1)[:, None, None, None]
    lev = quant.bin_levels(orig, vmax, vmax, 64)
    dd, hh, ww = (torch.from_numpy(dims[:, k].astype(np.int32)).to(device)
                  for k in range(3))
    aabb = texture3d._in_aabb3d((D, H, W), dd, hh, ww)
    return orig, lev, orig.to(torch.int32), aabb, dd, hh, ww


def kernels_3d_agree(agree, cube, dtype, rtol, big_glcm=False):
    """K13-K16, K7 on the 3D labels (on every plan, forced) and K1 against
    their plain versions on
    one synth_cube, with the inputs the 3D families hand them: K13 at 64
    levels (offsets 1 and 2, with and without the transpose) and, with
    ``big_glcm``, at 4096 raw levels (device memory); K14 at 64 levels and
    at 4096 raw levels (device memory); K15 with both connectivities on
    GLSZM's and GLDZM's inputs at both level sets; K16 with the GLDM (N26)
    and NGLDM (N24) tables and NGTDM windows of radius 1 and 2; K1 on
    GLDM's 4096 x 27 cells (split path) with 0/1 weights and float
    weights (within ``rtol``, or within the rounding bound of a sum taken
    in another order where a cell sums many terms), and at 64 bins with
    0/1 weights and dyadic weights (multiples of 1/4: a bin's sum, below
    2^22 even at the 64 x 256 x 256 crop, is exact in either type, so that
    rows of many chunks must agree exactly whatever the atomics' order)."""
    import torch
    from nyxus_tpu_torch.ops import common, texture3d as t3, zones
    orig, lev, raw, aabb, dd, hh, ww = cube
    B = lev.shape[0]
    nr = max(lev.shape[1:])
    for o, sym, ibsi in ((1, False, False), (2, True, False)):
        agree("glcm3d_cooc",
              t3.glcm3d_cooc(lev, dd, hh, ww, o, 64, sym, ibsi, dtype),
              t3.glcm3d_cooc_plain(lev, dd, hh, ww, o, 64, sym, ibsi, dtype))
    if big_glcm:
        one = (raw[:1], dd[:1], hh[:1], ww[:1])
        agree("glcm3d_cooc",
              t3.glcm3d_cooc(*one, 1, RAW_NG, True, True, dtype),
              t3.glcm3d_cooc_plain(*one, 1, RAW_NG, True, True, dtype))
    rvalid = aabb & (raw > 0)
    for lv, valid, ng in ((lev, aabb, 64), (raw, rvalid, RAW_NG)):
        agree("glrlm3d_runs", t3.glrlm3d_runs(lv, valid, ng, nr, dtype),
              t3.glrlm3d_runs_plain(lv, valid, ng, nr, dtype))
    for inp, valid, want in k15_k16_agree(agree, cube):
        zone_stats_paths_agree(agree, want[0], inp, valid, want[1])
    glev = torch.where(aabb, raw, -9)
    same = t3.stencil3d_plain(glev, aabb, t3.N26)
    cells = common._composite((raw - 1).reshape(B, -1), same.reshape(B, -1),
                              RAW_NG, 27)
    ones = aabb.reshape(B, -1).to(dtype)
    g = torch.Generator(device="cuda").manual_seed(B)
    wts = torch.rand(ones.shape, generator=g, device="cuda", dtype=dtype)
    dyadic = torch.floor(wts * 4) / 4 * ones
    flat = (lev - 1).reshape(B, -1)
    for idx, w, nb in ((cells, ones, RAW_NG * 27), (flat, ones, 64),
                       (flat, dyadic, 64)):
        agree("batched_hist", common.batched_hist(idx, w, nb),
              common.batched_hist_plain(idx, w, nb))
    # float weights: within rtol, or where a cell sums many terms (a uniform
    # cube's few cells, the crop's) within the rounding of a sum of n
    # non-negative terms taken in another order, 2 n u sum(w) (u the type's
    # unit roundoff)
    nb = RAW_NG * 27
    want = common.batched_hist_plain(cells, wts * ones, nb)
    n = common.batched_hist_plain(cells, ones.double(), nb)
    total = common.batched_hist_plain(cells, (wts * ones).double(), nb)
    unit = torch.finfo(dtype).eps / 2
    agree("batched_hist", common.batched_hist(cells, wts * ones, nb), want,
          scale=torch.maximum(rtol * want.abs().double(),
                              2 * n * unit * total))


def k15_k16_agree(agree, cube):
    """K15 with both connectivities on GLSZM's and GLDZM's inputs at 64 and
    at raw levels, and K16 with the GLDM (N26) and NGLDM (N24) tables and
    NGTDM windows of radius 1 and 2, against their plain versions on one
    synth_cube, by whichever paths the plans choose; returns K15's (levels,
    valid, plain result) for the zone lists."""
    import torch
    from nyxus_tpu_torch.ops import texture3d as t3
    _, lev, raw, aabb, _, hh, ww = cube
    labels = []
    for lv, zero_i, gvalid in ((lev, 1, aabb), (raw, 0, aabb & (raw > 0))):
        sv = aabb & (lv != zero_i)
        slev = torch.where(sv, lv, -1)
        dlev = torch.where(aabb, lv, 0)
        for inp, valid, conn in ((slev, sv, 26), (dlev, gvalid, 6)):
            got = t3.cc3d(inp, valid, conn, hh, ww)
            want = t3.cc3d_plain(inp, valid, conn, hh, ww)
            for g, w in zip(got, want):
                if w is not None:
                    agree("cc3d", g, w)
            labels.append((inp, valid, want))
    glev = torch.where(aabb, raw, -9)
    for lv, table in ((glev, t3.N26), (lev, t3.N24_NGLDM)):
        agree("stencil3d", t3.stencil3d(lv, aabb, table),
              t3.stencil3d_plain(lv, aabb, table))
    nlev = torch.where(aabb, lev, 0)
    for radius in (1, 2):
        for g, w in zip(t3.stencil3d(nlev, aabb, radius=radius),
                        t3.stencil3d_plain(nlev, aabb, radius=radius)):
            agree("stencil3d", g, w)
    return labels


def bounds_3d(cube, ng_glcm=64, ng_runs=RAW_NG):
    """(bytes, operations) K13-K16 must move and do on one synth_cube at the
    timed arguments (the main path's: GLCM at 64 levels, runs at raw 12-bit
    levels, GLSZM's 26-connected labels, GLDM's 26-shift table), each input
    read once and each output written once (int32 levels, labels, distances
    and counts, 1-byte masks, float32 matrices).  Operations: K13 one count
    a pair with both ends in the AABB, K14 one compare a voxel and
    direction, K15 one compare a voxel and forward neighbour (13), K16 one
    compare a voxel and shift (26).  Beside them the other modes of K15 and
    K16: GLDZM's 6-connected labels with the distances ("cc3d_dist": 13
    bytes a voxel, three compares and the four directions' scan steps),
    NGLDM's 24-shift table ("stencil3d_n24") and NGTDM's window of radius 1
    ("stencil3d_window": 13 bytes a voxel, an add to the sum and one to the
    count a neighbour)."""
    _, lev, _, aabb, dd, hh, ww = cube
    B, D, H, W = lev.shape
    A = B * D * H * W
    from nyxus_tpu_torch.ops import texture3d as t3
    d, h, w = (t.double() for t in (dd, hh, ww))
    pairs = 0.0
    for dx, dy, dz in t3.GLCM_SHIFTS:
        pairs += float(((d - abs(dz)).clamp(min=0) * (h - abs(dy)).clamp(min=0)
                        * (w - abs(dx)).clamp(min=0)).sum())
    return {
        "glcm3d_cooc": (A * 4 + 12 * B + B * 13 * ng_glcm ** 2 * 4, pairs),
        "glrlm3d_runs": (A * 5 + B * 13 * ng_runs * max(D, H, W) * 4, 13 * A),
        "cc3d": (A * 5 + A * 4, 13 * A),
        "stencil3d": (A * 5 + A * 4, 26 * A),
        "cc3d_dist": (A * 5 + A * 8 + 8 * B, 7 * A),
        "stencil3d_n24": (A * 5 + A * 4, 24 * A),
        "stencil3d_window": (A * 5 + A * 8, 52 * A),
    }


# K5's timed buckets: the main path's three and the long ROI's
K5_TIMED = ((64, 32, 32), (47, 64, 64), (28, 16, 16), (1, 1024, 64))


def k1_k5_inputs():
    """K1's timed calls as (name, idx, weights, nbins): the intensity
    histogram's 100 bins at 64 x 32² (the main bucket) and 47 x 64²,
    NGTDM's three channels of 65 bins at 64 x 32², the 3D 8 x 32³ rows at
    64 bins (four chunks of the first design) and GLDM's raw 4096 x 27
    cells at 8 x 32³ (beyond a block's shared memory), all f32."""
    import torch
    out = []
    for B, H, W, hw in (CASES[0], (47, 64, 64, (60, 47))):
        _, lev, _, roi = synth_bucket(B, H, W, hw, 0, torch.float32)
        flat = (lev - 1).reshape(B, -1)
        cnt = roi.reshape(B, -1).to(torch.float32)
        out.append(("100 bins B=%d %dx%d" % (B, H, W), flat, cnt, 100))
        if (B, H, W) == (64, 32, 32):
            diff = torch.rand(cnt.shape, generator=torch.Generator(
                device="cuda").manual_seed(0), device="cuda") * 30
            out.append(("NGTDM's 3 channels of 65 bins B=64 32x32", lev
                        .reshape(B, -1), torch.stack((cnt, cnt * diff, cnt)),
                        65))
    cube = synth_cube(*MAIN_CUBE, 0, torch.float32)
    _, lev, raw, aabb, _, _, _ = cube
    B = lev.shape[0]
    ones = aabb.reshape(B, -1).to(torch.float32)
    out.append(("64 bins B=8 32x32x32", (lev - 1).reshape(B, -1), ones, 64))
    from nyxus_tpu_torch.ops import common, texture3d as t3
    same = t3.stencil3d_plain(torch.where(aabb, raw, -9), aabb, t3.N26)
    cells = common._composite((raw - 1).reshape(B, -1), same.reshape(B, -1),
                              RAW_NG, 27)
    out.append(("4096 x 27 cells B=8 32x32x32", cells, ones, RAW_NG * 27))
    return out


def k1_k5_times(iters=20):
    """K5 at K5_TIMED and K1 at k1_k5_inputs, f32, with their launch plans:
    device and events ms a call, device launches a call (from the
    profiler) and the bytes bound; K5 also with the block path forced and,
    where the tree has it, the dependent chain of its warp path alone (no
    loads: the floor of the sweep); and a one-block torch fill_, the fixed
    cost of any launch on the profiler's clock.  K1's channel form is three calls where
    the tree's K1 takes no channels.  Runs on any tree's package (a tree
    without the plans prints none), so that two trees can be timed in turn
    (--kernel-times)."""
    import torch
    from nyxus_tpu_torch.ops import common, zones
    dplan = getattr(zones, "zone_dag_plan", None)
    hplan = getattr(common, "batched_hist_plan", None)
    for B, H, W in K5_TIMED:
        hw = {32: (29, 31), 64: (60, 47), 16: (13, 9)}.get(W, (600, 40))
        _, zl, zv, _, _ = zone_cases((B, H, W, hw), torch.float32)[0]
        nbytes = bounds(B, H, W)["zone_dag"][0]
        ev, ms, nl = timed(lambda: zones.zone_labels(zl, zv), iters)
        log("  K5 zone_dag f32 B=%d %dx%d: device %.4f ms (events %.4f ms), "
            "%s device launches a call; bound %.5f ms (bytes); plan (path, "
            "warps a row, ROIs a block, columns a lane) %s"
            % (B, H, W, ms, ev, nl, nbytes / HBM_BYTES_S * 1e3,
               dplan(B, H, W) if dplan else "none in this tree"))
        if dplan:
            saved = forced_dag_block()
            try:
                ev, ms, nl = timed(lambda: zones.zone_labels(zl, zv), iters)
            finally:
                zones.zone_dag_plan = saved
            log("  K5 zone_dag block path forced f32 B=%d %dx%d: device %.4f "
                "ms (events %.4f ms)" % (B, H, W, ms, ev))
        if hasattr(zones, "zone_dag_chain"):
            ev, ms, nl = timed(lambda: zones.zone_dag_chain(B, H), iters)
            log("  K5 zone_dag chain alone (H = %d dependent row steps, no "
                "loads) B=%d: device %.4f ms (events %.4f ms)"
                % (H, B, ms, ev))
    # the fixed cost of any launch on the profiler's clock: one small fill_
    small = torch.empty(64, device="cuda")
    ev, ms, nl = timed(lambda: small.fill_(0), iters)
    log("  a launch's floor (torch fill_ of 64 floats, one block): device "
        "%.4f ms (events %.4f ms)" % (ms, ev))
    for name, idx, w, nb in k1_k5_inputs():
        C, B, A = (w.shape if w.dim() == 3 else (1,) + tuple(w.shape))
        if w.dim() == 3 and not hplan:
            def call():
                for wc in w:
                    common.batched_hist(idx, wc, nb)
        else:
            def call():
                common.batched_hist(idx, w, nb)
        ev, ms, nl = timed(call, iters)
        nbytes = B * A * 4 + C * B * A * 4 + C * B * nb * 4
        log("  K1 batched_hist %s f32: device %.4f ms (events %.4f ms), %s "
            "device launches a call; bound %.5f ms (bytes); plan (path, "
            "cluster, chunk, threads, copies, bins a block, smem) %s"
            % (name, ms, ev, nl, nbytes / HBM_BYTES_S * 1e3,
               hplan(B, A, nb, C, 4) if hplan else "none in this tree"))


# K3's timed calls: the main path's three buckets at 64 levels, IBSI's 256
# at 64 x 32², the uniform and checkerboard 64 x 32² crops of runs_cases and
# the long ROI's device-memory counts; K9's the main three buckets, the
# long ROI's and 2 x 256²
K3_K9_TIMED = CASES[:3] + ((2, 1024, 64, (600, 40)),)


def quads_bound(B, H, W):
    """(bytes, operations) K9 must move and do: the mask read once and the
    int32 counts written once; 10 operations a 2 x 2 window, and the box
    counts as a pyramid makes them, every box of scale s at any of its
    origins the union of four origin-0 boxes of scale s/2 (3 ORs) adding
    one to its count."""
    from nyxus_tpu_torch.ops import binary
    SB, S = binary.n_scales(H, W)
    boxes = 0
    for s in (SB >> i for i in range(S)):
        shifts = (((0, 0), (s // 2, 0), (0, s // 2), (s // 2, s // 2))
                  if s <= 32 else ((0, 0),))
        boxes += sum(-(-(H + oy) // s) * -(-(W + ox) // s)
                     for ox, oy in shifts)
    return (B * H * W + 4 * B * (3 + 4 * S),
            B * (10 * (H + 1) * (W + 1) + 4 * boxes))


def k3_k9_times(iters=20):
    """K3 and K9 in f32 at K3_K9_TIMED with their launch plans: device and
    events ms a call, device launches a call (from the profiler) and the
    bound.  K3 as GLRLM calls it under MATLAB binning (the AABB valid, nr
    the bucket's side) at 64 levels, at 256 levels at 64 x 32² and on the
    uniform and checkerboard crops; K9 on the synth buckets' ROI masks and
    2 x 256², and at 64 x 32² also on its 64-bit warp path forced (where
    the tree has the plan).  Runs on any tree's package (a tree without
    the plans prints none), so that two trees can be timed in turn
    (--kernel-times)."""
    import torch
    from nyxus_tpu_torch.ops import binary, glrlm
    rplan = getattr(glrlm, "glrlm_runs_plan", None)
    qplan = getattr(binary, "binary_quads_plan", None)
    f32 = torch.float32

    def runs(name, lev, valid, ng, nr):
        B, H, W = lev.shape
        ev, ms, nl = timed(lambda: glrlm.run_matrices(lev, valid, ng, nr,
                                                      f32), iters)
        nbytes = B * H * W * 5 + B * 4 * ng * nr * 4
        log("  K3 glrlm_runs %s %d levels f32 B=%d %dx%d: device %.4f ms "
            "(events %.4f ms), %s device launches a call; bound %.5f ms "
            "(bytes); plan (path, code bits, count bits, ROIs a block, smem) "
            "%s" % (name, ng, B, H, W, ms, ev, nl, nbytes / HBM_BYTES_S * 1e3,
                    rplan(B, H, W, ng, nr, 4) if rplan
                    else "none in this tree"))

    for B, H, W, hw in K3_K9_TIMED:
        orig, lev, aabb, roi = synth_bucket(B, H, W, hw, 0, f32)
        runs("synth", lev, aabb, 64, max(H, W))
        if (B, H, W) == (64, 32, 32):
            lev256 = (lev - 1) * 4 + 1 + (orig.long() % 4).to(torch.int32)
            runs("synth", lev256, aabb, 256, 32)
            for name, lv, vv, ng, nr in runs_cases():
                if name in ("uniform", "checkerboard"):
                    runs(name, lv, vv, ng, nr)
        _, sm, _, _ = shape_cases((B, H, W, hw), f32)[0]
        masks = [(sm, "synth")]
        if (B, H, W) == (2, 1024, 64):
            _, _, _, big = synth_bucket(2, 256, 256, (250, 199), 0, f32)
            masks.append((big, "synth"))
        if (B, H, W) == (64, 32, 32) and qplan:
            masks.append((sm, "64-bit warp path forced"))
        for m, name in masks:
            mB, mH, mW = m.shape
            plan = qplan(mB, mH, mW) if qplan else "none in this tree"
            if name == "64-bit warp path forced":
                plan = ("warp", plan[1], 2, 0)
                binary.binary_quads_plan = lambda B, H, W, p=plan: p
            try:
                ev, ms, nl = timed(lambda: binary.binary_quads(m), iters)
            finally:
                if qplan:
                    binary.binary_quads_plan = qplan
            nbytes, ops = quads_bound(mB, mH, mW)
            bytes_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, ops / OPS_S * 1e3
            log("  K9 binary_quads %s f32 B=%d %dx%d: device %.4f ms (events "
                "%.4f ms), %s device launches a call; bound %.5f ms (%s); "
                "plan (path, ROIs a block, words a row, smem) %s"
                % (name, mB, mH, mW, ms, ev, nl, max(bytes_ms, ops_ms),
                   "bytes" if bytes_ms >= ops_ms else "operations", plan))


def zone_stats_library(anc, valid, dist):
    """The PyTorch calls that compute K7's sizes (and minimum distances):
    scatter_add_ (and scatter_reduce_ "amin") into filled [B, A + 1] rows,
    the labels off ``valid`` sent to slot A; a function of no arguments,
    its int64 index and weights made once (the yardstick of K7's library
    time; the port never calls it)."""
    import torch
    B = anc.shape[0]
    A = anc[0].numel()
    vf = valid.reshape(B, -1)
    idx = torch.where(vf, anc.reshape(B, -1), A).long()
    ones = vf.to(torch.int32)
    df = None if dist is None else dist.reshape(B, -1).to(torch.int32)

    def call():
        size = torch.zeros((B, A + 1), dtype=torch.int32, device=anc.device)
        size.scatter_add_(1, idx, ones)
        if df is not None:
            dmin = torch.full((B, A + 1), 1 << 30, dtype=torch.int32,
                              device=anc.device)
            dmin.scatter_reduce_(1, idx, df, "amin")
    return call


# K7's timed shapes: the main path's three 2D buckets and the 3D cubes
# 8 x 32³, 42 x 16³ and 2 x 64³; K8's the main three, 1 x 1024 x 64, the
# 256² disk and the cap
K7_K8_CUBES = (MAIN_CUBE, (42, 16, 16, 16), (2, 64, 64, 64))
# a 32² bucket as full as a slide's (300 ROIs, more than the SMs)
K7_K8_WIDE = (300, 32, 32, (29, 31))


# K7's grid path against the cluster path, both forced: 2D crops of the
# whole-slide levels (H, W)
K7_GRID_VS_CLUSTER = ((512, 512), (1024, 64), (1024, 512))


def k7_large_inputs():
    """(name, anc, lev, valid, dist | None, forced) of K7 past the main
    buckets, the labels from the tree's K5, K6 and K15 as the families make
    them: GLSZM's and GLDZM's of crops K7_GRID_VS_CLUSTER of the whole-slide
    levels (AABB participation; timed on every plan forced), of the
    whole-slide 2048² bucket, of 1 x 64 x 256 x 256 (synth_cube) and of the
    whole-volume crop 1 x 128 x 512 x 512 (whole_volume_cube of
    make_volume_3d(1); 26-connected raw-level zones and 6-connected zones
    with distances), each by its plan."""
    import torch
    from nyxus_tpu_torch.ops import texture3d as t3, zones
    f32 = torch.float32
    out = []
    _, wlev, waabb, _, whts, wwds = wholeslide_crop(f32)
    wlev = torch.where(waabb, wlev, 0)
    for H, W in K7_GRID_VS_CLUSTER + ((WS_BUCKET, WS_BUCKET),):
        whole = H == WS_BUCKET
        lev = wlev[:, :H, :W].contiguous()
        valid = waabb[:, :H, :W].contiguous()
        hts, wds = (whts, wwds) if whole else (
            torch.full((1,), n, dtype=torch.int32, device="cuda")
            for n in (H, W))
        tag = "whole-slide %dx%d" % (H, W)
        anc, dist = zones.zone_cc4(lev, valid, hts, wds)
        out.append(("GLDZM %s (dist)" % tag, anc, lev, valid, dist,
                    not whole))
        out.append(("GLSZM %s" % tag, zones.zone_labels(lev, valid), lev,
                    valid, None, not whole))
    cube = synth_cube(1, 64, 256, 256, 0, f32)
    for tag, (_, lev, raw, aabb, dd, hh, ww) in (
            ("3D 64x256x256", cube),
            ("whole volume 128x512x512", whole_volume_cube(make_volume_3d(1)))):
        sv = aabb & (raw != 0)
        slev = torch.where(sv, raw, -1)
        dlev = torch.where(aabb, lev, 0)
        anc6, dist6 = t3.cc3d(dlev, aabb, 6, hh, ww)
        out.append(("GLDZM %s (dist)" % tag, anc6, dlev, aabb, dist6, False))
        out.append(("GLSZM %s" % tag, t3.cc3d(slev, sv, 26)[0], slev, sv,
                    None, False))
    return out


def grouped_sums_time(zlev, zsize, zdist, ok):
    """K7's consumer, zones.grouped_weight_sums (a torch sort, gathers, a
    cumsum and a scatter_add_), timed as GLSZM's GLN calls it on one K7
    output (float32 levels as keys, +inf off the zones, the zone weights):
    device ms and launches a call, each launch apart, and the bytes bound
    (keys and weights read, the four outputs written once)."""
    import torch
    from nyxus_tpu_torch.ops import zones
    w = ok.to(torch.float32)
    keys = torch.where(ok, zlev.to(torch.float32), float("inf"))
    ev, ms, nl = timed(lambda: zones.grouped_weight_sums(keys, w), 3)
    nbytes = keys.numel() * (4 + 4 + 4 + 4 + 4 + 1)
    log("  grouped_weight_sums (GLSZM's GLN) B=%d A=%d: device %.4f ms "
        "(events %.4f ms), %s device launches a call; bound %.5f ms "
        "(bytes); device us a call by launch: %s"
        % (keys.shape[0], keys.shape[1], ms, ev, nl,
           nbytes / HBM_BYTES_S * 1e3,
           kernel_breakdown(lambda: zones.grouped_weight_sums(keys, w))))


def k7_k8_times(iters=20):
    """K7 and K8 in f32 with their launch plans: device and events ms a
    call, device launches a call (from the profiler) and the bound.  K7 on
    GLSZM's labels (no distances) and GLDZM's (with them) at the main
    buckets (AABB participation) and at K7_K8_CUBES (K15's 26-connected
    labels at raw levels, 6-connected labels and distances at 64 levels)
    and at k7_large_inputs (3 calls a time; on a tree with the grid path
    its launches apart where it is the plan), each beside its library
    calls (zone_stats_library), and grouped_sums_time on GLSZM's zones of
    the whole-slide bucket; K8 on the synth
    buckets' ROI masks, the long ROI's 1 x 1024 x 64, the 256² disk, a full
    32² AABB (the cap) and an ellipse filling 1024 x 64 (erosion_case's
    "tall"), the longest ROI's count and the steps it needs
    beside each time, by its plan and on every plan of erosion_plans,
    forced.  Runs on any tree's package (a tree without the plans prints
    none and times the plan alone), so that two trees can be timed in turn
    (--kernel-times)."""
    import torch
    from nyxus_tpu_torch.ops import binary, texture3d as t3, zones
    zplan = getattr(zones, "zone_stats_plan", None)
    eplan = getattr(binary, "erosion_plan", None)
    f32 = torch.float32

    def k7(name, anc, lev, valid, dist, forced=False, n=iters):
        B = anc.shape[0]
        A = anc[0].numel()
        lib_ev, lib_ms, _ = timed(zone_stats_library(anc, valid, dist), n)
        nbytes = 2 * B * A * (13 if dist is not None else 9)
        plans = [None] + (zone_stats_plans(B, A, dist is not None)
                          if zplan and forced else [])
        for plan in plans:
            saved = forced_zone_stats_plan(plan) if plan else None
            try:
                ev, ms, nl = timed(
                    lambda: zones.zone_list(anc, lev, valid, dist), n)
            finally:
                if saved:
                    zones.zone_stats_plan = saved
            log("  K7 zone_stats %s f32 B=%d A=%d: device %.4f ms (events "
                "%.4f ms), %s device launches a call; library %.4f ms "
                "(events %.4f ms); bound %.5f ms (bytes); plan (path, C, "
                "threads, smem) %s%s"
                % (name, B, A, ms, ev, nl, lib_ms, lib_ev,
                   nbytes / HBM_BYTES_S * 1e3,
                   plan or (zplan(B, A, dist is not None) if zplan
                            else "none in this tree"),
                   " forced" if plan else ""))

    for B, H, W, hw in CASES[:3] + (K7_K8_WIDE,):
        _, zl, zv, hts, wds = zone_cases((B, H, W, hw), f32)[0]
        cc4, dist = zones.zone_cc4_plain(zl, zv, hts, wds)
        dag = zones.zone_labels_plain(zl, zv)
        tag = "%dx%d" % (H, W)
        tag = "%s B=%d" % (tag, B) if B == K7_K8_WIDE[0] else tag
        k7("GLDZM %s (dist)" % tag, cc4, zl, zv, dist, True)
        k7("GLSZM %s" % tag, dag, zl, zv, None, True)
    for cube_shape in K7_K8_CUBES:
        _, lev, raw, aabb, dd, hh, ww = synth_cube(*cube_shape, 0, f32)
        sv = aabb & (raw != 0)
        slev = torch.where(sv, raw, -1)
        dlev = torch.where(aabb, lev, 0)
        tag = "3D %dx%dx%d" % cube_shape[1:]
        anc6, dist6 = t3.cc3d_plain(dlev, aabb, 6, hh, ww)
        k7("GLDZM %s (dist)" % tag, anc6, dlev, aabb, dist6, True)
        k7("GLSZM %s" % tag, t3.cc3d_plain(slev, sv, 26)[0], slev, sv, None,
           True)
    for name, anc, lev, valid, dist, forced in k7_large_inputs():
        k7(name, anc, lev, valid, dist, forced, 3)
        if zplan and zplan(anc.shape[0], anc[0].numel(),
                           dist is not None)[0] == "grid":
            log("  K7 zone_stats %s, device us a call by launch: %s"
                % (name, kernel_breakdown(
                    lambda: zones.zone_list(anc, lev, valid, dist))))
        if name == "GLSZM whole-slide %dx%d" % (WS_BUCKET, WS_BUCKET):
            grouped_sums_time(*zones.zone_list(anc, lev, valid))

    masks = []
    for B, H, W, hw in CASES[:3] + (K7_K8_WIDE, (1, 1024, 64, (600, 40))):
        _, sm, hts, wds = shape_cases((B, H, W, hw), f32)[0]
        masks.append(("synth", sm, hts, wds))
    masks += [(name, *c[1:]) for c in special_shape_cases()
              for name in (c[0],) if name in ("disk256", "full")]
    masks.append(("tall", *erosion_case("tall 1024x64")))
    for name, m, hts, wds in masks:
        B, H, W = m.shape
        count = max(erosion_steps(m, hts, wds))
        if hasattr(binary, "erosion_step"):
            nbytes, ops = erosion_bound(m, hts, wds)
            need = "%d steps needed" % int(erosion_work(m, hts, wds).max())
            bound = "%.5f ms (%s)" % (
                max(nbytes / HBM_BYTES_S, ops / OPS_S) * 1e3,
                "bytes" if nbytes / HBM_BYTES_S >= ops / OPS_S
                else "operations")
        else:  # a tree without the plain step: the other tree's bound holds
            need, bound = "steps needed not counted", "not computed"
        plans = [None] + (erosion_plans(B, H, W) if eplan else [])
        for plan in plans:
            saved = forced_erosion_plan(plan) if plan else None
            try:
                ev, ms, nl = timed(lambda: binary.erosion_counts(m, hts, wds),
                                   iters)
            finally:
                if saved:
                    binary.erosion_plan = saved
            log("  K8 erosion %s f32 B=%d %dx%d (longest count %d, %s): "
                "device %.4f ms (events %.4f ms), %s device launches a call; "
                "bound %s; plan (path, word bits, threads, smem) %s%s"
                % (name, B, H, W, count, need, ms, ev, nl, bound,
                   plan or (eplan(B, H, W) if eplan else "none in this tree"),
                   " forced" if plan else ""))


# K6's and K8's crops past their shared-memory paths (k6_k8_times): K6
# (B, H, W) of cc4_crop's random levels, then the whole-slide crop; K8's
# EROSION_BEYOND, then ellipses filling 256², 512² and 968 x 960, where
# the block path and the dist path both run
K6_TIMED = ((1, 161, 161), (2, 256, 256), (1, 1024, 64))
K8_DISKS = ((256, 256), (512, 512), (968, 960))


def kernel_breakdown(fn, iters=3):
    """{kernel name: device µs a call} of fn() from one torch.profiler
    window of ``iters`` calls after a warm-up (the launches of a
    multi-launch path, each apart)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name, us in device_events(prof):
        out[name] = out.get(name, 0.0) + us / iters
    return out


def k6_k8_times(iters=3):
    """K6 and K8 past their shared-memory paths: device and events ms a
    call, device launches a call (from the profiler), the bytes bound and
    the plan.  K6 at K6_TIMED and at the whole-slide crop's 64 levels with
    the AABB and the ROI as participation (the levels, valid bytes and both
    int32 outputs once: 13 bytes a pixel of the bucket); K8 at
    EROSION_BEYOND and on ellipses filling K8_DISKS by its plan and, on a tree with the
    dist path, with the dist path forced where the plan is another (the
    mask once); on a tree with the tiled and dist paths, the whole-slide
    times by launch (kernel_breakdown).  Few calls a time:
    the first port's device paths take up to seconds a call.  Runs on any
    tree's package, so that two trees can be timed in turn
    (--kernel-times)."""
    import torch
    from nyxus_tpu_torch.ops import binary, zones
    f32 = torch.float32
    cplan = getattr(zones, "zone_cc4_plan", None)
    eplan = getattr(binary, "erosion_plan", None)
    has_dist = hasattr(binary, "erosion_counts_dist_plain")

    def k6(name, lev, valid, hts, wds):
        B, H, W = lev.shape
        ev, ms, nl = timed(lambda: zones.zone_cc4(lev, valid, hts, wds),
                           iters)
        log("  K6 zone_cc4 %s f32 B=%d %dx%d: device %.4f ms (events %.4f "
            "ms), %s device launches a call; bound %.5f ms (bytes); plan %s"
            % (name, B, H, W, ms, ev, nl,
               (13 * B * H * W + 8 * B) / HBM_BYTES_S * 1e3,
               cplan(H, W) if cplan else "none in this tree"))

    for B, H, W in K6_TIMED:
        lev, valid, hts, wds = cc4_crop(H, W, "random")
        k6("random", lev[:B], valid[:B], hts[:B], wds[:B])
    _, lev, aabb, roi, hts, wds = wholeslide_crop(f32)
    for part, valid in (("aabb", aabb), ("roi", roi)):
        k6("whole-slide 64 levels %s" % part, torch.where(valid, lev, 0),
           valid, hts, wds)

    if cplan and cplan(*lev.shape[1:])[0] == "tiled":
        zl = torch.where(aabb, lev, 0)
        log("  K6 zone_cc4 whole-slide 64 levels aabb, device us a call by "
            "launch: %s" % kernel_breakdown(
                lambda: zones.zone_cc4(zl, aabb, hts, wds)))

    def ellipse(H, W):
        yy, xx = np.mgrid[0:H, 0:W]
        e = (((yy - (H - 1) / 2) / (H / 2)) ** 2
             + ((xx - (W - 1) / 2) / (W / 2)) ** 2 <= 1.0)
        return (torch.from_numpy(e[None].copy()).cuda(),
                torch.full((1,), H, dtype=torch.int32, device="cuda"),
                torch.full((1,), W, dtype=torch.int32, device="cuda"))

    masks = [(name, *erosion_case(name)) for name in EROSION_BEYOND]
    masks += [("disk %dx%d" % hw, *ellipse(*hw)) for hw in K8_DISKS]
    for name, m, hts, wds in masks:
        B, H, W = m.shape
        nbytes, ops = erosion_bound(m, hts, wds)
        plans = [None]
        if has_dist and eplan(B, H, W)[0] != "dist":
            plans += [p for p in erosion_plans(B, H, W)
                      if p[0] == "dist"][:1]
        for plan in plans:
            saved = forced_erosion_plan(plan) if plan else None
            try:
                ev, ms, nl = timed(lambda: binary.erosion_counts(m, hts, wds),
                                   iters)
                count = binary.erosion_counts(m, hts, wds).tolist()
            finally:
                if saved:
                    binary.erosion_plan = saved
            if name == EROSION_BEYOND[0] and has_dist:
                log("  K8 erosion %s, device us a call by launch: %s"
                    % (name, kernel_breakdown(
                        lambda: binary.erosion_counts(m, hts, wds))))
            log("  K8 erosion %s f32 B=%d %dx%d (count %s): device %.4f ms "
                "(events %.4f ms), %s device launches a call; bound %.5f ms "
                "(%s); plan (path, word bits, threads, smem) %s%s"
                % (name, B, H, W, count, ms, ev, nl,
                   max(nbytes / HBM_BYTES_S, ops / OPS_S) * 1e3,
                   "bytes" if nbytes / HBM_BYTES_S >= ops / OPS_S
                   else "operations",
                   plan or (eplan(B, H, W) if eplan else "none in this tree"),
                   " forced" if plan else ""))


# K11's timed buckets (the main path's three, then 2 x 256^2, which takes
# the tile path) and K13's (the main 3D bucket, 64^3 and a 64 x 256 x 256
# crop, at 64 levels)
K11_TIMED = CASES[:3] + (CASES[6],)
K13_TIMED = (MAIN_CUBE, (2, 64, 64, 64), (1, 64, 256, 256))


def k11_k13_times(iters=20):
    """K11 and K13 in f32 at K11_TIMED and K13_TIMED with their launch
    plans, K11 also with the 64-tap bank at the main bucket and K13 at raw
    12-bit levels (its device-memory path) at MAIN_CUBE: device and events
    ms a call, device launches a call (from the profiler) and the bounds,
    K11's unfused floor (every multiply and add an instruction of its own)
    beside its operations bound.  Runs on any tree's package (a tree
    without the plans prints none), so that two trees can be timed in turn
    (--kernel-times)."""
    import torch
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.ops import gabor, texture3d as t3
    gplan = getattr(gabor, "gabor_plan", None)
    cplan = getattr(t3, "glcm3d_plan", None)
    for (B, H, W, hw), bank in [(c, "n16") for c in K11_TIMED] + [
            (CASES[0], "n64")]:
        img, hts, wds = gz_inputs((B, H, W, hw), torch.float32)
        cfg = EngineConfig(**GABOR_BANKS[bank])
        n, K = cfg.gabor_kersize, 1 + len(cfg.gabor_thetas)
        plan = gplan(B, H, W, n, K, 4) if gplan else "none in this tree"
        ev, ms, nl = timed(lambda: gabor.gabor_counts(img, hts, wds, cfg),
                           iters)
        ops = gz_bounds(img, hts, wds, cfg)["gabor"][1]
        log("  K11 gabor %s f32 B=%d %dx%d AABB %s: device %.4f ms (events "
            "%.4f ms), %s device launches a call; bound %.5f ms "
            "(operations, an FMA counted as two), unfused floor %.5f ms; "
            "plan (path, cluster, pixels and filters a thread, smem) %s"
            % (bank, B, H, W, hw, ms, ev, nl, ops / OPS_S * 1e3,
               2 * ops / OPS_S * 1e3, plan))
    for cube_shape, ng in [(c, 64) for c in K13_TIMED] + [(MAIN_CUBE,
                                                            RAW_NG)]:
        cube = synth_cube(*cube_shape, 0, torch.float32)
        _, lev, raw, _, dd, hh, ww = cube
        lv = lev if ng == 64 else raw
        plan = cplan(ng, *cube_shape[1:], 1) if cplan else "none in this tree"
        ev, ms, nl = timed(lambda: t3.glcm3d_cooc(lv, dd, hh, ww, 1, ng,
                                                  False, False,
                                                  torch.float32), iters)
        nbytes = bounds_3d(cube, ng_glcm=ng)["glcm3d_cooc"][0]
        log("  K13 glcm3d_cooc %d levels f32 B=%d %dx%dx%d: device %.4f ms "
            "(events %.4f ms), %s device launches a call; bound %.5f ms "
            "(bytes); plan (path, cluster, directions a block, threads, "
            "planes, rows, 16-bit, smem) %s"
            % ((ng,) + cube_shape + (ms, ev, nl, nbytes / HBM_BYTES_S * 1e3,
                                     plan)))


# K10's and K12's timed buckets: the main path's three, 2 x 256² and the
# long ROI's 1 x 1024 x 64
K10_K12_TIMED = CASES[:3] + ((2, 256, 256, (250, 199)),
                             (1, 1024, 64, (600, 40)))


def k10_parent_calls(moments, inten, mask, area, logw):
    """The six K10 calls of a bucket before the fused launch, with the
    torch work around them, as the families made them: the mask weights;
    the mask's and the masked intensity's raw sums (morphology), the
    ellipse's centroid and its centred sums; for the intensity moments and
    then the shape moments, the weighted plane, the raw sums, the centres
    (safe_div in the compute dtype) and the centred sums, the intensity
    moments forming their weighted plane twice (once for the raw call,
    once for the centred one).  ``moments`` is a tree's ops.moments with
    power_sums(planes, centre)."""
    import torch
    from nyxus_tpu_torch.ops.common import safe_div
    dt = inten.dtype
    mw = mask.to(dt)
    mi = torch.where(mask, inten, 0)
    S = moments.power_sums([mw, mi])[:, 0].to(dt)
    n = area.to(dt)
    moments.power_sums([mw], torch.stack([S[:, 1, 0] / n, S[:, 0, 1] / n],
                                         dim=1)[:, None, :])
    for w, twice in ((mi, True), (mw, False)):
        raw = moments.power_sums(moments.moment_planes(w, logw))
        planes = moments.moment_planes(w, logw) if twice else None
        centres = []
        for k in range(2):
            Sk = raw[:, k].to(dt)
            centres.append(torch.stack([safe_div(Sk[:, 1, 0], Sk[:, 0, 0]),
                                        safe_div(Sk[:, 0, 1], Sk[:, 0, 0])],
                                       dim=1))
        moments.power_sums(planes or moments.moment_planes(w, logw),
                           torch.stack(centres, dim=1))


def k10_k12_times(iters=20):
    """K10 and K12 in f32 at K10_K12_TIMED with their launch plans: device
    and events ms a call, device launches a call (from the profiler) and
    the bound.  K10 as the families call it: where the tree has the fused
    launch (moment_power_sums) that launch, with its plan, and at the main
    bucket also its staging off (its second pass reading the inputs
    again) and its plain version; else k10_parent_calls, its six launches
    and their torch work; and the library einsum of its four planes' raw
    sums.  K12 as the family calls it (zernike_features, fed K10's plain
    sums) and its plain version, or, where the tree has no plan, its kernel
    alone (zernike_sums); at the main bucket also one block a ROI and a
    cluster of four, forced.  Runs on
    any tree's package, so that two trees can be timed in turn
    (--kernel-times)."""
    import torch
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.ops import moments, zernike
    fused = hasattr(moments, "moment_power_sums")
    zplan = getattr(zernike, "zernike_plan", None)
    f32 = torch.float32
    for B, H, W, hw in K10_K12_TIMED:
        _, _, _, mask = synth_bucket(B, H, W, hw, 0, f32)
        inten, area, lw = moment_inputs(mask, f32)
        planes = moment_planes_of(inten, mask, lw)
        nbytes, ops = power_sums_bound(planes)
        bound = max(nbytes / HBM_BYTES_S, ops / OPS_S) * 1e3
        calls = [("fused, by its plan %s" % (moments.power_sums_plan(
            B, H, W, 4, 4),), None)] if fused else [
            ("the parent's six calls", None)]
        if fused and (B, H, W) == (64, 32, 32):
            plan = moments.power_sums_plan(B, H, W, 4, 4)
            calls.append(("fused, staging off", ("global",) + plan[1:4]
                          + (0,)))
        if fused:
            calls.append(("plain version (moment_sums_plain)", None))
        for name, force in calls:
            saved = getattr(moments, "power_sums_plan", None)
            if force:
                moments.power_sums_plan = lambda *a, p=force: p
            if name.startswith("plain"):
                fn = (lambda: moments.moment_sums_plain(inten, mask, area, lw))
            elif fused:
                fn = (lambda: moments.moment_power_sums(inten, mask, area, lw))
            else:
                fn = (lambda: k10_parent_calls(moments, inten, mask, area, lw))
            try:
                ev, ms, nl = timed(fn, iters)
            finally:
                if force:
                    moments.power_sums_plan = saved
            log("  K10 power_sums %s f32 B=%d %dx%d: device %.4f ms (events "
                "%.4f ms), %s device launches a call; bound %.5f ms (%s)"
                % (name, B, H, W, ms, ev, nl, bound,
                   "bytes" if nbytes / HBM_BYTES_S >= ops / OPS_S
                   else "operations"))
        wcat = torch.cat(planes).contiguous()
        dev = mask.device
        pw = torch.arange(4, device=dev, dtype=f32)
        X = torch.arange(W, device=dev, dtype=f32)[None, :] ** pw[:, None]
        Y = torch.arange(H, device=dev, dtype=f32)[None, :] ** pw[:, None]
        ev, ms, nl = timed(lambda: torch.einsum("bhw,qh,pw->bpq", wcat, Y, X),
                           iters)
        log("  K10 library einsum of the four planes' raw sums f32 B=%d "
            "%dx%d: device %.4f ms (events %.4f ms)" % (B, H, W, ms, ev))
        img = inten * mask
        hts = torch.full((B,), hw[0], dtype=torch.int32, device=dev)
        wds = torch.full((B,), hw[1], dtype=torch.int32, device=dev)
        vmin, vmax = roi_extrema(img)
        raw = moments.power_sums_plain([img])[:, 0].contiguous()
        nbytes, ops = gz_bounds(img, hts, wds, EngineConfig())["zernike"]
        bound = max(nbytes / HBM_BYTES_S, ops / OPS_S) * 1e3
        calls = [("zernike_features", None)]
        if zplan and (B, H, W) == (64, 32, 32):
            calls += [("one block a ROI, forced", (1, 1024)),
                      ("a cluster of four, forced", (4, 256))]
        if not zplan:
            calls.append(("kernel alone (zernike_sums)", None))
        else:
            calls.append(("plain version (zernike_moments_plain)", None))
        for name, force in calls:
            if name.startswith("kernel alone"):
                zin = zernike.zernike_inputs(img, hts, wds, raw)
                fn = (lambda: zernike.zernike_sums(img, *zin))
            elif name.startswith("plain"):
                fn = (lambda: zernike.zernike_moments_plain(
                    img, raw, hts, wds, vmin, vmax, ZERNIKE_NOVAL))
            else:
                fn = (lambda: zernike.zernike_features(
                    img, hts, wds, vmin, vmax, ZERNIKE_NOVAL, f32, raw=raw))
            if force:
                zernike.zernike_plan = lambda *a, p=force: p
            try:
                ev, ms, nl = timed(fn, iters)
            finally:
                if force:
                    zernike.zernike_plan = zplan
            log("  K12 zernike %s f32 B=%d %dx%d: device %.4f ms (events %.4f "
                "ms), %s device launches a call; bound %.5f ms (operations); "
                "plan (C, chunk) %s" % (
                    name, B, H, W, ms, ev, nl, bound,
                    "none" if name.startswith("plain") else force
                    or (zplan(B, H, W) if zplan else "none in this tree")))


# K15's and K16's timed buckets: the main 3D bucket, the main path's
# commonest (42 x 16^3: each throughput volume has one), 64^3 and a 64 x 256
# x 256 crop
K15_K16_TIMED = (MAIN_CUBE, (42, 16, 16, 16), (2, 64, 64, 64),
                 (1, 64, 256, 256))


def k15_k16_modes(cube):
    """K15's and K16's calls on one synth_cube as the 3D families make them,
    by mode: (the bounds_3d row, the kernel's call, the launch plan or None
    where the tree has no plans).  GLSZM's
    26-connected labels at raw levels, GLDZM's 6-connected labels and
    distances at 64 levels, GLDM's N26 table at raw levels, NGLDM's N24
    table and NGTDM's window of radius 1 at 64 levels."""
    import torch
    from nyxus_tpu_torch.ops import texture3d as t3
    _, lev, raw, aabb, dd, hh, ww = cube
    shape = tuple(lev.shape)
    cplan = getattr(t3, "cc3d_plan", None)
    splan = getattr(t3, "stencil3d_plan", None)
    sv = aabb & (raw != 0)
    slev = torch.where(sv, raw, -1)
    dlev = torch.where(aabb, lev, 0)
    glev = torch.where(aabb, raw, -9)
    return {
        "cc3d 26": ("cc3d", lambda: t3.cc3d(slev, sv, 26),
                    cplan(*shape) if cplan else None),
        "cc3d 6 + distances": (
            "cc3d_dist", lambda: t3.cc3d(dlev, aabb, 6, hh, ww),
            cplan(*shape, True) if cplan else None),
        "stencil3d N26": ("stencil3d", lambda: t3.stencil3d(glev, aabb, t3.N26),
                          splan(*shape, 1) if splan else None),
        "stencil3d N24": ("stencil3d_n24",
                          lambda: t3.stencil3d(lev, aabb, t3.N24_NGLDM),
                          splan(*shape, 1) if splan else None),
        "stencil3d window r=1": (
            "stencil3d_window", lambda: t3.stencil3d(dlev, aabb, radius=1),
            splan(*shape, 1) if splan else None),
    }


def k15_k16_times(iters=20):
    """K15 and K16 in every mode (k15_k16_modes) at K15_K16_TIMED: device
    and events ms a call, device launches a call (from the profiler), the
    bound and the launch plan (K15: path, cluster, planes a block, threads,
    32-bit parents, smem; K16: path, planes, rows, threads, smem).  Runs on
    any tree's package (a tree without the plans prints none), so that two
    trees can be timed in turn (--kernel-times)."""
    import torch
    for cube_shape in K15_K16_TIMED:
        cube = synth_cube(*cube_shape, 0, torch.float32)
        bnd = bounds_3d(cube)
        for mode, (row, kern, plan) in k15_k16_modes(cube).items():
            ev, ms, nl = timed(kern, iters)
            nbytes, ops = bnd[row]
            bytes_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, ops / OPS_S * 1e3
            log("  %s f32 B=%d %dx%dx%d: device %.4f ms (events %.4f ms), %s "
                "device launches a call; bound %.5f ms (%s); plan %s"
                % ((mode,) + cube_shape + (
                    ms, ev, nl, max(bytes_ms, ops_ms),
                    "bytes" if bytes_ms >= ops_ms else "operations",
                    plan or "none in this tree")))


def forced_second_paths():
    """The wrappers' plans replaced by ones that choose K15's device-memory
    path and K16's voxel path, whatever the shape; returns the originals
    (restore_plans puts them back)."""
    from nyxus_tpu_torch.ops import texture3d as t3
    saved = (t3.cc3d_plan, t3.stencil3d_plan)
    t3.cc3d_plan = lambda B, D, H, W, dist=False: ("device", 0, 0, 0,
                                                   D * H * W > 65535, 0)
    t3.stencil3d_plan = lambda B, D, H, W, halo: ("voxel", 0, 0, 0, 0)
    return saved


def restore_plans(saved):
    from nyxus_tpu_torch.ops import texture3d as t3
    t3.cc3d_plan, t3.stencil3d_plan = saved


def check_kernels_3d():
    """K13-K16 and K1's split path against their plain versions on
    the card, then their times at MAIN_CUBE (and at 64^3 and the 64 x 256 x
    256 crop, printed only); returns per-kernel results."""
    import torch
    from nyxus_tpu_torch.ops import common, texture3d as t3
    res = {k: {"max_abs_err": 0.0} for k in KERNELS_3D + ("batched_hist",
                                                          "zone_stats")}

    def agree(name, got, want, scale=None):
        """Equal, or within ``scale`` (a per-element bound) when given."""
        if got.shape != want.shape:
            raise AssertionError("%s: shape %s != %s" % (name, got.shape,
                                                          want.shape))
        diff = (got.double() - want.double()).abs()
        err = float(diff.max()) if got.numel() else 0.0
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        if scale is None:
            if not torch.equal(got, want):
                raise AssertionError("%s: counts differ (max abs %g)"
                                     % (name, err))
        elif not bool((diff <= scale).all()):
            raise AssertionError("%s: beyond its bound (max abs %g)"
                                 % (name, err))

    for prec, dtype, rtol in (("f32", torch.float32, 1e-6),
                              ("f64", torch.float64, 1e-12)):
        for ci, (B, D, H, W) in enumerate(CUBES):
            cube = synth_cube(B, D, H, W, 20 + ci, dtype)
            kernels_3d_agree(agree, cube, dtype, rtol, big_glcm=D <= 16)
            log("  %s B=%d %dx%dx%d: K13-K16, K7 and K1 agree (K13 at 64%s "
                "levels, K14 at 64 and %d)" % (
                    prec, B, D, H, W, " and %d" % RAW_NG if D <= 16 else "",
                    RAW_NG))
        for kind in ("empty", "uniform"):
            cube = synth_cube(4, 16, 16, 16, 30, dtype, kind)
            kernels_3d_agree(agree, cube, dtype, rtol)
            raw_valid = cube[3] & (cube[2] > 0)     # raw levels' zones
            n = int((t3.cc3d(torch.where(raw_valid, cube[2], -1), raw_valid,
                             26)[0].reshape(4, -1)
                     == torch.arange(16 ** 3, device="cuda")).sum())
            if n != (0 if kind == "empty" else 4):
                raise AssertionError("cc3d: %d zones in the %s cubes" % (n,
                                                                         kind))
        log("  %s: empty and uniform 16^3 cubes agree (0 and 4 zones)" % prec)
        n7 = [zone_stats_paths_agree(agree, *inp)
              for inp in zone_stats_case("3D uniform 2x64³")]
        log("  %s: K7 on the uniform 2 x 64³ cubes' 26- and 6-connected "
            "zones agrees by its plan and on %d forced plans" % (prec,
                                                                 sum(n7)))
        # K15's 32-bit parents (a cube of 65536 voxels) on the special
        # kinds, then K15's device-memory and K16's voxel paths, forced
        for kind in ("empty", "uniform", "blob"):
            k15_k16_agree(agree, synth_cube(2, 16, 64, 64, 32, dtype, kind))
        saved = forced_second_paths()
        try:
            for kind in ("empty", "uniform", "blob"):
                k15_k16_agree(agree, synth_cube(4, 16, 16, 16, 33, dtype,
                                                kind))
            k15_k16_agree(agree, synth_cube(*MAIN_CUBE, 34, dtype))
        finally:
            restore_plans(saved)
        log("  %s: K15 and K16 agree on 16 x 64 x 64 cubes (32-bit parents) "
            "and with K15's device-memory and K16's voxel paths forced"
            % prec)

    for cube_shape in (MAIN_CUBE, (2, 64, 64, 64), (1, 64, 256, 256)):
        cube = synth_cube(*cube_shape, 0, torch.float32)
        orig, lev, raw, aabb, dd, hh, ww = cube
        rvalid = aabb & (raw > 0)
        nr = max(lev.shape[1:])
        sv = aabb & (raw != 0)
        slev = torch.where(sv, raw, -1)
        glev = torch.where(aabb, raw, -9)
        f32 = torch.float32
        pairs = {
            "glcm3d_cooc": (
                lambda: t3.glcm3d_cooc(lev, dd, hh, ww, 1, 64, False, False,
                                       f32),
                lambda: t3.glcm3d_cooc_plain(lev, dd, hh, ww, 1, 64, False,
                                             False, f32)),
            "glrlm3d_runs": (
                lambda: t3.glrlm3d_runs(raw, rvalid, RAW_NG, nr, f32),
                lambda: t3.glrlm3d_runs_plain(raw, rvalid, RAW_NG, nr, f32)),
            "cc3d": (lambda: t3.cc3d(slev, sv, 26),
                     lambda: t3.cc3d_plain(slev, sv, 26)),
            "stencil3d": (lambda: t3.stencil3d(glev, aabb, t3.N26),
                          lambda: t3.stencil3d_plain(glev, aabb, t3.N26)),
        }
        main = cube_shape == MAIN_CUBE
        iters = 20 if main else 3
        bnd = bounds_3d(cube)
        for name, (kern, plain) in pairs.items():
            p1, k1, k2, p2 = (timed(f, iters) for f in (plain, kern, kern,
                                                        plain))
            ev, ms = (k1[0] + k2[0]) / 2, (k1[1] + k2[1]) / 2
            pev, plain_ms = (p1[0] + p2[0]) / 2, (p1[1] + p2[1]) / 2
            nbytes, ops = bnd[name]
            bytes_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, ops / OPS_S * 1e3
            log("  time %-12s f32 B=%d %dx%dx%d: device %.4f ms (events "
                "%.4f ms) vs plain device %.4f ms (events %.4f ms); bound "
                "%.5f ms" % ((name,) + cube_shape + (ms, ev, plain_ms, pev,
                                                     max(bytes_ms, ops_ms))))
            if main:
                res[name].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=None)
        # K14's launch plan at raw levels, and K14 in the binned
        # configuration (64 levels, the AABB taking part)
        vox = lev[0].numel()
        for ng in (RAW_NG, 64):
            S, L, P, narrow, smem = t3.glrlm3d_plan(ng, nr, vox)
            log("  glrlm3d_runs plan %d x %d, %dx%dx%d: clusters of %d "
                "blocks, %d levels (%d bytes of %d-bit counts) a block, %d "
                "passes" % ((ng, nr) + cube_shape[1:]
                            + (S, L, smem, 16 if narrow else 32, P)))
        k = timed(lambda: t3.glrlm3d_runs(lev, aabb, 64, nr, f32), iters)
        p = timed(lambda: t3.glrlm3d_runs_plain(lev, aabb, 64, nr, f32),
                  iters)
        log("  time glrlm3d_runs binned 64 levels, B=%d %dx%dx%d: device "
            "%.4f ms (events %.4f ms) vs plain device %.4f ms; bound %.5f ms"
            % ((cube_shape[0],) + cube_shape[1:] + (
                k[1], k[0], p[1], bounds_3d(cube, ng_runs=64)[
                    "glrlm3d_runs"][0] / HBM_BYTES_S * 1e3)))
        # K1's split path at GLDM's raw 4096 x 27 cells
        B = lev.shape[0]
        same = t3.stencil3d(glev, aabb, t3.N26)
        cells = common._composite((raw - 1).reshape(B, -1),
                                  same.reshape(B, -1), RAW_NG, 27)
        ones = aabb.reshape(B, -1).to(f32)
        k = timed(lambda: common.batched_hist(cells, ones, RAW_NG * 27),
                  iters)
        p = timed(lambda: common.batched_hist_plain(cells, ones, RAW_NG * 27),
                  iters)
        log("  time batched_hist split path %d x 27 cells, B=%d "
            "%dx%dx%d: device %.4f ms (events %.4f ms) vs plain device %.4f "
            "ms; bound %.5f ms" % ((RAW_NG, B) + cube_shape[1:] + (
                k[1], k[0], p[1], (B * lev[0].numel() * 8
                                   + B * RAW_NG * 27 * 4) / HBM_BYTES_S * 1e3)))
    k11_k13_times()
    k15_k16_times()
    return res


# K2's timed calls (f32; bucket, levels, symmetric): the main path's three
# buckets (seed 7's 47 x 64²), a slide's 300 x 32², the long ROI (2 x 1024
# x 64) at 64 levels, 64 x 32² symmetric, IBSI's 256 levels at 64 x 32²
# (asymmetric and, as IBSI runs it, symmetric) and its 4096 raw levels on
# the long ROI (symmetric, one ROI a call, as the family's chunks call it)
K2_TIMED = ((CASES[0], 64, False), ((47, 64, 64, (60, 47)), 64, False),
            (CASES[2], 64, False), ((300, 32, 32, (29, 31)), 64, False),
            ((2, 1024, 64, (600, 40)), 64, False), (CASES[0], 64, True),
            (CASES[0], 256, False), (CASES[0], 256, True),
            ((1, 1024, 64, (600, 40)), 4096, True))


def k2_bound(B, H, W, ng, symmetric, angles=4, esz=4):
    """(bytes, operations) K2 must move and do: the intensities (esz bytes)
    and int32 levels read once, the [B, angles, ng, ng] matrices written
    once; a count a pixel and angle (two symmetric)."""
    A = B * H * W
    return (A * (esz + 4) + B * angles * ng * ng * esz,
            angles * A * (1 + bool(symmetric)))


def k2_times(iters=20):
    """K2 in f32: device and events ms a call, device launches a call (from
    the profiler) and the bound (k2_bound), at K2_TIMED by the wrapper and,
    at 4096 levels, on the device path's other plans (the int32 scratch,
    the crop read from device memory); at 64 x 32² (64 levels) on every
    plan of glcm_plans forced, and its plain version.  Runs on any tree's
    package: on a tree without glcm_cooc_plan the wrapper alone, its plan
    "none in this tree", so that two trees can be timed in turn
    (--kernel-times)."""
    import torch
    from nyxus_tpu_torch.ops import glcm
    plan_fn = getattr(glcm, "glcm_cooc_plan", None)
    f32 = torch.float32
    all4 = (0, 45, 90, 135)
    for (B, H, W, hw), ng, sym in K2_TIMED:
        orig, lev, _, roi = synth_bucket(B, H, W, hw, 0, f32)
        if ng == 256:
            lev = (lev - 1) * 4 + 1 + (orig.long() % 4).to(torch.int32)
        elif ng != 64:
            g = torch.Generator(device="cuda").manual_seed(ng)
            lev = torch.randint(1, ng + 1, lev.shape, generator=g,
                                device="cuda", dtype=torch.int32)
            orig = torch.where(roi, lev.to(f32) + 0.5, 0.0)
        nbytes, ops = k2_bound(B, H, W, ng, sym)
        bound = max(nbytes / HBM_BYTES_S, ops / OPS_S) * 1e3
        main = (B, H, W, ng) == (64, 32, 32, 64) and not sym
        plans = [None]
        if plan_fn and (main or ng == 4096):
            plans += glcm_plans(B, H, W, ng, 4, sym, 4)[1:]
        if main:
            plans.append("plain")
        for force in plans:
            if force == "plain":
                fn = lambda: glcm.cooc_matrices_plain(orig, lev, all4, 1, ng,
                                                      sym)
            else:
                fn = lambda: glcm.cooc_matrices(orig, lev, all4, 1, ng, sym)
                if force:
                    glcm.glcm_cooc_plan = lambda *a, p=force: p
            try:
                ev, ms, nl = timed(fn, iters)
            finally:
                if plan_fn:
                    glcm.glcm_cooc_plan = plan_fn
            plan = "none" if force == "plain" else force or (
                plan_fn(B, H, W, ng, 4, sym, 4) if plan_fn
                else "none in this tree")
            log("  K2 glcm_cooc %s f32 B=%d %dx%d at %d levels%s: device "
                "%.4f ms (events %.4f ms), %s device launches a call; bound "
                "%.5f ms (%s); plan (path, count bits, angles a block, "
                "blocks a ROI, threads, smem) %s%s"
                % ("plain version" if force == "plain" else "kernel", B, H, W,
                   ng, " symmetric" if sym else "", ms, ev, nl, bound,
                   "bytes" if nbytes / HBM_BYTES_S >= ops / OPS_S
                   else "operations", plan, " forced" if force
                   and force != "plain" else ""))


# K4's timed buckets: the main path's three (seed 7's 47 x 64²), a slide's
# 300 x 32² and the long ROI's 1 x 1024 x 64 at 64 levels; then IBSI's raw
# 256 and 4096 levels at 64 x 32²
K4_TIMED = (CASES[0], (47, 64, 64, (60, 47)), CASES[2],
            (300, 32, 32, (29, 31)), (1, 1024, 64, (600, 40)))
K4_IBSI_LEVELS = (256, 4096)


def k4_family_calls(orig, lev, aabb, roi, glev, nb):
    """The three families' matrix calls on one bucket, (name, call, mode,
    levels, participation, matrix levels, participation bytes): GLDM's
    gldm_matrix (the levels, the original intensities), NGTDM's
    ngtdm_matrices (the levels over the AABB) and NGLDM's ngldm_matrix (the
    to_grayscale levels ``glev`` over the ROI)."""
    import torch
    from nyxus_tpu_torch.ops import gldm, ngldm, ngtdm
    f32 = torch.float32
    return [("GLDM", lambda: gldm.gldm_matrix(orig, lev, nb, f32), "gldm",
             lev, orig, nb, 4),
            ("NGTDM", lambda: ngtdm.ngtdm_matrices(lev, aabb, nb, f32),
             "ngtdm", lev, aabb, nb + 1, 1),
            ("NGLDM", lambda: ngldm.ngldm_matrix(glev, roi, nb, f32),
             "ngldm", glev, roi, nb + 1, 1)]


def k4_k17_times(iters=20):
    """K4 and K17 in f32: device and events ms a call, device launches a
    call (from the profiler) and the bound.  K4 as each family calls it
    (k4_family_calls: one launch) at K4_TIMED and at IBSI's
    K4_IBSI_LEVELS, with its plan, the K4 and K1 launches of one call (and
    the family function's calls, common.counted), every other plan of
    neigh_plans forced at 64 levels and, at 64 x 32², its plain version;
    K17 at B = 64 rows of IH_BINS bins and at IH_TIMED_B rows of 64
    (ih_inputs: the degenerate rows included) with its plan, every plan of
    ih_plans forced, and its plain version at 64 x 64."""
    import torch
    from nyxus_tpu_torch.ops import common, gldm, ih, ngldm, ngtdm
    plan_fn = common.neigh_matrix_plan
    f32 = torch.float32
    cases = [(c, None) for c in K4_TIMED] + [(CASES[0], nb)
                                             for nb in K4_IBSI_LEVELS]
    for (B, H, W, hw), raw in cases:
        orig, lev, aabb, roi = synth_bucket(B, H, W, hw, 0, f32)
        nb = 64
        if raw:
            g = torch.Generator(device="cuda").manual_seed(raw)
            lev = torch.randint(1, raw + 1, lev.shape, generator=g,
                                device="cuda", dtype=torch.int32)
            orig = torch.where(roi, lev.to(f32), 0.0)
            nb = raw
        vmax = orig.reshape(B, -1).amax(dim=1).clamp(min=1)
        glev = lev if raw else ngldm.to_grayscale_levels(
            orig, vmax[:, None, None], nb, False)
        tag = "B=%d %dx%d%s" % (B, H, W, " at %d raw levels" % raw
                                if raw else "")
        main = (B, H, W) == (64, 32, 32) and not raw
        for name, call, mode, nlev, part, nbins, pb in k4_family_calls(
                orig, lev, aabb, roi, glev, nb):
            nbytes, ops = neigh_bound(mode, B, H, W, nbins, pb)
            bound = max(nbytes / HBM_BYTES_S, ops / OPS_S) * 1e3
            before = common.neigh_matrix.launches, \
                common.batched_hist.launches
            call()
            after = common.neigh_matrix.launches, common.batched_hist.launches
            plan = plan_fn(mode, B, H, W, nbins, 4)
            plans = [None]
            if not raw:
                plans += neigh_plans(mode, B, H, W, nbins, 4)[1:]
            if main:
                plans.append("plain")
            for force in plans:
                fn = call
                if force == "plain":
                    fn = (lambda m=mode, a=nlev, p=part, n=nbins:
                          common.neigh_matrix_plain(m, a, p, n, f32))
                elif force:
                    common.neigh_matrix_plan = lambda *a, p=force: p
                try:
                    ev, ms, nl = timed(fn, iters)
                finally:
                    common.neigh_matrix_plan = plan_fn
                log("  K4 %s matrix %s f32 %s: device %.4f ms (events %.4f "
                    "ms), %s device launches a call; K4 / K1 launches a "
                    "call %d / %d; bound %.5f ms (%s); plan (path, blocks "
                    "a ROI, threads, smem) %s%s"
                    % (name, "plain version" if force == "plain" else
                       "as the family calls it", tag, ms, ev, nl,
                       after[0] - before[0], after[1] - before[1], bound,
                       "bytes" if nbytes / HBM_BYTES_S >= ops / OPS_S
                       else "operations",
                       "none" if force == "plain" else force or plan,
                       " forced" if force and force != "plain" else ""))
    log("  K4 family functions' calls (common.counted) over these "
        "timings: gldm_matrix %d, ngtdm_matrices %d, ngldm_matrix %d; "
        "K4 launches %d" % (gldm.gldm_matrix.calls,
                            ngtdm.ngtdm_matrices.calls,
                            ngldm.ngldm_matrix.calls,
                            common.neigh_matrix.launches))
    iplan = ih.ih_stats_plan
    for B, N in [(64, N) for N in IH_BINS] + [(B, 64) for B in IH_TIMED_B]:
        inputs = ih_inputs(B, N, f32, seed=N)
        nbytes, ops = ih_bound(B, N)
        bound = max(nbytes / HBM_BYTES_S, ops / OPS_S) * 1e3
        plans = [None] + ih_plans(N, 4)[1:]
        if (B, N) == (64, 64):
            plans.append("plain")
        for force in plans:
            if force == "plain":
                fn = lambda: ih.ih_features_from_freq_plain(
                    *inputs[:4], -0.0, *inputs[4:])
            else:
                fn = lambda: ih.ih_stats(*inputs[:4], -0.0, *inputs[4:])
                if force:
                    ih.ih_stats_plan = lambda *a, p=force: p
            try:
                ev, ms, nl = timed(fn, iters)
            finally:
                ih.ih_stats_plan = iplan
            log("  K17 ih_stats %s f32 B=%d N=%d: device %.4f ms (events "
                "%.4f ms), %s device launches a call; bound %.5f ms (%s); "
                "plan (path, bins a lane) %s%s"
                % ("plain version" if force == "plain" else "kernel", B, N,
                   ms, ev, nl, bound, "bytes" if nbytes / HBM_BYTES_S
                   >= ops / OPS_S else "operations",
                   "none" if force == "plain" else force or iplan(N, 4),
                   " forced" if force and force != "plain" else ""))


# ---------------------------------------------------------------------------
# phase 2, IBSI: K17 ih_stats


# bin counts K17 is held at: the IBSI goldens' 6, the default |grey depth|
# 64, 100, 256, and 32768 (beyond a block's shared memory in float64)
IH_BINS = (6, 64, 100, 256, 32768)
# wider buckets K17 is timed at (N = 64): a slide's 300 ROIs, and 1056
# (eight warps for each of the card's 132 SMs)
IH_TIMED_B = (300, 1056)
# members that are bin indices or counts formed by the same operations in
# both versions from the same counts: equal exactly
IH_EXACT = ("IH_MEDIAN_IDX", "IH_MINIMUM_IDX", "IH_P10_IDX", "IH_P90_IDX",
            "IH_MAXIMUM_IDX", "IH_MODE_IDX", "IH_INTERQUANTILE_RANGE_IDX",
            "IH_RANGE_IDX", "IH_MAX_GRADIENT_IDX", "IH_MIN_GRADIENT_IDX",
            "IH_NUM_BINS")


def ih_inputs(B, N, dtype, seed=0, device="cuda"):
    """(freq, counts, vmin, vmax, pscale, poffset) of B ROIs' N-bin
    histograms: random exact counts over random [vmin, vmax] ranges, every
    fourth row in an HU-like reporting domain (offset -1024); row 0 has no
    pixels, row 1 a single level (vmax == vmin), row 2 all its mass in one
    middle bin and row 3 in the last bin."""
    import torch
    r = np.random.default_rng(seed)
    freq = r.integers(0, 40, (B, N)).astype(np.float64)
    freq[r.random((B, N)) < 0.3] = 0
    vmin = r.integers(0, 2000, B).astype(np.float64)
    vmax = vmin + r.integers(1, 3000, B)
    freq[0] = 0
    freq[1] = 0
    freq[1, 0] = 17
    vmax[1] = vmin[1]
    freq[2] = 0
    freq[2, N // 2] = 31
    freq[3] = 0
    freq[3, N - 1] = 5
    counts = freq.sum(axis=1)
    pscale = np.ones(B)
    poffset = np.where(np.arange(B) % 4 == 0, -1024.0, 0.0)
    return tuple(torch.from_numpy(a).to(dtype).to(device)
                 for a in (freq, counts, vmin, vmax, pscale, poffset))


def ih_agree(got, want, inputs, rtol):
    """K17's [B, 46] against its plain version's: IH_EXACT equal, every
    other member within rtol of its value plus rtol of the row's scale (the
    largest of 1, N, the largest count and the reporting-domain magnitude
    |poffset| + |pscale| max(|vmin|, |vmax|)), since sums that cancel (a
    skewness near 0, a mean near 0 in the HU domain) have no scale of their
    own.  Returns the largest absolute difference."""
    import torch
    from nyxus_tpu_torch.ops import ih
    freq, _, vmin, vmax, pscale, poffset = inputs
    if got.shape != want.shape:
        raise AssertionError("ih_stats: shape %s != %s"
                             % (tuple(got.shape), tuple(want.shape)))
    exact = [ih.MEMBERS.index(m) for m in IH_EXACT]
    if not torch.equal(got[:, exact], want[:, exact]):
        bad = (got[:, exact] != want[:, exact]).nonzero()[:5].tolist()
        raise AssertionError("ih_stats: bin indices differ at %s" % bad)
    g, w = got.double(), want.double()
    scale = torch.stack([
        torch.ones_like(vmin.double()),
        torch.full_like(vmin.double(), freq.shape[1]),
        freq.double().amax(dim=1),
        poffset.double().abs() + pscale.double().abs()
        * torch.maximum(vmin.double().abs(), vmax.double().abs())]).amax(dim=0)
    diff = (g - w).abs()
    ok = diff <= rtol * (w.abs() + scale[:, None])
    if not bool(ok.all()):
        b, k = (~ok).nonzero()[0].tolist()
        raise AssertionError("ih_stats: %s of row %d: %r vs %r"
                             % (ih.MEMBERS[k], b, float(g[b, k]),
                                float(w[b, k])))
    return float(diff.max())


def ih_bound(B, N, esz=4):
    """(bytes, operations) K17 must move and do: freq read once, the five
    [B] rows read once, the [B, 46] result written once; ~60 operations a
    bin (the scan and the landing tests ~12, the gradient 3, pass B 10,
    pass C 35)."""
    return (B * N * esz + 5 * B * esz + 46 * B * esz, 60.0 * B * N)


def ih_plans(N, esz):
    """Every launch plan K17 can take on rows of N bins: its own; up to
    IH_WARP_BINS the warp path (and, below 4 bins a lane, at twice the bins
    a lane); the block path where the row fits its shared memory and the
    device path."""
    from nyxus_tpu_torch.ops import ih
    out = [ih.ih_stats_plan(N, esz)]
    alts = []
    if N <= ih.IH_WARP_BINS:
        K = ih.ih_bins_a_lane(N)
        alts.append(("warp", K))
        if K < 4:
            alts.append(("warp", 2 * K))
    nb = -(-N // ih.IH_BLOCK)
    if N * esz <= ih._STAGE_MAX:
        alts.append(("block", nb))
    alts.append(("device", nb))
    return out + [p for p in alts if p != out[0]]


def ih_paths_agree(inputs, rtol):
    """K17 against its plain version on one input by its plan and on every
    other plan of ih_plans, forced, one launch a call (ih_agree); returns
    (the largest absolute difference, the plans held)."""
    from nyxus_tpu_torch.ops import ih
    want = ih.ih_features_from_freq_plain(*inputs[:4], -0.0, *inputs[4:])
    B, N = inputs[0].shape
    saved = ih.ih_stats_plan
    plans = ih_plans(N, inputs[0].element_size())
    err = 0.0
    for plan in plans:
        ih.ih_stats_plan = lambda *a, p=plan: p
        before = ih.ih_stats.launches
        try:
            got = ih.ih_stats(*inputs[:4], -0.0, *inputs[4:])
        finally:
            ih.ih_stats_plan = saved
        if ih.ih_stats.launches != before + 1:
            raise AssertionError("ih_stats: %d launches a call"
                                 % (ih.ih_stats.launches - before))
        err = max(err, ih_agree(got, want, inputs, rtol))
    return err, plans


def check_ih():
    """K17 against its plain version at B = 64, each bin count of IH_BINS,
    f32 and f64 (the degenerate rows included), by its plan and on every
    plan of ih_plans forced, then timed at the default N = 64 in f32; and
    the one torch.sort the IBSI path reads (common.sort_masked_values, IH's
    binning) timed at the main bucket."""
    import torch
    from nyxus_tpu_torch.ops import common, ih
    res = {"ih_stats": {"max_abs_err": 0.0}}
    for prec, dtype, rtol in (("f32", torch.float32, 1e-5),
                              ("f64", torch.float64, 1e-12)):
        for N in IH_BINS:
            inputs = ih_inputs(64, N, dtype, seed=N)
            err, plans = ih_paths_agree(inputs, rtol)
            res["ih_stats"]["max_abs_err"] = max(
                res["ih_stats"]["max_abs_err"], err)
            log("  %s B=64 N=%d: ih_stats agrees by its plan %s and on %s "
                "forced, max abs diff %g" % (prec, N, plans[0], plans[1:],
                                              err))
        err, plans = ih_paths_agree(wholeslide_ih_inputs(dtype), rtol)
        res["ih_stats"]["max_abs_err"] = max(res["ih_stats"]["max_abs_err"],
                                             err)
        log("  %s whole-slide crop at 12 bits (64 bins of its raw levels): "
            "ih_stats agrees by its plan %s and on %s forced, max abs diff "
            "%g" % (prec, plans[0], plans[1:], err))
    for N in (64, 6, 100, 256, 32768):
        inputs = ih_inputs(64, N, torch.float32, seed=N)
        kern = lambda: ih.ih_stats(*inputs[:4], -0.0, *inputs[4:])
        plain = lambda: ih.ih_features_from_freq_plain(*inputs[:4], -0.0,
                                                       *inputs[4:])
        main = N == 64
        iters = 20 if main else 5
        p1, k1, k2, p2 = (timed(f, iters) for f in (plain, kern, kern, plain))
        ev, ms = (k1[0] + k2[0]) / 2, (k1[1] + k2[1]) / 2
        pev, plain_ms = (p1[0] + p2[0]) / 2, (p1[1] + p2[1]) / 2
        nbytes, ops = ih_bound(64, N)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, ops / OPS_S * 1e3
        log("  time ih_stats     f32 B=64 N=%d: device %.4f ms (events %.4f "
            "ms) vs plain device %.4f ms (events %.4f ms); bound %.5f ms"
            % (N, ms, ev, plain_ms, pev, max(bytes_ms, ops_ms)))
        if main:
            res["ih_stats"].update(
                ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None)
    # sort_masked_values at B=64 x 32^2: reads the crop (4 bytes) and mask
    # (1 byte) once, writes the sorted rows; ~log2(1024) = 10 compares an
    # element
    orig, _, _, roi = synth_bucket(64, 32, 32, (29, 31), 0, torch.float32)
    ev, ms, _ = timed(lambda: common.sort_masked_values(orig, roi))
    A = orig.numel()
    bound = max((A * 9) / HBM_BYTES_S, 10.0 * A / OPS_S) * 1e3
    log("  time sort_masked_values (torch.sort) f32 B=64 32x32: device %.4f "
        "ms (events %.4f ms); bound %.5f ms" % (ms, ev, bound))
    return res


def make_volume_3d(seed, shape=(96, 320, 320), n_nuclei=200, n_lesions=3):
    """A 12-bit radiomics-like volume pair: a noisy background (intensities
    1..4095) with ~``n_nuclei`` nucleus-like ellipsoids (semi-axes 3-10
    voxels: buckets 8^3 to 32^3) and ``n_lesions`` lesion-like ones
    (semi-axes 14-30: buckets 32^3 to 64^3), each with its own base
    intensity and texture; made per object in a window around it, with
    numpy from ``seed`` (as make_dsb_like makes its slides)."""
    r = np.random.default_rng(seed)
    D, H, W = shape
    labels = np.zeros(shape, np.int32)
    intens = r.normal(300, 60, shape).clip(1, 4095)
    lab = 1
    specs = [(14, 30)] * n_lesions + [(3, 10)] * n_nuclei
    for lo, hi in specs:
        rz, ry, rx = r.uniform(lo, hi, 3)
        c = [r.uniform(rad + 1, n - rad - 1) for rad, n in
             ((rz, D), (ry, H), (rx, W))]
        sl = tuple(slice(max(0, int(ci - rad) - 1), min(n, int(ci + rad) + 2))
                   for ci, rad, n in zip(c, (rz, ry, rx), (D, H, W)))
        zz, yy, xx = np.mgrid[sl]
        m = ((((zz - c[0]) / rz) ** 2 + ((yy - c[1]) / ry) ** 2
              + ((xx - c[2]) / rx) ** 2) <= 1.0) & (labels[sl] == 0)
        if m.sum() < 30:
            continue
        base = r.uniform(600, 3800)
        win_i = intens[sl]
        win_i[m] = np.clip(base + r.normal(0, base * 0.15, m.sum())
                           + base * 0.1 * np.sin(zz[m] / 2.3), 1, 4095)
        labels[sl][m] = lab
        lab += 1
    return np.floor(intens).astype(np.uint16), labels


# ---------------------------------------------------------------------------
# phase 3 and 4: the request end to end


def pre_host_columns(runner, slots):
    """Value columns of the host families that read no device result (the
    pre-collect ones): every member of those without a device half, and the
    host half's FRACT_DIM_PERIMETER of FractalDimensionFeature.  Their
    inputs are the same on the card and on the CPU, so their values are
    too, bit for bit."""
    from nyxus_tpu_torch import registry, taxonomy
    codes = set()
    for name in runner.pre_host:
        fam = registry.FAMILIES[name]
        if not fam.device:
            codes.update(fam.codes)
        elif name == "FractalDimensionFeature":
            codes.add(taxonomy.F2D["FRACT_DIM_PERIMETER"])
    out, off = [], 0
    for code, width in slots:
        if code in codes:
            out.extend(range(off, off + width))
        off += width
    if not out:
        raise AssertionError("no pre-collect host columns")
    return np.asarray(out)


def check_output(what, cols, labs, dev, labs64, ref):
    """Labels and shape equal, NaN where and only where the f64 CPU run has
    NaN, no infinity, the EXACT counts equal and every other column within
    its tier; returns the column
    closest to its tier.  Where the f64 value lies beyond float32's range
    (a weighted Hu invariant of a long ROI reaches 1e44) the f32 run may
    overflow to inf or NaN."""
    if dev.shape != (len(labs64), len(cols)) or list(labs) != list(labs64):
        raise AssertionError("%s: shape/labels %s vs %s"
                             % (what, dev.shape, ref.shape))
    with np.errstate(invalid="ignore"):
        beyond = np.abs(ref) > np.finfo(np.float32).max
    odd = ~beyond & ((np.isnan(dev) != np.isnan(ref)) | np.isinf(dev))
    if odd.any():
        j = np.nonzero(odd.any(axis=0))[0]
        raise AssertionError("%s: inf, or NaN unlike the f64 CPU run, in %s"
                             % (what, [cols[k] for k in j[:10]]))
    exact = [j for j, c in enumerate(cols) if c in EXACT]
    if not np.array_equal(dev[:, exact], ref[:, exact]):
        raise AssertionError("%s: %s differ between the card and the CPU run"
                             % (what, [cols[j] for j in exact]))
    bad, worst = compare_tiers(cols, dev, ref)
    if bad:
        raise AssertionError("%s: f32 card vs f64 CPU beyond tolerance: %r"
                             % (what, bad[:20]))
    return worst


def surface_columns(slots):
    """Value columns of D3_SurfaceFeature: numpy and scipy on the host over
    the same voxels, reading no device result, so bit-equal between the
    card and the CPU run."""
    from nyxus_tpu_torch import taxonomy
    codes = set(taxonomy.CLASS_FEATURES["D3_SurfaceFeature"])
    out, off = [], 0
    for code, width in slots:
        if code in codes:
            out.extend(range(off, off + width))
        off += width
    if not out:
        raise AssertionError("no surface columns")
    return np.asarray(out)


def subset_3d(labels, step=10):
    """The labels of the f64 CPU reference on a throughput volume: the
    lesions (labels 1-3, made first) and every ``step``-th nucleus; the
    others are zeroed, which leaves every kept ROI's values as they are
    (the slide range and the raw levels' matrix size come from the
    intensities)."""
    keep = [l for l in np.unique(labels) if l and (l <= 3 or l % step == 0)]
    return np.where(np.isin(labels, keep), labels, 0), keep


def check_3d(kern):
    """Phase 3, 3D: *3D_ALL* in f32 on the card against f64 on the CPU, at
    the default and the binned configuration, on the fixture volume and on
    a subset of throughput volume 1; every column within its tier, the
    surface columns bit-equal, and K13-K16 launched."""
    from nyxus_tpu_torch import columns, taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner
    fset = taxonomy.parse_feature_request(FEATURES_3D, dim=3)
    hdr, slots = columns.build_header(fset, EngineConfig())
    cols = hdr[4:]
    if len(cols) != WIDTH_3D:
        raise AssertionError("3D width %d != %d" % (len(cols), WIDTH_3D))
    surf = surface_columns(slots)
    fi, fl = blob3d(seed=4, shape=(48, 56, 60))
    fixture = ((fi % 59 + 1).astype(np.uint16), fl)
    vol = make_volume_3d(1)
    sub_labels, keep = subset_3d(vol[1])
    seen = {k: 0 for k in KERNELS_3D}
    for what, (intens, labels), ref_labels, kw in (
            ("fixture volume", fixture, fixture[1], {}),
            ("fixture volume, binned", fixture, fixture[1], BINNED_3D),
            ("volume 1 (%d of its ROIs on the CPU)" % len(keep), vol,
             sub_labels, {}),
            ("volume 1, binned (%d of its ROIs on the CPU)" % len(keep), vol,
             sub_labels, BINNED_3D)):
        for f in kern.values():
            f.launches = 0
        labs, dev = VolumeRunner(fset, EngineConfig(precision="f32", **kw),
                                 "cuda").run(intens, labels)
        launches = {k: kern[k].launches for k in KERNELS_3D + (
            "batched_hist", "zone_stats")}
        for k in KERNELS_3D:
            seen[k] += launches[k]
        labs64, ref = VolumeRunner(fset, EngineConfig(precision="f64", **kw),
                                   "cpu").run(intens, ref_labels)
        rows = np.searchsorted(labs, labs64)
        worst = check_output(what, cols, labs[rows], dev[rows], labs64, ref)
        if not np.array_equal(dev[rows][:, surf].view(np.uint64),
                              ref[:, surf].view(np.uint64)):
            raise AssertionError("%s: the surface columns differ between "
                                 "the card and the CPU run" % what)
        log("  %s: %d ROIs x %d columns agree, the %d surface columns bit "
            "for bit; closest to its tier: %s; launches %s"
            % (what, len(labs64), len(cols), len(surf), worst, launches))
    if not all(seen.values()):
        raise AssertionError("3D: a kernel was not launched: %r" % seen)


def throughput_3d(kern):
    """Phase 4, 3D: two make_volume_3d volumes through VolumeRunner at the
    default configuration, one untimed pass then one timed pass; returns
    (runner, volumes, the timed pass's launches)."""
    import torch
    from nyxus_tpu_torch import taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner
    t0 = time.perf_counter()
    vols = [make_volume_3d(s) for s in (1, 2)]
    log("  volumes generated in %.1f s" % (time.perf_counter() - t0))
    runner = VolumeRunner(taxonomy.parse_feature_request(FEATURES_3D, dim=3),
                          EngineConfig(precision="f32"), "cuda")
    for intens, labels in vols:                         # untimed pass
        runner.run(intens, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in kern.values():
        f.launches = 0
    for f in torch_routines().values():
        f.calls = 0
    n_rois, outs = 0, []
    t0 = time.perf_counter()
    for intens, labels in vols:
        labs, vals = runner.run(intens, labels)
        n_rois += len(labs)
        outs.append((labs, vals))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in kern.items()}
    peak = torch.cuda.max_memory_allocated()
    voxels = sum(int(np.count_nonzero(labels)) for _, labels in vols)
    log("  *3D_ALL* (213 columns) on 2 volumes of 96 x 320 x 320: %d ROIs "
        "(%d ROI voxels) in %.4f s: %.2f ROIs/s, %.3f ROI Mvoxels/s; peak "
        "device memory %d bytes (%.1f MiB); launches %s; torch routines' "
        "calls %s"
        % (n_rois, voxels, wall, n_rois / wall, voxels / wall / 1e6, peak,
           peak / 2 ** 20, launches,
           {k: f.calls for k, f in torch_routines().items()}))
    if not all(launches[k] for k in KERNELS_3D + ("batched_hist",
                                                  "zone_stats")):
        raise AssertionError("3D throughput: a kernel was not launched: %r"
                             % launches)
    for labs, vals in outs:
        if vals.shape != (len(labs), WIDTH_3D):
            raise AssertionError("3D throughput: bad output %s" % (
                vals.shape,))
    return runner, vols, launches


# IH members read straight off the histogram: its bin count, the mode's
# bin and the gradient extrema's bins.  The histogram's bin indices are
# computed in float64 in either precision (ops/ih.ih_freq), so the f32
# card run's histograms equal the f64 CPU run's and these members must too
IH_FROM_HISTOGRAM = ("IH_NUM_BINS", "IH_MODE_IDX", "IH_MAX_GRADIENT_IDX",
                     "IH_MIN_GRADIENT_IDX")


def check_ih_columns(what, cols, dev, ref):
    """IH_FROM_HISTOGRAM equal between the card and the CPU run."""
    for c in IH_FROM_HISTOGRAM:
        j = cols.index(c)
        if not np.array_equal(dev[:, j], ref[:, j]):
            raise AssertionError("%s: %s differs between the card and the "
                                 "CPU run" % (what, c))


def check_ibsi(kern):
    """Phase 3, IBSI: the IBSI *ALL* (793 columns) on the reference fixture
    slide (intensities % 59 + 1, 64 raw levels) and on the long-ROI slide
    at 12 bits (intensities >> 4, 4096 raw levels: GLCM's [4, 4096, 4096]
    matrices in device memory, a chunk of one ROI at a time), then IBSI
    *3D_ALL* on the fixture volume, each in f32 on the card against f64 on
    the CPU at the tiers; the IH members read off the histogram equal;
    every kernel of the path launched."""
    import torch
    from nyxus_tpu_torch import columns, taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.pipeline.runner import PairRunner
    from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner
    fset = taxonomy.parse_feature_request(FEATURES_ALL, ibsi=True)
    hdr, slots = columns.build_header(fset, EngineConfig(ibsi=True))
    cols = hdr[4:]
    if len(cols) != WIDTH_IBSI:
        raise AssertionError("IBSI width %d != %d" % (len(cols), WIDTH_IBSI))
    card = PairRunner(fset, EngineConfig(precision="f32", ibsi=True), "cuda")
    cpu = PairRunner(fset, EngineConfig(precision="f64", ibsi=True), "cpu")
    host_cols = pre_host_columns(card, slots)
    fi, fl = make_dsb_like(320, 320, 40, seed=11)
    li, ll = make_long_roi_slide()
    for what, (intens, labels), used in (
            ("320x320 slide, IBSI (64 raw levels)",
             ((fi % 59 + 1).astype(np.uint16), fl), KERNELS_2D + KERNELS_IH),
            ("long-ROI slide at 12 bits, IBSI (4096 raw levels)",
             ((li >> 4).astype(np.uint16), ll),
             ("glcm_cooc", "glrlm_runs", "ih_stats"))):
        for f in kern.values():
            f.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        labs, dev = card.run(intens, labels)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = {k: kern[k].launches for k in KERNELS_2D + KERNELS_IH}
        labs64, ref = cpu.run(intens, labels)
        worst = check_output(what, cols, labs, dev, labs64, ref)
        if not np.array_equal(dev[:, host_cols].view(np.uint64),
                              ref[:, host_cols].view(np.uint64)):
            raise AssertionError("%s: the pre-collect host columns differ "
                                 "between the card and the CPU run" % what)
        check_ih_columns(what, cols, dev, ref)
        log("  %s: %d ROIs x %d columns agree, the %d pre-collect host "
            "columns bit for bit, %s equal; closest to its tier: %s; peak "
            "device memory %d bytes (%.1f MiB); launches %s"
            % (what, len(labs), len(cols), len(host_cols),
               "/".join(IH_FROM_HISTOGRAM), worst, peak, peak / 2 ** 20,
               launches))
        if not all(launches[k] for k in used):
            raise AssertionError("%s: a kernel was not launched: %r"
                                 % (what, launches))
    fset3 = taxonomy.parse_feature_request(FEATURES_3D, dim=3, ibsi=True)
    hdr3, slots3 = columns.build_header(fset3, EngineConfig(ibsi=True))
    cols3 = hdr3[4:]
    if len(cols3) != WIDTH_3D:
        raise AssertionError("3D IBSI width %d != %d" % (len(cols3), WIDTH_3D))
    vi, vl = blob3d(seed=4, shape=(48, 56, 60))
    vi = (vi % 59 + 1).astype(np.uint16)
    for f in kern.values():
        f.launches = 0
    labs, dev = VolumeRunner(fset3, EngineConfig(precision="f32", ibsi=True),
                             "cuda").run(vi, vl)
    launches = {k: kern[k].launches for k in KERNELS_3D}
    labs64, ref = VolumeRunner(fset3, EngineConfig(precision="f64", ibsi=True),
                               "cpu").run(vi, vl)
    worst = check_output("fixture volume, IBSI", cols3, labs, dev, labs64, ref)
    surf = surface_columns(slots3)
    if not np.array_equal(dev[:, surf].view(np.uint64),
                          ref[:, surf].view(np.uint64)):
        raise AssertionError("fixture volume, IBSI: the surface columns "
                             "differ between the card and the CPU run")
    log("  fixture volume, IBSI: %d ROIs x %d columns agree, the %d surface "
        "columns bit for bit; closest to its tier: %s; launches %s"
        % (len(labs), len(cols3), len(surf), worst, launches))
    if not all(launches.values()):
        raise AssertionError("3D IBSI: a kernel was not launched: %r"
                             % launches)
    return card, cpu, cols


# K2's device kernels by name, for their total over a profiled slide
KERNEL_NAMES_K2 = {"K2 glcm_cooc": "glcm_cooc"}
# K13-K16's device kernels by name, for their totals over a profiled volume
KERNEL_NAMES_3D = {"K13 glcm3d_cooc": "glcm3d_", "K14 glrlm3d_runs": "glrlm3d_",
                   "K15 cc3d": "cc3d_", "K16 stencil3d": "stencil3d_"}


def profile_report(what, run, stage_prefix="nyx:", totals=None):
    """Profile one warm run: wall, device busy share, the top device
    kernels, the device ms and launches of each group of ``totals`` (label
    -> a substring of its kernels' names), and the host ms (and card span)
    of each nyx:* runner stage."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for name, us in device_events(prof):
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, cnt + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e3
    log("  %s: wall %.2f ms (profiled), device busy %.2f ms (%.1f%%) in %d "
        "kernel/copy launches of %d names"
        % (what, pwall, busy, 100 * busy / pwall,
           sum(c for _, c in by_name.values()), len(by_name)))
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
        log("    %8.3f ms %5d x  %s" % (tot / 1e3, cnt, name[:100]))
    for label, part in (totals or {}).items():
        hits = [v for name, v in by_name.items() if part in name]
        log("  %s over the run: device %.4f ms in %d launches"
            % (label, sum(t for t, _ in hits) / 1e3,
               sum(c for _, c in hits)))
    stages = {}
    for e in prof.events():
        if e.name.startswith(stage_prefix):
            on_host = e.device_type != DeviceType.CUDA
            st = stages.setdefault(e.name, [0.0, 0.0])
            st[0 if on_host else 1] += e.time_range.elapsed_us() / 1e3
    log("  runner stages (nyx:* ranges): host ms, and the span on the card "
        "from their first to their last kernel")
    for name, (host_ms, span_ms) in stages.items():
        log("    %-58s host %8.2f ms   card span %8.2f ms"
            % (name, host_ms, span_ms))


# ---------------------------------------------------------------------------
# phase 3b: the 2D file protocol


def check_files(kern, card_runner):
    """Phase 3b: TIFF pairs written by the port's writer (the 320 x 320
    slide tiled LZW in 128-px tiles, the long-ROI slide stripped Deflate,
    make_dsb_like(seed=7) tiled LZW in 512-px tiles as bench.py's corpus
    has it), read back exactly, then *ALL* through
    Nyxus._iter_directory_raw in memory and tile-streamed (ram_limit=1),
    each pair's labels equal to PairRunner.run's on the decoded arrays on
    the card and its values within the f32 tiers of that run, K1-K12
    launched by each; the 1024² pair's wall through the file path beside
    PairRunner.run's."""
    import importlib
    import tempfile

    import torch

    from nyxus_tpu_torch import Nyxus
    from nyxus_tpu_torch.api import _force_finite
    from nyxus_tpu_torch.io.readers import read_gray
    from nyxus_tpu_torch.io.tiff import write_tiff

    have = {}
    for mod in ("PIL", "pandas", "pyarrow"):
        try:
            importlib.import_module(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    log("  importable on this machine (pandas needed by phase 3c's "
        "featurize_directory and phase 3d's ImageQuality.featurize): %s"
        % ", ".join("%s %s" % (m, "yes" if ok else "no")
                    for m, ok in have.items()))
    pairs = {"fixture320.tif": (make_dsb_like(320, 320, 40, seed=11), 128,
                                "lzw"),
             "long_roi.tif": (make_long_roi_slide(), 0, "deflate"),
             "slide1.ome.tif": (make_dsb_like(seed=7), 512, "lzw")}
    with tempfile.TemporaryDirectory(prefix="nyx_files_") as root:
        int_dir = os.path.join(root, "int")
        seg_dir = os.path.join(root, "seg")
        os.makedirs(int_dir)
        os.makedirs(seg_dir)
        t0 = time.perf_counter()
        for name, ((intens, labels), tile, comp) in pairs.items():
            write_tiff(os.path.join(int_dir, name), intens.astype(np.uint16),
                       tile_size=tile, compression=comp)
            write_tiff(os.path.join(seg_dir, name), labels.astype(np.uint16),
                       tile_size=tile, compression=comp)
        log("  3 pairs written in %.3f s: %s" % (
            time.perf_counter() - t0, ", ".join(
                "%s %s %s %s" % (name, "x".join(map(str, a[0].shape)),
                                 "tiles %d" % tile if tile else "strips", comp)
                for name, (a, tile, comp) in pairs.items())))
        for name, ((intens, labels), _, _) in pairs.items():
            t0 = time.perf_counter()
            ri = read_gray(os.path.join(int_dir, name))
            rl = read_gray(os.path.join(seg_dir, name))
            dt = time.perf_counter() - t0
            if not (ri.dtype == np.uint16 and np.array_equal(ri, intens)
                    and np.array_equal(rl, labels)):
                raise AssertionError("%s: read_gray differs from what was "
                                     "written" % name)
            if name == "slide1.ome.tif":
                TIFF_3B["decode_s"] = dt
                log("  the 1024² pair decoded in %.4f s (tiled LZW, four "
                    "512² tiles a file)" % dt)
        want = {}
        for name, ((intens, labels), _, _) in pairs.items():
            labs, vals = card_runner.run(intens, labels)
            want[name] = (labs, _force_finite(vals, card_runner.cfg.noval))
        fset_cols = columns_of(card_runner)
        for what, kw in (("in memory", {}), ("streamed", {"ram_limit": 1})):
            nyx = Nyxus(FEATURES_ALL, **kw)
            calls = {"run": 0, "run_streamed": 0}
            for meth in calls:
                count_calls(nyx._runner, meth, calls)
            for f in kern.values():
                f.launches = 0
            got = list(nyx._iter_directory_raw(int_dir, seg_dir, ".*"))
            launches = {k: kern[k].launches for k in KERNELS_2D}
            if [os.path.basename(g[0]) for g in got] != sorted(pairs):
                raise AssertionError("files path %s: pairs %s" % (
                    what, [g[0] for g in got]))
            want_calls = {"run": 0, "run_streamed": 3} if kw else \
                {"run": 3, "run_streamed": 0}
            if calls != want_calls:
                raise AssertionError("files path %s: runner calls %s"
                                     % (what, calls))
            worst = []
            for ipath, _, labs, vals in got:
                wl, wv = want[os.path.basename(ipath)]
                if list(labs) != list(wl) or vals.shape != wv.shape \
                        or not np.isfinite(vals).all():
                    raise AssertionError("files path %s, %s: labels/shape "
                                         "%s vs %s" % (what, ipath,
                                                       vals.shape, wv.shape))
                bad, w = compare_tiers(fset_cols, vals, wv)
                if bad:
                    raise AssertionError("files path %s, %s: beyond the f32 "
                                         "tiers of PairRunner.run: %r"
                                         % (what, ipath, bad[:20]))
                worst.append((os.path.basename(ipath), w,
                              int((vals.view(np.uint64)
                                   == wv.view(np.uint64)).all(axis=0).sum())))
            if not all(launches.values()):
                raise AssertionError("files path %s: a kernel was not "
                                     "launched: %r" % (what, launches))
            log("  %s: %d pairs through %s, labels equal to PairRunner.run's "
                "on the card; (pair, closest to its tier, columns bit-equal "
                "of %d) %s; launches %s"
                % (what, len(got), "run_streamed" if kw else "run",
                   len(fset_cols), worst, launches))
        intens, labels = pairs["slide1.ome.tif"][0]
        times = {}
        for what, kw in (("file path in memory", {}),
                         ("file path streamed", {"ram_limit": 1})):
            nyx = Nyxus(FEATURES_ALL, **kw)
            t0 = time.perf_counter()
            out = list(nyx._iter_directory_raw(int_dir, seg_dir,
                                               r"slide1\.ome\.tif"))
            torch.cuda.synchronize()
            times[what] = time.perf_counter() - t0
            if len(out) != 1:
                raise AssertionError("timed file path: %d pairs" % len(out))
        t0 = time.perf_counter()
        card_runner.run(intens, labels)
        torch.cuda.synchronize()
        times["PairRunner.run on the decoded arrays"] = \
            time.perf_counter() - t0
        TIFF_3B["walls"] = times
        log("  the 1024² pair (%d ROIs, warm): %s; card %s"
            % (len(want["slide1.ome.tif"][0]),
               ", ".join("%s %.4f s" % kv for kv in times.items()),
               card_line()))


# ---------------------------------------------------------------------------
# phase 3c: the 2D run modes and the CLI

# each mode as (name, EngineConfig keywords, Nyxus keywords); the factors
# narrowed to C float, as every entry point of the port does
MODES_3C = (("mergerois", {"mergerois": True}, {"mergerois": True}),
            ("whole-slide", {}, {}),
            ("anisotropy 1.4 x 0.75",
             {"aniso_x": float(np.float32(1.4)),
              "aniso_y": float(np.float32(0.75))},
             {"anisotropy_x": 1.4, "anisotropy_y": 0.75}))
# the 2D kernels' device functions by name, for their totals over a
# profiled run
KERNEL_NAMES_2D = {"K1 batched_hist": "batched_hist", "K2 glcm_cooc":
                   "glcm_cooc", "K3 glrlm_runs": "glrlm_runs",
                   "K4 neigh_matrix": "neigh_matrix",
                   "K5 zone_dag": "zone_dag", "K6 zone_cc4": "zone_cc4",
                   "K7 zone_stats": "zone_stats", "K8 erosion": "erosion_",
                   "K9 binary_quads": "binary_quads",
                   "K10 power_sums": "power_sums", "K11 gabor": "gabor_",
                   "K12 zernike": "zernike"}
# the JAX package's Stopwatch keys of its runner (nyxus_tpu/pipeline/
# runner.py), which the port's timing CSV must use
JAX_STAGE_KEYS = ("Pipeline/Phase1_discovery/#cca33a",
                  "Pipeline/Contours/#777799",
                  "Pipeline/Host/geom_batch/#99bb55",
                  "Pipeline/Phase2_device_batches/#33cc77",
                  "Pipeline/Phase2_collect/#33aa99")


def write_pair_dir(root, pairs, tile=64):
    """int/ and seg/ under ``root`` holding each (name, (intens, labels))
    of ``pairs`` as TIFFs written by the port's writer (tiled LZW)."""
    from nyxus_tpu_torch.io.tiff import write_tiff
    int_dir, seg_dir = os.path.join(root, "int"), os.path.join(root, "seg")
    os.makedirs(int_dir)
    os.makedirs(seg_dir)
    for name, (intens, labels) in pairs:
        write_tiff(os.path.join(int_dir, name), intens, tile_size=tile)
        write_tiff(os.path.join(seg_dir, name), labels.astype(np.uint16),
                   tile_size=tile)
    return int_dir, seg_dir


def check_modes(kern):
    """Phase 3c: *ALL* under mergerois, whole-slide mode and anisotropy 1.4
    x 0.75 in f32 on the card against the f64 CPU run (check_output: the
    f32 tiers of tests/test_tpu_device.py), in memory through PairRunner.run
    on the parity slide make_dsb_like(320, 320, 40, seed=11) and
    tile-streamed (ram_limit=1) through Nyxus._iter_directory_raw over its
    TIFF pair, K1-K12 launched in each run.  Streamed, mergerois and
    whole-slide mode run on the slide's top-left 255 x 255 window: the
    merged ROI or the slide's inclusive box fits ram_limit=1's 1 MB batch
    budget (a 256² bucket), so that these runs take the trivial path
    (phase 3d runs the oversized one)."""
    import tempfile

    import torch

    from nyxus_tpu_torch import Nyxus, columns, taxonomy
    from nyxus_tpu_torch.api import _force_finite
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.pipeline.runner import PairRunner

    fset = taxonomy.parse_feature_request(FEATURES_ALL)
    full = make_dsb_like(320, 320, 40, seed=11)
    window = tuple(np.ascontiguousarray(a[:255, :255]) for a in full)
    with tempfile.TemporaryDirectory(prefix="nyx_modes_") as root:
        dirs = {name: write_pair_dir(os.path.join(root, name),
                                     [("slide.tif", pair)])
                for name, pair in (("full", full), ("window", window))}
        for mode, cfg_kw, nyx_kw in MODES_3C:
            ws = mode == "whole-slide"
            card = PairRunner(fset, EngineConfig(precision="f32", **cfg_kw),
                              "cuda")
            cpu = PairRunner(fset, EngineConfig(precision="f64", **cfg_kw),
                             "cpu")
            cols = columns.build_header(fset, EngineConfig(**cfg_kw))[0][4:]
            for what in ("in memory", "streamed"):
                src = "window" if what == "streamed" and mode in (
                    "mergerois", "whole-slide") else "full"
                intens, labels = full if src == "full" else window
                lab = np.ones(intens.shape, np.uint32) if ws \
                    else labels.astype(np.uint32)
                labs64, ref = cpu.run(intens, lab, wholeslide=ws)
                for f in kern.values():
                    f.launches = 0
                if what == "in memory":
                    labs, dev = card.run(intens, lab, wholeslide=ws)
                else:
                    nyx = Nyxus(FEATURES_ALL, ram_limit=1, **nyx_kw)
                    calls = {"run": 0, "run_streamed": 0}
                    for meth in calls:
                        count_calls(nyx._runner, meth, calls)
                    int_dir, seg_dir = dirs[src]
                    (_, _, labs, dev), = nyx._iter_directory_raw(
                        int_dir, int_dir if ws else seg_dir, ".*")
                    if calls != {"run": 0, "run_streamed": 1}:
                        raise AssertionError("%s streamed: runner calls %s"
                                             % (mode, calls))
                    ref = _force_finite(ref, nyx.cfg.noval)
                torch.cuda.synchronize()
                launches = {k: kern[k].launches for k in KERNELS_2D}
                label = "%s, %s (%s slide)" % (mode, what, "320²" if src
                                               == "full" else "255² window")
                worst = check_output(label, cols, labs, dev, labs64, ref)
                if not all(launches.values()):
                    raise AssertionError("%s: a kernel was not launched: %r"
                                         % (label, launches))
                log("  %s: %d ROIs x %d columns agree with the f64 CPU run; "
                    "closest to its tier: %s; launches %s"
                    % (label, len(labs), len(cols), worst, launches))


def wholeslide_throughput(kern, slides):
    """Phase 3c at full size: whole-slide mode through
    Nyxus.featurize_directory (pandas output) over the 8 slides of phase 4
    written as TIFFs (the port's writer, tiled LZW in 512-px tiles), one
    ROI a slide whose inclusive 1025² box pads to a 2048² bucket: one
    untimed slide, then the 8 timed (seconds a slide, peak device memory,
    launches a slide), the output checked (one finite row of 747 columns a
    slide, the 1025 x 1025 box, the slide's area), then one slide profiled:
    device time and launches of each of K1-K12 at that crop.  Returns slide
    7's row."""
    import tempfile

    import torch

    from nyxus_tpu_torch import Nyxus
    from nyxus_tpu_torch.io.tiff import write_tiff

    with tempfile.TemporaryDirectory(prefix="nyx_ws_") as root:
        t0 = time.perf_counter()
        for k, (intens, _) in enumerate(slides):
            write_tiff(os.path.join(root, "slide%02d.ome.tif" % (7 + k)),
                       intens, tile_size=512)
        log("  %d whole-slide TIFFs written in %.2f s" % (
            len(slides), time.perf_counter() - t0))
        nyx = Nyxus(FEATURES_ALL)
        nyx.featurize_directory(root, file_pattern=r"slide07\.ome\.tif")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in kern.values():
            f.launches = 0
        t0 = time.perf_counter()
        df = nyx.featurize_directory(root)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: kern[k].launches for k in KERNELS_2D}
        vals = df[df.columns[4:]].to_numpy(np.float64)
        if (len(df) != len(slides) or vals.shape[1] != WIDTH_ALL
                or list(df.ROI_label) != [1] * len(slides)
                or set(df.mask_image) != {""}
                or not np.isfinite(vals).all()
                or set(df.BBOX_WIDTH) != {WS_SLIDE + 1}
                or set(df.BBOX_HEIGHT) != {WS_SLIDE + 1}
                or set(df.AREA_PIXELS_COUNT) != {WS_SLIDE ** 2}):
            raise AssertionError("whole-slide slides: bad output %s" % (
                vals.shape,))
        if not all(launches.values()):
            raise AssertionError("whole-slide slides: a kernel was not "
                                 "launched: %r" % launches)
        log("  whole-slide *ALL* over %d 1024² slides: %.4f s, %.4f s a "
            "slide; peak device memory %d bytes (%.1f MiB); launches a "
            "slide %s; card %s"
            % (len(slides), wall, wall / len(slides), peak, peak / 2 ** 20,
               {k: v / len(slides) for k, v in launches.items()},
               card_line()))
        profile_report("whole-slide slide 8 of *ALL* (2048² bucket)",
                       lambda: nyx.featurize_directory(
                           root, file_pattern=r"slide08\.ome\.tif"),
                       totals=KERNEL_NAMES_2D)
    return vals[0]


def check_cli():
    """Phase 3c, the CLI: python3 -m nyxus_tpu_torch.cli --features=*ALL*
    --outputType=singlecsv --exclusivetiming=true as a subprocess on the
    card (its default device) over a directory of two TIFF pairs (the
    parity slide and the long-ROI slide), its CSV against the in-process
    Nyxus.featurize_directory frame on the card: the same header, rows,
    names and labels, every value within the f32 tiers (two runs on the
    card may differ in the last bits where float atomics add in another
    order); and <seg>_nyxustiming.csv, whose stages are the JAX package's
    runner keys."""
    import tempfile

    import pandas as pd

    from nyxus_tpu_torch import Nyxus, registry

    with tempfile.TemporaryDirectory(prefix="nyx_cli_") as root:
        int_dir, seg_dir = write_pair_dir(
            root, [("fixture320.tif", make_dsb_like(320, 320, 40, seed=11)),
                   ("long_roi.tif", make_long_roi_slide())])
        out = os.path.join(root, "out")
        cmd = [sys.executable, "-m", "nyxus_tpu_torch.cli",
               "--intDir=" + int_dir, "--segDir=" + seg_dir,
               "--outDir=" + out, "--features=*ALL*",
               "--outputType=singlecsv", "--exclusivetiming=true"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                           timeout=900,
                           env=dict(os.environ, PYTHONPATH=HERE))
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError("the CLI exited %d:\n%s" % (
                r.returncode, r.stderr[-3000:]))
        got = pd.read_csv(os.path.join(out, "NyxusFeatures.csv"), dtype=str,
                          keep_default_na=False)
        want = Nyxus(FEATURES_ALL).featurize_directory(int_dir, seg_dir)
        if list(got.columns) != list(want.columns) or len(got) != len(want):
            raise AssertionError("the CLI's CSV: columns/rows differ")
        for c in want.columns[:3]:
            if list(got[c]) != [str(v) for v in want[c]]:
                raise AssertionError("the CLI's CSV: column %s differs" % c)
        cols = list(want.columns[4:])
        g = np.array(got[cols].to_numpy().tolist(), np.float64)
        w = want[cols].to_numpy(np.float64)
        bad, worst = compare_tiers(cols, g, w)
        if bad or not np.isfinite(g).all():
            raise AssertionError("the CLI's CSV beyond the f32 tiers of the "
                                 "in-process frame: %r" % bad[:20])
        exact = int((g == w).all(axis=0).sum())
        tpath = os.path.join(out, "seg_nyxustiming.csv")
        with open(tpath) as f:
            rows = [ln.split(",") for ln in f.read().splitlines()]
        hosts = {"Pipeline/Host/%s/#bbbbbb" % name for name in registry.FAMILIES}
        keys = {"/".join(p for p in row[:4] if p) for row in rows[1:]}
        if rows[0] != ["h1", "h2", "h3", "color", "seconds", "calls"] \
                or not set(JAX_STAGE_KEYS) <= keys \
                or not keys <= set(JAX_STAGE_KEYS) | hosts:
            raise AssertionError("the timing CSV: header %s, stages %s"
                                 % (rows[0], sorted(keys)))
        log("  the CLI (subprocess, %.1f s): %d rows x %d columns equal to "
            "featurize_directory's in names and labels, within the f32 tiers "
            "(%d columns bit-equal; closest to its tier %s); %s holds %d "
            "stages under the JAX package's keys: %s"
            % (wall, len(got), len(cols), exact, worst,
               os.path.basename(tpath), len(keys),
               ", ".join("%s %s s" % ("/".join(p for p in row[:3] if p
                                               and not p.startswith("#")),
                                      row[4]) for row in rows[1:]
                         if not row[1] == "Host" or row[2] == "geom_batch")))


# ---------------------------------------------------------------------------
# phase 3d: oversized ROIs (phase 3) and ImageQuality

# float64 outside the tensor cores (NVIDIA's H100 SXM data sheet: 34
# TFLOP/s at 700 W): the rate the bounds of the intensity, IH and texture
# finish stages charge their operations at, as they run in float64 in
# either precision; the power spectrum runs in its frame's dtype
F64_OPS_S = 34e12
SW_OVERSIZED = "Pipeline/Phase3_oversized/#cc7733"
# the columns phase 3 defines otherwise than the trivial path in whole-slide
# mode (tests/test_torch_oversized.py OWN_DEFINITION): the hull and
# calipers of the box's four-corner contour, two extrema points
WS_OWN_DEFINITION = ("CONVEX_HULL_AREA", "SOLIDITY", "EXTREMA_P3_Y",
                     "EXTREMA_P6_X") + tuple(
    "STAT_%s_DIAM_%s" % (k, s) for k in ("FERET", "MARTIN", "NASSENSTEIN")
    for s in ("MIN", "MAX", "MEAN", "MEDIAN", "MODE", "STDDEV"))
# central moments of a whole slide's full box that its symmetry makes 0:
# float residue on both sides (the JAX package's reference test,
# tests/test_wholeslide_parity.py, leaves CENTRAL_MOMENT_23/33 out), held
# by absolute size against the largest central moment instead
WS_SYMMETRIC_ZERO = ("CENTRAL_MOMENT_23", "CENTRAL_MOMENT_32",
                     "CENTRAL_MOMENT_33")
# the finish stages, by what they replace in the JAX package
FINISH_REPLACES = {
    "intensity_members": "nyxus_tpu/pipeline/oversized.py:209",
    "ih_members": "nyxus_tpu/pipeline/oversized.py:231",
    "texture_members": "nyxus_tpu/pipeline/oversized.py:456",
    "spectrum_bins": "nyxus_tpu/pipeline/imq_streamed.py:325"}
IMQ_COLS = ("FOCUS_SCORE", "LOCAL_FOCUS_SCORE", "MIN_SATURATION",
            "MAX_SATURATION", "SHARPNESS", "POWER_SPECTRUM_SLOPE")


def make_oversized_pair():
    """tests/test_oversized.py's make_pair: 700 x 800 uniform noise in 1..2999
    (default_rng(11)), an ellipse of ~601 x 661 px (label 5, its AABB in a
    1024² bucket) and a 20 x 30 box (label 2)."""
    r = np.random.default_rng(11)
    intens = r.integers(1, 3000, (700, 800)).astype(np.uint16)
    labels = np.zeros((700, 800), np.int32)
    yy, xx = np.mgrid[0:700, 0:800]
    blob = ((yy - 350) ** 2 / 300.0 ** 2 + (xx - 380) ** 2 / 330.0 ** 2) <= 1
    labels[blob] = 5
    labels[10:30, 10:40] = 2
    return intens, labels


def ibsi_pair(pair):
    """The oversized pair at IBSI's raw levels: (intensity >> 4) + 1 (up to
    188, matrices of 256 levels)."""
    return ((pair[0] >> 4) + 1).astype(np.uint16), pair[1]


def oversized_ref(ibsi):
    """Worker process: the f64 CPU run of the oversized pair at ram_limit=1
    (*ALL*, or *ALL* in IBSI mode on ibsi_pair): (labels, values)."""
    sys.path.insert(0, HERE)
    import torch
    torch.set_num_threads(2)
    from nyxus_tpu_torch import taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.pipeline.runner import PairRunner
    pair = make_oversized_pair()
    if ibsi:
        pair = ibsi_pair(pair)
    fset = taxonomy.parse_feature_request(FEATURES_ALL, ibsi=ibsi)
    return PairRunner(fset, EngineConfig(precision="f64", ibsi=ibsi,
                                         ram_limit_mb=1), "cpu").run(*pair)


def imq_ref(seed):
    """Worker process: the f64 CPU ImageQuality.featurize row of corpus
    slide make_dsb_like(seed=seed), no label image (the whole image):
    (labels, values)."""
    sys.path.insert(0, HERE)
    import torch
    torch.set_num_threads(2)
    from nyxus_tpu_torch import ImageQuality
    intens, _ = make_dsb_like(1024, 1024, 300, seed=seed)
    iq = ImageQuality(device="cpu", precision="f64")
    return frame_rows(iq, iq.featurize(intens))


def frame_rows(nyx, df):
    """(labels, values [N, n_out]) of a featurize frame."""
    from nyxus_tpu_torch import columns
    return (df[columns.COL_LABEL].to_numpy(),
            df[list(nyx.header[4:])].to_numpy(np.float64))


def unserved_columns(cols, over, triv):
    """Columns the phase-3 row ``over`` leaves unassigned (-0.0) where the
    trivial row ``triv`` holds a value (a computed zero within 1e-7 of the
    trivial value, a vanishing Hu invariant, counts as served)."""
    return [c for c, a, b in zip(cols, over, triv)
            if a == 0.0 and np.signbit(a) and not (b == 0.0 and np.signbit(b))
            and abs(b) > 1e-7]


def timed_run(kern, run):
    """(result, wall s, launches, peak device bytes, Phase3_oversized s) of
    run(), the Stopwatch on and every count set to 0 just before."""
    import torch

    from nyxus_tpu_torch.timing import Stopwatch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in kern.values():
        f.launches = 0
    Stopwatch.reset()
    Stopwatch.enable(True)
    try:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Stopwatch.enable(False)
    launches = {k: f.launches for k, f in kern.items() if f.launches}
    return (out, wall, launches, torch.cuda.max_memory_allocated(),
            Stopwatch.totals().get(SW_OVERSIZED, 0.0))


# phase 3d's walls, kept to be printed again near the end of the output
OVERSIZED_WALLS = []


def log_run(what, wall, launches, peak, p3):
    """Log a phase-3d run; its walls are host-clock times taken while the
    three f64 CPU reference processes may still run (up to 6 of the host's
    cores busy)."""
    log("  %s: wall %.4f s, Pipeline/Phase3_oversized %.4f s, peak device "
        "memory %d bytes (%.1f MiB), launches %s"
        % (what, wall, p3, peak, peak / 2 ** 20, launches))
    OVERSIZED_WALLS.append("%s: wall %.4f s, phase 3 %.4f s, peak %.1f MiB"
                           % (what.split(" ")[0], wall, p3, peak / 2 ** 20))


def device_profile(kern, fn, windows=5):
    """(device ms, kernel launches, copies and memsets, the kernels'
    launches) of one call of fn(), from torch.profiler traces: the sum of
    its kernels and copies, the two counted apart, and the wrappers' counts
    over the call.  The trace drops a call's device events now and then
    (all of them, in one window of the whole smoke), never adds any: of
    ``windows`` traced calls the one with the most events counts.  Where
    none holds any, the first three are None."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    best, kl = [], None
    for _ in range(windows):
        torch.cuda.synchronize()
        for f in kern.values():
            f.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = device_events(prof)
        kl = {k: f.launches for k, f in kern.items() if f.launches}
        if len(seen) > len(best):
            best = seen
    if not best:
        return None, None, None, kl
    copies = sum(n.startswith(("Memcpy", "Memset")) for n, _ in best)
    return (sum(us for _, us in best) / 1e3, len(best) - copies, copies,
            kl)


def flat_members(out):
    """{member: value or array} (or {family: {member: ...}}) -> (names,
    float64 values), in key order."""
    names, vals = [], []
    for k, v in out.items():
        if isinstance(v, dict):
            n, x = flat_members(v)
            names += ["%s/%s" % (k, m) for m in n]
            vals.append(x)
            continue
        x = np.asarray(v, np.float64).ravel()
        names += [k] * x.size
        vals.append(x)
    return names, np.concatenate(vals) if vals else np.zeros(0)


def same_members(what, card, cpu, rtol=1e-9, atol=1e-12):
    """Hold a finish stage's members on the card against the same stage on
    the CPU over the same accumulators, every member (the DISCRETE ones,
    MEDIAN, MODE, P01-P99, IQR, included): NaN in the same places, else
    within rtol / atol.  Returns (members, the largest |a - b| / (atol +
    rtol |b|) and its member)."""
    names, a = flat_members(card)
    names_b, b = flat_members(cpu)
    if names != names_b:
        raise AssertionError("%s: the card's members %r differ from the "
                             "CPU's %r" % (what, names, names_b))
    nan = np.isnan(a) | np.isnan(b)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError("%s: NaN on one side only: %r" % (what, [
            n for n, x, y in zip(names, a, b) if np.isnan(x) != np.isnan(y)]))
    r = np.where(nan, 0.0, np.abs(a - b) / (atol + rtol * np.abs(b)))
    k = int(np.argmax(r)) if r.size else 0
    if r.size and r[k] > 1.0:
        bad = [(n, x, y) for n, x, y, q in zip(names, a, b, r) if q > 1.0]
        raise AssertionError("%s: card and CPU differ beyond rtol %g: %r"
                             % (what, rtol, bad[:10]))
    return len(names), (names[k] if r.size else None,
                        float(r[k]) if r.size else 0.0)


def finish_stage_rows(kern, pair, ipair):
    """The four finish stages on the card at the oversized pair's big ROI
    (label 5): each one's call ms (CUDA events, the host's preparation and
    the device-to-host copy included) and device ms and launches (profiler)
    a call, its K1 / K17 launches, its bound and, for the power spectrum,
    the library's torch.fft.fft2 + scatter_add_ on the same frame.  The
    texture finish is profiled inside texture_members, whose device work
    is the finish alone (the sweep is numpy); its ms is the whole call's
    host wall.  The intensity, IH and texture stages are each held against
    the same stage on the CPU over the same accumulators, every member at
    rtol 1e-9 (both in float64).  A bound charges float64 operations at
    F64_OPS_S and the power spectrum's, which runs in its frame's dtype
    (float32 here), at OPS_S."""
    import torch

    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.ops.ih import MEMBERS as IH_MEMBERS
    from nyxus_tpu_torch.pipeline import imq_streamed as oimq
    from nyxus_tpu_torch.pipeline import labels as plabels
    from nyxus_tpu_torch.pipeline import oversized as ovs
    from nyxus_tpu_torch.pipeline.sources import ArrayPairSource

    rows = []

    def big(p):
        recs, smin, smax = plabels._discover_rois_np(*p)
        return next(r for r in recs if r.label == 5), smin, smax

    cfg = EngineConfig(precision="f32")
    cfg_i = EngineConfig(precision="f32", ibsi=True)
    rec, smin, smax = big(pair)
    src = ArrayPairSource(*pair)
    acc = ovs.accumulate(rec, src)
    reci, smini, smaxi = big(ipair)
    acci = ovs.accumulate(reci, ArrayPairSource(*ipair))
    N = int(cfg_i.coarse_gray_depth)

    def add(name, fn, nbytes, ops, rate=F64_OPS_S, ms=None, library=None,
            note="", agree=None):
        if ms is None:
            ms = timed(fn)[0]
        dev_ms, n_dev, n_copies, kl = device_profile(kern, fn)
        bound = max(nbytes / HBM_BYTES_S, ops / rate) * 1e3
        rows.append({"name": name, "replaces": FINISH_REPLACES[name],
                     "how": note, "ms": ms, "device_ms": dev_ms,
                     "device_launches": n_dev, "device_copies": n_copies,
                     "kernel_launches": kl,
                     "bound_ms": bound, "bound_by": "bytes" if nbytes /
                     HBM_BYTES_S >= ops / rate else "operations",
                     "library_ms": library, "agree": agree})

    # the weighted intensity statistics: the n sorted unique values and
    # their counts in (float64), ~40 members and the histogram out; ~60
    # float64 operations a value (the moments to the sixth power, two
    # binnings, the cumulative sums)
    n = acc.vals.size
    nb = abs(cfg.coarse_gray_depth)
    agree = same_members(
        "intensity_members",
        ovs.intensity_members(acc, smin, smax, cfg, "cuda"),
        ovs.intensity_members(acc, smin, smax, cfg, "cpu"))
    add("intensity_members",
        lambda: ovs.intensity_members(acc, smin, smax, cfg, "cuda"),
        n * 16 + (40 + nb) * 8, n * 60, agree=agree,
        note="torch over the streamed value histogram; K1 "
             "(masked_bincount) for its 100-bin and custom histograms")
    # IH: the N-bin histogram in, 46 members out, ~60 operations a bin
    agree = same_members(
        "ih_members", ovs.ih_members(acci, cfg_i, smini, 0.0, "cuda"),
        ovs.ih_members(acci, cfg_i, smini, 0.0, "cpu"))
    add("ih_members",
        lambda: ovs.ih_members(acci, cfg_i, smini, 0.0, "cuda"),
        N * 8 + len(IH_MEMBERS) * 8, N * 60, agree=agree,
        note="K17 (ih_stats) over the streamed histogram, IBSI only")
    # textures: what texture_members uploads (the accumulated matrices as
    # uploaded and, of its zone lists, the unique (level, size) pairs that
    # _agg_zones keeps, not their padding) in float64, the members out;
    # ~50 operations a matrix cell and a zone and NGTDM's ng^2 pair terms
    # (its five statistics over [ng, ng])
    fams = list(ovs.TEX_FAMILIES)
    ng = abs(cfg.coarse_gray_depth)
    seen = {"elems": 0, "zones": 0, "zone_slots": 0}
    dev0, agg0 = ovs._dev, ovs._agg_zones

    def dev(x, device, dtype=ovs.FINISH_DTYPE):
        seen["elems"] += np.asarray(x).size
        return dev0(x, device, dtype)

    def agg(*a):
        out = agg0(*a)
        seen["zones"] += out[0].shape[1]
        seen["zone_slots"] += 3 * ovs._pow2(out[0].shape[1])
        return out

    ovs._dev, ovs._agg_zones = dev, agg
    try:
        t0 = time.perf_counter()
        tex_card = ovs.texture_members(rec, src, cfg, fams, smax,
                                       device="cuda")
        torch.cuda.synchronize()
        tex_wall = (time.perf_counter() - t0) * 1e3
    finally:
        ovs._dev, ovs._agg_zones = dev0, agg0
    cells = seen["elems"] - seen["zone_slots"]
    zones = seen["zones"]
    outs = len(flat_members(tex_card)[0])
    log("  texture_members uploads %d matrix cells and %d aggregated zone "
        "pairs (%d slots with padding) and returns %d members"
        % (cells, zones, seen["zone_slots"] // 3, outs))
    agree = same_members(
        "texture_members", tex_card,
        ovs.texture_members(rec, src, cfg, fams, smax, device="cpu"))
    add("texture_members",
        lambda: ovs.texture_members(rec, src, cfg, fams, smax, device="cuda"),
        (cells + 3 * zones + outs) * 8,
        50 * (cells + zones) + 5 * 5 * ng * ng, ms=tex_wall, agree=agree,
        note="torch statistics (glcm_finalize, glrlm_features, the zone "
             "statistics over grouped_weight_sums, ngtdm_stats, "
             "gldm_features, ngldm_features_from_matrix) over the "
             "streamed matrices; no K1 or K17")
    # the power spectrum: the S x S float32 frame of the big ROI in, the
    # two radial sums out; a real-input FFT's 2.5 S² log2(S²) operations
    # and ~10 an element for the magnitudes, bins and weights, in float32
    S = 1
    while S < max(rec.height, rec.width):
        S *= 2
    cap = max(rec.height, rec.width)
    frame = np.zeros((S, S), np.float32)
    ii, ll = src.read_pair(rec.y0, rec.x0, rec.height, rec.width)
    frame[:rec.height, :rec.width] = np.where(ll == rec.label, ii, 0)

    def library():
        b = torch.from_numpy(frame).to("cuda")
        v = torch.abs(torch.fft.fft2(b)) / S
        li = (torch.floor(torch.sqrt(v)) + 1).long().clamp_(max=cap).ravel()
        out = torch.zeros((2, cap + 1), dtype=v.dtype, device="cuda")
        out[0].scatter_add_(0, li, v.ravel())
        out[1].scatter_add_(0, li, (v * v).ravel())
        return out[:, :cap].double().cpu().numpy()

    lib_ms = timed(library)[0]
    mag, pw = oimq.spectrum_bins(frame, cap, "cuda")
    ref = library()
    if not (np.allclose(mag, ref[0], rtol=1e-4, atol=1e-6)
            and np.allclose(pw, ref[1], rtol=1e-4, atol=1e-6)):
        raise AssertionError("spectrum_bins differs from torch.fft.fft2 + "
                             "scatter_add_")
    add("spectrum_bins", lambda: oimq.spectrum_bins(frame, cap, "cuda"),
        S * S * 4 + 2 * cap * 8,
        2.5 * S * S * np.log2(S * S) + 10 * S * S,
        rate=OPS_S if frame.dtype == np.float32 else F64_OPS_S,
        library=lib_ms,
        note="torch.fft.fft2, then both radial sums in one K1 "
             "(masked_bincount) launch over 128 rows of the spectrum")
    return rows


def check_oversized(kern, ws_row, slides):
    """Phase 3d: oversized ROIs on the card at the sizes users run, and
    ImageQuality; the f64 CPU references run meanwhile in three worker
    processes.
    (a) tests/test_oversized.py's 700 x 800 pair (the ~601 x 661 ellipse in
        a 1024² bucket and one small trivial ROI) with *ALL* at ram_limit=1
        in f32 on the card against the f64 CPU run of the same path, within
        the tiers; no column the card's trivial run (default budget) serves
        left unserved by phase 3; the same in IBSI mode at 256 raw levels
        (K17 over the streamed histogram); then the four finish stages
        timed at the big ROI, three of them held against the CPU on every
        member (finish_stage_rows)
    (b) corpus slide 7 (1024²) in whole-slide mode at ram_limit=1 through
        Nyxus._iter_directory_raw, tile-streamed: one 1 M-pixel oversized
        ROI, against phase 3c's in-memory whole-slide row within the tiers
        (but for WS_OWN_DEFINITION)
    (c) whole-slide mode at the default budget on an 8704 x 1024 slide (the
        8 corpus slides and the first's top half, stacked), oversized by its
        height alone, in memory through the directory path: timed, its
        intensity family against numpy over the slide
    (d) ImageQuality.featurize with no label image (the constant-1 label
        default) on the stack of the 8 corpus slides on the card against
        the f64 CPU featurize rows, then on one slide at ram_limit=1 in f64
        (its 1024² bucket over the budget: the streamed IMQ families, the
        power spectrum's FFT and K1 on the card) against its in-memory row
        at tests/test_imq.py's tolerances.
    Returns the finish stages' rows."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from nyxus_tpu_torch import ImageQuality, Nyxus, columns, taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.io.tiff import write_tiff
    from nyxus_tpu_torch.pipeline.runner import PairRunner

    fset = taxonomy.parse_feature_request(FEATURES_ALL)
    cols = columns.build_header(fset, EngineConfig())[0][4:]
    fset_i = taxonomy.parse_feature_request(FEATURES_ALL, ibsi=True)
    cols_i = columns.build_header(fset_i, EngineConfig(ibsi=True))[0][4:]
    pair = make_oversized_pair()
    ipair = ibsi_pair(pair)
    rows = None
    with ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        refs = {"all": pool.submit(oversized_ref, False),
                "ibsi": pool.submit(oversized_ref, True)}
        imq_refs = [pool.submit(imq_ref, s) for s in range(7, 15)]

        # (a)
        card = PairRunner(fset, EngineConfig(precision="f32",
                                             ram_limit_mb=1), "cuda")
        card.run(*pair)                                   # untimed pass
        (labs, dev), wall, launches, peak, p3 = timed_run(
            kern, lambda: card.run(*pair))
        log_run("(a) *ALL* on the 700 x 800 pair at ram_limit=1 (one "
                "oversized, one trivial ROI)", wall, launches, peak, p3)
        if not all(launches.get(k) for k in KERNELS_2D):
            raise AssertionError("(a): a kernel was not launched: %r"
                                 % launches)
        triv = PairRunner(fset, EngineConfig(precision="f32"), "cuda")
        (tl, tv), twall, tlaunch, tpeak, _ = timed_run(
            kern, lambda: triv.run(*pair))
        log_run("(a) the same pair at the default budget (both trivial, a "
                "1024² bucket)", twall, tlaunch, tpeak, 0.0)
        big = list(labs).index(5)
        unserved = unserved_columns(cols, dev[big], tv[list(tl).index(5)])
        if unserved or list(tl) != list(labs):
            raise AssertionError("(a): phase 3 leaves unserved %r"
                                 % unserved)
        cardi = PairRunner(fset_i, EngineConfig(precision="f32", ibsi=True,
                                                ram_limit_mb=1), "cuda")
        cardi.run(*ipair)
        (labsi, devi), wall, launches_i, peak, p3 = timed_run(
            kern, lambda: cardi.run(*ipair))
        log_run("(a) IBSI *ALL* on the pair at 256 raw levels, ram_limit=1",
                wall, launches_i, peak, p3)
        if not launches_i.get("ih_stats") or not launches_i.get(
                "batched_hist"):
            raise AssertionError("(a) IBSI: K1 or K17 not launched: %r"
                                 % launches_i)
        for what, c, (l64, ref), (l, d) in (
                ("(a) *ALL*", cols, refs["all"].result(), (labs, dev)),
                ("(a) IBSI *ALL*", cols_i, refs["ibsi"].result(),
                 (labsi, devi))):
            worst = check_output(what, c, l, d, l64, ref)
            log("  %s: %d ROIs x %d columns agree with the f64 CPU run of "
                "the same path; closest to its tier: %s; no column the "
                "trivial run serves is unserved"
                % (what, len(l), len(c), worst))
        rows = finish_stage_rows(kern, pair, ipair)
        for r in rows:
            log("  finish stage %-17s call %s ms, device %s (%s of K1/K17), "
                "bound %.6f ms by %s, library %s ms%s"
                % (r["name"], "%.4f" % r["ms"] if r["ms"] else "-",
                   "%.4f ms in %d launches and %d copies"
                   % (r["device_ms"], r["device_launches"],
                      r["device_copies"]) if r["device_ms"] is not None
                   else "not traced",
                   r["kernel_launches"], r["bound_ms"], r["bound_by"],
                   "%.4f" % r["library_ms"] if r["library_ms"] else "-",
                   "; equal to the CPU's on its %d members at rtol 1e-9 "
                   "(closest to it: %s)" % r["agree"] if r["agree"]
                   else ""))

        with tempfile.TemporaryDirectory(prefix="nyx_over_") as root:
            # (b)
            d7 = os.path.join(root, "s7")
            os.makedirs(d7)
            write_tiff(os.path.join(d7, "slide07.ome.tif"), slides[0][0],
                       tile_size=512)
            nyx = Nyxus(FEATURES_ALL, ram_limit=1, device="cuda")
            calls = {"run": 0, "run_streamed": 0}
            for meth in calls:
                count_calls(nyx._runner, meth, calls)
            ((_, _, lb, vb),), wall, launches, peak, p3 = timed_run(
                kern, lambda: list(nyx._iter_directory_raw(d7, d7, ".*")))
            log_run("(b) whole-slide *ALL* on corpus slide 7 at ram_limit=1, "
                    "tile-streamed (one 1025² box)", wall, launches, peak, p3)
            WS_STREAMED_3D[:] = [(lb, vb, wall)]
            keep = [j for j, c in enumerate(cols)
                    if c not in WS_OWN_DEFINITION + WS_SYMMETRIC_ZERO]
            cm = [j for j, c in enumerate(cols)
                  if c.startswith("CENTRAL_MOMENT_")]
            scale = max(np.abs(ws_row[cm]).max(), np.abs(vb[0, cm]).max())
            zeros = {c: (float(vb[0, cols.index(c)]),
                         float(ws_row[cols.index(c)]))
                     for c in WS_SYMMETRIC_ZERO}
            if max(abs(v) for p in zeros.values() for v in p) > 1e-6 * scale:
                raise AssertionError("(b): symmetric-zero central moments "
                                     "%r beyond 1e-6 of %g" % (zeros, scale))
            if calls != {"run": 0, "run_streamed": 1} or \
                    not launches.get("batched_hist"):
                raise AssertionError("(b): runner calls %s, launches %s"
                                     % (calls, launches))
            worst = check_output("(b)", [cols[j] for j in keep], lb,
                                 vb[:, keep], [1], ws_row[None, keep])
            log("  (b): the streamed oversized slide agrees with phase 3c's "
                "in-memory whole-slide row on %d columns within the tiers "
                "(the %d columns phase 3 defines otherwise left out); "
                "closest to its tier: %s; the box's symmetric-zero central "
                "moments (phase 3, trivial) %r, under 1e-6 of the largest "
                "central moment %g"
                % (len(keep), len(WS_OWN_DEFINITION), worst, zeros, scale))

            # (c)
            tall = np.ascontiguousarray(np.concatenate(
                [s[0] for s in slides] + [slides[0][0][:512]]))
            dt = os.path.join(root, "tall")
            os.makedirs(dt)
            write_tiff(os.path.join(dt, "tall.ome.tif"), tall, tile_size=512)
            nyx = Nyxus(FEATURES_ALL, device="cuda")
            ((_, _, lc, vc),), wall, launches, peak, p3 = timed_run(
                kern, lambda: list(nyx._iter_directory_raw(dt, dt, ".*")))
            log_run("(c) whole-slide *ALL* on the %d x %d slide at the "
                    "default budget (oversized by its height)" % tall.shape,
                    wall, launches, peak, p3)
            x = tall.astype(np.float64).ravel()
            want = {"MEAN": x.mean(), "MIN": x.min(), "MAX": x.max(),
                    "INTEGRATED_INTENSITY": x.sum(),
                    "ENERGY": (x * x).sum(), "MEDIAN": np.median(x),
                    "STANDARD_DEVIATION": x.std(ddof=1),
                    "VARIANCE": x.var(ddof=1), "RANGE": x.max() - x.min(),
                    "ROOT_MEAN_SQUARED": np.sqrt((x * x).mean())}
            got = {k: vc[0, cols.index(k)] for k in want}
            bad = {k: (got[k], v) for k, v in want.items()
                   if not np.isclose(got[k], v, rtol=1e-9, atol=0)}
            if list(lc) != [1] or bad or not launches.get("batched_hist"):
                raise AssertionError("(c): intensity against numpy %r, "
                                     "launches %s" % (bad, launches))
            log("  (c): %s equal numpy over the %d pixels within 1e-9"
                % ("/".join(want), x.size))

        # (d): ImageQuality's entry point, featurize with no label image
        # (the constant-1 label default), on the stack of the 8 slides
        iq = ImageQuality(device="cuda")
        stack = np.stack([s[0] for s in slides])
        iq.featurize(stack[:1])                           # untimed pass
        df, wall, launches, peak, _ = timed_run(
            kern, lambda: iq.featurize(stack))
        log_run("(d) ImageQuality.featurize (*ALL_IMQ*) on the stack of the "
                "8 corpus slides, no label image", wall, launches, peak, 0.0)
        icols = list(iq.header[4:])
        names = list(df[columns.COL_INTENSITY])
        if names != ["Intensity%d" % k for k in range(len(slides))]:
            raise AssertionError("(d): the frame's rows %r" % names)
        exact = True
        for k, f in enumerate(imq_refs):
            rows_k = df[columns.COL_INTENSITY] == "Intensity%d" % k
            l, v = frame_rows(iq, df[rows_k])
            l64, ref = f.result()
            if list(l) != [1]:
                raise AssertionError("(d) slide %d: labels %r" % (7 + k, l))
            check_output("(d) slide %d" % (7 + k), icols, l, v, l64, ref)
            exact &= np.array_equal(v, ref)
        log("  (d): the frame's 8 rows (label 1, the whole image) of %s "
            "agree with the f64 CPU featurize rows (%s)"
            % ("/".join(icols), "bit for bit" if exact else "within tiers"))
        iq1 = ImageQuality(ram_limit=1, precision="f64", device="cuda")
        df1, wall, launches, peak, p3 = timed_run(
            kern, lambda: iq1.featurize(slides[0][0]))
        l1, v1 = frame_rows(iq1, df1)
        log_run("(d) ImageQuality.featurize on slide 7 at ram_limit=1, f64 "
                "(streamed IMQ)", wall, launches, peak, p3)
        if not launches.get("batched_hist"):
            raise AssertionError("(d) streamed: K1 not launched %r"
                                 % launches)
        tol = {"SHARPNESS": 1e-6, "POWER_SPECTRUM_SLOPE": 1e-6}
        for j, c in enumerate(icols):
            if not np.isclose(v1[0, j], imq_refs[0].result()[1][0, j],
                              rtol=tol.get(c, 1e-9), atol=0):
                raise AssertionError("(d) streamed %s: %r vs %r" % (
                    c, v1[0, j], imq_refs[0].result()[1][0, j]))
        if list(l1) != [1]:
            raise AssertionError("(d) streamed: labels %r" % l1)
        log("  (d): the streamed IMQ row of slide 7 agrees with its "
            "in-memory f64 row (rtol 1e-9, sharpness and slope 1e-6)")
    log(json.dumps({"finish_stages": rows}))
    return rows


def count_calls(obj, meth, calls):
    """Wrap obj.meth so that each call adds one to calls[meth]."""
    fn = getattr(obj, meth)

    def counted(*args, **kw):
        calls[meth] += 1
        return fn(*args, **kw)
    setattr(obj, meth, counted)


def columns_of(runner):
    """The value columns' names of a PairRunner's request."""
    from nyxus_tpu_torch import columns
    return columns.build_header(runner.fset, runner.cfg)[0][4:]


# ---------------------------------------------------------------------------
# phase 3e: 3D beyond the default configuration

# the device phase 3e runs on (the card; a rehearsal on a machine without
# one sets "cpu")
DEVICE_3E = "cuda"
# the planes of throughput volume 1 that the f64 CPU references of the run
# modes see, the card running the same cut beside the whole volume: the
# CPU run of the whole volume's one ROI (whole-volume mode, mergerois)
# would outlast the smoke
MODE_CPU_DEPTH = 15
# run mode -> (EngineConfig keywords, whole-volume)
MODES_3D = {
    "anisotropy z 1.5": (dict(aniso_z=1.5), False),
    "anisotropy 1.4 x 1.2 x 1.5": (dict(aniso_x=float(np.float32(1.4)),
                                        aniso_y=float(np.float32(1.2)),
                                        aniso_z=1.5), False),
    "whole volume": ({}, True),
    "mergerois": (dict(mergerois=True), False),
}
# the RAM gate (MB) that puts volume 1's largest ROI, and it alone, over
# the batch budget: label 2, 54 x 37 x 59 voxels, a 64³ cube of 4 MB at 16
# bytes a voxel
OVERSIZED_3D_MB = 2
OVERSIZED_3D_LABEL = 2
# the RAM limit (MB) that puts volume 1's layout-A stack (96 x 320 x 320 at
# 16 bytes a voxel, 157 MB) over the gate (half the limit) while no ROI
# passes the batch budget
STACK_RAM_LIMIT_MB = 256
# the 3D finish stages, by what they replace in the JAX package
FINISH3D_REPLACES = {
    "D3_VoxelIntensityFeatures": "nyxus_tpu/pipeline/oversized3d.py:568",
    "D3_GLCM_feature": "nyxus_tpu/pipeline/oversized3d.py:588",
    "D3_GLRLM_feature": "nyxus_tpu/pipeline/oversized3d.py:599",
    "D3_GLSZM_feature": "nyxus_tpu/pipeline/oversized3d.py:612",
    "D3_GLDZM_feature": "nyxus_tpu/pipeline/oversized3d.py:623",
    "D3_GLDM_feature": "nyxus_tpu/pipeline/oversized3d.py:635",
    "D3_NGLDM_feature": "nyxus_tpu/pipeline/oversized3d.py:643",
    "D3_NGTDM_feature": "nyxus_tpu/pipeline/oversized3d.py:652"}
# the kernels phase 2 holds at the whole-volume crop
KERNELS_WHOLE_VOLUME = KERNELS_3D + ("zone_stats", "batched_hist")


# phase 3e's walls, kept to be printed again near the end of the output
WALLS_3E = []


def log_run3(what, wall, launches, peak):
    """Log a phase-3e run: host-clock wall (the card synchronised at its
    end, the f64 CPU reference processes running meanwhile in (c)), peak
    device memory, launches."""
    log("  %s: wall %.4f s, peak device memory %d bytes (%.1f MiB), "
        "launches %s" % (what, wall, peak, peak / 2 ** 20, launches))
    WALLS_3E.append("%s: %.4f s, %.1f MiB" % (what.split(",")[0], wall,
                                              peak / 2 ** 20))


def mode_volume(mode, depth=None):
    """Throughput volume 1 as a run mode reads it: its first ``depth``
    planes (all by default); in whole-volume mode every voxel labelled 1."""
    intens, labels = make_volume_3d(1)
    if depth:
        intens, labels = intens[:depth].copy(), labels[:depth].copy()
    if MODES_3D[mode][1]:
        labels = np.ones_like(labels)
    return intens, labels


def mode_ref_3d(mode):
    """Worker process: the f64 CPU run of *3D_ALL* under a run mode on the
    first MODE_CPU_DEPTH planes of volume 1: (labels, values)."""
    sys.path.insert(0, HERE)
    import torch
    torch.set_num_threads(2)
    from nyxus_tpu_torch import taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner
    kw, whole = MODES_3D[mode]
    fset = taxonomy.parse_feature_request(FEATURES_3D, dim=3)
    return VolumeRunner(fset, EngineConfig(precision="f64", **kw), "cpu").run(
        *mode_volume(mode, MODE_CPU_DEPTH), wholeslide=whole)


def trivial_ref_3d(ibsi):
    """Worker process: the f64 CPU run of volume 1 (at (volume >> 4) + 1 in
    IBSI mode) with every label but OVERSIZED_3D_LABEL zeroed, which keeps
    that ROI's values (the slide range and the raw levels' matrix size come
    from the intensities), at the default budget: (labels, values)."""
    sys.path.insert(0, HERE)
    import torch
    torch.set_num_threads(2)
    from nyxus_tpu_torch import taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner
    intens, labels = make_volume_3d(1)
    if ibsi:
        intens = ((intens >> 4) + 1).astype(np.uint16)
    labels = np.where(labels == OVERSIZED_3D_LABEL, labels, 0)
    fset = taxonomy.parse_feature_request(FEATURES_3D, dim=3, ibsi=ibsi)
    return VolumeRunner(fset, EngineConfig(precision="f64", ibsi=ibsi),
                        "cpu").run(intens, labels)


def rows_agree(what, cols, got, want):
    """Two card runs of the same volume through two entry points: labels
    equal and every column within its tier; returns (the column closest to
    its tier, the share of values equal bit for bit)."""
    (gl, gv), (wl, wv) = got, want
    if list(gl) != list(wl) or gv.shape != wv.shape:
        raise AssertionError("%s: labels or shape differ: %s vs %s"
                             % (what, gv.shape, wv.shape))
    bad, worst = compare_tiers(cols, gv, wv)
    if bad or not np.array_equal(np.isnan(gv), np.isnan(wv)):
        raise AssertionError("%s: beyond the tiers: %r" % (what, bad[:20]))
    same = np.isnan(gv) & np.isnan(wv) | (gv == wv)
    return worst, float(same.mean())


def check_3d_files(kern, vols, mem):
    """Phase 3e (a) and (b): the 3D file protocol on the card; returns
    (a)'s rows (labels, values) of both volumes.
    (a) the two throughput volumes written as vol1.nii and vol2.nii.gz
        through Nyxus3D.featurize_directory (pandas): the rows of the
        in-memory Nyxus3D.featurize of the same volumes (``mem``);
    (b) volume 1 as a 96-slice layout-A stack of TIFF slices, in memory and
        over the RAM gate (ram_limit=STACK_RAM_LIMIT_MB: 157 MB of stack
        against a 128 MB gate; read a plane at a time, VolumeRunner.run
        handed the stack's lazy channels): (a)'s rows of volume 1."""
    import tempfile

    from nyxus_tpu_torch import Nyxus3D
    from nyxus_tpu_torch.io import readers
    from nyxus_tpu_torch.pipeline import runner3d

    nyx = Nyxus3D(FEATURES_3D, DEVICE_3E, precision="f32")
    cols = list(nyx.header[4:])
    with tempfile.TemporaryDirectory() as root:
        for d in ("int", "seg"):
            os.makedirs(os.path.join(root, "nifti", d))
            os.makedirs(os.path.join(root, "stack", d))
        t0 = time.perf_counter()
        for k, ((intens, labels), ext) in enumerate(zip(vols, (".nii",
                                                               ".nii.gz"))):
            name = "vol%d%s" % (k + 1, ext)
            readers.write_nifti(os.path.join(root, "nifti", "int", name),
                                intens)
            readers.write_nifti(os.path.join(root, "nifti", "seg", name),
                                labels)
        intens, labels = vols[0]
        for z in range(intens.shape[0]):
            name = "vol1_z%03d.tif" % z
            readers.write_gray(os.path.join(root, "stack", "int", name),
                               intens[z])
            readers.write_gray(os.path.join(root, "stack", "seg", name),
                               labels[z].astype(np.uint16))
        log("  wrote the NIfTI pair files and the 2 x %d slice files in %.1f "
            "s" % (intens.shape[0], time.perf_counter() - t0))
        df, wall, launches, peak, _ = timed_run(
            kern, lambda: nyx.featurize_directory(
                os.path.join(root, "nifti", "int"),
                os.path.join(root, "nifti", "seg")))
        log_run3("(a) featurize_directory, vol1.nii and vol2.nii.gz",
                 wall, launches, peak)
        if not all(launches.get(k) for k in KERNELS_3D):
            raise AssertionError("(a): a kernel was not launched: %r"
                                 % launches)
        files = frame_rows(nyx, df)
        names = sorted(set(os.path.basename(p) for p in df.intensity_image))
        if names != ["vol1.nii", "vol2.nii.gz"]:
            raise AssertionError("(a): volumes %r" % names)
        worst, same = rows_agree("(a)", cols, files, mem)
        log("  (a) %d ROIs x %d columns equal the in-memory featurize rows "
            "within the tiers (%.4f of the values bit for bit); closest to "
            "its tier: %s" % (len(files[0]), len(cols), same, worst))
        n1 = int((df.intensity_image.map(os.path.basename)
                  == "vol1.nii").sum())
        vol1 = (files[0][:n1], files[1][:n1])
        runs = []
        run = runner3d.VolumeRunner.run

        def recording(self, i, lab, wholeslide=False):
            runs.append(type(i).__name__)
            return run(self, i, lab, wholeslide)
        runner3d.VolumeRunner.run = recording
        try:
            for what, kw, kind in (("in memory", {}, "ndarray"),
                                   ("over the RAM gate",
                                    {"ram_limit": STACK_RAM_LIMIT_MB},
                                    "_LazyVol")):
                runs.clear()
                stack = Nyxus3D(FEATURES_3D, DEVICE_3E, precision="f32", **kw)
                df, wall, launches, peak, _ = timed_run(
                    kern, lambda: stack.featurize_directory(
                        os.path.join(root, "stack", "int"),
                        os.path.join(root, "stack", "seg"),
                        file_pattern="vol1_z{set d+}.tif"))
                if runs != [kind]:
                    raise AssertionError("(b) %s: VolumeRunner.run got %r"
                                         % (what, runs))
                log_run3("(b) the layout-A stack %s" % what, wall, launches,
                         peak)
                worst, same = rows_agree("(b) %s" % what, cols,
                                         frame_rows(stack, df), vol1)
                log("  (b) %s: %d ROIs equal (a)'s volume 1 rows within the "
                    "tiers (%.4f bit for bit); closest to its tier: %s"
                    % (what, n1, same, worst))
        finally:
            runner3d.VolumeRunner.run = run
    return files


def check_3d_modes(kern, refs):
    """Phase 3e (c): *3D_ALL* under each run mode of MODES_3D on the card in
    f32: volume 1 whole (timed; its labels, shape and launches checked;
    in whole-volume mode once more under the profiler: card busy share,
    K13-K16 and K7 totals) and its first MODE_CPU_DEPTH planes against the f64 CPU run of the same
    planes (worker processes of ``pool``, started first), within the
    tiers, the surface columns bit for bit.  Returns the whole-volume
    mode's full-size row (labels, values)."""
    import torch

    from nyxus_tpu_torch import columns, taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner

    fset = taxonomy.parse_feature_request(FEATURES_3D, dim=3)
    hdr, slots = columns.build_header(fset, EngineConfig())
    cols = hdr[4:]
    surf = surface_columns(slots)
    whole_row = None
    for mode, (kw, whole) in MODES_3D.items():
        runner = VolumeRunner(fset, EngineConfig(precision="f32", **kw),
                              DEVICE_3E)
        vol = mode_volume(mode)
        (labs, vals), wall, launches, peak, _ = timed_run(
            kern, lambda: runner.run(*vol, wholeslide=whole))
        log_run3("(c) %s, volume 1 (96 x 320 x 320), %d ROIs"
                 % (mode, len(labs)), wall, launches, peak)
        if vals.shape != (len(labs), WIDTH_3D) or np.isinf(vals).any() \
                or not all(launches.get(k) for k in KERNELS_3D):
            raise AssertionError("(c) %s: shape %s, launches %r"
                                 % (mode, vals.shape, launches))
        if whole or kw.get("mergerois"):
            if list(labs) != [1]:
                raise AssertionError("(c) %s: labels %r" % (mode, labs))
        if whole:
            whole_row = (labs, vals)
            profile_report("(c) %s, volume 1 (one 128 x 512 x 512 bucket)"
                           % mode, lambda: runner.run(*vol, wholeslide=True),
                           totals=dict(KERNEL_NAMES_3D,
                                       **{"K7 zone_stats": "zone_stats"}))
        cut = runner.run(*mode_volume(mode, MODE_CPU_DEPTH), wholeslide=whole)
        labs64, ref = refs[mode].result()
        worst = check_output("(c) %s" % mode, cols, cut[0], cut[1], labs64,
                             ref)
        if not np.array_equal(cut[1][:, surf].view(np.uint64),
                              ref[:, surf].view(np.uint64)):
            raise AssertionError("(c) %s: the surface columns differ "
                                 "between the card and the CPU" % mode)
        log("  (c) %s, its first %d planes: %d ROIs x %d columns agree with "
            "the f64 CPU run, the %d surface columns bit for bit; closest to "
            "its tier: %s" % (mode, MODE_CPU_DEPTH, len(labs64), len(cols),
                              len(surf), worst))
    return whole_row


def finish3d_stage_rows(kern, vol):
    """The eight 3D finish stages on the card over the accumulators of
    volume 1's largest ROI (label 2) at the default configuration, and
    NGTDM's at the binned one (radius 1: the default's radius 0 leaves it
    no work): each one's call ms (CUDA events, the host's preparation and
    the device-to-host copy included), device ms, kernels and copies
    (profiler, the fullest of five traced calls), the wrappers' launches,
    and its bound; each held against the same stage on the CPU over the
    same accumulators on every member at rtol 1e-9 (both float64).  The
    bound counts the elements a stage uploads and the members it returns
    (8 bytes each), and ~50 float64 operations an uploaded element (60 for
    the intensity statistics' values), at F64_OPS_S."""
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.pipeline import oversized as ovs
    from nyxus_tpu_torch.pipeline import oversized3d as ov3
    from nyxus_tpu_torch.pipeline.runner3d import discover_rois_3d

    recs, smin, smax = discover_rois_3d(*vol)
    rec = next(r for r in recs if r.label == OVERSIZED_3D_LABEL)
    fams = set(ov3.FINISH3D)
    t0 = time.perf_counter()
    acc = ov3.accumulate3d(rec, *vol, EngineConfig(precision="f32"), fams,
                           smin, smax)
    acc_n = ov3.accumulate3d(rec, *vol, EngineConfig(precision="f32",
                                                     **BINNED_3D),
                             {"D3_NGTDM_feature"}, smin, smax)
    log("  the accumulators of label %d (%d voxels, %d x %d x %d) in %.2f s "
        "(host numpy)" % (rec.label, rec.area, rec.depth, rec.height,
                          rec.width, time.perf_counter() - t0))
    rows = []
    dev0 = ovs._dev
    for fam, finish in ov3.FINISH3D.items():
        a = acc_n if fam == "D3_NGTDM_feature" else acc
        seen = {"elems": 0}

        def dev(x, device, dtype=ovs.FINISH_DTYPE):
            seen["elems"] += np.asarray(x).size
            return dev0(x, device, dtype)
        ovs._dev = dev
        try:
            card = finish(a, DEVICE_3E)
        finally:
            ovs._dev = dev0
        agree = same_members(fam, card, finish(a, "cpu"))
        outs = len(flat_members(card)[0])
        ms = timed(lambda: finish(a, DEVICE_3E), iters=5)[0]
        dev_ms, n_dev, n_copies, kl = device_profile(
            kern, lambda: finish(a, DEVICE_3E))
        per = 60 if fam == "D3_VoxelIntensityFeatures" else 50
        nbytes, ops = (seen["elems"] + outs) * 8, per * seen["elems"]
        rows.append({"name": fam, "replaces": FINISH3D_REPLACES[fam],
                     "ms": ms, "device_ms": dev_ms, "device_launches": n_dev,
                     "device_copies": n_copies, "kernel_launches": kl,
                     "bound_ms": max(nbytes / HBM_BYTES_S,
                                     ops / F64_OPS_S) * 1e3,
                     "bound_by": "bytes" if nbytes / HBM_BYTES_S
                     >= ops / F64_OPS_S else "operations",
                     "library_ms": None, "agree": agree,
                     "uploaded": seen["elems"], "members": outs})
        log("  finish %s: call %.4f ms, device %s ms in %s kernels + %s "
            "copies, launches %s, %d elements up, %d members; card = CPU "
            "(closest %s)" % (fam, ms, dev_ms, n_dev, n_copies, kl,
                              seen["elems"], outs, agree))
    return rows


def check_oversized_3d(kern, vol, triv, refs):
    """Phase 3e (d): volume 1 at ram_limit=OVERSIZED_3D_MB, which puts its
    largest ROI (label 2) alone over the gate: its row through phase 3
    (the slice-streamed accumulators, the finish stages on the card in
    float64) against the f64 CPU trivial run of that ROI (``refs[ibsi]``,
    trivial_ref_3d) at tests/test_oversized.py's tolerance (rtol 1e-8,
    atol 1e-10 where both are finite, INFOMEAS at atol 1e-6), no column
    that the card's trivial row ``triv`` serves left unserved, the other
    ROIs' rows within the tiers of ``triv``'s; the same in IBSI mode on
    (volume >> 4) + 1 (256 raw levels) against the card's trivial IBSI
    run; then the finish stages timed (finish3d_stage_rows)."""
    import torch

    from nyxus_tpu_torch import columns, taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner

    ivol = (((vol[0] >> 4) + 1).astype(np.uint16), vol[1])
    for what, ibsi, v in (("*3D_ALL*", False, vol),
                          ("IBSI *3D_ALL*", True, ivol)):
        fset = taxonomy.parse_feature_request(FEATURES_3D, dim=3, ibsi=ibsi)
        cols = columns.build_header(fset, EngineConfig(ibsi=ibsi))[0][4:]
        over = VolumeRunner(fset, EngineConfig(
            precision="f32", ibsi=ibsi, ram_limit_mb=OVERSIZED_3D_MB),
            DEVICE_3E)
        p3 = []
        phase3 = over._oversized

        def timed_phase3(*a):
            t = time.perf_counter()
            phase3(*a)
            if DEVICE_3E != "cpu":
                torch.cuda.synchronize()
            p3.append(time.perf_counter() - t)
        over._oversized = timed_phase3
        (labs, dev), wall, launches, peak, _ = timed_run(
            kern, lambda: over.run(*v))
        log("  (d) %s: phase 3 (label %d's accumulators and finish stages) "
            "%.4f s of the run's %.4f s" % (what, OVERSIZED_3D_LABEL,
                                             sum(p3), wall))
        log_run3("(d) %s on volume 1 at ram_limit=%d (label %d oversized)"
                 % (what, OVERSIZED_3D_MB, OVERSIZED_3D_LABEL), wall,
                 launches, peak)
        if ibsi:
            tl, tv = VolumeRunner(fset, EngineConfig(precision="f32",
                                                     ibsi=True),
                                  DEVICE_3E).run(*v)
        else:
            tl, tv = triv
        if list(labs) != list(tl):
            raise AssertionError("(d) %s: labels differ" % what)
        k = list(labs).index(OVERSIZED_3D_LABEL)
        unserved = unserved_columns(cols, dev[k], tv[k])
        if unserved:
            raise AssertionError("(d) %s: phase 3 leaves unserved %r"
                                 % (what, unserved))
        rl, rv = refs[ibsi].result()
        if list(rl) != [OVERSIZED_3D_LABEL]:
            raise AssertionError("(d) %s: the reference's labels %r"
                                 % (what, rl))
        worst = (0.0, None)
        for j, col in enumerate(cols):
            a, b = dev[k, j], rv[0, j]
            if not (np.isfinite(a) and np.isfinite(b)):
                continue
            atol = 1e-6 if "INFOMEAS" in col else 1e-10
            r = abs(a - b) / (atol + 1e-8 * abs(b))
            if r > worst[0]:
                worst = (r, col)
            if r > 1.0:
                raise AssertionError(
                    "(d) %s: %s through phase 3 on the card %r, the f64 CPU "
                    "trivial run %r" % (what, col, a, b))
        others = [j for j in range(len(labs)) if j != k]
        bad, _ = compare_tiers(cols, dev[others], tv[others])
        if bad:
            raise AssertionError("(d) %s: the trivial rows differ: %r"
                                 % (what, bad[:10]))
        log("  (d) %s: label %d's %d columns through phase 3 equal the f64 "
            "CPU trivial run at rtol 1e-8 (closest: %s at %.3g of it), none "
            "unserved" % (what, OVERSIZED_3D_LABEL, len(cols), worst[1],
                          worst[0]))
    return finish3d_stage_rows(kern, vol)


def whole_volume_cube(vol):
    """Volume 1 as whole-volume mode's one ROI: the 97 x 321 x 321 one-past
    box in a 128 x 512 x 512 bucket, every voxel of the volume in the ROI,
    in synth_cube's form (masked intensities, levels at 64, raw levels,
    the AABB mask, depths, heights, widths) on the card in float32."""
    import torch
    from nyxus_tpu_torch.ops import quant, texture3d
    from nyxus_tpu_torch.pipeline import batching
    D, H, W = vol[0].shape
    shape = tuple(batching.pad_dim(n + 1) for n in (D, H, W))
    orig = torch.zeros((1,) + shape, dtype=torch.float32, device=DEVICE_3E)
    orig[0, :D, :H, :W] = torch.from_numpy(vol[0].astype(np.float32))
    vmax = orig.reshape(1, -1).amax(dim=1).clamp(min=1)[:, None, None, None]
    lev = quant.bin_levels(orig, vmax, vmax, 64)
    dd, hh, ww = (torch.tensor([n + 1], dtype=torch.int32, device=DEVICE_3E)
                  for n in (D, H, W))
    aabb = texture3d._in_aabb3d(shape, dd, hh, ww)
    return orig, lev, orig.to(torch.int32), aabb, dd, hh, ww


def kernels_whole_volume(vol):
    """Phase 3e (e): K13-K16, K7 (on every plan forced) and K1 against their
    plain versions at the whole-volume crop (kernels_3d_agree, f32), then
    each timed there as the 3D families call it; returns ({kernel: the
    largest |kernel - plain|}, {kernel: (device ms, events ms, launches a
    call)})."""
    import torch
    from nyxus_tpu_torch.ops import common, texture3d as t3, zones
    err = {k: 0.0 for k in KERNELS_WHOLE_VOLUME}

    def agree(name, got, want, scale=None):
        if got.shape != want.shape:
            raise AssertionError("(e) %s: shape %s != %s"
                                 % (name, got.shape, want.shape))
        diff = (got.double() - want.double()).abs()
        e = float(diff.max()) if got.numel() else 0.0
        err[name] = max(err[name], e)
        if scale is None:
            if not torch.equal(got, want):
                raise AssertionError("(e) %s: differs from its plain "
                                     "version (max abs %g)" % (name, e))
        elif not bool((diff <= scale).all()):
            raise AssertionError("(e) %s: beyond its bound (max abs %g)"
                                 % (name, e))

    cube = whole_volume_cube(vol)
    t0 = time.perf_counter()
    kernels_3d_agree(agree, cube, torch.float32, 1e-6)
    log("  (e) K13-K16, K7 on every plan and K1 agree with their plain "
        "versions at the whole-volume crop 1 x %d x %d x %d (box %d x %d x "
        "%d) in %.1f s; max |kernel - plain| %s"
        % (tuple(cube[0].shape[1:])
           + tuple(int(x) for x in (cube[4][0], cube[5][0], cube[6][0]))
           + (time.perf_counter() - t0, err)))
    orig, lev, raw, aabb, dd, hh, ww = cube
    nr = max(lev.shape[1:])
    rvalid = aabb & (raw > 0)
    sv = aabb & (raw != 0)
    slev = torch.where(sv, raw, -1)
    dlev = torch.where(aabb, lev, 0)
    glev = torch.where(aabb, raw, -9)
    f32 = torch.float32
    anc, _ = t3.cc3d(slev, sv, 26)
    same = t3.stencil3d(glev, aabb, t3.N26)
    cells = common._composite((raw - 1).reshape(1, -1), same.reshape(1, -1),
                              RAW_NG, 27)
    ones = aabb.reshape(1, -1).to(f32)
    calls = {
        "glcm3d_cooc": lambda: t3.glcm3d_cooc(lev, dd, hh, ww, 1, 64, False,
                                              False, f32),
        "glrlm3d_runs": lambda: t3.glrlm3d_runs(raw, rvalid, RAW_NG, nr,
                                                f32),
        "cc3d": lambda: t3.cc3d(slev, sv, 26),
        "cc3d 6 + distances": lambda: t3.cc3d(dlev, aabb, 6, hh, ww),
        "stencil3d": lambda: t3.stencil3d(glev, aabb, t3.N26),
        "zone_stats": lambda: zones.zone_list(anc, raw, sv),
        "batched_hist": lambda: common.batched_hist(cells, ones,
                                                    RAW_NG * 27),
    }
    times = {}
    for name, fn in calls.items():
        ev, ms, n = timed(fn, iters=3)
        times[name] = (ms, ev, n)
        log("  (e) time %-18s at the whole-volume crop: device %.4f ms "
            "(events %.4f ms, %s device launches a call)" % (name, ms, ev, n))
    return err, times


def check_3d_beyond(kern, vols, runner_3d):
    """Phase 3e: (a) and (b) check_3d_files, (c) check_3d_modes, (d)
    check_oversized_3d (the f64 CPU references of (c) and (d) in four
    worker processes meanwhile), (e) kernels_whole_volume.  Returns (the finish
    stages' rows, phase 2's errors and times at the whole-volume crop,
    (a)'s NIfTI rows)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from nyxus_tpu_torch import Nyxus3D

    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            4, mp_context=multiprocessing.get_context("spawn")) as pool:
        refs = {m: pool.submit(mode_ref_3d, m) for m in MODES_3D}
        trefs = {ibsi: pool.submit(trivial_ref_3d, ibsi)
                 for ibsi in (False, True)}
        log_phase("phase 3e (a), (b): the NIfTI and layout-A file protocol")
        nyx = Nyxus3D(FEATURES_3D, DEVICE_3E, precision="f32")
        mem = frame_rows(nyx, nyx.featurize([v[0] for v in vols],
                                            [v[1] for v in vols]))
        nifti_rows = check_3d_files(kern, vols, mem)
        log_phase("phase 3e (c): the run modes, volume 1 whole on the card "
                  "and its first %d planes against the f64 CPU"
                  % MODE_CPU_DEPTH)
        check_3d_modes(kern, refs)
        log_phase("phase 3e (d): volume 1's largest ROI through phase 3")
        triv = runner_3d.run(*vols[0])
        rows = check_oversized_3d(kern, vols[0], triv, trefs)
    log_phase("phase 3e (e): K13-K16, K7 and K1 at the whole-volume crop")
    whole = kernels_whole_volume(vols[0])
    log("  phase 3e took %.1f s" % (time.perf_counter() - t0))
    return rows, whole, nifti_rows


# ---------------------------------------------------------------------------
# phase 3f: OME-Zarr and DICOM

# phase 3b's figures of the 1024² TIFF pair (decode s, walls), printed beside
# phase 3f's
TIFF_3B = {}
# phase 3d (b)'s whole-slide run of corpus slide 7 tile-streamed from a TIFF:
# [(labels, values, wall s)], held against the same slide streamed from Zarr
WS_STREAMED_3D = []
# phase 3f's walls, kept to be printed again near the end of the output
WALLS_3F = []
# the device phase 3f runs on (the card; a rehearsal on a machine without
# one sets "cpu")
DEVICE_3F = "cuda"
# a 1024² slide's chunks (OME-Zarr v2, phase 3f (a)) and its v3 inner chunks
# and shards, 5D TCZYX
ZARR_CHUNKS = (1, 1, 1, 512, 512)
ZARR_V3_CHUNKS = (1, 1, 1, 256, 256)
ZARR_V3_SHARDS = (1, 1, 1, 512, 512)
# DICOM transfer syntaxes phase 3f writes encapsulated
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEGLS_LOSSLESS = "1.2.840.10008.1.2.4.80"
# the signed copy's stored values are the intensities less this, so that
# they fit int16; with the intercept -1024 its Hounsfield units are the
# intensities less 32768
HU_STORED_SHIFT = 31744


def write_zarr_v3_blosc_shards(path, arr, chunks, shards):
    """``arr`` as an OME-Zarr 0.5 container (zarr v3) in sharding_indexed
    shards of ``shards`` elements whose inner chunks of ``chunks`` are
    byte-shuffled blosc-LZ4 containers: write_zarr_v3's layout (which codes
    inner chunks with gzip or not at all), each inner chunk then coded by
    native.blosc_compress_lz4 and the codec named in zarr.json."""
    import json

    from nyxus_tpu_torch import native
    from nyxus_tpu_torch.io.zarr import write_zarr_v3
    write_zarr_v3(path, arr, chunks=chunks, codec=None, shards=shards)
    ds = os.path.join(path, "0")
    with open(os.path.join(ds, "zarr.json")) as f:
        meta = json.load(f)
    size = np.dtype(arr.dtype).itemsize
    meta["codecs"][0]["configuration"]["codecs"].append(
        {"name": "blosc", "configuration": {
            "cname": "lz4", "clevel": 5, "shuffle": "shuffle",
            "typesize": size, "blocksize": 0}})
    with open(os.path.join(ds, "zarr.json"), "w") as f:
        json.dump(meta, f)
    n_inner = int(np.prod([s // c for s, c in zip(shards, chunks)]))
    for d, _, files in os.walk(os.path.join(ds, "c")):
        for name in files:
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                raw = f.read()
            body, table, off = [], [], 0
            for o, nb in np.frombuffer(raw[len(raw) - 16 * n_inner:],
                                       "<u8").reshape(-1, 2):
                if o == 0xFFFFFFFFFFFFFFFF:
                    table.append((o, 0))
                    continue
                blk = native.blosc_compress_lz4(raw[int(o):int(o) + int(nb)],
                                                size, shuffle=True)
                body.append(blk)
                table.append((off, len(blk)))
                off += len(blk)
            with open(p, "wb") as f:
                f.write(b"".join(body) + np.asarray(table, "<u8").tobytes())


def dicom_encapsulated(ts, frag, rows, cols, bits, signed=0):
    """A minimal single-frame DICOM (explicit VR little endian) whose
    PixelData is one encapsulated fragment in transfer syntax ``ts``
    (tests/test_formats.py _encapsulate, copied: the script cannot import
    the tests; pinned equal by tests/test_torch_dicom_jax.py)."""
    import struct

    from nyxus_tpu_torch.io.dicom import _el
    body = _el(0x0002, 0x0010, b"UI", ts.encode())
    body += _el(0x0028, 0x0002, b"US", struct.pack("<H", 1))
    body += _el(0x0028, 0x0004, b"CS", b"MONOCHROME2 ")
    body += _el(0x0028, 0x0010, b"US", struct.pack("<H", rows))
    body += _el(0x0028, 0x0011, b"US", struct.pack("<H", cols))
    body += _el(0x0028, 0x0100, b"US", struct.pack("<H", bits))
    body += _el(0x0028, 0x0103, b"US", struct.pack("<H", signed))
    if len(frag) % 2:
        frag += b"\x00"
    # (7FE0,0010) OB undefined length + empty BOT + one fragment + delimiter
    body += struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF)
    body += struct.pack("<HHI", 0xFFFE, 0xE000, 0)
    body += struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag
    body += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    return b"\x00" * 128 + b"DICM" + body


def rle_frame(img):
    """One DICOM RLE Lossless frame of ``img`` in literal runs (valid,
    uncompressed PackBits), a segment a byte plane, most significant first
    (tests/test_formats.py _rle_encode, copied; pinned equal by
    tests/test_torch_dicom_jax.py)."""
    import struct
    nbytes = img.dtype.itemsize
    planes = []
    flat = img.reshape(-1)
    for b in range(nbytes):          # MSB first
        shift = 8 * (nbytes - 1 - b)
        planes.append(((flat >> shift) & 0xFF).astype(np.uint8).tobytes())
    segs = []
    for plane in planes:
        out = bytearray()
        for i in range(0, len(plane), 128):
            chunk = plane[i:i + 128]
            out.append(len(chunk) - 1)
            out += chunk
        if len(out) % 2:
            out.append(0)
        segs.append(bytes(out))
    hdr = [len(segs)]
    off = 64
    for s in segs:
        hdr.append(off)
        off += len(s)
    hdr += [0] * (16 - len(hdr))
    return struct.pack("<16I", *hdr) + b"".join(segs)


def write_format_pairs(root, intens, labels):
    """Slide ``intens`` / ``labels`` in each format of phase 3f (b) under
    ``root``: {name: (intensity path, mask path, streams at ram_limit=1)}.
    The signed copy (int16, intercept -1024) stores the intensities less
    HU_STORED_SHIFT; JPEG-LS is written only where CharLS loads."""
    from nyxus_tpu_torch.io import dicom, jpegls
    from nyxus_tpu_torch.io.zarr import write_zarr_v3

    def path(name, kind, ext):
        return os.path.join(root, "%s_%s%s" % (name, kind, ext))

    out = {}
    lab16 = labels.astype(np.uint16)
    for name, writer in (
            ("zarr v3 gzip", lambda p, a: write_zarr_v3(
                p, a, chunks=ZARR_V3_CHUNKS)),
            ("zarr v3 blosc shards", lambda p, a: write_zarr_v3_blosc_shards(
                p, a, ZARR_V3_CHUNKS, ZARR_V3_SHARDS))):
        ip, lp = (path(name.replace(" ", "_"), k, ".zarr")
                  for k in ("int", "seg"))
        writer(ip, intens)
        writer(lp, lab16)
        out[name] = (ip, lp, True)
    ip, lp = path("dicom", "int", ".dcm"), path("dicom", "seg", ".dcm")
    dicom.write_dicom_gray(ip, intens)
    dicom.write_dicom_gray(lp, lab16)
    out["dicom single-frame"] = (ip, lp, False)
    ip = path("rle", "int", ".dcm")
    with open(ip, "wb") as f:
        f.write(dicom_encapsulated(RLE_LOSSLESS, rle_frame(intens),
                                   *intens.shape, 16))
    out["dicom RLE"] = (ip, lp, False)
    ip, tp = path("tiled", "int", ".dcm"), path("tiled", "seg", ".dcm")
    dicom.write_dicom_tiled(ip, intens, tile=256)
    dicom.write_dicom_tiled(tp, lab16, tile=256)
    out["dicom tiled 256²"] = (ip, tp, True)
    ip = path("signed", "int", ".dcm")
    dicom.write_dicom_gray(
        ip, (intens.astype(np.int32) - HU_STORED_SHIFT).astype(np.int16),
        intercept=-1024.0)
    out["dicom signed HU"] = (ip, lp, False)
    if jpegls.available():
        ip = path("jpegls", "int", ".dcm")
        with open(ip, "wb") as f:
            f.write(dicom_encapsulated(JPEGLS_LOSSLESS,
                                       jpegls.encode(intens, bits=16),
                                       *intens.shape, 16))
        out["dicom JPEG-LS"] = (ip, lp, False)
    return out


def check_formats(kern, slides, vols, nifti_rows):
    """Phase 3f: OME-Zarr and DICOM through the entry points on the card.
    (a) the 8 corpus slides written as OME-Zarr v2 (blosc-LZ4 with byte
        shuffle, 512² chunks) by the port's write_zarr and read back bit for
        bit, then *ALL* through Nyxus.featurize_files in memory: each pair's
        labels equal to PairRunner.run's on the decoded arrays on the card
        and its values within the f32 tiers, K1-K12 launched; the decode s a
        slide and the wall of the 8 pairs beside phase 3b's TIFF figures;
    (b) slide 7's pair in every other format (write_format_pairs), each in
        memory and at ram_limit=1: the Zarr and tiled pairs through
        run_streamed, the single-frame files through run; each within the
        tiers of (a)'s rows of slide 7 (the signed copy: of PairRunner.run's
        on its Hounsfield units shifted to start at 0, the map of
        Nyxus._prep_intensity), K1-K12 launched by each; then slide 7
        whole-slide (no mask) from its (a) Zarr file at ram_limit=1,
        tile-streamed, against phase 3d (b)'s run of the same slide from a
        TIFF;
    (c) the two throughput volumes as OME-Zarr v2 through
        Nyxus3D.featurize_files: phase 3e (a)'s NIfTI rows within the
        tiers, K13-K16 launched."""
    import tempfile

    from nyxus_tpu_torch import Nyxus, Nyxus3D, columns, taxonomy
    from nyxus_tpu_torch.api import _force_finite
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.io import jpegls, readers
    from nyxus_tpu_torch.io.zarr import write_zarr
    from nyxus_tpu_torch.pipeline.runner import PairRunner

    t_phase = time.perf_counter()
    fset = taxonomy.parse_feature_request(FEATURES_ALL)
    cols = list(columns.build_header(fset, EngineConfig())[0][4:])
    card = PairRunner(fset, EngineConfig(precision="f32"), DEVICE_3F)

    def featurize(nyx, ips, lps, single_roi=False):
        """featurize_files timed (timed_run) with its runner's run and
        run_streamed calls counted: (rows of each pair, wall, launches,
        calls)."""
        calls = {"run": 0, "run_streamed": 0}
        for meth in calls:
            count_calls(nyx._runner, meth, calls)
        df, wall, launches, _, _ = timed_run(
            kern, lambda: nyx.featurize_files(ips, lps, single_roi))
        labs, vals = frame_rows(nyx, df)
        rows = [(labs[m], vals[m]) for m in
                (df.intensity_image.to_numpy() == ip for ip in ips)]
        return rows, wall, launches, calls

    with tempfile.TemporaryDirectory(prefix="nyx_formats_") as root:
        # (a)
        ips = [os.path.join(root, "slide%02d.zarr" % (k + 7))
               for k in range(len(slides))]
        lps = [os.path.join(root, "mask%02d.zarr" % (k + 7))
               for k in range(len(slides))]
        t0 = time.perf_counter()
        for (intens, labels), ip, lp in zip(slides, ips, lps):
            write_zarr(ip, intens, chunks=ZARR_CHUNKS, compressor="blosc")
            write_zarr(lp, labels.astype(np.uint16), chunks=ZARR_CHUNKS,
                       compressor="blosc")
        wrote = time.perf_counter() - t0
        decode = []
        for (intens, labels), ip, lp in zip(slides, ips, lps):
            t0 = time.perf_counter()
            ri = readers.read_gray(ip)
            decode.append(time.perf_counter() - t0)
            rl = readers.read_gray(lp)
            if not (ri.dtype == np.uint16 and np.array_equal(ri, intens)
                    and np.array_equal(rl, labels)):
                raise AssertionError("(a) %s: read_gray differs from what "
                                     "was written" % ip)
        want = []
        for intens, labels in slides:
            labs, vals = card.run(intens, labels)
            want.append((labs, _force_finite(vals, card.cfg.noval)))
        rows, wall, launches, calls = featurize(
            Nyxus(FEATURES_ALL, DEVICE_3F), ips, lps)
        if calls != {"run": len(slides), "run_streamed": 0} or \
                not all(launches.get(k) for k in KERNELS_2D):
            raise AssertionError("(a): runner calls %s, launches %s"
                                 % (calls, launches))
        worst = []
        for k, (got, w) in enumerate(zip(rows, want)):
            worst.append(rows_agree("(a) slide %d" % (k + 7), cols, got, w))
        n_rois = sum(len(w[0]) for w in want)
        tiff_decode = "%.4f s" % TIFF_3B["decode_s"] \
            if "decode_s" in TIFF_3B else "not measured"
        tiff_wall = "%.4f s" % TIFF_3B["walls"]["file path in memory"] \
            if "walls" in TIFF_3B else "not measured"
        log("  (a) %d OME-Zarr v2 pairs (blosc-LZ4 + shuffle, 512² chunks) "
            "written in %.3f s and read back bit for bit; decode s a slide "
            "%s (mean %.4f; phase 3b's tiled-LZW TIFF pair: %s)"
            % (len(slides), wrote, ["%.4f" % t for t in decode],
               float(np.mean(decode)), tiff_decode))
        log("  (a) featurize_files in memory: %d pairs, %d ROIs in %.4f s "
            "(%.4f s a pair; phase 3b's TIFF pair through the file path in "
            "memory: %s); launches %s; labels equal to PairRunner.run's "
            "on the decoded arrays, (closest to its tier, share bit-equal) "
            "%s" % (len(slides), n_rois, wall, wall / len(slides), tiff_wall,
                    launches, worst))
        WALLS_3F.append("(a) %d Zarr pairs %.4f s" % (len(slides), wall))

        # (b)
        intens, labels = slides[0]
        t0 = time.perf_counter()
        pairs = write_format_pairs(root, intens, labels)
        log("  (b) slide 7 written in %d more formats in %.3f s; CharLS "
            "(JPEG-LS) %s" % (len(pairs), time.perf_counter() - t0,
                              "loads" if jpegls.available() else
                              "does not load: JPEG-LS left out"))
        hu = intens.astype(np.int32) - HU_STORED_SHIFT - 1024
        labs, vals = card.run((hu - hu.min()).astype(np.uint32), labels)
        want_hu = (labs, _force_finite(vals, card.cfg.noval))
        for name, (ip, lp, streams) in pairs.items():
            t0 = time.perf_counter()
            ri = readers.read_gray(ip)
            dt = time.perf_counter() - t0
            signed = name == "dicom signed HU"
            if not np.array_equal(ri, hu if signed else intens):
                raise AssertionError("(b) %s: read_gray differs from what "
                                     "was written" % name)
            for what, kw in (("in memory", {}), ("ram_limit=1",
                                                {"ram_limit": 1})):
                (got,), wall, launches, calls = featurize(
                    Nyxus(FEATURES_ALL, DEVICE_3F, **kw), [ip], [lp])
                streamed = streams and bool(kw)
                if calls != {"run": int(not streamed),
                             "run_streamed": int(streamed)} or \
                        not all(launches.get(k) for k in KERNELS_2D):
                    raise AssertionError("(b) %s %s: runner calls %s, "
                                         "launches %s" % (name, what, calls,
                                                          launches))
                w, same = rows_agree("(b) %s %s" % (name, what), cols, got,
                                     want_hu if signed else want[0])
                log("  (b) %s %s: decode %.4f s, wall %.4f s through %s; "
                    "rows within the tiers of %s (%.4f bit for bit), closest "
                    "to its tier %s" % (
                        name, what, dt, wall,
                        "run_streamed" if streamed else "run",
                        "PairRunner.run on the shifted Hounsfield units"
                        if signed else "(a)'s slide 7", same, w))
                WALLS_3F.append("(b) %s %s %.4f s" % (name, what, wall))
        if WS_STREAMED_3D:
            ws_labs, ws_vals, ws_wall = WS_STREAMED_3D[0]
            (got,), wall, launches, calls = featurize(
                Nyxus(FEATURES_ALL, DEVICE_3F, ram_limit=1), ips[:1], None,
                single_roi=True)
            if calls != {"run": 0, "run_streamed": 1}:
                raise AssertionError("(b) whole-slide Zarr: runner calls %s"
                                     % calls)
            w, same = rows_agree("(b) whole-slide Zarr", cols, got,
                                 (ws_labs, ws_vals))
            log("  (b) whole-slide slide 7 from Zarr at ram_limit=1, "
                "tile-streamed: wall %.4f s (phase 3d (b) from a TIFF "
                "%.4f s), launches %s; its row within the tiers of phase 3d "
                "(b)'s (%.4f bit for bit), closest to its tier %s"
                % (wall, ws_wall, launches, same, w))
            WALLS_3F.append("(b) whole-slide Zarr streamed %.4f s" % wall)

        # (c)
        vips, vlps = [], []
        t0 = time.perf_counter()
        for k, (vi, vl) in enumerate(vols):
            vips.append(os.path.join(root, "vol%d.zarr" % (k + 1)))
            vlps.append(os.path.join(root, "vol%d_mask.zarr" % (k + 1)))
            write_zarr(vips[-1], vi, compressor="blosc")
            write_zarr(vlps[-1], vl, compressor="blosc")
        wrote = time.perf_counter() - t0
        nyx3 = Nyxus3D(FEATURES_3D, DEVICE_3F, precision="f32")
        cols3 = list(nyx3.header[4:])
        calls = {"run": 0}
        count_calls(nyx3._runner, "run", calls)
        df, wall, launches, _, _ = timed_run(
            kern, lambda: nyx3.featurize_files(vips, vlps))
        if calls != {"run": 2} or \
                not all(launches.get(k) for k in KERNELS_3D):
            raise AssertionError("(c): runner calls %s, launches %s"
                                 % (calls, launches))
        if list(df.intensity_image) != sorted(df.intensity_image):
            raise AssertionError("(c): volumes out of order")
        w, same = rows_agree("(c)", cols3, frame_rows(nyx3, df), nifti_rows)
        log("  (c) the 2 volumes as OME-Zarr v2 (blosc, 256² chunks) "
            "written in %.3f s; Nyxus3D.featurize_files %.4f s, launches "
            "%s; %d ROIs x %d columns within the tiers of phase 3e (a)'s "
            "NIfTI rows (%.4f bit for bit), closest to its tier %s"
            % (wrote, wall, launches, len(df), len(cols3), same, w))
        WALLS_3F.append("(c) 2 Zarr volumes %.4f s" % wall)
    log("  phase 3f took %.1f s; card %s" % (time.perf_counter() - t_phase,
                                             card_line()))


# ---------------------------------------------------------------------------
# phase 3g: ROI buckets sharded over devices, slides over processes, and the
# native discovery


# phase 3g's walls, kept to be printed again near the end of the output
WALLS_3G = []

_SHARD_WORKER = r"""
import os, pickle, sys, time
sys.path.insert(0, %(root)r)
import torch
from nyxus_tpu_torch import Nyxus
from nyxus_tpu_torch.parallel import initialize_distributed
initialize_distributed(coordinator_address=%(coord)r, num_processes=2,
                       process_id=%(pid)d)
import torch.distributed as dist
assert dist.get_rank() == %(pid)d and dist.get_world_size() == 2
t0 = time.perf_counter()
df = Nyxus(%(feats)r, shard_slides=True).featurize_directory(%(intdir)r,
                                                            %(segdir)r)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
with open(%(out)r, "wb") as f:
    pickle.dump((df, wall), f)
assert not [m for m in sys.modules
            if m in ("jax", "nyxus_tpu") or m.startswith("nyxus_tpu.")]
dist.destroy_process_group()
"""


def timed_pass(kern, runner, items):
    """One timed pass of ``runner.run`` over ``items`` (a warm-up already
    made): (outputs, host-clock wall to a synchronised card, launches)."""
    import torch
    torch.cuda.synchronize()
    for f in kern.values():
        f.launches = 0
    t0 = time.perf_counter()
    outs = [runner.run(*item) for item in items]
    torch.cuda.synchronize()
    return (outs, time.perf_counter() - t0,
            {k: f.launches for k, f in kern.items()})


def check_shards(kern, card_runner, slides, runner_3d, vols):
    """Phase 3g: the ROI axis sharded over devices and the slide list over
    processes, on the card's machine, and the native discovery.
    (a) the 8 corpus slides at *ALL* through PairRunner(devices=[cuda:0,
        cuda:0]) (each bucket in two shards on the one card) against the
        one-device rows of card_runner, one timed pass each: the EXACT
        columns and the pre-collect host columns bit for bit, the rest
        within the tiers; both walls and the launches printed; every 2D
        kernel launched by the sharded pass
    (b) volume 1 at *3D_ALL* the same way through VolumeRunner
    (c) Nyxus(n_devices=-1): the card count it resolves; n_devices=2 raises
        ValueError on one card, and where there are two, a real two-card
        pass over (a)'s slides held the same way
    (d) two processes, both on cuda:0, joined by initialize_distributed
        over tcp://localhost, each featurize_directory(shard_slides=True)
        over four corpus slides: every pair in exactly one shard, the union
        within the tiers of the one-process run
    (e) the native discovery on the 8 slides: the records of the numpy
        pass, ms a slide beside the numpy pass's"""
    import pickle
    import socket
    import tempfile
    import torch
    from nyxus_tpu_torch import Nyxus, columns, taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.pipeline import labels as plabels
    from nyxus_tpu_torch.pipeline.runner import PairRunner
    from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner
    t_phase = time.perf_counter()
    two = [torch.device("cuda", 0)] * 2
    fset = card_runner.fset
    hdr, slots = columns.build_header(fset, EngineConfig())
    cols = hdr[4:]

    # (a)
    sharded = PairRunner(fset, card_runner.cfg, devices=two)
    sharded.run(*slides[0])                               # warm-up
    ones, wall1, l1 = timed_pass(kern, card_runner, slides)
    twos, wall2, l2 = timed_pass(kern, sharded, slides)
    fixed = np.concatenate([pre_host_columns(sharded, slots),
                            [j for j, c in enumerate(cols) if c in EXACT]])
    worst, shares = None, []
    for k, ((la, va), (lb, vb)) in enumerate(zip(twos, ones)):
        if not np.array_equal(va[:, fixed].view(np.uint64),
                              vb[:, fixed].view(np.uint64)):
            raise AssertionError("3g (a) slide %d: the integer or host "
                                 "columns differ between the shards and "
                                 "one device" % k)
        worst, share = rows_agree("3g (a) slide %d" % k, cols, (la, va),
                                  (lb, vb))
        shares.append(share)
    if not all(l2[k] for k in KERNELS_2D):
        raise AssertionError("3g (a): a kernel was not launched by the "
                             "sharded pass: %r" % l2)
    n_rois = sum(len(la) for la, _ in ones)
    log("  (a) *ALL* on the 8 slides (%d ROIs): one device %.4f s, two "
        "shards on cuda:0 %.4f s; %d columns bit for bit (EXACT and the "
        "pre-collect host columns), the rest within the tiers (%.4f-%.4f "
        "of values bit for bit; closest to its tier %s); launches one "
        "device %s; two shards %s"
        % (n_rois, wall1, wall2, len(fixed), min(shares), max(shares),
           worst, l1, l2))
    WALLS_3G.append("(a) 8 slides one device %.4f s, two shards %.4f s"
                    % (wall1, wall2))

    # (b)
    fset3 = taxonomy.parse_feature_request(FEATURES_3D, dim=3)
    hdr3, _ = columns.build_header(fset3, EngineConfig())
    sharded3 = VolumeRunner(fset3, runner_3d.cfg, devices=two)
    sharded3.run(*vols[0])                                # warm-up
    (one3,), w31, _ = timed_pass(kern, runner_3d, vols[:1])
    (two3,), w32, l3 = timed_pass(kern, sharded3, vols[:1])
    worst3, same3 = rows_agree("3g (b) volume 1", hdr3[4:], two3, one3)
    if not all(l3[k] for k in KERNELS_3D):
        raise AssertionError("3g (b): a kernel was not launched: %r" % l3)
    log("  (b) *3D_ALL* on volume 1 (%d ROIs): one device %.4f s, two "
        "shards %.4f s; within the tiers (%.4f of values bit for bit, "
        "closest to its tier %s); launches %s"
        % (len(one3[0]), w31, w32, same3, worst3,
           {k: l3[k] for k in KERNELS_3D + ("batched_hist", "zone_stats")}))
    WALLS_3G.append("(b) volume 1 one device %.4f s, two shards %.4f s"
                    % (w31, w32))

    # (c)
    n_cards = torch.cuda.device_count()
    resolved = Nyxus(FEATURES_ALL, n_devices=-1)._runner.devices
    if len(resolved) != n_cards:
        raise AssertionError("3g (c): n_devices=-1 resolved %s on %d "
                             "cards" % (resolved, n_cards))
    log("  (c) Nyxus(n_devices=-1) resolved %d card(s): %s"
        % (len(resolved), [str(d) for d in resolved]))
    if n_cards < 2:
        try:
            Nyxus(FEATURES_ALL, n_devices=2)
        except ValueError as e:
            log("  (c) n_devices=2 on one card raises ValueError: %s" % e)
        else:
            raise AssertionError("3g (c): n_devices=2 on one card did not "
                                 "raise")
        log("  (c) no two-card run was made: the machine has %d card"
            % n_cards)
    else:
        real = Nyxus(FEATURES_ALL, n_devices=2)._runner
        real.run(*slides[0])
        reals, wall_r, lr = timed_pass(kern, real, slides)
        for k, (got, want) in enumerate(zip(reals, ones)):
            rows_agree("3g (c) slide %d" % k, cols, got, want)
        log("  (c) n_devices=2 on two cards: 8 slides %.4f s, within the "
            "tiers of one device; launches %s" % (wall_r, lr))
        WALLS_3G.append("(c) 8 slides on two cards %.4f s" % wall_r)

    # (d)
    with tempfile.TemporaryDirectory(prefix="nyx_shards_") as root:
        int_dir, seg_dir = write_pair_dir(
            root, [("s%d.tif" % k, slides[k]) for k in range(4)])
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            coord = "localhost:%d" % sock.getsockname()[1]
        env = dict(os.environ)
        env.pop("NYXUS_PROCESS_INDEX", None)
        env.pop("NYXUS_PROCESS_COUNT", None)
        procs, outs = [], []
        t0 = time.perf_counter()
        try:
            for pid in range(2):
                out = os.path.join(root, "shard%d.pkl" % pid)
                outs.append(out)
                code = _SHARD_WORKER % {
                    "root": HERE, "coord": coord, "pid": pid,
                    "feats": FEATURES_ALL, "intdir": int_dir,
                    "segdir": seg_dir, "out": out}
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, env=env, cwd=root))
            logs = [p.communicate(timeout=300)[0].decode(errors="replace")
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_p = time.perf_counter() - t0
        for p, text in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError("3g (d): a shard process failed:\n"
                                     + text[-3000:])
        parts = []
        for out in outs:
            with open(out, "rb") as f:
                parts.append(pickle.load(f))
        t0 = time.perf_counter()
        whole = Nyxus(FEATURES_ALL).featurize_directory(int_dir, seg_dir)
        torch.cuda.synchronize()
        wall_w = time.perf_counter() - t0
    names = ["s%d.tif" % k for k in range(4)]
    seen = [sorted({os.path.basename(m) for m in df.mask_image})
            for df, _ in parts]
    if seen != [names[0::2], names[1::2]]:
        raise AssertionError("3g (d): the shards hold %s" % seen)
    same_d = []
    for df, _ in parts:
        for name in sorted(set(df.mask_image)):
            got = df[df.mask_image == name]
            want = whole[whole.mask_image == name]
            w, same = rows_agree(
                "3g (d) " + os.path.basename(name), cols,
                (got.ROI_label.to_numpy(), got[cols].to_numpy(float)),
                (want.ROI_label.to_numpy(), want[cols].to_numpy(float)))
            same_d.append(same)
    if sum(len(df) for df, _ in parts) != len(whole):
        raise AssertionError("3g (d): the union has %d rows, the one "
                             "process %d" % (sum(len(df) for df, _ in parts),
                                             len(whole)))
    log("  (d) two processes on cuda:0 joined by initialize_distributed "
        "(gloo, %s): shards %s, %d rows in all within the tiers of the "
        "one-process run (%.4f-%.4f of values bit for bit); featurize_"
        "directory in the processes %.4f and %.4f s, both processes "
        "(start-up included) %.4f s; one process over the 4 slides %.4f s"
        % (coord, seen, len(whole), min(same_d), max(same_d), parts[0][1],
           parts[1][1], wall_p, wall_w))
    WALLS_3G.append("(d) two processes %.4f s (featurize_directory %.4f, "
                    "%.4f), one process %.4f s"
                    % (wall_p, parts[0][1], parts[1][1], wall_w))

    # (e)
    t_native, t_np = 0.0, 0.0
    for k, (intens, labels) in enumerate(slides):
        t0 = time.perf_counter()
        recs, smin, smax, clouds = plabels.discover_rois_clouds(intens,
                                                                labels)
        t1 = time.perf_counter()
        want = plabels._discover_rois_np(intens, labels)
        t_np += time.perf_counter() - t1
        t_native += t1 - t0
        if clouds is None or [vars(r) for r in recs] != \
                [vars(r) for r in want[0]] or (smin, smax) != want[1:]:
            raise AssertionError("3g (e) slide %d: the native discovery "
                                 "differs from the numpy pass" % k)
    log("  (e) native discovery (discover_rois_clouds, the records and the "
        "clouds) on the 8 slides: %.2f ms a slide, the records equal to "
        "the numpy pass's (%.2f ms a slide)"
        % (t_native * 1e3 / len(slides), t_np * 1e3 / len(slides)))
    WALLS_3G.append("(e) discovery %.2f ms a slide (numpy %.2f)"
                    % (t_native * 1e3 / len(slides),
                       t_np * 1e3 / len(slides)))
    log("  phase 3g took %.1f s; card %s" % (time.perf_counter() - t_phase,
                                             card_line()))


# ---------------------------------------------------------------------------


def kernel_times_only(root, only=None):
    """--kernel-times [ROOT [GROUP,...]]: build the kernels of the package
    under ROOT (by default this script's tree), print k1_k5_times,
    k2_times, k3_k9_times, k7_k8_times, k6_k8_times, k10_k12_times,
    k11_k13_times,
    k15_k16_times, k4_k17_times (or only the named groups, e.g. "k2") and
    the card; no result line.  Two trees timed in one call, in turns,
    compare the two versions of each of K1-K13 and K15-K17 on one
    card."""
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from nyxus_tpu_torch import _build
    torch.backends.cudnn.allow_tf32 = False
    log("card:", card_line())
    t0 = time.perf_counter()
    _build.lib()
    log("kernels of %s built in %.1f s" % (os.path.abspath(root),
                                           time.perf_counter() - t0))
    groups = {"k1_k5": k1_k5_times, "k2": k2_times, "k3_k9": k3_k9_times,
              "k7_k8": k7_k8_times, "k6_k8": k6_k8_times,
              "k10_k12": k10_k12_times,
              "k11_k13": k11_k13_times, "k15_k16": k15_k16_times,
              "k4_k17": k4_k17_times}
    for name in (only.split(",") if only else groups):
        groups[name]()
    log(card_line())


def main():
    import torch
    # phase 0
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch")
    if sys.argv[1:2] == ["--kernel-times"]:
        return kernel_times_only(sys.argv[2] if len(sys.argv) > 2 else HERE,
                                 sys.argv[3] if len(sys.argv) > 3 else None)
    sys.path.insert(0, HERE)
    try:
        import nyxus_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (%s)" % e)
    from nyxus_tpu_torch import _build, columns, native, taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.ops import glcm
    from nyxus_tpu_torch.ops.common import SMEM_MAX
    from nyxus_tpu_torch.pipeline import batching
    from nyxus_tpu_torch.pipeline import labels as plabels
    from nyxus_tpu_torch.pipeline.runner import PairRunner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card:", card)
    log("torch %s, CUDA %s, python %s, device %s"
        % (torch.__version__, torch.version.cuda, sys.version.split()[0],
           torch.cuda.get_device_name(0)))

    # phase 1: nvcc and g++ together
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        builds = [ex.submit(_build.lib), ex.submit(native.available)]
        for b in builds:
            b.result()
    log("phase 1: the %d kernel sources and the host library built in "
        "%.1f s (nvcc %.1f s into %s; g++ %.1f s into %s)"
        % (len(_build.SOURCES), time.perf_counter() - t0,
           _build.build_seconds or 0.0,
           _build.LIB_PATH, native.build_seconds or 0.0, native.LIB_PATH))
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())
    ldd = subprocess.run(["ldd", native.LIB_PATH], capture_output=True,
                         text=True, timeout=60).stdout
    if "libtiff" in ldd or "libz.so" in ldd:
        raise AssertionError("the host library links libtiff or zlib:\n"
                             + ldd)
    log("  ldd %s: %s" % (native.LIB_PATH, "; ".join(
        ln.split()[0] for ln in ldd.splitlines() if ln.strip())))

    # phase 2
    log_phase("phase 2: kernels against their plain versions")
    kres = check_kernels()
    log_phase("phase 2, 3D: K13-K16 and K1's split path against "
              "their plain versions")
    for k, v in check_kernels_3d().items():
        if k in kres:
            kres[k]["max_abs_err"] = max(kres[k]["max_abs_err"],
                                         v["max_abs_err"])
        else:
            kres[k] = v
    log_phase("phase 2, IBSI: K17 against its plain version")
    kres.update(check_ih())
    for name, nbytes in torch_bounds().items():
        log("  bound of torch routine %s at its main bucket: %d bytes, %.5f "
            "ms" % (name, nbytes, nbytes / HBM_BYTES_S * 1e3))

    # phase 3
    log_phase("phase 3: %s on the card (f32) against the CPU (f64)"
              % " ".join(FEATURES_ALL))
    kern = counters()
    fset = taxonomy.parse_feature_request(FEATURES_ALL)
    hdr, slots = columns.build_header(fset, EngineConfig())
    cols = hdr[4:]
    if len(cols) != WIDTH_ALL:
        raise AssertionError("width %d != %d" % (len(cols), WIDTH_ALL))
    card_runner = PairRunner(fset, EngineConfig(precision="f32"), "cuda")
    cpu_runner = PairRunner(fset, EngineConfig(precision="f64"), "cpu")
    long_slide = make_long_roi_slide()
    for what, (intens, labels), depth in (
            ("320x320 slide", make_dsb_like(320, 320, 40, seed=11), 64),
            ("long-ROI slide", long_slide, 64),
            ("long-ROI slide at 256 levels", long_slide, 256)):
        recs, _, _ = plabels._discover_rois_np(intens, labels)
        shapes = sorted({s for s, _ in batching.group_rois(recs)})
        big = [("K3 %dx%d" % (depth, max(s)))
               for s in shapes if 4 * depth * max(s) > SMEM_MAX]
        # K2's plan a bucket (the slide's GLCM is asymmetric)
        k2_plans = {s: glcm.glcm_cooc_plan(1, *s, depth, 4, False, 4)[:4]
                    for s in shapes}
        big += ["K2 %dx%d at %d levels" % (*s, depth)
                for s, p in k2_plans.items() if p[0] == "device"]
        dev_runner, ref_runner = card_runner, cpu_runner
        dcols, dslots = cols, slots
        if depth != 64:
            dev_runner = PairRunner(fset, EngineConfig(
                precision="f32", coarse_gray_depth=depth), "cuda")
            ref_runner = PairRunner(fset, EngineConfig(
                precision="f64", coarse_gray_depth=depth), "cpu")
            # the histogram members' widths follow the grey depth
            dhdr, dslots = columns.build_header(
                fset, EngineConfig(coarse_gray_depth=depth))
            dcols = dhdr[4:]
        host_cols = pre_host_columns(dev_runner, dslots)
        for f in kern.values():
            f.launches = 0
        labs, dev = dev_runner.run(intens, labels)
        small_launches = {k: kern[k].launches for k in KERNELS_2D}
        labs64, ref = ref_runner.run(intens, labels)
        worst = check_output(what, dcols, labs, dev, labs64, ref)
        if not np.array_equal(dev[:, host_cols].view(np.uint64),
                              ref[:, host_cols].view(np.uint64)):
            raise AssertionError("%s: the pre-collect host columns differ "
                                 "between the card and the CPU run" % what)
        gz = [j for j, c in enumerate(dcols)
              if c.startswith(("GABOR_", "ZERNIKE2D_"))]
        _, gz_worst = compare_tiers([dcols[j] for j in gz], dev[:, gz],
                                    ref[:, gz])
        log("  %s: %d ROIs x %d columns agree, the %d pre-collect host "
            "columns bit for bit; buckets %s; matrices in device memory: "
            "%s; K2's plans (path, count bits, angles a block, blocks a "
            "ROI) %s; closest to its tier: %s (of GABOR and ZERNIKE2D: %s); "
            "launches %s"
            % (what, len(labs), len(dcols), len(host_cols), shapes,
               big or "none", k2_plans, worst, gz_worst, small_launches))
        if not all(small_launches.values()):
            raise AssertionError("%s: a kernel was not launched: %r"
                                 % (what, small_launches))

    log_phase("phase 3, 3D: %s on the card (f32) against the CPU (f64)"
              % " ".join(FEATURES_3D))
    check_3d(kern)
    log_phase("phase 3, IBSI: %s (ibsi) and %s (ibsi) on the card (f32) "
              "against the CPU (f64)" % (" ".join(FEATURES_ALL),
                                         " ".join(FEATURES_3D)))
    ibsi_card, ibsi_cpu, ibsi_cols = check_ibsi(kern)

    # phase 3b
    log_phase("phase 3b: the 2D file protocol, %s through "
              "Nyxus._iter_directory_raw in memory and tile-streamed"
              % " ".join(FEATURES_ALL))
    check_files(kern, card_runner)

    # phase 3c
    t0 = time.perf_counter()
    slides = [make_dsb_like(1024, 1024, 300, seed=s) for s in range(7, 15)]
    log("  the 8 slides of phases 3c and 4 generated in %.1f s"
        % (time.perf_counter() - t0))
    log_phase("phase 3c: %s under mergerois, whole-slide mode and "
              "anisotropy on the card (f32) against the CPU (f64), in "
              "memory and streamed" % " ".join(FEATURES_ALL))
    check_modes(kern)
    log_phase("phase 3c: whole-slide mode at full size, the 8 slides "
              "through featurize_directory")
    ws_row = wholeslide_throughput(kern, slides)
    log_phase("phase 3c: the CLI as a subprocess")
    check_cli()

    # phase 3d
    log_phase("phase 3d: oversized ROIs (phase 3) on the card, f32 against "
              "the f64 CPU, and ImageQuality")
    oversized_rows = check_oversized(kern, ws_row, slides)

    # phase 4
    log_phase("phase 4: throughput on 8 slides make_dsb_like(1024, 1024, "
              "300)")
    tex_fset = taxonomy.parse_feature_request(FEATURES)
    tex_runner = PairRunner(tex_fset, EngineConfig(precision="f32"), "cuda")
    runner_713 = PairRunner(taxonomy.parse_feature_request(FEATURES_713),
                            EngineConfig(precision="f32"), "cuda")
    for name, runner, width, used in (
            ("337-column texture slice", tex_runner, WIDTH, TEXTURE_KERNELS),
            ("713-column request", runner_713, WIDTH_713,
             TEXTURE_KERNELS + SHAPE_KERNELS),
            ("747-column request", card_runner, WIDTH_ALL, KERNELS_2D)):
        for intens, labels in slides:                     # untimed pass
            runner.run(intens, labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in kern.values():
            f.launches = 0
        for f in torch_routines().values():
            f.calls = 0
        n_rois, outs = 0, []
        t0 = time.perf_counter()
        for intens, labels in slides:
            labs, vals = runner.run(intens, labels)
            n_rois += len(labs)
            outs.append((labs, vals))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in kern.items()}
        peak = torch.cuda.max_memory_allocated()
        log("  %s: %d ROIs in %.4f s: %.2f ROIs/s; peak device memory %d "
            "bytes (%.1f MiB); launches %s; torch routines' calls %s"
            % (name, n_rois, wall, n_rois / wall, peak, peak / 2 ** 20,
               launches, {k: f.calls for k, f in torch_routines().items()}))
        if not all(launches[k] for k in used):
            raise AssertionError("%s: a kernel was not launched: %r"
                                 % (name, launches))
        for labs, vals in outs:
            if vals.shape != (len(labs), width):
                raise AssertionError("%s: bad output %s" % (name,
                                                            vals.shape))
    labs64, ref = cpu_runner.run(*slides[0])
    worst = check_output("slide 7", cols, outs[0][0], outs[0][1], labs64, ref)
    log("  slide 7 (%d ROIs) of the 747-column request agrees with the f64 "
        "CPU run; closest to its tier: %s" % (len(labs64), worst))

    log_phase("phase 4, IBSI: throughput on the 8 slides at 8 bits "
              "((intensity >> 8) + 1, 256 raw levels)")
    from nyxus_tpu_torch.ops import common as ops_common
    slides8 = [(((intens >> 8) + 1).astype(np.uint16), labels)
               for intens, labels in slides]
    for intens, labels in slides8:                        # untimed pass
        ibsi_card.run(intens, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in kern.values():
        f.launches = 0
    ops_common.sort_masked_values.calls = 0
    n_rois, outs8 = 0, []
    t0 = time.perf_counter()
    for intens, labels in slides8:
        labs, vals = ibsi_card.run(intens, labels)
        n_rois += len(labs)
        outs8.append((labs, vals))
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t0
    launches_ibsi = {k: f.launches for k, f in kern.items()}
    peak = torch.cuda.max_memory_allocated()
    log("  IBSI 793-column request: %d ROIs in %.4f s: %.2f ROIs/s; peak "
        "device memory %d bytes (%.1f MiB); launches %s; sort_masked_values "
        "calls %d" % (n_rois, wall8, n_rois / wall8, peak, peak / 2 ** 20,
                      launches_ibsi, ops_common.sort_masked_values.calls))
    if not all(launches_ibsi[k] for k in KERNELS_2D + KERNELS_IH):
        raise AssertionError("IBSI throughput: a kernel was not launched: %r"
                             % launches_ibsi)
    for labs, vals in outs8:
        if vals.shape != (len(labs), WIDTH_IBSI):
            raise AssertionError("IBSI throughput: bad output %s"
                                 % (vals.shape,))
    labs64, ref = ibsi_cpu.run(*slides8[0])
    worst = check_output("slide 7, IBSI", ibsi_cols, outs8[0][0],
                         outs8[0][1], labs64, ref)
    check_ih_columns("slide 7, IBSI", ibsi_cols, outs8[0][1], ref)
    log("  slide 7 (%d ROIs) of the IBSI request agrees with the f64 CPU "
        "run, %s equal; closest to its tier: %s"
        % (len(labs64), "/".join(IH_FROM_HISTOGRAM), worst))

    log_phase("phase 4, 3D: throughput on 2 volumes make_volume_3d(1..2)")
    runner_3d, vols, launches_3d = throughput_3d(kern)

    # phase 3e
    log_phase("phase 3e: %s beyond the default configuration: the NIfTI and "
              "2.5D file protocol, the run modes, an oversized ROI, the "
              "kernels at the whole-volume crop" % " ".join(FEATURES_3D))
    finish3d_rows, (whole_err, whole_times), nifti_rows = check_3d_beyond(
        kern, vols, runner_3d)
    for k, e in whole_err.items():
        kres[k]["max_abs_err"] = max(kres[k]["max_abs_err"], e)

    # phase 3f
    log_phase("phase 3f: OME-Zarr and DICOM, %s through Nyxus.featurize_files "
              "in memory and streamed and %s through Nyxus3D.featurize_files"
              % (" ".join(FEATURES_ALL), " ".join(FEATURES_3D)))
    check_formats(kern, slides, vols, nifti_rows)

    # phase 3g
    log_phase("phase 3g: %s with each bucket in two shards on the card, "
              "Nyxus(n_devices=-1), two processes joined by "
              "initialize_distributed, the native discovery"
              % " ".join(FEATURES_ALL))
    check_shards(kern, card_runner, slides, runner_3d, vols)

    # phase 5
    log_phase("phase 5: profile of one warm slide of the 747-column request")
    profile_report("slide 8 of the 747-column request",
                   lambda: card_runner.run(*slides[1]), totals=KERNEL_NAMES_K2)
    t0 = time.perf_counter()
    for intens, labels in slides:
        plabels._discover_rois_np(intens, labels)
    log("  host ROI discovery: %.2f ms a slide (of %.2f ms a slide end to end)"
        % ((time.perf_counter() - t0) * 1e3 / len(slides), wall * 1e3 / len(slides)))
    log_phase("phase 5, 3D: profile of one warm volume of *3D_ALL*")
    profile_report("volume 1 of *3D_ALL*", lambda: runner_3d.run(*vols[0]),
                   totals=KERNEL_NAMES_3D)
    log_phase("phase 5, IBSI: profile of one warm 8-bit slide of the IBSI "
              "request")
    profile_report("slide 8 of the IBSI request",
                   lambda: ibsi_card.run(*slides8[1]), totals=KERNEL_NAMES_K2)

    src = {"batched_hist": ("nyxus_tpu_torch/csrc/batched_hist.cu",
                            "nyxus_tpu/ops/common.py:19"),
           "glcm_cooc": ("nyxus_tpu_torch/csrc/glcm_cooc.cu",
                         "nyxus_tpu/ops/glcm.py:61"),
           "glrlm_runs": ("nyxus_tpu_torch/csrc/glrlm_runs.cu",
                          "nyxus_tpu/ops/glrlm.py:85"),
           "neigh_matrix": ("nyxus_tpu_torch/csrc/neigh_matrix.cu",
                            "nyxus_tpu/ops/gldm.py:27"),
           "zone_dag": ("nyxus_tpu_torch/csrc/zone_dag.cu",
                        "nyxus_tpu/ops/zones.py:32"),
           "zone_cc4": ("nyxus_tpu_torch/csrc/zone_cc4.cu",
                        "nyxus_tpu/ops/zones.py:85"),
           "zone_stats": ("nyxus_tpu_torch/csrc/zone_stats.cu",
                          "nyxus_tpu/ops/zones.py:140"),
           "erosion": ("nyxus_tpu_torch/csrc/erosion.cu",
                       "nyxus_tpu/ops/binary.py:27"),
           "binary_quads": ("nyxus_tpu_torch/csrc/binary_quads.cu",
                            "nyxus_tpu/ops/binary.py:70"),
           "power_sums": ("nyxus_tpu_torch/csrc/power_sums.cu",
                          "nyxus_tpu/ops/moments.py:36"),
           "gabor": ("nyxus_tpu_torch/csrc/gabor.cu",
                     "nyxus_tpu/ops/gabor.py:49"),
           "zernike": ("nyxus_tpu_torch/csrc/zernike.cu",
                       "nyxus_tpu/ops/zernike.py:38"),
           "glcm3d_cooc": ("nyxus_tpu_torch/csrc/glcm3d_cooc.cu",
                           "nyxus_tpu/ops/texture3d.py:81"),
           "glrlm3d_runs": ("nyxus_tpu_torch/csrc/glrlm3d_runs.cu",
                            "nyxus_tpu/ops/texture3d.py:134"),
           "cc3d": ("nyxus_tpu_torch/csrc/cc3d.cu",
                    "nyxus_tpu/ops/texture3d.py:173"),
           "stencil3d": ("nyxus_tpu_torch/csrc/stencil3d.cu",
                         "nyxus_tpu/ops/texture3d.py:350"),
           "ih_stats": ("nyxus_tpu_torch/csrc/ih_stats.cu",
                        "nyxus_tpu/ops/ih.py:132")}
    # launches: the 2D kernels' in the timed pass of the 747-column request,
    # K13-K16's in the timed pass of *3D_ALL*, K17's in the timed IBSI pass
    launches.update({k: launches_3d[k] for k in KERNELS_3D})
    launches.update({k: launches_ibsi[k] for k in KERNELS_IH})
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [dict({"name": k, "route": "cuda", "source": src[k][0],
                     "replaces": src[k][1], "launches": launches[k]},
                    **{key: kres[k][key] for key in keys}) for k in KERNELS]
    log("phase 3d again: " + "; ".join(OVERSIZED_WALLS))
    log(json.dumps({"finish_stages": [
        {k: r[k] for k in ("name", "ms", "device_ms", "device_launches",
                           "device_copies", "kernel_launches", "bound_ms", "bound_by",
                           "library_ms", "agree")} for r in oversized_rows]}))
    log("phase 3e again: " + "; ".join(WALLS_3E))
    log("phase 3f again: " + "; ".join(WALLS_3F))
    log("phase 3g again: " + "; ".join(WALLS_3G))
    log(json.dumps({"finish3d_stages": [
        {k: r[k] for k in ("name", "ms", "device_ms", "device_launches",
                           "device_copies", "kernel_launches", "bound_ms",
                           "bound_by", "agree", "uploaded", "members")}
        for r in finish3d_rows]}))
    log(json.dumps({"whole_volume_kernels": {
        k: {"device_ms": t[0], "events_ms": t[1], "launches_a_call": t[2]}
        for k, t in whole_times.items()}}))
    log("smoke wall: %.1f s" % (time.perf_counter() - T_START))
    log_phase("done")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
