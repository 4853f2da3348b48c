"""The PyTorch port's slices end to end through PairRunner and
Nyxus.featurize, against the JAX package on the same slide in f64 on the
CPU, and against the reference binary's own CSV: intensity + the seven 2D
texture families GLCM, GLRLM, GLDM, NGTDM, GLSZM, GLDZM and NGLDM (337
columns), and the request *ALL* (747 columns: those plus the shape,
contour, host-geometry, moment, Gabor and Zernike families).  The
comparisons with JAX's PairRunner on whole slides run in files of their
own, tests/test_torch_slice_jax.py and tests/test_torch_slice_long_roi.py,
which import the helpers below.

Tolerances against JAX: rtol 1e-9 / atol 1e-12, except the members that go
through fast_log2 (rtol 5e-7): the JAX runner's jitted fast_log2 is
FMA-contracted by XLA and sits 1 ulp from the unfused reference formula the
port computes on ~9% of its float32 logs (see test_torch_texture).  NaN (a
weighted normalised moment of a ROI whose weighted mass is negative) must
sit in the same places, and the first central moments, zero by
construction, are compared by absolute size.  Against the reference CSV:
test_reference_parity's tolerances (p90 relative error <= 1e-4; the first
central moments by absolute size; DIAMETER_MIN_ENCLOSING_CIRCLE, a known
divergence of the JAX package's host code, at 5.0)."""

import gzip
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from conftest import make_blobs

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import nyxus_tpu  # noqa: E402
from nyxus_tpu import columns as jcol  # noqa: E402
from nyxus_tpu import taxonomy as jtx  # noqa: E402
from nyxus_tpu.blacklist import RoiBlacklist  # noqa: E402
from nyxus_tpu.config import EngineConfig as JConfig  # noqa: E402
from nyxus_tpu.pipeline.runner import PairRunner as JRunner  # noqa: E402

import nyxus_tpu_torch  # noqa: E402
from nyxus_tpu_torch import columns as tcol  # noqa: E402
from nyxus_tpu_torch import registry  # noqa: E402
from nyxus_tpu_torch import taxonomy as ttx  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig as TConfig  # noqa: E402
from nyxus_tpu_torch.pipeline.runner import PairRunner as TRunner  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

FEATURES = ["*ALL_INTENSITY*", "*ALL_GLCM*", "*ALL_GLRLM*", "*ALL_GLDM*",
            "*ALL_NGTDM*", "*ALL_GLSZM*", "*ALL_GLDZM*", "*ALL_NGLDM*"]
WIDTH = 337
FEATURES_ALL = ["*ALL*"]
WIDTH_ALL = 747
ZERO_BY_CONSTRUCTION = ("CENTRAL_MOMENT_01", "CENTRAL_MOMENT_10",
                        "IMOM_CM_01", "IMOM_CM_10")
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "ref_all_320x320_seed11.csv.gz")
_ENTROPY = ("ENTRO", "_JE", "_RE", "_DE", "INFOMEAS", "GLSZM_ZE")
GROUPS = {"intensity": lambda c: not c.startswith(("GL", "NGTDM", "NGLDM")),
          "glcm": lambda c: c.startswith("GLCM_"),
          "glrlm": lambda c: c.startswith("GLRLM_"),
          "gldm": lambda c: c.startswith("GLDM_"),
          "ngtdm": lambda c: c.startswith("NGTDM_"),
          "glszm": lambda c: c.startswith("GLSZM_"),
          "gldzm": lambda c: c.startswith("GLDZM_"),
          "ngldm": lambda c: c.startswith("NGLDM_")}


def _port_runner(**kw):
    return TRunner(ttx.parse_feature_request(FEATURES),
                   TConfig(precision="f64", **kw), device="cpu")


def _compare(cols, want, got):
    assert got.shape == want.shape
    for j, c in enumerate(cols):
        rtol = 5e-7 if any(t in c for t in _ENTROPY) else 1e-9
        np.testing.assert_allclose(got[:, j], want[:, j], rtol=rtol,
                                   atol=1e-12, err_msg=c)
        zero = want[:, j] == 0
        np.testing.assert_array_equal(np.signbit(got[zero, j]),
                                      np.signbit(want[zero, j]), err_msg=c)


def test_against_reference_binary():
    """The slice's columns of the reference CLI's *ALL* CSV on
    bench.make_dsb_like(320, 320, 40, seed=11)."""
    ref = pd.read_csv(gzip.open(FIXTURE, "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    intens, labels = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
    labs, values = _port_runner().run(intens, labels)
    hdr, _ = tcol.build_header(ttx.parse_feature_request(FEATURES), TConfig())
    ours = pd.DataFrame(values, columns=hdr[4:], index=labs)
    assert list(ref.index) == list(ours.index)
    cols = list(ours.columns)
    assert not set(cols) - set(ref.columns)
    failures = []
    for c in cols:
        a = ours[c].to_numpy(float)
        b = ref[c].to_numpy(float)
        both = np.isfinite(a) & np.isfinite(b)
        if both.sum() == 0:
            continue
        rel = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), 1e-8)
        p90 = float(np.quantile(rel, 0.9))
        if p90 > 1e-4:
            failures.append((c, p90))
    assert not failures, failures[:25]


def test_blacklisted_rows_stay_unassigned():
    intens, labels = make_blobs(seed=2)
    bl = RoiBlacklist()
    bl.parse_raw_string("2,5")
    cfg = JConfig(precision="f64")
    fset = jtx.parse_feature_request(["*ALL_INTENSITY*"])
    jl, jv = JRunner(fset, cfg).run(intens, labels, blacklist=bl)
    tl, tv = TRunner(ttx.parse_feature_request(["*ALL_INTENSITY*"]),
                     TConfig(precision="f64"), device="cpu").run(
        intens, labels, blacklist=bl)
    np.testing.assert_array_equal(tl, jl)
    for lab in (2, 5):
        row = tv[list(tl).index(lab)]
        assert (row == 0).all() and np.signbit(row).all()
    hdr, _ = jcol.build_header(fset, cfg)
    _compare(hdr[4:], jv, tv)


def test_empty_label_image():
    intens = np.ones((32, 32), np.uint16)
    labels = np.zeros((32, 32), np.int32)
    labs, values = _port_runner().run(intens, labels)
    assert labs.shape == (0,) and values.shape == (0, WIDTH)


@pytest.mark.parametrize("features,parse_kw,families", [
    (["SHARPNESS"], {"imq": True}, ("SharpnessFeature",)),
    (["*ALL_IMQ*"], {"imq": True}, ("FocusScoreFeature",
     "PowerSpectrumFeature", "SaturationFeature", "SharpnessFeature")),
    (["FOCUS_SCORE"], {"imq": True},
     ("FocusScoreFeature", "PowerSpectrumFeature")),
])
def test_unported_families_raise(features, parse_kw, families):
    """The image-quality families, which the port once refused, are served
    now: the request activates them (FOCUS_SCORE pulls in the power
    spectrum, as in the JAX package) and the port's values on a slide of
    blobs equal JAX's."""
    fset = ttx.parse_feature_request(features, **parse_kw)
    assert registry.activated_families(fset) == families
    intens, labels = make_blobs(64, 72, 4, seed=6)
    jl, jv = JRunner(jtx.parse_feature_request(features, **parse_kw),
                     JConfig(precision="f64")).run(intens, labels)
    tl, tv = TRunner(fset, TConfig(precision="f64"), device="cpu").run(
        intens, labels)
    np.testing.assert_array_equal(tl, jl)
    assert tv.shape == jv.shape and tv.shape[0] >= 3
    hdr, _ = tcol.build_header(fset, TConfig())
    _compare(hdr[4:], jv, tv)


# ---------------------------------------------------------------------------
# the request *ALL* (747 columns)

ALL_GROUPS = {
    "textures": lambda c: c.startswith(("GL", "NGTDM", "NGLDM")),
    "moments": lambda c: c.startswith(
        ("IMOM_", "SPAT_MOMENT", "WEIGHTED_SPAT", "CENTRAL_MOMENT",
         "WEIGHTED_CENTRAL", "NORM_", "WT_NORM", "HU_M", "WEIGHTED_HU")),
    "host": lambda c: c.startswith(
        ("PERIMETER", "DIAMETER_EQUAL_PERIMETER", "EDGE_", "CONVEX_HULL",
         "SOLIDITY", "CIRCULARITY", "MIN_FERET", "MAX_FERET", "STAT_",
         "MAXCHORDS", "ALLCHORDS", "ROI_RADIUS", "FRAC_AT_D", "MEAN_FRAC",
         "RADIAL_CV", "FRACT_DIM_PERIMETER", "DIAMETER_MIN_ENCLOSING",
         "DIAMETER_INSCRIBING", "DIAMETER_CIRCUMSCRIBING", "GEODETIC",
         "THICKNESS", "NUM_NEIGHBORS", "PERCENT_TOUCHING", "CLOSEST_",
         "ANG_BW", "POLYGONALITY", "HEXAGONALITY")),
    "gabor+zernike": lambda c: c.startswith(("GABOR_", "ZERNIKE2D_")),
}
ALL_GROUPS["intensity+shape"] = lambda c: not any(
    g(c) for k, g in ALL_GROUPS.items() if k != "intensity+shape")


def _compare_all(cols, want, got):
    """_compare with NaN in the same places and the first central moments
    (zero by construction) bounded by absolute size."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = [j for j, c in enumerate(cols) if c not in ZERO_BY_CONSTRUCTION]
    for j, c in enumerate(cols):
        if c in ZERO_BY_CONSTRUCTION:
            assert np.nanmax(np.abs(got[:, j])) < 1e-3, c
            assert np.nanmax(np.abs(want[:, j])) < 1e-3, c
    fin = ~np.isnan(want)
    _compare([cols[j] for j in keep], np.where(fin, want, 0)[:, keep],
             np.where(fin, got, 0)[:, keep])


@pytest.fixture(scope="module")
def reference_frames():
    ref = pd.read_csv(gzip.open(FIXTURE, "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    intens, labels = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
    labs, values = TRunner(ttx.parse_feature_request(FEATURES_ALL),
                           TConfig(precision="f64"), device="cpu").run(
        intens, labels)
    hdr, _ = tcol.build_header(ttx.parse_feature_request(FEATURES_ALL),
                               TConfig())
    return ref, pd.DataFrame(values, columns=hdr[4:], index=labs)


@pytest.mark.parametrize("group", list(ALL_GROUPS))
def test_all_but_gabor_zernike_against_reference_binary(reference_frames,
                                                        group):
    """The 747 columns against the reference CLI's *ALL* CSV on
    bench.make_dsb_like(320, 320, 40, seed=11), at
    tests/test_reference_parity.py's tolerances."""
    ref, ours = reference_frames
    assert list(ref.index) == list(ours.index)
    cols = [c for c in ours.columns if ALL_GROUPS[group](c)]
    assert cols and not set(cols) - set(ref.columns)
    failures = []
    for c in cols:
        a = ours[c].to_numpy(float)
        b = ref[c].to_numpy(float)
        both = np.isfinite(a) & np.isfinite(b)
        if both.sum() == 0:
            continue
        if c in ZERO_BY_CONSTRUCTION:
            if np.abs(a[both]).max() > 1e-3:
                failures.append((c, "abs", float(np.abs(a[both]).max())))
            continue
        rel = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), 1e-8)
        p90 = float(np.quantile(rel, 0.9))
        tol = 5.0 if c == "DIAMETER_MIN_ENCLOSING_CIRCLE" else 1e-4
        if p90 > tol:
            failures.append((c, p90))
    assert not failures, failures[:25]


def test_labels_beyond_int32_raise():
    """Labels of 2**31 and above, which the native batch trace cannot read
    as int32, no longer raise: each ROI's contour is traced alone
    (contour.merged_contour), as the JAX package's numpy fallback does, and
    the contour, geometry and weighted-moment columns equal JAX's."""
    intens, labels = make_blobs(64, 64, 3, seed=1)
    big = labels.astype(np.uint32)
    big[labels > 0] += np.uint32(2 ** 31)
    feats = ["PERIMETER", "EDGE_MEAN_INTENSITY", "ROI_RADIUS_MEAN",
             "CONVEX_HULL_AREA", "WEIGHTED_HU_M1", "*ALL_INTENSITY*"]
    jl, jv = JRunner(jtx.parse_feature_request(feats),
                     JConfig(precision="f64")).run(intens, big)
    tl, tv = TRunner(ttx.parse_feature_request(feats),
                     TConfig(precision="f64"), device="cpu").run(intens, big)
    np.testing.assert_array_equal(tl, jl)
    assert len(tl) == labels.max() and tl.min() >= 2 ** 31
    hdr, _ = tcol.build_header(ttx.parse_feature_request(feats), TConfig())
    _compare(hdr[4:], jv, tv)


def _oversized_equals_jax(intens, labels, wholeslide=False, **kw):
    """The slice's request with every ROI over the batch budget
    (ram_limit_mb=0, the streamed phase-3 path) against JAX's."""
    jl, jv = JRunner(jtx.parse_feature_request(FEATURES),
                     JConfig(precision="f64", ram_limit_mb=0, **kw)).run(
        intens, labels, wholeslide=wholeslide)
    tl, tv = _port_runner(ram_limit_mb=0, **kw).run(intens, labels,
                                                    wholeslide=wholeslide)
    np.testing.assert_array_equal(tl, jl)
    assert tv.shape == (len(tl), WIDTH)
    hdr, _ = tcol.build_header(ttx.parse_feature_request(FEATURES),
                               TConfig())
    _compare(hdr[4:], jv, tv)


@pytest.mark.parametrize("kw", [{"aniso_y": 2.0}, {"mergerois": True},
                                {"aniso_x": 2.0}])
def test_unsupported_modes_raise(kw):
    """The run modes build and run; an ROI over the batch budget under them,
    which the port once refused, takes the oversized path and equals
    JAX's."""
    intens, labels = make_blobs(seed=1)
    labs, values = _port_runner(**kw).run(intens, labels)
    assert values.shape == (len(labs), WIDTH) and len(labs) >= 1
    _oversized_equals_jax(intens, labels, **kw)


def test_oversized_and_wholeslide_raise():
    """Oversized ROIs and an oversized whole-slide ROI, which the port once
    refused, equal JAX's."""
    intens, labels = make_blobs(seed=1)
    _oversized_equals_jax(intens, labels)
    _oversized_equals_jax(intens, np.ones_like(labels), wholeslide=True)


@pytest.mark.parametrize("args", [(320, 320, 40, 11), (256, 256, 25, 5),
                                  (96, 128, 12, 3)])
def test_chip_smoke_slide_is_bench_slide(args):
    """chip_smoke.py carries a copy of bench.make_dsb_like (bench imports
    jax); the copy must give the very same slide."""
    import chip_smoke
    ci, cl = chip_smoke.make_dsb_like(*args)
    bi, bl = bench.make_dsb_like(*args)
    np.testing.assert_array_equal(cl, bl)
    np.testing.assert_array_equal(ci, bi)
    assert ci.dtype == bi.dtype and cl.dtype == bl.dtype


def test_chip_smoke_tiers_are_the_device_lane_tiers():
    import chip_smoke
    import test_tpu_device
    assert chip_smoke.DEFAULT_TOL == test_tpu_device.DEFAULT_TOL
    assert chip_smoke.PREFIX_TOL == test_tpu_device.PREFIX_TOL
    # the smoke matches DISCRETE on whole tokens, so it skips a subset of
    # the columns the device lane skips, and holds the integer shape counts
    # exactly
    hdr, _ = tcol.build_header(
        ttx.parse_feature_request(chip_smoke.FEATURES_ALL), TConfig())
    skipped = [c for c in hdr[4:]
               if set(c.split("_")) & set(chip_smoke.DISCRETE)]
    assert skipped and all(any(t in c for t in test_tpu_device.DISCRETE)
                           for c in skipped)
    assert "MINOR_AXIS_LENGTH" not in skipped
    assert {"EULER_NUMBER", "EROSIONS_2_VANISH"} <= set(chip_smoke.EXACT)
    assert chip_smoke.ZERO_BY_CONSTRUCTION == \
        test_tpu_device.ZERO_BY_CONSTRUCTION


@pytest.mark.parametrize("preserve_hu", [False, True])
def test_featurize_shifts_negative_intensities(preserve_hu):
    """Float images with negative values are shifted (and, under
    preserve_hu, rounded) exactly as the JAX package's featurize does."""
    intens, labels = make_blobs(96, 96, 4, seed=6)
    img = intens.astype(np.float64) / 7.0 - 500.25
    feats = ["*ALL_INTENSITY*"]
    want = nyxus_tpu.Nyxus(feats, precision="f64",
                           preserve_hu=preserve_hu).featurize(img, labels)
    got = nyxus_tpu_torch.Nyxus(feats, device="cpu", precision="f64",
                                preserve_hu=preserve_hu).featurize(img, labels)
    assert list(got.columns) == list(want.columns)
    cols = list(want.columns[4:])
    _compare(cols, want[cols].to_numpy(float), got[cols].to_numpy(float))


def test_device_selection_and_gpu_functions():
    n = nyxus_tpu_torch.Nyxus(["*ALL_INTENSITY*"], device="cpu")
    count = torch.cuda.device_count()
    with pytest.raises(ValueError):
        n.use_gpu_device(count)
    n.use_gpu_device(-1)
    assert n.device == "cuda" and n._runner.device.type == "cuda"
    assert nyxus_tpu_torch.gpu_is_available() == torch.cuda.is_available()
    props = nyxus_tpu_torch.get_gpu_properties()
    assert len(props) == (count if torch.cuda.is_available() else 0)


# ---------------------------------------------------------------------------
# two more reference CSVs of the 320 x 320 slide (test_config_parity's
# configurations): radiomics binning and preserve_hu


def _reference_parity(name, ours, skip_prefixes=()):
    """(columns checked, failures) of ``ours`` against the reference CSV
    ``name`` at test_config_parity's p90 1e-4: its FAMILY_TOL columns (the
    first central moments) skipped, DIAMETER_MIN_ENCLOSING_CIRCLE at 5.0."""
    ref = pd.read_csv(gzip.open(os.path.join(os.path.dirname(FIXTURE), name),
                                "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    assert list(ref.index) == list(ours.index)
    failures, checked = [], 0
    for c in ours.columns:
        if c not in ref.columns or c in ZERO_BY_CONSTRUCTION \
                or c.startswith(skip_prefixes):
            continue
        a = ours[c].to_numpy(float)
        b = ref[c].to_numpy(float)
        both = np.isfinite(a) & np.isfinite(b)
        if both.sum() == 0:
            continue
        rel = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), 1e-6)
        p90 = float(np.quantile(rel, 0.9))
        checked += 1
        if p90 > (5.0 if c == "DIAMETER_MIN_ENCLOSING_CIRCLE" else 1e-4):
            failures.append((c, p90))
    return checked, failures


def _slide_frame(intens, labels, **cfg):
    fset = ttx.parse_feature_request(FEATURES_ALL)
    labs, values = TRunner(fset, TConfig(precision="f64", **cfg),
                           device="cpu").run(intens, labels, hu_offset=0.0)
    hdr, _ = tcol.build_header(fset, TConfig(**cfg))
    return pd.DataFrame(values, columns=hdr[4:], index=labs)


def test_radiomics_binning_reference_parity():
    """coarse_gray_depth -32 (radiomics binning) on the slide with
    intensities % 59 + 1 against ref_radiomics_320x320_seed11: 642
    columns, GLDZM and NGLDM skipped as test_config_parity.py skips them
    (the binary's own defects under a negative grey depth)."""
    intens, labels = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
    intens = (intens % 59 + 1).astype(np.uint16)
    ours = _slide_frame(intens, labels, coarse_gray_depth=-32)
    checked, failures = _reference_parity(
        "ref_radiomics_320x320_seed11.csv.gz", ours,
        skip_prefixes=("GLDZM_", "NGLDM_"))
    assert not failures, failures[:25]
    assert checked == 642, checked


def test_preserve_hu_reference_parity():
    """preserve_hu on a positive float HU-like slide against
    ref_hu_320x320_seed11 at the binary's effective load map u = round(x)
    (test_config_parity.test_hu_mode_parity): 743 columns."""
    intens, labels = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
    hu = ((intens.astype(np.int64) % 59) * 30 + 100).astype(np.float32)
    ours = _slide_frame(np.round(hu).astype(np.uint32), labels,
                        preserve_hu=True)
    checked, failures = _reference_parity("ref_hu_320x320_seed11.csv.gz",
                                          ours)
    assert not failures, failures[:25]
    assert checked == 743, checked
