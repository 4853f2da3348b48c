"""The PyTorch port's slice end to end: intensity + GLCM + GLRLM + GLDM +
NGTDM (284 columns) through PairRunner and Nyxus.featurize, against the JAX
package on the same slide in f64 on the CPU, and against the reference
binary's own CSV.

Tolerances against JAX: rtol 1e-9 / atol 1e-12, except the entropy members
(rtol 5e-7): the JAX runner's jitted fast_log2 is FMA-contracted by XLA and
sits 1 ulp from the unfused reference formula the port computes on ~9% of
its float32 logs (see test_torch_texture).  Against the reference CSV:
test_reference_parity's tolerance, p90 relative error <= 1e-4."""

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
from nyxus_tpu_torch import taxonomy as ttx  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig as TConfig  # noqa: E402
from nyxus_tpu_torch.pipeline.runner import PairRunner as TRunner  # noqa: E402

FEATURES = ["*ALL_INTENSITY*", "*ALL_GLCM*", "*ALL_GLRLM*", "*ALL_GLDM*",
            "*ALL_NGTDM*"]
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "ref_all_320x320_seed11.csv.gz")
_ENTROPY = ("ENTRO", "_JE", "_RE", "_DE", "INFOMEAS")
GROUPS = {"intensity": lambda c: not c.startswith(("GL", "NGTDM")),
          "glcm": lambda c: c.startswith("GLCM_"),
          "glrlm": lambda c: c.startswith("GLRLM_"),
          "gldm": lambda c: c.startswith("GLDM_"),
          "ngtdm": lambda c: c.startswith("NGTDM_")}


def _port_runner(**kw):
    return TRunner(ttx.parse_feature_request(FEATURES),
                   TConfig(precision="f64", **kw), device="cpu")


@pytest.fixture(scope="module")
def blob_runs():
    intens, labels = make_blobs()
    cfg = JConfig(precision="f64")
    fset = jtx.parse_feature_request(FEATURES)
    jl, jv = JRunner(fset, cfg).run(intens, labels)
    tl, tv = _port_runner().run(intens, labels)
    hdr, _ = jcol.build_header(fset, cfg)
    return hdr[4:], (jl, jv), (tl, tv)


def _compare(cols, want, got):
    assert got.shape == want.shape
    for j, c in enumerate(cols):
        rtol = 5e-7 if any(t in c for t in _ENTROPY) else 1e-9
        np.testing.assert_allclose(got[:, j], want[:, j], rtol=rtol,
                                   atol=1e-12, err_msg=c)
        zero = want[:, j] == 0
        np.testing.assert_array_equal(np.signbit(got[zero, j]),
                                      np.signbit(want[zero, j]), err_msg=c)


@pytest.mark.parametrize("group", list(GROUPS))
def test_pair_runner_vs_jax(blob_runs, group):
    cols, (jl, jv), (tl, tv) = blob_runs
    assert len(cols) == 284
    np.testing.assert_array_equal(tl, jl)
    sel = [j for j, c in enumerate(cols) if GROUPS[group](c)]
    assert sel
    _compare([cols[j] for j in sel], jv[:, sel], tv[:, sel])


def test_every_column_in_a_group(blob_runs):
    cols = blob_runs[0]
    assert sum(any(g(c) for g in GROUPS.values()) for c in cols) == len(cols)
    assert all(sum(g(c) for g in GROUPS.values()) == 1 for c in cols)


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


def test_nyxus_featurize_frame(blob_runs):
    intens, labels = make_blobs()
    want = nyxus_tpu.Nyxus(FEATURES, precision="f64").featurize(intens, labels)
    got = nyxus_tpu_torch.Nyxus(FEATURES, device="cpu",
                                precision="f64").featurize(intens, labels)
    assert list(got.columns) == list(want.columns)
    assert len(got.columns) == 4 + 284
    np.testing.assert_array_equal(got["ROI_label"].to_numpy(),
                                  want["ROI_label"].to_numpy())
    assert (got["intensity_image"] == want["intensity_image"]).all()
    cols = list(want.columns[4:])
    _compare(cols, want[cols].to_numpy(float), got[cols].to_numpy(float))


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
    assert labs.shape == (0,) and values.shape == (0, 284)


@pytest.mark.parametrize("features,missing", [
    (["*ALL*"], "GLSZMFeature"),
    (["*ALL_GLSZM*"], "GLSZMFeature"),
    (["*ALL_INTENSITY*", "PERIMETER"], "ContourFeature"),
])
def test_unported_families_raise(features, missing):
    with pytest.raises(NotImplementedError, match=missing):
        TRunner(ttx.parse_feature_request(features), TConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match=missing):
        nyxus_tpu_torch.Nyxus(features, device="cpu")


@pytest.mark.parametrize("kw", [{"ibsi": True}, {"mergerois": True},
                                {"aniso_x": 2.0}])
def test_unsupported_modes_raise(kw):
    with pytest.raises(NotImplementedError):
        TRunner(ttx.parse_feature_request(FEATURES), TConfig(**kw),
                device="cpu")


def test_oversized_and_wholeslide_raise():
    intens, labels = make_blobs(seed=1)
    with pytest.raises(NotImplementedError, match="oversized"):
        _port_runner(ram_limit_mb=0).run(intens, labels)
    with pytest.raises(NotImplementedError, match="whole-slide"):
        _port_runner().run(intens, labels, wholeslide=True)


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
    assert chip_smoke.DISCRETE == test_tpu_device.DISCRETE
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
