"""The port's native ROI discovery (``native/src/discover.cpp``, a
verbatim copy of the JAX package's, and ``native.discover``) against the
JAX package's on the CPU: the records, the slide extrema and the
raster-order pixel clouds, bit for bit, over every intensity dtype the
scan reads and the label dtypes it takes; ``labels.discover_rois`` /
``discover_rois_clouds`` and the tile step of ``discover_rois_streamed``;
labels of 2**31 and above, which take the numpy path in both packages.
``PairRunner.run`` discovers through the native pass and hands its clouds
to the geometry pass: its rows equal those of the former whole-slide
label sort, under anisotropy too."""

import os
import sys

import numpy as np
import pytest

from conftest import make_blobs

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from nyxus_tpu import native as jnative  # noqa: E402
from nyxus_tpu.pipeline import labels as jlabels  # noqa: E402
from nyxus_tpu.pipeline.sources import ArrayPairSource as JSource  # noqa: E402

from nyxus_tpu_torch import native as tnative  # noqa: E402
from nyxus_tpu_torch import taxonomy as ttx  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig as TConfig  # noqa: E402
from nyxus_tpu_torch.pipeline import labels as tlabels  # noqa: E402
from nyxus_tpu_torch.pipeline import runner as trunner  # noqa: E402
from nyxus_tpu_torch.pipeline.sources import ArrayPairSource  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)

INTENS_DTYPES = (np.uint8, np.uint16, np.uint32, np.int32, np.float32,
                 np.float64, np.int64, np.int16)
LABEL_DTYPES = (np.uint8, np.uint16, np.int32, np.uint32, np.int64)
FEATS = ["*ALL_INTENSITY*", "*ALL_MORPHOLOGY*", "*ALL_GLCM*",
         "WEIGHTED_HU_M1", "EDGE_MEAN_INTENSITY", "ROI_RADIUS_MEAN"]


@pytest.fixture(scope="module")
def slide():
    """The reference CSVs' 320 x 320 slide, a ROI on its border."""
    intens, labels = bench.make_dsb_like(320, 320, 40, seed=11)
    labels = labels.astype(np.int32)
    labels[:3, 40:90] = labels.max() + 1
    return intens, labels


def _recs(result):
    """A discovery result with its records as dicts, comparable across the
    two packages' RoiRecord classes."""
    return ([vars(r) for r in result[0]],) + tuple(result[1:])


def _same(t, j):
    """Two (recs, fmm, smin, smax, clouds) results, bit for bit."""
    for a, b in zip(t[:2], j[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (t[2], t[3]) == (j[2], j[3])
    assert (t[4] is None) == (j[4] is None)
    if t[4] is not None:
        for a, b in zip(t[4], j[4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("want_clouds", [False, True])
@pytest.mark.parametrize("dtype", INTENS_DTYPES, ids=lambda d: d.__name__)
def test_discover_equals_jax(slide, dtype, want_clouds):
    intens, labels = slide
    img = (intens >> 8).astype(dtype) if dtype in (np.uint8, np.int16) \
        else intens.astype(dtype)
    if dtype in (np.float32, np.float64):
        img = img * 0.37 - 11.0
    t = tnative.discover(labels, img, want_clouds=want_clouds)
    _same(t, jnative.discover(labels, img, want_clouds=want_clouds))
    assert len(t[0]) == len(np.unique(labels)) - 1


@pytest.mark.parametrize("dtype", LABEL_DTYPES, ids=lambda d: d.__name__)
def test_discovery_records_and_clouds(slide, dtype):
    """``discover_rois_clouds`` / ``discover_rois``: the records and clouds
    of JAX's, the records of the numpy oracle, and the clouds of the
    runner's former whole-slide label sort."""
    intens, labels = slide
    labels = labels.astype(dtype)
    recs, smin, smax, clouds = tlabels.discover_rois_clouds(intens, labels)
    jrecs, jmin, jmax, jclouds = jlabels.discover_rois_clouds(intens, labels)
    assert _recs((recs, smin, smax)) == _recs((jrecs, jmin, jmax))
    for a, b in zip(clouds, jclouds):
        np.testing.assert_array_equal(a, b)
    assert (recs, smin, smax) == tuple(tlabels._discover_rois_np(intens,
                                                                  labels))
    assert tlabels.discover_rois(intens, labels) == (recs, smin, smax)
    for a, b in zip(clouds, trunner._build_clouds(recs, intens, labels)):
        np.testing.assert_array_equal(a, b)


def test_runner_slices_the_discovery_clouds(slide):
    """``_build_clouds`` given the discovery's clouds: the clouds of the
    label sort for every subset of rows the runner asks for (the whole set
    in order, a blacklist's remainder, oversized rows left empty)."""
    intens, labels = slide
    recs, _, _, clouds = tlabels.discover_rois_clouds(intens, labels)
    pre = clouds + ({r.label: k for k, r in enumerate(recs)},)
    for sub, skip in ((recs, frozenset()), (recs[3::2], frozenset()),
                      (recs, frozenset({0, 5})), (recs[::-1], {2})):
        got = trunner._build_clouds(sub, intens, labels, skip, pre=pre)
        want = trunner._build_clouds(sub, intens, labels, skip)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_empty_and_blank_slides():
    z = np.zeros((40, 30), np.uint16)
    intens = np.arange(1200, dtype=np.uint16).reshape(40, 30)
    _same(tnative.discover(z, intens, want_clouds=True),
          jnative.discover(z, intens, want_clouds=True))
    assert tlabels.discover_rois_clouds(intens, z) == \
        jlabels.discover_rois_clouds(intens, z) == ([], 0.0, 1199.0, None)
    assert tlabels.discover_rois_streamed(ArrayPairSource(intens, z), 16) \
        == jlabels.discover_rois_streamed(JSource(intens, z), 16)


@pytest.mark.parametrize("tile", [16, 64, 100, 2048])
def test_streamed_tiles_equal_jax(tile):
    """The native tile step of ``discover_rois_streamed``: the records of
    JAX's and of the in-memory pass, ROIs across tile seams merged."""
    intens, labels = make_blobs(150, 140, 12, seed=7)
    labels[58:70, 40:100] = 50
    labels[20:80, 134:] = 51
    labels = labels.astype(np.uint16)
    got = tlabels.discover_rois_streamed(ArrayPairSource(intens, labels),
                                         tile)
    assert _recs(got) == _recs(jlabels.discover_rois_streamed(
        JSource(intens, labels), tile))
    assert got == tuple(tlabels.discover_rois(intens, labels))


@pytest.mark.parametrize("streamed", [False, True])
def test_labels_beyond_int32_take_the_numpy_path(slide, streamed):
    intens, labels = slide
    big = labels.astype(np.uint64)
    big[labels > 0] += np.uint64(2 ** 31)
    assert not tlabels._native_labels_ok(big)
    if streamed:
        got = tlabels.discover_rois_streamed(ArrayPairSource(intens, big), 64)
        want = jlabels.discover_rois_streamed(JSource(intens, big), 64)
    else:
        got = tlabels.discover_rois_clouds(intens, big)
        want = jlabels.discover_rois_clouds(intens, big)
        assert got[3] is None and want[3] is None
    assert _recs(got) == _recs(want)
    assert got[0][0].label == 2 ** 31 + 1
    assert tuple(got[:3]) == tuple(tlabels._discover_rois_np(intens, big))
    with pytest.raises(ValueError, match="int32"):
        tnative.discover(big, intens)


@pytest.mark.parametrize("aniso", [False, True], ids=["plain", "aniso"])
def test_run_takes_native_discovery(slide, monkeypatch, aniso):
    """``PairRunner.run`` discovers through ``discover_rois_clouds`` (the
    numpy pass is never called) and its rows equal the rows it gives when
    the discovery hands no clouds (the whole-slide label sort), bit for
    bit; under anisotropy it discovers twice, on the virtual slide too."""
    intens, labels = slide
    kw = {"aniso_x": 1.4, "aniso_y": 0.75} if aniso else {}
    runner = trunner.PairRunner(ttx.parse_feature_request(FEATS),
                                TConfig(precision="f64", **kw), device="cpu")
    calls = []
    native_pass = tlabels.discover_rois_clouds

    def counted(*a):
        calls.append(1)
        return native_pass(*a)

    def refused(*a):
        raise AssertionError("the numpy discovery ran")
    monkeypatch.setattr(tlabels, "discover_rois_clouds", counted)
    monkeypatch.setattr(tlabels, "_discover_rois_np", refused)
    labs, vals = runner.run(intens, labels)
    assert len(calls) == (2 if aniso else 1)
    monkeypatch.setattr(tlabels, "discover_rois_clouds",
                        lambda *a: native_pass(*a)[:3] + (None,))
    labs2, vals2 = runner.run(intens, labels)
    np.testing.assert_array_equal(labs, labs2)
    np.testing.assert_array_equal(vals.view(np.uint64),
                                  vals2.view(np.uint64))
