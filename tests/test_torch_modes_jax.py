"""The port's 2D run modes against the JAX package's, in f64 on the CPU:
``mergerois``, whole-slide mode (the mask directory left out) and
anisotropy (1.4 x 0.75, and 1.25 x 1.5, above 1 on both axes), each
through ``Nyxus.featurize_directory`` in memory and tile-streamed
(``ram_limit=1``: the 200 x 184 slide is over the RAM gate, and its
whole-slide bucket of 256² still fits the 1 MB batch budget), on one TIFF
pair written by libtiff (the JAX package's writer); the anisotropic cases
run from tests/test_torch_modes_aniso_jax.py, so that ``--dist loadfile``
gives their JAX references a worker of their own.  rtol 1e-9 (atol
1e-12), 5e-7 for the fast_log2 entropies, NaN in the same places, the
first central moments (zero by construction) by absolute size.  A
whole-slide or merged ROI over the batch budget takes the oversized path
(phase 3), as JAX's does, and equals it.  The request is narrower than *ALL*
(tests/test_torch_modes_all_jax.py holds *ALL* under anisotropy against
JAX) but takes the device families, a texture with entropies, the
contours and host geometry, and the weighted moments' contour distances."""

import os
import sys

import numpy as np
import pytest

from conftest import make_blobs

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import nyxus_tpu
from nyxus_tpu import native as jnative
from nyxus_tpu import taxonomy as jtx
from nyxus_tpu.config import EngineConfig as JConfig
from nyxus_tpu.pipeline.runner import PairRunner as JRunner

import nyxus_tpu_torch
from nyxus_tpu_torch import columns as tcol
from nyxus_tpu_torch import taxonomy as ttx
from nyxus_tpu_torch.config import EngineConfig as TConfig
from nyxus_tpu_torch.pipeline.runner import PairRunner

from test_torch_slice import _compare_all
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)

FEATS = ["*ALL_INTENSITY*", "*ALL_MORPHOLOGY*", "*ALL_GLCM*",
         "WEIGHTED_HU_M1", "EDGE_MEAN_INTENSITY", "ROI_RADIUS_MEAN"]
SHAPE = (200, 184)
MODES = {"mergerois": {"mergerois": True},
         "wholeslide": {},
         "aniso_1.4x0.75": {"anisotropy_x": 1.4, "anisotropy_y": 0.75},
         "aniso_1.25x1.5": {"anisotropy_x": 1.25, "anisotropy_y": 1.5}}
# the modes of this file; tests/test_torch_modes_aniso_jax.py runs the
# anisotropic ones on a worker of their own
FILE_MODES = ("mergerois", "wholeslide")


@pytest.fixture(scope="module")
def tiff_dirs(tmp_path_factory):
    """One 200 x 184 pair (over the RAM gate at ram_limit=1), the
    intensities tiled LZW, a ROI on the slide's border."""
    root = tmp_path_factory.mktemp("modes")
    for d in ("int", "seg"):
        (root / d).mkdir()
    intens, labels = bench.make_dsb_like(*SHAPE, n_blobs=16, seed=21)
    labels[:3, 40:90] = labels.max() + 1
    jnative.write_tiff(str(root / "int" / "p0.tif"),
                       intens.astype(np.uint16), tile_size=64)
    jnative.write_tiff(str(root / "seg" / "p0.tif"), labels.astype(np.uint16))
    return str(root / "int"), str(root / "seg")


@pytest.mark.parametrize("ram_limit", [None, 1],
                         ids=["in-memory", "streamed"])
@pytest.mark.parametrize("mode", FILE_MODES)
def test_mode_equals_jax(tiff_dirs, mode, ram_limit):
    mode_equals_jax(tiff_dirs, mode, ram_limit)


def mode_equals_jax(tiff_dirs, mode, ram_limit):
    int_dir, seg_dir = tiff_dirs
    if mode == "wholeslide":
        seg_dir = int_dir
    kw = dict(MODES[mode], precision="f64")
    if ram_limit:
        kw["ram_limit"] = ram_limit
    want = nyxus_tpu.Nyxus(FEATS, **kw).featurize_directory(int_dir, seg_dir)
    nyx = nyxus_tpu_torch.Nyxus(FEATS, device="cpu", **kw)
    assert nyx._stream_gate(SHAPE) == bool(ram_limit)
    calls = {"run": 0, "run_streamed": 0}
    for meth in calls:
        fn = getattr(nyx._runner, meth)

        def counted(*a, _fn=fn, _m=meth, **k):
            calls[_m] += 1
            return _fn(*a, **k)
        setattr(nyx._runner, meth, counted)
    got = nyx.featurize_directory(int_dir, seg_dir)
    assert calls == ({"run": 0, "run_streamed": 1} if ram_limit
                     else {"run": 1, "run_streamed": 0})
    assert list(got.columns) == list(want.columns)
    for c in want.columns[:4]:
        assert list(got[c]) == list(want[c]), c
    if mode in ("mergerois", "wholeslide"):
        assert list(got.ROI_label) == [1]
    else:
        assert len(got) >= 15
    cols = list(want.columns[4:])
    _compare_all(cols, want[cols].to_numpy(float), got[cols].to_numpy(float))


def test_wholeslide_box_and_contour():
    """Whole-slide mode's one ROI: the inclusive 0..W, 0..H box (W + 1 by H
    + 1) and the four-corner contour at the slide max."""
    intens, _ = make_blobs(64, 80, 3, seed=5)
    fset = ttx.parse_feature_request(
        ["BBOX_WIDTH", "BBOX_HEIGHT", "PERIMETER", "EDGE_MAX_INTENSITY",
         "EDGE_MIN_INTENSITY", "MAX"])
    runner = PairRunner(fset, TConfig(precision="f64"), device="cpu")
    labs, v = runner.run(intens, np.ones_like(intens, np.uint32),
                         wholeslide=True)
    assert list(labs) == [1]
    row = dict(zip(tcol.build_header(fset, TConfig())[0][4:], v[0]))
    assert (row["BBOX_WIDTH"], row["BBOX_HEIGHT"]) == (81, 65)
    assert row["PERIMETER"] == pytest.approx(2 * (80 + 64))
    assert row["EDGE_MAX_INTENSITY"] == row["EDGE_MIN_INTENSITY"] \
        == row["MAX"] == intens.max()


@pytest.mark.parametrize("mode", ["wholeslide", "mergerois"])
def test_oversized_mode_roi_raises(tmp_path, mode):
    """A 600² whole-slide ROI at ram_limit=1 (bucket 1024², 16 MB) takes
    the streamed run and its phase-3 pass; a dense slide's merged ROI takes
    phase 3 in memory.  Both, which the port once refused, equal JAX's."""
    intens, labels = make_blobs(600, 600, 40, seed=2)
    if mode == "wholeslide":
        (tmp_path / "int").mkdir()
        jnative.write_tiff(str(tmp_path / "int" / "big.tif"),
                           intens.astype(np.uint16), tile_size=128)
        kw = dict(precision="f64", ram_limit=1)
        want = nyxus_tpu.Nyxus(FEATS, **kw).featurize_directory(
            str(tmp_path / "int"))
        nyx = nyxus_tpu_torch.Nyxus(FEATS, device="cpu", **kw)
        assert nyx._stream_gate(intens.shape)
        got = nyx.featurize_directory(str(tmp_path / "int"))
        assert list(got.columns) == list(want.columns)
        assert list(got.ROI_label) == list(want.ROI_label) == [1]
        cols = list(want.columns[4:])
        _compare_all(cols, want[cols].to_numpy(float),
                     got[cols].to_numpy(float))
        return
    jl, jv = JRunner(jtx.parse_feature_request(FEATS),
                     JConfig(precision="f64", mergerois=True,
                             ram_limit_mb=1)).run(intens, labels)
    fset = ttx.parse_feature_request(FEATS)
    runner = PairRunner(fset, TConfig(precision="f64", mergerois=True,
                                      ram_limit_mb=1), device="cpu")
    tl, tv = runner.run(intens, labels)
    assert list(tl) == list(jl) == [1]
    _compare_all(tcol.build_header(fset, TConfig())[0][4:], jv, tv)