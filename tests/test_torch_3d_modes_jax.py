"""The port's 3D run modes against the JAX package's VolumeRunner, in f64
on the CPU, *3D_ALL* (213 columns): whole-volume mode (the one vROI over
the one-past box, binned against the slide range), ``mergerois`` and 3D
anisotropy along z alone (1.5).  tests/test_torch_3d_aniso_jax.py holds
anisotropy in x and y (1.4 x 0.75) and in x, y and z (1.4 x 1.2 x 1.5)
the same way, so that ``--dist loadfile`` gives those JAX references a
worker of their own.

Volume: tests/test_oversized._blob3d(seed=4) at 20 x 24 x 28, intensities
% 59 + 1: an ellipsoid ROI (label 3) and a 4³ cube (label 1).  Each mode
runs once on each side (a module-level cache); each test holds one
family's columns.  rtol 1e-9 (atol 1e-12), 5e-7 for the members that go
through fast_log2 (the JAX runner's is FMA-contracted by XLA), NaN in the
same places, the labels equal."""

import functools

import numpy as np
import pytest

from test_oversized import _blob3d

from nyxus_tpu import columns as jcol
from nyxus_tpu import taxonomy as jtx
from nyxus_tpu.config import EngineConfig as JConfig
from nyxus_tpu.pipeline.runner3d import VolumeRunner as JRunner

from nyxus_tpu_torch import columns as tcol
from nyxus_tpu_torch import taxonomy as ttx
from nyxus_tpu_torch.config import EngineConfig as TConfig
from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

FEATURES = ["*3D_ALL*"]
# the families of *3D_ALL*, each a test's columns
FAMILIES = ["*3D_ALL_INTENSITY*", "*3D_ALL_MORPHOLOGY*", "*3D_GLCM*",
            "*3D_GLRLM*", "*3D_GLSZM*", "*3D_GLDZM*", "*3D_GLDM*",
            "*3D_NGLDM*", "*3D_NGTDM*"]
ENTROPY = ("ENTRO", "_JE", "_RE", "_ZE", "_DE", "INFOMEAS", "_ZDE", "DCENT")
# run mode -> (EngineConfig keywords, whole-volume)
MODES = {
    "wholevolume": ({}, True),
    "mergerois": ({"mergerois": True}, False),
    "aniso_z": ({"aniso_z": 1.5}, False),
    "aniso_xy": ({"aniso_x": float(np.float32(1.4)),
                  "aniso_y": float(np.float32(0.75))}, False),
    "aniso_xyz": ({"aniso_x": float(np.float32(1.4)),
                   "aniso_y": float(np.float32(1.2)),
                   "aniso_z": 1.5}, False),
}
FILE_MODES = ("wholevolume", "mergerois", "aniso_z")


def small_volume():
    intens, labels = _blob3d(seed=4, shape=(20, 24, 28))
    return (intens % 59 + 1).astype(np.uint16), labels


def family_columns(cols, family):
    """Indices into ``cols`` (a *3D_ALL* header's value columns) of one
    family group's columns."""
    fam = tcol.build_header(ttx.parse_feature_request([family], dim=3),
                            TConfig())[0][4:]
    idx = [cols.index(c) for c in fam]
    assert idx, family
    return idx


def agree(cols, got, want):
    """rtol 1e-9 (atol 1e-12), 5e-7 for the fast_log2 entropies, NaN in
    the same places."""
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for j, c in enumerate(cols):
        tol = 5e-7 if any(t in c for t in ENTROPY) else 1e-9
        np.testing.assert_allclose(got[:, j], want[:, j], rtol=tol,
                                   atol=1e-12, equal_nan=True, err_msg=c)


def run_both(intens, labels, cfg, wholeslide=False, features=FEATURES,
             ibsi=False):
    """(columns, labels, port values, JAX values) of one volume pair through
    both packages' VolumeRunner in f64, the port on the CPU."""
    jf = jtx.parse_feature_request(features, dim=3, ibsi=ibsi)
    tf = ttx.parse_feature_request(features, dim=3, ibsi=ibsi)
    jl, jv = JRunner(jf, JConfig(precision="f64", **cfg)).run(
        intens, labels, wholeslide=wholeslide)
    tl, tv = VolumeRunner(tf, TConfig(precision="f64", **cfg),
                          device="cpu").run(intens, labels,
                                            wholeslide=wholeslide)
    np.testing.assert_array_equal(tl, jl)
    cols = jcol.build_header(jf, JConfig(**cfg))[0][4:]
    assert cols == tcol.build_header(tf, TConfig(**cfg))[0][4:]
    return cols, tl, tv, jv


@functools.lru_cache(maxsize=None)
def mode_run(mode):
    cfg, whole = MODES[mode]
    intens, labels = small_volume()
    if whole:
        labels = np.ones_like(labels)
    return run_both(intens, labels, cfg, wholeslide=whole)


def mode_family_agrees(mode, family):
    cols, labs, got, want = mode_run(mode)
    assert got.shape == (len(labs), 213)
    if mode in ("wholevolume", "mergerois"):
        assert list(labs) == [1]
    else:
        assert list(labs) == [1, 3]
    idx = family_columns(cols, family)
    agree([cols[j] for j in idx], got[:, idx], want[:, idx])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mode", FILE_MODES)
def test_mode_equals_jax(mode, family):
    mode_family_agrees(mode, family)


def test_wholevolume_box_and_bins():
    """Whole-volume mode's one record is the one-past box 0..D x 0..H x
    0..W binned against 0 .. slide max - slide min, and its surface is the
    box's (analytic areas, zero axes), as in the JAX package."""
    cols, _, got, want = mode_run("wholevolume")
    area = got[0, cols.index("3AREA")]
    assert area == 2.0 * (29 * 25 + 25 * 21 + 29 * 21)
    assert got[0, cols.index("3MAJOR_AXIS_LEN")] == 0.0
    assert want[0, cols.index("3AREA")] == area
