"""The PyTorch port's 3D path end to end through Nyxus3D and VolumeRunner
(the request *3D_ALL*: 213 columns, the eight device families and the host
surface family), against the JAX package's VolumeRunner on the same volume
in f64 on the CPU, and against the reference binary's own CSV; the two
packages' Nyxus3D configurations; and the ROI buckets sharded over
several devices (n_devices), equal to the one-device rows.  The run modes, oversized ROIs and the file protocol are held
against JAX in tests/test_torch_3d_modes_jax.py,
tests/test_torch_3d_aniso_jax.py, tests/test_torch_oversized3d_jax.py,
tests/test_torch_3d_files_jax.py and tests/test_torch_3d_layout_jax.py.  The
comparisons with JAX's VolumeRunner run in two files of their own,
tests/test_torch_3d_default_jax.py and tests/test_torch_3d_configs_jax.py,
which import the helpers below.

Volumes: the reference fixture's (tests/test_oversized._blob3d(seed=4,
shape=(48, 56, 60)), intensities % 59 + 1; two ROIs, buckets 8^3 and 64^3)
at the default configuration, whose GLRLM/GLSZM/GLDM/NGTDM keep raw levels
and whose NGTDM is zero; and conftest.make_blobs3d at the binned
configuration of tests/test_texture3d.py (grey depth 64 for the four
families, 3ngtdm/radius 1).

Against JAX: rtol 1e-9, except the members that go through fast_log2 (rtol
5e-7, the JAX runner's fast_log2 being FMA-contracted by XLA).  Against the
reference CSV: test_config_parity's p90 relative error <= 1e-4 on every
comparable column, no exclusions."""

import dataclasses
import gzip
import os
import sys

import numpy as np
import pandas as pd
import pytest

from test_oversized import _blob3d

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import nyxus_tpu  # noqa: E402
from nyxus_tpu import columns as jcol  # noqa: E402
from nyxus_tpu import taxonomy as jtx  # noqa: E402
from nyxus_tpu.config import EngineConfig as JConfig  # noqa: E402
from nyxus_tpu.pipeline.runner3d import VolumeRunner as JRunner  # noqa: E402

import nyxus_tpu_torch  # noqa: E402
from nyxus_tpu_torch import taxonomy as ttx  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig as TConfig  # noqa: E402
from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FEATURES = ["*3D_ALL*"]
ENTROPY = ("ENTRO", "_JE", "_RE", "_ZE", "_DE", "INFOMEAS", "_ZDE", "DCENT")
BINNED = dict(d3_glrlm_greydepth=64, d3_glszm_greydepth=64,
              d3_gldm_greydepth=64, d3_ngtdm_greydepth=64, d3_ngtdm_radius=1)


def _fixture_volume():
    intens, labels = _blob3d(seed=4, shape=(48, 56, 60))
    return (intens % 59 + 1).astype(np.uint16), labels


def _jax_run(intens, labels, **cfg):
    fset = jtx.parse_feature_request(FEATURES, dim=3)
    labs, values = JRunner(fset, JConfig(precision="f64", **cfg)).run(
        intens, labels.astype(np.int32))
    cols, _ = jcol.build_header(fset, JConfig(**cfg))
    return labs, values, cols[4:]


def _agree(cols, got, want):
    assert got.shape == want.shape == (got.shape[0], 213)
    bad = []
    for j, c in enumerate(cols):
        tol = 5e-7 if any(t in c for t in ENTROPY) else 1e-9
        if not np.allclose(got[:, j], want[:, j], rtol=tol, atol=1e-300,
                           equal_nan=True):
            bad.append((c, got[:, j], want[:, j]))
    assert not bad, bad[:10]


@pytest.fixture(scope="module")
def fixture_frame():
    """The fixture volume through the port's Nyxus3D on the CPU."""
    intens, labels = _fixture_volume()
    nyx = nyxus_tpu_torch.Nyxus3D(FEATURES, device="cpu", precision="f64")
    return nyx.featurize(intens, labels)


def test_nyxus3d_reference_binary_parity(fixture_frame):
    """The port against the reference binary's *3D_ALL* CSV of the fixture
    volume at test_config_parity's p90 1e-4, no exclusions."""
    ref = pd.read_csv(gzip.open(
        os.path.join(DATA, "ref_3d_48x56x60_seed4.csv.gz"), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    ours = fixture_frame.set_index("ROI_label")
    assert list(ref.index) == list(ours.index)
    failures, checked = [], 0
    for c in ours.columns[4:]:
        if c not in ref.columns:
            continue
        a = ours[c].to_numpy(float)
        b = ref[c].to_numpy(float)
        both = np.isfinite(a) & np.isfinite(b)
        if both.sum() == 0:
            continue
        rel = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), 1e-6)
        p90 = float(np.quantile(rel, 0.9))
        checked += 1
        if p90 > 1e-4:
            failures.append((c, p90))
    assert checked > 200, checked
    assert not failures, failures[:40]


@pytest.mark.parametrize("kw,meta", [
    ({}, ()),
    ({"coarse_gray_depth": 32, "anisotropy_z": 1.0, "ram_limit": 512,
      "pixels_per_micron": 2.5, "neighbor_distance": 3}, ()),
    ({}, ("3glcm/greydepth=16", "3glcm/offset=2", "3ngtdm/radius=2",
          "3gldm/greydepth=8", "3glrlm/greydepth=12", "3glszm/greydepth=10",
          "3ngtdm/greydepth=4")),
])
def test_config_equals_jax(kw, meta):
    """Both packages' Nyxus3D build the same EngineConfig from the same
    keywords and 3D metaparameters, and read the metaparameters back
    alike."""
    j = nyxus_tpu.Nyxus3D(FEATURES, **kw)
    t = nyxus_tpu_torch.Nyxus3D(FEATURES, device="cpu", **kw)
    for m in meta:
        j.set_metaparam(m)
        t.set_metaparam(m)
    assert dataclasses.asdict(j.cfg) == dataclasses.asdict(t.cfg)
    for m in meta:
        name = m.split("=")[0]
        assert j.get_metaparam(name) == t.get_metaparam(name), name
    assert j.get_params() == t.get_params()
    assert j.header == t.header and len(t.header) - 4 == 213


def test_set_params_and_prep():
    t = nyxus_tpu_torch.Nyxus3D(FEATURES, device="cpu")
    t.set_params(coarse_gray_depth=16, features=["*3D_GLCM*"])
    j = nyxus_tpu.Nyxus3D(FEATURES)
    j.set_params(coarse_gray_depth=16, features=["*3D_GLCM*"])
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    assert t.header == j.header
    vol = np.asarray([[[-3.5, 0.25], [2.0, 7.9]]])
    np.testing.assert_array_equal(t._prep(vol), j._prep(vol))


@pytest.mark.parametrize("mode", ["n_devices"])
def test_unported_modes_raise(mode):
    """Sharding over several cards, the last mode the port lacked, is
    served: Nyxus3D(n_devices=4) splits each voxel bucket into 4 shards on
    the CPU, and its *3D_ALL* rows equal the one-device rows in f64."""
    ctor = {"n_devices": {"n_devices": 4}}[mode]
    intens, labels = _blob3d(seed=4, shape=(20, 24, 16))
    one = nyxus_tpu_torch.Nyxus3D(FEATURES, device="cpu", precision="f64")
    many = nyxus_tpu_torch.Nyxus3D(FEATURES, device="cpu", precision="f64",
                                   **ctor)
    assert len(many._runner.devices) == 4
    a, b = one.featurize(intens, labels), many.featurize(intens, labels)
    assert len(a) >= 2 and len(a.columns) == 217
    pd.testing.assert_frame_equal(b, a, check_exact=False, rtol=1e-12,
                                  atol=1e-12)


def test_empty_volume():
    nyx = nyxus_tpu_torch.Nyxus3D(FEATURES, device="cpu", precision="f64")
    df = nyx.featurize(np.ones((8, 8, 8)), np.zeros((8, 8, 8), np.int32))
    assert len(df) == 0 and len(df.columns) == 217


def test_chip_smoke_blob3d_copy():
    """chip_smoke's copy of the fixture volume generator (it cannot import
    the tests) makes the same volume."""
    for seed, shape in ((4, (48, 56, 60)), (1, (20, 24, 16))):
        a = _blob3d(seed=seed, shape=shape)
        b = chip_smoke.blob3d(seed=seed, shape=shape)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_chip_smoke_3d_tiers():
    """chip_smoke gives a 3D column its 2D twin's tier and skips the same
    order statistics: every *3D_ALL* column has the tier of its name
    without the leading 3 (3KURTOSIS 2e-2, not the default 2e-3), and
    3MEDIAN, 3P90 and 3MODE are skipped however far off they are."""
    fset = ttx.parse_feature_request(FEATURES, dim=3)
    from nyxus_tpu_torch import columns as tcol
    cols = tcol.build_header(fset, TConfig())[0][4:]
    for c in cols:
        assert chip_smoke.tol_for(c) == chip_smoke.tol_for(c[1:]), c
    assert chip_smoke.tol_for("3KURTOSIS") == 2e-2
    assert chip_smoke.tol_for("3GLCM_ASM") == 5e-3
    dev = np.ones((3, len(cols)))
    ref = np.ones((3, len(cols)))
    skipped = [j for j, c in enumerate(cols)
               if c in ("3MEDIAN", "3P90", "3MODE", "3P01")]
    assert len(skipped) == 4
    dev[:, skipped] = 5.0
    assert chip_smoke.compare_tiers(cols, dev, ref)[0] == []
    dev[:, cols.index("3KURTOSIS")] = 1.01
    assert chip_smoke.compare_tiers(cols, dev, ref)[0] == []
    dev[:, cols.index("3KURTOSIS")] = 1.03
    assert [c for c, _ in chip_smoke.compare_tiers(cols, dev, ref)[0]] == \
        ["3KURTOSIS"]


# ---------------------------------------------------------------------------
# IBSI mode and preserve_hu on the fixture volume


def _reference_parity_3d(name, ours, skip_prefixes=()):
    """(columns checked, failures) against a reference CSV at
    test_config_parity's p90 1e-4."""
    ref = pd.read_csv(gzip.open(os.path.join(DATA, name), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    assert list(ref.index) == list(ours.index)
    failures, checked = [], 0
    for c in ours.columns:
        if c not in ref.columns or c.startswith(skip_prefixes):
            continue
        a = ours[c].to_numpy(float)
        b = ref[c].to_numpy(float)
        both = np.isfinite(a) & np.isfinite(b)
        if both.sum() == 0:
            continue
        rel = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), 1e-6)
        p90 = float(np.quantile(rel, 0.9))
        checked += 1
        if p90 > 1e-4:
            failures.append((c, p90))
    return checked, failures


@pytest.fixture(scope="module")
def ibsi_volume_frame():
    intens, labels = _fixture_volume()
    nyx = nyxus_tpu_torch.Nyxus3D(FEATURES, device="cpu", precision="f64",
                                  ibsi=True)
    return nyx.featurize(intens, labels)


def test_nyxus3d_ibsi_reference_parity(ibsi_volume_frame):
    """IBSI *3D_ALL* against ref_3d_ibsi_48x56x60_seed4 (the binary's
    --ibsi=true) at p90 1e-4: every comparable column, at least 150."""
    ours = ibsi_volume_frame.set_index("ROI_label").iloc[:, 3:]
    checked, failures = _reference_parity_3d(
        "ref_3d_ibsi_48x56x60_seed4.csv.gz", ours)
    assert not failures, failures[:40]
    assert checked >= 150, checked


def test_preserve_hu_3d_reference_parity():
    """*3D_ALL* under preserve_hu on an int16 HU-like volume against
    ref_3d_hu_48x56x60_seed4 (the NIfTI loader's floored-minimum offset, as
    test_config_parity.test_3d_hu_reference_binary_parity applies it): 211
    columns, the hull members skipped (the binary's per-plane hull)."""
    intens, labels = _blob3d(seed=4, shape=(48, 56, 60))
    hu = ((intens.astype(np.int64) % 59) * 30 - 900).astype(np.int16)
    off = np.floor(hu.min())
    vol = np.maximum(np.round(hu - off), 0).astype(np.uint16)
    fset = ttx.parse_feature_request(FEATURES, dim=3)
    cfg = TConfig(precision="f64", preserve_hu=True)
    labs, values = VolumeRunner(fset, cfg, "cpu").run(
        vol, labels.astype(np.int32))
    from nyxus_tpu_torch import columns as tcol
    ours = pd.DataFrame(values, columns=tcol.build_header(fset, cfg)[0][4:],
                        index=labs)
    checked, failures = _reference_parity_3d(
        "ref_3d_hu_48x56x60_seed4.csv.gz", ours,
        skip_prefixes=("3MESH_VOLUME", "3VOLUME_CONVEXHULL"))
    assert not failures, failures[:40]
    assert checked == 211, checked
