"""The port's whole-slide and anisotropic runs against the reference
binary's own CSVs on the parity slide bench.make_dsb_like(320, 320, 40,
seed=11), in f64 on the CPU, with the JAX package's tests' exclusions and
tolerances imported from them (tests/test_wholeslide_parity.py: the
whole-slide row through ``Nyxus.featurize_directory`` with no mask
directory; tests/test_aniso.py: PairRunner.run at anisotropy 1.4 x 0.75,
the factors narrowed to C float as the reference CLI does)."""

import gzip
import os
import sys

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

import nyxus_tpu_torch  # noqa: E402
from nyxus_tpu_torch import columns as tcol  # noqa: E402
from nyxus_tpu_torch import taxonomy as ttx  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig as TConfig  # noqa: E402
from nyxus_tpu_torch.io.tiff import write_tiff  # noqa: E402
from nyxus_tpu_torch.pipeline.runner import PairRunner  # noqa: E402

import test_aniso as ta  # noqa: E402
import test_wholeslide_parity as tw  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)


@pytest.fixture(scope="module")
def wholeslide(tmp_path_factory):
    base = tmp_path_factory.mktemp("ws")
    intens, _ = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
    write_tiff(str(base / "slide.ome.tif"), intens.astype(np.uint16))
    ref = pd.read_csv(gzip.open(tw.FIXTURE, "rt"))
    ours = nyxus_tpu_torch.Nyxus(["*ALL*"], device="cpu",
                                 precision="f64").featurize_directory(
        str(base), str(base))
    return ref, ours


def test_wholeslide_single_roi(wholeslide):
    ref, ours = wholeslide
    assert len(ours) == 1 and int(ours.ROI_label.iloc[0]) == 1
    assert ours.mask_image.iloc[0] == ""


def test_wholeslide_column_values(wholeslide):
    ref, ours = wholeslide
    checked = 0
    failures = []
    for c in ours.columns[4:]:
        if c not in ref.columns:
            continue
        if c.startswith(tw.EXCLUDE_PREFIXES) or c in tw.EXCLUDE_EXACT:
            continue
        a = float(ours[c].iloc[0])
        b = float(ref[c].iloc[0])
        if not (np.isfinite(a) and np.isfinite(b)):
            continue
        checked += 1
        if abs(a - b) / max(abs(b), 1e-8) > tw.TOL:
            failures.append((c, a, b))
    assert checked > 550, "exclusion list swallowed the test"
    assert not failures, failures[:25]


def test_wholeslide_quirks_explicit(wholeslide):
    """The inclusive 321 x 321 box and the four-corner contour at the
    slide max."""
    row = wholeslide[1].iloc[0]
    assert row.BBOX_WIDTH == 321 and row.BBOX_HEIGHT == 321
    assert row.PERIMETER == pytest.approx(4 * 320)
    assert row.EDGE_MIN_INTENSITY == row.EDGE_MAX_INTENSITY == row["MAX"]
    assert row.EDGE_INTEGRATED_INTENSITY == pytest.approx(4 * row["MAX"])
    assert row.EXTENT == pytest.approx(320 * 320 / 321.0 / 321.0, rel=1e-9)


@pytest.fixture(scope="module")
def aniso():
    ref = pd.read_csv(gzip.open(ta.FIXTURE, "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    intens, labels = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
    cfg = TConfig(precision="f64", aniso_x=float(np.float32(1.4)),
                  aniso_y=float(np.float32(0.75)))
    fset = ttx.parse_feature_request(["*ALL*"])
    labs, values = PairRunner(fset, cfg, device="cpu").run(intens, labels)
    cols, _ = tcol.build_header(fset, cfg)
    ours = pd.DataFrame(values, columns=cols[4:])
    ours["ROI_label"] = labs
    return ref, ours.set_index("ROI_label")


def test_aniso_rows(aniso):
    ref, ours = aniso
    assert list(ref.index) == list(ours.index)


def test_aniso_column_values(aniso):
    ref, ours = aniso
    common = [c for c in ours.columns if c in ref.columns]
    assert len(common) > 700
    checked = 0
    failures = []
    for c in common:
        if ta._excluded(c):
            continue
        a = ours[c].to_numpy(float)
        b = ref[c].to_numpy(float)
        both = np.isfinite(a) & np.isfinite(b)
        if both.sum() == 0:
            continue
        rel = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), 1e-8)
        checked += 1
        if float(np.quantile(rel, 0.9)) > ta.TOL:
            failures.append((c, float(np.quantile(rel, 0.9))))
    assert checked > 350, "exclusion list swallowed the test"
    assert not failures, failures[:25]


def test_aniso_bbox_and_area_semantics(aniso):
    ref, ours = aniso
    for c in ("AREA_PIXELS_COUNT", "BBOX_XMIN", "BBOX_YMIN", "BBOX_WIDTH",
              "BBOX_HEIGHT", "CENTROID_X", "CENTROID_Y", "MEAN", "MIN",
              "MAX", "MEDIAN", "SKEWNESS", "COMPACTNESS",
              "MAJOR_AXIS_LENGTH"):
        a = ours[c].to_numpy(float)
        b = ref[c].to_numpy(float)
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-8)
        assert float(np.quantile(rel, 0.9)) < ta.TOL, c
