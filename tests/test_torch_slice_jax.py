"""The PyTorch port's slices through PairRunner and Nyxus.featurize against
the JAX package on conftest.make_blobs slides, in f64 on the CPU: the 337
columns of intensity and the seven 2D textures, and the request *ALL* (747
columns), at tests/test_torch_slice.py's tolerances.  A file of its own, so
that pytest-xdist's ``--dist loadfile`` runs these JAX references on
another worker than the reference-CSV tests; the shared helpers live in
tests/test_torch_slice.py."""

import numpy as np
import pytest

from conftest import make_blobs

import nyxus_tpu
from nyxus_tpu import columns as jcol
from nyxus_tpu import taxonomy as jtx
from nyxus_tpu.config import EngineConfig as JConfig

import nyxus_tpu_torch

from test_torch_slice import (ALL_GROUPS, FEATURES, FEATURES_ALL, GROUPS,
                              WIDTH, WIDTH_ALL, _compare, _compare_all)
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)


def _featurize_runs(nyx, intens, labels):
    """(the PairRunner.run output, the frame) of one ``nyx.featurize`` call:
    each package's runner runs once, and its output serves both the
    runner-level and the frame-level comparisons."""
    runs = []
    run = nyx._runner.run

    def spy(*args, **kw):
        runs.append(run(*args, **kw))
        return runs[-1]
    nyx._runner.run = spy
    frame = nyx.featurize(intens, labels)
    assert len(runs) == 1
    return runs[0], frame


@pytest.fixture(scope="module")
def blob_runs():
    """The slice on make_blobs() through each package's Nyxus.featurize (its
    PairRunner in f64; the API's config differs from a bare EngineConfig
    only in xyres, which no feature reads)."""
    intens, labels = make_blobs()
    (jl, jv), want = _featurize_runs(
        nyxus_tpu.Nyxus(FEATURES, precision="f64"), intens, labels)
    (tl, tv), got = _featurize_runs(
        nyxus_tpu_torch.Nyxus(FEATURES, device="cpu", precision="f64"),
        intens, labels)
    hdr, _ = jcol.build_header(jtx.parse_feature_request(FEATURES),
                               JConfig(precision="f64"))
    return hdr[4:], (jl, jv), (tl, tv), (want, got)


@pytest.mark.parametrize("group", list(GROUPS))
def test_pair_runner_vs_jax(blob_runs, group):
    cols, (jl, jv), (tl, tv), _ = blob_runs
    assert len(cols) == WIDTH
    np.testing.assert_array_equal(tl, jl)
    sel = [j for j, c in enumerate(cols) if GROUPS[group](c)]
    assert sel
    _compare([cols[j] for j in sel], jv[:, sel], tv[:, sel])


def test_every_column_in_a_group(blob_runs):
    cols = blob_runs[0]
    assert sum(any(g(c) for g in GROUPS.values()) for c in cols) == len(cols)
    assert all(sum(g(c) for g in GROUPS.values()) == 1 for c in cols)


def test_nyxus_featurize_frame(blob_runs):
    want, got = blob_runs[3]
    assert list(got.columns) == list(want.columns)
    assert len(got.columns) == 4 + WIDTH
    np.testing.assert_array_equal(got["ROI_label"].to_numpy(),
                                  want["ROI_label"].to_numpy())
    assert (got["intensity_image"] == want["intensity_image"]).all()
    cols = list(want.columns[4:])
    _compare(cols, want[cols].to_numpy(float), got[cols].to_numpy(float))


@pytest.fixture(scope="module")
def all_runs():
    """The 747-column request on a 160 x 160 slide of 20 ROIs, through each
    package's Nyxus.featurize as blob_runs."""
    intens, labels = make_blobs(160, 160, 20, seed=0)
    (jl, jv), want = _featurize_runs(
        nyxus_tpu.Nyxus(FEATURES_ALL, precision="f64"), intens, labels)
    (tl, tv), got = _featurize_runs(
        nyxus_tpu_torch.Nyxus(FEATURES_ALL, device="cpu", precision="f64"),
        intens, labels)
    hdr, _ = jcol.build_header(jtx.parse_feature_request(FEATURES_ALL),
                               JConfig(precision="f64"))
    return hdr[4:], (jl, jv), (tl, tv), (want, got)


@pytest.mark.parametrize("group", list(ALL_GROUPS))
def test_all_but_gabor_zernike_vs_jax(all_runs, group):
    cols, (jl, jv), (tl, tv), _ = all_runs
    assert len(cols) == WIDTH_ALL and len(tl) == 20
    np.testing.assert_array_equal(tl, jl)
    sel = [j for j, c in enumerate(cols) if ALL_GROUPS[group](c)]
    assert sel
    _compare_all([cols[j] for j in sel], jv[:, sel], tv[:, sel])
    if group == "moments":
        assert np.isnan(jv[:, sel]).any()


def test_all_but_gabor_zernike_groups_cover_every_column(all_runs):
    cols = all_runs[0]
    assert all(sum(g(c) for g in ALL_GROUPS.values()) == 1 for c in cols)


def test_all_but_gabor_zernike_featurize_frame(all_runs):
    """Nyxus.featurize: the 747 value columns of the JAX package, in its
    order; NaN becomes noval in both (api._force_finite)."""
    want, got = all_runs[3]
    assert list(got.columns) == list(want.columns)
    assert len(got.columns) == 4 + WIDTH_ALL
    cols = list(want.columns[4:])
    w, g = want[cols].to_numpy(float), got[cols].to_numpy(float)
    assert np.isfinite(g).all()
    _compare_all(cols, w, g)
