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
from nyxus_tpu.pipeline.runner import PairRunner as JRunner

import nyxus_tpu_torch
from nyxus_tpu_torch import taxonomy as ttx
from nyxus_tpu_torch.config import EngineConfig as TConfig
from nyxus_tpu_torch.pipeline.runner import PairRunner as TRunner

from test_torch_slice import (ALL_GROUPS, FEATURES, FEATURES_ALL, GROUPS,
                              WIDTH, WIDTH_ALL, _compare, _compare_all,
                              _port_runner)


@pytest.fixture(scope="module")
def blob_runs():
    intens, labels = make_blobs()
    cfg = JConfig(precision="f64")
    fset = jtx.parse_feature_request(FEATURES)
    jl, jv = JRunner(fset, cfg).run(intens, labels)
    tl, tv = _port_runner().run(intens, labels)
    hdr, _ = jcol.build_header(fset, cfg)
    return hdr[4:], (jl, jv), (tl, tv)


@pytest.mark.parametrize("group", list(GROUPS))
def test_pair_runner_vs_jax(blob_runs, group):
    cols, (jl, jv), (tl, tv) = blob_runs
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
    intens, labels = make_blobs()
    want = nyxus_tpu.Nyxus(FEATURES, precision="f64").featurize(intens, labels)
    got = nyxus_tpu_torch.Nyxus(FEATURES, device="cpu",
                                precision="f64").featurize(intens, labels)
    assert list(got.columns) == list(want.columns)
    assert len(got.columns) == 4 + WIDTH
    np.testing.assert_array_equal(got["ROI_label"].to_numpy(),
                                  want["ROI_label"].to_numpy())
    assert (got["intensity_image"] == want["intensity_image"]).all()
    cols = list(want.columns[4:])
    _compare(cols, want[cols].to_numpy(float), got[cols].to_numpy(float))


@pytest.fixture(scope="module")
def all_runs():
    """The 747-column request on a 160 x 160 slide of 20 ROIs."""
    intens, labels = make_blobs(160, 160, 20, seed=0)
    cfg = JConfig(precision="f64")
    fset = jtx.parse_feature_request(FEATURES_ALL)
    jl, jv = JRunner(fset, cfg).run(intens, labels)
    tl, tv = TRunner(ttx.parse_feature_request(FEATURES_ALL),
                     TConfig(precision="f64"), device="cpu").run(intens,
                                                                 labels)
    hdr, _ = jcol.build_header(fset, cfg)
    return hdr[4:], (jl, jv), (tl, tv)


@pytest.mark.parametrize("group", list(ALL_GROUPS))
def test_all_but_gabor_zernike_vs_jax(all_runs, group):
    cols, (jl, jv), (tl, tv) = all_runs
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
    intens, labels = make_blobs(160, 160, 20, seed=0)
    want = nyxus_tpu.Nyxus(FEATURES_ALL, precision="f64").featurize(intens,
                                                                     labels)
    got = nyxus_tpu_torch.Nyxus(FEATURES_ALL, device="cpu",
                                precision="f64").featurize(intens, labels)
    assert list(got.columns) == list(want.columns)
    assert len(got.columns) == 4 + WIDTH_ALL
    cols = list(want.columns[4:])
    w, g = want[cols].to_numpy(float), got[cols].to_numpy(float)
    assert np.isfinite(g).all()
    _compare_all(cols, w, g)
