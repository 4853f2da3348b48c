"""The request *ALL* (747 columns) under anisotropy (1.4 x 0.75) through
each package's PairRunner.run, in f64 on the CPU, on
tests/test_torch_modes_jax.py's 200 x 184 slide: the virtual slide's
crops, contours and clouds, the physical area and intensity range, the
scaled boxes that BBOX_* report and the centroid and ellipse of k fed
pixels over the physical area n, at tests/test_torch_slice.py's
tolerances.  The one JAX *ALL* run of this module; a file of its own so
that ``--dist loadfile`` gives it a worker of its own."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from nyxus_tpu import columns as jcol  # noqa: E402
from nyxus_tpu import taxonomy as jtx  # noqa: E402
from nyxus_tpu.config import EngineConfig as JConfig  # noqa: E402
from nyxus_tpu.pipeline.runner import PairRunner as JRunner  # noqa: E402

from nyxus_tpu_torch import taxonomy as ttx  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig as TConfig  # noqa: E402
from nyxus_tpu_torch.pipeline.runner import PairRunner as TRunner  # noqa: E402

from test_torch_slice import (ALL_GROUPS, FEATURES_ALL, WIDTH_ALL,  # noqa: E402
                              _compare_all)
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)

ANISO = dict(aniso_x=float(np.float32(1.4)), aniso_y=float(np.float32(0.75)))


@pytest.fixture(scope="module")
def aniso_runs():
    intens, labels = bench.make_dsb_like(200, 184, n_blobs=16, seed=21)
    jl, jv = JRunner(jtx.parse_feature_request(FEATURES_ALL),
                     JConfig(precision="f64", **ANISO)).run(intens, labels)
    tl, tv = TRunner(ttx.parse_feature_request(FEATURES_ALL),
                     TConfig(precision="f64", **ANISO),
                     device="cpu").run(intens, labels)
    hdr, _ = jcol.build_header(jtx.parse_feature_request(FEATURES_ALL),
                               JConfig(precision="f64"))
    return hdr[4:], (jl, jv), (tl, tv)


@pytest.mark.parametrize("group", list(ALL_GROUPS))
def test_aniso_all_columns_vs_jax(aniso_runs, group):
    cols, (jl, jv), (tl, tv) = aniso_runs
    assert len(cols) == WIDTH_ALL and len(tl) >= 15
    np.testing.assert_array_equal(tl, jl)
    sel = [j for j, c in enumerate(cols) if ALL_GROUPS[group](c)]
    assert sel
    _compare_all([cols[j] for j in sel], jv[:, sel], tv[:, sel])


def test_aniso_reports_the_scaled_box(aniso_runs):
    """BBOX_WIDTH / BBOX_HEIGHT are the scaled boxes, not the physical
    ones: wider by about 1.4 and shorter by about 0.75."""
    cols, _, (tl, tv) = aniso_runs
    intens, labels = bench.make_dsb_like(200, 184, n_blobs=16, seed=21)
    w = tv[:, cols.index("BBOX_WIDTH")]
    h = tv[:, cols.index("BBOX_HEIGHT")]
    for lab, wi, hi in zip(tl, w, h):
        ys, xs = np.nonzero(labels == lab)
        assert abs(wi - 1.4 * (xs.max() - xs.min() + 1)) <= 2
        assert abs(hi - 0.75 * (ys.max() - ys.min() + 1)) <= 2
    assert (tv[:, cols.index("AREA_PIXELS_COUNT")]
            == [np.sum(labels == lab) for lab in tl]).all()
