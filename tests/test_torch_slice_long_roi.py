"""The PyTorch port's 337-column slice against the JAX package on
chip_smoke's long-ROI slide (one 600 x 40 px ROI in a 1024 x 64 bucket
beside small ones), in f64 on the CPU, at tests/test_torch_slice.py's
tolerances.  A file of its own, so that pytest-xdist's ``--dist loadfile``
gives the JAX package's CPU run of that slide a worker of its own; the
shared helpers live in tests/test_torch_slice.py."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nyxus_tpu import columns as jcol  # noqa: E402
from nyxus_tpu import taxonomy as jtx  # noqa: E402
from nyxus_tpu.config import EngineConfig as JConfig  # noqa: E402
from nyxus_tpu.pipeline.runner import PairRunner as JRunner  # noqa: E402

from test_torch_slice import FEATURES, _compare, _port_runner  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)


def test_long_roi_slide_vs_jax():
    """chip_smoke's slide with one 600 x 40 px ROI (bucket 1024 x 64, whose
    GLRLM run matrix at 64 levels is larger than a block's shared memory on
    the card) beside small ones: the slice against the JAX package."""
    import chip_smoke
    intens, labels = chip_smoke.make_long_roi_slide()
    cfg = JConfig(precision="f64")
    fset = jtx.parse_feature_request(FEATURES)
    jl, jv = JRunner(fset, cfg).run(intens, labels)
    tl, tv = _port_runner().run(intens, labels)
    ys, xs = np.nonzero(labels == labels.max())
    assert ys.max() - ys.min() + 1 > 512 and xs.max() - xs.min() + 1 <= 64
    assert len(tl) >= 3
    np.testing.assert_array_equal(tl, jl)
    hdr, _ = jcol.build_header(fset, cfg)
    _compare(hdr[4:], jv, tv)
