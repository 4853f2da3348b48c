"""The PyTorch port's Nyxus3D at the default configuration (raw levels for
GLRLM/GLSZM/GLDM/NGTDM, NGTDM zero) against the JAX package's VolumeRunner
on the reference fixture volume, in f64 on the CPU, at
tests/test_torch_3d.py's tolerances.  A file of its own, so that
pytest-xdist's ``--dist loadfile`` gives the JAX package's CPU run of the
volume a worker of its own; the shared helpers and the ``fixture_frame``
fixture live in tests/test_torch_3d.py."""

import numpy as np

from nyxus_tpu.config import EngineConfig as JConfig

from test_torch_3d import (_agree, _fixture_volume, _jax_run,  # noqa: F401
                           fixture_frame)
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)


def test_nyxus3d_default_config_equals_jax(fixture_frame):
    """Nyxus3D (raw levels for four families, NGTDM zero) equals JAX's
    VolumeRunner on every one of the 213 columns; the surface columns are
    the same numpy/scipy code on the same voxels, so they are equal."""
    intens, labels = _fixture_volume()
    labs, want, cols = _jax_run(intens, labels)
    noval = JConfig().noval
    want = np.where(np.isfinite(want), want, noval)
    assert list(fixture_frame.columns[4:]) == cols
    assert list(fixture_frame["ROI_label"]) == list(labs)
    got = fixture_frame[cols].to_numpy(np.float64)
    _agree(cols, got, want)
    surf = [j for j, c in enumerate(cols) if c in (
        "3AREA", "3VOLUME_CONVEXHULL", "3MAJOR_AXIS_LEN", "3SPHERICITY")]
    assert len(surf) == 4
    assert np.array_equal(got[:, surf], want[:, surf])
    ngtdm = [j for j, c in enumerate(cols) if c.startswith("3NGTDM_")]
    assert len(ngtdm) == 5 and not got[:, ngtdm].any()
