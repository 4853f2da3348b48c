"""The PyTorch port's VolumeRunner at the binned configuration and in IBSI
mode against the JAX package's on conftest.make_blobs3d, in f64 on the
CPU, at tests/test_torch_3d.py's tolerances.  A file of its own, so that
pytest-xdist's ``--dist loadfile`` runs these JAX references on another
worker than the reference-CSV tests; the shared helpers live in
tests/test_torch_3d.py."""

import numpy as np

from conftest import make_blobs3d

from nyxus_tpu_torch import taxonomy as ttx
from nyxus_tpu_torch.config import EngineConfig as TConfig
from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner

from test_torch_3d import BINNED, FEATURES, _agree, _jax_run
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)


def test_volume_runner_binned_config_equals_jax():
    """VolumeRunner at the binned configuration (K16's NGTDM window at
    radius 1) equals JAX's on every column of conftest.make_blobs3d."""
    intens, labels = make_blobs3d()
    labs, want, cols = _jax_run(intens, labels, **BINNED)
    fset = ttx.parse_feature_request(FEATURES, dim=3)
    tlabs, got = VolumeRunner(fset, TConfig(precision="f64", **BINNED),
                              device="cpu").run(intens,
                                                labels.astype(np.int32))
    assert list(tlabs) == list(labs)
    _agree(cols, got, want)
    ngtdm = [j for j, c in enumerate(cols) if c.startswith("3NGTDM_")]
    assert np.isfinite(got[:, ngtdm]).all() and got[:, ngtdm].any()


def test_volume_runner_ibsi_equals_jax():
    """IBSI *3D_ALL* (raw levels for every texture family, the matrices
    sized by the volume's power-of-two ceiling, NGLDM's raw levels) equals
    JAX's VolumeRunner on all 213 columns of conftest.make_blobs3d with
    intensities % 59 + 1 (the fixture volume's 64^3 bucket takes the JAX
    package ~16 GB in IBSI mode)."""
    intens, labels = make_blobs3d()
    intens = (intens % 59 + 1).astype(np.uint16)
    labs, want, cols = _jax_run(intens, labels, ibsi=True)
    fset = ttx.parse_feature_request(FEATURES, dim=3, ibsi=True)
    tl, got = VolumeRunner(fset, TConfig(precision="f64", ibsi=True),
                           "cpu").run(intens, labels.astype(np.int32))
    np.testing.assert_array_equal(tl, labs)
    _agree(cols, got, want)
