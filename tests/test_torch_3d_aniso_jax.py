"""The port's 3D anisotropy against the JAX package's VolumeRunner in x and
y (1.4 x 0.75) and in x, y and z (1.4 x 1.2 x 1.5), in f64 on the CPU, at
tests/test_torch_3d_modes_jax.py's volume, request and tolerances; a file
of its own, so that ``--dist loadfile`` gives these JAX references a
worker of their own."""

import pytest

from test_torch_3d_modes_jax import FAMILIES, mode_family_agrees
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mode", ["aniso_xy", "aniso_xyz"])
def test_aniso_equals_jax(mode, family):
    mode_family_agrees(mode, family)
