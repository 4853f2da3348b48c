"""The port's anisotropic run mode against the JAX package's, in f64 on
the CPU: ``anisotropy_x`` / ``anisotropy_y`` 1.4 x 0.75 and 1.25 x 1.5
(above 1 on both axes) through ``Nyxus.featurize_directory``, in memory
and tile-streamed, at tests/test_torch_modes_jax.py's request, slide and
tolerances.  A file of its own, so that ``--dist loadfile`` gives these
JAX references a worker of their own."""

import pytest

from test_torch_modes_jax import MODES, mode_equals_jax, tiff_dirs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)


@pytest.mark.parametrize("ram_limit", [None, 1],
                         ids=["in-memory", "streamed"])
@pytest.mark.parametrize("mode", [m for m in MODES if m.startswith("aniso")])
def test_aniso_equals_jax(tiff_dirs, mode, ram_limit):  # noqa: F811
    mode_equals_jax(tiff_dirs, mode, ram_limit)
