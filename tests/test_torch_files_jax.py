"""The port's ``Nyxus.featurize_directory`` against the JAX package's on
one directory of make_blobs TIFF pairs written by libtiff (the JAX
package's writer), on the CPU in f64: in memory, and with ``ram_limit=1``
on both sides, so that the port's tile-streamed run meets JAX's.  rtol
1e-9 (atol 1e-12), 5e-7 for the fast_log2 entropies, the name and label
columns equal.  A file of its own, so that ``--dist loadfile`` gives these
JAX references a worker of their own; the request is narrower than *ALL*
(tests/test_torch_slice_jax.py holds *ALL* against JAX) but takes every
path of the file protocol: device families, contours and the host
geometry, the weighted moments' contour distances, and a texture with
entropies."""

import numpy as np
import pytest

from conftest import make_blobs

import nyxus_tpu
from nyxus_tpu import native as jnative

import nyxus_tpu_torch

from test_torch_slice import _compare
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)

FEATS = ["*ALL_INTENSITY*", "*ALL_MORPHOLOGY*", "*ALL_GLSZM*",
         "WEIGHTED_HU_M1", "EDGE_MEAN_INTENSITY", "ROI_RADIUS_MEAN"]


@pytest.fixture(scope="module")
def tiff_dirs(tmp_path_factory):
    """Two 192 x 176 pairs (over the RAM gate at ram_limit=1), tiled LZW
    intensities and stripped Deflate masks, ROIs on the border."""
    root = tmp_path_factory.mktemp("pairs")
    for d in ("int", "seg"):
        (root / d).mkdir()
    for k in range(2):
        intens, labels = make_blobs(192, 176, 7, seed=30 + k)
        labels[:3, 20:70] = 60
        intens[:3, 20:70] = 900 + np.arange(150).reshape(3, 50) * 7
        name = "p%d.ome.tif" % k
        jnative.write_tiff(str(root / "int" / name), intens, tile_size=64)
        jnative.write_tiff(str(root / "seg" / name),
                           labels.astype(np.uint16), compression="deflate")
    return str(root / "int"), str(root / "seg")


@pytest.mark.parametrize("ram_limit", [None, 1],
                         ids=["in-memory", "streamed"])
def test_featurize_directory_equals_jax(tiff_dirs, ram_limit):
    kw = dict(precision="f64")
    if ram_limit:
        kw["ram_limit"] = ram_limit
    want = nyxus_tpu.Nyxus(FEATS, **kw).featurize_directory(*tiff_dirs)
    nyx = nyxus_tpu_torch.Nyxus(FEATS, device="cpu", **kw)
    assert nyx._stream_gate((192, 176)) == bool(ram_limit)
    got = nyx.featurize_directory(*tiff_dirs)
    assert list(got.columns) == list(want.columns)
    for c in want.columns[:4]:
        assert list(got[c]) == list(want[c]), c
    assert len(got) >= 14
    cols = list(want.columns[4:])
    w, g = want[cols].to_numpy(float), got[cols].to_numpy(float)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    _compare(cols, w, g)
