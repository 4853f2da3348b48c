"""The port's 2.5D layout-A stacks (one 2D slice file a z, grouped by a
``{set d+}`` pattern) through ``Nyxus3D.featurize_directory`` against the
JAX package's, on the CPU in f64: tests/test_io_cli.py's stack in memory
and over the RAM gate (``ram_limit=1``: the port reads the stack a plane
at a time, its oversized ROI through phase 3 included), against JAX's and
against the in-memory ``featurize`` of the stacked volume; and a stack
with negative intensities, which both packages stack whole.  The
tolerances of tests/test_torch_3d_files_jax.py."""

import numpy as np
import pytest

import nyxus_tpu

import nyxus_tpu_torch
from nyxus_tpu_torch.io import readers as treaders
from nyxus_tpu_torch.pipeline import runner3d as trunner3d
from nyxus_tpu_torch.pipeline import sources as tsources

from test_torch_3d_files_jax import FEATS, frames_agree
from test_torch_3d_modes_jax import agree
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)


@pytest.fixture(scope="module")
def layout_a_dirs(tmp_path_factory):
    """tests/test_io_cli.py's over-the-gate stack: 6 slices of 96 x 96, a
    trivial ROI (label 2) and a big one (label 7) that the 1 MB gate makes
    oversized, one TIFF a slice (the port's writer)."""
    root = tmp_path_factory.mktemp("layoutA")
    r = np.random.default_rng(9)
    Z, H, W = 6, 96, 96
    ivol = r.integers(1, 900, (Z, H, W)).astype(np.uint16)
    lvol = np.zeros((Z, H, W), np.uint16)
    lvol[1:4, 8:28, 10:40] = 2
    lvol[0:6, 34:90, 4:88] = 7
    for d, vol in (("int", ivol), ("seg", lvol)):
        (root / d).mkdir()
        for z in range(Z):
            treaders.write_gray(str(root / d / ("vol1_z0%d.tif" % z)), vol[z])
    return str(root / "int"), str(root / "seg"), ivol, lvol


@pytest.mark.parametrize("ram_limit", [None, 1], ids=["in-memory", "lazy"])
def test_layout_a_equals_jax(layout_a_dirs, ram_limit, monkeypatch):
    int_dir, seg_dir, ivol, lvol = layout_a_dirs
    kw = dict(precision="f64")
    if ram_limit:
        kw["ram_limit"] = ram_limit
    pattern = "vol{d+}_z{set d+}.tif"
    want = nyxus_tpu.Nyxus3D(FEATS, **kw).featurize_directory(
        int_dir, seg_dir, file_pattern=pattern)
    runs = []
    run = trunner3d.VolumeRunner.run

    def recording(self, intens, labels, wholeslide=False):
        runs.append(type(intens))
        return run(self, intens, labels, wholeslide)
    monkeypatch.setattr(trunner3d.VolumeRunner, "run", recording)
    nyx = nyxus_tpu_torch.Nyxus3D(FEATS, device="cpu", **kw)
    got = nyx.featurize_directory(int_dir, seg_dir, file_pattern=pattern)
    # over the gate the stack is read a plane at a time, never stacked
    assert runs == [tsources._LazyVol if ram_limit else np.ndarray]
    frames_agree(got, want)
    assert got.ROI_label.tolist() == [2, 7]
    mem = nyxus_tpu_torch.Nyxus3D(FEATS, device="cpu", precision="f64") \
        .featurize([ivol], [lvol])
    cols = list(mem.columns[4:])
    agree(cols, got[cols].to_numpy(float), mem[cols].to_numpy(float))


def test_layout_a_negative_intensities_are_stacked(tmp_path):
    """A lazy stack with negative intensities is stacked whole and shifted,
    as JAX does."""
    ivol = (np.arange(2 * 40 * 40).reshape(2, 40, 40) % 50 - 20).astype(
        np.float32)
    lvol = np.zeros((2, 40, 40), np.uint16)
    lvol[:, 5:30, 5:35] = 3
    for d, vol in (("int", ivol), ("seg", lvol)):
        (tmp_path / d).mkdir()
        for z in range(2):
            treaders.write_gray(str(tmp_path / d / ("s_z%d.tif" % z)), vol[z])
    args = (str(tmp_path / "int"), str(tmp_path / "seg"))
    kw = dict(precision="f64", ram_limit=1)
    got = nyxus_tpu_torch.Nyxus3D(FEATS, device="cpu", **kw) \
        .featurize_directory(*args, file_pattern="s_z{set d+}.tif")
    want = nyxus_tpu.Nyxus3D(FEATS, **kw).featurize_directory(
        *args, file_pattern="s_z{set d+}.tif")
    frames_agree(got, want)
