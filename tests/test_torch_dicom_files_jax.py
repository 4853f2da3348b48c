"""The port's DICOM file protocol against the JAX package's, on the CPU
in f64 (tests/test_torch_dicom_jax.py's helpers and tolerances): a
signed int16 tiled pair in memory and at ``ram_limit=1``; a signed slide
shifted without wrapping; the Hounsfield map of tests/test_formats.py:66;
a DICOM intensity with a TIFF mask and a tiled intensity with a
single-frame mask, decoded whole; the CLI over a directory of ``.dcm``
pairs against JAX's CLI file.  A file of its own, so that ``--dist
loadfile`` gives these JAX references a worker of their own."""

import os
import sys

import numpy as np
import pytest

import nyxus_tpu
import nyxus_tpu.cli as jcli

import nyxus_tpu_torch
import nyxus_tpu_torch.cli as tcli
from nyxus_tpu_torch.io import dicom as tdicom
from nyxus_tpu_torch.io import readers as treaders

from test_torch_cli import _read
from test_torch_dicom_jax import dicom_pairs, featurize_pair  # noqa: F401
from test_torch_zarr_jax import FEATS, _pair, frames_equal
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("ram_limit", [None, 1], ids=["in-memory",
                                                      "ram_limit=1"])
def test_tiled_signed_equals_jax(dicom_pairs, ram_limit,  # noqa: F811
                                 monkeypatch):
    """int16 frames spanning -19999..19999, no rescale: streamed at
    ram_limit=1 (negative intensities reach the runner unshifted, as in
    JAX), decoded whole and shifted in memory."""
    featurize_pair(dicom_pairs, "tiled signed", ram_limit, monkeypatch)


def test_signed_shift_does_not_wrap(dicom_pairs):  # noqa: F811
    """An int16 slide spanning more than 32767 (the tiled signed pair's
    intensities, -19999..19999) is shifted to start at 0 as its int32 copy
    is; the JAX package's shift wraps in int16 (its rows of such a slide
    are not its rows of the int32 copy)."""
    seen = dicom_pairs["tiled signed"][2]
    assert seen.dtype == np.int16 and int(seen.max()) - int(seen.min()) > \
        np.iinfo(np.int16).max
    nyx = nyxus_tpu_torch.Nyxus(["MEAN"], device="cpu")
    I, _ = nyx._prep_intensity(seen)
    J, _ = nyx._prep_intensity(seen.astype(np.int32))
    assert I.dtype == J.dtype == np.uint32 and int(I.min()) == 0
    np.testing.assert_array_equal(I, J)
    W, _ = nyxus_tpu.Nyxus(["MEAN"])._prep_intensity(seen)
    assert not np.array_equal(np.asarray(W), I)


def test_hounsfield_prep_intensity(dicom_pairs):  # noqa: F811
    """tests/test_formats.py:66's map: stored + intercept -1024 read as
    int32 HU, which _prep_intensity shifts to start at 0, as JAX's; its
    rows equal featurize's of the shifted array."""
    ip, lp, hu = dicom_pairs["unsigned HU"]
    got = treaders.read_gray(ip)
    assert got.dtype == np.int32 and got.min() < 0
    np.testing.assert_array_equal(got, hu)
    nyx = nyxus_tpu_torch.Nyxus(FEATS, device="cpu", precision="f64")
    I, off = nyx._prep_intensity(got)
    J, joff = nyxus_tpu.Nyxus(FEATS, precision="f64")._prep_intensity(got)
    assert off == joff == 0.0 and I.dtype == J.dtype == np.uint32
    np.testing.assert_array_equal(I, hu - hu.min())
    np.testing.assert_array_equal(np.asarray(J), I)
    a = nyx.featurize_files([ip], [lp])
    b = nyx.featurize(I, _pair()[1])
    np.testing.assert_array_equal(a.iloc[:, 4:].to_numpy(float),
                                  b.iloc[:, 4:].to_numpy(float))


def test_mixed_formats_decode_whole(tmp_path):
    """A DICOM intensity with a TIFF mask (tests/test_formats.py:78) has
    no region source in either format's reader: decoded whole, equal to
    JAX's, also at ram_limit=1; a tiled intensity with a single-frame mask
    is decoded whole too, every frame (JAX's read_gray would give the
    first frame and no pair)."""
    intens = np.zeros((60, 60), np.uint16)
    labels = np.zeros((60, 60), np.uint16)
    intens[5:25, 5:35] = np.arange(600).reshape(20, 30) + 100
    labels[5:25, 5:35] = 2
    ip, lp = str(tmp_path / "i.dcm"), str(tmp_path / "s.tif")
    tdicom.write_dicom_gray(ip, intens)
    treaders.write_gray(lp, labels)
    for kw in ({}, {"ram_limit": 1}):
        got = nyxus_tpu_torch.Nyxus(["MEAN", "MAX", "AREA_PIXELS_COUNT"],
                                    device="cpu", precision="f64",
                                    **kw).featurize_files([ip], [lp])
        want = nyxus_tpu.Nyxus(["MEAN", "MAX", "AREA_PIXELS_COUNT"],
                               precision="f64", **kw).featurize_files([ip],
                                                                      [lp])
        frames_equal(got, want)
        assert got.AREA_PIXELS_COUNT.tolist() == [600]
    big = np.tile(intens, (3, 3))
    tp, sp = str(tmp_path / "t.dcm"), str(tmp_path / "m.dcm")
    tdicom.write_dicom_tiled(tp, big, tile=64)
    tdicom.write_dicom_gray(sp, np.tile(labels, (3, 3)))
    feats = ["MEAN", "MAX", "AREA_PIXELS_COUNT"]
    got = nyxus_tpu_torch.Nyxus(feats, device="cpu", precision="f64",
                                ram_limit=1).featurize_files([tp], [sp])
    want = nyxus_tpu_torch.Nyxus(feats, device="cpu", precision="f64") \
        .featurize(big, np.tile(labels, (3, 3)))
    np.testing.assert_array_equal(got.iloc[:, 4:].to_numpy(float),
                                  want.iloc[:, 4:].to_numpy(float))
    assert got.AREA_PIXELS_COUNT.tolist() == [5400]


def test_cli_over_dicom_directory_equals_jax(tmp_path):
    """The CLI over a directory of single-frame .dcm pairs: the port's
    CSV is the JAX CLI's (names and labels equal, values within
    chip_smoke's f32 tiers, the CLI's precision) and holds the port's
    featurize_directory rows bit for bit."""
    for d in ("int", "seg"):
        (tmp_path / d).mkdir()
    for k in range(2):
        intens, labels = chip_smoke.make_dsb_like(96, 112, 5, seed=20 + k)
        if k:
            intens = (intens.astype(np.int32) - 200).astype(np.int16)
        tdicom.write_dicom_gray(str(tmp_path / "int" / ("p%d.dcm" % k)),
                                intens, intercept=-1024.0 if k else None)
        tdicom.write_dicom_gray(str(tmp_path / "seg" / ("p%d.dcm" % k)),
                                labels.astype(np.uint16))
    feats = "*ALL_INTENSITY*,*ALL_MORPHOLOGY*,*ALL_GLSZM*"
    argv = ["--intDir=" + str(tmp_path / "int"),
            "--segDir=" + str(tmp_path / "seg"),
            "--features=" + feats, "--outputType=singlecsv"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.main(argv + ["--outDir=" + jout]) == 0
    assert tcli.main(argv + ["--outDir=" + tout, "--useGpu=false"]) == 0
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout)) == \
        ["NyxusFeatures.csv"]
    want = _read(os.path.join(jout, "NyxusFeatures.csv"))
    got = _read(os.path.join(tout, "NyxusFeatures.csv"))
    assert list(got.columns) == list(want.columns)
    meta = ["intensity_image", "mask_image", "ROI_label", "t_index"]
    for c in meta:
        assert list(got[c]) == list(want[c]), c
    assert set(got.intensity_image.map(os.path.basename)) == {"p0.dcm",
                                                              "p1.dcm"}
    cols = [c for c in want.columns if c not in meta]
    bad, _ = chip_smoke.compare_tiers(cols, got[cols].to_numpy(float),
                                      want[cols].to_numpy(float))
    assert not bad, bad[:10]
    args = tcli.build_parser().parse_args(argv + ["--outDir=" + tout,
                                                  "--useGpu=false"])
    frame = tcli.make_nyxus(args).featurize_directory(args.intDir,
                                                      args.segDir)
    np.testing.assert_array_equal(got[cols].to_numpy(float),
                                  frame[cols].to_numpy(float))
