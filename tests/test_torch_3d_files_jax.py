"""The port's 3D file protocol against the JAX package's, on the CPU in
f64:

- the NIfTI copies (``io/readers.py`` read_nifti, write_nifti and
  read_volume) against JAX's on every NIfTI data type, ``.nii`` and
  ``.nii.gz``, 3D and 4D (the time axis and the header's rescale);
- ``Nyxus3D.featurize_directory`` on a directory of NIfTI volume pairs
  (one ``.nii``, one 4D ``.nii.gz`` of two time points whose label volume
  has one) against JAX's: the pandas frame, and the Arrow IPC and Parquet
  files, streamed a volume at a time; ``featurize_files`` with
  ``single_roi`` (whole-volume mode) against JAX's;
- the CLI with ``--dim=3`` against the JAX package's CLI: the same CSV.

tests/test_torch_3d_layout_jax.py holds the 2.5D layout-A stacks the same
way, so that ``--dist loadfile`` gives those JAX references a worker of
their own.

rtol 1e-9 (atol 1e-12), 5e-7 for the fast_log2 entropies, NaN in the same
places, the name, label and time columns equal.  ROBUST_MEAN and
ROBUST_MEAN_ABSOLUTE_DEVIATION average the voxels within [P10, P90]; XLA
contracts the percentiles' bin edge ``vmin + binw i`` into an FMA, which
can leave JAX's P10 or P90 one ulp off a voxel value that the port's
unfused formula lands on exactly (vol_a's ROI 4: P10 85.00000000000001
against 85.0), and the voxels of that value then fall out of JAX's range.
In a row whose P10 or P90 is not JAX's bit for bit, the two members are
held against numpy over that row's voxels and the port's range instead."""

import os
import sys

import numpy as np
import pandas as pd
import pytest

import nyxus_tpu
import nyxus_tpu.cli as jcli
from nyxus_tpu.io import readers as jreaders

import nyxus_tpu_torch
import nyxus_tpu_torch.cli as tcli
from nyxus_tpu_torch.io import readers as treaders

from test_torch_3d_modes_jax import agree
from test_torch_cli import _read

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)

FEATS = ["*3D_ALL_INTENSITY*", "*3D_ALL_MORPHOLOGY*", "*3D_GLCM*",
         "*3D_GLSZM*", "*3D_GLDZM*"]
META = ["intensity_image", "mask_image", "ROI_label", "t_index"]


ROBUST = ("3ROBUST_MEAN", "3ROBUST_MEAN_ABSOLUTE_DEVIATION")


def frames_agree(got, want, voxels=None):
    """Frames equal in their name, label and time columns, their values
    within the tolerances; ``voxels(row)``, the intensities of a row's ROI,
    serves the rows whose P10 or P90 is not JAX's (see above)."""
    assert list(got.columns) == list(want.columns)
    assert list(got.columns[:4]) == META
    for c in META:
        assert list(got[c]) == list(want[c]), c
    cols = list(want.columns[4:])
    g = got[cols].to_numpy(float)
    w = want[cols].to_numpy(float).copy()
    if "3P10" in cols:
        p10, p90 = cols.index("3P10"), cols.index("3P90")
        ties = np.nonzero((g[:, p10] != w[:, p10])
                          | (g[:, p90] != w[:, p90]))[0]
        for r in ties:
            v = voxels(got.iloc[r])
            v = v[(v >= g[r, p10]) & (v <= g[r, p90])]
            mean = v.mean()
            want_r = {"3ROBUST_MEAN": mean,
                      "3ROBUST_MEAN_ABSOLUTE_DEVIATION":
                      np.abs(v - mean).mean()}
            for c in ROBUST:
                np.testing.assert_allclose(g[r, cols.index(c)], want_r[c],
                                           rtol=1e-9, err_msg=c)
                w[r, cols.index(c)] = g[r, cols.index(c)]
    agree(cols, g, w)


def _read_table(path):
    if path.endswith(".parquet"):
        return pd.read_parquet(path)
    import pyarrow as pa
    with pa.memory_map(path) as src:
        return pa.ipc.open_file(src).read_all().to_pandas()


# -- NIfTI ---------------------------------------------------------------

NIFTI_DTYPES = [np.uint8, np.int16, np.int32, np.float32, np.float64,
                np.int8, np.uint16, np.uint32, np.int64, np.uint64]


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", NIFTI_DTYPES, ids=lambda d: d.__name__)
def test_nifti_equals_jax(tmp_path, dtype, ext):
    """Each package reads the other's file back exactly, with its type,
    shape and header fields."""
    vol = (np.random.default_rng(3).integers(0, 100, (3, 5, 7)) - 20)
    vol = vol.astype(dtype)
    pt, pj = str(tmp_path / ("t" + ext)), str(tmp_path / ("j" + ext))
    treaders.write_nifti(pt, vol)
    jreaders.write_nifti(pj, vol)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read() or ext == ".nii.gz"
    for p in (pt, pj):
        for meta in (False, True):
            got = treaders.read_nifti(p, with_meta=meta)
            want = jreaders.read_nifti(p, with_meta=meta)
            if meta:
                assert got[1] == want[1]
                got, want = got[0], want[0]
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(np.asarray(treaders.read_volume(p)),
                                      vol)


def test_nifti_4d_and_rescale(tmp_path):
    """A 4D volume keeps its time axis; a header's scl_slope and scl_inter
    come back in the metadata, as JAX reads them; a directory is read as
    an OME-Zarr volume, as JAX reads it."""
    vol = np.arange(2 * 3 * 4 * 5, dtype=np.int16).reshape(2, 3, 4, 5)
    p = str(tmp_path / "v.nii")
    treaders.write_nifti(p, vol)
    blob = bytearray(open(p, "rb").read())
    blob[112:116] = np.float32(2.5).tobytes()
    blob[116:120] = np.float32(-7.0).tobytes()
    open(p, "wb").write(bytes(blob))
    got, meta = treaders.read_volume(p, with_meta=True)
    want, jmeta = jreaders.read_volume(p, with_meta=True)
    assert meta == jmeta == {"scl_slope": 2.5, "scl_inter": -7.0, "nt": 2}
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 3, 4, 5)
    from nyxus_tpu_torch.io.zarr import write_zarr
    z = str(tmp_path / "zarr_volume")
    write_zarr(z, vol.reshape(2, 1, 3, 4, 5), chunks=(1, 1, 2, 3, 3))
    got, meta = treaders.read_volume(z, with_meta=True)
    want, jmeta = jreaders.read_volume(z, with_meta=True)
    assert meta == jmeta == {"nt": 2, "slope": 1.0, "inter": 0.0}
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vol)


# -- featurize_directory / featurize_files --------------------------------


def _volume_pair(seed, shape):
    r = np.random.default_rng(seed)
    intens = r.integers(1, 900, shape).astype(np.uint16)
    labels = np.zeros(shape, np.uint16)
    D, H, W = shape
    labels[1:D - 1, 2:H // 2, 3:W // 2] = 4
    labels[0:D // 2, H // 2 + 1:H - 1, 1:W - 2] = 9
    labels[D - 3:D, 1:4, W - 5:W] = 2
    return intens, labels


def nifti_voxels(row):
    """The intensities of a frame row's ROI in the nifti_dirs volumes."""
    name = os.path.basename(row.intensity_image)
    ivol, lvol = NIFTI_PAIRS[name]
    lab = lvol if row.mask_image else np.ones_like(lvol)
    return ivol[int(row.t_index)][lab == row.ROI_label].astype(np.float64)


def _nifti_pairs():
    ia, la = _volume_pair(1, (12, 14, 16))
    ib, lb = _volume_pair(2, (10, 12, 14))
    ib2 = np.stack([ib, (ib // 3 + 5).astype(np.uint16)])
    return {"vol_a.nii": (ia[None], la), "vol_b.nii.gz": (ib2, lb)}


NIFTI_PAIRS = _nifti_pairs()


@pytest.fixture(scope="module")
def nifti_dirs(tmp_path_factory):
    """vol_a.nii (12 x 14 x 16) and vol_b.nii.gz, a 4D intensity volume of
    two time points whose label volume has one."""
    root = tmp_path_factory.mktemp("nifti")
    for d in ("int", "seg"):
        (root / d).mkdir()
    for name, (ivol, lvol) in NIFTI_PAIRS.items():
        treaders.write_nifti(str(root / "int" / name),
                             ivol[0] if len(ivol) == 1 else ivol)
        treaders.write_nifti(str(root / "seg" / name), lvol)
    return str(root / "int"), str(root / "seg")


@pytest.fixture(scope="module")
def jax_directory_frame(nifti_dirs):
    return nyxus_tpu.Nyxus3D(FEATS, precision="f64").featurize_directory(
        *nifti_dirs)


def test_featurize_directory_equals_jax(nifti_dirs, jax_directory_frame):
    got = nyxus_tpu_torch.Nyxus3D(FEATS, device="cpu", precision="f64") \
        .featurize_directory(*nifti_dirs)
    want = jax_directory_frame
    frames_agree(got, want, nifti_voxels)
    assert list(got.t_index) == [0.0] * 3 + [0.0] * 3 + [1.0] * 3
    assert got.ROI_label.tolist() == [2, 4, 9] * 3


@pytest.mark.parametrize("output_type", ["arrowipc", "parquet"])
def test_arrow_outputs_equal_jax(nifti_dirs, jax_directory_frame, tmp_path,
                                 output_type):
    """The Arrow IPC and Parquet files hold JAX's pandas rows, and the
    accessors name them."""
    nyx = nyxus_tpu_torch.Nyxus3D(FEATS, device="cpu", precision="f64")
    assert nyx.arrow_is_enabled() == nyxus_tpu.Nyxus3D.arrow_is_enabled()
    out = nyx.featurize_directory(*nifti_dirs, output_type=output_type,
                                  output_path=str(tmp_path))
    assert out == nyx.get_arrow_ipc_file() == nyx.get_parquet_file()
    assert os.path.dirname(out) == str(tmp_path)
    jout = nyxus_tpu.Nyxus3D(FEATS, precision="f64").featurize_directory(
        *nifti_dirs, output_type=output_type,
        output_path=str(tmp_path / "jax"))
    assert os.path.basename(out) == os.path.basename(jout)
    frames_agree(_read_table(out), jax_directory_frame, nifti_voxels)
    frames_agree(_read_table(jout), _read_table(out), nifti_voxels)


def test_featurize_files_single_roi_equals_jax(nifti_dirs):
    """Whole-volume mode: each intensity volume one ROI over its one-past
    box, the mask column empty."""
    int_dir, _ = nifti_dirs
    files = [os.path.join(int_dir, f) for f in ("vol_a.nii", "vol_b.nii.gz")]
    got = nyxus_tpu_torch.Nyxus3D(FEATS, device="cpu", precision="f64") \
        .featurize_files(files, None, single_roi=True)
    want = nyxus_tpu.Nyxus3D(FEATS, precision="f64").featurize_files(
        files, None, single_roi=True)
    frames_agree(got, want, nifti_voxels)
    assert got.ROI_label.tolist() == [1, 1, 1]
    assert set(got.mask_image) == {""}


def test_featurize_files_pairs_and_errors(nifti_dirs):
    """featurize_files on explicit pairs equals featurize_directory's rows;
    the JAX package's argument errors."""
    int_dir, seg_dir = nifti_dirs
    nyx = nyxus_tpu_torch.Nyxus3D(FEATS, device="cpu", precision="f64")
    ip = [os.path.join(int_dir, "vol_a.nii")]
    lp = [os.path.join(seg_dir, "vol_a.nii")]
    got = nyx.featurize_files(ip, lp)
    want = nyx.featurize_directory(int_dir, seg_dir, file_pattern="vol_a.*")
    frames_agree(got, want, nifti_voxels)
    with pytest.raises(IOError):
        nyx.featurize_files(None, lp)
    with pytest.raises(IOError):
        nyx.featurize_files(ip, None)
    with pytest.raises(ValueError, match="Invalid output type"):
        nyx.featurize_directory(int_dir, seg_dir, output_type="csv")
    with pytest.raises(IOError):
        nyx.featurize_directory(int_dir + "_none", seg_dir)


# -- the CLI ---------------------------------------------------------------


def test_cli_dim3_equals_jax(nifti_dirs, tmp_path):
    """--dim=3 over the NIfTI directory: the port's CSV is the JAX CLI's
    (names, labels and time equal, values within chip_smoke's f32 tiers,
    the CLI's precision) and holds the rows of the port's
    featurize_directory with the CLI's settings bit for bit."""
    argv = ["--intDir=" + nifti_dirs[0], "--segDir=" + nifti_dirs[1],
            "--dim=3", "--features=" + ",".join(FEATS),
            "--outputType=singlecsv"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.main(argv + ["--outDir=" + jout]) == 0
    assert tcli.main(argv + ["--outDir=" + tout, "--useGpu=false"]) == 0
    assert os.listdir(jout) == os.listdir(tout) == ["NyxusFeatures.csv"]
    got = _read(os.path.join(tout, "NyxusFeatures.csv"))
    want = _read(os.path.join(jout, "NyxusFeatures.csv"))
    assert list(got.columns) == list(want.columns)
    for c in META:
        assert list(got[c]) == list(want[c]), c
    cols = list(want.columns[4:])
    # the CLI's default precision, f32, on both sides: its tiers
    bad, _ = chip_smoke.compare_tiers(cols, got[cols].to_numpy(float),
                                      want[cols].to_numpy(float))
    assert not bad, bad[:10]
    # and bit for bit the rows of the port's featurize_directory with the
    # CLI's settings
    args = tcli.build_parser().parse_args(argv + ["--outDir=" + tout,
                                                  "--useGpu=false"])
    nyx = tcli.make_nyxus(args)
    assert isinstance(nyx, nyxus_tpu_torch.Nyxus3D)
    frame = nyx.featurize_directory(args.intDir, args.segDir,
                                    args.filePattern)
    assert len(frame) == len(got) == 9
    np.testing.assert_array_equal(got[cols].to_numpy(float),
                                  frame[cols].to_numpy(float))
