"""The port's Nyxus parameter surface against the JAX package's
(tests/test_api_params.py's cases): metaparameters, Gabor customisation
and environment parameters, on the CPU.  A custom Gabor bank set through
the constructor gives the JAX package's values (f64, rtol 1e-9)."""

import numpy as np
import pytest

import nyxus_tpu
import nyxus_tpu_torch

from conftest import make_blobs
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)


def _nyx(features, **kw):
    return nyxus_tpu_torch.Nyxus(features, device="cpu", **kw)


def test_metaparam_roundtrip():
    nyx = _nyx(["GLCM_CONTRAST"])
    assert nyx.get_metaparam("glcm/greydepth") == 64.0   # default fallback
    nyx.set_metaparam("glcm/greydepth=25")
    assert nyx.get_metaparam("glcm/greydepth") == 25.0
    assert nyx.cfg.glcm_greydepth == 25
    nyx.set_metaparam("glcm/offset=2")
    assert nyx.get_metaparam("glcm/offset") == 2.0


def test_metaparam_3d_paths():
    nyx = _nyx(["MEAN"])
    for p, v in (("3glcm/greydepth", 32), ("3glcm/offset", 2),
                 ("3gldm/greydepth", 16), ("3ngtdm/greydepth", 8),
                 ("3ngtdm/radius", 2), ("3glrlm/greydepth", 12),
                 ("3glszm/greydepth", 10)):
        nyx.set_metaparam("%s=%d" % (p, v))
        assert nyx.get_metaparam(p) == float(v), p


@pytest.mark.parametrize("bad", ["glcm/greydepth", "glcm/bogus=1",
                                 "bogusfam/greydepth=1", "glcm/greydepth=abc",
                                 "3ngtdm/radius=0", "a/b/c=1", "greydepth=3"])
def test_metaparam_errors(bad):
    """Each malformed setting raises ValueError with the JAX package's
    message."""
    with pytest.raises(ValueError) as got:
        _nyx(["MEAN"]).set_metaparam(bad)
    with pytest.raises(ValueError) as want:
        nyxus_tpu.Nyxus(["MEAN"]).set_metaparam(bad)
    assert str(got.value) == str(want.value)


def test_get_metaparam_errors():
    nyx = _nyx(["MEAN"])
    for bad in ("glcm/bogus", "glcm", "a/b/c"):
        with pytest.raises(NameError):
            nyx.get_metaparam(bad)


def test_metaparam_changes_glcm_result():
    intens, labels = make_blobs(64, 64, 3, seed=3)
    nyx = _nyx(["GLCM_CONTRAST"], precision="f64")
    a = nyx.featurize(intens.astype(np.uint16), labels)
    nyx.set_metaparam("glcm/greydepth=8")
    b = nyx.featurize(intens.astype(np.uint16), labels)
    assert not np.allclose(a.iloc[:, 4:].values, b.iloc[:, 4:].values)


def test_set_gabor_feature_params():
    nyx = _nyx(["GABOR"])
    nyx.set_gabor_feature_params(kersize=10, gamma=0.2, sig2lam=0.9,
                                 f0=0.2, thold=0.05,
                                 thetas=[0, 30, 60, 90],
                                 freqs=[2, 4, 8, 16])
    p = nyx.get_params()
    assert p["gabor_kersize"] == 10
    assert (p["gabor_gamma"], p["gabor_sig2lam"], p["gabor_f0"],
            p["gabor_thold"]) == (0.2, 0.9, 0.2, 0.05)
    assert p["gabor_thetas"] == [0, 30, 60, 90]
    assert p["gabor_freqs"] == [2, 4, 8, 16]
    assert nyx._runner.cfg.gabor_kersize == 10


@pytest.mark.parametrize("kwargs,exc,msg", [
    ({"bogus": 1}, ValueError, "Invalid Gabor parameter bogus"),
    ({}, IOError, "Illegal arguments"),
    ({"thetas": [0, 45]}, ValueError, "together with matching lengths"),
    ({"thetas": [0, 45], "freqs": [1]}, ValueError, "matching lengths"),
])
def test_set_gabor_feature_params_errors(kwargs, exc, msg):
    nyx = _nyx(["GABOR"])
    with pytest.raises(exc, match=msg):
        nyx.set_gabor_feature_params(**kwargs)
    assert nyx.cfg.gabor_thetas == (0, 45, 90, 135)   # unchanged


def test_set_environment_params():
    nyx = _nyx(["MEAN"])
    nyx.set_environment_params(coarse_gray_depth=32, neighbor_distance=7)
    p = nyx.get_params("coarse_gray_depth", "neighbor_distance")
    assert p == {"coarse_gray_depth": 32, "neighbor_distance": 7}
    nyx.set_params(features=["*ALL_GLCM*"], gabor_thetas=[0, 90],
                   gabor_freqs=[4, 8])
    assert nyx.features == ["*ALL_GLCM*"]
    assert nyx.get_params("gabor_thetas") == {"gabor_thetas": [0, 90]}


def test_get_params_match_jax():
    kw = dict(coarse_gray_depth=32, gabor_kersize=12, gabor_thetas=[10, 20],
              gabor_freqs=[3, 5], pixels_per_micron=2.0)
    got = _nyx(["MEAN"], **kw).get_params()
    want = nyxus_tpu.Nyxus(["MEAN"], **kw).get_params()
    assert got == want


def test_custom_gabor_bank_matches_jax():
    """Nyxus(["GABOR"], gabor_thetas=..., gabor_freqs=...) gives the JAX
    package's values (an odd kersize and five filters)."""
    intens, labels = make_blobs(96, 96, 6, seed=7)
    kw = dict(gabor_kersize=11, gabor_thetas=[0, 20, 40, 60, 80],
              gabor_freqs=[1, 2, 4, 8, 16], gabor_thold=0.05,
              precision="f64")
    want = nyxus_tpu.Nyxus(["GABOR"], **kw).featurize(intens, labels)
    got = _nyx(["GABOR"], **kw).featurize(intens, labels)
    assert list(got.columns) == list(want.columns)
    assert len(got.columns) == 4 + 5
    cols = list(want.columns[4:])
    np.testing.assert_allclose(got[cols].to_numpy(float),
                               want[cols].to_numpy(float), rtol=1e-9,
                               atol=1e-12)
    default = _nyx(["GABOR"], precision="f64").featurize(intens, labels)
    assert len(default.columns) == 4 + 4


# ---------------------------------------------------------------------------
# output types, the ROI blacklist and IBSI construction


def _pair():
    intens, labels = make_blobs(96, 96, 5, seed=11)
    return intens, labels


@pytest.mark.parametrize("output_type", ["arrowipc", "parquet"])
def test_featurize_output_files(tmp_path, output_type):
    """featurize writes the Arrow IPC / Parquet file at output_path (a
    directory gets the default name), returns its path, and the file reads
    back as the pandas frame."""
    pa = pytest.importorskip("pyarrow")
    import pandas as pd
    intens, labels = _pair()
    nyx = _nyx(["*ALL_INTENSITY*", "GLCM_ASM"], precision="f64")
    df = nyx.featurize(intens, labels)
    path = nyx.featurize(intens, labels, output_type=output_type,
                         output_path=str(tmp_path / "out"))
    name = {"arrowipc": "NyxusFeatures.arrow",
            "parquet": "NyxusFeatures.parquet"}[output_type]
    assert path == str(tmp_path / "out" / name)
    getter = {"arrowipc": nyx.get_arrow_ipc_file,
              "parquet": nyx.get_parquet_file}[output_type]
    assert getter() == path
    if output_type == "parquet":
        back = pd.read_parquet(path)
    else:
        with pa.memory_map(path) as src:
            back = pa.ipc.open_file(src).read_all().to_pandas()
    pd.testing.assert_frame_equal(back, df)
    assert nyxus_tpu_torch.Nyxus.arrow_is_enabled() is True


def test_featurize_csv_writer_matches_jax(tmp_path):
    """The CSV writer (the copied native writer) writes the port's frame as
    the JAX package's writes it, byte for byte, and it reads back."""
    import pandas as pd
    from nyxus_tpu.io import writers as jwriters
    from nyxus_tpu_torch.io import writers
    intens, labels = _pair()
    df = _nyx(["*ALL_INTENSITY*"], precision="f64").featurize(intens, labels)
    ours = writers.write_dataframe(df, "csv", str(tmp_path / "t.csv"))
    theirs = jwriters.write_dataframe(df, "csv", str(tmp_path / "j.csv"))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back = pd.read_csv(ours, float_precision="round_trip")
    assert list(back.columns) == list(df.columns)
    np.testing.assert_allclose(back.iloc[:, 4:].to_numpy(float),
                               df.iloc[:, 4:].to_numpy(float), rtol=0)


def test_featurize_invalid_output_type():
    intens, labels = _pair()
    nyx = _nyx(["MEAN"])
    with pytest.raises(ValueError, match="Invalid output type csv"):
        nyx.featurize(intens, labels, output_type="csv")
    assert nyx.get_arrow_ipc_file() == ""


def test_blacklist_methods():
    """A blacklisted ROI keeps its row with every feature -0.0; the summary
    names the list; clearing it restores the values.  A per-file list
    applies to the intensity image of that name only."""
    intens, labels = _pair()
    nyx = _nyx(["MEAN", "GLCM_ASM_AVE"], precision="f64")
    full = nyx.featurize(intens, labels)
    assert nyx.roi_blacklist_get_summary() == "blacklist is not defined"
    nyx.blacklist_roi("1,3")
    assert "global blacklist: 1,3" in nyx.roi_blacklist_get_summary()
    df = nyx.featurize(intens, labels)
    assert list(df.ROI_label) == list(full.ROI_label)
    black = df.ROI_label.isin([1, 3])
    vals = df.loc[black].iloc[:, 4:].to_numpy(float)
    assert black.sum() == 2 and (vals == 0).all() and np.signbit(vals).all()
    np.testing.assert_array_equal(df.loc[~black].iloc[:, 4:].to_numpy(float),
                                  full.loc[~black].iloc[:, 4:].to_numpy(float))
    nyx.clear_roi_blacklist()
    pd_eq = nyx.featurize(intens, labels)
    np.testing.assert_array_equal(pd_eq.iloc[:, 4:].to_numpy(float),
                                  full.iloc[:, 4:].to_numpy(float))
    nyx.blacklist_roi("a.tif:2;b.tif:4")
    two = nyx.featurize(np.stack([intens, intens]), np.stack([labels, labels]),
                        intensity_names=["a.tif", "b.tif"],
                        label_names=["ma.tif", "mb.tif"])
    out = two.set_index(["intensity_image", "ROI_label"]).MEAN
    assert out[("a.tif", 2)] == 0 and out[("a.tif", 4)] > 0
    assert out[("b.tif", 4)] == 0 and out[("b.tif", 2)] > 0


@pytest.mark.parametrize("cls,features,width", [
    ("Nyxus", ["*ALL*"], 793), ("Nyxus3D", ["*3D_ALL*"], 213)])
def test_ibsi_construction(cls, features, width):
    """IBSI Nyxus / Nyxus3D build on the CPU (no NotImplementedError) with
    the IBSI header."""
    nyx = getattr(nyxus_tpu_torch, cls)(features, device="cpu", ibsi=True)
    assert nyx.cfg.ibsi and len(nyx.header) - 4 == width
    assert nyx.get_params("ibsi") == {"ibsi": True}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_n_devices_beyond_one_raises(n):
    """A request to shard over n cards no longer raises: on the CPU it
    makes n shards of each ROI bucket, and the 2D and 3D rows equal the
    one-device rows in f64 at rtol 1e-12 (each ROI's features read its own
    crop alone; a batched einsum may add a shard's rows in another order
    than the whole bucket's).  The slide's 5 ROIs give empty shards at
    n = 8."""
    from conftest import make_blobs3d
    intens, labels = _pair()
    feats = ["*ALL_INTENSITY*", "*ALL_GLCM*", "*ALL_MORPHOLOGY*"]
    one = _nyx(feats, precision="f64").featurize(intens, labels)
    many = _nyx(feats, precision="f64", n_devices=n)
    assert len(many._runner.devices) == n
    _same_frame(many.featurize(intens, labels), one)
    vol, vlab = make_blobs3d(seed=n)
    one3 = nyxus_tpu_torch.Nyxus3D(["*3D_ALL*"], device="cpu",
                                   precision="f64").featurize(vol, vlab)
    many3 = nyxus_tpu_torch.Nyxus3D(["*3D_ALL*"], device="cpu",
                                    precision="f64", n_devices=n)
    assert len(many3._runner.devices) == n
    _same_frame(many3.featurize(vol, vlab), one3)


def _same_frame(got, want):
    import pandas as pd
    assert len(want) > 0
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12,
                                  atol=1e-12)


@pytest.mark.parametrize("n", [None, 0, 1])
def test_n_devices_of_one_card_runs(n):
    """n_devices None, 0 and 1 mean one card: the 2D Nyxus builds and
    featurizes as without it."""
    intens, labels = _pair()
    got = _nyx(["MEAN", "AREA_PIXELS_COUNT"], n_devices=n).featurize(
        intens, labels)
    want = _nyx(["MEAN", "AREA_PIXELS_COUNT"]).featurize(intens, labels)
    assert got.equals(want)
