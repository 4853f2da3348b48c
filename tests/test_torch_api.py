"""The port's Nyxus parameter surface against the JAX package's
(tests/test_api_params.py's cases): metaparameters, Gabor customisation
and environment parameters, on the CPU.  A custom Gabor bank set through
the constructor gives the JAX package's values (f64, rtol 1e-9)."""

import numpy as np
import pytest

import nyxus_tpu
import nyxus_tpu_torch

from conftest import make_blobs


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
