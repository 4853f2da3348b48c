"""The port's ``ImageQuality`` and its four IMQ families (focus score,
power spectrum, saturation, sharpness) against the JAX package's, in f64
on the CPU, and against tests/test_imq.py's properties: the focus score
and its quadrant against direct numpy, the saturation counts, a finite
sharpness; the oversized streamed families (``pipeline/imq_streamed.py``,
the power spectrum's FFT and radial sums in torch, the sums through K1's
plain version here) against the in-memory ones and JAX's, with small
blocks too; invariance under the binning modes and preserve_hu's shift;
the file surface; the anisotropic virtual slide.  Against JAX: rtol 1e-9
(the power spectrum slope, whose FFT is torch's against XLA's, 1e-9 as
well)."""

import os
import sys

import numpy as np
import pytest
from scipy import signal

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nyxus_tpu  # noqa: E402
from nyxus_tpu.pipeline import imq_streamed as jimq  # noqa: E402
from nyxus_tpu.pipeline import sources as jsources  # noqa: E402

import nyxus_tpu_torch  # noqa: E402
from nyxus_tpu_torch.io.tiff import write_tiff  # noqa: E402
from nyxus_tpu_torch.ops import imq as timq_ops  # noqa: E402
from nyxus_tpu_torch.pipeline import imq_streamed as timq  # noqa: E402
from nyxus_tpu_torch.pipeline import sources as tsources  # noqa: E402
from nyxus_tpu_torch.pipeline.labels import RoiRecord  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

COLS = ["FOCUS_SCORE", "LOCAL_FOCUS_SCORE", "MIN_SATURATION",
        "MAX_SATURATION", "SHARPNESS", "POWER_SPECTRUM_SLOPE"]


def _iq(**kw):
    return nyxus_tpu_torch.ImageQuality(device="cpu", **kw)


def _assert_frames_equal(got, want, rtol=1e-9):
    assert list(got.columns) == list(want.columns)
    for c in want.columns[:4]:
        assert list(got[c]) == list(want[c]), c
    for c in want.columns[4:]:
        np.testing.assert_allclose(got[c].to_numpy(float),
                                   want[c].to_numpy(float), rtol=rtol,
                                   atol=1e-12, err_msg=c)


@pytest.fixture(scope="module")
def imq_df():
    r = np.random.default_rng(11)
    img = r.integers(0, 4000, (48, 56)).astype(np.uint16)
    df = _iq().featurize(img)
    return img, df


def test_imagequality_equals_jax(imq_df):
    """The default request, *ALL_IMQ*, on a whole image (a constant-1
    label image) and per ROI of a labelled pair."""
    img, df = imq_df
    assert sorted(df.columns[4:]) == sorted(COLS) and len(df) == 1
    _assert_frames_equal(df, nyxus_tpu.ImageQuality().featurize(img))
    lab = np.zeros(img.shape, np.int32)
    lab[2:30, 3:40] = 4
    lab[33:46, 10:50] = 9
    got = _iq(precision="f64").featurize(img, lab)
    want = nyxus_tpu.ImageQuality(precision="f64").featurize(img, lab)
    assert list(got.ROI_label) == [4, 9]
    _assert_frames_equal(got, want)


def test_focus_score(imq_df):
    img, df = imq_df
    row = df.iloc[0]
    k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], float)
    lap = signal.convolve2d(img.astype(float), k, mode="same", boundary="fill")
    a = np.abs(lap)
    want = ((a - a.mean()) ** 2).mean()
    assert row.FOCUS_SCORE == pytest.approx(want, rel=1e-9)


def test_local_focus_score_quadrant(imq_df):
    """Even dims: the reference's tile loop visits only the top-left tile."""
    img, df = imq_df
    k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], float)
    tile = img[:24, :28].astype(float)
    lap = signal.convolve2d(tile, k, mode="same", boundary="fill")
    a = np.abs(lap)
    want = ((a - a.mean()) ** 2).mean() / 4
    assert df.iloc[0].LOCAL_FOCUS_SCORE == pytest.approx(want, rel=1e-9)


def test_saturation(imq_df):
    img, df = imq_df
    row = df.iloc[0]
    assert row.MIN_SATURATION == (img == img.min()).sum() / img.size
    assert row.MAX_SATURATION == (img == img.max()).sum() / img.size


def test_sharpness_finite(imq_df):
    _, df = imq_df
    row = df.iloc[0]
    assert np.isfinite(row.SHARPNESS) and row.SHARPNESS >= 0
    assert np.isfinite(row.POWER_SPECTRUM_SLOPE)


@pytest.fixture(scope="module")
def oversized_pair():
    """tests/test_imq.py's streamed-parity pair: a 260 x 340 ROI whose
    512² bucket is over ram_limit=1's 1 MB budget."""
    r = np.random.default_rng(5)
    img = r.integers(1, 4000, (300, 400)).astype(np.uint16)
    lab = np.zeros((300, 400), np.uint16)
    lab[20:280, 30:370] = 7
    mem = _iq(precision="f64").featurize(img, lab)
    st = _iq(precision="f64", ram_limit=1).featurize(img, lab)
    return img, lab, mem, st


def test_imq_oversized_streamed_parity(oversized_pair):
    """Forced-oversized (ram_limit=1) IMQ matches the in-memory trivial
    path for all four families, at test_imq.py's tolerances."""
    _, _, mem, st = oversized_pair
    assert list(mem.ROI_label) == list(st.ROI_label) == [7]
    tol = {"SHARPNESS": 1e-6, "POWER_SPECTRUM_SLOPE": 1e-6}
    for c in COLS:
        np.testing.assert_allclose(st[c].to_numpy(), mem[c].to_numpy(),
                                   rtol=tol.get(c, 1e-9), err_msg=c)


def test_imq_oversized_streamed_equals_jax(oversized_pair):
    """The streamed families against JAX's streamed ones."""
    img, lab, _, st = oversized_pair
    want = nyxus_tpu.ImageQuality(precision="f64", ram_limit=1).featurize(
        img, lab)
    _assert_frames_equal(st, want)


def test_imq_oversized_small_blocks():
    """Block-row streaming with tiny blocks (halo and boundary code)
    against the trivial functions and JAX's streamed ones."""
    r = np.random.default_rng(9)
    img = r.integers(0, 900, (61, 47)).astype(np.uint16)
    lab = np.zeros((61, 47), np.uint16)
    lab[3:58, 2:45] = 3
    src = tsources.ArrayPairSource(img, lab)
    jsrc = jsources.ArrayPairSource(img, lab)
    rec = RoiRecord(3, int((lab == 3).sum()), 3, 57, 2, 44, 0, 0)
    crop = np.where(lab[3:58, 2:45] == 3, img[3:58, 2:45], 0).astype(float)
    for block in (7, 16, 64):
        fs = timq.focus_score_streamed(rec, src, block)
        tfs, tlfs = timq_ops.focus_score(crop)
        assert fs["FOCUS_SCORE"] == pytest.approx(tfs, rel=1e-9)
        assert fs["LOCAL_FOCUS_SCORE"] == pytest.approx(tlfs, rel=1e-9)
        sat = timq.saturation_streamed(rec, src, block)
        tmn, tmx = timq_ops.saturation(crop)
        assert sat["MIN_SATURATION"] == tmn and sat["MAX_SATURATION"] == tmx
        sh = timq.sharpness_streamed(rec, src, block)
        assert sh["SHARPNESS"] == pytest.approx(timq_ops.sharpness(crop),
                                                rel=1e-7)
        ps = timq.power_spectrum_streamed(rec, src, np.float64, block)
        assert ps["POWER_SPECTRUM_SLOPE"] == pytest.approx(
            timq_ops.power_spectrum_slope(crop), rel=1e-6)
        assert ps["POWER_SPECTRUM_SLOPE"] == pytest.approx(
            jimq.power_spectrum_streamed(rec, jsrc, np.float64, block)
            ["POWER_SPECTRUM_SLOPE"], rel=1e-9)
        assert sh == jimq.sharpness_streamed(rec, jsrc, block)
        assert fs == jimq.focus_score_streamed(rec, jsrc, block)


def test_spectrum_bins_f32_and_f64():
    """The power spectrum's radial sums (torch FFT, one two-channel K1 call
    over 128 rows) against numpy's FFT and bincount, in both dtypes."""
    r = np.random.default_rng(2)
    buf = r.normal(0, 1, (256, 256))
    cap = 240
    v = (np.abs(np.fft.fft2(buf)) / 256).ravel()
    li = np.floor(np.sqrt(v)).astype(np.int64) + 1
    li = np.where(li < cap, li, cap)
    mag = np.bincount(li, weights=v, minlength=cap + 1)[:cap]
    pw = np.bincount(li, weights=v * v, minlength=cap + 1)[:cap]
    for dt, rtol in ((np.float64, 1e-12), (np.float32, 1e-4)):
        got_mag, got_pw = timq.spectrum_bins(buf.astype(dt), cap)
        assert got_mag.dtype == got_pw.dtype == np.float64
        np.testing.assert_allclose(got_mag, mag, rtol=rtol, atol=1e-9)
        np.testing.assert_allclose(got_pw, pw, rtol=rtol, atol=1e-9)


def test_imq_config_invariance_and_hu():
    """The binning modes do not touch the IMQ math, and preserve_hu
    shifts the input by the floored slide min before the same math."""
    r = np.random.default_rng(12)
    img = r.integers(1, 3000, (96, 128)).astype(np.uint16)
    base = _iq(precision="f64").featurize(img)
    for kw in (dict(ibsi=True), dict(coarse_gray_depth=-32)):
        alt = _iq(precision="f64", **kw).featurize(img)
        for c in COLS:
            np.testing.assert_allclose(alt[c], base[c], rtol=0, atol=0,
                                       err_msg="%s under %r" % (c, kw))
    hu = img.astype(np.int32) - 900
    got = _iq(precision="f64", preserve_hu=True).featurize(hu)
    off = np.floor(hu.min())
    shifted = np.maximum(np.round(hu - off), 0).astype(np.uint32)
    exp = _iq(precision="f64").featurize(shifted)
    for c in COLS:
        np.testing.assert_allclose(got[c], exp[c], rtol=1e-12, err_msg=c)
    _assert_frames_equal(got, nyxus_tpu.ImageQuality(
        precision="f64", preserve_hu=True).featurize(hu))


def test_imagequality_file_surface(tmp_path):
    """ImageQuality carries Nyxus's file surface: a directory with no
    masks is whole-image quality per slide, over the inclusive one-past
    box (its empty row and column make the frame's min 0)."""
    r = np.random.default_rng(3)
    d = tmp_path / "imgs"
    d.mkdir()
    imgs = {}
    for k in range(2):
        img = r.integers(1, 2000, (64, 80)).astype(np.uint16)
        write_tiff(str(d / ("a%d.tif" % k)), img, tile_size=64)
        imgs["a%d.tif" % k] = img
    iq = _iq(precision="f64")
    df = iq.featurize_directory(str(d), None)
    assert len(df) == 2
    for _, row in df.iterrows():
        img = imgs[os.path.basename(row.intensity_image)]
        H, W = img.shape
        frame = np.zeros((H + 1, W + 1))
        frame[:H, :W] = img
        assert row.MIN_SATURATION == \
            (frame == frame.min()).sum() / frame.size
        assert row.MAX_SATURATION == \
            (frame == frame.max()).sum() / frame.size
    _assert_frames_equal(df, nyxus_tpu.ImageQuality(
        precision="f64").featurize_directory(str(d), None))
    files = [str(d / "a0.tif"), str(d / "a1.tif")]
    df2 = iq.featurize_files(files, None, single_roi=True)
    assert len(df2) == 2
    assert iq.get_params()["features"] == ["*ALL_IMQ*"]


def test_imq_anisotropy_virtual_slide():
    """Under anisotropy the IMQ features read the nearest-neighbour
    resampled virtual slide: the same as the plain engine on the resampled
    image, and as JAX's."""
    r = np.random.default_rng(31)
    img = r.integers(0, 3000, (40, 52)).astype(np.uint16)
    ax, ay = 2.0, 1.5
    got = _iq(anisotropy_x=ax, anisotropy_y=ay).featurize(img)
    H, W = img.shape
    vH, vW = int(H * ay), int(W * ax)
    pr = np.minimum((np.arange(vH) / ay).astype(np.int64), H - 1)
    pc = np.minimum((np.arange(vW) / ax).astype(np.int64), W - 1)
    want = _iq().featurize(np.ascontiguousarray(img[pr][:, pc]))
    assert list(got.ROI_label) == list(want.ROI_label)
    for c in COLS:
        np.testing.assert_allclose(got[c].to_numpy(float),
                                   want[c].to_numpy(float),
                                   rtol=1e-12, atol=0, err_msg=c)
    _assert_frames_equal(got, nyxus_tpu.ImageQuality(
        anisotropy_x=ax, anisotropy_y=ay).featurize(img))
