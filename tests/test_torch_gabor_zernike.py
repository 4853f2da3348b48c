"""The PyTorch port's Gabor and Zernike modules against the JAX package's,
in f64 on the CPU, where the port runs the plain versions of K11 and K12
(tests/test_torch_cuda.py holds the kernels against them on the card).

Inputs are padded 16 x 16 and 32 x 32 buckets of seeded conftest.make_blobs
slides, assembled like the runners' dense path, plus two hand-made ROIs: a
blank one (one intensity: GABOR 0.0, ZERNIKE2D noval) and a 3 x 3 one of
intensities 1 and 2 whose baseline magnitudes are all 0 (flat: GABOR
noval).  Tolerances: rtol 1e-9 / atol 1e-12 against JAX (Gabor's scores are
ratios of equal integer counts; Zernike's sums are taken in another order),
and the numpy oracles of tests/test_gabor_zernike.py at that file's own
tolerances.  What the two packages share, the filter bank and the H
tables, must be equal bit for bit."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_blobs
import test_gabor_zernike as oracles

from nyxus_tpu.config import EngineConfig as JConfig
from nyxus_tpu.ops import gabor as jgabor
from nyxus_tpu.ops import zernike as jzernike

from nyxus_tpu_torch.config import EngineConfig as TConfig
from nyxus_tpu_torch.ops import gabor as tgabor
from nyxus_tpu_torch.ops import moments as tmoments
from nyxus_tpu_torch.ops import zernike as tzernike
from nyxus_tpu_torch.pipeline import batching, labels
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

# (kersize, thetas, freqs): the default bank, an odd kersize, and an even
# one with five filters
BANKS = {"default": {},
         "odd9": {"gabor_kersize": 9},
         "five10": {"gabor_kersize": 10, "gabor_thetas": (0, 30, 60, 90, 120),
                    "gabor_freqs": (2, 4, 8, 16, 32)}}
_CACHE = {}


def _bucket(size):
    """Masked crops of a seeded slide's ROIs whose bucket is size x size,
    then a blank ROI and a flat-baseline ROI: (img, mask, heights, widths,
    vmin, vmax) numpy arrays."""
    if size in _CACHE:
        return _CACHE[size]
    rmin, rmax = {16: (3, 7), 32: (8, 14)}[size]
    intens, lab = make_blobs(h=128, w=128, n_blobs=6, seed=size + 1,
                             rmin=rmin, rmax=rmax)
    recs, _, _ = labels._discover_rois_np(intens, lab)
    recs = [r for r in recs
            if batching.bucket_shape(r.height, r.width) == (size, size)]
    assert len(recs) >= 2
    B = len(recs) + 2
    img = np.zeros((B, size, size))
    mask = np.zeros((B, size, size), bool)
    hw = np.zeros((B, 2), np.int32)
    vmm = np.zeros((B, 2))
    for bi, r in enumerate(recs):
        h = min(size, lab.shape[0] - r.y0)
        w = min(size, lab.shape[1] - r.x0)
        m = lab[r.y0:r.y0 + h, r.x0:r.x0 + w] == r.label
        mask[bi, :h, :w] = m
        img[bi, :h, :w] = np.where(m, intens[r.y0:r.y0 + h, r.x0:r.x0 + w], 0)
        hw[bi] = r.height, r.width
        vmm[bi] = r.vmin, r.vmax
    yy, xx = np.mgrid[0:10, 0:12]
    blank = ((yy - 4.5) / 5) ** 2 + ((xx - 5.5) / 6) ** 2 <= 1
    mask[-2, :10, :12] = blank
    img[-2, :10, :12] = np.where(blank, 500.0, 0.0)
    hw[-2], vmm[-2] = (10, 12), (500, 500)
    mask[-1, :3, :3] = True
    img[-1, :3, :3] = 1 + np.arange(9).reshape(3, 3) % 2
    hw[-1], vmm[-1] = (3, 3), (1, 2)
    _CACHE[size] = (img, mask, hw[:, 0].copy(), hw[:, 1].copy(),
                    vmm[:, 0].copy(), vmm[:, 1].copy())
    return _CACHE[size]


def _aabb(hts, wds, size):
    ys, xs = np.mgrid[0:size, 0:size]
    return (ys[None] < hts[:, None, None]) & (xs[None] < wds[:, None, None])


def _raw(img):
    """K10's raw sums of the masked intensities, which Zernike reads."""
    return tmoments.power_sums_plain([torch.from_numpy(img)])[:, 0]


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    zero = want == 0
    np.testing.assert_array_equal(np.signbit(got[zero]), np.signbit(want[zero]))


@pytest.mark.parametrize("bank", list(BANKS))
@pytest.mark.parametrize("size", [16, 32])
def test_gabor_vs_jax(size, bank):
    img, _, hts, wds, vmin, vmax = _bucket(size)
    jcfg = JConfig(precision="f64", **BANKS[bank])
    tcfg = TConfig(precision="f64", **BANKS[bank])
    want = np.asarray(jgabor.gabor_features(
        jnp.asarray(img), jnp.asarray(_aabb(hts, wds, size)),
        jnp.asarray(vmin), jnp.asarray(vmax), jcfg, jnp.float64)["GABOR"])
    got = tgabor.gabor_features(
        torch.from_numpy(img), torch.from_numpy(hts), torch.from_numpy(wds),
        torch.from_numpy(vmin), torch.from_numpy(vmax), tcfg,
        torch.float64)["GABOR"].numpy()
    assert got.shape == want.shape == (len(img), len(tcfg.gabor_thetas))
    _assert_close(got, want)
    # the blank ROI scores 0.0, the flat-baseline one noval (-0.0)
    assert (got[-2] == 0).all() and not np.signbit(got[-2]).any()
    assert (got[-1] == 0).all() and np.signbit(got[-1]).all()
    assert (got[:-2] > 0).any()


def test_gabor_counts_of_the_flat_and_empty_rois():
    """The plain counts: the flat ROI's baseline max equals its min; an
    ROI with an empty AABB has max -inf, min +inf and no counts."""
    img, _, hts, wds, _, _ = _bucket(16)
    hts = hts.copy()
    hts[0] = 0
    counts, mx, mn = tgabor.gabor_counts_plain(
        torch.from_numpy(img), torch.from_numpy(hts), torch.from_numpy(wds),
        TConfig())
    assert mx[-1] == mn[-1] == 0
    assert mx[0] == -math.inf and mn[0] == math.inf
    assert (counts[0] == 0).all() and counts.dtype == torch.int32


@pytest.mark.parametrize("size", [16, 32])
def test_zernike_vs_jax(size):
    img, _, hts, wds, vmin, vmax = _bucket(size)
    want = np.asarray(jzernike.zernike_features(
        jnp.asarray(img), jnp.asarray(hts), jnp.asarray(wds),
        jnp.asarray(vmin), jnp.asarray(vmax), -0.0, jnp.float64)["ZERNIKE2D"])
    got = tzernike.zernike_features(
        torch.from_numpy(img), torch.from_numpy(hts), torch.from_numpy(wds),
        torch.from_numpy(vmin), torch.from_numpy(vmax), -0.0,
        torch.float64, _raw(img))["ZERNIKE2D"].numpy()
    assert got.shape == want.shape == (len(img), 30)
    _assert_close(got, want)
    assert np.signbit(got[-2]).all() and (got[-2] == 0).all()   # blank
    assert (got[:-2, 0] > 0).all()


@pytest.mark.parametrize("bank", list(BANKS))
def test_gabor_against_numpy_oracle(bank):
    """tests/test_gabor_zernike.py's scipy oracle on each ROI's AABB crop,
    at rel 1e-6."""
    img, _, hts, wds, vmin, vmax = _bucket(32)
    cfg = TConfig(precision="f64", **BANKS[bank])
    got = tgabor.gabor_features(
        torch.from_numpy(img), torch.from_numpy(hts), torch.from_numpy(wds),
        torch.from_numpy(vmin), torch.from_numpy(vmax), cfg,
        torch.float64)["GABOR"].numpy()
    for b in range(len(img) - 2):
        crop = img[b, :hts[b], :wds[b]]
        want = oracles.gabor_oracle(crop, cfg)
        np.testing.assert_allclose(got[b], want, rtol=1e-6)


def test_zernike_against_numpy_oracle():
    """tests/test_gabor_zernike.py's literal mb_zernike2D on each ROI's
    AABB crop, at rel 1e-7 / abs 1e-10."""
    img, _, hts, wds, vmin, vmax = _bucket(16)
    got = tzernike.zernike_features(
        torch.from_numpy(img), torch.from_numpy(hts), torch.from_numpy(wds),
        torch.from_numpy(vmin), torch.from_numpy(vmax), -0.0,
        torch.float64, _raw(img))["ZERNIKE2D"].numpy()
    for b in range(len(img) - 2):
        want = oracles.zernike_oracle(img[b, :hts[b], :wds[b]])
        np.testing.assert_allclose(got[b], want, rtol=1e-7, atol=1e-10)


def test_zernike_sums_scale():
    """The plain sums with their scale: |sum| <= sum of |terms|, and the
    terms of the blank ROI (one intensity) are those of any other."""
    img, _, hts, wds, _, _ = _bucket(16)
    t = torch.from_numpy(img)
    cx, cy, rad, s = tzernike.zernike_inputs(_raw(img), torch.from_numpy(hts),
                                             torch.from_numpy(wds), t.dtype)
    sums, scale = tzernike.zernike_sums_plain(t, cx, cy, rad, s, scale=True)
    assert sums.dtype == scale.dtype == torch.float64
    assert (sums.abs() <= scale * (1 + 1e-12)).all()
    assert torch.equal(sums, tzernike.zernike_sums_plain(t, cx, cy, rad, s))
    # the zeroth moment is the disk's share of the intensity
    assert ((scale[:, 0, 0] > 0) & (scale[:, 0, 0] <= 1 + 1e-12)).all()


@pytest.mark.parametrize("bank", list(BANKS))
def test_filter_bank_equals_jax(bank):
    """The port's taps, from its own copy of gabor_kernel, equal the JAX
    package's bit for bit: the baseline filter, then each (theta, freq)
    pair with the reference's swapped unpacking (filter 0 has f0 = 0)."""
    cfg = TConfig(**BANKS[bank])
    n = cfg.gabor_kersize
    want = [jgabor.gabor_kernel(cfg.gabor_f0, cfg.gabor_sig2lam,
                                cfg.gabor_gamma, math.pi / 2, n)]
    for th, fr in zip(cfg.gabor_thetas, cfg.gabor_freqs):
        want.append(jgabor.gabor_kernel(math.radians(th), cfg.gabor_sig2lam,
                                        cfg.gabor_gamma, float(fr), n))
    bank64 = tgabor.filter_bank(cfg, torch.float64, "cpu").numpy()
    assert bank64.shape == (len(want), 2, n, n)
    for k, (kr, ki) in enumerate(want):
        np.testing.assert_array_equal(bank64[k, 0], kr)
        np.testing.assert_array_equal(bank64[k, 1], ki)
    flat = tgabor.gabor_kernel(0.0, cfg.gabor_sig2lam, cfg.gabor_gamma, 0.3, n)
    jflat = jgabor.gabor_kernel(0.0, cfg.gabor_sig2lam, cfg.gabor_gamma, 0.3, n)
    for a, b in zip(flat, jflat):
        np.testing.assert_array_equal(a, b)
    assert (flat[1] == 0).all() and np.unique(flat[0]).size == 1
    bank32 = tgabor.filter_bank(cfg, torch.float32, "cpu")
    assert bank32.dtype == torch.float32
    assert tgabor.filter_bank(cfg, torch.float32, "cpu") is bank32   # cached


def test_h_tables_equal_jax():
    for a, b in zip(tzernike._h_tables(), jzernike._h_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tzernike._H_ALL[2], jzernike._H3)
    assert tzernike.NM[:4] == [(0, 0), (1, 1), (2, 0), (2, 2)]
    assert len(tzernike.NM) == 30
