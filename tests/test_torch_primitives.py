"""The PyTorch port's primitives (nyxus_tpu_torch/ops/common.py, quant.py)
against the JAX package's, on the same numpy inputs.  On the CPU every
kernel wrapper runs its plain version (tests/test_torch_cuda.py holds the
CUDA kernels against those plain versions on the card).

Tolerances: counts, indices, levels and selections must be equal; weighted
float sums, whose summation order differs (one-hot matmul in JAX, scatter
here), hold rtol 1e-12 in f64 and 1e-5 in f32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nyxus_tpu.ops import common as jc
from nyxus_tpu.ops import quant as jq

from nyxus_tpu_torch.ops import common as tc
from nyxus_tpu_torch.ops import quant as tq

import oracle_fastlog

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _j(x):
    return np.asarray(x)


def _t(x):
    return x.cpu().numpy()


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("nbins", [9, 64, 100])
def test_masked_bincount(prec, nbins):
    npdt, tdt = DTYPES[prec]
    r = np.random.default_rng(nbins)
    idx = r.integers(-3, nbins + 3, size=(7, 300)).astype(np.int32)
    cnt = (r.random((7, 300)) < 0.7).astype(npdt)
    w = r.normal(0, 10, (7, 300)).astype(npdt)
    got = _t(tc.masked_bincount(torch.from_numpy(idx), torch.from_numpy(cnt),
                                nbins))
    np.testing.assert_array_equal(
        got, _j(jc.masked_bincount(jnp.asarray(idx), jnp.asarray(cnt), nbins)))
    rtol = 1e-12 if prec == "f64" else 1e-5
    np.testing.assert_allclose(
        _t(tc.masked_bincount(torch.from_numpy(idx), torch.from_numpy(w),
                              nbins)),
        _j(jc.masked_bincount(jnp.asarray(idx), jnp.asarray(w), nbins)),
        rtol=rtol, atol=rtol * 100)


@pytest.mark.parametrize("ni,nj", [(64, 9), (64, 64), (5, 33)])
def test_pair_hist(ni, nj):
    r = np.random.default_rng(ni * nj)
    i = r.integers(-2, ni + 2, size=(5, 400)).astype(np.int32)
    j = r.integers(-2, nj + 2, size=(5, 400)).astype(np.int32)
    w = (r.random((5, 400)) < 0.8).astype(np.float64)
    got = tc.pair_hist(torch.from_numpy(i), torch.from_numpy(j),
                       torch.from_numpy(w), ni, nj)
    want = jc.pair_hist(jnp.asarray(i), jnp.asarray(j), jnp.asarray(w), ni, nj)
    np.testing.assert_array_equal(_t(got), _j(want))
    np.testing.assert_array_equal(
        _t(tc.pair_hist_plain(torch.from_numpy(i), torch.from_numpy(j),
                              torch.from_numpy(w), ni, nj)), _j(want))


@pytest.mark.parametrize("dx,dy", list(jc.NEIGHBORS8) + [(3, -2), (-5, 4),
                                                        (20, 0)])
def test_shifted2d(dx, dy):
    r = np.random.default_rng(abs(dx) * 10 + abs(dy))
    a = r.integers(0, 9, size=(3, 11, 13)).astype(np.int32)
    np.testing.assert_array_equal(
        _t(tc.shifted2d(torch.from_numpy(a), dx, dy)),
        _j(jc.shifted2d(jnp.asarray(a), dx, dy)))
    f = r.random((3, 11, 13))
    np.testing.assert_array_equal(
        _t(tc.shifted2d(torch.from_numpy(f), dx, dy, fill=-1.5)),
        _j(jc.shifted2d(jnp.asarray(f), dx, dy, fill=-1.5)))
    assert tc.NEIGHBORS8 == jc.NEIGHBORS8


def test_sort_take_last_true_safe_div():
    r = np.random.default_rng(1)
    v = np.floor(r.normal(100, 20, (6, 8, 8)))
    m = r.random((6, 8, 8)) < 0.6
    m[2] = False                                   # an empty ROI
    sv = _t(tc.sort_masked_values(torch.from_numpy(v), torch.from_numpy(m)))
    np.testing.assert_array_equal(
        sv, _j(jc.sort_masked_values(jnp.asarray(v), jnp.asarray(m))))
    idx = r.integers(0, 64, 6)
    np.testing.assert_array_equal(
        _t(tc.take_per_row(torch.from_numpy(sv), torch.from_numpy(idx))),
        _j(jc.take_per_row(jnp.asarray(sv), jnp.asarray(idx))))
    cond = r.random((6, 40)) < 0.1
    cond[0] = False
    cand = r.normal(0, 1, (6, 40))
    np.testing.assert_array_equal(
        _t(tc.last_true_value(torch.from_numpy(cond), torch.from_numpy(cand),
                              -7.0)),
        _j(jc.last_true_value(jnp.asarray(cond), jnp.asarray(cand), -7.0)))
    a = r.normal(0, 1, 50)
    b = np.where(r.random(50) < 0.3, 0.0, r.normal(0, 1, 50))
    np.testing.assert_array_equal(
        _t(tc.safe_div(torch.from_numpy(a), torch.from_numpy(b), 3.0)),
        _j(jc.safe_div(jnp.asarray(a), jnp.asarray(b), 3.0)))


def _binning_inputs(npdt):
    """Per-ROI intensities with many values exactly on bin edges: with
    vmax = 640 and 64 levels every multiple of 10 is an edge."""
    r = np.random.default_rng(3)
    vmin = np.array([1.0, 10.0, 7.0, 100.0, 5.0], npdt)
    vmax = np.array([640.0, 650.0, 7.0, 40000.0, 65535.0], npdt)
    x = np.empty((5, 400), npdt)
    for b in range(5):
        edges = np.linspace(vmin[b], vmax[b], 65)
        rnd = np.floor(r.uniform(vmin[b], vmax[b], 300))
        x[b] = np.concatenate([np.floor(edges), np.ceil(edges), [vmin[b]],
                               [vmax[b]], np.zeros(4), rnd])[:400]
    x[:, -6:] = 0
    return x, vmin, vmax


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("greyinfo", [64, 16, -64, -8, 0])
def test_bin_levels(prec, greyinfo):
    npdt, _ = DTYPES[prec]
    x, vmin, vmax = _binning_inputs(npdt)
    got = tq.bin_levels(torch.from_numpy(x), torch.from_numpy(vmin)[:, None],
                        torch.from_numpy(vmax)[:, None], greyinfo)
    want = jq.bin_levels(jnp.asarray(x), jnp.asarray(vmin)[:, None],
                         jnp.asarray(vmax)[:, None], greyinfo)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_t(got), _j(want))
    np.testing.assert_array_equal(
        _t(tq.binned_range_degenerate(torch.from_numpy(vmin),
                                      torch.from_numpy(vmax), greyinfo)),
        _j(jq.binned_range_degenerate(jnp.asarray(vmin), jnp.asarray(vmax),
                                      greyinfo)))


def test_fast_log2_bit_exact():
    """Bit for bit on 1e5 positive float32 values, against the JAX
    function run op by op and against the tests' numpy oracle."""
    r = np.random.default_rng(5)
    x = np.concatenate([r.uniform(0, 1, 40000), 10 ** r.uniform(-30, 30, 40000),
                        r.integers(1, 1 << 20, 20000)]).astype(np.float32)
    got = _t(tc.fast_log2(torch.from_numpy(x)))
    assert got.dtype == np.float32
    want = _j(jc.fast_log2(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    oracle = oracle_fastlog.fast_log2(x).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), oracle.view(np.int32))
    # f64 inputs take the float32 path and come back as f64
    got64 = _t(tc.fast_log2(torch.from_numpy(x.astype(np.float64))))
    np.testing.assert_array_equal(got64, got.astype(np.float64))


def _jax_stencil(lev, part):
    """The JAX package's 8-neighbour loops (gldm.py:33-37, ngtdm.py:37-43)."""
    same = jnp.zeros_like(lev)
    nsum = jnp.zeros_like(lev)
    ncnt = jnp.zeros_like(lev)
    for dx, dy in jc.NEIGHBORS8:
        p = jc.shifted2d(part.astype(jnp.int32), dx, dy) > 0
        m = jc.shifted2d(lev, dx, dy)
        same = same + (p & (m == lev)).astype(lev.dtype)
        nz = p & (m > 0)
        nsum = nsum + jnp.where(nz, m, 0)
        ncnt = ncnt + nz.astype(lev.dtype)
    return same, nsum, ncnt


@pytest.mark.parametrize("shape", [(4, 16, 16), (2, 7, 13)])
def test_stencil8(shape):
    r = np.random.default_rng(shape[1])
    lev = r.integers(0, 4, size=shape).astype(np.int32)
    part = r.random(shape) < 0.7
    got = tc.stencil8(torch.from_numpy(lev), torch.from_numpy(part))
    want = _jax_stencil(jnp.asarray(lev), jnp.asarray(part))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_t(g), _j(w))


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for a CPU tensor."""
    idx = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    w = torch.zeros((2, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        tc.batched_hist(idx, w, 4)
    with pytest.raises(ValueError):
        tc.stencil8(idx.reshape(1, 2, 3), w.reshape(1, 2, 3) > 0)
