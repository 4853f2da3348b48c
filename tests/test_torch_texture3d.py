"""The PyTorch port's 3D texture functions (nyxus_tpu_torch/ops/texture3d.py,
the 3D zone helpers of ops/zones.py, ngtdm_stats' IBSI gate and K1 above
shared-memory size) against the JAX package's (nyxus_tpu/ops/texture3d.py,
ops/zones.py, ops/ngtdm.py, ops/common.py), in f64 on the CPU, where the
port runs the plain versions of its kernels K1 and K13-K16
(tests/test_torch_cuda.py holds the kernels against those plain versions on
the card).

Inputs are made with numpy from a seed: batches of B = 3 cubes of 8 x 16 x
16 and 16 x 16 x 16 voxels whose ROIs fill AABBs of different sizes, with a
few grey levels so that runs and zones are long, at MATLAB-binned levels
(1-based, background level 1 inside the AABB) and at raw levels (0 =
background).  Matrices, labels, distances and counts are integers and must
be equal; statistics hold rtol 1e-9, and the entropies that go through
fast_log2 5e-7 (as tests/test_texture3d.py:20-27)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nyxus_tpu.ops import common as jcommon
from nyxus_tpu.ops import ngtdm as jngtdm
from nyxus_tpu.ops import texture3d as jt3
from nyxus_tpu.ops import zones as jzones

from nyxus_tpu_torch.ops import common as tcommon
from nyxus_tpu_torch.ops import ngtdm as tngtdm
from nyxus_tpu_torch.ops import texture3d as tt3
from nyxus_tpu_torch.ops import zones as tzones
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

SHAPES = [(8, 16, 16), (16, 16, 16)]
# per-ROI AABB sizes (depth, height, width) inside a cube of each shape
DIMS = {(8, 16, 16): [(8, 16, 16), (5, 11, 13), (7, 9, 16)],
        (16, 16, 16): [(16, 16, 16), (9, 14, 5), (12, 3, 11)]}
ENTROPY = ("ENTRO", "_JE", "_RE", "_ZE", "_DE", "INFOMEAS", "_ZDE", "DCENT")
NOVAL = float("nan")


def _case(shape, seed, nlev=4, raw=False):
    """(levels, intens, depths, heights, widths) numpy arrays of one batch:
    intensities in 1..999 on an ellipsoid ROI with ~10% holes in each AABB
    (0 elsewhere), binned MATLAB-style to ``nlev`` levels or kept as raw
    levels 0..nlev."""
    r = np.random.default_rng(seed)
    D, H, W = shape
    dims = np.asarray(DIMS[shape], np.int32)
    B = len(dims)
    zz, yy, xx = np.mgrid[0:D, 0:H, 0:W]
    intens = np.zeros((B,) + shape)
    levels = np.zeros((B,) + shape, np.int32)
    for b, (d, h, w) in enumerate(dims):
        roi = ((((zz - (d - 1) / 2) / max(d / 2, 0.5)) ** 2
                + ((yy - (h - 1) / 2) / max(h / 2, 0.5)) ** 2
                + ((xx - (w - 1) / 2) / max(w / 2, 0.5)) ** 2) <= 1.3) \
            & (zz < d) & (yy < h) & (xx < w) & (r.random(shape) < 0.9)
        lv = r.integers(1, nlev + 1, shape)
        # slabs of one level, so runs and zones grow long
        lv[:, : h // 2] = 1 + (b % nlev)
        intens[b] = np.where(roi, lv * 100 + r.integers(0, 99, shape), 0)
        inb = (zz < d) & (yy < h) & (xx < w)
        levels[b] = np.where(roi, lv, 0) if raw else np.where(inb, np.where(
            roi, lv, 1), 1)
    return levels, intens, dims[:, 0], dims[:, 1], dims[:, 2]


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_members(got, want, tight=1e-9):
    assert sorted(got) == sorted(want)
    for m in want:
        tol = 5e-7 if any(t in m for t in ENTROPY) else tight
        np.testing.assert_allclose(_np(got[m]), _np(want[m]), rtol=tol,
                                   atol=1e-300, equal_nan=True, err_msg=m)


def _aabb(levels, dd, hh, ww):
    return np.asarray(jt3._in_aabb3d(levels.shape[1:], _j(dd), _j(hh),
                                     _j(ww)))


@pytest.mark.parametrize("shift", [(1, 0, 0), (-2, 1, 3), (0, -1, -1),
                                   (20, 0, 0)])
def test_shifted3d_and_aabb(shift):
    lev, _, dd, hh, ww = _case((8, 16, 16), 0)
    dx, dy, dz = shift
    np.testing.assert_array_equal(
        _np(tt3.shifted3d(_t(lev), dx, dy, dz, fill=-5)),
        _np(jt3.shifted3d(_j(lev), dx, dy, dz, fill=-5)))
    np.testing.assert_array_equal(
        _np(tt3._in_aabb3d(lev.shape[1:], _t(dd), _t(hh), _t(ww))),
        _aabb(lev, dd, hh, ww))


def test_shift_tables():
    for name in ("GLCM_SHIFTS", "GLRLM_SHIFTS", "N26", "N6", "N24_NGLDM"):
        assert getattr(tt3, name) == getattr(jt3, name), name
    assert len(tt3.N24_NGLDM) == 24


def _jit(fn, *arrays, record=None, stub=None):
    """fn(*arrays) under jax.jit (one compile is far quicker than the
    eager op-by-op run of these loops).  ``stub=(module, name)`` replaces
    module.name with a function returning its first argument while fn is
    traced; ``record=(module, name)`` also returns the first two arguments
    of every call to module.name made meanwhile."""
    def body(*arrs):
        log, saved = [], []
        for spec, make in ((stub, lambda f: lambda M, *a, **k: M),
                           (record, lambda f: lambda *a, **k: (
                               log.append(a[:2]), f(*a, **k))[1])):
            if spec is not None:
                mod, name = spec
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, make(getattr(mod, name)))
        try:
            out = fn(*arrs)
        finally:
            for mod, name, f in saved:
                setattr(mod, name, f)
        return (out, log) if record is not None else out
    return jax.jit(body)(*[_j(a) for a in arrays])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("greyinfo", [6, 0])
def test_glcm3d(shape, offset, greyinfo):
    """K13's plain version equals the JAX matrices (neighbour level on axis
    -2, MATLAB mode not symmetric, IBSI symmetric), and the features
    agree."""
    lev, _, dd, hh, ww = _case(shape, 1, nlev=6, raw=greyinfo == 0)
    aabb = _aabb(lev, dd, hh, ww)
    vmin = np.asarray([1.0, 2.0, 3.0])
    vmax = np.asarray([500.0, 2.0, 600.0])   # ROI 1 degenerate
    ng, sym = 6, greyinfo == 0
    got = tt3.glcm3d_cooc(_t(lev), _t(dd), _t(hh), _t(ww), offset, ng, sym,
                          greyinfo == 0, torch.float64)
    ng_val = vmax if greyinfo == 0 else None
    jfn = lambda lv, ab, v0, v1, *nv: jt3.glcm3d_all(
        lv, ab, v0, v1, offset, ng, sym, greyinfo, NOVAL, jnp.float64,
        nv[0] if nv else None)
    args = (lev, aabb, vmin, vmax) + (() if ng_val is None else (ng_val,))
    want = _jit(jfn, *args, stub=(jt3, "glcm3d_finalize"))
    np.testing.assert_array_equal(_np(got), _np(want))
    assert float(got.sum()) > 0
    if not sym:
        assert not torch.equal(got, got.transpose(-1, -2))
    # the features op by op (jitted, XLA fuses fast_log2's multiply-add,
    # which moves INFOMEAS1 by ~1e-6 at six levels)
    _close_members(
        tt3.glcm3d_all(_t(lev), _t(dd), _t(hh), _t(ww), _t(vmin), _t(vmax),
                       offset, ng, sym, greyinfo, NOVAL, torch.float64,
                       None if ng_val is None else _t(ng_val)),
        jt3.glcm3d_finalize(want, _j(vmin), _j(vmax), greyinfo, NOVAL,
                            jnp.float64, None if ng_val is None
                            else _j(ng_val)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("raw", [False, True])
def test_glrlm3d(shape, raw):
    """K14's plain version equals JAX's per-direction run matrices
    (_runs3d), and the features agree."""
    lev, _, dd, hh, ww = _case(shape, 2, nlev=3, raw=raw)
    aabb = _aabb(lev, dd, hh, ww)
    valid = aabb & (lev > 0) if raw else aabb
    ng, nr = 4, max(shape)
    got = tt3.glrlm3d_runs(_t(lev), _t(valid), ng, nr, torch.float64)
    want = _jit(lambda lv, va: jnp.stack(
        [jt3._runs3d(lv, va, d, ng, nr, jnp.float64)
         for d in jt3.GLRLM_SHIFTS], axis=1), lev, valid)
    np.testing.assert_array_equal(_np(got), want)
    assert float(got[..., 1:].sum()) > 0       # runs longer than one
    npx = valid.reshape(3, -1).sum(1)
    vmin = np.asarray([1.0, 1.0, 3.0])
    vmax = np.asarray([9.0, 1.0, 5.0])
    _close_members(
        tt3.glrlm3d_all(_t(lev), _t(valid), _t(npx), _t(vmin), _t(vmax), ng,
                        nr, NOVAL, torch.float64),
        _jit(lambda *a: jt3.glrlm3d_all(*a, ng, nr, NOVAL, jnp.float64),
             lev, valid, npx, vmin, vmax))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("conn", [26, 6])
def test_cc3d_labels_and_border_distance(shape, conn):
    """K15's plain labels equal the JAX fixpoint's (lowest raster index,
    D*H*W off valid), and the 6-connectivity distances JAX's
    border_distance3d."""
    lev, _, dd, hh, ww = _case(shape, 3, nlev=2, raw=True)
    aabb = _aabb(lev, dd, hh, ww)
    valid = aabb & (lev > 0)
    got, dist = tt3.cc3d(_t(lev), _t(valid), conn, _t(hh), _t(ww))
    nbhd = jt3.N26 if conn == 26 else jt3.N6
    want = _jit(lambda lv, va: jt3.cc3d_labels(lv, va, nbhd), lev, valid)
    np.testing.assert_array_equal(_np(got), _np(want))
    n_zones = int((_np(got).reshape(3, -1) == np.arange(np.prod(shape))).sum())
    assert 3 < n_zones < int(valid.sum())
    if conn == 6:
        np.testing.assert_array_equal(
            _np(dist), _np(_jit(jt3.border_distance3d, lev, hh, ww)))
    else:
        assert dist is None


def test_zone_seeds_and_sizes():
    """The port's zone_seeds_and_sizes against the JAX module's on 2D
    labels, and (flattened) against texture3d's _zone_seeds_sizes3d on 3D
    labels."""
    lev, _, dd, hh, ww = _case((8, 16, 16), 4, nlev=2, raw=True)
    valid = _aabb(lev, dd, hh, ww) & (lev > 0)
    anc = _jit(lambda lv, va: jt3.cc3d_labels(lv, va, jt3.N26), lev, valid)
    seed, size = tzones.zone_seeds_and_sizes(_t(np.asarray(anc)), _t(valid))
    jseed, jsize = _jit(jt3._zone_seeds_sizes3d, anc, valid)
    np.testing.assert_array_equal(_np(seed).reshape(3, -1), _np(jseed))
    np.testing.assert_array_equal(_np(size).reshape(3, -1), _np(jsize))
    anc2 = _jit(jzones.zone_labels, lev[:, 0], valid[:, 0])
    seed2, size2 = tzones.zone_seeds_and_sizes(_t(np.asarray(anc2)),
                                               _t(valid[:, 0]))
    jseed2, jsize2 = _jit(jzones.zone_seeds_and_sizes, anc2, valid[:, 0])
    np.testing.assert_array_equal(_np(seed2), _np(jseed2))
    np.testing.assert_array_equal(_np(size2), _np(jsize2))
    assert int(seed.sum()) > 3


@pytest.mark.parametrize("dtype", ["float", "int"])
def test_grouped_run_counts(dtype):
    r = np.random.default_rng(5)
    keys = r.integers(0, 7, (4, 50)).astype(np.float64)
    keys[r.random(keys.shape) < 0.2] = np.inf
    keys[3] = np.inf                                   # an empty row
    jk, jc, jv = jzones.grouped_run_counts(_j(keys))
    tk = _t(keys)
    if dtype == "int":
        big = torch.iinfo(torch.int64).max
        tk = torch.where(torch.isfinite(tk), tk, 0).to(torch.int64)
        tk = torch.where(torch.isfinite(_t(keys)), tk, big)
    ks, cnt, v = tzones.grouped_run_counts(tk)
    np.testing.assert_array_equal(_np(v), _np(jv))
    np.testing.assert_array_equal(_np(cnt), _np(jc))
    np.testing.assert_array_equal(_np(ks)[_np(v)], _np(jk)[_np(jv)])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("raw", [False, True])
def test_glszm3d_and_gldzm3d(shape, raw):
    """The two zone families as the 3D runner calls them: GLSZM on
    where(valid, lev, -1) with valid excluding zeroI, GLDZM on
    where(aabb, lev, 0)."""
    lev, _, dd, hh, ww = _case(shape, 6, nlev=3, raw=raw)
    aabb = _aabb(lev, dd, hh, ww)
    zero_i = 0 if raw else 1
    vmin = np.asarray([1.0, 1.0, 2.0])
    vmax = np.asarray([7.0, 1.0, 3.0])
    area = aabb.reshape(3, -1).sum(1)
    sv = aabb & (lev != zero_i)
    slev = np.where(sv, lev, -1)
    _close_members(
        tt3.glszm3d_all(_t(slev), _t(sv), _t(area), _t(vmin), _t(vmax),
                        NOVAL, torch.float64),
        _jit(lambda *a: jt3.glszm3d_all(*a, NOVAL, jnp.float64),
             slev, sv, area, vmin, vmax))
    dv = aabb & (lev > 0) if raw else aabb
    dlev = np.where(aabb, lev, 0)
    _close_members(
        tt3.gldzm3d_all(_t(dlev), _t(dv), _t(hh), _t(ww), _t(area),
                        _t(vmin), _t(vmax), NOVAL, torch.float64),
        _jit(lambda *a: jt3.gldzm3d_all(*a, NOVAL, jnp.float64),
             dlev, dv, hh, ww, area, vmin, vmax))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("raw", [False, True])
def test_gldm3d(shape, raw):
    """K16's plain N26 counts equal the dependence index JAX hands its
    pair histogram, and the features agree."""
    lev, _, dd, hh, ww = _case(shape, 7, nlev=3, raw=raw)
    aabb = _aabb(lev, dd, hh, ww)
    glev = np.where(aabb, lev, -9)
    zero_i = 0 if raw else 1
    vmin, vmax = np.asarray([1.0, 1.0, 2.0]), np.asarray([5.0, 1.0, 3.0])
    want, log = _jit(lambda lv, ab, v0, v1: jt3.gldm3d_all(
        lv, ab, zero_i, 4, v0, v1, NOVAL, jnp.float64), glev, aabb, vmin,
        vmax, record=(jt3, "pair_hist"))
    same = tt3.stencil3d(_t(glev), _t(aabb), tt3.N26)
    np.testing.assert_array_equal(_np(same).reshape(3, -1), _np(log[0][1]))
    assert int(same.max()) > 3
    _close_members(tt3.gldm3d_all(_t(glev), _t(aabb), zero_i, 4, _t(vmin),
                                  _t(vmax), NOVAL, torch.float64), want)


def _interior(lev, dd, hh, ww):
    D, H, W = lev.shape[1:]
    zs, ys, xs = np.mgrid[0:D, 0:H, 0:W]
    return ((zs >= 1) & (zs < dd[:, None, None, None] - 1)
            & (ys >= 1) & (ys < hh[:, None, None, None] - 1)
            & (xs >= 1) & (xs < ww[:, None, None, None] - 1))


@pytest.mark.parametrize("shape", SHAPES)
def test_ngldm3d(shape):
    """K16's plain N24 counts equal the match index JAX hands its pair
    histogram (unclamped to_grayscale levels), and the features agree."""
    lev, intens, dd, hh, ww = _case(shape, 8, nlev=3)
    aabb = _aabb(lev, dd, hh, ww)
    interior = _interior(lev, dd, hh, ww)
    vmax = intens.reshape(3, -1).max(1)
    vmin = np.asarray([1.0, vmax[1], 100.0])
    tbox = {"interior": _t(interior), "inbounds": _t(aabb)}
    want, log = _jit(lambda it, itr, ab, v1, v0: jt3.ngldm3d_all(
        it, {"interior": itr, "inbounds": ab}, v1, 8, 8, False, v0, NOVAL,
        jnp.float64), intens, interior, aabb, vmax, vmin,
        record=(jt3, "pair_hist"))
    tlev = (_t(intens) * 8 / _t(vmax)[:, None, None, None]).to(torch.int32)
    m = tt3.stencil3d(tlev, _t(aabb), tt3.N24_NGLDM)
    np.testing.assert_array_equal(
        np.clip(_np(m), 0, 24).reshape(3, -1), _np(log[0][1]))
    _close_members(tt3.ngldm3d_all(_t(intens), tbox, _t(vmax), 8, 8, False,
                                   _t(vmin), NOVAL, torch.float64), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("raw", [False, True])
def test_ngtdm3d(monkeypatch, shape, radius, raw):
    """K16's plain window sums give JAX's per-level N and S (the
    masked_bincount inputs: JAX's three calls are the port's one call of
    three channels over the same index), and the features agree, with the
    IBSI gate at raw levels."""
    lev, _, dd, hh, ww = _case(shape, 9, nlev=3, raw=raw)
    aabb = _aabb(lev, dd, hh, ww)
    nlev = np.where(aabb, lev, 0)
    if raw:
        nlev[1] = 0          # nothing above level 0: IBSI-degenerate
    zero_i = 0 if raw else 1
    vmin, vmax = np.asarray([1.0, 1.0, 2.0]), np.asarray([5.0, 4.0, 3.0])
    want, log = _jit(lambda lv, ab, v0, v1: jt3.ngtdm3d_all(
        lv, ab, zero_i, 4, radius, v0, v1, NOVAL, jnp.float64, ibsi=raw),
        nlev, aabb, vmin, vmax, record=(jt3, "masked_bincount"))
    tlog = []
    orig = tt3.masked_bincount
    monkeypatch.setattr(tt3, "masked_bincount", lambda *a: (
        tlog.append(a[:2]), orig(*a))[1])
    got = tt3.ngtdm3d_all(_t(nlev), _t(aabb), zero_i, 4, radius, _t(vmin),
                          _t(vmax), NOVAL, torch.float64, ibsi=raw)
    assert len(tlog) == 1 and len(log) == 3
    tidx, tw = tlog[0]
    assert tuple(tw.shape[:1]) == (3,)
    for c, (jidx, jw) in enumerate(log):
        np.testing.assert_array_equal(_np(tidx), _np(jidx))
        np.testing.assert_allclose(_np(tw[c]), _np(jw), rtol=1e-12)
    _close_members(got, want)
    if raw:
        assert np.isnan(_np(got["NGTDM_COARSENESS"])[1])


@pytest.mark.parametrize("ibsi", [False, True])
def test_ngtdm_stats_signature_and_ibsi_gate(ibsi):
    """ngtdm_stats has the JAX signature; with ibsi the degenerate gate is
    'largest valid level below 1' (ROI 1 has one level, degenerate only
    without ibsi; ROI 2 only zeros, degenerate in both)."""
    r = np.random.default_rng(10)
    nb = 6
    N = r.integers(0, 9, (3, nb)).astype(np.float64)
    N[1] = 0
    N[1, 3] = 5
    N[2] = 0
    N[:, 0] = 0
    S = r.random((3, nb)) * N
    present = N > 0
    levels = np.zeros((3, 4, 5, 5), np.int32)
    levels[0, :, :, :3] = 2
    levels[0, 1] = 4
    levels[1] = 3
    valid = np.ones(levels.shape, bool)
    got = tngtdm.ngtdm_stats(_t(N), _t(S), _t(present), _t(levels),
                             _t(valid), NOVAL, torch.float64, ibsi)
    want = jngtdm.ngtdm_stats(_j(N), _j(S), _j(present), _j(levels),
                              _j(valid), NOVAL, jnp.float64, ibsi)
    _close_members(got, want)
    c = _np(got["NGTDM_CONTRAST"])
    assert np.isnan(c[2]) and np.isnan(c[1]) != ibsi and np.isfinite(c[0])


@pytest.mark.parametrize("nbins", [100, 4096 * 27])
def test_batched_hist_beyond_shared_memory(nbins):
    """K1's plain version at the histogram sizes the card counts in shared
    memory and, at raw 12-bit GLDM cells (4096 x 27, 442 KB), in device
    memory, against the JAX masked_bincount, with 0/1 and float weights."""
    r = np.random.default_rng(11)
    idx = r.integers(-3, nbins + 3, (3, 5000)).astype(np.int32)
    assert nbins * 4 > tcommon.SMEM_MAX or nbins == 100
    for w in (np.ones(idx.shape), r.random(idx.shape)):
        np.testing.assert_allclose(
            _np(tcommon.batched_hist(_t(idx), _t(w), nbins)),
            _np(jcommon.masked_bincount(_j(idx), _j(w), nbins)), rtol=1e-12)


@pytest.mark.parametrize("voxels", [8 ** 3, 32 ** 3, 65535, 64 ** 3,
                                    64 * 256 * 256])
@pytest.mark.parametrize("nr", [1, 32, 64, 65, 256])
@pytest.mark.parametrize("ng", [1, 63, 64, 256, 4096, 4097])
def test_glrlm3d_plan_covers_levels(ng, nr, voxels):
    """K14's launch plan: clusters of at most eight blocks, each block's L
    rows of counts (L a power of two; 16-bit counts only for cubes of at
    most 65535 voxels) within a block's shared memory, and the level ranges
    of the blocks over every pass cover 0..ng-1 exactly once, in order."""
    S, L, P, narrow, smem = tt3.glrlm3d_plan(ng, nr, voxels)
    assert 1 <= S <= tt3.CLUSTER_MAX and P >= 1 and L & (L - 1) == 0
    assert narrow == (voxels <= 65535)
    assert smem == -(-(2 if narrow else 4) * L * nr // 16) * 16
    assert smem <= tcommon.SMEM_MAX
    ranges = tt3.glrlm3d_ranges(ng, S, L, P)
    assert len(ranges) == S * P and all(len(r) <= L for r in ranges)
    assert [i for r in ranges for i in r] == list(range(ng))
    if 2 * ng * nr <= tt3.RUNS3_SHARE and voxels == 8 ** 3:
        assert (S, P) == (1, 1)
    if 4 * ng * nr > tt3.CLUSTER_MAX * tcommon.SMEM_MAX and not narrow:
        assert P > 1
