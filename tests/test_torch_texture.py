"""The PyTorch port's texture matrix builders and family functions against
the JAX package's, on the same padded ROI buckets (16 x 16 and 32 x 32 crops
of conftest.make_blobs slides) at grey depths 64 (MATLAB binning) and -64
(radiomics binning), in f64 on the CPU.  The port runs the plain versions of
its kernels here (tests/test_torch_cuda.py holds the CUDA kernels against
those plain versions on the card).

The JAX side runs under jax.jit, as its runner runs it.

Tolerances: matrices, counts, levels and ranks must be equal.  Feature
values hold rtol 1e-9 / atol 1e-12, except the entropy members: XLA
contracts the multiply-add of the JAX package's jitted fast_log2 into an
FMA, so about 9% of its float32 logs sit 1 ulp from the unfused formula the
port computes (bit-identical to the numpy oracle and to the JAX function run
op by op, see test_torch_primitives), which moves an entropy by up to ~1e-7
relative; they hold rtol 5e-7, as the JAX package's own oracle tests do.
GLSZM's ZE is one of them; GLDZM's ZDE and NGLDM's DCENT use the exact log2
and hold rtol 1e-9 like every other member.
The NGTDM difference sums S, float sums in another order, hold rtol 1e-12."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_blobs

import nyxus_tpu.registry as jreg
from nyxus_tpu.config import EngineConfig as JConfig
from nyxus_tpu.ops import common as jc
from nyxus_tpu.ops import glcm as jglcm
from nyxus_tpu.ops import gldm as jgldm
from nyxus_tpu.ops import glrlm as jglrlm

import nyxus_tpu_torch.registry as treg
from nyxus_tpu_torch.config import EngineConfig as TConfig
from nyxus_tpu_torch.ops import common as tcommon
from nyxus_tpu_torch.ops import glcm as tglcm
from nyxus_tpu_torch.ops import gldm as tgldm
from nyxus_tpu_torch.ops import glrlm as tglrlm
from nyxus_tpu_torch.ops import ngtdm as tngtdm
from nyxus_tpu_torch.pipeline import batching, labels
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

SIZES = (16, 32)
DEPTHS = (64, -64)
FAMILIES = ("PixelIntensityFeatures", "GLCMFeature", "GLRLMFeature",
            "NGTDMFeature", "GLDMFeature", "NGLDMfeature", "GLSZMFeature",
            "GLDZMFeature")


def _bucket_arrays(size):
    """Padded crops of every ROI of a seeded slide whose bucket is
    size x size, assembled like the runners' dense path."""
    rmin, rmax = {16: (3, 7), 32: (8, 14)}[size]
    intens, lab = make_blobs(h=128, w=128, n_blobs=9, seed=size,
                             rmin=rmin, rmax=rmax)
    recs, smin, smax = labels._discover_rois_np(intens, lab)
    recs = [r for r in recs
            if batching.bucket_shape(r.height, r.width) == (size, size)]
    assert len(recs) >= 3
    B = len(recs)
    ci = np.zeros((B, size, size))
    cm = np.zeros((B, size, size), bool)
    for bi, r in enumerate(recs):
        h = min(size, lab.shape[0] - r.y0)
        w = min(size, lab.shape[1] - r.x0)
        ci[bi, :h, :w] = intens[r.y0:r.y0 + h, r.x0:r.x0 + w]
        cm[bi, :h, :w] = lab[r.y0:r.y0 + h, r.x0:r.x0 + w] == r.label
    return dict(
        intens=ci, mask=cm,
        area=np.array([r.area for r in recs], np.int32),
        vmin=np.array([r.vmin for r in recs]),
        vmax=np.array([r.vmax for r in recs]),
        heights=np.array([r.height for r in recs], np.int32),
        widths=np.array([r.width for r in recs], np.int32),
        smin=np.full(B, smin), smax=np.full(B, smax))


_CACHE = {}
_KEYS = ("intens", "mask", "area", "vmin", "vmax", "smin", "smax", "heights",
         "widths")
# entropy members: see the module docstring
_ENTROPY = ("ENTRO", "_JE", "_RE", "_DE", "INFOMEAS", "GLSZM_ZE")


def _arrays(size):
    if size not in _CACHE:
        _CACHE[size] = _bucket_arrays(size)
    return _CACHE[size]


def _jax(size, depth, fn):
    """fn(ctx, cfg) of the JAX package, under jax.jit, on the bucket."""
    cfg = JConfig(precision="f64", coarse_gray_depth=depth)

    def run(*arrs):
        d = dict(zip(_KEYS, arrs))
        zero = jnp.zeros_like(d["area"])
        ctx = jreg.BatchContext(d["intens"], d["mask"], d["area"], d["vmin"],
                                d["vmax"], zero, zero, d["smin"], d["smax"],
                                cfg, heights=d["heights"], widths=d["widths"])
        return fn(ctx, cfg)

    a = _arrays(size)
    return jax.jit(run)(*(jnp.asarray(a[k]) for k in _KEYS))


def _torch(size, depth, fn):
    """fn(ctx, cfg) of the port, on the bucket."""
    a = _arrays(size)
    cfg = TConfig(precision="f64", coarse_gray_depth=depth)
    ctx = treg.BatchContext(*(torch.from_numpy(a[k]) for k in _KEYS), cfg)
    return fn(ctx, cfg)


def _valid(ctx, levels, depth):
    return ctx.aabb_mask if depth > 0 else ctx.aabb_mask & (levels > 0)


def _eq(t, j):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_levels(size, depth):
    def fn(ctx, cfg):
        return (ctx.texture_levels(depth), ctx.masked_intens, ctx.aabb_mask,
                ctx.sorted_values)
    for t, j in zip(_torch(size, depth, fn), _jax(size, depth, fn)):
        _eq(t, j)


def _cooc(mod, symmetric):
    def fn(ctx, cfg):
        return mod.cooc_matrices(ctx.masked_intens,
                                 ctx.texture_levels(cfg.coarse_gray_depth),
                                 cfg.glcm_angles, cfg.glcm_offset,
                                 abs(cfg.coarse_gray_depth), symmetric)
    return fn


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("symmetric", [False, True])
def test_cooc_matrices(size, depth, symmetric):
    _eq(_torch(size, depth, _cooc(tglcm, symmetric)),
        _jax(size, depth, _cooc(jglcm, symmetric)))


@pytest.mark.parametrize("size", SIZES)
def test_radiomics_rank_info(size):
    def fn(ctx, cfg):
        lev = ctx.texture_levels(-64)
        mod, dt = (tglcm, torch.float64) if isinstance(lev, torch.Tensor) \
            else (jglcm, jnp.float64)
        info = mod.radiomics_rank_info(lev, ctx.masked_intens > 0, 64, dt)
        if mod is tglcm:
            return info + (mod._rank_per_pixel(lev, info[0], 64),)
        return info + (mod._rank_per_pixel(lev, info[0], 64, dt),)
    for t, j in zip(_torch(size, -64, fn), _jax(size, -64, fn)):
        _eq(t, j)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_run_matrices(size, depth):
    def tfn(ctx, cfg):
        lev = ctx.texture_levels(depth)
        return tglrlm.run_matrices(lev, _valid(ctx, lev, depth), abs(depth),
                                   size, torch.float64)

    def jfn(ctx, cfg):
        lev = ctx.texture_levels(depth)
        return jglrlm.run_matrices(lev, _valid(ctx, lev, depth), abs(depth),
                                   size)
    P = _torch(size, depth, tfn)
    assert P.dtype == torch.float64
    _eq(P, _jax(size, depth, jfn))


def _diagonal_crop(anti):
    """An 8 x 8 crop whose only valid pixels form one run of level 3 along
    45 deg (x - y constant) or 135 deg (x + y constant)."""
    lev = np.ones((1, 8, 8), np.int32)
    valid = np.zeros((1, 8, 8), bool)
    for k in range(5):
        y, x = (1 + k, 6 - k) if anti else (2 + k, 1 + k)
        lev[0, y, x] = 3
        valid[0, y, x] = True
    return lev, valid


@pytest.mark.parametrize("anti", [False, True])
def test_run_matrices_single_diagonal(anti):
    lev, valid = _diagonal_crop(anti)
    P = tglrlm.run_matrices(torch.from_numpy(lev), torch.from_numpy(valid), 4,
                            8, torch.float64).numpy()[0]
    want = np.zeros((4, 4, 8))
    run_angle = 3 if anti else 1            # angles 0, 45, 90, 135
    for a in range(4):
        if a == run_angle:
            want[a, 2, 4] = 1               # one run of level 3, length 5
        else:
            want[a, 2, 0] = 5               # five runs of length 1
    np.testing.assert_array_equal(P, want)
    jrun = jax.jit(jglrlm.run_matrices, static_argnums=(2, 3))
    np.testing.assert_array_equal(
        P, np.asarray(jrun(jnp.asarray(lev), jnp.asarray(valid), 4, 8))[0])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_gldm_matrix(size, depth):
    def fn(ctx, cfg):
        t = isinstance(ctx.intens, torch.Tensor)
        mod, dt = (tgldm, torch.float64) if t else (jgldm, jnp.float64)
        return mod.gldm_matrix(ctx.masked_intens, ctx.texture_levels(depth),
                               abs(depth), dt)
    _eq(_torch(size, depth, fn), _jax(size, depth, fn))


def _jax_ngtdm_matrices(levels, valid, nmax):
    """N, S, present exactly as nyxus_tpu/ops/ngtdm.py:32-57 builds them."""
    B = levels.shape[0]
    lev = jnp.where(valid, levels, 0)
    lev_f = lev.astype(jnp.float64)
    nz = lev > 0
    neig_sum = jnp.zeros_like(lev_f)
    neig_cnt = jnp.zeros_like(lev_f)
    for dx, dy in jc.NEIGHBORS8:
        ok = (jc.shifted2d(nz.astype(jnp.int32), dx, dy) > 0).astype(lev_f.dtype)
        neig_sum = neig_sum + jc.shifted2d(lev_f, dx, dy) * ok
        neig_cnt = neig_cnt + ok
    is_zone = nz & (neig_cnt > 0)
    ave = jnp.where(is_zone, neig_sum / jnp.maximum(neig_cnt, 1), 0)
    flat = lev.reshape(B, -1)
    wz = is_zone.reshape(B, -1).astype(lev_f.dtype)
    N = jc.masked_bincount(flat, wz, nmax + 1)
    S = jc.masked_bincount(flat, wz * jnp.abs(lev_f - ave).reshape(B, -1),
                           nmax + 1)
    present = jc.masked_bincount(flat, valid.reshape(B, -1).astype(
        lev_f.dtype), nmax + 1) > 0
    return N, S, present.at[:, 0].set(False)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_ngtdm_matrices(size, depth):
    def tfn(ctx, cfg):
        lev = ctx.texture_levels(depth)
        return tngtdm.ngtdm_matrices(lev, _valid(ctx, lev, depth), abs(depth),
                                     torch.float64)

    def jfn(ctx, cfg):
        lev = ctx.texture_levels(depth)
        return _jax_ngtdm_matrices(lev, _valid(ctx, lev, depth), abs(depth))
    (tN, tS, tp), (jN, jS, jp) = _torch(size, depth, tfn), \
        _jax(size, depth, jfn)
    _eq(tN, jN)
    _eq(tp, jp)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("depth", DEPTHS)
def test_ngtdm_matrices_one_histogram_call(depth, monkeypatch):
    """On the CPU N, S and the present levels come from one histogram of
    three channels over the levels (the plain version of K4, which forms
    all three in one launch on the card; JAX: three masked_bincount calls),
    equal to JAX's."""
    calls = []
    orig = tcommon.batched_hist_plain

    def tfn(ctx, cfg):
        lev = ctx.texture_levels(depth)
        valid = _valid(ctx, lev, depth)
        monkeypatch.setattr(tcommon, "batched_hist_plain", lambda *a: (
            calls.append(tuple(a[1].shape)), orig(*a))[1])
        return tngtdm.ngtdm_matrices(lev, valid, abs(depth), torch.float64)
    tN, _, tp = _torch(32, depth, tfn)
    # the channel call, then its own call over the C * B rows
    assert len(calls) == 2 and calls[0][0] == 3
    assert calls[1] == (calls[0][0] * calls[0][1], calls[0][2])
    assert tuple(tN.shape) == calls[0][1:2] + (abs(depth) + 1,)
    assert tp.dtype == torch.bool and not bool(tp[:, 0].any())


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("family", FAMILIES)
def test_family_members(family, size, depth):
    """Every member of each family's output dict."""
    want = _jax(size, depth, jreg.FAMILIES[family].fn)
    got = _torch(size, depth, treg.FAMILIES[family].fn)
    assert sorted(got) == sorted(want)
    for m in want:
        g = got[m].numpy()
        w = np.asarray(want[m])
        assert g.shape == w.shape, m
        rtol = 5e-7 if any(t in m for t in _ENTROPY) else 1e-9
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-12, err_msg=m)
        # the soft-NAN placeholder is -0.0: signs of zeros must agree
        np.testing.assert_array_equal(np.signbit(g[w == 0]),
                                      np.signbit(w[w == 0]), err_msg=m)
