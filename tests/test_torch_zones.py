"""The PyTorch port's zone labelling, border distance, zone lists and grouped
sums (nyxus_tpu_torch/ops/zones.py) against the JAX package's
(nyxus_tpu/ops/zones.py, ops/gldzm.py), in f64 on the CPU, where the port
runs the plain versions of its kernels K5-K7 (tests/test_torch_cuda.py holds
the kernels against those plain versions on the card).

Inputs: the 16 x 16 and 32 x 32 buckets of test_torch_texture (crops of
conftest.make_blobs slides) at grey depths 64 (MATLAB binning, background
takes part as level 1) and -64 (radiomics binning, background is level 0),
plus hand-made crops: the directed-scan pattern of tests/test_zones.py, a
spiral and a comb whose zones need many fixpoint rounds.

Labels, distances and zone lists are integers and must be equal.  The
port's zone_list returns the zones in raster order of their seeds and the
JAX one in sorted-label order, so each ROI's multiset of (level, size[,
distance]) is compared, and the port's layout (zone p at position p) is
checked on its own.  Grouped sums hold rtol 1e-12: float sums of the same
terms in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracle_zones
from test_torch_texture import DEPTHS, SIZES, _jax, _torch

from nyxus_tpu.ops import gldzm as jgldzm
from nyxus_tpu.ops import zones as jzones

from nyxus_tpu_torch.ops import common as tcommon
from nyxus_tpu_torch.ops import zones as tzones
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)


def _zone_inputs(ctx, depth):
    """(levels, valid) as the GLSZM/GLDZM families hand them to the zone
    code: levels zeroed off the participation mask."""
    lev = ctx.texture_levels(depth)
    valid = ctx.aabb_mask if depth > 0 else ctx.aabb_mask & (lev > 0)
    where = torch.where if isinstance(lev, torch.Tensor) else jnp.where
    return where(valid, lev, 0), valid


# the port's counterparts of the JAX labelling functions: K6 computes the
# GLDZM labels together with the border distances
PORT_LABELS = {
    "zone_labels": lambda lev, valid, hts, wds: tzones.zone_labels(lev,
                                                                   valid),
    "zone_labels_cc4": lambda lev, valid, hts, wds: tzones.zone_cc4(
        lev, valid, hts, wds)[0],
}


def _labels_fn(name):
    def fn(ctx, cfg):
        lev, valid = _zone_inputs(ctx, cfg.coarse_gray_depth)
        if isinstance(lev, torch.Tensor):
            return PORT_LABELS[name](lev, valid, ctx.heights, ctx.widths)
        return getattr(jzones, name)(lev, valid)
    return fn


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("name", ["zone_labels", "zone_labels_cc4"])
def test_labels_on_buckets(name, size, depth):
    got = _np(_torch(size, depth, _labels_fn(name)))
    want = _np(_jax(size, depth, _labels_fn(name)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert (got < size * size).any()


def _spiral(n=24):
    """A one-pixel-wide square spiral of level 2, walked inward from the
    top-left corner with a one-pixel gap of level 1 between its turns."""
    lev = np.ones((n, n), np.int32)
    y, x = 0, 0
    lev[y, x] = 2
    steps = [n - 1] * 3 + [k for k in range(n - 3, 0, -2) for _ in (0, 1)]
    for i, length in enumerate(steps):
        dy, dx = ((0, 1), (1, 0), (0, -1), (-1, 0))[i % 4]
        for _ in range(length):
            y, x = y + dy, x + dx
            lev[y, x] = 2
    return lev


def _comb(n=24):
    """Vertical teeth of level 3 joined only along the bottom row; the
    seeds sit at the top of each tooth, so labels flow down and back up."""
    lev = np.ones((n, n), np.int32)
    lev[:, ::2] = 3
    lev[-1, :] = 3
    lev[0, 1::4] = 3
    return lev


CROPS = {"spiral": _spiral, "comb": _comb,
         "tricky": lambda: np.pad(np.array([[5, 0, 5], [0, 5, 0]], np.int32),
                                  ((0, 2), (0, 1)))}


@pytest.mark.parametrize("crop", list(CROPS))
@pytest.mark.parametrize("name", ["zone_labels", "zone_labels_cc4"])
def test_labels_on_adversarial_crops(name, crop):
    lev = CROPS[crop]()[None]
    lev = np.concatenate([lev, np.where(lev == lev.max(), 0, lev)])
    valid = lev > 0
    B, H, W = lev.shape
    got = PORT_LABELS[name](torch.from_numpy(lev), torch.from_numpy(valid),
                            torch.full((B,), H), torch.full((B,), W)).numpy()
    want = np.asarray(jax.jit(getattr(jzones, name))(jnp.asarray(lev),
                                                     jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    if name == "zone_labels":
        for b in range(lev.shape[0]):
            ref = oracle_zones.scan_zones(lev[b], valid[b])
            sizes = np.bincount(got[b][valid[b]])
            assert sorted(sizes[sizes > 0]) == sorted(len(p) for _, p in ref)


def test_tricky_pattern_labels():
    """The directed scan splits what 8-connectivity joins: (0,0), (0,2) and
    (1,1) of equal level are two GLSZM zones, (0,0)+(1,1) and (0,2); under
    4-connectivity all three are alone."""
    lev = torch.zeros((1, 4, 4), dtype=torch.int32)
    lev[0, 0, 0] = lev[0, 0, 2] = lev[0, 1, 1] = 5
    anc = tzones.zone_labels(lev, lev > 0)[0]
    assert (anc[0, 0], anc[1, 1], anc[0, 2]) == (0, 0, 2)
    hw = torch.tensor([4])
    cc4 = tzones.zone_cc4(lev, lev > 0, hw, hw)[0][0]
    assert (cc4[0, 0], cc4[1, 1], cc4[0, 2]) == (0, 5, 2)
    assert (anc[lev[0] == 0] == 16).all() and (cc4[lev[0] == 0] == 16).all()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_border_distance(size, depth):
    def fn(ctx, cfg):
        lev, valid = _zone_inputs(ctx, depth)
        if isinstance(lev, torch.Tensor):
            return tzones.zone_cc4(lev, valid, ctx.heights, ctx.widths)[1]
        return jgldzm.border_distance(lev, ctx.heights, ctx.widths)
    got, want = _np(_torch(size, depth, fn)), _np(_jax(size, depth, fn))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1 and got.max() > 1


def _zone_multisets(zlev, zsize, zdist, ok):
    zlev, zsize, ok = _np(zlev), _np(zsize), _np(ok)
    zdist = None if zdist is None else _np(zdist)
    out = []
    for b in range(ok.shape[0]):
        cols = [zlev[b, ok[b]], zsize[b, ok[b]]]
        if zdist is not None:
            cols.append(zdist[b, ok[b]])
        out.append(sorted(zip(*(c.tolist() for c in cols))))
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("family", ["glszm", "gldzm"])
def test_zone_list(family, size, depth):
    def fn(ctx, cfg):
        lev, valid = _zone_inputs(ctx, depth)
        t = isinstance(lev, torch.Tensor)
        zmod = tzones if t else jzones
        if family == "glszm":
            return zmod.zone_list(zmod.zone_labels(lev, valid), lev, valid)
        if t:
            anc, dist = tzones.zone_cc4(lev, valid, ctx.heights, ctx.widths)
        else:
            anc = jzones.zone_labels_cc4(lev, valid)
            dist = jgldzm.border_distance(lev, ctx.heights, ctx.widths)
        return zmod.zone_list(anc, lev, valid, dist=dist)
    got, want = _torch(size, depth, fn), _jax(size, depth, fn)
    assert _zone_multisets(*got) == _zone_multisets(*want)
    zlev, zsize, zdist, ok = got
    # the port's layout: zone p at position p, zeros elsewhere
    assert ok.dtype == torch.bool and zsize.dtype == torch.int32
    assert (zsize[~ok] == 0).all() and (zlev[~ok] == 0).all()
    assert (zsize[ok] > 0).all()
    if zdist is not None:
        assert (zdist[~ok] == 0).all() and (zdist[ok] >= 1).all()


def _zone_list_crop(kind):
    """(levels, valid, heights, widths) of two 24 x 20 crops: "uniform" one
    level on every valid pixel (one zone), "per_pixel" a distinct level on
    every pixel (a zone a pixel under both scans); the second crop's AABB is
    17 x 13, with zero-level holes."""
    B, H, W = 2, 24, 20
    if kind == "uniform":
        lev = np.full((B, H, W), 5, np.int32)
    else:
        lev = np.broadcast_to(1 + np.arange(H * W, dtype=np.int32).reshape(
            H, W), (B, H, W)).copy()
    valid = np.ones((B, H, W), bool)
    valid[1, 17:] = valid[1, :, 13:] = False
    valid[1] &= np.random.default_rng(5).random((H, W)) < 0.9
    lev = np.where(valid, lev, 0).astype(np.int32)
    return lev, valid, np.array([H, 17], np.int32), np.array([W, 13],
                                                              np.int32)


@pytest.mark.parametrize("family", ["glszm", "gldzm"])
@pytest.mark.parametrize("kind", ["uniform", "per_pixel"])
def test_zone_list_uniform_and_per_pixel(kind, family):
    """K7's extremes against JAX's zone_list, as multisets: one zone holding
    every valid pixel (its size the crop's valid count, its distance the
    least), and a zone a pixel (size 1 everywhere)."""
    lev, valid, hts, wds = _zone_list_crop(kind)
    t = [torch.from_numpy(a) for a in (lev, valid, hts, wds)]
    j = [jnp.asarray(a) for a in (lev, valid, hts, wds)]
    if family == "glszm":
        got = tzones.zone_list(tzones.zone_labels(t[0], t[1]), t[0], t[1])
        want = jax.jit(lambda lv, vd: jzones.zone_list(
            jzones.zone_labels(lv, vd), lv, vd))(j[0], j[1])
    else:
        anc, dist = tzones.zone_cc4(*t)
        got = tzones.zone_list(anc, t[0], t[1], dist=dist)
        want = jax.jit(lambda lv, vd, h, w: jzones.zone_list(
            jzones.zone_labels_cc4(lv, vd), lv, vd,
            dist=jgldzm.border_distance(lv, h, w)))(*j)
    assert _zone_multisets(*got) == _zone_multisets(*want)
    zsize, ok = got[1], got[3]
    n_valid = valid.reshape(2, -1).sum(axis=1)
    if kind == "uniform":
        # the second crop's holes may split its valid pixels into zones
        assert int(ok[0].sum()) == 1 and int(zsize[0].max()) == n_valid[0]
    else:
        assert (ok.sum(dim=1).numpy() == n_valid).all()
        assert (zsize[ok] == 1).all()


# one ROI past a 16-block cluster's counters with and without the
# distances (743808 pixels): K7's grid path on the card
LARGE_CROP = (1, 1024, 768)


def _large_zone_inputs(kind, family):
    """(anc, levels, valid, dist | None) of one LARGE_CROP ROI as the GLSZM
    (no distances) and GLDZM families hand them to K7: "random" 8 levels
    on ~95% of the pixels, labelled by the port's plain K5 / K6; "uniform"
    one level on every pixel, one zone across all of a grid launch's
    blocks, its labels 0 (the seed is pixel 0: the plain labellings'
    fixpoints would take a round a row)."""
    B, H, W = LARGE_CROP
    r = np.random.default_rng(11)
    if kind == "uniform":
        lev = np.full(LARGE_CROP, 3, np.int32)
        valid = np.ones(LARGE_CROP, bool)
    else:
        valid = r.random(LARGE_CROP) < 0.95
        lev = np.where(valid, r.integers(1, 9, LARGE_CROP), 0).astype(
            np.int32)
    lev_t, valid_t = torch.from_numpy(lev), torch.from_numpy(valid)
    hts = torch.full((B,), H, dtype=torch.int32)
    wds = torch.full((B,), W, dtype=torch.int32)
    if kind == "uniform":
        anc = torch.zeros(LARGE_CROP, dtype=torch.int32)
        dist = tzones.border_distance_plain(lev_t, hts, wds)
    elif family == "glszm":
        anc, dist = tzones.zone_labels(lev_t, valid_t), None
    else:
        anc, dist = tzones.zone_cc4(lev_t, valid_t, hts, wds)
    return anc, lev_t, valid_t, None if family == "glszm" else dist


@pytest.mark.parametrize("family", ["glszm", "gldzm"])
@pytest.mark.parametrize("kind", ["random", "uniform"])
def test_zone_list_past_cluster(kind, family):
    """zone_list (its plain version here) against JAX's at a ROI that only
    K7's grid path takes on the card, as multisets of (level, size[,
    distance]), on the same labels; the port's layout (zone p at position
    p, zeros elsewhere) checked on its own."""
    anc, lev, valid, dist = _large_zone_inputs(kind, family)
    A = anc[0].numel()
    assert tzones.zone_stats_plan(1, A, dist is not None)[0] == "grid"
    got = tzones.zone_list(anc, lev, valid, dist)
    j = [jnp.asarray(_np(t)) for t in (anc, lev, valid)]
    if dist is None:
        want = jax.jit(jzones.zone_list)(*j)
    else:
        want = jax.jit(lambda a, lv, vd, d: jzones.zone_list(
            a, lv, vd, dist=d))(*j, jnp.asarray(_np(dist)))
    assert _zone_multisets(*got) == _zone_multisets(*want)
    zlev, zsize, zdist, ok = got
    assert (zsize[~ok] == 0).all() and (zlev[~ok] == 0).all()
    assert int(zsize.sum()) == int(valid.sum())
    if kind == "uniform":
        assert ok[0, 0] and int(ok.sum()) == 1 and int(zsize[0, 0]) == A
        if dist is not None:
            assert int(zdist[0, 0]) == 1
    else:
        assert int(ok.sum()) > 1000


@pytest.mark.parametrize("kind", ["float", "int"])
def test_grouped_weight_sums(kind):
    r = np.random.default_rng(3)
    keys = r.integers(0, 6, (5, 40)).astype(np.float64)
    keys[r.random(keys.shape) < 0.2] = np.inf
    w = r.random(keys.shape) * (r.random(keys.shape) < 0.8)
    jk, jw, js, jv = (np.asarray(a) for a in jax.jit(
        jzones.grouped_weight_sums)(jnp.asarray(keys), jnp.asarray(w)))
    tkeys = torch.from_numpy(keys)
    if kind == "int":
        big = torch.iinfo(torch.int64).max
        tkeys = torch.where(torch.isinf(tkeys), big, tkeys.to(torch.int64))
    tk, tw, ts, tv = (a.numpy() for a in tzones.grouped_weight_sums(
        tkeys, torch.from_numpy(w)))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tk[tv], jk[jv])
    np.testing.assert_allclose(ts, js, rtol=1e-12, atol=1e-15)
    # the weights travel with their keys: the same multiset per key
    for b in range(keys.shape[0]):
        for k in np.unique(jk[b][jv[b]]):
            np.testing.assert_allclose(np.sort(tw[b][tk[b] == k]),
                                       np.sort(jw[b][jk[b] == k]))


def test_cell_keys_exact_beyond_float32():
    """The GLSZM (level, size) key of a 1024 x 1024 bucket at 64 levels
    exceeds 2^24: float32 keys would merge these two cells."""
    stride = 1024 * 1024 + 1
    zlev = torch.tensor([[64.0, 64.0, 3.0]], dtype=torch.float32)
    zsize = torch.tensor([[1.0, 2.0, 0.0]], dtype=torch.float32)
    w = torch.tensor([[1.0, 1.0, 0.0]], dtype=torch.float32)
    assert np.float32(64 * stride + 1) == np.float32(64 * stride + 2)
    key = tzones.cell_keys(w, zlev, zsize, stride)
    assert key[0, 0] != key[0, 1]
    assert key[0, 2] == torch.iinfo(torch.int64).max
    _, _, sums, v = tzones.grouped_weight_sums(key, w)
    assert v.tolist() == [[True, True, False]]
    assert sums.tolist() == [[1.0, 1.0, 0.0]]


@pytest.mark.parametrize("hw,in_smem", [
    ((32, 32), True), ((64, 64), True), ((16, 16), True), ((7, 13), True),
    ((128, 128), True), ((256, 64), True), ((160, 160), True),
    ((161, 161), False), ((1024, 64), False), ((256, 256), False),
    ((256, 128), False)])
def test_zone_cc4_plan_path_choice(hw, in_smem):
    """K6 takes its shared-memory path exactly when the crop's levels and
    parents (int32, rows of pitch W | 1) and valid bytes fit a block's
    shared memory: 160 x 160 is the largest square that does, 161 x 161
    the smallest that does not; 1024 x 64 runs the tiled path (64² tiles
    labelled in 37120 bytes of shared memory by 512 threads)."""
    H, W = hw
    path, smem, threads = tzones.zone_cc4_plan(H, W)
    need = 8 * H * (W | 1) + H * W
    assert (path == "smem") == in_smem == (need <= tcommon.SMEM_MAX)
    if in_smem:
        assert smem == need
        # a warp a row or column, at most 1024 threads
        assert threads == min(1024, 32 * max(H, W))
    else:
        assert (path, smem, threads) == ("tiled", 37120, 512)
