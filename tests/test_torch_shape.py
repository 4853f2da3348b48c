"""The PyTorch port's shape and moment modules against the JAX package's, in
f64 on the CPU: the binary-mask features (ops/binary.py: erosion, Euler
number, box-count fractal dimension), the power sums of ops/moments.py, and
every member of the eight device families of the slice (basic morphology,
ellipse, erosion, Euler, fractal box count, extrema, intensity and shape
moments, and Zernike).  The port runs the plain versions of K8-K10 here
(tests/test_torch_cuda.py holds the kernels against them on the card), and
Zernike (K12), whose centroid K10's sums give, beside them; K10's plain
version is pinned bit for bit to the torch calls the families made before
the kernel fused them.

Inputs are the padded 16 x 16, 32 x 32 and 64 x 64 buckets of seeded
conftest.make_blobs slides, assembled like the runners' dense path, with a
seeded log-distance plane for the weighted moments; the JAX side runs under
jax.jit, as its runner runs it.

Tolerances: counts (erosions, Euler numbers, box counts) must be equal; the
fractal dimension holds rtol 1e-12; the power sums (float sums in another
order) hold 1e-12 of the sum of their terms' absolute values, as a central
sum's terms cancel and its own value is no scale; family members hold rtol 1e-9 / atol 1e-12 with NaN in
the same places (the weighted normalised moments of a ROI whose weighted
mass is negative are NaN on both sides, std::pow semantics).  The first
central moments CENTRAL_MOMENT_01/10 and IMOM_CM_01/10 are zero by
construction: both sides hold floating-point residue, compared by absolute
size as tests/test_reference_parity.py compares them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_blobs

import nyxus_tpu.registry as jreg
from nyxus_tpu.config import EngineConfig as JConfig
from nyxus_tpu.ops import binary as jbinary
from nyxus_tpu.ops import moments as jmoments

import chip_smoke
import nyxus_tpu_torch.registry as treg
from nyxus_tpu_torch.config import EngineConfig as TConfig
from nyxus_tpu_torch.ops import binary as tbinary
from nyxus_tpu_torch.ops import moments as tmoments
from nyxus_tpu_torch.ops.common import safe_div
from nyxus_tpu_torch.pipeline import batching, labels
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

SIZES = (16, 32, 64)
DEVICE_FAMILIES = ("BasicMorphologyFeatures", "EllipseFittingFeature",
                   "ErosionPixelsFeature", "EulerNumberFeature",
                   "FractalDimensionFeature", "ExtremaFeature",
                   "Imoms2D_feature", "Smoms2D_feature", "ZernikeFeature")
ZERO_BY_CONSTRUCTION = ("CENTRAL_MOMENT_01", "CENTRAL_MOMENT_10",
                        "IMOM_CM_01", "IMOM_CM_10")
_KEYS = ("intens", "mask", "area", "vmin", "vmax", "y0", "x0", "smin",
         "smax", "heights", "widths", "logw")
_CACHE = {}


def _bucket_arrays(size):
    """Padded crops of every ROI of a seeded slide whose bucket is
    size x size, with a seeded log-distance plane on the ROI pixels."""
    rmin, rmax = {16: (3, 7), 32: (8, 14), 64: (17, 28)}[size]
    intens, lab = make_blobs(h=160, w=160, n_blobs=9, seed=size,
                             rmin=rmin, rmax=rmax)
    recs, smin, smax = labels._discover_rois_np(intens, lab)
    recs = [r for r in recs
            if batching.bucket_shape(r.height, r.width) == (size, size)]
    assert len(recs) >= 2
    B = len(recs)
    ci = np.zeros((B, size, size))
    cm = np.zeros((B, size, size), bool)
    for bi, r in enumerate(recs):
        h = min(size, lab.shape[0] - r.y0)
        w = min(size, lab.shape[1] - r.x0)
        ci[bi, :h, :w] = intens[r.y0:r.y0 + h, r.x0:r.x0 + w]
        cm[bi, :h, :w] = lab[r.y0:r.y0 + h, r.x0:r.x0 + w] == r.label
    # distances to the contour 0 .. size/8: mostly 0 (log 0.001) for the
    # small ROIs, whose weighted mass is then negative, as on a real slide
    rng = np.random.default_rng(size)
    d = rng.integers(0, size // 8 + 1, cm.shape).astype(np.float64)
    logw = np.where(cm, np.log(d + 0.001), 0.0)
    return dict(
        intens=ci, mask=cm,
        area=np.array([r.area for r in recs], np.int32),
        vmin=np.array([r.vmin for r in recs]),
        vmax=np.array([r.vmax for r in recs]),
        y0=np.array([r.y0 for r in recs], np.int32),
        x0=np.array([r.x0 for r in recs], np.int32),
        smin=np.full(B, smin), smax=np.full(B, smax),
        heights=np.array([r.height for r in recs], np.int32),
        widths=np.array([r.width for r in recs], np.int32),
        logw=logw)


def _arrays(size):
    if size not in _CACHE:
        _CACHE[size] = _bucket_arrays(size)
    return _CACHE[size]


def _jax(size, fn):
    """fn(ctx, cfg) of the JAX package, under jax.jit, on the bucket."""
    cfg = JConfig(precision="f64")

    def run(*arrs):
        d = dict(zip(_KEYS, arrs))
        ctx = jreg.BatchContext(d["intens"], d["mask"], d["area"], d["vmin"],
                                d["vmax"], d["y0"], d["x0"], d["smin"],
                                d["smax"], cfg, heights=d["heights"],
                                widths=d["widths"], logw=d["logw"])
        return fn(ctx, cfg)

    a = _arrays(size)
    return jax.jit(run)(*(jnp.asarray(a[k]) for k in _KEYS))


def _torch(size, fn):
    """fn(ctx, cfg) of the port, on the bucket."""
    a = _arrays(size)
    cfg = TConfig(precision="f64")
    t = {k: torch.from_numpy(a[k]) for k in _KEYS}
    ctx = treg.BatchContext(t["intens"], t["mask"], t["area"], t["vmin"],
                            t["vmax"], t["smin"], t["smax"], t["heights"],
                            t["widths"], cfg, y0=t["y0"], x0=t["x0"],
                            logw=t["logw"])
    return fn(ctx, cfg)


# ---------------------------------------------------------------------------
# hand-made masks


def _disk(n, r, hole=0.0):
    yy, xx = np.mgrid[0:n, 0:n]
    d2 = (yy - (n - 1) / 2) ** 2 + (xx - (n - 1) / 2) ** 2
    return (d2 <= r * r) & (d2 >= hole * hole)


def _with_holes(k):
    m = np.zeros((32, 32), bool)
    m[2:30, 2:30] = True
    for j in range(k):
        m[6 + 8 * j:9 + 8 * j, 10:13] = False
    return m


def _diagonal():
    m = np.zeros((16, 16), bool)
    for k in range(6):
        m[2 + 2 * k, 2 + 2 * k] = True
        m[3 + 2 * k, 3 + 2 * k] = True
    m[8, 3] = m[9, 2] = True          # a second diagonal-only pair
    return m


def _empty_interior():
    """A 12 x 12 frame whose pixels all lie on the frozen border (x, y < 2
    or = 11): the interior is empty from the start."""
    m = np.zeros((16, 16), bool)
    m[:2, :12] = m[:12, :2] = m[11, :12] = m[:12, 11] = True
    return m


def _solid(h, w, n=32):
    """An h x w rectangle filling its AABB: its frozen border feeds the
    interior, which never empties (the count stops at the cap)."""
    m = np.zeros((n, n), bool)
    m[:h, :w] = True
    return m


def _ring_zeros():
    """A full 20 x 20 AABB whose only zeros lie on the frozen ring (rows 0,
    1 and 19, columns 0, 1 and 19): they erode the interior from outside."""
    m = _solid(20, 20)
    m[1, 5:15] = False
    m[9, 1] = m[19, 8] = m[6, 19] = False
    return m


def _tiny(n, hole):
    """A full n x n AABB (n = 4, 5: the smallest interiors) with one zero
    at ``hole``."""
    m = _solid(n, n, 8)
    m[hole] = False
    return m


def _ellipse(h, w):
    """A solid ellipse filling an h x w AABB inside a bucket of 64 rows and
    the next multiple of 64 columns."""
    m = np.zeros((64, -(-w // 64) * 64), bool)
    yy, xx = np.mgrid[0:h, 0:w]
    m[:h, :w] = (((yy - (h - 1) / 2) / (h / 2)) ** 2
                 + ((xx - (w - 1) / 2) / (w / 2)) ** 2 <= 1.0)
    return m


CROPS = {
    "solid": _solid(20, 24),
    "ring_zeros": _ring_zeros(),
    "tiny4": _tiny(4, (1, 2)),
    "tiny5": _tiny(5, (2, 1)),
    "tiny5_full": _tiny(5, (0, 0)),
    "w33": _ellipse(40, 33),
    "w65": _ellipse(50, 65),
    "thick_disk": _disk(64, 30),
    "ring": _disk(64, 25) & ~_disk(64, 24),
    "empty_interior": _empty_interior(),
    "holes0": _with_holes(0),
    "holes1": _with_holes(1),
    "holes3": _with_holes(3),
    "diagonal": _diagonal(),
}


def _crop_inputs(name):
    m = CROPS[name]
    ys, xs = np.nonzero(m)
    hw = (ys.max() + 1, xs.max() + 1)
    return (m[None], np.array([hw[0]], np.int32), np.array([hw[1]], np.int32))


def _mask_inputs(case):
    """(mask [B, H, W], heights, widths) of a bucket or a hand-made crop."""
    if isinstance(case, int):
        a = _arrays(case)
        return a["mask"], a["heights"], a["widths"]
    return _crop_inputs(case)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(SIZES) + [
    "thick_disk", "ring", "empty_interior", "solid", "ring_zeros", "tiny4",
    "tiny5", "tiny5_full", "w33", "w65"])
def test_erosions_to_vanish(case):
    """EROSIONS_2_VANISH equal to JAX on the buckets and on hand-made crops:
    a solid rectangle and full 5 x 5 AABB (the cap of 1000), a full AABB
    whose zeros lie only on the frozen ring, 4 x 4 and 5 x 5 AABBs (one
    and four interior pixels) with one zero, ellipses 33 and 65 wide."""
    m, h, w = _mask_inputs(case)
    want = np.asarray(jbinary.erosions_to_vanish(
        jnp.asarray(m), jnp.asarray(h), jnp.asarray(w), jnp.float64))
    got = tbinary.erosions_to_vanish(torch.from_numpy(m), torch.from_numpy(h),
                                     torch.from_numpy(w), torch.float64)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "thick_disk":
        assert want[0] > 20
    if case in ("empty_interior", "tiny4"):
        assert want[0] == 0
    if case in ("solid", "tiny5_full"):
        assert want[0] == 1000
    if case in ("ring_zeros", "tiny5", "w33", "w65"):
        assert 0 < want[0] < 1000
    if case in ("w33", "w65"):
        assert w[0] == int(case[1:])


@pytest.mark.parametrize("case", list(SIZES) + ["holes0", "holes1", "holes3",
                                                "diagonal"])
def test_euler_number(case):
    m, _, _ = _mask_inputs(case)
    want = np.asarray(jbinary.euler_number(jnp.asarray(m), jnp.float64))
    got = tbinary.euler_number(torch.from_numpy(m), torch.float64)
    np.testing.assert_array_equal(got.numpy(), want)
    expect = {"holes0": 1, "holes1": 0, "holes3": -2}
    if case in expect:
        assert want[0] == expect[case]
    if case == "diagonal":
        # 8-connected: one diagonal line and one diagonal pair, the C++
        # truncating division of a count that is not a multiple of 4
        assert want[0] == 2


@pytest.mark.parametrize("case", list(SIZES) + ["thick_disk", "ring"])
def test_box_counts_and_fractal_dimension(case):
    m, h, w = _mask_inputs(case)
    quads, boxes = tbinary.binary_quads_plain(torch.from_numpy(m))
    SB, S = tbinary.n_scales(*m.shape[1:])
    assert boxes.shape == (m.shape[0], S, 4) and quads.shape == (m.shape[0], 3)
    jm = jnp.asarray(m)

    def jax_counts(mj):
        counts = []
        for i in range(S):
            s = SB >> i
            origins = (((0, 0), (s // 2, 0), (0, s // 2), (s // 2, s // 2))
                       if s <= 32 else ((0, 0),) * 4)
            counts.append(jnp.stack([jbinary._box_count_at_scale(mj, s, ox, oy)
                                     for ox, oy in origins], axis=1))
        return jnp.stack(counts, axis=1)

    def jax_fd(mj, hj, wj):
        return jbinary.fract_dim_boxcount(mj, hj, wj, jnp.float64)

    np.testing.assert_array_equal(boxes.numpy(),
                                  np.asarray(jax.jit(jax_counts)(jm)))
    want = np.asarray(jax.jit(jax_fd)(jm, jnp.asarray(h), jnp.asarray(w)))
    got = tbinary.fract_dim_boxcount(torch.from_numpy(m), torch.from_numpy(h),
                                     torch.from_numpy(w), torch.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("centred", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_power_sums(size, centred):
    a = _arrays(size)
    w = np.where(a["mask"], a["intens"], 0.0)
    planes = [w, w * a["logw"]]
    B, H, W = w.shape
    xs = np.arange(W, dtype=np.float64)[None, None, :] * np.ones((1, H, 1))
    ys = np.arange(H, dtype=np.float64)[None, :, None] * np.ones((1, 1, W))
    centre = None
    if centred:
        m00 = w.sum(axis=(1, 2))
        centre = np.stack([(w * xs).sum(axis=(1, 2)) / m00,
                           (w * ys).sum(axis=(1, 2)) / m00], axis=1)
        centre = np.stack([centre, centre + 0.25], axis=1)     # [B, 2, 2]
    got = tmoments.power_sums_plain(
        [torch.from_numpy(p) for p in planes],
        None if centre is None else torch.from_numpy(centre)).numpy()
    assert got.shape == (B, 2, 4, 4)
    for k, p in enumerate(planes):
        x, y = jnp.asarray(xs), jnp.asarray(ys)
        if centred:
            x = x - jnp.asarray(centre[:, k, 0])[:, None, None]
            y = y - jnp.asarray(centre[:, k, 1])[:, None, None]
        S = jmoments._power_sums(jnp.asarray(p), x, y)
        for (i, j), v in S.items():
            scale = (np.abs(p) * np.abs(np.asarray(x)) ** i
                     * np.abs(np.asarray(y)) ** j).sum(axis=(1, 2))
            assert (np.abs(got[:, k, i, j] - np.asarray(v))
                    <= 1e-12 * scale).all(), (k, i, j)


def _family_fn(mod, family):
    def fn(ctx, cfg):
        return mod.FAMILIES[family].fn(ctx, cfg)
    return fn


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("family", DEVICE_FAMILIES)
def test_family_members(family, size):
    want = {k: np.asarray(v) for k, v in
            _jax(size, _family_fn(jreg, family)).items()}
    got = {k: v.numpy() for k, v in
           _torch(size, _family_fn(treg, family)).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k], want[k]
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        ok = ~np.isnan(b)
        if k in ZERO_BY_CONSTRUCTION:
            scale = np.abs(want["IMOM_RM_00" if k.startswith("IMOM")
                                else "SPAT_MOMENT_00"]) * size
            assert (np.abs(a[ok]) <= 1e-9 * scale[ok]).all(), k
            assert (np.abs(b[ok]) <= 1e-9 * scale[ok]).all(), k
            continue
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-9, atol=1e-12,
                                   err_msg=k)
        zero = b == 0
        np.testing.assert_array_equal(np.signbit(a[zero]), np.signbit(b[zero]),
                                      err_msg=k)
    if family in ("Imoms2D_feature", "Smoms2D_feature") and size == 16:
        # the 16 px bucket's ROIs have a negative weighted mass: their
        # weighted normalised moments are NaN on both sides
        assert any(np.isnan(v).any() for v in want.values())


def _old_moment_calls(intens, mask, area, logw):
    """The torch calls the morphology, ellipse and moment families made one
    family at a time before K10 fused them: (morphology's raw sums of the
    mask and the masked intensity, its local centroid, the ellipse's
    centred sums, and for the intensity then the shape moments the raw
    sums, the centres and the centred sums of moment_planes)."""
    dt = intens.dtype
    mw, mi = mask.to(dt), torch.where(mask, intens, 0)
    morph = tmoments.power_sums_plain([mw, mi])
    S = morph[:, 0].to(dt)
    n = area.to(dt)
    lc = torch.stack([S[:, 1, 0] / n, S[:, 0, 1] / n], dim=1)
    ellipse = tmoments.power_sums_plain([mw], lc[:, None, :])[:, 0]
    fams = []
    for weights in (mi, mw):
        planes = tmoments.moment_planes(weights, logw)
        raw = tmoments.power_sums_plain(planes)
        centres = []
        for k in range(len(planes)):
            Sk = raw[:, k].to(dt)
            centres.append(torch.stack([safe_div(Sk[:, 1, 0], Sk[:, 0, 0]),
                                        safe_div(Sk[:, 0, 1], Sk[:, 0, 0])],
                                       dim=1))
        centres = torch.stack(centres, dim=1)
        fams.append((raw, centres, tmoments.power_sums_plain(planes, centres)))
    return morph, lc, ellipse, fams


def _moment_case(case, dtype):
    """(intens, mask, area, logw) of a chip_smoke.CASES bucket (its index)
    or a hand-made 32 x 32 crop: "empty" (no pixel, area 0), "one-pixel",
    "uniform" (a full AABB of one intensity), "zero-m00" (a ROI of zero
    intensities).  Intensities lie off the mask too (the planes mask them);
    logw is log(d + 0.001) on the mask with d mostly 0, so the weighted
    masses are negative."""
    rng = np.random.default_rng(7)
    if isinstance(case, int):
        B, H, W, hw = chip_smoke.CASES[case]
        orig, _, _, mask = chip_smoke.synth_bucket(
            B, H, W, hw, case, dtype, empty=hw == (0, 0), device="cpu")
        intens = orig + (~mask) * 7
    else:
        mask = torch.zeros((1, 32, 32), dtype=torch.bool)
        intens = torch.from_numpy(rng.integers(1, 4000, (1, 32, 32))).to(dtype)
        if case == "one-pixel":
            mask[0, 5, 9] = True
        elif case in ("uniform", "zero-m00"):
            mask[0, :29, :31] = True
            intens = torch.full_like(intens, 1000 if case == "uniform" else 0)
    d = torch.from_numpy(rng.integers(0, 3, tuple(mask.shape))).to(dtype)
    logw = torch.where(mask, torch.log(d + 0.001), 0)
    area = mask.reshape(mask.shape[0], -1).sum(dim=1).to(torch.int32)
    return intens, mask, area, logw


@pytest.fixture
def one_thread():
    """One torch thread for the test: the plain sums of the 256² and 1024 x
    64 buckets take a fraction of a second alone, and tens of seconds when
    each parallel region of a busy machine waits for eight threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_bits(a, b):
    idt = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(idt),
                                              b.contiguous().view(idt))


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("case", list(range(len(chip_smoke.CASES)))
                         + ["empty", "one-pixel", "uniform", "zero-m00"])
def test_moment_sums_plain_is_the_old_call_sequence(case, prec, weighted,
                                                    one_thread):
    """K10's plain version (moments.moment_sums_plain, one entry for every
    sum and centre) equals, bit for bit, what the families' separate
    calls gave: the same planes, centres and sums, in f32 and f64."""
    dtype = torch.float32 if prec == "f32" else torch.float64
    intens, mask, area, logw = _moment_case(case, dtype)
    logw = logw if weighted else None
    ms = tmoments.moment_sums_plain(intens, mask, area, logw)
    morph, lc, ellipse, (imoms, smoms) = _old_moment_calls(intens, mask,
                                                           area, logw)
    P = 4 if weighted else 2
    assert ms.raw.shape == ms.central.shape == (len(mask), P, 4, 4)
    assert ms.centres.shape == (len(mask), P + 1, 2)
    assert ms.centres.dtype == dtype
    # (plane, the family's sums of it): mask, masked intensity, then the
    # two weighted planes
    old = [(0, smoms, 0), (1, imoms, 0)] + ([(2, imoms, 1), (3, smoms, 1)]
                                            if weighted else [])
    for p, (raw, centres, central), k in old:
        assert _same_bits(ms.raw[:, p], raw[:, k]), p
        assert _same_bits(ms.centres[:, p], centres[:, k]), p
        assert _same_bits(ms.central[:, p], central[:, k]), p
    assert _same_bits(ms.raw[:, :2], morph)
    assert _same_bits(ms.centres[:, P], lc)
    assert _same_bits(ms.ellipse, ellipse)
    if case == "zero-m00":
        assert (ms.centres[:, 1] == 0).all() and (ms.raw[:, 1] == 0).all()
    if weighted and case in (0, "uniform"):
        assert (ms.raw[:, 2:, 0, 0] < 0).all()    # negative weighted masses
