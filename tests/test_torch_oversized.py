"""The port's oversized-ROI path (phase 3) against its own trivial path, in
f64 on the CPU: a scaled-down copy of tests/test_oversized.py's pair (a
~280 x 230 irregular ROI, its bucket 512 x 256 over the 1 MB batch budget
of ``ram_limit=1``, beside one small trivial ROI) through ``*ALL*`` twice,
at the default budget and at ``ram_limit=1``.

Held to test_oversized.py's ``*ALL*`` tolerances (its
test_oversized_all_group_parity): the moment families at rtol 1e-5 with an
absolute floor of 1e-8 of their family's scale, the textures and Gabor at
1e-5, the rest at 1e-7; an EMPTY unserved set (no column the trivial path
assigns left -0.0 by phase 3) and the count of checked columns asserted.
The same in memory, streamed through ``featurize_directory``, under
mergerois and whole-slide mode (the merged or whole-slide ROI over the
budget) and under anisotropy.  Whole-slide mode and anisotropy each have
columns that phase 3 defines otherwise, as the JAX package's phase 3 does
(tests/test_torch_oversized_jax.py and tests/test_torch_modes_jax.py hold
the port's to JAX's): they are pinned by name below."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nyxus_tpu_torch  # noqa: E402
from nyxus_tpu_torch import columns as tcol  # noqa: E402
from nyxus_tpu_torch import taxonomy as ttx  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig as TConfig  # noqa: E402
from nyxus_tpu_torch.io.tiff import write_tiff  # noqa: E402
from nyxus_tpu_torch.pipeline import labels as tlabels  # noqa: E402
from nyxus_tpu_torch.pipeline import oversized as tovs  # noqa: E402
from nyxus_tpu_torch.pipeline.runner import PairRunner  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

FEATURES_ALL = ["*ALL*"]
BIG, SMALL = 5, 2
MOMENTS = ("IMOM", "SMOM", "HU_", "NORM_", "CENTRAL_", "WT_", "SPAT_",
           "WEIGHTED_")
TEXTURES = ("GLCM_", "GLRLM_", "GLSZM_", "GLDZM_", "GLDM_", "NGLDM_",
            "NGTDM_", "GABOR")
_HULL = ("CONVEX_HULL_AREA", "SOLIDITY") + tuple(
    "STAT_%s_DIAM_%s" % (k, s) for k in ("FERET", "MARTIN", "NASSENSTEIN")
    for s in ("MIN", "MAX", "MEAN", "MEDIAN", "MODE", "STDDEV"))
# columns phase 3 defines otherwise than the trivial path, in the JAX
# package as in the port:
# - whole-slide mode: the oversized ROI's hull and calipers are those of
#   its contour, the box's four corners one past its last pixels, and two
#   extrema points are read off the streamed box
# - anisotropy: phase 3 counts the virtual pixels it streams, where the
#   trivial path takes the physical area (intensity moments, the centroid,
#   the area and the ellipse that read it)
OWN_DEFINITION = {
    "wholeslide": set(_HULL) | {"EXTREMA_P3_Y", "EXTREMA_P6_X"},
    "aniso": {"AREA_PIXELS_COUNT", "CENTROID_X", "CENTROID_Y", "COMPACTNESS",
              "COV", "DIAMETER_CIRCUMSCRIBING_CIRCLE", "DIAMETER_EQUAL_AREA",
              "DIAMETER_INSCRIBING_CIRCLE", "ECCENTRICITY", "ELONGATION",
              "EXTREMA_P8_Y", "HYPERFLATNESS",
              "HYPERSKEWNESS", "MAJOR_AXIS_LENGTH", "MASS_DISPLACEMENT",
              "MEAN", "MEAN_ABSOLUTE_DEVIATION", "MEDIAN_ABSOLUTE_DEVIATION",
              "MINOR_AXIS_LENGTH", "ORIENTATION", "ROOT_MEAN_SQUARED",
              "ROUNDNESS", "STANDARD_DEVIATION", "STANDARD_DEVIATION_BIASED",
              "STANDARD_ERROR", "VARIANCE", "VARIANCE_BIASED"},
}
# each mode as (EngineConfig keywords, whole-slide, the slide's crop)
MODES = {"memory": ({}, False, None),
         "mergerois": ({"mergerois": True}, False, None),
         "wholeslide": ({}, True, (260, 200)),
         "aniso": ({"aniso_x": 0.9, "aniso_y": 1.2}, False, None)}


def make_pair(h=320, w=280):
    """tests/test_oversized.py's make_pair at 320 x 280: uniform noise, an
    ellipse of ~281 x 231 px (label 5) and a 16 x 26 box (label 2) whose
    merged box with it stays 512 x 256."""
    r = np.random.default_rng(11)
    intens = r.integers(1, 3000, (h, w)).astype(np.uint16)
    labels = np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((yy - 165) ** 2 / 140.0 ** 2 + (xx - 150) ** 2 / 115.0 ** 2) <= 1
    labels[blob] = BIG
    labels[4:20, 40:66] = SMALL
    return intens, labels


def _runner(ram_limit_mb=None, **kw):
    cfg = TConfig(precision="f64", **kw)
    if ram_limit_mb is not None:
        cfg = cfg.replace(ram_limit_mb=ram_limit_mb)
    return PairRunner(ttx.parse_feature_request(FEATURES_ALL), cfg, "cpu")


def _columns():
    fset = ttx.parse_feature_request(FEATURES_ALL)
    return tcol.build_header(fset, TConfig())[0][4:]


def _inputs(mode):
    kw, wholeslide, crop = MODES[mode]
    intens, labels = make_pair()
    if crop is not None:
        intens, labels = intens[:crop[0], :crop[1]], labels[:crop[0], :crop[1]]
    if wholeslide:
        labels = np.ones_like(labels)
    return intens, labels, kw, wholeslide


def parity(cols, mem, ovr, row):
    """(checked, unserved, differing) of row ``row``: test_oversized.py's
    *ALL* comparison of the phase-3 values ``ovr`` with the trivial ones
    ``mem``."""
    famscale = {}
    for j, c in enumerate(cols):
        for pref in MOMENTS:
            if c.startswith(pref):
                famscale[pref] = max(famscale.get(pref, 1.0),
                                     abs(float(mem[row, j])))
    checked, unserved, bad = 0, [], []
    for j, c in enumerate(cols):
        a, b = float(ovr[row, j]), float(mem[row, j])
        tol, atol = 1e-7, 1e-12
        for pref in MOMENTS:
            if c.startswith(pref):
                tol, atol = 1e-5, 1e-8 * famscale[pref]
                break
        else:
            if c.startswith(TEXTURES):
                tol = 1e-5
        # -0.0 where the trivial path assigned a value: unassigned, unless
        # that value is zero within the column's absolute tolerance (a
        # computed -0.0, e.g. a vanishing Hu invariant)
        if a == 0.0 and np.signbit(a) and not (b == 0.0 and np.signbit(b)) \
                and not abs(b) <= atol:
            unserved.append(c)
            continue
        if not (np.isfinite(a) and np.isfinite(b)):
            continue
        checked += 1
        if abs(a - b) > tol * max(abs(b), 1e-6) + atol:
            bad.append(c)
    return checked, unserved, bad


@pytest.fixture(scope="module")
def trivial_runs():
    """Each mode's trivial run at the default budget, made once."""
    cache = {}

    def get(mode):
        if mode not in cache:
            intens, labels, kw, ws = _inputs(mode)
            cache[mode] = _runner(**kw).run(intens, labels, wholeslide=ws)
        return cache[mode]
    return get


def _oversized_run(mode, tmp_path):
    if mode == "streamed":
        intens, labels = make_pair()
        for d, img in (("int", intens), ("seg", labels.astype(np.uint16))):
            (tmp_path / d).mkdir()
            write_tiff(str(tmp_path / d / "p.tif"), img, tile_size=64)
        nyx = nyxus_tpu_torch.Nyxus(FEATURES_ALL, device="cpu", ram_limit=1,
                                    precision="f64")
        # the 320 x 280 pair is over the RAM gate: the tile-streamed run
        assert nyx._stream_gate(intens.shape)
        (_, _, labs, values), = nyx._iter_directory_raw(
            str(tmp_path / "int"), str(tmp_path / "seg"), ".*")
        return labs, values
    intens, labels, kw, ws = _inputs(mode)
    return _runner(ram_limit_mb=1, **kw).run(intens, labels, wholeslide=ws)


def test_pair_splits_at_the_gate():
    """At ram_limit=1 the big ROI is oversized by its bucket (512 x 256 x
    16 B over 1 MB) and the small one trivial; the default budget takes
    both as trivial."""
    intens, labels = make_pair()
    recs = {r.label: r for r in tlabels._discover_rois_np(intens, labels)[0]}
    assert recs[BIG].height > 256 and recs[BIG].width <= 256
    assert tovs.is_oversized(recs[BIG], 1 << 20)
    assert not tovs.is_oversized(recs[SMALL], 1 << 20)
    budget = TConfig().ram_limit_mb << 20
    assert not any(tovs.is_oversized(r, budget) for r in recs.values())


@pytest.mark.parametrize("mode", ["memory", "streamed", "mergerois",
                                  "wholeslide", "aniso"])
def test_oversized_all_matches_trivial(trivial_runs, tmp_path, mode):
    """*ALL* with the big (merged, whole-slide) ROI oversized against the
    trivial path: every column the trivial path assigns is served, and
    agrees within test_oversized.py's tolerances, but for the columns
    phase 3 defines otherwise (``OWN_DEFINITION``); the small trivial ROI's
    row is the trivial run's."""
    cols = _columns()
    ml, mem = trivial_runs("memory" if mode == "streamed" else mode)
    ol, ovr = _oversized_run(mode, tmp_path)
    np.testing.assert_array_equal(ol, ml)
    assert ovr.shape == mem.shape == (len(ml), len(cols))
    row = list(ml).index(BIG) if BIG in ml else 0
    checked, unserved, bad = parity(cols, mem, ovr, row)
    assert not unserved, "phase 3 stopped serving: %r" % unserved
    assert checked == len(cols), checked
    assert set(bad) == OWN_DEFINITION.get(mode, set()), sorted(bad)
    if SMALL in ml:
        k = list(ml).index(SMALL)
        np.testing.assert_allclose(ovr[k], mem[k], rtol=1e-12, atol=1e-12)
