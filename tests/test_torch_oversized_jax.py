"""The port's oversized-ROI path (phase 3) against the JAX package's, in
f64 on the CPU.

Both runners take ``ram_limit_mb=0``, so that every ROI of the slide
(conftest.make_blobs at 96 x 96) is oversized: the numpy accumulators, the
streamed contour, the streamed tail families and the finish stages (the
port's on its torch device, the CPU here; the JAX package's jitted on its
host backend) give every column.  ``*ALL*`` is compared on all 747 columns,
family by family, at rtol 1e-9 / atol 1e-12 (5e-7 for the fast_log2
entropies), with NaN and the unassigned ``-0.0`` in the same places; one
IBSI run compares the IH members.  The accumulators, the texture sweep and
``process`` are also held against JAX's at module level, on small tiles."""

import os
import sys

import numpy as np
import pytest

from conftest import make_blobs

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nyxus_tpu import taxonomy as jtx  # noqa: E402
from nyxus_tpu.config import EngineConfig as JConfig  # noqa: E402
from nyxus_tpu.pipeline import oversized as jovs  # noqa: E402
from nyxus_tpu.pipeline import sources as jsources  # noqa: E402
from nyxus_tpu.pipeline.runner import PairRunner as JRunner  # noqa: E402

from nyxus_tpu_torch import columns as tcol  # noqa: E402
from nyxus_tpu_torch import registry as treg  # noqa: E402
from nyxus_tpu_torch import taxonomy as ttx  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig as TConfig  # noqa: E402
from nyxus_tpu_torch.pipeline import contour as tcontour  # noqa: E402
from nyxus_tpu_torch.pipeline import labels as tlabels  # noqa: E402
from nyxus_tpu_torch.pipeline import oversized as tovs  # noqa: E402
from nyxus_tpu_torch.pipeline import sources as tsources  # noqa: E402
from nyxus_tpu_torch.pipeline.runner import PairRunner as TRunner  # noqa: E402

from test_torch_slice import _ENTROPY, _compare_all  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

FEATURES_ALL = ["*ALL*"]
WIDTH_ALL = 747
IBSI_FEATURES = ["*ALL_INTENSITY*", "*ALL_IH*", "*ALL_GLCM*", "*ALL_NGTDM*",
                 "*ALL_GLDZM*"]
FAMILIES_ALL = treg.activated_families(ttx.parse_feature_request(FEATURES_ALL))


def _slide():
    return make_blobs(96, 96, 4, seed=3)


def _family_columns(fset, cfg):
    """{family: value-column indices} of a request's header (a code that
    two families declare counts for both)."""
    _, slots = tcol.build_header(fset, cfg)
    cols, off = {}, 0
    for code, width in slots:
        for fam in treg.FAMILIES:
            if code in treg.FAMILIES[fam].codes:
                cols.setdefault(fam, []).extend(range(off, off + width))
        off += width
    return cols


@pytest.fixture(scope="module")
def all_runs():
    intens, labels = _slide()
    jl, jv = JRunner(jtx.parse_feature_request(FEATURES_ALL),
                     JConfig(precision="f64", ram_limit_mb=0)).run(
        intens, labels)
    fset = ttx.parse_feature_request(FEATURES_ALL)
    tl, tv = TRunner(fset, TConfig(precision="f64", ram_limit_mb=0),
                     device="cpu").run(intens, labels)
    hdr, _ = tcol.build_header(fset, TConfig())
    return hdr[4:], (jl, jv), (tl, tv), _family_columns(fset, TConfig())


def test_every_roi_is_oversized(all_runs):
    """ram_limit_mb=0 sends every ROI to phase 3, and the families' columns
    cover the 747."""
    intens, labels = _slide()
    recs, _, _ = tlabels._discover_rois_np(intens, labels)
    assert len(recs) >= 3
    assert all(tovs.is_oversized(r, 0) for r in recs)
    cols, (jl, _), (tl, tv), fam_cols = all_runs
    np.testing.assert_array_equal(tl, jl)
    assert tv.shape == (len(recs), WIDTH_ALL) == (len(recs), len(cols))
    assert sorted({j for c in fam_cols.values() for j in c}) == \
        list(range(WIDTH_ALL))
    assert set(fam_cols) == set(FAMILIES_ALL)


@pytest.mark.parametrize("family", FAMILIES_ALL)
def test_all_oversized_equals_jax(all_runs, family):
    """Each family's columns of *ALL* with every ROI oversized: the values,
    NaN and the -0.0 sentinel as JAX's."""
    cols, (_, jv), (_, tv), fam_cols = all_runs
    sel = fam_cols[family]
    _compare_all([cols[j] for j in sel], jv[:, sel], tv[:, sel])


@pytest.fixture(scope="module")
def ibsi_runs():
    intens, labels = _slide()
    intens = (intens % 59 + 1).astype(np.uint16)
    jl, jv = JRunner(jtx.parse_feature_request(IBSI_FEATURES, ibsi=True),
                     JConfig(precision="f64", ibsi=True,
                             ram_limit_mb=0)).run(intens, labels)
    fset = ttx.parse_feature_request(IBSI_FEATURES, ibsi=True)
    tl, tv = TRunner(fset, TConfig(precision="f64", ibsi=True,
                                   ram_limit_mb=0), "cpu").run(intens, labels)
    hdr, _ = tcol.build_header(fset, TConfig(ibsi=True))
    return hdr[4:], (jl, jv), (tl, tv)


@pytest.mark.parametrize("group", ("IH_", "GLCM_", "NGTDM_", "GLDZM_",
                                   "intensity"))
def test_ibsi_oversized_equals_jax(ibsi_runs, group):
    """IBSI mode with every ROI oversized: the IH members (K17's plain
    version over the streamed histogram), the raw-level textures and the
    weighted intensity statistics as JAX's."""
    cols, (jl, jv), (tl, tv) = ibsi_runs
    np.testing.assert_array_equal(tl, jl)
    sel = [j for j, c in enumerate(cols)
           if (c.startswith(group) if group != "intensity" else
               not c.startswith(("IH_", "GLCM_", "NGTDM_", "GLDZM_")))]
    assert sel
    for j in sel:
        c = cols[j]
        rtol = 5e-7 if any(t in c for t in _ENTROPY) and \
            not c.startswith("IH_") else 1e-9
        np.testing.assert_allclose(tv[:, j], jv[:, j], rtol=rtol, atol=1e-12,
                                   err_msg=c)
        zero = jv[:, j] == 0
        np.testing.assert_array_equal(np.signbit(tv[zero, j]),
                                      np.signbit(jv[zero, j]), err_msg=c)
    if group == "IH_":
        assert np.isfinite(tv[:, sel]).all() and (tv[:, sel] != 0).any()


# ---------------------------------------------------------------------------
# the phase-3 modules on small tiles


@pytest.fixture(scope="module")
def tile_case():
    """The slide's largest ROI, its streamed contour, and the two packages'
    sources over the slide."""
    intens, labels = _slide()
    recs, smin, smax = tlabels._discover_rois_np(intens, labels)
    rec = max(recs, key=lambda r: r.area)
    tsrc = tsources.ArrayPairSource(intens, labels)
    jsrc = jsources.ArrayPairSource(intens, labels)
    K = tcontour.oversized_contour(rec, tsrc)
    return rec, smin, smax, tsrc, jsrc, K


def _assert_member_dicts(want, got, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        a = np.asarray(want[k], np.float64)
        b = np.asarray(got[k], np.float64)
        rtol = 5e-7 if any(t in k for t in _ENTROPY) else 1e-9
        np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-12,
                                   err_msg="%s %s" % (what, k))
        np.testing.assert_array_equal(np.signbit(b), np.signbit(a),
                                      err_msg="%s %s" % (what, k))


@pytest.mark.parametrize("block", (13, 32, 2048))
def test_accumulate_equals_jax(tile_case, block):
    """OversizedAccums after the streamed pass (value histogram, moment
    sums, contour-weighted sums) equal JAX's bit for bit, tile size
    whatever."""
    rec, _, _, tsrc, jsrc, K = tile_case
    ta = tovs.accumulate(rec, tsrc, block, contour=K)
    ja = jovs.accumulate(rec, jsrc, block, contour=K)
    assert tuple(tovs.OversizedAccums.__slots__) == \
        tuple(jovs.OversizedAccums.__slots__)
    for slot in jovs.OversizedAccums.__slots__:
        np.testing.assert_array_equal(np.asarray(getattr(ta, slot)),
                                      np.asarray(getattr(ja, slot)),
                                      err_msg=slot)


@pytest.mark.parametrize("depth", (64, -32))
def test_texture_members_equal_jax(tile_case, depth):
    """The tiled texture accumulators (13-row strips) and their finish
    stages, default and radiomics binning, against JAX's."""
    rec, _, smax, tsrc, jsrc, _ = tile_case
    fams = list(tovs.TEX_FAMILIES)
    got = tovs.texture_members(rec, tsrc, TConfig(coarse_gray_depth=depth),
                               fams, smax, 13, device="cpu")
    want = jovs.texture_members(rec, jsrc, JConfig(coarse_gray_depth=depth),
                                fams, smax, 13)
    assert sorted(got) == sorted(want) == sorted(fams)
    for fam in fams:
        _assert_member_dicts(want[fam], got[fam], fam)


def test_process_equals_jax(tile_case):
    """``process`` over every streamable family of *ALL* on 17-row tiles,
    its pool of two workers included, against JAX's."""
    rec, smin, smax, tsrc, jsrc, K = tile_case
    got = tovs.process(rec, tsrc, TConfig(), FAMILIES_ALL, smin, smax, 17,
                       contour=K, device="cpu")
    want = jovs.process(rec, jsrc, JConfig(), FAMILIES_ALL, smin, smax, 17,
                        contour=K)
    assert sorted(got) == sorted(want)
    assert set(got) == set(tovs.STREAMABLE) & set(FAMILIES_ALL)
    for fam in want:
        _assert_member_dicts(want[fam], got[fam], fam)
