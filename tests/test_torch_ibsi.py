"""The PyTorch port's IBSI mode on the CPU: the intensity-histogram (IH)
functions against the JAX package's on the same numpy inputs (f64, rtol
1e-9), the IBSI texture families against the JAX package's PairRunner on
conftest.make_blobs, the IBSI digital phantom's golden values under the
reference's own protocol (tests/test_goldens_ibsi.py), the IH members
against the numpy oracle (tests/oracle_ih.py) and the preserve_hu cases of
tests/test_ih.py through the port's Nyxus, and the request *ALL* under IBSI
(793 columns) against the reference binary's CSV ref_ibsi_320x320_seed11
at test_config_parity's p90 1e-4.

Against JAX the texture entropies hold 5e-7 (the JAX runner's fast_log2 is
FMA-contracted by XLA, see test_torch_slice); IH's entropy is the exact
log2 and holds 1e-9 like every other IH member."""

import gzip
import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from conftest import make_blobs
import oracle_ih
from goldens_ref import GOLDENS
from phantoms_ref import PIXELS, grid

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from nyxus_tpu import columns as jcol  # noqa: E402
from nyxus_tpu import taxonomy as jtx  # noqa: E402
from nyxus_tpu.config import EngineConfig as JConfig  # noqa: E402
from nyxus_tpu.ops import ih as jih  # noqa: E402
from nyxus_tpu.pipeline.runner import PairRunner as JRunner  # noqa: E402

import nyxus_tpu_torch  # noqa: E402
from nyxus_tpu_torch import columns as tcol  # noqa: E402
from nyxus_tpu_torch import registry  # noqa: E402
from nyxus_tpu_torch import taxonomy as ttx  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig as TConfig  # noqa: E402
from nyxus_tpu_torch.ops import ih as tih  # noqa: E402
from nyxus_tpu_torch.pipeline.runner import PairRunner as TRunner  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
_ENTROPY = ("ENTRO", "_JE", "_RE", "_DE", "INFOMEAS", "GLSZM_ZE")


# ---------------------------------------------------------------------------
# ops/ih.py against the JAX package's


def _ih_inputs(N, seed):
    """[12, 50] raw values (+inf padding) with an empty row, a one-pixel
    row and a uniform row, the per-row min/max, and an affine map."""
    r = np.random.default_rng(seed)
    B, A = 12, 50
    vals = r.integers(0, 40, (B, A)).astype(np.float64)
    cnt = r.integers(2, A + 1, B)
    cnt[0], cnt[1] = 0, 1
    for b in range(B):
        vals[b, cnt[b]:] = np.inf
    vals[2, :cnt[2]] = 7.0
    fin = np.where(np.isfinite(vals), vals, np.nan)
    fin[0] = 0.0
    vmin = np.where(cnt > 0, np.nanmin(fin, axis=1), 0.0)
    vmax = np.where(cnt > 0, np.nanmax(fin, axis=1), 0.0)
    pscale = r.uniform(0.5, 2.0, B)
    poffset = r.uniform(-1100.0, 100.0, B)
    return vals, cnt, vmin, vmax, pscale, poffset


def _agree_members(got, want):
    for m in jih.MEMBERS:
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want[m]),
                                   rtol=1e-9, atol=1e-12, err_msg=m)


@pytest.mark.parametrize("N", [2, 3, 6, 100])
@pytest.mark.parametrize("mapped", [False, True])
def test_ih_features_vs_jax(N, mapped):
    """ih_features (the binning through K1's plain version, then the
    statistics) equals the JAX package's, with and without an affine map;
    empty, one-pixel and uniform rows emit noval."""
    vals, cnt, vmin, vmax, ps, po = _ih_inputs(N, seed=N)
    if not mapped:
        ps = po = None
    J = lambda a: None if a is None else jnp.asarray(a)
    T = lambda a: None if a is None else torch.from_numpy(a)
    want = jih.ih_features(J(vals), J(cnt), J(vmin), J(vmax), N, -0.0,
                           J(ps), J(po))
    got = tih.ih_features(T(vals), T(cnt), T(vmin), T(vmax), N, -0.0,
                          T(ps), T(po))
    assert list(got) == list(jih.MEMBERS) == list(tih.MEMBERS)
    _agree_members(got, want)
    for b in (0, 2):
        assert all(np.signbit(got[m][b].item()) for m in tih.MEMBERS)


@pytest.mark.parametrize("N", [2, 3, 6, 100])
def test_ih_features_from_freq_vs_jax(N):
    """ih_features_from_freq on a given table (the streamed path's entry):
    random counts with zero rows and bins, counts not matching the table's
    sum on one row."""
    r = np.random.default_rng(10 + N)
    B = 9
    freq = r.integers(0, 9, (B, N)).astype(np.float64)
    freq[r.random((B, N)) < 0.4] = 0
    freq[0] = 0
    counts = freq.sum(axis=1)
    counts[3] += 2
    vmin = r.uniform(-50, 50, B)
    vmax = vmin + r.uniform(0, 300, B)
    vmax[4] = vmin[4]
    ps = r.uniform(0.5, 2, B)
    po = r.uniform(-10, 10, B)
    want = jih.ih_features_from_freq(*(jnp.asarray(a) for a in (
        freq, counts, vmin, vmax)), N, -0.0, jnp.asarray(ps), jnp.asarray(po))
    got = tih.ih_features_from_freq(*(torch.from_numpy(a) for a in (
        freq, counts, vmin, vmax)), N, -0.0, torch.from_numpy(ps),
        torch.from_numpy(po))
    _agree_members(got, want)


@pytest.mark.parametrize("nbins", [0, 1])
def test_ih_fewer_than_two_bins_is_noval(nbins):
    vals = torch.tensor([[1.0, 2.0, 3.0]], dtype=torch.float64)
    out = tih.ih_features(vals, torch.tensor([3]), vals.amin(1), vals.amax(1),
                          nbins, -0.0)
    assert all(v.item() == 0 and np.signbit(v.item()) for v in out.values())
    freq = torch.ones((1, nbins), dtype=torch.float64)
    out = tih.ih_features_from_freq(freq, torch.tensor([3]), vals.amin(1),
                                    vals.amax(1), nbins, -0.0)
    assert all(np.signbit(v.item()) for v in out.values())


def test_ih_freq_bins_in_float64():
    """The f32 frequency table equals the f64 one where float32's N / range
    would move a bin-edge value (25 * 64 / 100 = 16) into the bin below."""
    v = np.arange(0, 101, dtype=np.float64)[None, :]
    for dt in (torch.float32, torch.float64):
        t = torch.from_numpy(v).to(dt)
        f = tih.ih_freq(t, t.amin(1), t.amax(1), 64)
        assert f.dtype == dt
        want = np.bincount(np.clip(np.floor(v[0] * (64.0 / 100.0)), 0, 63)
                           .astype(int), minlength=64)
        np.testing.assert_array_equal(f[0].double().numpy(), want)


def test_ih_stats_plain_on_cpu():
    """On a CPU tensor K17's wrapper is its plain version; the result is
    [B, 46] in MEMBERS order."""
    import chip_smoke
    inputs = chip_smoke.ih_inputs(8, 6, torch.float64, device="cpu")
    got = tih.ih_stats(*inputs[:4], -0.0, *inputs[4:])
    want = tih.ih_features_from_freq_plain(*inputs[:4], -0.0, *inputs[4:])
    assert got.shape == (8, len(tih.MEMBERS)) and torch.equal(got, want)
    assert chip_smoke.ih_agree(got, want, inputs, 1e-12) == 0.0
    assert got[4:, tih.MEMBERS.index("IH_NUM_BINS")].tolist() == [6.0] * 4


# ---------------------------------------------------------------------------
# the IBSI families against the JAX package's PairRunner

IBSI_FEATURES = ["*ALL_INTENSITY*", "*ALL_IH*", "*ALL_GLCM*", "*ALL_GLRLM*",
                 "*ALL_GLDM*", "*ALL_NGTDM*", "*ALL_GLSZM*", "*ALL_GLDZM*",
                 "*ALL_NGLDM*"]
IBSI_GROUPS = ("IH_", "GLCM_", "GLRLM_", "GLDM_", "NGTDM_", "GLSZM_",
               "GLDZM_", "NGLDM_")


def _blobs_8bit(*args, **kw):
    """conftest.make_blobs with intensities (v >> 8) + 1: raw levels up to
    ~160, so IBSI's matrices are 256 levels (GLCM's marginals by index
    additions)."""
    intens, labels = make_blobs(*args, **kw)
    return ((intens >> 8) + 1).astype(np.uint16), labels


@pytest.fixture(scope="module")
def ibsi_blob_runs():
    """conftest.make_blobs with intensities % 59 + 1, as the reference
    fixtures have them (64 raw levels: at 256 the JAX package's one-hot
    GLCM marginals take ~15 GB on the CPU)."""
    intens, labels = make_blobs()
    intens = (intens % 59 + 1).astype(np.uint16)
    cfg = JConfig(precision="f64", ibsi=True)
    fset = jtx.parse_feature_request(IBSI_FEATURES, ibsi=True)
    jl, jv = JRunner(fset, cfg).run(intens, labels)
    tl, tv = TRunner(ttx.parse_feature_request(IBSI_FEATURES, ibsi=True),
                     TConfig(precision="f64", ibsi=True), "cpu").run(
        intens, labels)
    hdr, _ = jcol.build_header(fset, cfg)
    return hdr[4:], (jl, jv), (tl, tv)


@pytest.mark.parametrize("group", IBSI_GROUPS + ("intensity",))
def test_ibsi_families_vs_jax(ibsi_blob_runs, group):
    """IBSI raw levels (matrices sized by the slide max rounded up to a
    power of two), the symmetric GLCM with per-ROI Ng, NGTDM's IBSI gate,
    NGLDM's raw levels and the IH family equal the JAX package's."""
    cols, (jl, jv), (tl, tv) = ibsi_blob_runs
    np.testing.assert_array_equal(tl, jl)
    sel = [j for j, c in enumerate(cols)
           if (c.startswith(group) if group != "intensity"
               else not c.startswith(IBSI_GROUPS))]
    assert sel
    for j in sel:
        c = cols[j]
        rtol = 5e-7 if any(t in c for t in _ENTROPY) and \
            not c.startswith("IH_") else 1e-9
        np.testing.assert_allclose(tv[:, j], jv[:, j], rtol=rtol, atol=1e-12,
                                   err_msg=c)


def test_ibsi_max_int_and_ih_family_ported():
    fset = ttx.parse_feature_request(["*ALL*"], ibsi=True)
    assert "IntensityHistogramFeatures" in registry.activated_families(fset)
    hdr, _ = tcol.build_header(fset, TConfig(ibsi=True))
    assert len(hdr) - 4 == 793
    intens, labels = _blobs_8bit(64, 64, 3, seed=2)
    runner = TRunner(ttx.parse_feature_request(["*ALL_GLCM*"], ibsi=True),
                     TConfig(precision="f64", ibsi=True), "cpu")
    seen = []
    fn = registry.FAMILIES["GLCMFeature"].fn
    try:
        registry.FAMILIES["GLCMFeature"].fn = \
            lambda ctx, cfg: seen.append(ctx.static_meta) or fn(ctx, cfg)
        runner.run(intens, labels)
    finally:
        registry.FAMILIES["GLCMFeature"].fn = fn
    top = int(intens[labels > 0].max())
    assert seen and all(m == {"max_int": 1 << (top - 1).bit_length()}
                        for m in seen)


def test_glcm_chunks_equal_one_pass(monkeypatch):
    """The GLCM family run over chunks of ROIs (as at raw 12-bit levels)
    gives every ROI the values of one pass."""
    intens, labels = _blobs_8bit(96, 96, 6, seed=8)
    fset = ttx.parse_feature_request(["*ALL_GLCM*"], ibsi=True)
    cfg = TConfig(precision="f64", ibsi=True)
    _, whole = TRunner(fset, cfg, "cpu").run(intens, labels)
    monkeypatch.setattr(registry, "GLCM_CHUNK_CELLS", 1)
    _, chunked = TRunner(fset, cfg, "cpu").run(intens, labels)
    np.testing.assert_array_equal(chunked, whole)


@pytest.mark.parametrize("ng", [16, 96])
def test_glcm_features_from_matrix_vs_jax(ng):
    """GLCM's 30 statistics from count matrices (their |i-j| and i+j
    marginals by index additions) equal the JAX package's (one-hot
    matmuls), with per-ROI Ng and an empty angle."""
    from nyxus_tpu.ops import glcm as jglcm
    from nyxus_tpu_torch.ops import glcm
    r = np.random.default_rng(ng)
    M = (r.random((3, 4, ng, ng)) < 0.05) * r.integers(1, 6, (3, 4, ng, ng))
    M = M.astype(np.float64)
    M[0, 1] = 0
    ngv = np.array([ng - 6.0, ng - 16.0, ng - 1.0])
    want = jglcm.glcm_features_from_matrix(jnp.asarray(M), ng, -0.0,
                                           ng_val=jnp.asarray(ngv))
    got = glcm.glcm_features_from_matrix(torch.from_numpy(M), ng, -0.0,
                                         ng_val=torch.from_numpy(ngv))
    for m in glcm.MEMBERS:
        rtol = 5e-7 if any(t in m for t in _ENTROPY) else 1e-9
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want[m]),
                                   rtol=rtol, atol=1e-12, err_msg=m)


# ---------------------------------------------------------------------------
# the IBSI digital phantom (tests/test_goldens_ibsi.py's protocol)


def _agrees_gt(fval, gt, frac):
    if abs(gt) < 1e-12:
        return abs(fval - gt) <= 1e-9
    return abs(fval - gt) <= abs(gt / frac)


def _phantom_slices():
    for z in (1, 2, 3, 4):
        yield (grid(PIXELS["ibsi_phantom_z%d_intensity" % z]),
               grid(PIXELS["ibsi_phantom_z%d_mask" % z]))


def _run_one(intens, mask, feats, **cfg_kw):
    cfg = TConfig(precision="f64", **cfg_kw)
    fset = ttx.parse_feature_request(feats, ibsi=cfg.ibsi)
    labs, values = TRunner(fset, cfg, "cpu").run(
        intens.astype(np.uint16), (mask != 0).astype(np.int32))
    cols, _ = tcol.build_header(fset, cfg)
    assert len(labs) == 1
    return dict(zip(cols[4:], values[0]))


def _pooled_phantom():
    ii = np.zeros((4, 4 * 6), np.uint16)
    mm = np.zeros((4, 4 * 6), np.int32)
    for k, (inten, mask) in enumerate(_phantom_slices()):
        ii[:, k * 6:k * 6 + 5] = inten
        mm[:, k * 6:k * 6 + 5] = mask != 0
    return ii, mm


@pytest.fixture(scope="module")
def phantom_rows():
    feats = ["*ALL_GLCM*", "*ALL_GLRLM*", "*ALL_GLSZM*", "*ALL_GLDM*",
             "*ALL_NGTDM*", "*ALL_GLDZM*", "*ALL_NGLDM*"]
    rows = [_run_one(i, m, feats, ibsi=True) for i, m in _phantom_slices()]
    ii, mm = _pooled_phantom()
    ih = _run_one(ii, mm, ["*ALL_IH*"], ibsi=True, coarse_gray_depth=6)
    return rows, ih


_ANGLED = [("glcm", n) for n in
           sorted(GOLDENS["ibsi_reference_glcm_feature_golden_values"])] + \
    [("glrlm", n) for n in
     sorted(GOLDENS["ibsi_reference_glrlm_feature_golden_values"])]


@pytest.mark.parametrize("fam,name", _ANGLED)
def test_phantom_angled_families(phantom_rows, fam, name):
    """GLCM / GLRLM: 4 slices x 4 angles, total / 16, rel 1e-2."""
    gold = GOLDENS["ibsi_reference_%s_feature_golden_values" % fam][name]
    total = sum(row["%s_%d" % (name, a)] for row in phantom_rows[0]
                for a in (0, 45, 90, 135))
    assert _agrees_gt(total / 16, gold, 100.), (name, total / 16, gold)


_SCALAR = [(k, n, frac) for k, frac in (
    ("ibsi_reference_glszm_feature_golden_values", 100.),
    ("ibsi_reference_gldm_feature_golden_values", 100.),
    ("ibsi_reference_ngtdm_feature_golden_values", 100.),
    ("ibsi_reference_gldzm_feature_golden_values", 2.),
    ("ibsi_reference_ngldm_feature_reference_values", 2.))
    for n in sorted(GOLDENS[k])]


@pytest.mark.parametrize("table,name,frac", _SCALAR,
                         ids=["%s-%s" % (t.split("_")[2], n)
                              for t, n, _ in _SCALAR])
def test_phantom_scalar_families(phantom_rows, table, name, frac):
    """GLSZM / GLDM / NGTDM (rel 1e-2) and GLDZM / NGLDM (the reference's
    loose rel 0.5): 4 slices, total / 4.  NGLDM's -1 entries are pinned to
    the reference's own regression table."""
    total = sum(row[name] for row in phantom_rows[0])
    gold = GOLDENS[table][name]
    if table.endswith("ngldm_feature_reference_values") and gold < 0:
        regr = GOLDENS[
            "unvetted_nyxus_regression_ngldm_feature_reference_values"][name]
        assert total / 4 == pytest.approx(regr, rel=1e-9)
        return
    assert _agrees_gt(total / 4, gold, frac), (name, total / 4, gold)


@pytest.mark.parametrize("name", sorted(GOLDENS["ibsi_ih_phantom_golden"]))
def test_phantom_ih(phantom_rows, name):
    """IH over the pooled phantom, 6 bins, rel 1e-2."""
    got = phantom_rows[1]["IH_" + name]
    gold = GOLDENS["ibsi_ih_phantom_golden"][name]
    assert _agrees_gt(got, gold, 100.), (name, got, gold)


# ---------------------------------------------------------------------------
# IH against the numpy oracle, and the HU cases of tests/test_ih.py


def test_ih_members_match_oracle(blob_pair):
    intens, labels = blob_pair
    cfg = TConfig(precision="f64", ibsi=True)
    fset = ttx.parse_feature_request(["*ALL_IH*"], ibsi=True)
    labs, values = TRunner(fset, cfg, "cpu").run(intens, labels)
    cols = tcol.build_header(fset, cfg)[0][4:]
    checked = 0
    for i, lab in enumerate(labs):
        ref = oracle_ih.ih_features(
            intens[labels == lab].astype(np.float64), cfg.coarse_gray_depth)
        if ref is None:
            continue
        row = dict(zip(cols, values[i]))
        for key, want in ref.items():
            assert row[key] == pytest.approx(want, rel=1e-9, abs=1e-9), key
            checked += 1
    assert checked > 5 * 46


def test_ih_degenerate_roi_nan():
    intens = np.zeros((24, 24), np.uint16)
    labels = np.zeros((24, 24), np.int32)
    intens[2:8, 2:8] = 77            # uniform ROI: max == min -> noval
    labels[2:8, 2:8] = 1
    intens[12:20, 12:20] = np.arange(64).reshape(8, 8) + 1
    labels[12:20, 12:20] = 2
    nyx = nyxus_tpu_torch.Nyxus(["IH_MEAN_VAL", "IH_NUM_BINS"], device="cpu",
                                ibsi=True)
    df = nyx.featurize(intens, labels)
    r1 = df[df.ROI_label == 1].iloc[0]
    assert r1.IH_MEAN_VAL == -0.0 and r1.IH_NUM_BINS == -0.0
    r2 = df[df.ROI_label == 2].iloc[0]
    assert r2.IH_NUM_BINS == 64
    ref = oracle_ih.ih_features(np.arange(64.0) + 1, 64)
    assert r2.IH_MEAN_VAL == pytest.approx(ref["IH_MEAN_VAL"], rel=1e-9)


def test_ih_affine_float_domain():
    """The affine map shifts reported values, not bin indices."""
    r = np.random.default_rng(3)
    v = torch.from_numpy(r.integers(10, 4000, (1, 500)).astype(np.float64))
    args = (v, torch.tensor([500]), v.amin(1), v.amax(1), 32, -0.0)
    a = tih.ih_features(*args)
    b = tih.ih_features(*args, torch.tensor([2.5], dtype=torch.float64),
                        torch.tensor([-100.0], dtype=torch.float64))
    assert b["IH_MEAN_IDX"].item() == a["IH_MEAN_IDX"].item()
    assert b["IH_MODE_IDX"].item() == a["IH_MODE_IDX"].item()
    assert b["IH_MEAN_VAL"].item() == pytest.approx(
        -100.0 + 2.5 * a["IH_MEAN_VAL"].item())


def test_preserve_hu_end_to_end():
    """preserve_hu: first-order stats run on the offset uints while IH_*
    report in the original HU domain (the floored slide minimum that the
    load shifted away is added back)."""
    r = np.random.default_rng(0)
    hu = r.integers(-400, 900, (64, 64)).astype(np.int32)
    ll = np.zeros((64, 64), np.int32)
    ll[8:40, 8:40] = 1
    feats = ["MEAN", "MIN", "MAX", "IH_MEAN_VAL", "IH_MINIMUM_VAL",
             "IH_MAXIMUM_VAL", "IH_MEDIAN_VAL"]
    df = nyxus_tpu_torch.Nyxus(feats, device="cpu", ibsi=True,
                               preserve_hu=True,
                               precision="f64").featurize(hu, ll)
    sel = hu[ll == 1].astype(np.float64)
    off = np.floor(hu.min())
    np.testing.assert_allclose(df.MEAN[0], (sel - off).mean(), rtol=1e-12)
    assert df.MIN[0] == sel.min() - off and df.MAX[0] == sel.max() - off
    binw = (sel.max() - sel.min()) / 64
    assert abs(df.IH_MINIMUM_VAL[0] - sel.min()) <= binw
    assert abs(df.IH_MAXIMUM_VAL[0] - sel.max()) <= binw
    assert abs(df.IH_MEAN_VAL[0] - sel.mean()) <= binw
    assert df.IH_MEAN_VAL[0] < 0 or sel.mean() > 0


def test_preserve_hu_ih_equals_jax():
    """Every IH member of a negative-valued image under preserve_hu equals
    the JAX package's Nyxus (the offset reaches IH through the runner)."""
    import nyxus_tpu
    intens, labels = make_blobs(96, 96, 5, seed=4)
    img = intens.astype(np.float64) / 9.0 - 700.5
    kw = dict(ibsi=True, preserve_hu=True, precision="f64")
    want = nyxus_tpu.Nyxus(["*ALL_IH*"], **kw).featurize(img, labels)
    got = nyxus_tpu_torch.Nyxus(["*ALL_IH*"], device="cpu", **kw).featurize(
        img, labels)
    assert list(got.columns) == list(want.columns)
    cols = list(want.columns[4:])
    assert (want["IH_MINIMUM_VAL"] < 0).any()
    np.testing.assert_allclose(got[cols].to_numpy(float),
                               want[cols].to_numpy(float), rtol=1e-9,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# the reference binary's IBSI CSV

IBSI_REF_GROUPS = {
    "IH": lambda c: c.startswith("IH_"),
    "textures": lambda c: c.startswith(("GL", "NGTDM", "NGLDM")),
    "shape+intensity": lambda c: not c.startswith(("IH_", "GL", "NGTDM",
                                                   "NGLDM")),
}


@pytest.fixture(scope="module")
def ibsi_reference_frames():
    ref = pd.read_csv(gzip.open(
        os.path.join(DATA, "ref_ibsi_320x320_seed11.csv.gz"), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    intens, labels = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
    intens = (intens % 59 + 1).astype(np.uint16)
    df = nyxus_tpu_torch.Nyxus(["*ALL*"], device="cpu", ibsi=True,
                               precision="f64").featurize(intens, labels)
    assert df.shape[1] - 4 == 793
    return ref, df.set_index("ROI_label").iloc[:, 3:]


@pytest.mark.parametrize("group", list(IBSI_REF_GROUPS))
def test_ibsi_reference_binary_parity(ibsi_reference_frames, group):
    """The 793 IBSI columns against the reference CLI's --ibsi CSV at
    test_config_parity's p90 1e-4 (DIAMETER_MIN_ENCLOSING_CIRCLE 5.0, the
    first central moments, zero by construction, skipped); at least 700
    columns checked over the groups."""
    ref, ours = ibsi_reference_frames
    assert list(ref.index) == list(ours.index)
    skip = ("CENTRAL_MOMENT_01", "CENTRAL_MOMENT_10", "IMOM_CM_01",
            "IMOM_CM_10")
    failures, checked = [], 0
    for c in ours.columns:
        if c not in ref.columns or c in skip or not IBSI_REF_GROUPS[group](c):
            continue
        a = ours[c].to_numpy(float)
        b = ref[c].to_numpy(float)
        both = np.isfinite(a) & np.isfinite(b)
        if both.sum() == 0:
            continue
        rel = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), 1e-6)
        p90 = float(np.quantile(rel, 0.9))
        checked += 1
        tol = 5.0 if c == "DIAMETER_MIN_ENCLOSING_CIRCLE" else 1e-4
        if p90 > tol:
            failures.append((c, p90))
    assert not failures, failures[:25]
    assert checked >= {"IH": 46, "textures": 250, "shape+intensity": 400}[
        group], checked
    total = sum(1 for c in ours.columns if c in ref.columns and c not in skip)
    assert total >= 700


def test_chip_smoke_ih_tiers():
    """chip_smoke's whole-token DISCRETE match skips exactly the IH order
    statistics and modes -- the median, p10, p90, mode and the median
    absolute deviation, as values and bin indices -- and holds every other
    IH member at its tier: IH_MINIMUM*, IH_MAXIMUM* and IH_RANGE* are the
    ROI's exact min and max on both sides, so they are held, not skipped."""
    import chip_smoke
    fset = ttx.parse_feature_request(["*ALL*"], ibsi=True)
    cols = [c for c in tcol.build_header(fset, TConfig(ibsi=True))[0][4:]
            if c.startswith("IH_")]
    assert len(cols) == 46
    skipped = {c for c in cols
               if set(c.split("_")) & set(chip_smoke.DISCRETE)}
    assert skipped == {"IH_%s_%s" % (m, k) for k in ("VAL", "IDX") for m in (
        "MEDIAN", "P10", "P90", "MODE", "MEDIAN_ABSOLUTE_DEVIATION")}
    held = [c for c in cols if c not in skipped]
    assert {"IH_MINIMUM_VAL", "IH_MAXIMUM_IDX", "IH_RANGE_VAL"} <= set(held)
    assert all(chip_smoke.tol_for(c) == chip_smoke.DEFAULT_TOL for c in held)
    ref = np.ones((4, len(cols)))
    dev = ref.copy()
    dev[:, [cols.index(c) for c in skipped]] = 3.0
    assert chip_smoke.compare_tiers(cols, dev, ref)[0] == []
    dev[:, cols.index("IH_RANGE_VAL")] = 1.01
    assert [c for c, _ in chip_smoke.compare_tiers(cols, dev, ref)[0]] == \
        ["IH_RANGE_VAL"]
    assert set(chip_smoke.IH_FROM_HISTOGRAM) <= set(cols)
    assert set(chip_smoke.IH_EXACT) <= set(cols)
