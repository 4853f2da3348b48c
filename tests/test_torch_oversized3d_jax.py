"""The port's slice-streamed 3D phase 3 (pipeline/oversized3d.py) against
the JAX package's, in f64 on the CPU, every ROI oversized
(``ram_limit_mb=0``), *3D_ALL*: tests/test_oversized.py's two 3D cases
(the default configuration on _blob3d(seed=4), IBSI on _blob3d(seed=9)
at intensities % 14 + 1 and grey depth 16), at 20 x 24 x 28 and 16 x 20 x
24, and the binned configuration (grey depth 64 for GLRLM, GLSZM, GLDM and
NGTDM, NGTDM radius 1), whose NGTDM statistics are not the default's
zeros.

- The port's oversized rows against JAX's, one family's columns a test:
  rtol 1e-9 (atol 1e-12), 5e-7 for the fast_log2 entropies, NaN in the
  same places.
- The port's oversized rows against its own trivial rows, as
  tests/test_oversized.py holds JAX's (rtol 1e-8, atol 1e-10 where both
  are finite; INFOMEAS at atol 1e-6 in IBSI mode).
- Each finish stage alone (``FINISH3D``) over the port's accumulators of
  the ellipsoid ROI against the same family of JAX's ``process3d`` on the
  same record (the accumulators are the JAX package's code): every member
  at the same tolerances."""

import functools

import numpy as np
import pytest

from test_oversized import _blob3d
from test_torch_3d_modes_jax import FAMILIES, agree, family_columns, run_both

from nyxus_tpu.config import EngineConfig as JConfig
from nyxus_tpu.pipeline import oversized3d as joversized3d

from nyxus_tpu_torch import taxonomy as ttx
from nyxus_tpu_torch.config import EngineConfig as TConfig
from nyxus_tpu_torch.pipeline import oversized3d
from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner, discover_rois_3d
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

ENTROPY = ("ENTRO", "_JE", "_RE", "_ZE", "_DE", "INFOMEAS", "_ZDE", "DCENT")
BINNED = dict(d3_glrlm_greydepth=64, d3_glszm_greydepth=64,
              d3_gldm_greydepth=64, d3_ngtdm_greydepth=64, d3_ngtdm_radius=1)


def _volume(case):
    if case == "ibsi":
        intens, labels = _blob3d(seed=9, shape=(16, 20, 24))
        return (intens % 14 + 1).astype(np.uint16), labels
    intens, labels = _blob3d(seed=4, shape=(20, 24, 28))
    return (intens % 59 + 1).astype(np.uint16), labels


CASES = {"default": {}, "ibsi": dict(ibsi=True, coarse_gray_depth=16),
         "binned": BINNED}


@functools.lru_cache(maxsize=None)
def oversized_run(case):
    return run_both(*_volume(case), dict(CASES[case], ram_limit_mb=0),
                    ibsi=case == "ibsi")


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("case", list(CASES))
def test_oversized3d_equals_jax(case, family):
    cols, labs, got, want = oversized_run(case)
    assert list(labs) == [1, 3]
    idx = family_columns(cols, family)
    agree([cols[j] for j in idx], got[:, idx], want[:, idx])


@pytest.mark.parametrize("case", list(CASES))
def test_oversized3d_matches_trivial(case):
    """Every ROI through phase 3 equals the port's trivial (dense) path."""
    cols, labs, over, _ = oversized_run(case)
    cfg = dict(CASES[case], precision="f64")
    fset = ttx.parse_feature_request(["*3D_ALL*"], dim=3,
                                     ibsi=case == "ibsi")
    runner = VolumeRunner(fset, TConfig(**cfg), device="cpu")
    assert runner.cfg.ram_limit_mb << 20 > 0
    l1, triv = runner.run(*_volume(case))
    np.testing.assert_array_equal(l1, labs)
    for j, c in enumerate(cols):
        a, b = triv[:, j], over[:, j]
        both = np.isfinite(a) & np.isfinite(b)
        atol = 1e-6 if (case == "ibsi" and "INFOMEAS" in c) else 1e-10
        np.testing.assert_allclose(b[both], a[both], rtol=1e-8, atol=atol,
                                   err_msg=c)


@functools.lru_cache(maxsize=None)
def finish_inputs(case):
    """(port accumulators, JAX process3d result) of the ellipsoid ROI."""
    intens, labels = _volume(case)
    cfg = dict(CASES[case], precision="f64")
    recs, smin, smax = discover_rois_3d(intens, labels)
    rec = next(r for r in recs if r.label == 3)
    fams = set(oversized3d.FINISH3D) | {"D3_SurfaceFeature"}
    acc = oversized3d.accumulate3d(rec, intens, labels, TConfig(**cfg), fams,
                                   smin, smax)
    want = joversized3d.process3d(rec, intens, labels, JConfig(**cfg), fams,
                                  smin, smax)
    return acc, want


@pytest.mark.parametrize("family", list(oversized3d.FINISH3D))
@pytest.mark.parametrize("case", list(CASES))
def test_finish_stage_equals_jax(case, family):
    acc, want = finish_inputs(case)
    got = oversized3d.FINISH3D[family](acc, "cpu")
    want = want[family]
    assert sorted(got) == sorted(want)
    for m, w in want.items():
        g = np.asarray(got[m], np.float64)
        w = np.asarray(w, np.float64)
        tol = 5e-7 if any(t in m for t in ENTROPY) else 1e-9
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=m)
        np.testing.assert_allclose(g, w, rtol=tol, atol=1e-12,
                                   equal_nan=True, err_msg=m)


def test_surface_members_of_accumulators():
    """The host surface members of the streamed sums equal JAX's."""
    acc, want = finish_inputs("default")
    got = oversized3d._surface_members(acc.rec, acc.surf)
    assert got == want["D3_SurfaceFeature"]
