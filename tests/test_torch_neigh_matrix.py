"""The plain versions of K4 ``neigh_matrix`` (nyxus_tpu_torch/ops/common.py
neigh_matrix_plain, behind gldm_matrix_plain, ngtdm_matrices_plain and
ngldm_matrix_plain): each family's matrix equals, bit for bit, the call
sequence the families made before K4 formed the whole matrix in one launch
(the stencil counts of stencil8_plain, then K1's plain histogram), and
equals the JAX package's matrices in f64 (nyxus_tpu/ops/gldm.py:27
gldm_matrix; the N, S and present levels of nyxus_tpu/ops/ngtdm.py:32-57;
the P of nyxus_tpu/ops/ngldm.py:41-58).  Cases: one-pixel ROIs at the
corners, edges and middle of a 7 x 13 crop, a uniform ROI, ROIs that cover
their crop to its border, levels outside the matrix (negative and past it)
and IBSI's 256 raw levels.  On the CPU the family functions run these plain
versions (tests/test_torch_cuda.py holds the kernel against them on the
card).

NGTDM's and NGLDM's JAX matrices are built inside their feature functions,
so ``_jax_matrix`` copies that inline code (ngtdm.py:32-57, ngldm.py:41-58)
from the JAX package's primitives: a change to the package's code is not
seen here.  tests/test_torch_texture.py::test_family_members holds the
port's NGTDM, NGLDM and GLDM features to the package's own functions.

Tolerances: counts and present levels equal; NGTDM's S, a float sum in
another order than JAX's one-hot matmul, within rtol 1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nyxus_tpu.ops import common as jc
from nyxus_tpu.ops import gldm as jgldm

from nyxus_tpu_torch.ops import common as tc
from nyxus_tpu_torch.ops import gldm as tgldm
from nyxus_tpu_torch.ops import ngldm as tngldm
from nyxus_tpu_torch.ops import ngtdm as tngtdm
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

CASES = ("one pixel", "uniform", "border", "levels out of range", "ibsi 256")
DTYPES = {"f32": torch.float32, "f64": torch.float64}
FAMILIES = ("gldm", "ngtdm", "ngldm")


def _case(name):
    """(levels, original intensities, ROI mask, AABB mask, matrix levels) of
    one case, as numpy arrays made from a seed."""
    r = np.random.default_rng(len(name))
    if name == "one pixel":
        B, H, W, nb = 8, 7, 13, 16
        lev = r.integers(1, nb + 1, (B, H, W))
        roi = np.zeros((B, H, W), bool)
        for b, (y, x) in enumerate([(0, 0), (0, 12), (6, 0), (6, 12), (3, 6),
                                    (0, 5), (6, 7), (2, 0)]):
            roi[b, y, x] = True
    elif name == "uniform":
        B, H, W, nb = 3, 8, 8, 16
        lev = np.full((B, H, W), 5)
        roi = np.ones((B, H, W), bool)
    elif name == "border":
        B, H, W, nb = 4, 12, 12, 16
        lev = r.integers(1, 5, (B, H, W))
        roi = r.random((B, H, W)) < 0.85
        roi[:, 0, :] = roi[:, -1, :] = roi[:, :, 0] = roi[:, :, -1] = True
    elif name == "levels out of range":
        B, H, W, nb = 4, 16, 16, 16
        lev = r.integers(-3, 21, (B, H, W))
        roi = r.random((B, H, W)) < 0.8
    else:
        B, H, W, nb = 3, 16, 16, 256
        lev = r.integers(0, 256, (B, H, W))
        roi = r.random((B, H, W)) < 0.9
    orig = np.where(roi, np.abs(lev) + 0.5, 0.0)
    aabb = np.ones((B, H, W), bool)
    return lev.astype(np.int32), orig, roi, aabb, nb


def _parent(family, lev, orig, roi, aabb, nb, dtype):
    """The families' call sequence before K4 formed the whole matrix, as
    gldm_matrix, ngtdm_matrices and ngldm_features made it on the CPU."""
    B = lev.shape[0]
    if family == "gldm":
        r = orig > 0
        same, _, _ = tc.stencil8_plain(lev, r)
        return tc.pair_hist_plain((lev.to(torch.int32) - 1).reshape(B, -1),
                                  same.reshape(B, -1),
                                  r.reshape(B, -1).to(dtype), nb, 9)
    if family == "ngldm":
        matches, _, _ = tc.stencil8_plain(lev, roi)
        return tc.pair_hist_plain(torch.where(roi, lev, 0).reshape(B, -1),
                                  matches.reshape(B, -1),
                                  roi.reshape(B, -1).to(dtype), nb + 1, 9)
    valid = aabb & (lev > 0)
    lv = torch.where(valid, lev.to(torch.int32), 0)
    _, nsum, ncnt = tc.stencil8_plain(lv, valid)
    is_zone = (lv > 0) & (ncnt > 0)
    ave = torch.where(is_zone,
                      nsum.to(dtype) / torch.clamp(ncnt, min=1).to(dtype), 0)
    wzone = is_zone.reshape(B, -1).to(dtype)
    diff = torch.abs(lv.to(dtype) - ave).reshape(B, -1)
    N, S, cnt = tc.batched_hist_plain(lv.reshape(B, -1), torch.stack(
        (wzone, wzone * diff, valid.reshape(B, -1).to(dtype))), nb + 1)
    present = cnt > 0
    present[:, 0] = False
    return N, S, present


def _plain(family, lev, orig, roi, aabb, nb, dtype):
    if family == "gldm":
        return tgldm.gldm_matrix_plain(orig, lev, nb, dtype)
    if family == "ngldm":
        return tngldm.ngldm_matrix_plain(lev, roi, nb, dtype)
    return tngtdm.ngtdm_matrices_plain(lev, aabb & (lev > 0), nb, dtype)


def _family(family, lev, orig, roi, aabb, nb, dtype):
    if family == "gldm":
        return tgldm.gldm_matrix(orig, lev, nb, dtype)
    if family == "ngldm":
        return tngldm.ngldm_matrix(lev, roi, nb, dtype)
    return tngtdm.ngtdm_matrices(lev, aabb & (lev > 0), nb, dtype)


def _torch_inputs(name, dtype):
    lev, orig, roi, aabb, nb = _case(name)
    return (torch.from_numpy(lev), torch.from_numpy(orig).to(dtype),
            torch.from_numpy(roi), torch.from_numpy(aabb), nb)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("name", CASES)
def test_plain_matrix_is_the_former_sequence(name, prec, family):
    """Bit for bit the former call sequence, and what the family function
    returns on the CPU (no kernel launched)."""
    dtype = DTYPES[prec]
    lev, orig, roi, aabb, nb = _torch_inputs(name, dtype)
    want = _tuple(_parent(family, lev, orig, roi, aabb, nb, dtype))
    launches = tc.neigh_matrix.launches
    for got in (_plain(family, lev, orig, roi, aabb, nb, dtype),
                _family(family, lev, orig, roi, aabb, nb, dtype)):
        got = _tuple(got)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)
    assert tc.neigh_matrix.launches == launches


def _jax_matrix(family, lev, orig, roi, aabb, nb):
    """The JAX package's matrix of the family, in f64: gldm_matrix itself;
    NGTDM's N, S and present and NGLDM's P as nyxus_tpu/ops/ngtdm.py:32-57
    and nyxus_tpu/ops/ngldm.py:41-58 build them inside their features."""
    B = lev.shape[0]
    lev, orig = jnp.asarray(lev), jnp.asarray(orig)
    roi, aabb = jnp.asarray(roi), jnp.asarray(aabb)
    if family == "gldm":
        return jgldm.gldm_matrix(orig, lev, nb, jnp.float64)
    if family == "ngldm":
        lv = jnp.where(roi, lev, -1)
        matches = jnp.zeros(lv.shape, jnp.int32)
        for dx, dy in jc.NEIGHBORS8:
            n_lev = jc.shifted2d(lv, dx, dy, fill=-1)
            matches = matches + ((n_lev >= 0) & (n_lev == lv)).astype(
                jnp.int32)
        return jc.pair_hist(jnp.where(roi, lv, 0).reshape(B, -1),
                            matches.reshape(B, -1),
                            roi.reshape(B, -1).astype(jnp.float64), nb + 1, 9)
    valid = aabb & (lev > 0)
    lv = jnp.where(valid, lev, 0)
    lev_f = lv.astype(jnp.float64)
    nz = lv > 0
    neig_sum = jnp.zeros_like(lev_f)
    neig_cnt = jnp.zeros_like(lev_f)
    for dx, dy in jc.NEIGHBORS8:
        ok = (jc.shifted2d(nz.astype(jnp.int32), dx, dy) > 0).astype(
            jnp.float64)
        neig_sum = neig_sum + jc.shifted2d(lev_f, dx, dy) * ok
        neig_cnt = neig_cnt + ok
    is_zone = nz & (neig_cnt > 0)
    ave = jnp.where(is_zone, neig_sum / jnp.maximum(neig_cnt, 1), 0)
    flat = lv.reshape(B, -1)
    wz = is_zone.reshape(B, -1).astype(jnp.float64)
    N = jc.masked_bincount(flat, wz, nb + 1)
    S = jc.masked_bincount(flat, wz * jnp.abs(lev_f - ave).reshape(B, -1),
                           nb + 1)
    present = jc.masked_bincount(flat, valid.reshape(B, -1).astype(
        jnp.float64), nb + 1) > 0
    return N, S, present.at[:, 0].set(False)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", CASES)
def test_plain_matrix_equals_jax(name, family):
    lev, orig, roi, aabb, nb = _case(name)
    got = _tuple(_plain(family, torch.from_numpy(lev),
                        torch.from_numpy(orig), torch.from_numpy(roi),
                        torch.from_numpy(aabb), nb, torch.float64))
    want = _tuple(_jax_matrix(family, lev, orig, roi, aabb, nb))
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if family == "ngtdm" and k == 1:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_array_equal(g, w)


def test_neigh_matrix_refuses_bad_calls():
    """An unknown family raises on the CPU; a tensor on neither the CPU nor
    a card raises before any launch."""
    lev = torch.ones((1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tc.neigh_matrix("glcm", lev, lev > 0, 4, torch.float64)
    meta = lev.to("meta")
    with pytest.raises(ValueError):
        tc.neigh_matrix("ngtdm", meta, meta > 0, 4, torch.float32)
