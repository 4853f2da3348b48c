"""The port's CUDA kernels against their plain PyTorch versions, and the
slice in f32 on the card against the port's own f64 CPU run.  Every test
needs a CUDA device and skips without one.  This file imports neither jax
nor the JAX package, so it runs on a machine with a card and no jax:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Counts must be equal.  Weighted float sums hold rtol 1e-12 in f64 and, in
f32, 1e-6 up to the main path's 64 x 64 buckets and 1e-5 above: the
kernel's atomics add in another order, and a bin of a 256 x 256 crop sums
~1000 float32 terms, whose rounding then differs by more than 1e-6."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from nyxus_tpu_torch import columns, taxonomy  # noqa: E402
from nyxus_tpu_torch.config import EngineConfig  # noqa: E402
from nyxus_tpu_torch.ops import common, glcm, glrlm  # noqa: E402
from nyxus_tpu_torch.pipeline.runner import PairRunner  # noqa: E402

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# (B, H, W, ROI AABB) buckets: the main path's, a ROI that does not fill its
# bucket, a shape that is not a power of two, the 128/256 buckets whose run
# matrices need more than 48 KB of shared memory, and an empty ROI
CASES = [(64, 32, 32, (29, 31)), (64, 64, 64, (60, 47)), (28, 16, 16, (13, 9)),
         (5, 32, 32, (13, 21)), (3, 7, 13, (7, 13)), (4, 128, 128, (101, 77)),
         (2, 256, 256, (250, 199)), (1, 16, 16, (0, 0))]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


def _bucket(case, dtype, seed=0):
    B, H, W, hw = case
    return chip_smoke.synth_bucket(B, H, W, hw, seed, dtype,
                                   empty=hw == (0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_batched_hist(prec, case):
    dtype = DTYPES[prec]
    orig, lev, aabb, roi = _bucket(case, dtype)
    B = orig.shape[0]
    flat = (lev - 1).reshape(B, -1)
    cnt = roi.reshape(B, -1).to(dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    w = torch.rand(cnt.shape, generator=g, device="cuda", dtype=dtype) * cnt
    for idx, nbins in ((flat, 64), (flat * 9 + flat % 9, 576),
                       (flat * 256 + flat, 64 * 256)):
        assert torch.equal(common.batched_hist(idx, cnt, nbins),
                           common.batched_hist_plain(idx, cnt, nbins))
    rtol = 1e-12 if prec == "f64" else 1e-6 if case[1] * case[2] <= 4096 \
        else 1e-5
    torch.testing.assert_close(common.batched_hist(flat, w, 65),
                               common.batched_hist_plain(flat, w, 65),
                               rtol=rtol, atol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_glcm_cooc(prec, case):
    orig, lev, _, _ = _bucket(case, DTYPES[prec])
    for angles, offset in (((0, 45, 90, 135), 1), ((90,), 1),
                           ((45, 135), 3)):
        for sym in (False, True):
            assert torch.equal(
                glcm.cooc_matrices(orig, lev, angles, offset, 64, sym),
                glcm.cooc_matrices_plain(orig, lev, angles, offset, 64, sym))


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_glrlm_runs(prec, case):
    dtype = DTYPES[prec]
    _, lev, aabb, roi = _bucket(case, dtype)
    nr = max(lev.shape[1:])
    for valid in (aabb, roi):
        assert torch.equal(glrlm.run_matrices(lev, valid, 64, nr, dtype),
                           glrlm.run_matrices_plain(lev, valid, 64, nr, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("anti", [False, True])
def test_glrlm_runs_single_diagonal(anti):
    lev = torch.ones((1, 8, 8), dtype=torch.int32)
    valid = torch.zeros((1, 8, 8), dtype=torch.bool)
    for k in range(5):
        y, x = (1 + k, 6 - k) if anti else (2 + k, 1 + k)
        lev[0, y, x] = 3
        valid[0, y, x] = True
    P = glrlm.run_matrices(lev.cuda(), valid.cuda(), 4, 8, torch.float32)
    want = torch.zeros((4, 4, 8))
    for a in range(4):
        if a == (3 if anti else 1):
            want[a, 2, 4] = 1
        else:
            want[a, 2, 0] = 5
    assert torch.equal(P.cpu()[0], want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=str)
def test_stencil8(case):
    _, lev, aabb, roi = _bucket(case, torch.float32)
    for part in (roi, aabb):
        for got, want in zip(common.stencil8(lev, part),
                             common.stencil8_plain(lev, part)):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_shared_memory_limits_raise():
    idx = torch.zeros((1, 4), dtype=torch.int32, device="cuda")
    w = torch.ones((1, 4), dtype=torch.float64, device="cuda")
    with pytest.raises(NotImplementedError):
        common.batched_hist(idx, w, 30000)
    lev = torch.ones((1, 4, 4), dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError):
        glcm.cooc_matrices(lev.double(), lev, (0,), 1, 256, False)
    with pytest.raises(NotImplementedError):
        glrlm.run_matrices(lev, lev > 0, 256, 512, torch.float32)


@pytest.mark.cuda
def test_slice_f32_on_card_against_f64_cpu():
    counters = (common.batched_hist, common.stencil8, glcm.cooc_matrices,
                glrlm.run_matrices)
    before = [f.launches for f in counters]
    fset = taxonomy.parse_feature_request(chip_smoke.FEATURES)
    intens, labels = chip_smoke.make_dsb_like(320, 320, 40, seed=11)
    labs, dev = PairRunner(fset, EngineConfig(precision="f32"),
                           "cuda").run(intens, labels)
    assert all(f.launches > b for f, b in zip(counters, before))
    labs64, ref = PairRunner(fset, EngineConfig(precision="f64"),
                             "cpu").run(intens, labels)
    np.testing.assert_array_equal(labs, labs64)
    hdr, _ = columns.build_header(fset, EngineConfig())
    bad, _ = chip_smoke.compare_tiers(hdr[4:], dev, ref)
    assert not bad, bad
