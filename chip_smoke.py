#!/usr/bin/env python3
"""Smoke run of nyxus_tpu_torch on one CUDA card.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each of which raises on failure (non-zero exit, no result line):

0. refuse to run without a CUDA device; print the card, its power limit and
   the torch / CUDA versions
1. build the four CUDA kernels from nyxus_tpu_torch/csrc with nvcc (sm_90a)
2. hold each kernel against its plain PyTorch version on the card at the
   main path's bucket shapes, f32 and f64 (counts exact, weighted sums
   within rtol 1e-6 / 1e-12), and time both with CUDA events
3. run the slice (intensity + GLCM + GLRLM + GLDM + NGTDM, 284 columns)
   through PairRunner on a 320 x 320 slide in f32 on the card and in f64 on
   the CPU, compare per column at the p90 relative error with the tiers of
   tests/test_tpu_device.py, and check that every kernel was launched
4. throughput: the 8 slides make_dsb_like(1024, 1024, 300, seed=7..14), one
   untimed pass then one timed pass through PairRunner.run; the first slide
   is also held against the f64 CPU run
5. a torch.profiler trace of one warm slide: device time by kernel

The last three lines are the card's name and power limit, the kernels'
JSON line and the result JSON line.  Imports torch, numpy and
nyxus_tpu_torch only.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FEATURES = ["*ALL_INTENSITY*", "*ALL_GLCM*", "*ALL_GLRLM*", "*ALL_GLDM*",
            "*ALL_NGTDM*"]

# per-member-prefix relative tolerance of f32-on-device vs f64-on-CPU, p90
# over ROIs (copied from tests/test_tpu_device.py:27-63)
DEFAULT_TOL = 2e-3
PREFIX_TOL = {
    "IMOM": 5e-2, "SPAT_": 5e-2, "CENTRAL_": 5e-2, "NORM_": 5e-2,
    "HU_": 5e-1, "WEIGHTED_": 5e-2, "SMOM": 5e-2,
    "WT_": 5e-2,
    "GLCM_CLUPROM": 2e-2, "GLCM_CLUSHADE": 2e-1,
    "GLCM_": 5e-3, "GLRLM_": 5e-3, "GLSZM_": 5e-3, "GLDZM_": 5e-3,
    "GLDM_": 5e-3, "NGLDM_": 5e-3, "NGTDM_": 2e-2,
    "3GLCM_": 5e-3, "3GLRLM_": 5e-3, "3GLSZM_": 5e-3, "3GLDZM_": 5e-3,
    "3GLDM_": 5e-3, "3NGLDM_": 5e-3, "3NGTDM_": 2e-2,
    "GABOR": 5e-2,
    "ZERNIKE2D": 2e-2,
    "FRAC_AT_D": 2e-2, "MEAN_FRAC": 2e-2, "RADIAL_CV": 5e-2,
    "STDDEV": 5e-3, "SKEWNESS": 2e-2, "KURTOSIS": 2e-2,
    "EXCESS_KURTOSIS": 2e-2, "HYPER": 5e-2,
    "COV": 5e-3, "ENERGY": 5e-3, "VARIANCE": 5e-3,
    "EROSIONS": 1.01,
}
# discrete statistics of small counts: an f32 bin-edge flip moves one pixel
DISCRETE = ("MODE", "MEDIAN", "P01", "P10", "P25", "P75", "P90", "P99",
            "EULER", "NUM_", "MIN", "MAX", "RANGE", "MAXCHORDS",
            "ALLCHORDS")
ZERO_BY_CONSTRUCTION = ("CENTRAL_MOMENT_01", "CENTRAL_MOMENT_10",
                        "IMOM_CM_01", "IMOM_CM_10")


def tol_for(col):
    best, best_len = DEFAULT_TOL, 0
    for pref, t in PREFIX_TOL.items():
        if col.startswith(pref) and len(pref) > best_len:
            best, best_len = t, len(pref)
    return best


def compare_tiers(cols, dev, ref):
    """Columns whose p90 relative error of dev (f32 on the card) against
    ref (f64 on the CPU) exceeds its tier; also the worst p90 seen."""
    bad, worst = [], (0.0, None)
    for j, c in enumerate(cols):
        a, b = dev[:, j], ref[:, j]
        both = np.isfinite(a) & np.isfinite(b)
        if both.sum() == 0:
            continue
        if any(t in c for t in DISCRETE) or c in ZERO_BY_CONSTRUCTION:
            continue
        rel = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), 1e-4)
        p90 = float(np.quantile(rel, 0.9))
        if p90 / tol_for(c) > worst[0]:
            worst = (p90 / tol_for(c), (c, p90))
        if p90 > tol_for(c):
            bad.append((c, p90))
    return bad, worst[1]


def make_dsb_like(h=1024, w=1024, n_blobs=300, seed=7):
    """Nucleus-like elliptical ROIs, DSB2018-ish density and sizes: the
    repository benchmark's slide (bench.make_dsb_like, which imports jax),
    computed per blob in a window around it with the same arithmetic and
    random stream, so the slide is identical (pinned by
    tests/test_torch_slice.py)."""
    r = np.random.default_rng(seed)
    labels = np.zeros((h, w), np.int32)
    intens = (r.normal(120, 30, (h, w))).clip(1, 255)
    lab = 1
    for _ in range(n_blobs):
        cy, cx = r.uniform(12, h - 12), r.uniform(12, w - 12)
        ry, rx = r.uniform(4, 18), r.uniform(4, 18)
        ang = r.uniform(0, np.pi)
        ca, sa = np.cos(ang), np.sin(ang)
        # every pixel of the ellipse lies within max(ry, rx) < 18 of its centre
        y0, y1 = max(0, int(cy) - 20), min(h, int(cy) + 21)
        x0, x1 = max(0, int(cx) - 20), min(w, int(cx) + 21)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        u = (yy - cy) * ca + (xx - cx) * sa
        v = -(yy - cy) * sa + (xx - cx) * ca
        win_l = labels[y0:y1, x0:x1]
        m = ((u / ry) ** 2 + (v / rx) ** 2 <= 1.0) & (win_l == 0)
        if m.sum() < 12:
            continue
        base = r.uniform(400, 40000)
        win_i = intens[y0:y1, x0:x1]
        win_i[m] = np.clip(base + r.normal(0, base * 0.15, m.sum()), 1, 65535)
        win_l[m] = lab
        lab += 1
    return np.floor(intens).astype(np.uint16), labels


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_events(prof):
    """(name, microseconds) of every kernel and copy the card ran inside a
    torch.profiler window (not the device spans of the runner's nyx:*
    annotation ranges, which the trace lists as device events too)."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith("nyx:")]


def timed(fn, iters=20):
    """(ms a call between CUDA events, device ms a call) of fn() after a
    warm-up.  The first includes the host's launch overhead whenever the host
    enqueues more slowly than the card runs; the second sums the kernels the
    call ran, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_ms = sum(us for _, us in device_events(prof)) / 1e3 / iters
    return event_ms, dev_ms


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def synth_bucket(B, H, W, roi_hw, seed, dtype, empty=False):
    """A padded bucket of B elliptical ROIs of AABB roi_hw inside H x W
    crops: (masked original intensities, MATLAB levels at 64, the AABB
    validity mask, the ROI mask)."""
    import torch
    from nyxus_tpu_torch.ops import quant
    r = np.random.default_rng(seed)
    h, w = roi_hw
    yy, xx = np.mgrid[0:H, 0:W]
    roi = (((yy - (h - 1) / 2) / max(h / 2, 0.5)) ** 2
           + ((xx - (w - 1) / 2) / max(w / 2, 0.5)) ** 2 <= 1.0)
    roi = np.broadcast_to(roi, (B, H, W)) & (r.random((B, H, W)) < 0.97)
    if empty:
        roi = np.zeros((B, H, W), bool)
    intens = np.floor(r.normal(2000, 500, (B, H, W))).clip(1, 65535)
    orig = torch.from_numpy(np.where(roi, intens, 0)).to(dtype).cuda()
    vmax = orig.reshape(B, -1).amax(dim=1).clamp(min=1)
    lev = quant.bin_levels(orig, vmax[:, None, None], vmax[:, None, None], 64)
    aabb = torch.from_numpy(np.broadcast_to((yy < h) & (xx < w),
                                            (B, H, W)).copy()).cuda()
    return orig, lev, aabb, torch.from_numpy(roi.copy()).cuda()


CASES = ((64, 32, 32, (29, 31)), (64, 64, 64, (60, 47)), (28, 16, 16, (13, 9)),
         (5, 32, 32, (13, 21)), (3, 7, 13, (7, 13)), (1, 16, 16, (0, 0)))


def check_kernels():
    """Every kernel against its plain version; returns per-kernel results."""
    import torch
    from nyxus_tpu_torch.ops import common, glcm, glrlm
    res = {k: {"max_abs_err": 0.0} for k in ("batched_hist", "glcm_cooc",
                                             "glrlm_runs", "stencil8")}

    def agree(name, got, want, rtol=0.0):
        err = float((got.double() - want.double()).abs().max()) \
            if got.numel() else 0.0
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        if got.shape != want.shape:
            raise AssertionError("%s: shape %s != %s" % (name, got.shape,
                                                          want.shape))
        if rtol == 0.0:
            if not torch.equal(got, want):
                raise AssertionError("%s: counts differ (max abs %g)"
                                     % (name, err))
        elif not torch.allclose(got, want, rtol=rtol, atol=rtol):
            raise AssertionError("%s: beyond rtol %g (max abs %g)"
                                 % (name, rtol, err))

    for prec, dtype, rtol in (("f32", torch.float32, 1e-6),
                              ("f64", torch.float64, 1e-12)):
        for ci, (B, H, W, hw) in enumerate(CASES):
            orig, lev, aabb, roi = synth_bucket(B, H, W, hw, ci, dtype,
                                                empty=hw == (0, 0))
            flat = (lev - 1).reshape(B, -1)
            cnt = roi.reshape(B, -1).to(dtype)
            g = torch.Generator(device="cuda").manual_seed(ci)
            wts = torch.rand(cnt.shape, generator=g, device="cuda",
                             dtype=dtype) * 40 * cnt
            idx100 = torch.randint(-1, 101, cnt.shape, generator=g,
                                   device="cuda", dtype=torch.int32)
            for idx, w, nb, tol in ((flat, cnt, 64, 0.0),
                                    (idx100, cnt, 100, 0.0),
                                    (flat * 9 + (flat % 9), cnt, 576, 0.0),
                                    (flat, wts, 65, rtol)):
                agree("batched_hist", common.batched_hist(idx, w, nb),
                      common.batched_hist_plain(idx, w, nb), tol)
            for sym in (False, True):
                agree("glcm_cooc",
                      glcm.cooc_matrices(orig, lev, (0, 45, 90, 135), 1, 64,
                                         sym),
                      glcm.cooc_matrices_plain(orig, lev, (0, 45, 90, 135), 1,
                                               64, sym))
            nr = max(H, W)
            agree("glrlm_runs", glrlm.run_matrices(lev, aabb, 64, nr, dtype),
                  glrlm.run_matrices_plain(lev, aabb, 64, nr, dtype))
            for got, want in zip(common.stencil8(lev, roi),
                                 common.stencil8_plain(lev, roi)):
                agree("stencil8", got, want)
            log("  %s B=%d %dx%d roi %s: all four kernels agree"
                % (prec, B, H, W, hw))

    # times at the main path's commonest bucket (f32, 64 ROIs of 32 x 32)
    for B, H, W, hw in CASES[:3]:
        orig, lev, aabb, roi = synth_bucket(B, H, W, hw, 0, torch.float32)
        flat = (lev - 1).reshape(B, -1)
        cnt = roi.reshape(B, -1).to(torch.float32)
        nr = max(H, W)
        pairs = {
            "batched_hist": (lambda: common.batched_hist(flat, cnt, 100),
                             lambda: common.batched_hist_plain(flat, cnt, 100)),
            "glcm_cooc": (
                lambda: glcm.cooc_matrices(orig, lev, (0, 45, 90, 135), 1, 64,
                                           False),
                lambda: glcm.cooc_matrices_plain(orig, lev, (0, 45, 90, 135),
                                                 1, 64, False)),
            "glrlm_runs": (
                lambda: glrlm.run_matrices(lev, aabb, 64, nr, torch.float32),
                lambda: glrlm.run_matrices_plain(lev, aabb, 64, nr,
                                                 torch.float32)),
            "stencil8": (lambda: common.stencil8(lev, roi),
                         lambda: common.stencil8_plain(lev, roi)),
        }
        for name, (kern, plain) in pairs.items():
            # plain, kernel, kernel, plain: the pairs share clocks and cache
            p1, k1, k2, p2 = timed(plain), timed(kern), timed(kern), \
                timed(plain)
            ev, ms = (k1[0] + k2[0]) / 2, (k1[1] + k2[1]) / 2
            pev, plain_ms = (p1[0] + p2[0]) / 2, (p1[1] + p2[1]) / 2
            log("  time %-12s f32 B=%d %dx%d: device %.4f ms (events %.4f "
                "ms) vs plain device %.4f ms (events %.4f ms)"
                % (name, B, H, W, ms, ev, plain_ms, pev))
            if (B, H, W) == (64, 32, 32):
                res[name]["ms"] = ms
                res[name]["plain_ms"] = plain_ms
    return res


# ---------------------------------------------------------------------------


def main():
    import torch
    # phase 0
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch")
    sys.path.insert(0, HERE)
    try:
        import nyxus_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (%s)" % e)
    from nyxus_tpu_torch import _build, columns, taxonomy
    from nyxus_tpu_torch.config import EngineConfig
    from nyxus_tpu_torch.ops import common, glcm, glrlm
    from nyxus_tpu_torch.pipeline.runner import PairRunner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card:", card)
    log("torch %s, CUDA %s, python %s, device %s"
        % (torch.__version__, torch.version.cuda, sys.version.split()[0],
           torch.cuda.get_device_name(0)))

    # phase 1
    t0 = time.perf_counter()
    _build.lib()
    log("phase 1: kernels built in %.1f s (nvcc %.1f s) into %s"
        % (time.perf_counter() - t0, _build.build_seconds or 0.0,
           _build.LIB_PATH))
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())

    # phase 2
    log("phase 2: kernels against their plain versions")
    kres = check_kernels()

    # phase 3
    log("phase 3: slice on the card (f32) against the CPU (f64)")
    counters = {"batched_hist": common.batched_hist,
                "glcm_cooc": glcm.cooc_matrices,
                "glrlm_runs": glrlm.run_matrices,
                "stencil8": common.stencil8}
    fset = taxonomy.parse_feature_request(FEATURES)
    hdr, _ = columns.build_header(fset, EngineConfig())
    cols = hdr[4:]
    card_runner = PairRunner(fset, EngineConfig(precision="f32"), "cuda")
    cpu_runner = PairRunner(fset, EngineConfig(precision="f64"), "cpu")
    intens, labels = make_dsb_like(320, 320, 40, seed=11)
    for f in counters.values():
        f.launches = 0
    labs, dev = card_runner.run(intens, labels)
    small_launches = {k: f.launches for k, f in counters.items()}
    labs64, ref = cpu_runner.run(intens, labels)
    if len(cols) != 284 or dev.shape != (len(labs64), 284) \
            or list(labs) != list(labs64):
        raise AssertionError("slice shape/labels: %s vs %s"
                             % (dev.shape, ref.shape))
    bad, worst = compare_tiers(cols, dev, ref)
    if bad:
        raise AssertionError("f32 card vs f64 CPU beyond tolerance: %r"
                             % bad[:20])
    log("  %d ROIs x %d columns agree; closest to its tier: %s; launches %s"
        % (len(labs), len(cols), worst, small_launches))
    if not all(small_launches.values()):
        raise AssertionError("a kernel was not launched: %r" % small_launches)

    # phase 4
    log("phase 4: throughput on 8 slides make_dsb_like(1024, 1024, 300)")
    t0 = time.perf_counter()
    slides = [make_dsb_like(1024, 1024, 300, seed=s) for s in range(7, 15)]
    log("  slides generated in %.1f s" % (time.perf_counter() - t0))
    for intens, labels in slides:                     # untimed pass
        card_runner.run(intens, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    n_rois, outs = 0, []
    t0 = time.perf_counter()
    for intens, labels in slides:
        labs, vals = card_runner.run(intens, labels)
        n_rois += len(labs)
        outs.append((labs, vals))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    log("  %d ROIs in %.4f s: %.2f ROIs/s; peak device memory %d bytes "
        "(%.1f MiB); launches %s"
        % (n_rois, wall, n_rois / wall, peak, peak / 2 ** 20, launches))
    if not all(launches.values()):
        raise AssertionError("a kernel was not launched: %r" % launches)
    for labs, vals in outs:
        if vals.shape != (len(labs), 284) or not np.isfinite(vals).all():
            raise AssertionError("throughput run: bad output %s" %
                                 (vals.shape,))
    labs64, ref = cpu_runner.run(*slides[0])
    bad, worst = compare_tiers(cols, outs[0][1], ref)
    if bad or list(labs64) != list(outs[0][0]):
        raise AssertionError("slide 7 f32 card vs f64 CPU: %r" % bad[:20])
    log("  slide 7 (%d ROIs) agrees with the f64 CPU run; closest to its "
        "tier: %s" % (len(labs64), worst))

    # phase 5
    log("phase 5: profile of one warm slide")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        card_runner.run(*slides[1])
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for name, us in device_events(prof):
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, cnt + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e3
    log("  wall %.2f ms (profiled), device busy %.2f ms (%.1f%%) in %d "
        "kernel/copy launches of %d names"
        % (pwall, busy, 100 * busy / pwall,
           sum(c for _, c in by_name.values()), len(by_name)))
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
        log("    %8.3f ms %5d x  %s" % (tot / 1e3, cnt, name[:100]))
    from torch.autograd import DeviceType
    stages = {}
    for e in prof.events():
        if e.name.startswith("nyx:"):
            on_host = e.device_type != DeviceType.CUDA
            st = stages.setdefault(e.name, [0.0, 0.0])
            st[0 if on_host else 1] += e.time_range.elapsed_us() / 1e3
    log("  runner stages (nyx:* ranges): host ms, and the span on the card "
        "from their first to their last kernel")
    for name, (host_ms, span_ms) in stages.items():
        log("    %-26s host %8.2f ms   card span %8.2f ms"
            % (name, host_ms, span_ms))
    t0 = time.perf_counter()
    from nyxus_tpu_torch.pipeline import labels as plabels
    for intens, labels in slides:
        plabels._discover_rois_np(intens, labels)
    log("  host ROI discovery: %.2f ms a slide (of %.2f ms a slide end to end)"
        % ((time.perf_counter() - t0) * 1e3 / len(slides), wall * 1e3 / len(slides)))

    src = {"batched_hist": ("nyxus_tpu_torch/csrc/batched_hist.cu",
                            "nyxus_tpu/ops/common.py:19"),
           "glcm_cooc": ("nyxus_tpu_torch/csrc/glcm_cooc.cu",
                         "nyxus_tpu/ops/glcm.py:61"),
           "glrlm_runs": ("nyxus_tpu_torch/csrc/glrlm_runs.cu",
                          "nyxus_tpu/ops/glrlm.py:85"),
           "stencil8": ("nyxus_tpu_torch/csrc/stencil8.cu",
                        "nyxus_tpu/ops/gldm.py:28")}
    kernels = [{"name": k, "route": "cuda", "source": src[k][0],
                "replaces": src[k][1], "launches": launches[k],
                "max_abs_err": kres[k]["max_abs_err"], "ms": kres[k]["ms"],
                "plain_ms": kres[k]["plain_ms"]} for k in counters]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
