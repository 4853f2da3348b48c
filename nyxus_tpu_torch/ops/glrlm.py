"""GLRLM (grey-level run-length matrix) features (PyTorch port of
nyxus_tpu/ops/glrlm.py).

Reproduces the reference's GLRLMFeature (reference:
src/nyx/features/glrlm.cpp:40-760): maximal same-level runs along the four
rotation angles {0, 45, 90, 135}, counted into a (level, run-length) matrix
per angle, then 16 scalar statistics per angle + _AVE means.

Faithful behavior notes:
* MATLAB binning (default) maps original intensity 0 -> level 1
  (texture_feature.h:96-117), so AABB background pixels participate in runs;
  run percentage RP = sum_p / Np with Np counting only original-nonzero
  pixels can therefore exceed 1 (glrlm.cpp:298-304, 540-552).
* blank ROI (raw min == max) -> every member soft-NAN (glrlm.cpp:49-72)
* empty matrix at an angle -> that angle's features are 0.0 (not NAN)

The run matrices are K3 (``run_matrices``, csrc/glrlm_runs.cu): a block a
(ROI, angle) stages the crop once in shared memory and a warp takes a scan
line, a lane a pixel, with no sheared copy of the crop
(``glrlm_runs_plan``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .common import SMEM_MAX, _kernel_device, fast_log2, pair_hist_plain

EPS = 2.2e-16  # reference: glrlm.h:169 / glszm.h:138 / gldm.h:105

MEMBERS = [
    "GLRLM_SRE", "GLRLM_LRE", "GLRLM_GLN", "GLRLM_GLNN", "GLRLM_RLN",
    "GLRLM_RLNN", "GLRLM_RP", "GLRLM_GLV", "GLRLM_RV", "GLRLM_RE",
    "GLRLM_LGLRE", "GLRLM_HGLRE", "GLRLM_SRLGLE", "GLRLM_SRHGLE",
    "GLRLM_LRLGLE", "GLRLM_LRHGLE",
]

# scan direction (dx, dy) of each angle, in output order
ANGLE_STEPS = ((1, 0), (1, 1), (0, 1), (-1, 1))


@functools.lru_cache(maxsize=32)
def scan_lines(H: int, W: int, angle_index: int) -> np.ndarray:
    """Flat pixel indices of every scan line of one angle, in walking order:
    [n_lines, max_len] int64, -1 past a line's end.  The line sets are those
    the kernel walks (and that the JAX package's _shear produces): rows,
    lines of constant x - y, columns, lines of constant x + y."""
    sx, sy = ANGLE_STEPS[angle_index]
    if angle_index == 0:
        starts = [(0, y) for y in range(H)]
    elif angle_index == 2:
        starts = [(x, 0) for x in range(W)]
    elif angle_index == 1:
        starts = [(max(d, 0), max(-d, 0)) for d in range(-(H - 1), W)]
    else:
        starts = [(s - max(0, s - (W - 1)), max(0, s - (W - 1)))
                  for s in range(H + W - 1)]
    lines = []
    for x, y in starts:
        line = []
        while 0 <= x < W and 0 <= y < H:
            line.append(y * W + x)
            x += sx
            y += sy
        lines.append(line)
    n = max(len(line) for line in lines)
    out = np.full((len(lines), n), -1, np.int64)
    for i, line in enumerate(lines):
        out[i, :len(line)] = line
    return out


def _runs_along_lines(lev, valid, ng: int, nr: int, dtype):
    """Run-length histogram for runs along the last axis of [B, L, n]
    line-gathered levels / participation (the JAX package's
    _runs_matrix_along_x)."""
    B, L, n = lev.shape
    same_next = valid[:, :, :-1] & valid[:, :, 1:] \
        & (lev[:, :, :-1] == lev[:, :, 1:])
    zeros = torch.zeros((B, L, 1), dtype=torch.bool, device=lev.device)
    same_next = torch.cat([same_next, zeros], dim=2)
    xs = torch.arange(n, dtype=torch.int64, device=lev.device)
    stop = torch.cummin(torch.where(~same_next, xs, n).flip(2),
                        dim=2).values.flip(2)
    same_prev = torch.cat([zeros, same_next[:, :, :-1]], dim=2)
    is_start = valid & ~same_prev
    runlen = stop - xs + 1                        # valid only at starts
    lev_idx = (lev - 1).reshape(B, -1)
    len_idx = torch.clamp(runlen - 1, 0, nr - 1).reshape(B, -1)
    return pair_hist_plain(lev_idx, len_idx, is_start.reshape(B, -1).to(dtype),
                           ng, nr)


def run_matrices_plain(lev, valid, ng: int, nr: int, dtype):
    """Plain version of K3: each angle's scan lines gathered into a padded
    [B, n_lines, max_len] plane (padding does not participate, so runs end
    there), then the run detection of the JAX package."""
    B, H, W = lev.shape
    lev_f = lev.to(torch.int32).reshape(B, -1)
    val_f = valid.to(torch.bool).reshape(B, -1)
    mats = []
    for a in range(4):
        ix = torch.as_tensor(scan_lines(H, W, a), device=lev.device)
        inside = ix >= 0
        g = torch.clamp(ix, min=0).reshape(-1)
        lv = lev_f[:, g].reshape(B, *ix.shape)
        vv = val_f[:, g].reshape(B, *ix.shape) & inside
        mats.append(_runs_along_lines(lv, vv, ng, nr, dtype))
    return torch.stack(mats, dim=1)


_RUNS_MODES = {"smem32": 0, "smem16": 1, "device": 2}


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def glrlm_runs_layout(H: int, W: int, ng: int, nr: int, path: str,
                      code_bits: int):
    """(row stride of the staged codes, bytes of counts, shared memory
    bytes) of K3's block for a plan's path and code bits (0: the crop is
    read from device memory).  The stride keeps a warp walking a column on
    32 banks: 16-bit codes take W + 2 where 4 divides W (an odd number of
    words a row), 32-bit codes an odd number of words."""
    if code_bits == 32:
        ws = W | 1
    else:
        ws = W + 2 if W % 4 == 0 else W
    nm = ng * nr
    cnt = {"smem32": _round16(4 * nm), "smem16": _round16(4 * (-(-nm // 2))),
           "device": 0}[path]
    crop = H * ws * code_bits // 8
    return ws, cnt, cnt + crop


def glrlm_runs_plan(B: int, H: int, W: int, ng: int, nr: int, esz: int):
    """(path, code bits, count bits, ROIs a block, smem bytes) of K3's
    launch for B crops of H x W into [ng, nr] matrices of esz-byte floats.

    One block a (ROI, angle), 4 B blocks.  The crop is staged in shared
    memory as 16-bit codes while ng < 65535, else 32-bit ones; the counts
    go, in this order of preference:
    - "smem32": 32-bit counts in shared memory, beside the staged crop;
    - "smem16": 16-bit counts, two a word, where H * W <= 65535 (no count
      can pass 65535), beside the staged crop;
    - the same two with the crop read from device memory (code bits 0)
      where the crop does not fit beside them;
    - "device": 32-bit counts in a device buffer, the crop staged where it
      fits a block alone, else read from device memory.
    The counts are integers, so esz (the output's element size, which sets
    only the write-out's vector width) does not change the plan."""
    if esz not in (4, 8):
        raise ValueError("glrlm_runs_plan: element size 4 or 8, got %d" % esz)
    code = 16 if ng < 65535 else 32
    small = H * W <= 65535
    for staged in (code, 0):
        for path, bits in (("smem32", 32), ("smem16", 16)):
            if bits == 16 and not small:
                continue
            smem = glrlm_runs_layout(H, W, ng, nr, path, staged)[2]
            if smem <= SMEM_MAX:
                return path, staged, bits, 1, smem
    smem = glrlm_runs_layout(H, W, ng, nr, "device", code)[2]
    if smem <= SMEM_MAX:
        return "device", code, 32, 1, smem
    return "device", 0, 32, 1, 0


def glrlm_runs_threads(H: int, W: int) -> int:
    """Threads of K3's block, a warp a scan line (two a step where no line
    is longer than 32): 16 warps up to 64 x 64 (on the card 16 beat 8 and
    32 at 16², 32² and 64²), 32 beyond for the longer lists of lines."""
    return 512 if H * W <= 4096 else 1024


def run_matrices(lev, valid, ng: int, nr: int, dtype):
    """[B, 4, ng, nr] run-length matrices for angles 0, 45, 90, 135: K3
    glrlm_runs, replacing nyxus_tpu/ops/glrlm.py:85 run_matrices.

    lev: [B, H, W] int levels (1-based); valid: [B, H, W] bool participation.
    Entry (l, j) counts maximal runs of level l+1 with length j+1 (longer
    runs clamp into the last column).  On the card one launch of a block
    a (ROI, angle): the crop staged once as codes, a warp a scan line and
    a lane a pixel, run ends from a ballot, one atomic a run into counts in
    shared memory or, beyond it, in an int32 device buffer
    (``glrlm_runs_plan``).  Bound on the card: at the main buckets the
    launch, the staging latency and the line steps."""
    if not _kernel_device(lev, "glrlm_runs"):
        return run_matrices_plain(lev, valid, ng, nr, dtype)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("glrlm_runs: float32 or float64 expected, got %s"
                        % dtype)
    if lev.dim() != 3 or valid.shape != lev.shape \
            or valid.device != lev.device:
        raise ValueError("glrlm_runs: lev %s and valid %s must be [B, H, W] "
                         "on one device" % (tuple(lev.shape),
                                            tuple(valid.shape)))
    lev = lev.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    B, H, W = lev.shape
    out = torch.empty((B, 4, ng, nr), dtype=dtype, device=lev.device)
    if out.numel() == 0:
        return out
    if H * W == 0:
        return out.zero_()
    esz = out.element_size()
    path, code_bits, _, _, smem = glrlm_runs_plan(B, H, W, ng, nr, esz)
    ws, cnt_bytes, _ = glrlm_runs_layout(H, W, ng, nr, path, code_bits)
    gcnt = None
    if path == "device":
        gcnt = torch.empty((B, 4, ng, nr), dtype=torch.int32,
                           device=lev.device)
    vec = W % 4 == 0 and lev.data_ptr() % 16 == 0 \
        and valid.data_ptr() % 4 == 0
    vec_out = (ng * nr) % 4 == 0 and out.data_ptr() % 16 == 0
    code = _build.lib().nyx_glrlm_runs(
        lev.data_ptr(), valid.data_ptr(), out.data_ptr(),
        0 if gcnt is None else gcnt.data_ptr(), B, H, W, ng, nr,
        _RUNS_MODES[path], code_bits, ws, cnt_bytes, smem,
        glrlm_runs_threads(H, W), int(vec), int(vec_out), int(esz == 8),
        _build.stream_of(lev, "glrlm_runs"))
    _build.check("glrlm_runs", code)
    run_matrices.launches += 1
    return out


run_matrices.launches = 0


def glrlm_features(P, n_pixels, vmin, vmax, noval: float, dtype):
    """All 16 GLRLM members from run matrices.

    P: [B, 4, ng, nr] counts; n_pixels: [B] original-nonzero pixel count (Np);
    vmin/vmax: [B] raw intensity extrema for the blank-ROI intercept.
    Returns dict member -> [B, 4] plus member_AVE -> [B].
    """
    P = P.to(dtype)
    B, A, ng, nr = P.shape
    dev = P.device
    sum_p = P.sum(dim=(-1, -2))                    # [B, 4]
    empty = sum_p == 0
    s = torch.where(empty, 1, sum_p)

    ival = torch.arange(1, ng + 1, dtype=dtype, device=dev)   # level values I
    jval = torch.arange(1, nr + 1, dtype=dtype, device=dev)   # run lengths

    ri = P.sum(dim=-1)                             # [B, 4, ng] row sums
    rj = P.sum(dim=-2)                             # [B, 4, nr] col sums

    out = {}
    out["GLRLM_SRE"] = (rj / (jval * jval)).sum(dim=-1) / s
    out["GLRLM_LRE"] = (rj * (jval * jval)).sum(dim=-1) / s
    out["GLRLM_GLN"] = (ri * ri).sum(dim=-1) / s
    out["GLRLM_GLNN"] = (ri * ri).sum(dim=-1) / (s * s)
    out["GLRLM_RLN"] = (rj * rj).sum(dim=-1) / s
    out["GLRLM_RLNN"] = (rj * rj).sum(dim=-1) / (s * s)
    out["GLRLM_RP"] = sum_p / torch.clamp(n_pixels[:, None].to(dtype), min=1)

    mu_g = (ri * ival).sum(dim=-1) / s
    out["GLRLM_GLV"] = (ri * (ival - mu_g[..., None]) ** 2).sum(dim=-1) / s
    mu_r = (rj * jval).sum(dim=-1) / s
    out["GLRLM_RV"] = (rj * (jval - mu_r[..., None]) ** 2).sum(dim=-1) / s

    p = P / s[..., None, None]
    out["GLRLM_RE"] = -(p * fast_log2(p + EPS)).sum(dim=(-1, -2))

    inv_i2 = 1.0 / (ival * ival)
    i2 = ival * ival
    inv_j2 = 1.0 / (jval * jval)
    j2 = jval * jval
    out["GLRLM_LGLRE"] = (ri * inv_i2).sum(dim=-1) / s
    out["GLRLM_HGLRE"] = (ri * i2).sum(dim=-1) / s
    out["GLRLM_SRLGLE"] = torch.einsum("baij,i,j->ba", P, inv_i2, inv_j2) / s
    out["GLRLM_SRHGLE"] = torch.einsum("baij,i,j->ba", P, i2, inv_j2) / s
    out["GLRLM_LRLGLE"] = torch.einsum("baij,i,j->ba", P, inv_i2, j2) / s
    out["GLRLM_LRHGLE"] = torch.einsum("baij,i,j->ba", P, i2, j2) / s

    for m in MEMBERS:
        out[m] = torch.where(empty, 0.0, out[m])

    # blank-ROI intercept: raw min == max -> soft NAN everywhere
    blank = (vmin == vmax)[:, None]
    final = {}
    for m in MEMBERS:
        v = torch.where(blank, noval, out[m])
        final[m] = v
        final[m + "_AVE"] = v.mean(dim=-1)
    return final
