"""Shared batched primitives for feature kernels (PyTorch port of
nyxus_tpu/ops/common.py).

Everything is batched over a leading ROI axis ``B`` and works on padded,
masked tensors.  Two of the functions here are kernels written by hand for
the card (``batched_hist`` = K1, ``neigh_matrix`` = K4): each has a plain
PyTorch version beside it, which is the only path for a tensor on the CPU.
A CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from .. import _build

# shared memory a Hopper block can use (227 KB)
SMEM_MAX = 232448
# K1's launch plan (batched_hist_plan): streaming multiprocessors of the
# card; threads a block at most; entries a thread loads at once (16 bytes of
# int32); channels of weights at most; blocks (a cluster) a row's entries
# are split over at most; entries a block of a split row counts at most
# (each slice of the bins reads its entries again); slices of a row's bins
# at most while the batch leaves SMs idle; shared memory the per-warp
# copies of a block's bins may take
SMS = 132
HIST_THREADS = 1024
HIST_STEP = 4
HIST_CMAX = 4
HIST_CLUSTER = 8
HIST_SPLIT_CHUNK = 32768
HIST_SPLIT_FILL = 16
HIST_COPY_BYTES = 32768


def counted(fn):
    """``fn`` with a count of its calls (``fn.calls``), for the device
    routines that stay torch and the family calls that launch K4:
    chip_smoke.py reports them beside the kernels' launches."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        wrapper.calls += 1
        return fn(*args, **kwargs)
    wrapper.calls = 0
    return wrapper


def roi_sizes(t: torch.Tensor):
    """An int32 [B] tensor of per-ROI sizes and its element stride, for a
    kernel that reads ROI b's at b * stride: the runners hand column views
    of one metadata tensor, which need no copy."""
    if t.dtype != torch.int32:
        t = t.to(torch.int32)
    return t, t.stride(0) if t.numel() > 1 else 1


def _kernel_device(t: torch.Tensor, name: str) -> bool:
    """True when ``t`` must go through the CUDA kernel, False for the plain
    version (CPU tensors only); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (name, t.device))
    return True


def _check_float(t: torch.Tensor, name: str):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError("%s: float32 or float64 expected, got %s"
                        % (name, t.dtype))


# ---------------------------------------------------------------------------
# K1: batched (joint) histogram


def batched_hist_plain(idx, weights, nbins: int):
    """Plain version of K1: out[b, k] = sum_a weights[b, a] * (idx[b, a] == k),
    entries with idx outside [0, nbins) dropped.  weights [C, B, A] (C
    channels over the one idx) gives [C, B, nbins]."""
    if weights.dim() == 3:
        C, B, A = weights.shape
        return batched_hist_plain(idx.expand(C, B, A).reshape(C * B, A),
                                  weights.reshape(C * B, A),
                                  nbins).reshape(C, B, nbins)
    B = idx.shape[0]
    ok = (idx >= 0) & (idx < nbins)
    out = torch.zeros((B, nbins), dtype=weights.dtype, device=weights.device)
    out.scatter_add_(1, torch.where(ok, idx, 0).long(),
                     torch.where(ok, weights, 0))
    return out


def batched_hist_plan(B: int, A: int, nbins: int, C: int, esz: int):
    """(path, S, chunk, threads, copies, L, smem) of K1's launch for B rows
    of A entries into nbins bins, C channels of weights of esz bytes.

    A row's bins are cut into slices of L bins, and each slice is counted
    by S blocks (a thread-block cluster when S > 1), block r taking the
    entries [r * chunk, (r + 1) * chunk); threads the least power of two
    (64 to HIST_THREADS) that covers a chunk in one step.
    - "smem": the C x nbins bins fit a block's SMEM_MAX: one slice, L =
      nbins, ``copies`` of it a block (a power of two, at most a copy a
      warp, within HIST_COPY_BYTES and with no more bins than the chunk has
      entries); S as many as a row needs at HIST_THREADS threads loading
      HIST_STEP entries once each, at most HIST_CLUSTER.
    - "split": they do not: S as many as give each block at most
      HIST_SPLIT_CHUNK entries, at most HIST_CLUSTER; the least number of
      slices whose C x L bins fit, or more (each reads its entries again,
      from L2) while the batch leaves SMS idle, up to HIST_SPLIT_FILL;
      copies 1."""
    slices = 1
    while C * -(-nbins // slices) * esz > SMEM_MAX:
        slices += 1
    per_block = HIST_THREADS * HIST_STEP if slices == 1 else HIST_SPLIT_CHUNK
    S = max(1, min(HIST_CLUSTER, -(-A // per_block)))
    chunk = -(-A // S)
    chunk = max(HIST_STEP, -(-chunk // HIST_STEP) * HIST_STEP)
    if slices > 1:
        slices = max(slices, min(HIST_SPLIT_FILL, -(-SMS // max(B * S, 1))))
    L = -(-nbins // slices)
    threads = 64
    while threads < HIST_THREADS and threads * HIST_STEP < chunk:
        threads *= 2
    copies = 1
    row = C * L * esz
    if slices == 1:
        while (copies * 2 <= threads // 32
               and copies * 2 * row <= HIST_COPY_BYTES
               and copies * 2 * nbins <= chunk):
            copies *= 2
    return ("smem" if slices == 1 else "split", S, chunk, threads, copies, L,
            copies * row)


def batched_hist(idx, weights, nbins: int):
    """K1 batched_hist (csrc/batched_hist.cu), replacing
    nyxus_tpu/ops/common.py:19 masked_bincount.

    idx: [B, A] integer; weights: [B, A], or [C, B, A] for C <= HIST_CMAX
    channels over the one idx, float32/float64 on the same device ->
    [B, nbins] ([C, B, nbins]) of weights.dtype.  On the card one launch
    into ``torch.empty``: a row is a block, or a cluster of blocks that
    count their chunks in shared memory and merge through distributed
    shared memory; bins beyond a block's 227 KB are cut into slices, each
    counted so over the whole row (``batched_hist_plan``).  Bound on the
    card: the read of idx and the weights; at the main path's sizes the
    launch, the load latency and the shared-memory atomics."""
    if not _kernel_device(idx, "batched_hist"):
        return batched_hist_plain(idx, weights, nbins)
    _check_float(weights, "batched_hist")
    w3 = weights if weights.dim() == 3 else weights[None]
    if idx.dim() != 2 or w3.dim() != 3 or w3.shape[1:] != idx.shape \
            or not 1 <= w3.shape[0] <= HIST_CMAX \
            or weights.device != idx.device:
        raise ValueError("batched_hist: idx %s and weights %s must be [B, A] "
                         "and [B, A] or [C <= %d, B, A] on one device"
                         % (tuple(idx.shape), tuple(weights.shape),
                            HIST_CMAX))
    idx = idx.to(torch.int32).contiguous()
    w3 = w3.contiguous()
    C, B, A = w3.shape
    out = torch.empty((C, B, nbins), dtype=w3.dtype, device=idx.device)
    if B == 0 or nbins == 0 or A == 0:
        out.zero_()
    else:
        path, S, chunk, threads, copies, L, _ = batched_hist_plan(
            B, A, nbins, C, w3.element_size())
        vec = A % HIST_STEP == 0 and chunk % HIST_STEP == 0 \
            and idx.data_ptr() % 16 == 0 and w3.data_ptr() % 16 == 0
        code = _build.lib().nyx_batched_hist(
            idx.data_ptr(), w3.data_ptr(), out.data_ptr(), B, A, nbins, C,
            S, chunk, threads, copies, L, int(vec),
            int(w3.dtype == torch.float64),
            _build.stream_of(idx, "batched_hist"))
        _build.check("batched_hist", code)
        batched_hist.launches += 1
    return out if weights.dim() == 3 else out[0]


batched_hist.launches = 0


# the JAX package's name for the batched bincount
masked_bincount = batched_hist


def _composite(i_idx, j_idx, ni: int, nj: int):
    ok = (i_idx >= 0) & (i_idx < ni) & (j_idx >= 0) & (j_idx < nj)
    return torch.where(ok, i_idx * nj + j_idx, -1)


def pair_hist(i_idx, j_idx, weights, ni: int, nj: int):
    """2D histogram out[b, i, j] through K1 on the composite index i*nj + j
    (the form of nyxus_tpu/ops/common.py:79 pair_hist_scatter).  Entries
    with either index out of range contribute nothing."""
    return batched_hist(_composite(i_idx, j_idx, ni, nj), weights,
                        ni * nj).reshape(weights.shape[0], ni, nj)


def pair_hist_plain(i_idx, j_idx, weights, ni: int, nj: int):
    return batched_hist_plain(_composite(i_idx, j_idx, ni, nj), weights,
                              ni * nj).reshape(weights.shape[0], ni, nj)


# ---------------------------------------------------------------------------
# elementwise / reduction helpers


def shifted2d(arr, dx: int, dy: int, fill=0):
    """arr[b, y + dy, x + dx] with constant fill outside."""
    B, H, W = arr.shape
    out = torch.full_like(arr, fill)
    y0, y1 = max(0, -dy), min(H, H - dy)
    x0, x1 = max(0, -dx), min(W, W - dx)
    if y0 < y1 and x0 < x1:
        out[:, y0:y1, x0:x1] = arr[:, y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


NEIGHBORS8 = ((0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1))


def safe_div(a, b, default=0.0):
    """a / b with ``default`` where b == 0."""
    ok = b != 0
    return torch.where(ok, a / torch.where(ok, b, 1), default)


@counted
def sort_masked_values(intens, mask, pad=float("inf")):
    """Flatten an [B, H, W] crop to sorted [B, A] values with +inf padding
    (one torch.sort)."""
    B = intens.shape[0]
    v = torch.where(mask, intens, pad).reshape(B, -1)
    return torch.sort(v, dim=1).values


def take_per_row(values, idx):
    """values: [B, A], idx: [B] -> [B] gather of values[b, idx[b]]."""
    return values.gather(1, idx.long()[:, None])[:, 0]


def last_true_value(cond, cand, default=0.0):
    """Per batch row: cand at the LAST index where cond is True, else default.
    cond, cand: [B, K] -> [B]."""
    K = cond.shape[-1]
    has = cond.any(dim=-1)
    last = (K - 1) - torch.argmax(cond.flip(-1).to(torch.int32), dim=-1)
    return torch.where(has, take_per_row(cand, last), default)


_LOG2_A = torch.tensor(-0.6296735, dtype=torch.float32)
_LOG2_B = torch.tensor(1.466967, dtype=torch.float32)


@counted
def fast_log2(x):
    """The reference's float32 quadratic log2 (helpers.h:283-327), bit for
    bit: every texture entropy flows through it, and an exact log differs by
    ~1e-3.  Works on the float32 bit pattern through an int32 view."""
    dt = x.dtype
    ui = x.to(torch.float32).contiguous().view(torch.int32)
    exp = ((ui >> 23) & 0xFF).to(torch.float32)
    frac = ui & 0x007FFFFF
    greater = (ui & 0x00400000) != 0
    sig_g = (frac | 0x3F000000).view(torch.float32)
    sig_l = (frac | 0x3F800000).view(torch.float32)
    fexp = torch.where(greater, exp - 126.0, exp - 127.0)
    signif = torch.where(greater, sig_g, sig_l) - 1.0
    a = _LOG2_A.to(x.device)
    b = _LOG2_B.to(x.device)
    lg2 = (fexp + (a * signif) * signif) + b * signif
    return lg2.to(dt)


# ---------------------------------------------------------------------------
# K4: the matrices of the 8-neighbour families (GLDM, NGLDM, NGTDM)


def stencil8_plain(lev, part):
    """The per-pixel 8-neighbour counts the plain version of K4 reads.  lev:
    [B, H, W] int levels; part: [B, H, W] bool participation.  Returns int32
    (same, nsum, ncnt), each [B, H, W]: same = participating neighbours with
    the centre's level; nsum / ncnt = sum / count of participating
    neighbours with level > 0."""
    lev = lev.to(torch.int32)
    same = torch.zeros_like(lev)
    nsum = torch.zeros_like(lev)
    ncnt = torch.zeros_like(lev)
    for dx, dy in NEIGHBORS8:
        p = shifted2d(part, dx, dy)
        m = shifted2d(lev, dx, dy)
        same += (p & (m == lev)).to(torch.int32)
        nz = p & (m > 0)
        nsum += torch.where(nz, m, 0)
        ncnt += nz.to(torch.int32)
    return same, nsum, ncnt


# the families K4 forms a matrix of (csrc/neigh_matrix.cu NM_GLDM, NM_NGLDM,
# NM_NGTDM); dependence columns of GLDM and NGLDM (0..8 neighbours)
NM_MODES = ("gldm", "ngldm", "ngtdm")
NM_ND = 9
# K4's launch plan (neigh_matrix_plan): threads a block at most; blocks (a
# cluster) a ROI at most; crop pixels a block takes before the rows are
# split over a cluster (at 47 x 64² a cluster of 2 ran faster than one
# block, at 300 x 32² slower: PERF.md)
NM_THREADS_MAX = 1024
NM_CLUSTER_MAX = 16
NM_BLOCK_PIXELS = 2048
NM_PATHS = ("smem", "cluster", "device")
# participation kinds by dtype (csrc/neigh_matrix.cu NM_PART_*)
_NM_PART = {torch.bool: 0, torch.uint8: 0, torch.float32: 1,
            torch.float64: 2}


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def neigh_matrix_plain(mode: str, lev, part, nbins: int, dtype):
    """Plain version of K4: each family's former call sequence, bit for bit
    (stencil8_plain, then K1's plain version).  lev: [B, H, W] int levels;
    part: [B, H, W] participation (bool, or a crop read as part > 0).
    "gldm": P [B, nbins, 9], P[b, lev - 1, same] += 1 for participating
    pixels; "ngldm": P[b, lev, matches] += 1 likewise (levels 0-based);
    "ngtdm": (N, S, present), each [B, nbins], over the levels zeroed
    outside ``part``: per-level zone counts, sums of |level - neighbourhood
    mean| and the non-zero levels that occur.  Entries outside the matrix
    add nothing."""
    B = lev.shape[0]
    lev = lev.to(torch.int32)
    if part.dtype != torch.bool:
        part = part > 0
    w = part.reshape(B, -1).to(dtype)
    if mode == "gldm":
        same, _, _ = stencil8_plain(lev, part)
        return pair_hist_plain((lev - 1).reshape(B, -1), same.reshape(B, -1),
                               w, nbins, NM_ND)
    if mode == "ngldm":
        matches, _, _ = stencil8_plain(lev, part)
        return pair_hist_plain(torch.where(part, lev, 0).reshape(B, -1),
                               matches.reshape(B, -1), w, nbins, NM_ND)
    if mode != "ngtdm":
        raise ValueError("neigh_matrix: mode %r not in %s" % (mode, NM_MODES))
    lev = torch.where(part, lev, 0)
    _, nsum, ncnt = stencil8_plain(lev, part)
    is_zone = (lev > 0) & (ncnt > 0)
    ave = torch.where(is_zone,
                      nsum.to(dtype) / torch.clamp(ncnt, min=1).to(dtype), 0)
    wzone = is_zone.reshape(B, -1).to(dtype)
    diff = torch.abs(lev.to(dtype) - ave).reshape(B, -1)
    # N, S and the valid count per level: three channels over one index
    N, S, cnt = batched_hist_plain(lev.reshape(B, -1),
                                   torch.stack((wzone, wzone * diff, w)),
                                   nbins)
    present = cnt > 0
    present[:, 0] = False
    return N, S, present


def neigh_matrix_blocks(mode: str, H: int, W: int, nbins: int, esz: int,
                        C: int):
    """(path, C, threads, smem) of K4 with a crop's rows split over C
    blocks, or None where a block's shared memory cannot hold them.  C =
    1: "smem", one block a ROI; C > 1: "cluster", C blocks of R = ceil(H /
    C) rows each (C lowered to ceil(H / R), so that no block is empty); C
    = 0: "device", the crop read from device memory and the counts in a
    device scratch.  A block has a thread a pixel of its rows, whole warps,
    at most NM_THREADS_MAX; its shared memory holds the counts (32-bit;
    NGTDM's cnt and N and S of esz bytes a level), 16 bytes aligned each, NGTDM's 32 terms a warp and, staged, the (R + 2) x
    (W + 2) 16-bit codes of its rows with their halo."""
    terms = 0
    if C == 0:
        threads = min(NM_THREADS_MAX, 32 * max(1, -(-H * W // 32)))
        if mode == "ngtdm":
            terms = _align16(threads * esz)
        return "device", 0, threads, terms
    R = -(-H // C) if H else 0
    C = -(-H // R) if R else 1
    threads = min(NM_THREADS_MAX, 32 * max(1, -(-R * W // 32)))
    if mode == "ngtdm":
        terms = _align16(threads * esz)
        counts = _align16(8 * nbins) + _align16(esz * nbins)
    else:
        counts = _align16(4 * NM_ND * nbins)
    smem = counts + terms + 2 * (R + 2) * (W + 2)
    if smem > SMEM_MAX:
        return None
    return ("smem" if C == 1 else "cluster"), C, threads, smem


def neigh_matrix_plan(mode: str, B: int, H: int, W: int, nbins: int,
                      esz: int):
    """(path, C, threads, smem) of K4's launch for family ``mode`` over B
    crops of H x W into ``nbins`` levels, the compute type of esz bytes
    (neigh_matrix_blocks): the fewest blocks a ROI, from one a
    NM_BLOCK_PIXELS pixels (at most NM_CLUSTER_MAX, at most a row each),
    whose shared memory holds the counts and the staged rows; else the
    device path.  A matrix of 65535 levels or more never fits, so the
    staged codes fit 16 bits.  B does not change the plan."""
    C0 = max(1, min(NM_CLUSTER_MAX, H, -(-H * W // NM_BLOCK_PIXELS)))
    for C in range(C0, NM_CLUSTER_MAX + 1):
        plan = neigh_matrix_blocks(mode, H, W, nbins, esz, C)
        if plan is not None:
            return plan
    return neigh_matrix_blocks(mode, H, W, nbins, esz, 0)


def neigh_matrix(mode: str, lev, part, nbins: int, dtype):
    """K4 neigh_matrix (csrc/neigh_matrix.cu): the whole matrix of one
    8-neighbour family in one launch, replacing the neighbour loops and
    histograms of nyxus_tpu/ops/gldm.py:27 gldm_matrix,
    nyxus_tpu/ops/ngldm.py:41-46 and nyxus_tpu/ops/ngtdm.py:37-46.
    Arguments and results as neigh_matrix_plain; ``part`` bool or uint8
    (non-zero takes part), or a float crop (> 0 takes part: GLDM passes
    the original intensities).  On the card one launch a call, no K1 and no
    fill: a block a ROI stages the crop in shared memory as 16-bit codes
    (the level and the participation in one value) and counts the family's
    cells in shared memory, one atomic a warp's group of equal cells, each
    cell written once (``neigh_matrix_plan``: past 2048 pixels a cluster
    of up to 16 blocks a ROI, each counting its rows and summing its share
    of the cells over the cluster through distributed shared memory; past
    a block's shared memory the crop is read from device memory and the
    counts sit in a device scratch).  GLDM's and NGLDM's P and NGTDM's N and present equal the
    plain version's; NGTDM's S sums the same terms in another order, within
    2 n u sum(w) of a cell of n terms (u the compute type's unit
    roundoff).  Bound on the card: bytes (levels and participation read
    once, the matrix written once)."""
    if not _kernel_device(lev, "neigh_matrix"):
        return neigh_matrix_plain(mode, lev, part, nbins, dtype)
    if mode not in NM_MODES:
        raise ValueError("neigh_matrix: mode %r not in %s" % (mode, NM_MODES))
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("neigh_matrix: float32 or float64 expected, got %s"
                        % (dtype,))
    if lev.dim() != 3 or part.shape != lev.shape or part.device != lev.device \
            or part.dtype not in _NM_PART:
        raise ValueError("neigh_matrix: lev %s and part %s (%s) must be "
                         "[B, H, W] on one device, part bool, uint8 or float"
                         % (tuple(lev.shape), tuple(part.shape), part.dtype))
    lev = lev.to(torch.int32).contiguous()
    part = part.contiguous()
    B, H, W = lev.shape
    dev = lev.device
    esz = 8 if dtype == torch.float64 else 4
    ngtdm = mode == "ngtdm"
    if ngtdm:
        out = torch.empty((2, B, nbins), dtype=dtype, device=dev)
        present = torch.empty((B, nbins), dtype=torch.bool, device=dev)
        result = (out[0], out[1], present)
    else:
        out = torch.empty((B, nbins, NM_ND), dtype=dtype, device=dev)
        present = None
        result = out
    if B == 0 or nbins == 0:
        return result
    path, C, threads, smem = neigh_matrix_plan(mode, B, H, W, nbins, esz)
    dcount = dsum = None
    if path == "device":
        # NGTDM: a (cnt, N) pair a level
        dcount = torch.empty((B, (2 if ngtdm else NM_ND) * nbins),
                             dtype=torch.int32, device=dev)
        if ngtdm:
            dsum = torch.empty((B, nbins), dtype=dtype, device=dev)
    vec = W % 4 == 0 and lev.data_ptr() % 16 == 0 \
        and part.data_ptr() % 16 == 0
    code = _build.lib().nyx_neigh_matrix(
        lev.data_ptr(), part.data_ptr(), _NM_PART[part.dtype],
        out.data_ptr(), 0 if present is None else present.data_ptr(),
        0 if dcount is None else dcount.data_ptr(),
        0 if dsum is None else dsum.data_ptr(), B, H, W, nbins,
        NM_MODES.index(mode), NM_PATHS.index(path), C, threads, smem,
        int(vec), int(esz == 8),
        _build.stream_of(lev, "neigh_matrix"))
    _build.check("neigh_matrix", code)
    neigh_matrix.launches += 1
    return result


neigh_matrix.launches = 0
