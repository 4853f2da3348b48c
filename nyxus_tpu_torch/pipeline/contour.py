# Copied verbatim from nyxus_tpu/pipeline/contour.py; pinned by tests/test_torch_tables.py.
"""ROI contour extraction: exact port of the reference's multicontour build
(reference: src/nyx/features/contour.cpp:306-680).

Stages, matching the reference bit-for-bit:

1. Moore boundary tracing over a 1-pixel padded AABB image with an
   inside/outside raster state machine -> marked border pixels
2. raster-order collection with the reference's has-neighbor bounds quirks
   (right/lower checks gated by w-1/h-1 on the (w+2)-wide padded image)
3. crossing removal: pixels whose 4 NSEW neighbors are all border pixels are
   dropped sequentially in raster order
4. chain ordering into loops: walk from the raster-first remaining pixel,
   preferring 4-neighbors over diagonals, ties broken by "dial position"
   (W > NW > N > NE > E > SE > S > SW), with backtracking; a walk that ends
   within unit distance of its origin is accepted as a loop

NOTE the reference's coordinate quirk: the final contour coordinates are the
original global coordinates PLUS (1, 1) (contour.cpp:674-679 adds base_x/y to
padded coordinates).  Downstream consumers (distance-to-contour weighting,
radius features) see that shift; we reproduce it.

This phase is sequential per ROI and runs host-side (the reference runs it on
CPU threads); a C++ port is the planned fast path.
"""

from __future__ import annotations

import numpy as np

# dial positions for tie-breaking (contour.cpp:344-380): (dx, dy) -> rank
_DIAL = {
    (1, 0): 1, (1, -1): 2, (0, -1): 3, (-1, -1): 4, (-1, 0): 5,
    (1, 1): -1, (0, 1): -2, (-1, 1): -3, (0, 0): 0,
}


def _moore_trace(P, w, h):
    """Mark border pixels (stage 1). P: (h+2, w+2) padded intensity+1 image.
    Returns borderImage of the same shape."""
    W2 = w + 2
    flatP = P.ravel()
    n = flatP.size
    border = np.zeros_like(flatP)
    # (offset, next check location) pairs, contour.cpp:431-441
    neigh = [(-1, 7), (-3 - w, 7), (-w - 2, 1), (-1 - w, 1),
             (1, 3), (3 + w, 3), (w + 2, 5), (1 + w, 5)]
    inside = False
    for y in range(h + 2):
        for x in range(W2):
            pos = y * W2 + x
            bi = border[pos]
            pi = flatP[pos]
            if bi != 0 and not inside:
                inside = True
            elif pi != 0 and inside:
                continue
            elif pi == 0 and inside:
                inside = False
            elif pi != 0 and not inside:
                border[pos] = pi
                check_nr = 1
                start_pos = pos
                counter = 0
                counter2 = 0
                p = pos
                while True:
                    check_pos = p + neigh[check_nr - 1][0]
                    new_check = neigh[check_nr - 1][1]
                    if check_pos >= n or check_pos < 0:
                        break
                    if flatP[check_pos] != 0:
                        if check_pos == start_pos:
                            counter += 1
                            if new_check == 1 or counter >= 3:
                                inside = True
                                break
                        check_nr = new_check
                        p = check_pos
                        counter2 = 0
                        border[check_pos] = flatP[check_pos]
                    else:
                        check_nr = 1 + (check_nr % 8)
                        if counter2 > 8:
                            counter2 = 0
                            break
                        else:
                            counter2 += 1
    return border.reshape(h + 2, W2)


def _collect_border(border, w, h):
    """Stage 2: raster-order pixels with the reference's neighbor-bounds
    quirks. Returns list of (x, y, inten)."""
    C = []
    for y in range(h + 2):
        for x in range(w + 2):
            inte = border[y, x]
            if not inte:
                continue
            has = False
            if x > 0:
                has = has or border[y, x - 1] != 0
            if x < w - 1:
                has = has or border[y, x + 1] != 0
            if y > 0:
                has = has or border[y - 1, x] != 0
            if y < h - 1:
                has = has or border[y + 1, x] != 0
            if x > 0 and y > 0:
                has = has or border[y - 1, x - 1] != 0
            if x < w - 1 and y > 0:
                has = has or border[y - 1, x + 1] != 0
            if x > 0 and y < h - 1:
                has = has or border[y + 1, x - 1] != 0
            if x < w - 1 and y < h - 1:
                has = has or border[y + 1, x + 1] != 0
            if has:
                C.append((x, y, int(inte) - 1))
    return C


def _remove_crossings(C):
    """Stage 3: drop pixels whose NSEW neighbors are all present (evolving
    set semantics, raster iteration order)."""
    live = {(x, y): (x, y, i) for x, y, i in C}
    for x, y, _ in C:
        if ((x, y - 1) in live and (x, y + 1) in live and
                (x - 1, y) in live and (x + 1, y) in live):
            live.pop((x, y), None)
    return live  # insertion-ordered dict


def _check_loop(live_keys, origin):
    """Stage 4 walk (contour.cpp:306-470). live_keys: insertion-ordered dict
    of remaining (x, y) -> pixel. Returns (loop_ok, S list of keys)."""
    U = dict(live_keys)
    S = [origin]
    P = []
    del U[origin]
    tip = origin
    looplen = 0
    while U:
        # find_cands: 4-neighbors first, else diagonals
        c10 = [(tip[0] + dx, tip[1] + dy)
               for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1))
               if (tip[0] + dx, tip[1] + dy) in U]
        if c10:
            cands = c10
        else:
            cands = [(tip[0] + dx, tip[1] + dy)
                     for dx, dy in ((1, 1), (1, -1), (-1, 1), (-1, -1))
                     if (tip[0] + dx, tip[1] + dy) in U]
        if len(cands) > 1:
            P.append(tip)
            best = cands[0]
            for c in cands[1:]:
                d1 = (c[0] - tip[0], c[1] - tip[1])
                d2 = (best[0] - tip[0], best[1] - tip[1])
                if _DIAL[d1] > _DIAL[d2]:
                    best = c
            cands = [best]
        if not cands:
            dx, dy = tip[0] - origin[0], tip[1] - origin[1]
            if abs(dx) == 1 or abs(dy) == 1:
                return True, S
            if not P:
                return False, S
            tip = P.pop()
            continue
        tip = cands[0]
        looplen += 1
        S.append(tip)
        del U[tip]
    return looplen > 0, S


def build_multicontour(crop_mask: np.ndarray, crop_intens: np.ndarray):
    """Multicontour of one ROI AABB crop.

    crop_mask: (h, w) bool; crop_intens: (h, w) intensities.
    Returns list of loops, each an array [(x, y, inten)] in AABB-local
    coordinates SHIFTED BY +1 (the reference's quirk; add bbox origin for the
    reference's absolute coordinates)."""
    h, w = crop_mask.shape
    P = np.zeros((h + 2, w + 2), np.int64)
    ys, xs = np.nonzero(crop_mask)
    P[ys + 1, xs + 1] = crop_intens[ys, xs].astype(np.int64) + 1

    border = _moore_trace(P, w, h)
    C = _collect_border(border, w, h)
    if not C:
        return []
    live = _remove_crossings(C)
    inten_of = {(x, y): i for (x, y), (_, _, i) in live.items()}

    loops = []
    remaining = dict.fromkeys(live.keys())
    while remaining:
        origin = next(iter(remaining))
        ok, S = _check_loop(remaining, origin)
        if ok:
            loops.append(np.array([(x, y, inten_of[(x, y)]) for x, y in S],
                                  np.int64))
        for k in S:
            remaining.pop(k, None)
    return loops


def merged_contour(crop_mask, crop_intens):
    """Concatenated loops (LR::merge_multicontour, roi_cache.cpp:93-100).
    Native C++ fast path (native/src/contour.cpp); this module is the
    fallback and parity oracle."""
    from .. import native
    if native.available():
        return native.contour(crop_mask,
                              np.asarray(crop_intens).astype(np.int64))
    return merged_contour_py(crop_mask, crop_intens)


def oversized_contour(rec, source, cap_bytes: int = 1 << 30,
                      block: int = 2048):
    """Contour of an oversized ROI without materializing its dense crop.

    The mask is assembled as a 1-byte/pixel array by streaming the AABB
    (16x cheaper than the dense compute crop whose budget overflow made the
    ROI oversized; reference analog: buildRegularContour_nontriv over a
    file-backed mask, contour.cpp).  The trace runs with a zero intensity
    plane (lazy zero pages; the tracer only tests mask membership), then
    contour-pixel intensities are fetched in a second streamed sweep.
    Returns the merged contour [N, 3] (local +1 coords) or None when even
    the byte mask would exceed ``cap_bytes``."""
    H, W = rec.height, rec.width
    if H * W > cap_bytes:
        return None
    mask = np.zeros((H, W), bool)
    for by in range(rec.y0, rec.y1 + 1, block):
        bh = min(block, rec.y1 + 1 - by)
        _, ll = source.read_pair(by, rec.x0, bh, W)
        mask[by - rec.y0:by - rec.y0 + bh] = ll == rec.label
    K = merged_contour(mask, np.zeros((H, W), np.int64))
    del mask
    if K.shape[0] == 0:
        return K
    K = K.copy()
    ys = K[:, 1] - 1          # AABB-local row of each contour pixel
    xs = K[:, 0] - 1
    for by in range(rec.y0, rec.y1 + 1, block):
        bh = min(block, rec.y1 + 1 - by)
        sel = (ys >= by - rec.y0) & (ys < by - rec.y0 + bh)
        if not sel.any():
            continue
        ii, _ = source.read_pair(by, rec.x0, bh, W)
        K[sel, 2] = ii[ys[sel] - (by - rec.y0), xs[sel]].astype(np.int64)
    return K


def merged_contour_py(crop_mask, crop_intens):
    loops = build_multicontour(crop_mask, crop_intens)
    if not loops:
        return np.zeros((0, 3), np.int64)
    return np.concatenate(loops, axis=0)
