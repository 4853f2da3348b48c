"""Extrema points (PyTorch port of nyxus_tpu/ops/radial.py:15 extrema): masked
row and column min/max as torch ops.

Reference: src/nyx/features/extrema.cpp.  ROI radius and the radial
distribution are host families (pipeline/hostfeats.py).
"""

from __future__ import annotations

import torch

from .common import counted


@counted
def extrema(ctx, cfg):
    """8 extremal boundary points P1..P8 in global coordinates
    (extrema.cpp): P1/P2 on the top row (left/right), P3/P4 on the right
    column (top/bottom), P5/P6 on the bottom row (right/left), P7/P8 on the
    left column (bottom/top)."""
    dt = ctx.intens.dtype
    m = ctx.mask
    B, H, W = m.shape
    dev = m.device
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.int32, device=dev)[None, :, None]

    y_top = torch.zeros_like(ctx.heights)  # the crop starts at the AABB
    y_bot = ctx.heights - 1
    x_left = torch.zeros_like(ctx.widths)
    x_right = ctx.widths - 1

    def at_row(row, reduce, fill):
        sel = m & (ys == row[:, None, None])
        return reduce(torch.where(sel, xs, fill).reshape(B, -1), dim=1)

    def at_col(colv, reduce, fill):
        sel = m & (xs == colv[:, None, None])
        return reduce(torch.where(sel, ys, fill).reshape(B, -1), dim=1)

    gx = lambda v: (v + ctx.x0).to(dt)
    gy = lambda v: (v + ctx.y0).to(dt)

    return {
        "EXTREMA_P1_Y": gy(y_top),
        "EXTREMA_P1_X": gx(at_row(y_top, torch.amin, W + 1)),
        "EXTREMA_P2_Y": gy(y_top),
        "EXTREMA_P2_X": gx(at_row(y_top, torch.amax, -1)),
        "EXTREMA_P3_Y": gy(at_col(x_right, torch.amin, H + 1)),
        "EXTREMA_P3_X": gx(x_right),
        "EXTREMA_P4_Y": gy(at_col(x_right, torch.amax, -1)),
        "EXTREMA_P4_X": gx(x_right),
        "EXTREMA_P5_Y": gy(y_bot),
        "EXTREMA_P5_X": gx(at_row(y_bot, torch.amax, -1)),
        "EXTREMA_P6_Y": gy(y_bot),
        "EXTREMA_P6_X": gx(at_row(y_bot, torch.amin, W + 1)),
        "EXTREMA_P7_Y": gy(at_col(x_left, torch.amax, -1)),
        "EXTREMA_P7_X": gx(x_left),
        "EXTREMA_P8_Y": gy(at_col(x_left, torch.amin, H + 1)),
        "EXTREMA_P8_X": gx(x_left),
    }
