"""K8's distance form against the JAX package's erosion loop, in f64 on the
CPU.  ``erosion_counts_dist_plain`` (the plain version of K8's "dist" path:
EROSIONS_2_VANISH as a city-block distance transform, no chain of steps)
must equal JAX's ``erosions_to_vanish`` (a while_loop of 3x3-cross
erosions) exactly, on masks made from a seed with numpy: random masks with
0, 2, 10 and 40% holes and AABBs smaller than the bucket; the full AABB
(the cap); zeros only on the frame, only on row 0 or column 0 (no source:
the cap), only on the frame's corners (no source either); 4 x 4 and 5 x 5
AABBs; heights or widths below 4 (no interior: 0); the whole-slide ROI's
shape in small (ones with a zero last row and column).  JAX compiles its
loop once a bucket shape, so the cases share three shapes.  The distance
form is also held against the port's own loop (``erosion_counts_plain``)
on the 256² disk beside disks of 9 and 4 steps.

    python -m pytest tests/test_torch_erosion_dist_jax.py -q
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nyxus_tpu.ops import binary as jbinary

import chip_smoke
from nyxus_tpu_torch.ops import binary as tbinary
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

CAP = tbinary.EROSION_CAP
S = 12  # the side of the hand-made crops' bucket


def _jax_counts(m, h, w):
    return np.asarray(jbinary.erosions_to_vanish(
        jnp.asarray(m), jnp.asarray(h), jnp.asarray(w), jnp.float64))


def _both(m, h, w):
    """(JAX's counts, the distance form's) of masks m [B, H, W] with AABB
    heights h and widths w."""
    m = np.ascontiguousarray(m)
    h = np.asarray(h, np.int32)
    w = np.asarray(w, np.int32)
    want = _jax_counts(m, h, w)
    got = tbinary.erosion_counts_dist_plain(
        torch.from_numpy(m), torch.from_numpy(h), torch.from_numpy(w))
    assert got.dtype == torch.int32
    return want, got.numpy()


@pytest.mark.parametrize("holes", [0.0, 0.02, 0.1, 0.4])
def test_random_masks(holes):
    """Eight 24 x 24 crops a hole rate: an ellipse filling the AABB with
    random holes, the AABBs of random sizes (1 to 24 a side, the first the
    whole bucket), the pixels beyond the AABB random too (never read)."""
    r = np.random.default_rng(int(holes * 100) + 1)
    B, H, W = 8, 24, 24
    h = r.integers(1, H + 1, B)
    w = r.integers(1, W + 1, B)
    h[0], w[0] = H, W
    yy, xx = np.mgrid[0:H, 0:W]
    m = r.random((B, H, W)) < 0.5
    for b in range(B):
        e = (((yy - (h[b] - 1) / 2) / (h[b] / 2)) ** 2
             + ((xx - (w[b] - 1) / 2) / (w[b] / 2)) ** 2 <= 1.0)
        inside = (yy < h[b]) & (xx < w[b])
        m[b] = np.where(inside, e & (r.random((H, W)) >= holes), m[b])
    want, got = _both(m, h, w)
    np.testing.assert_array_equal(got, want)
    if holes == 0.0:
        assert want[0] > 1


def _frame(h, w):
    """[S, S] bool: the frame pixels 4-adjacent to the interior of an h x w
    AABB (rows 1 and h-1 at columns 2..w-2, columns 1 and w-1 at rows
    2..h-2)."""
    f = np.zeros((S, S), bool)
    f[[1, h - 1], 2:w - 1] = True
    f[2:h - 1, [1, w - 1]] = True
    return f


def _special(name):
    """(mask [1, S, S], height, width, the count) of a hand-made crop."""
    m = np.zeros((1, S, S), bool)
    h = w = 10
    m[0, :h, :w] = True
    if name == "full":
        want = CAP
    elif name == "zeros on the frame":
        m[0] &= ~_frame(h, w)
        want = 3   # the interior's centre is 4 steps from the frame
    elif name == "zeros on row 0":
        m[0, 0, :w] = False
        want = CAP
    elif name == "zeros on column 0":
        m[0, :h, 0] = False
        want = CAP
    elif name == "zeros on the frame's corners":
        for y, x in ((1, 1), (1, w - 1), (h - 1, 1), (h - 1, w - 1)):
            m[0, y, x] = False
        want = CAP
    elif name == "4 x 4, one zero":
        h = w = 4
        m[0] = False
        m[0, :4, :4] = True
        m[0, 1, 2] = False  # the one interior pixel's neighbour above
        want = 0
    elif name == "5 x 5, one zero":
        h = w = 5
        m[0] = False
        m[0, :5, :5] = True
        m[0, 2, 2] = False
        want = 1
    elif name == "5 x 5 full":
        h = w = 5
        m[0] = False
        m[0, :5, :5] = True
        want = CAP
    elif name == "height 3":
        h = 3
        want = 0
    elif name == "width 2":
        w = 2
        want = 0
    else:  # the whole-slide ROI in small: ones, the box one larger
        m[0] = False
        m[0, :10, :10] = True
        h = w = 11
        want = 7   # the far corner (2, 2) is 8 steps from row and column 10
    return m, h, w, want


SPECIAL = ("full", "zeros on the frame", "zeros on row 0",
           "zeros on column 0", "zeros on the frame's corners",
           "4 x 4, one zero", "5 x 5, one zero", "5 x 5 full", "height 3",
           "width 2", "whole-slide box")


@pytest.mark.parametrize("name", SPECIAL)
def test_hand_made_crops(name):
    """Each hand-made crop in one 12 x 12 bucket: the distance form equal
    to JAX's loop, both equal to the count the shape gives."""
    m, h, w, count = _special(name)
    want, got = _both(m, [h], [w])
    np.testing.assert_array_equal(got, want)
    assert want.tolist() == [count]


def test_whole_slide_box():
    """The whole-slide ROI's shape at 64 x 64: ones on 63² in a 64² AABB
    (the zeros only its last row and column) in a 72 x 80 bucket: T = 61,
    60 steps."""
    m = np.zeros((1, 72, 80), bool)
    m[0, :63, :63] = True
    want, got = _both(m, [64], [64])
    np.testing.assert_array_equal(got, want)
    assert want.tolist() == [60]


def test_disk256_against_the_loop():
    """The 256² disk beside disks of 9 and 4 steps (chip_smoke's shape
    crop): the distance form equal to the port's own erosion loop."""
    (_, m, h, w), = [c for c in chip_smoke.special_shape_cases("cpu")
                     if c[0] == "disk256"]
    want = tbinary.erosion_counts_plain(m, h, w)
    got = tbinary.erosion_counts_dist_plain(m, h, w)
    assert torch.equal(got, want)
    assert got.tolist() == [131, 9, 4]
