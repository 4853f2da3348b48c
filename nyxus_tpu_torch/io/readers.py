"""Whole-image readers and writers (nyxus_tpu/io/readers.py read_gray and
write_gray).

TIFF goes through the port's libtiff-free reader and writer
(``io/tiff.py``) and never through PIL.  Other formats, such as PNG masks,
go through PIL, imported when such a file is met, as the JAX package's
fallback does.  OME-Zarr and DICOM are not ported yet (ROADMAP.md queue 1
item 13), nor are the NIfTI volumes of ``read_nifti`` / ``read_volume``
(item 7).
"""

from __future__ import annotations

import os

import numpy as np

_TIFF = (".tif", ".tiff")


def read_gray(path: str) -> np.ndarray:
    """A grayscale image as a 2D numpy array, as nyxus_tpu's read_gray
    returns it from a TIFF: unsigned samples of up to 16 bits as uint16,
    wider ones as uint32, signed ones as int32 and float ones as float32;
    the first channel of a multi-sample file."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".zarr" or os.path.isdir(path) or ext in (".dcm", ".dicom"):
        raise NotImplementedError(
            "nyxus_tpu_torch does not read OME-Zarr or DICOM yet (%s): "
            "ROADMAP.md queue 1 item 13" % path)
    if ext in _TIFF:
        from .tiff import TiffReader
        with TiffReader(path) as r:
            if r.is_float:
                return r.read_all("f32")
            arr = r.read_all("u32")
            if r.is_signed:
                return arr.view(np.int32)
            if r.bits <= 16:
                return arr.astype(np.uint16)
            return arr
    try:
        from PIL import Image
    except ImportError:
        raise IOError("cannot read %s: not a TIFF, and PIL is not installed"
                      % path)
    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as im:
        arr = np.array(im)
    return arr[..., 0] if arr.ndim == 3 else arr


def write_gray(path: str, arr: np.ndarray):
    """Write a grayscale image: a TIFF uncompressed through ``io/tiff.py``
    (uint8, uint16, uint32 and float32 keep their type, anything else is
    written as float32), any other format through PIL."""
    if os.path.splitext(path)[1].lower() in _TIFF:
        from .tiff import write_tiff
        write_tiff(path, arr, compression="none")
        return
    from PIL import Image
    Image.fromarray(arr).save(path)
