"""Whole-image readers and writers (nyxus_tpu/io/readers.py read_gray,
write_gray, and the NIfTI volumes of read_nifti, write_nifti and
read_volume).

TIFF goes through the port's libtiff-free reader and writer
(``io/tiff.py``) and never through PIL.  Other formats, such as PNG masks,
go through PIL, imported when such a file is met, as the JAX package's
fallback does.  OME-Zarr v2/v3 (a ``.zarr`` path or any directory) goes
through ``io/zarr.py`` and DICOM (``.dcm``, ``.dicom``) through
``io/dicom.py``, verbatim copies of the JAX package's readers.  NIfTI-1/2
(``.nii``, ``.nii.gz``) is read and written by numpy alone:
``_NIFTI_DTYPES`` to ``write_nifti`` are verbatim copies of the JAX
package's (pinned by tests/test_torch_tables.py).
"""

from __future__ import annotations

import os

import numpy as np

_TIFF = (".tif", ".tiff")
# io/dicom.DicomTiledReader's refusal of a DICOM file that is not tiled
# multi-frame: such a file is decoded whole by read_dicom
UNTILED_DICOM = "not a tiled multi-frame DICOM"


def read_gray(path: str) -> np.ndarray:
    """A grayscale image as a 2D numpy array, as nyxus_tpu's read_gray
    returns it: from a TIFF, unsigned samples of up to 16 bits as uint16,
    wider ones as uint32, signed ones as int32 and float ones as float32,
    the first channel of a multi-sample file; from an OME-Zarr container,
    the first plane (t, c, z = 0) in the array's type; from a DICOM file,
    its pixels after MONOCHROME1 inversion and the rescale to Hounsfield
    units (int32 where slope and intercept are integral).  A tiled
    multi-frame DICOM (TILED_FULL) gives its whole pixel matrix, frame by
    frame; the JAX package's read_gray returns its first frame alone."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".zarr" or os.path.isdir(path):
        from .zarr import OmeZarrReader
        return OmeZarrReader(path).read_slice()
    if ext in (".dcm", ".dicom"):
        from .dicom import DicomTiledReader, read_dicom_gray
        try:
            with DicomTiledReader(path) as r:
                return r.read_region(0, 0, r.height, r.width)
        except ValueError as e:
            if str(e) != UNTILED_DICOM:
                raise
        return read_dicom_gray(path)
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


# ---------------------------------------------------------------------------
# NIfTI-1/2 volumes (reference: src/nyx/raw_nifti.h:188-330 NiftiLoader over
# the vendored nifti2_io; voxel order on disk is x-fastest, so the in-memory
# layout is [t][z][y][x])

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}


def _nifti_blob(path: str) -> bytes:
    import gzip
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            return gzip.decompress(f.read())
        return f.read()


def read_nifti(path: str, with_meta: bool = False):
    """Read a .nii/.nii.gz volume as [T, Z, Y, X] (T dropped when nt<=1 and
    with_meta is False).  Pure-numpy NIfTI-1/NIfTI-2 parser; byte order is
    detected from sizeof_hdr.  The raw stored values are returned (the
    reference applies scl_slope/inter only in preserve_hu mode,
    raw_nifti.h:243-245); meta carries the header rescale for that mode.

    Uncompressed single-file .nii volumes come back as a read-only
    np.memmap: z-slab consumers (the slice-streamed 3D oversized path)
    page only the slices they touch, so over-RAM volumes never fully
    materialize (the reference's streamed NIfTI reads, raw_nifti.h:189)."""
    is_mmap = False
    if not path.lower().endswith(".gz"):
        with open(path, "rb") as f:
            head = f.read(2)
        if head != b"\x1f\x8b":
            with open(path, "rb") as f:
                blob = f.read(600)      # NIfTI-1/2 headers fit in 544 B
            is_mmap = True
    if not is_mmap:
        blob = _nifti_blob(path)
    hdr_size = int(np.frombuffer(blob, "<i4", 1, 0)[0])
    bo = "<"
    if hdr_size not in (348, 540):
        hdr_size = int(np.frombuffer(blob, ">i4", 1, 0)[0])
        bo = ">"
        if hdr_size not in (348, 540):
            raise IOError("not a NIfTI file: %s" % path)
    if hdr_size == 348:                      # NIfTI-1
        dim = np.frombuffer(blob, bo + "i2", 8, 40).astype(np.int64)
        datatype = int(np.frombuffer(blob, bo + "i2", 1, 70)[0])
        vox_offset = int(np.frombuffer(blob, bo + "f4", 1, 108)[0])
        scl_slope = float(np.frombuffer(blob, bo + "f4", 1, 112)[0])
        scl_inter = float(np.frombuffer(blob, bo + "f4", 1, 116)[0])
    else:                                    # NIfTI-2
        datatype = int(np.frombuffer(blob, bo + "i2", 1, 12)[0])
        dim = np.frombuffer(blob, bo + "i8", 8, 16).astype(np.int64)
        vox_offset = int(np.frombuffer(blob, bo + "i8", 1, 168)[0])
        scl_slope = float(np.frombuffer(blob, bo + "f8", 1, 176)[0])
        scl_inter = float(np.frombuffer(blob, bo + "f8", 1, 184)[0])
    if datatype not in _NIFTI_DTYPES:
        raise IOError("unrecognized NIFTI data type %d in %s" % (datatype, path))
    ndim = int(dim[0])
    nx = max(int(dim[1]), 1)
    ny = max(int(dim[2]), 1) if ndim >= 2 else 1
    nz = max(int(dim[3]), 1) if ndim >= 3 else 1
    nt = max(int(dim[4]), 1) if ndim >= 4 else 1
    dt = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(bo)
    nvox = nx * ny * nz * nt
    if is_mmap:
        vol = np.memmap(path, dtype=dt, mode="r", offset=vox_offset,
                        shape=(nt, nz, ny, nx))
    else:
        data = np.frombuffer(blob, dt, nvox, vox_offset)
        vol = data.reshape(nt, nz, ny, nx)
    if with_meta:
        meta = {"scl_slope": scl_slope if scl_slope != 0.0 else 1.0,
                "scl_inter": scl_inter if scl_slope != 0.0 else 0.0,
                "nt": nt}
        return vol, meta
    return vol if nt > 1 else vol[0]


def write_nifti(path: str, vol: np.ndarray):
    """Write a [Z, Y, X] or [T, Z, Y, X] volume as NIfTI-1 (test/roundtrip
    support)."""
    import gzip
    if vol.ndim == 3:
        vol = vol[None]
    nt, nz, ny, nx = vol.shape
    code = None
    for c, d in _NIFTI_DTYPES.items():
        if np.dtype(d) == vol.dtype:
            code = c
            break
    if code is None:
        vol = vol.astype(np.float64)
        code = 64
    hdr = bytearray(352)
    hdr[0:4] = np.int32(348).tobytes()
    dim = np.zeros(8, np.int16)
    dim[0] = 4 if nt > 1 else 3
    dim[1:5] = (nx, ny, nz, nt)
    dim[5:] = 1
    hdr[40:56] = dim.tobytes()
    hdr[70:72] = np.int16(code).tobytes()
    hdr[72:74] = np.int16(vol.dtype.itemsize * 8).tobytes()
    pixdim = np.ones(8, np.float32)
    hdr[76:108] = pixdim.tobytes()
    hdr[108:112] = np.float32(352).tobytes()
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + np.ascontiguousarray(vol).tobytes()
    if path.endswith(".gz"):
        payload = gzip.compress(payload)
    with open(path, "wb") as f:
        f.write(payload)


def read_volume(path: str, with_meta: bool = False):
    """Read a volume file as [T, Z, Y, X]: NIfTI (.nii/.nii.gz) or OME-Zarr
    (.zarr directory), every time point of the latter stacked (the
    reference's ImageLoader extension dispatch, image_loader.cpp:27-176,
    for volumetric inputs)."""
    low = path.lower()
    if low.endswith(".zarr") or os.path.isdir(path):
        from .zarr import OmeZarrReader
        z = OmeZarrReader(path)
        vol = np.stack([z.read_volume(t=t) for t in range(z.nt)])
        return (vol, {"nt": z.nt, "slope": 1.0, "inter": 0.0}) \
            if with_meta else vol
    return read_nifti(path, with_meta)
