# Copied verbatim from nyxus_tpu/io/dicom.py; pinned by tests/test_torch_tables.py.
"""Minimal DICOM grayscale reader/writer.

The reference reads DICOM through DCMTK behind the USE_DCMTK build gate
(reference: src/nyx/nyxus_dicom_loader.h:4-19, raw_dicom.h).  This
self-contained parser covers the grayscale-CT cases the pipeline needs:
implicit/explicit VR little endian, MONOCHROME1/2, 8/16-bit signed/unsigned
pixels, RescaleSlope/Intercept (Hounsfield), and the encapsulated transfer
syntaxes RLE lossless (native PackBits), JPEG-LS (system CharLS), and JPEG
baseline/extended + JPEG 2000 (Pillow).
"""

from __future__ import annotations

import struct

import numpy as np

IMPLICIT_LE = "1.2.840.10008.1.2"
EXPLICIT_LE = "1.2.840.10008.1.2.1"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
JPEG2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG2000 = "1.2.840.10008.1.2.4.91"
JPEGLS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEGLS_NEAR = "1.2.840.10008.1.2.4.81"
# encapsulated syntaxes this reader decodes: RLE natively, JPEG-LS through
# the system CharLS library (io/jpegls.py), JPEG/JPEG2000 through Pillow
# (reference: DCMTK-backed decode, nyxus_dicom_loader.h:4-19)
ENCAPSULATED = (RLE_LOSSLESS, JPEG_BASELINE, JPEG_EXTENDED,
                JPEG2000_LOSSLESS, JPEG2000, JPEGLS_LOSSLESS, JPEGLS_NEAR)


def _read_fragments(s: "_Stream"):
    """Encapsulated PixelData items: basic offset table + fragments
    (PS3.5 A.4), terminated by a sequence-delimiter item."""
    frags = []
    first = True
    while True:
        group, elem = s.u16(), s.u16()
        length = s.u32()
        if (group, elem) == (0xFFFE, 0xE0DD):
            break
        if (group, elem) != (0xFFFE, 0xE000):
            raise ValueError("malformed encapsulated PixelData item "
                             "(%04x,%04x)" % (group, elem))
        data = s.raw(length)
        if first:
            first = False      # basic offset table; ignored (single frame)
        else:
            frags.append(data)
    return frags


def _packbits(data: bytes, expected: int) -> np.ndarray:
    """PackBits decode of one RLE segment (PS3.5 G.3.1)."""
    out = np.empty(expected, np.uint8)
    buf = data
    i = o = 0
    n = len(buf)
    while i < n and o < expected:
        h = buf[i]
        i += 1
        if h < 128:
            cnt = min(h + 1, expected - o)
            out[o:o + cnt] = np.frombuffer(buf, np.uint8, cnt, i)
            i += h + 1
            o += cnt
        elif h > 128:
            cnt = min(257 - h, expected - o)
            out[o:o + cnt] = buf[i]
            i += 1
            o += cnt
        # h == 128: no-op
    if o < expected:
        out[o:] = 0
    return out


def _rle_decode(frag: bytes, rows: int, cols: int, nbytes: int) -> np.ndarray:
    """DICOM RLE frame: 64-byte header (segment count + offsets), one
    PackBits segment per sample byte, most significant first (PS3.5 G.2)."""
    import struct as _st
    hdr = _st.unpack("<16I", frag[:64])
    nseg = hdr[0]
    offsets = hdr[1:1 + nseg]
    npx = rows * cols
    segs = []
    for i, off in enumerate(offsets):
        end = offsets[i + 1] if i + 1 < nseg else len(frag)
        segs.append(_packbits(frag[off:end], npx))
    if nbytes == 1:
        return segs[0]
    out = np.zeros(npx, np.uint32 if nbytes > 2 else np.uint16)
    for b, seg in enumerate(segs[:nbytes]):
        out |= seg.astype(out.dtype) << (8 * (nbytes - 1 - b))
    return out


def _decode_encapsulated(ts: str, frags, meta):
    rows, cols = meta["rows"], meta["cols"]
    nbytes = (meta["bits"] + 7) // 8
    if ts == RLE_LOSSLESS:
        raw = _rle_decode(frags[0], rows, cols, nbytes)
    elif ts in (JPEGLS_LOSSLESS, JPEGLS_NEAR):
        from . import jpegls
        if not jpegls.available():
            raise ValueError("JPEG-LS DICOM needs the system CharLS "
                             "library (libcharls.so.2), which was not found")
        raw = jpegls.decode(b"".join(frags)).reshape(-1)
    else:
        import io as _io

        from PIL import Image
        img = Image.open(_io.BytesIO(b"".join(frags)))
        raw = np.asarray(img).reshape(-1)
    dt = np.dtype({(8, 0): np.uint8, (8, 1): np.int8,
                   (16, 0): np.uint16, (16, 1): np.int16,
                   (32, 0): np.uint32, (32, 1): np.int32}[(meta["bits"],
                                                           meta["signed"])])
    raw = raw.reshape(rows, cols)
    if raw.dtype.itemsize == dt.itemsize:
        return raw.view(dt)        # bit-exact reinterpretation (signed)
    return raw.astype(dt)

_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR",
             b"UT", b"UN"}


class _Stream:
    def __init__(self, data: bytes, pos: int):
        self.d = data
        self.p = pos

    def u16(self):
        v = struct.unpack_from("<H", self.d, self.p)[0]
        self.p += 2
        return v

    def u32(self):
        v = struct.unpack_from("<I", self.d, self.p)[0]
        self.p += 4
        return v

    def raw(self, n):
        v = self.d[self.p:self.p + n]
        self.p += n
        return v

    def eof(self):
        return self.p >= len(self.d)


def _read_element(s: _Stream, explicit: bool):
    group = s.u16()
    elem = s.u16()
    if explicit or group == 0x0002:       # file meta is always explicit
        vr = s.raw(2)
        if vr in _LONG_VRS:
            s.p += 2
            length = s.u32()
        else:
            length = s.u16()
    else:
        vr = b""
        length = s.u32()
    return group, elem, vr, length


def _skip_undefined(s: _Stream):
    """Skip an undefined-length sequence: scan to (FFFE,E0DD) delimiter."""
    pat = struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    i = s.d.find(pat, s.p)
    if i < 0:
        raise ValueError("unterminated DICOM sequence")
    s.p = i + len(pat)


def read_dicom(path: str):
    """(pixel_array [rows, cols], meta dict).  Pixels carry the Rescale
    transform (HU) when slope/intercept are present."""
    with open(path, "rb") as f:
        data = f.read()
    if data[128:132] != b"DICM":
        raise ValueError("not a DICOM part-10 file: %s" % path)
    s = _Stream(data, 132)

    meta = {"ts": EXPLICIT_LE, "bits": 16, "signed": 0, "rows": 0, "cols": 0,
            "slope": None, "intercept": None, "photometric": "MONOCHROME2",
            "samples": 1}
    explicit = True
    pixel_data = None
    while not s.eof():
        group, elem, vr, length = _read_element(s, explicit)
        if length == 0xFFFFFFFF:
            if (group, elem) == (0x7FE0, 0x0010):
                frags = _read_fragments(s)
                arr = _decode_encapsulated(meta["ts"], frags, meta)
                return _finish_pixels(arr, meta), meta
            _skip_undefined(s)
            continue
        val = s.raw(length)
        if (group, elem) == (0x0002, 0x0010):
            meta["ts"] = val.decode("ascii").strip("\x00 ")
            if meta["ts"] == IMPLICIT_LE:
                explicit = False
            elif meta["ts"] != EXPLICIT_LE and meta["ts"] not in ENCAPSULATED:
                raise ValueError(
                    "unsupported DICOM transfer syntax %s (supported: "
                    "implicit/explicit little endian, RLE lossless, "
                    "JPEG-LS, JPEG baseline/extended, JPEG 2000)"
                    % meta["ts"])
        elif (group, elem) == (0x0028, 0x0010):
            meta["rows"] = struct.unpack("<H", val[:2])[0]
        elif (group, elem) == (0x0028, 0x0011):
            meta["cols"] = struct.unpack("<H", val[:2])[0]
        elif (group, elem) == (0x0028, 0x0100):
            meta["bits"] = struct.unpack("<H", val[:2])[0]
        elif (group, elem) == (0x0028, 0x0103):
            meta["signed"] = struct.unpack("<H", val[:2])[0]
        elif (group, elem) == (0x0028, 0x0002):
            meta["samples"] = struct.unpack("<H", val[:2])[0]
        elif (group, elem) == (0x0028, 0x0004):
            meta["photometric"] = val.decode("ascii").strip("\x00 ")
        elif (group, elem) == (0x0028, 0x1052):
            meta["intercept"] = float(val.decode("ascii").strip("\x00 "))
        elif (group, elem) == (0x0028, 0x1053):
            meta["slope"] = float(val.decode("ascii").strip("\x00 "))
        elif (group, elem) == (0x7FE0, 0x0010):
            pixel_data = val
            break

    if pixel_data is None:
        raise ValueError("no PixelData in %s" % path)
    if meta["samples"] != 1:
        raise ValueError("only single-sample (grayscale) DICOM is supported")
    dt = {(8, 0): np.uint8, (8, 1): np.int8,
          (16, 0): np.uint16, (16, 1): np.int16,
          (32, 0): np.uint32, (32, 1): np.int32}[(meta["bits"],
                                                  meta["signed"])]
    n = meta["rows"] * meta["cols"]
    arr = np.frombuffer(pixel_data, dt, n).reshape(meta["rows"], meta["cols"])
    return _finish_pixels(arr, meta), meta


def _finish_pixels(arr: np.ndarray, meta):
    """MONOCHROME1 inversion + Rescale (HU) transform, shared by the native
    and encapsulated paths."""
    if meta["photometric"] == "MONOCHROME1":   # inverted scale
        arr = arr.max() - arr
    if meta["slope"] is not None or meta["intercept"] is not None:
        sl = 1.0 if meta["slope"] is None else meta["slope"]
        ic = 0.0 if meta["intercept"] is None else meta["intercept"]
        hu = arr.astype(np.float64) * sl + ic
        if float(sl).is_integer() and float(ic).is_integer():
            arr = hu.astype(np.int32)
        else:
            arr = hu
    return arr


def read_dicom_gray(path: str) -> np.ndarray:
    return read_dicom(path)[0]


class DicomTiledReader:
    """Tiled multi-frame DICOM (WSI ``TILED_FULL`` layout): each frame is
    one tile of the TotalPixelMatrix, laid out row-major; region reads
    decode only the frames a request touches, so over-RAM DICOM slides can
    stream (reference: nyxus_dicom_loader.h:4-19, which reads per-frame
    through DCMTK the same way).

    Supports native little-endian frames (read straight out of an mmap)
    and encapsulated transfer syntaxes with one fragment per frame (RLE,
    JPEG family).  MONOCHROME1 needs a global max and is rejected here
    (those files fall back to whole-image decode); the Rescale transform
    is linear per-pixel and applies per frame."""

    def __init__(self, path: str):
        import mmap

        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[128:132] != b"DICM":
            raise ValueError("not a DICOM part-10 file: %s" % path)
        s = _Stream(self._mm, 132)
        meta = {"ts": EXPLICIT_LE, "bits": 16, "signed": 0, "rows": 0,
                "cols": 0, "slope": None, "intercept": None,
                "photometric": "MONOCHROME2", "samples": 1}
        explicit = True
        n_frames = 0
        tot_rows = tot_cols = 0
        self._frames = None        # encapsulated: [(off, len)]
        self._pix_off = None       # native: offset of frame 0
        while not s.eof():
            group, elem, vr, length = _read_element(s, explicit)
            if length == 0xFFFFFFFF:
                if (group, elem) == (0x7FE0, 0x0010):
                    self._frames = self._fragment_table(s)
                    break
                _skip_undefined(s)
                continue
            if (group, elem) == (0x7FE0, 0x0010):
                self._pix_off = s.p
                break
            val = s.raw(length)
            if (group, elem) == (0x0002, 0x0010):
                meta["ts"] = val.decode("ascii").strip("\x00 ")
                if meta["ts"] == IMPLICIT_LE:
                    explicit = False
            elif (group, elem) == (0x0028, 0x0008):      # NumberOfFrames IS
                n_frames = int(val.decode("ascii").strip("\x00 ") or 0)
            elif (group, elem) == (0x0028, 0x0010):
                meta["rows"] = struct.unpack("<H", val[:2])[0]
            elif (group, elem) == (0x0028, 0x0011):
                meta["cols"] = struct.unpack("<H", val[:2])[0]
            elif (group, elem) == (0x0028, 0x0100):
                meta["bits"] = struct.unpack("<H", val[:2])[0]
            elif (group, elem) == (0x0028, 0x0103):
                meta["signed"] = struct.unpack("<H", val[:2])[0]
            elif (group, elem) == (0x0028, 0x0002):
                meta["samples"] = struct.unpack("<H", val[:2])[0]
            elif (group, elem) == (0x0028, 0x0004):
                meta["photometric"] = val.decode("ascii").strip("\x00 ")
            elif (group, elem) == (0x0028, 0x1052):
                meta["intercept"] = float(val.decode("ascii").strip("\x00 "))
            elif (group, elem) == (0x0028, 0x1053):
                meta["slope"] = float(val.decode("ascii").strip("\x00 "))
            elif (group, elem) == (0x0048, 0x0006):  # TotalPixelMatrixCols
                tot_cols = struct.unpack("<I", val[:4])[0]
            elif (group, elem) == (0x0048, 0x0007):  # TotalPixelMatrixRows
                tot_rows = struct.unpack("<I", val[:4])[0]
        if n_frames <= 1 or not tot_rows or not tot_cols:
            raise ValueError("not a tiled multi-frame DICOM")
        if meta["photometric"] == "MONOCHROME1":
            raise ValueError("MONOCHROME1 needs a global max; use the "
                             "whole-image decode path")
        if meta["samples"] != 1:
            raise ValueError("only grayscale DICOM is supported")
        if self._frames is not None and len(self._frames) != n_frames:
            raise ValueError("fragment count %d != frame count %d "
                             "(multi-fragment frames unsupported)"
                             % (len(self._frames), n_frames))
        if self._frames is None and self._pix_off is None:
            raise ValueError("no PixelData in tiled DICOM")
        self.meta = meta
        self.n_frames = n_frames
        self.height, self.width = tot_rows, tot_cols
        self.tile_h, self.tile_w = meta["rows"], meta["cols"]
        self.tiles_x = -(-tot_cols // self.tile_w)
        self.tiles_y = -(-tot_rows // self.tile_h)
        if self.tiles_x * self.tiles_y != n_frames:
            raise ValueError("frame count %d does not tile %dx%d "
                             "(TILED_FULL expected)" %
                             (n_frames, tot_rows, tot_cols))
        self._dt = np.dtype({(8, 0): np.uint8, (8, 1): np.int8,
                             (16, 0): np.uint16, (16, 1): np.int16,
                             (32, 0): np.uint32, (32, 1): np.int32}[
            (meta["bits"], meta["signed"])])
        from collections import OrderedDict
        self._cache = OrderedDict()     # LRU of decoded frames

    def _fragment_table(self, s: _Stream):
        """[(offset, length)] of encapsulated frame fragments."""
        frags = []
        first = True
        while True:
            group, elem = s.u16(), s.u16()
            length = s.u32()
            if (group, elem) == (0xFFFE, 0xE0DD):
                break
            if (group, elem) != (0xFFFE, 0xE000):
                raise ValueError("malformed encapsulated PixelData item")
            if first:
                first = False      # basic offset table
            else:
                frags.append((s.p, length))
            s.p += length
        return frags

    def _frame(self, k: int) -> np.ndarray:
        if k in self._cache:
            self._cache.move_to_end(k)
            return self._cache[k]
        npx = self.tile_h * self.tile_w
        if self._frames is None:
            nb = self._dt.itemsize
            off = self._pix_off + k * npx * nb
            # copy: a live view would pin the mmap open past close()
            arr = np.frombuffer(self._mm, self._dt, npx, off).reshape(
                self.tile_h, self.tile_w).copy()
        else:
            off, length = self._frames[k]
            arr = _decode_encapsulated(
                self.meta["ts"], [self._mm[off:off + length]], self.meta)
        m = self.meta
        if m["slope"] is not None or m["intercept"] is not None:
            sl = 1.0 if m["slope"] is None else m["slope"]
            ic = 0.0 if m["intercept"] is None else m["intercept"]
            hu = arr.astype(np.float64) * sl + ic
            arr = (hu.astype(np.int32)
                   if float(sl).is_integer() and float(ic).is_integer()
                   else hu)
        # bounded LRU: evict the least-recently-used frame (a 2048-wide
        # region touches 64+ tiles; clearing everything thrashed decodes)
        while len(self._cache) >= 64:
            self._cache.popitem(last=False)
        self._cache[k] = arr
        return arr

    def read_region(self, y0: int, x0: int, h: int, w: int) -> np.ndarray:
        m = self.meta
        has_rescale = m["slope"] is not None or m["intercept"] is not None
        sl = 1.0 if m["slope"] is None else float(m["slope"])
        ic = 0.0 if m["intercept"] is None else float(m["intercept"])
        # mirror _frame's cast rule: int32 only when BOTH slope and
        # intercept are integral, else keep the float rescale exact
        out_dt = (self._dt if not has_rescale
                  else (np.int32 if sl.is_integer() and ic.is_integer()
                        else np.float64))
        out = np.zeros((h, w), out_dt)
        y1 = min(y0 + h, self.height)
        x1 = min(x0 + w, self.width)
        if y1 <= y0 or x1 <= x0:
            return out
        for ty in range(y0 // self.tile_h, -(-y1 // self.tile_h)):
            for tx in range(x0 // self.tile_w, -(-x1 // self.tile_w)):
                fr = self._frame(ty * self.tiles_x + tx)
                gy0 = max(y0, ty * self.tile_h)
                gy1 = min(y1, (ty + 1) * self.tile_h)
                gx0 = max(x0, tx * self.tile_w)
                gx1 = min(x1, (tx + 1) * self.tile_w)
                out[gy0 - y0:gy1 - y0, gx0 - x0:gx1 - x0] = \
                    fr[gy0 - ty * self.tile_h:gy1 - ty * self.tile_h,
                       gx0 - tx * self.tile_w:gx1 - tx * self.tile_w]
        return out

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _el(group, elem, vr: bytes, val: bytes) -> bytes:
    if len(val) % 2:
        val += b"\x00" if vr != b"UI" else b"\x00"
    head = struct.pack("<HH", group, elem) + vr
    if vr in _LONG_VRS:
        return head + b"\x00\x00" + struct.pack("<I", len(val)) + val
    return head + struct.pack("<H", len(val)) + val


def write_dicom_tiled(path: str, arr: np.ndarray, tile: int = 256):
    """Write a tiled multi-frame (TILED_FULL) grayscale DICOM: frames are
    ``tile x tile`` blocks of ``arr`` in row-major order, edge tiles
    zero-padded (tests and dataset fabrication; read back with
    DicomTiledReader)."""
    arr = np.ascontiguousarray(arr)
    signed = arr.dtype.kind == "i"
    bits = arr.dtype.itemsize * 8
    if bits not in (8, 16, 32):
        raise ValueError("unsupported dtype %s" % arr.dtype)
    H, W = arr.shape
    ty, tx = -(-H // tile), -(-W // tile)
    frames = []
    for i in range(ty):
        for j in range(tx):
            blk = np.zeros((tile, tile), arr.dtype)
            sub = arr[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
            blk[:sub.shape[0], :sub.shape[1]] = sub
            frames.append(blk.tobytes())
    meta_body = _el(0x0002, 0x0010, b"UI", EXPLICIT_LE.encode())
    out = [b"\x00" * 128, b"DICM",
           _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))),
           meta_body,
           _el(0x0008, 0x0060, b"CS", b"SM"),
           _el(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
           _el(0x0028, 0x0004, b"CS", b"MONOCHROME2"),
           _el(0x0028, 0x0008, b"IS", str(ty * tx).encode()),
           _el(0x0028, 0x0010, b"US", struct.pack("<H", tile)),
           _el(0x0028, 0x0011, b"US", struct.pack("<H", tile)),
           _el(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
           _el(0x0028, 0x0101, b"US", struct.pack("<H", bits)),
           _el(0x0028, 0x0102, b"US", struct.pack("<H", bits - 1)),
           _el(0x0028, 0x0103, b"US", struct.pack("<H", 1 if signed else 0)),
           _el(0x0048, 0x0006, b"UL", struct.pack("<I", W)),
           _el(0x0048, 0x0007, b"UL", struct.pack("<I", H))]
    vr = b"OW" if bits > 8 else b"OB"
    out.append(_el(0x7FE0, 0x0010, vr, b"".join(frames)))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def write_dicom_gray(path: str, arr: np.ndarray, slope: float = None,
                     intercept: float = None):
    """Write a minimal explicit-VR-little-endian grayscale DICOM (tests and
    dataset fabrication)."""
    arr = np.ascontiguousarray(arr)
    signed = arr.dtype.kind == "i"
    bits = arr.dtype.itemsize * 8
    if bits not in (8, 16, 32):
        raise ValueError("unsupported dtype %s" % arr.dtype)
    meta_body = _el(0x0002, 0x0010, b"UI", EXPLICIT_LE.encode())
    out = [b"\x00" * 128, b"DICM",
           _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))),
           meta_body,
           _el(0x0008, 0x0060, b"CS", b"CT"),
           _el(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
           _el(0x0028, 0x0004, b"CS", b"MONOCHROME2"),
           _el(0x0028, 0x0010, b"US", struct.pack("<H", arr.shape[0])),
           _el(0x0028, 0x0011, b"US", struct.pack("<H", arr.shape[1])),
           _el(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
           _el(0x0028, 0x0101, b"US", struct.pack("<H", bits)),
           _el(0x0028, 0x0102, b"US", struct.pack("<H", bits - 1)),
           _el(0x0028, 0x0103, b"US", struct.pack("<H", 1 if signed else 0))]
    if intercept is not None:
        out.append(_el(0x0028, 0x1052, b"DS", str(intercept).encode()))
    if slope is not None:
        out.append(_el(0x0028, 0x1053, b"DS", str(slope).encode()))
    vr = b"OW" if bits > 8 else b"OB"
    out.append(_el(0x7FE0, 0x0010, vr, arr.tobytes()))
    with open(path, "wb") as f:
        f.write(b"".join(out))
