"""Grayscale TIFF region reader and writer without libtiff (the port's
counterpart of nyxus_tpu/native/__init__.py ``TiffReader`` and
``write_tiff``, which link libtiff).

numpy plus the port's host library: TIFF LZW and horizontal differencing
(Predictor 2) run in ``native/src/tiff_codec.cpp``, Deflate in Python's
``zlib``.  The reader parses the first IFD of a classic (version 42) or
BigTIFF (version 43) file in either byte order, tiled or stripped, and
decodes only the tiles or strips a region touches, keeping the decoded
blocks in a bounded LRU (many small ROI regions of one batch land in the
same tile).  Anything it cannot decode raises ``IOError`` naming the tag.
"""

from __future__ import annotations

import collections
import ctypes
import os
import struct
import zlib

import numpy as np

from .. import native

# tags read from the first IFD
_WIDTH, _LENGTH, _BITS, _COMPRESSION = 256, 257, 258, 259
_STRIP_OFFSETS, _SPP, _ROWS_PER_STRIP = 273, 277, 278
_STRIP_COUNTS, _PLANAR, _PREDICTOR = 279, 284, 317
_TILE_WIDTH, _TILE_LENGTH, _TILE_OFFSETS, _TILE_COUNTS = 322, 323, 324, 325
_SAMPLE_FORMAT, _FILL_ORDER = 339, 266

_NONE, _LZW, _DEFLATE, _ADOBE_DEFLATE = 1, 5, 32946, 8

# IFD field type -> numpy type of one value (RATIONAL as two uint32)
_FIELD_TYPES = {1: "u1", 2: "u1", 3: "u2", 4: "u4", 5: "u4", 6: "i1",
                7: "u1", 8: "i2", 9: "i4", 10: "i4", 11: "f4", 12: "f8",
                13: "u4", 16: "u8", 17: "i8", 18: "u8"}
_FIELD_COUNT = {5: 2, 10: 2}     # numpy values a field value spans

# SampleFormat (1 uint, 2 int, 3 IEEE float, 4 void = uint) and bits ->
# numpy kind
_SAMPLE_KIND = {1: "u", 2: "i", 3: "f", 4: "u"}

_DTYPES = {"f32": np.float32, "f64": np.float64, "u32": np.uint32}

# decoded-block cache of a reader (nyxus_tpu/native/src/tiff_reader.cpp:36-45)
CACHE_CAP_BYTES = 32 << 20


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def lzw_decode(data: bytes, size: int) -> bytes:
    """The first ``size`` bytes that one LZW strip or tile decodes to (fewer
    when the stream ends first)."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(size, np.uint8)
    n = native._load().nyx_lzw_decode(_ptr(src), src.size, _ptr(out), size)
    if n < 0:
        raise IOError("corrupt LZW data (a code not in the table)")
    return out[:n].tobytes()


def lzw_encode(data: bytes) -> bytes:
    """One LZW strip or tile as libtiff writes it: ClearCode first,
    EndOfInformation last."""
    src = np.frombuffer(data, np.uint8)
    cap = 2 * src.size + 64
    out = np.empty(cap, np.uint8)
    n = native._load().nyx_lzw_encode(_ptr(src), src.size, _ptr(out), cap)
    if n < 0:
        raise IOError("LZW output exceeded its %d-byte buffer" % cap)
    return out[:n].tobytes()


def _hdiff(fn, buf, rows, width, spp, itemsize, big_endian):
    if not (buf.flags.c_contiguous and buf.flags.writeable) \
            or buf.nbytes < rows * width * spp * itemsize:
        raise ValueError("Predictor 2 needs a writable contiguous buffer of "
                         "%d bytes" % (rows * width * spp * itemsize))
    if fn(_ptr(buf), rows, width, spp, itemsize, int(big_endian)) != 0:
        raise IOError("Predictor 2 over %d-byte samples is not supported"
                      % itemsize)


def undo_predictor(buf: np.ndarray, rows, width, spp, itemsize,
                   big_endian=False):
    """Undo horizontal differencing (Predictor 2) in place over ``rows``
    rows of ``width`` pixels of ``spp`` samples of ``itemsize`` bytes in
    the file's byte order."""
    _hdiff(native._load().nyx_hdiff_decode, buf, rows, width, spp, itemsize,
           big_endian)


def apply_predictor(buf: np.ndarray, rows, width, spp, itemsize,
                    big_endian=False):
    """Horizontal differencing (Predictor 2) in place, the inverse of
    ``undo_predictor``."""
    _hdiff(native._load().nyx_hdiff_encode, buf, rows, width, spp, itemsize,
           big_endian)


def _pread(fd, n, off):
    data = os.pread(fd, n, off)
    if len(data) != n:
        raise IOError("TIFF truncated: %d bytes at offset %d, %d read"
                      % (n, off, len(data)))
    return data


def _read_ifd(fd):
    """(byte order "<" or ">", {tag: numpy values}) of the first IFD."""
    head = os.pread(fd, 16, 0)
    order = {b"II": "<", b"MM": ">"}.get(head[:2])
    if order is None or len(head) < 8:
        raise IOError("not a TIFF file (byte-order mark %r)" % head[:2])
    version = struct.unpack(order + "H", head[2:4])[0]
    if version == 42:
        ifd = struct.unpack(order + "I", head[4:8])[0]
        n = struct.unpack(order + "H", _pread(fd, 2, ifd))[0]
        base, entry, cfmt, vsize = ifd + 2, 12, "I", 4
    elif version == 43:
        if len(head) < 16 or struct.unpack(order + "HH", head[4:8]) != (8, 0):
            raise IOError("BigTIFF header with an offset size other than 8")
        ifd = struct.unpack(order + "Q", head[8:16])[0]
        n = struct.unpack(order + "Q", _pread(fd, 8, ifd))[0]
        base, entry, cfmt, vsize = ifd + 8, 20, "Q", 8
    else:
        raise IOError("unknown TIFF version %d" % version)
    raw = _pread(fd, n * entry, base)
    tags = {}
    for k in range(n):
        e = raw[k * entry:(k + 1) * entry]
        tag, ftype = struct.unpack(order + "HH", e[:4])
        count = struct.unpack(order + cfmt, e[4:4 + vsize])[0]
        field = e[4 + vsize:]
        np_type = _FIELD_TYPES.get(ftype)
        if np_type is None:
            continue                       # a type no read tag uses
        dt = np.dtype(np_type).newbyteorder(order)
        nvals = count * _FIELD_COUNT.get(ftype, 1)
        nbytes = nvals * dt.itemsize
        if nbytes <= len(field):
            data = field[:nbytes]
        else:
            data = _pread(fd, nbytes, struct.unpack(order + cfmt, field)[0])
        tags[tag] = np.frombuffer(data, dt)
    return order, tags


class TiffReader:
    """Region server over one grayscale TIFF (tiled or stripped): the
    counterpart of nyxus_tpu.native.TiffReader, with its attributes and
    methods.  Multi-sample files read as their first channel.  One reader
    is not safe for concurrent calls: a pair source serialises them."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._parse()
        except BaseException:
            os.close(self._fd)
            self._fd = None
            raise
        self._cache = collections.OrderedDict()
        self._cache_bytes = 0

    def _tag(self, tags, tag, default=None):
        v = tags.get(tag)
        if v is None or v.size == 0:
            if default is None:
                raise IOError("%s: required TIFF tag %d missing"
                              % (self.path, tag))
            return default
        return int(v[0])

    def _parse(self):
        order, tags = _read_ifd(self._fd)
        self._order = order
        self.width = self._tag(tags, _WIDTH)
        self.height = self._tag(tags, _LENGTH)
        self.bits = self._tag(tags, _BITS, 1)
        self.samples_per_pixel = self._tag(tags, _SPP, 1)
        fmt = self._tag(tags, _SAMPLE_FORMAT, 1)
        comp = self._tag(tags, _COMPRESSION, _NONE)
        pred = self._tag(tags, _PREDICTOR, 1)
        planar = self._tag(tags, _PLANAR, 1)
        if comp not in (_NONE, _LZW, _DEFLATE, _ADOBE_DEFLATE):
            raise IOError("%s: unsupported Compression (tag 259) = %d: only "
                          "none (1), LZW (5) and Deflate (8, 32946) are read"
                          % (self.path, comp))
        if pred not in (1, 2):
            raise IOError("%s: unsupported Predictor (tag 317) = %d: only "
                          "none (1) and horizontal differencing (2) are read"
                          % (self.path, pred))
        if self._tag(tags, _FILL_ORDER, 1) != 1:
            raise IOError("%s: unsupported FillOrder (tag 266) = %d"
                          % (self.path, self._tag(tags, _FILL_ORDER)))
        kind = _SAMPLE_KIND.get(fmt)
        if kind is None:
            raise IOError("%s: unsupported SampleFormat (tag 339) = %d"
                          % (self.path, fmt))
        if self.bits not in (8, 16, 32, 64) or (kind == "f"
                                                and self.bits < 32):
            raise IOError("%s: unsupported BitsPerSample (tag 258) = %d for "
                          "SampleFormat %d" % (self.path, self.bits, fmt))
        self.is_float = fmt == 3
        self.is_signed = fmt == 2
        self._itemsize = self.bits // 8
        self._file_dtype = np.dtype("%s%d" % (kind, self._itemsize)) \
            .newbyteorder(order)
        self._native_dtype = self._file_dtype.newbyteorder("=")
        self._comp = comp
        self._predictor = pred == 2 and comp != _NONE
        # separate planes: plane 0's blocks hold the first channel alone
        self._spp = 1 if planar == 2 else self.samples_per_pixel
        self.tiled = _TILE_OFFSETS in tags
        if self.tiled:
            self.tile_width = self._tag(tags, _TILE_WIDTH)
            self.tile_height = self._tag(tags, _TILE_LENGTH)
            offsets, counts = tags[_TILE_OFFSETS], tags.get(_TILE_COUNTS)
        else:
            rps = self._tag(tags, _ROWS_PER_STRIP, self.height)
            if rps == 0 or rps > self.height:
                rps = self.height
            self.tile_width, self.tile_height = self.width, rps
            offsets, counts = tags.get(_STRIP_OFFSETS), tags.get(_STRIP_COUNTS)
            if offsets is None:
                raise IOError("%s: StripOffsets (tag 273) missing" % self.path)
        if min(self.width, self.height, self.tile_width,
               self.tile_height) <= 0:
            raise IOError("%s: empty image or tile (%d x %d, blocks %d x %d)"
                          % (self.path, self.height, self.width,
                             self.tile_height, self.tile_width))
        self._blocks_x = -(-self.width // self.tile_width)
        n = -(-self.height // self.tile_height) * self._blocks_x
        if counts is None:
            if comp != _NONE:
                raise IOError("%s: %s byte counts (tag %d) missing"
                              % (self.path, "Tile" if self.tiled else "Strip",
                                 _TILE_COUNTS if self.tiled
                                 else _STRIP_COUNTS))
            counts = np.full(n, self.tile_height * self.tile_width
                             * self._spp * self._itemsize, np.int64)
        if offsets.size < n or counts.size < n:
            raise IOError("%s: %d blocks but %d offsets and %d byte counts"
                          % (self.path, n, offsets.size, counts.size))
        self._offsets = offsets[:n].astype(np.int64)
        self._counts = counts[:n].astype(np.int64)

    def _decode(self, k: int, rows: int) -> np.ndarray:
        """Block k decoded to [rows, block width] in the native dtype."""
        row_bytes = self.tile_width * self._spp * self._itemsize
        need = rows * row_bytes
        raw = _pread(self._fd, int(self._counts[k]), int(self._offsets[k]))
        if self._comp == _LZW:
            if len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
                raise IOError("%s: old-style LZW (Compression tag 259 = 5, "
                              "pre-TIFF 6.0 bit order) is not supported"
                              % self.path)
            data = lzw_decode(raw, need)
        elif self._comp in (_DEFLATE, _ADOBE_DEFLATE):
            try:
                data = zlib.decompress(raw)[:need]
            except zlib.error as e:
                raise IOError("%s: corrupt Deflate data in block %d (%s)"
                              % (self.path, k, e))
        else:
            data = raw[:need]
        if len(data) < need:
            raise IOError("%s: block %d holds %d of its %d bytes"
                          % (self.path, k, len(data), need))
        buf = np.frombuffer(bytearray(data), np.uint8)
        if self._predictor:
            undo_predictor(buf, rows, self.tile_width, self._spp,
                           self._itemsize, self._order == ">")
        arr = buf.view(self._file_dtype).reshape(rows, self.tile_width,
                                                 self._spp)[:, :, 0]
        return arr.astype(self._native_dtype)

    def _block(self, by: int, bx: int) -> np.ndarray:
        """Decoded block at block row by, block column bx, through the
        LRU."""
        k = by * self._blocks_x + bx
        hit = self._cache.get(k)
        if hit is not None:
            self._cache.move_to_end(k)
            return hit
        rows = self.tile_height if self.tiled else \
            min(self.tile_height, self.height - by * self.tile_height)
        blk = self._decode(k, rows)
        self._cache[k] = blk
        self._cache_bytes += blk.nbytes
        while self._cache_bytes > CACHE_CAP_BYTES and len(self._cache) > 1:
            _, old = self._cache.popitem(last=False)
            self._cache_bytes -= old.nbytes
        return blk

    def read_region(self, y0: int, x0: int, h: int, w: int, dtype="f32"):
        """Dense [h, w] region at (y0, x0) as float32, float64 or uint32
        (``dtype`` "f32", "f64", "u32", converted as a C cast does);
        out-of-image margins are 0."""
        if self._fd is None:
            raise IOError("%s: reader closed" % self.path)
        if min(y0, x0, h, w) < 0:
            raise ValueError("negative region (%d, %d, %d, %d)"
                             % (y0, x0, h, w))
        out = np.zeros((h, w), _DTYPES[dtype])
        y1, x1 = min(y0 + h, self.height), min(x0 + w, self.width)
        th, tw = self.tile_height, self.tile_width
        for by in range(y0 // th, -(-y1 // th)):
            for bx in range(x0 // tw, -(-x1 // tw)):
                blk = self._block(by, bx)
                oy, ox = by * th, bx * tw
                cy0, cy1 = max(y0, oy), min(y1, oy + blk.shape[0])
                cx0, cx1 = max(x0, ox), min(x1, ox + tw)
                out[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0] = \
                    blk[cy0 - oy:cy1 - oy, cx0 - ox:cx1 - ox]
        return out

    def read_all(self, dtype="f32"):
        return self.read_region(0, 0, self.height, self.width, dtype)

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
            self._cache.clear()
            self._cache_bytes = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_fd", None) is not None:
            self.close()


# what nyxtiff_write takes (nyxus_tpu/native/src/tiff_reader.cpp:286-344):
# dtype -> SampleFormat
_WRITE_FORMATS = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 1,
                  np.dtype(np.uint32): 1, np.dtype(np.float32): 3}
_COMPRESSIONS = {"none": _NONE, "lzw": _LZW, "deflate": _ADOBE_DEFLATE}
_SHORT, _LONG = 3, 4


def _ifd(entries, offset: int) -> bytes:
    """Little-endian classic IFD at file offset ``offset`` (even) with its
    out-of-entry values after it; ``entries`` (tag, type, values)."""
    entries = sorted(entries)
    n = len(entries)
    extra_at = offset + 2 + 12 * n + 4
    head, extra = [struct.pack("<H", n)], []
    for tag, ftype, values in entries:
        data = np.asarray(values, "<u2" if ftype == _SHORT else "<u4") \
            .tobytes()
        if len(data) <= 4:
            field = data.ljust(4, b"\0")
        else:
            field = struct.pack("<I", extra_at)
            extra.append(data)
            extra_at += len(data)
        head.append(struct.pack("<HHI", tag, ftype, len(values)) + field)
    head.append(struct.pack("<I", 0))
    return b"".join(head + extra)


def write_tiff(path, arr, tile_size=0, compression="lzw"):
    """Write a grayscale TIFF (stripped in strips of about 1 MB, or tiled
    with ``tile_size`` x ``tile_size`` tiles, the edge tiles padded with
    zeros), as nyxus_tpu.native.write_tiff does: uint8, uint16, uint32 and
    float32 keep their type, any other dtype is written as float32;
    ``compression`` "none", "lzw" or "deflate".  Little-endian classic
    TIFF, so the file must stay under 4 GiB."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _WRITE_FORMATS:
        arr = np.ascontiguousarray(arr, np.float32)
    if arr.ndim != 2 or arr.size == 0:
        raise ValueError("write_tiff takes a non-empty 2D array, not %s"
                         % (arr.shape,))
    comp = _COMPRESSIONS[compression]
    encode = {_NONE: bytes, _LZW: lzw_encode,
              _ADOBE_DEFLATE: zlib.compress}[comp]
    H, W = arr.shape
    bpp = arr.itemsize
    fmt = _WRITE_FORMATS[arr.dtype]
    arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    blocks = []
    if tile_size > 0:
        tile = np.zeros((tile_size, tile_size), arr.dtype)
        for ty in range(0, H, tile_size):
            for tx in range(0, W, tile_size):
                part = arr[ty:ty + tile_size, tx:tx + tile_size]
                tile.fill(0)
                tile[:part.shape[0], :part.shape[1]] = part
                blocks.append(encode(tile.tobytes()))
        layout = [(322, _LONG, [tile_size]), (323, _LONG, [tile_size])]
        offsets_tag, counts_tag = _TILE_OFFSETS, _TILE_COUNTS
    else:
        rps = max(1, (1 << 20) // (W * bpp))
        blocks = [encode(arr[y:y + rps].tobytes()) for y in range(0, H, rps)]
        layout = [(_ROWS_PER_STRIP, _LONG, [rps])]
        offsets_tag, counts_tag = _STRIP_OFFSETS, _STRIP_COUNTS
    offsets, pos = [], 8
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    ifd_at = pos + (pos & 1)
    entries = layout + [
        (_WIDTH, _LONG, [W]), (_LENGTH, _LONG, [H]),
        (_BITS, _SHORT, [8 * bpp]), (_COMPRESSION, _SHORT, [comp]),
        (262, _SHORT, [1]),                          # MinIsBlack
        (_SPP, _SHORT, [1]), (_PLANAR, _SHORT, [1]),
        (_SAMPLE_FORMAT, _SHORT, [fmt]),
        (offsets_tag, _LONG, offsets),
        (counts_tag, _LONG, [len(b) for b in blocks])]
    ifd = _ifd(entries, ifd_at)
    if ifd_at + len(ifd) >= 1 << 32:
        raise ValueError("%s: %d bytes exceed what classic TIFF addresses"
                         % (path, ifd_at + len(ifd)))
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", ifd_at))
        for b in blocks:
            f.write(b)
        f.write(b"\0" * (ifd_at - pos))
        f.write(ifd)
