"""The port's libtiff-free TIFF codec, reader and writer
(nyxus_tpu_torch/io/tiff.py, native/src/tiff_codec.cpp) against libtiff
(the JAX package's native reader and writer) and PIL, on the CPU.

Files written by libtiff in every layout, compression and dtype that its
writer takes read bit for bit as libtiff reads them, regions across tile
seams and past the image's edge included; the port's files read back equal
through libtiff and PIL; big-endian, BigTIFF and Predictor-2 files, built
here from raw IFD bytes, read equal through both readers; and what the
reader cannot decode raises IOError naming the tag."""

import ctypes
import os
import re
import struct
import sys
import threading
import zlib

import numpy as np
import pytest

import nyxus_tpu.native as jnative
from nyxus_tpu.io import readers as jreaders

from nyxus_tpu_torch import native as tnative
from nyxus_tpu_torch.io import readers as treaders
from nyxus_tpu_torch.io import tiff
from nyxus_tpu_torch.pipeline.sources import TiffPairSource
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)

DTYPES = [np.uint8, np.uint16, np.uint32, np.float32]
LAYOUTS = [0, 128, 512]            # strips, 128-px tiles, 512-px tiles
COMPRESSIONS = ["none", "lzw", "deflate"]
H, W = 300, 700                    # not a multiple of either tile size
REGIONS = [(0, 0, H, W), (100, 120, 60, 30), (120, 500, 20, 40),
           (250, 600, 100, 200), (290, 690, 64, 64), (310, 0, 8, 8)]


def _image(dtype, seed=0, h=H, w=W):
    r = np.random.default_rng(seed)
    if dtype == np.float32:
        a = r.normal(0, 3000, (h, w)).astype(np.float32)
    else:
        a = r.integers(0, np.iinfo(dtype).max, (h, w), dtype=np.uint64,
                       endpoint=True).astype(dtype)
    a[:h // 3, :w // 4] = a[0, 0]        # a flat patch: long LZW strings
    return a


@pytest.mark.parametrize("data", [
    b"", b"A", bytes(70000), bytes(range(256)) * 300,
    np.random.default_rng(1).integers(0, 256, 200000, np.uint8).tobytes(),
    np.random.default_rng(2).integers(0, 3, 300000, np.uint8).tobytes()],
    ids=["empty", "one", "zeros", "ramp", "random", "three-symbols"])
def test_lzw_roundtrip(data):
    """Encode then decode is the identity on random, uniform and
    low-entropy buffers (the last two fill the table many times over)."""
    enc = tiff.lzw_encode(data)
    assert enc[0] == 0x80                # ClearCode first, MSB-first
    assert tiff.lzw_decode(enc, len(data) + 16) == data
    assert tiff.lzw_decode(enc, len(data) // 2) == data[:len(data) // 2]


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
@pytest.mark.parametrize("big_endian", [False, True])
def test_predictor_roundtrip(itemsize, big_endian):
    r = np.random.default_rng(itemsize)
    buf = r.integers(0, 256, 5 * 7 * 3 * itemsize, np.uint8)
    orig = buf.copy()
    tiff.apply_predictor(buf, 5, 7, 3, itemsize, big_endian)
    assert not np.array_equal(buf, orig)
    tiff.undo_predictor(buf, 5, 7, 3, itemsize, big_endian)
    np.testing.assert_array_equal(buf, orig)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("comp", COMPRESSIONS)
@pytest.mark.parametrize("tile", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_reads_libtiff_files(tmp_path, dtype, tile, comp):
    """A file from libtiff's writer: read_gray and every region in every
    output type equal JAX's read_gray and native reader bit for bit (but
    negative floats as uint32, a C cast whose result is undefined)."""
    a = _image(dtype)
    p = str(tmp_path / "a.tif")
    jnative.write_tiff(p, a, tile_size=tile, compression=comp)
    _same(treaders.read_gray(p), jreaders.read_gray(p))
    with tiff.TiffReader(p) as t, jnative.TiffReader(p) as j:
        # (libtiff reports a single uncompressed strip chopped into
        # strips of ~8 KB, so strip heights are not compared)
        assert (t.height, t.width, t.bits, t.is_float, t.is_signed,
                t.tiled, t.tile_width) == \
            (j.height, j.width, j.bits, j.is_float, j.is_signed, j.tiled,
             j.tile_width)
        assert not t.tiled or t.tile_height == j.tile_height
        for dt in ("f32", "f64") + (() if t.is_float else ("u32",)):
            for reg in REGIONS:
                _same(t.read_region(*reg, dt), j.read_region(*reg, dt))


@pytest.mark.parametrize("comp", COMPRESSIONS)
@pytest.mark.parametrize("tile", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_writes_libtiff_and_pil_read(tmp_path, dtype, tile, comp):
    """The port's write_tiff: libtiff and PIL read the array back equal."""
    from PIL import Image
    a = _image(dtype, seed=3)
    p = str(tmp_path / "a.tif")
    tiff.write_tiff(p, a, tile_size=tile, compression=comp)
    with jnative.TiffReader(p) as j:
        assert j.tiled == (tile > 0) and j.bits == 8 * a.itemsize
        np.testing.assert_array_equal(j.read_all("f64"), a.astype(np.float64))
    with Image.open(p) as im:
        # PIL holds uint32 samples as int32 ("I"): the same bits
        _same(np.array(im).view(a.dtype), a)


def test_write_casts_other_dtypes_to_float32(tmp_path):
    """Like libtiff's writer, any dtype but u8/u16/u32/f32 is written as
    float32 (int32 labels too)."""
    a = np.arange(-20, 40, dtype=np.int32).reshape(6, 10)
    p, q = str(tmp_path / "t.tif"), str(tmp_path / "j.tif")
    tiff.write_tiff(p, a)
    jnative.write_tiff(q, a)
    _same(treaders.read_gray(p), jreaders.read_gray(q))
    assert treaders.read_gray(p).dtype == np.float32


# -- files built from raw IFD bytes ----------------------------------------

_TYPE = {1: "B", 3: "H", 4: "I", 16: "Q"}


def _raw_tiff(path, arr, order="<", big=False, predictor=1, comp=5,
              tile=0, rps=None, spp=1):
    """A TIFF of ``arr`` ([h, w] or [h, w, spp]) built byte by byte:
    ``order`` its byte order, ``big`` BigTIFF, tiles of ``tile`` px or
    strips of ``rps`` rows (None: no RowsPerStrip tag, one strip)."""
    a = arr if arr.ndim == 3 else arr[:, :, None]
    h, w, spp = a.shape
    a = a.astype(a.dtype.newbyteorder(order))
    isz = a.itemsize
    fmt = {"u": 1, "i": 2, "f": 3}[a.dtype.kind]

    def encode(block):
        buf = np.frombuffer(bytearray(block.tobytes()), np.uint8)
        rows, bw = block.shape[:2]
        if predictor == 2:
            tiff.apply_predictor(buf, rows, bw, spp, isz, order == ">")
        data = buf.tobytes()
        return {1: data, 5: tiff.lzw_encode(data),
                8: zlib.compress(data)}[comp]

    blocks = []
    if tile:
        for ty in range(0, h, tile):
            for tx in range(0, w, tile):
                t = np.zeros((tile, tile, spp), a.dtype)
                part = a[ty:ty + tile, tx:tx + tile]
                t[:part.shape[0], :part.shape[1]] = part
                blocks.append(encode(t))
    else:
        step = rps or h
        blocks = [encode(a[y:y + step]) for y in range(0, h, step)]
    off_t = 16 if big else 4
    head = 16 if big else 8
    offs, pos = [], head
    for b in blocks:
        offs.append(pos)
        pos += len(b)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8 * isz] * spp),
               (259, 3, [comp]), (262, 3, [1]), (277, 3, [spp]),
               (284, 3, [1]), (317, 3, [predictor]), (339, 3, [fmt] * spp)]
    if tile:
        entries += [(322, 4, [tile]), (323, 4, [tile]), (324, off_t, offs),
                    (325, 4, [len(b) for b in blocks])]
    else:
        entries += [(273, off_t, offs), (279, 4, [len(b) for b in blocks])]
        if rps:
            entries.append((278, 4, [rps]))
    entries.sort()
    ifd_at = pos + (pos & 1)
    cnt, slot = ("Q", 8) if big else ("I", 4)
    ent_size = 4 + 2 * slot
    extra_at = ifd_at + (8 if big else 2) + ent_size * len(entries) + slot
    body, extra = [struct.pack(order + ("Q" if big else "H"),
                               len(entries))], []
    for tag, typ, vals in entries:
        data = struct.pack(order + _TYPE[typ] * len(vals), *vals)
        if len(data) <= slot:
            field = data.ljust(slot, b"\0")
        else:
            field = struct.pack(order + cnt, extra_at)
            extra.append(data)
            extra_at += len(data)
        body.append(struct.pack(order + "HH" + cnt, tag, typ, len(vals))
                    + field)
    body.append(struct.pack(order + cnt, 0))
    if big:
        header = (b"II" if order == "<" else b"MM") + struct.pack(
            order + "HHHQ", 43, 8, 0, ifd_at)
    else:
        header = (b"II" if order == "<" else b"MM") + struct.pack(
            order + "HI", 42, ifd_at)
    with open(path, "wb") as f:
        f.write(header)
        for b in blocks:
            f.write(b)
        f.write(b"\0" * (ifd_at - pos))
        f.write(b"".join(body + extra))


RAW_DTYPES = [np.uint8, np.uint16, np.int16, np.uint32, np.int32, np.float32,
              np.float64, np.uint64]


@pytest.mark.parametrize("layout", ["tile16", "rps7", "no-rps"])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("big", [False, True], ids=["classic", "bigtiff"])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
def test_raw_files_read_as_libtiff(tmp_path, order, big, predictor, layout):
    """Big- and little-endian, classic and BigTIFF, with and without
    Predictor 2 over LZW, tiled (edge tiles) or stripped (a short last
    strip, or RowsPerStrip absent): every sample type reads as libtiff
    reads it."""
    tile = 16 if layout == "tile16" else 0
    rps = 7 if layout == "rps7" else None
    for k, dt in enumerate(RAW_DTYPES):
        a = _image(dt, seed=k, h=37, w=45) if dt in DTYPES else (
            np.random.default_rng(k).normal(0, 1e4, (37, 45)).astype(dt))
        p = str(tmp_path / ("f%d.tif" % k))
        _raw_tiff(p, a, order, big, predictor, 5, tile, rps)
        with tiff.TiffReader(p) as t:
            for dtn in ("f32", "f64") + (
                    ("u32",) if a.dtype.kind != "f" or a.min() >= 0 else ()):
                got = t.read_region(3, 5, 40, 44, dtn)
                if dtn == "f64":
                    want = np.zeros((40, 44))
                    want[:34, :40] = a[3:, 5:].astype(np.float64)
                    _same(got, want)
                if not big:          # libtiff's BigTIFF reads in the next test
                    with jnative.TiffReader(p) as j:
                        _same(got, j.read_region(3, 5, 40, 44, dtn))
        if not big:
            _same(treaders.read_gray(p), jreaders.read_gray(p))


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
def test_bigtiff_read_as_libtiff(tmp_path, order):
    """A BigTIFF (the OME-TIFF of large slides) with Predictor 2 over LZW
    and Deflate: libtiff and the port read the same samples."""
    for comp in (5, 8):
        a = _image(np.uint16, seed=comp, h=70, w=90)
        p = str(tmp_path / ("b%d.tif" % comp))
        _raw_tiff(p, a, order, True, 2, comp, tile=32)
        with tiff.TiffReader(p) as t, jnative.TiffReader(p) as j:
            _same(t.read_all("u32"), j.read_all("u32"))
            _same(t.read_region(60, 80, 20, 20, "f64"),
                  j.read_region(60, 80, 20, 20, "f64"))
        _same(treaders.read_gray(p), a)


def test_first_channel_of_rgb(tmp_path):
    """spp > 1 reads the first channel, as the native reader does."""
    rgb = np.random.default_rng(5).integers(0, 255, (30, 40, 3), np.uint8)
    p = str(tmp_path / "rgb.tif")
    _raw_tiff(p, rgb, predictor=2, tile=16)
    with tiff.TiffReader(p) as t, jnative.TiffReader(p) as j:
        assert t.samples_per_pixel == 3
        _same(t.read_all("u32"), j.read_all("u32"))
    _same(treaders.read_gray(p), rgb[:, :, 0].astype(np.uint16))


def _patch_tag(path, tag, value, new_tag=None):
    """Set the SHORT value of ``tag`` in a little-endian classic TIFF's
    IFD (and rename the entry ``new_tag``)."""
    data = bytearray(open(path, "rb").read())
    ifd = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[ifd:ifd + 2])[0]
    for k in range(n):
        at = ifd + 2 + 12 * k
        if struct.unpack("<H", data[at:at + 2])[0] == tag:
            data[at:at + 12] = struct.pack("<HHIHH", new_tag or tag, 3, 1,
                                           value, 0)
            open(path, "wb").write(bytes(data))
            return
    raise KeyError(tag)


@pytest.mark.parametrize("case", ["not-tiff", "truncated", "jpeg",
                                  "float-predictor", "bits12", "old-lzw",
                                  "bad-lzw", "bad-deflate", "fill-order"])
def test_unreadable_files_raise(tmp_path, case):
    """Corrupt or unsupported files raise IOError naming what is wrong."""
    a = _image(np.uint16, h=40, w=50)
    p = str(tmp_path / "x.tif")
    _raw_tiff(p, a, tile=16, comp=8 if case == "bad-deflate" else 5)
    want = {"not-tiff": "not a TIFF", "truncated": "truncated",
            "jpeg": "Compression (tag 259) = 7",
            "float-predictor": "Predictor (tag 317) = 3",
            "bits12": "BitsPerSample (tag 258) = 12",
            "old-lzw": "old-style LZW", "bad-lzw": "corrupt LZW",
            "bad-deflate": "corrupt Deflate",
            "fill-order": "FillOrder (tag 266) = 2"}[case]
    if case == "not-tiff":
        open(p, "wb").write(b"\x89PNG\r\n\x1a\n" + bytes(100))
    elif case == "jpeg":
        _patch_tag(p, 259, 7)
    elif case == "float-predictor":
        _patch_tag(p, 317, 3)
    elif case == "bits12":
        _patch_tag(p, 258, 12)
    elif case == "fill-order":
        # the PhotometricInterpretation entry becomes FillOrder = 2 (the
        # entries stay sorted)
        _patch_tag(p, 262, 2, new_tag=266)
    else:
        with tiff.TiffReader(p) as t:
            at = int(t._offsets[-1])
        data = bytearray(open(p, "rb").read())
        if case == "truncated":
            data = data[:at + 3]          # the last tile and the IFD cut
        elif case == "old-lzw":
            data[at:at + 2] = b"\x00\x01"
        elif case == "bad-lzw":
            data[at:at + 4] = b"\x80\x3f\xff\xff"  # Clear, then code 4095
        else:
            data[at:at + 8] = b"\xff" * 8
        open(p, "wb").write(bytes(data))
    with pytest.raises(IOError, match=re.escape(want)):
        with tiff.TiffReader(p) as t:
            t.read_all()


def test_block_cache_is_bounded(tmp_path, monkeypatch):
    """The LRU of decoded blocks stays under its cap (one block over at
    most) and serves repeated regions without decoding again."""
    a = _image(np.uint16, h=256, w=256)
    p = str(tmp_path / "c.tif")
    tiff.write_tiff(p, a, tile_size=32)
    monkeypatch.setattr(tiff, "CACHE_CAP_BYTES", 5 * 32 * 32 * 2)
    with tiff.TiffReader(p) as t:
        calls = []
        decode = t._decode
        t._decode = lambda k, rows: calls.append(k) or decode(k, rows)
        for y in range(0, 256, 20):
            for x in range(0, 256, 20):
                np.testing.assert_array_equal(
                    t.read_region(y, x, 20, 20, "u32")[:256 - y, :256 - x],
                    a[y:y + 20, x:x + 20])
                assert t._cache_bytes <= tiff.CACHE_CAP_BYTES
        n = len(calls)
        t.read_region(250, 250, 4, 4, "u32")
        assert len(calls) == n            # the last block is still cached


def test_pair_source_threads(tmp_path):
    """Many threads reading one TiffPairSource's regions at once, with a
    short switch interval, all get the right pixels (its lock serialises
    the readers' handles and caches)."""
    a = _image(np.uint16, h=200, w=230)
    lab = (a % 7).astype(np.uint16)
    ip, lp = str(tmp_path / "i.tif"), str(tmp_path / "l.tif")
    tiff.write_tiff(ip, a, tile_size=32)
    tiff.write_tiff(lp, lab, tile_size=64, compression="deflate")
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with TiffPairSource(ip, lp) as src:
            def work(seed):
                r = np.random.default_rng(seed)
                for _ in range(40):
                    y, x = r.integers(0, 200), r.integers(0, 230)
                    ii, ll = src.read_pair(y, x, 33, 47)
                    h, w = min(33, 200 - y), min(47, 230 - x)
                    if not (np.array_equal(ii[:h, :w], a[y:y + h, x:x + w])
                            and np.array_equal(ll[:h, :w],
                                               lab[y:y + h, x:x + w])
                            and not ii[h:].any() and not ll[:, w:].any()):
                        errors.append((y, x))
            threads = [threading.Thread(target=work, args=(s,))
                       for s in range(3 * (os.cpu_count() or 1))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:5]


def test_read_gray_other_formats(tmp_path):
    """Non-TIFF images go through PIL; an OME-Zarr container (a ``.zarr``
    path or any directory) and a DICOM file through the copies of the JAX
    package's readers: each equal to JAX's read_gray."""
    from nyxus_tpu_torch.io.dicom import write_dicom_gray
    from nyxus_tpu_torch.io.zarr import write_zarr
    a = np.arange(600, dtype=np.uint16).reshape(20, 30)
    p = str(tmp_path / "m.png")
    treaders.write_gray(p, a)
    _same(treaders.read_gray(p), jreaders.read_gray(p))
    q = str(tmp_path / "m.tif")
    treaders.write_gray(q, a)
    _same(treaders.read_gray(q), a)
    for name in ("x.zarr", "plain_dir"):
        z = str(tmp_path / name)
        write_zarr(z, a, chunks=(1, 1, 1, 16, 16))
        _same(treaders.read_gray(z), jreaders.read_gray(z))
        _same(treaders.read_gray(z), a)
    for ext, arr, kw in ((".dcm", a, {}),
                         (".dicom", a.astype(np.int16) - 300,
                          {"intercept": -1024.0})):
        d = str(tmp_path / ("x" + ext))
        write_dicom_gray(d, arr, **kw)
        _same(treaders.read_gray(d), jreaders.read_gray(d))


def test_codec_entry_points_match_declarations():
    """The ctypes types bound for the codec's C entry points are their
    declarations' in tiff_codec.cpp, in number and kind."""
    with open(os.path.join(os.path.dirname(tnative.__file__), "src",
                           "tiff_codec.cpp")) as f:
        text = f.read()
    kinds = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}
    found = re.findall(r"^(int64_t|int) (nyx_\w+)\(([^)]*)\)", text, re.M)
    assert len(found) == 4
    for ret, name, params in found:
        args = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
                for p in (" ".join(q.split()) for q in params.split(","))]
        assert tnative._SIGNATURES[name] == (kinds[ret], args), name
