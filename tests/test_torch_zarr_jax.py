"""The port's OME-Zarr support against the JAX package's, on the CPU:

- the chunk codec (``native/src/zarr_codec.cpp``, the JAX package's less
  zlib, and Python's ``zlib`` for blosc blocks coded with zlib): the same
  containers bit for bit from both writers, the same bytes back from both
  readers, JAX's errors for bitshuffle, blosclz and corrupt streams;
- ``io/zarr.py`` (a verbatim copy) in both directions, each package's
  writer read by the other's reader bit for bit: v2 with no compressor,
  zlib, blosc-LZ4 with shuffle and blosc blocks coded with zlib; v3 with
  gzip chunks, sharded, and blosc inner chunks in shards; region reads
  across chunk edges and past the image; volumes with a time axis;
- ``Nyxus.featurize_files`` on a Zarr pair against JAX's in f64, in memory,
  streamed (``ram_limit=1``: tests/test_stream_sources.py:39's case) and
  in whole-slide mode, and ``Nyxus3D.featurize_files`` on a Zarr volume
  pair (tests/test_formats.py:194's case).

rtol 1e-9 (atol 1e-12), 5e-7 for the fast_log2 entropies, NaN in the same
places, the name and label columns equal."""

import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest

import nyxus_tpu
from nyxus_tpu.io import readers as jreaders
from nyxus_tpu.io import zarr as jzarr

import nyxus_tpu_torch
from nyxus_tpu_torch import native as tnative
from nyxus_tpu_torch.io import readers as treaders
from nyxus_tpu_torch.io import zarr as tzarr
from nyxus_tpu_torch.pipeline import sources as tsources

from test_torch_slice import _compare
from test_torch_3d_files_jax import frames_agree
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native, jax_native_loaded  # noqa: F401 (autouse)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# tests/test_torch_files_jax.py's request (every path of the file protocol)
# and tests/test_stream_sources.py's GLCM member, with GLCM's joint entropy;
# tests/test_torch_slice_jax.py holds *ALL* against JAX
FEATS = ["*ALL_INTENSITY*", "*ALL_MORPHOLOGY*", "*ALL_GLSZM*",
         "WEIGHTED_HU_M1", "EDGE_MEAN_INTENSITY", "ROI_RADIUS_MEAN",
         "GLCM_CONTRAST_AVE", "GLCM_JE_AVE"]
FEATS_3D = ["*3D_ALL_INTENSITY*", "*3D_ALL_MORPHOLOGY*", "*3D_GLCM*",
            "*3D_GLSZM*"]
DTYPES = [np.uint8, np.uint16, np.int16, np.int32, np.float32]


def _image(shape, dtype, seed):
    r = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return (r.normal(100, 40, shape)).astype(dtype)
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -3000), min(info.max, 60000)
    # runs of equal values, so that LZ4 finds matches
    return np.repeat(r.integers(lo, hi, shape[:-1] + (shape[-1] // 4 + 1,)),
                     4, axis=-1)[..., :shape[-1]].astype(dtype)


def blosc_zlib(buf, typesize, blocksize, shuffle=True, stored=()):
    """A c-blosc1 container of ``buf`` whose blocks are coded with zlib
    (codec 3), byte-shuffled a block, the blocks numbered in ``stored``
    kept raw (coded size equal to the block's size)."""
    n = len(buf)
    nblocks = -(-n // blocksize)
    payloads = []
    for b in range(nblocks):
        blk = buf[b * blocksize:(b + 1) * blocksize]
        if shuffle and len(blk) % typesize == 0:
            blk = np.frombuffer(blk, np.uint8).reshape(-1, typesize).T \
                .tobytes()
        c = blk if b in stored else zlib.compress(blk, 6)
        assert b in stored or len(c) != len(blk)
        payloads.append(struct.pack("<i", len(c)) + c)
    starts, off = [], 16 + 4 * nblocks
    for p in payloads:
        starts.append(off)
        off += len(p)
    flags = (1 if shuffle else 0) | (3 << 5)
    return (bytes([2, 1, flags, typesize])
            + struct.pack("<iii", n, blocksize, off)
            + struct.pack("<%di" % nblocks, *starts) + b"".join(payloads))


# -- the chunk codec -------------------------------------------------------


@pytest.mark.parametrize("typesize,shuffle", [(1, True), (2, True),
                                              (4, False), (8, True)])
def test_blosc_lz4_equals_jax(typesize, shuffle):
    """The LZ4 writer makes JAX's bytes; each package reads both."""
    jn = jax_native()
    r = np.random.default_rng(typesize)
    for n in (0, 7, 4096, 100003):
        buf = np.repeat(r.integers(0, 255, n // 3 + 1, np.uint8),
                        3)[:n].tobytes()
        n -= n % typesize
        buf = buf[:n]
        t = tnative.blosc_compress_lz4(buf, typesize, shuffle)
        assert t == jn.blosc_compress_lz4(buf, typesize, shuffle)
        assert tnative.blosc_decompress(t, n) == buf
        assert jn.blosc_decompress(t, n) == buf


@pytest.mark.parametrize("typesize,blocksize,stored", [
    (2, 4096, ()), (2, 1000, (1,)), (4, 3000, (0, 2)), (1, 65536, ()),
    (3, 999, ())])
def test_blosc_zlib_blocks_equal_jax(typesize, blocksize, stored):
    """Blocks coded with zlib: the port inflates them in Python, JAX in
    C++ through zlib; both give the bytes that were coded."""
    jn = jax_native()
    r = np.random.default_rng(blocksize)
    buf = np.repeat(r.integers(0, 60000, 3000, np.uint16), 2).tobytes()
    buf = buf[:len(buf) - len(buf) % typesize]
    c = blosc_zlib(buf, typesize, blocksize, stored=stored)
    assert tnative.blosc_decompress(c, len(buf)) == buf
    assert jn.blosc_decompress(c, len(buf)) == buf


def _errors(buf, n):
    out = []
    for mod in (tnative, jax_native()):
        try:
            mod.blosc_decompress(buf, n)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def test_blosc_errors_equal_jax():
    """Bitshuffle, blosclz and corrupt or truncated streams raise JAX's
    errors, whichever codec the blocks carry."""
    buf = np.arange(5000, dtype=np.uint16).tobytes()
    lz4 = tnative.blosc_compress_lz4(buf, 2, True)
    zl = blosc_zlib(buf, 2, 4096)
    bitshuffle = bytearray(lz4)
    bitshuffle[2] |= 0x4
    blosclz = bytearray(lz4)
    blosclz[2] &= 0x1F
    cases = {
        "bitshuffle": (bytes(bitshuffle), "bitshuffle"),
        "blosclz": (bytes(blosclz), "inner codec"),
        "short header": (lz4[:10], "corrupt"),
        "lz4 truncated": (lz4[:len(lz4) // 2], "corrupt"),
        "zlib truncated": (zl[:len(zl) - 40], "corrupt"),
        "zlib garbage": (zl[:40] + bytes(len(zl) - 40), "corrupt"),
        "zlib block offset": (zl[:16] + struct.pack("<i", len(zl) + 9)
                              + zl[20:], "corrupt"),
        "over the output": (lz4, "corrupt"),
    }
    for name, (data, msg) in cases.items():
        n = len(buf) - 2 if name == "over the output" else len(buf)
        t, j = _errors(data, n)
        assert t == j and t is not None and msg in t, (name, t, j)


def test_zarr_codec_entry_points_match_declarations():
    """The ctypes types bound for zarr_codec.cpp's C entry points are their
    declarations', in number and kind."""
    import ctypes
    import re
    with open(os.path.join(os.path.dirname(tnative.__file__), "src",
                           "zarr_codec.cpp")) as f:
        text = f.read()
    found = re.findall(r"^int (nyx_\w+)\(([^)]*)\)", text, re.M)
    assert len(found) == 4
    for name, params in found:
        args = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in (" ".join(q.split()) for q in params.split(","))]
        assert tnative._SIGNATURES[name] == (ctypes.c_int, args), name


# -- io/zarr.py both ways ---------------------------------------------------


def _write_v2_blosc_zlib(path, arr, chunks):
    """``arr`` as OME-Zarr v2 whose chunks are blosc containers of zlib
    blocks: write_zarr's layout, each chunk coded again."""
    tzarr.write_zarr(path, arr, chunks=chunks, compressor=None)
    ds = os.path.join(path, "0")
    with open(os.path.join(ds, ".zarray")) as f:
        meta = json.load(f)
    meta["compressor"] = {"id": "blosc", "cname": "zlib", "clevel": 5,
                          "shuffle": 1, "blocksize": 0}
    with open(os.path.join(ds, ".zarray"), "w") as f:
        json.dump(meta, f)
    for name in os.listdir(ds):
        if not name.startswith("."):
            p = os.path.join(ds, name)
            with open(p, "rb") as f:
                raw = f.read()
            with open(p, "wb") as f:
                f.write(blosc_zlib(raw, arr.dtype.itemsize, 3000))


WRITERS = {
    "v2 none": lambda m, p, a: m.write_zarr(p, a, chunks=(1, 1, 1, 48, 40),
                                            compressor=None),
    "v2 zlib": lambda m, p, a: m.write_zarr(p, a, chunks=(1, 1, 1, 48, 40),
                                            compressor="zlib"),
    "v2 blosc-lz4": lambda m, p, a: m.write_zarr(p, a,
                                                 chunks=(1, 1, 1, 48, 40)),
    "v3 gzip": lambda m, p, a: m.write_zarr_v3(p, a,
                                               chunks=(1, 1, 1, 32, 48)),
    "v3 sharded": lambda m, p, a: m.write_zarr_v3(
        p, a, chunks=(1, 1, 1, 16, 16), shards=(1, 1, 1, 32, 48)),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("codec", list(WRITERS))
def test_zarr_both_ways(tmp_path, codec, dtype):
    """Each package's writer read back by the other's reader, and by its
    own, bit for bit; the files of both writers are the same bytes."""
    jax_native()
    a = _image((101, 130), dtype, 5)
    files = {}
    for name, mod in (("port", tzarr), ("jax", jzarr)):
        p = str(tmp_path / ("%s.zarr" % name))
        WRITERS[codec](mod, p, a)
        files[name] = p
    for p in files.values():
        for mod in (tzarr, jzarr):
            got = mod.OmeZarrReader(p).read_slice()
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(got, a)
        np.testing.assert_array_equal(treaders.read_gray(p),
                                      jreaders.read_gray(p))
    for root, _, names in os.walk(files["port"]):
        for n in names:
            q = os.path.join(files["jax"],
                             os.path.relpath(os.path.join(root, n),
                                             files["port"]))
            with open(os.path.join(root, n), "rb") as f, open(q, "rb") as g:
                assert f.read() == g.read(), n


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("codec", ["v2 blosc-zlib", "v3 blosc shards"])
def test_zarr_hand_built_blosc(tmp_path, codec, dtype):
    """Blosc containers no writer of the packages makes: v2 chunks of zlib
    blocks, v3 shards of blosc-LZ4 inner chunks
    (chip_smoke.write_zarr_v3_blosc_shards): both readers give the array,
    and the same region across chunk and shard edges."""
    jax_native()
    a = _image((90, 111), dtype, 8)
    p = str(tmp_path / "a.zarr")
    if codec == "v2 blosc-zlib":
        _write_v2_blosc_zlib(p, a, (1, 1, 1, 32, 40))
    else:
        chip_smoke.write_zarr_v3_blosc_shards(p, a, (1, 1, 1, 16, 16),
                                              (1, 1, 1, 32, 48))
    for mod in (tzarr, jzarr):
        z = mod.OmeZarrReader(p)
        np.testing.assert_array_equal(z.read_slice(), a)
        np.testing.assert_array_equal(z.read_plane_region(20, 30, 50, 61),
                                      a[20:70, 30:91])


@pytest.mark.parametrize("codec", ["v2 blosc-lz4", "v3 sharded"])
def test_region_reads_equal_jax(tmp_path, codec):
    """read_plane_region and ZarrArray.read_region across chunk edges and
    past the image (the fill value there), and ZarrPairSource.read_pair,
    equal to JAX's."""
    from nyxus_tpu.pipeline import sources as jsources
    jax_native()
    a = _image((130, 170), np.uint16, 9)
    lab = (a % 7).astype(np.uint16)
    ip, lp = str(tmp_path / "i.zarr"), str(tmp_path / "l.zarr")
    WRITERS[codec](tzarr, ip, a)
    WRITERS[codec](tzarr, lp, lab)
    t, j = tzarr.OmeZarrReader(ip), jzarr.OmeZarrReader(ip)
    ts, js = tsources.ZarrPairSource(ip, lp), jsources.ZarrPairSource(ip, lp)
    assert ts.shape == js.shape == (130, 170)
    assert (ts.int_is_float, ts.int_transfer_u32_ok) == \
        (js.int_is_float, js.int_transfer_u32_ok) == (False, True)
    r = np.random.default_rng(1)
    for _ in range(25):
        y, x = int(r.integers(0, 140)), int(r.integers(0, 180))
        h, w = int(r.integers(1, 90)), int(r.integers(1, 90))
        got = t.read_plane_region(y, x, h, w)
        np.testing.assert_array_equal(got, j.read_plane_region(y, x, h, w))
        hh, ww = max(0, min(h, 130 - y)), max(0, min(w, 170 - x))
        np.testing.assert_array_equal(got[:hh, :ww], a[y:y + hh, x:x + ww])
        assert not got[hh:].any() and not got[:, ww:].any()
        for k in range(2):
            np.testing.assert_array_equal(ts.read_pair(y, x, h, w)[k],
                                          js.read_pair(y, x, h, w)[k])
        if y + h <= 130 and x + w <= 170:
            np.testing.assert_array_equal(
                t.arr.read_region([0, 0, 0, y, x], [1, 1, 1, h, w]),
                j.arr.read_region([0, 0, 0, y, x], [1, 1, 1, h, w]))
    whole = tsources.ZarrPairSource(ip)
    ii, ll = whole.read_pair(100, 150, 64, 64)
    assert ll[:30, :20].all() and not ll[30:].any() and not ll[:, 20:].any()
    np.testing.assert_array_equal(ii[:30, :20], a[100:, 150:])


def test_zarr_mismatched_pair_raises(tmp_path):
    ip, lp = str(tmp_path / "i.zarr"), str(tmp_path / "l.zarr")
    tzarr.write_zarr(ip, np.zeros((40, 50), np.uint16))
    tzarr.write_zarr(lp, np.zeros((40, 51), np.uint16))
    with pytest.raises(ValueError, match="mismatch"):
        tsources.ZarrPairSource(ip, lp)
    with pytest.raises(ValueError, match="mismatch"):
        nyxus_tpu_torch.Nyxus(["MEAN"], device="cpu", ram_limit=1) \
            .featurize_files([ip], [lp])


@pytest.mark.parametrize("shape,chunks", [
    ((3, 4, 30, 41), (1, 1, 2, 16, 16)),
    ((2, 1, 5, 33, 20), (1, 1, 3, 32, 8)),
    ((6, 17, 25), (1, 1, 4, 8, 32))], ids=str)
def test_volumes_equal_jax(tmp_path, shape, chunks):
    """read_volume of a Zarr directory (any path that is a directory, a
    time axis stacked) and OmeZarrReader.read_volume / read_slice equal
    JAX's, meta included."""
    jax_native()
    vol = _image(shape, np.uint16, 4)
    p = str(tmp_path / "v.zarr")
    tzarr.write_zarr(p, vol, chunks=chunks)
    got, meta = treaders.read_volume(p, with_meta=True)
    want, jmeta = jreaders.read_volume(p, with_meta=True)
    assert meta == jmeta
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(treaders.read_volume(p),
                                  jreaders.read_volume(p))
    v5 = vol.reshape((1,) * (5 - vol.ndim) + vol.shape)
    assert meta["nt"] == v5.shape[0]
    np.testing.assert_array_equal(got, v5[:, 0])
    t, j = tzarr.OmeZarrReader(p), jzarr.OmeZarrReader(p)
    assert t.shape5 == j.shape5 == v5.shape
    np.testing.assert_array_equal(t.read_volume(t=v5.shape[0] - 1),
                                  v5[-1, 0])
    np.testing.assert_array_equal(t.read_slice(t=0, z=v5.shape[2] - 1),
                                  j.read_slice(t=0, z=v5.shape[2] - 1))


# -- featurize_files against JAX --------------------------------------------


def _pair():
    """tests/test_stream_sources.py make_pair(): three ROIs on a 256²
    uint16 slide, over the RAM gate at ram_limit=1."""
    r = np.random.default_rng(11)
    intens = r.integers(1, 40000, (256, 256)).astype(np.uint16)
    labels = np.zeros((256, 256), np.uint16)
    labels[16:120, 20:200] = 1
    labels[140:240, 40:100] = 2
    labels[150:200, 150:250] = 3
    return intens, labels


@pytest.fixture(scope="module")
def zarr_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("zarr")
    intens, labels = _pair()
    ip, lp = str(root / "i.zarr"), str(root / "s.zarr")
    tzarr.write_zarr(ip, intens, chunks=(1, 1, 1, 64, 64))
    tzarr.write_zarr(lp, labels, chunks=(1, 1, 1, 64, 64))
    return ip, lp


PERCENTS = {"P01": 0.01, "P10": 0.10, "P25": 0.25, "P75": 0.75,
            "P90": 0.90, "P99": 0.99}


def percentile_members(v):
    """The 100-bin interpolated percentiles of a ROI's intensities ``v``
    and the members formed from them, by the reference formula
    (histogram.h:50-62, 86-106, 300-327) in float64, each operation rounded
    on its own."""
    v = np.sort(np.asarray(v, np.float64))
    vmin, n = v[0], len(v)
    binw = (v[-1] - vmin) / 100.0
    idx = np.clip(((v - vmin) / binw).astype(np.int32), 0, 99)
    bins = np.bincount(idx, minlength=100).astype(np.float64)
    run = np.cumsum(bins) - bins
    left = vmin + binw * np.arange(100)
    out = {}
    for name, p in PERCENTS.items():
        cnt = n * p
        k = np.nonzero((run <= cnt) & (cnt <= run + bins))[0][-1]
        out[name] = (cnt - run[k]) * binw / bins[k] + left[k]
    out["INTERQUARTILE_RANGE"] = out["P75"] - out["P25"]
    out["QCOD"] = out["INTERQUARTILE_RANGE"] / (out["P75"] + out["P25"])
    mid = v[(v >= out["P10"]) & (v <= out["P90"])]
    out["ROBUST_MEAN"] = mid.mean()
    out["ROBUST_MEAN_ABSOLUTE_DEVIATION"] = np.abs(mid - mid.mean()).mean()
    return out


def frames_equal(got, want, pixels=None):
    """Frames equal in their name and label columns, their values within
    the tolerances.  XLA rewrites the percentile histogram's bin index
    ``(v - vmin) / binw`` of the JAX package, which can put an integer
    intensity on a bin edge into the bin below: in a row whose percentiles
    are not JAX's bit for bit, the port's percentile members are held
    against ``percentile_members`` over ``pixels(row)`` (the row's ROI
    intensities) instead."""
    assert list(got.columns) == list(want.columns)
    for c in want.columns[:4]:
        assert list(got[c]) == list(want[c]), c
    cols = list(want.columns[4:])
    w, g = want[cols].to_numpy(float).copy(), got[cols].to_numpy(float)
    pct = [cols.index(c) for c in PERCENTS if c in cols]
    for r in np.nonzero((g[:, pct] != w[:, pct]).any(axis=1))[0]:
        ref = percentile_members(pixels(got.iloc[r]))
        for c, x in ref.items():
            if c in cols:
                np.testing.assert_allclose(g[r, cols.index(c)], x,
                                           rtol=1e-9, err_msg=c)
                w[r, cols.index(c)] = g[r, cols.index(c)]
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    fin = ~np.isnan(w)
    _compare(cols, np.where(fin, w, 0), np.where(fin, g, 0))


def pair_pixels(intens, labels):
    """pixels(row) of frames_equal over an in-memory pair; a whole-slide
    row (no mask) takes every pixel."""
    return lambda row: intens[labels == row.ROI_label] \
        if row.mask_image else intens.ravel()


@pytest.mark.parametrize("mode", ["in-memory", "streamed", "whole-slide"])
def test_featurize_files_equals_jax(zarr_pair, mode, monkeypatch):
    """In memory, over the RAM gate (the port's run_streamed through
    ZarrPairSource, as JAX's) and whole-slide streamed: JAX's rows."""
    jax_native()
    kw = dict(precision="f64")
    if mode != "in-memory":
        kw["ram_limit"] = 1
    ip, lp = zarr_pair
    single = mode == "whole-slide"
    want = nyxus_tpu.Nyxus(FEATS, **kw).featurize_files([ip], [lp], single)
    nyx = nyxus_tpu_torch.Nyxus(FEATS, device="cpu", **kw)
    calls = []
    run_streamed = nyx._runner.run_streamed
    monkeypatch.setattr(nyx._runner, "run_streamed",
                        lambda src, **k: calls.append(type(src).__name__)
                        or run_streamed(src, **k))
    got = nyx.featurize_files([ip], [lp], single)
    assert calls == ([] if mode == "in-memory" else ["ZarrPairSource"])
    assert len(got) == (1 if single else 3)
    pixels = pair_pixels(*_pair())
    frames_equal(got, want, pixels)
    if mode == "streamed":
        mem = nyxus_tpu_torch.Nyxus(FEATS, device="cpu",
                                    precision="f64").featurize(*_pair())
        np.testing.assert_array_equal(got.iloc[:, 4:].to_numpy(float),
                                      mem.iloc[:, 4:].to_numpy(float))


def test_3d_featurize_files_equals_jax(tmp_path):
    """tests/test_formats.py:194's volumes, OME-Zarr v2 (zlib), through
    Nyxus3D.featurize_files: JAX's rows, and whole-volume mode."""
    jax_native()
    r = np.random.default_rng(6)
    ivol = r.integers(1, 500, (3, 30, 40)).astype(np.uint16)
    lvol = np.zeros((3, 30, 40), np.uint16)
    lvol[:, 5:25, 5:35] = 3
    lvol[1:, 2:9, 30:38] = 5
    ip, lp = str(tmp_path / "iv.zarr"), str(tmp_path / "lv.zarr")
    tzarr.write_zarr(ip, ivol, compressor="zlib")
    tzarr.write_zarr(lp, lvol, compressor="zlib")
    for single in (False, True):
        got = nyxus_tpu_torch.Nyxus3D(FEATS_3D, device="cpu",
                                      precision="f64").featurize_files(
            [ip], [lp], single_roi=single)
        want = nyxus_tpu.Nyxus3D(FEATS_3D, precision="f64").featurize_files(
            [ip], [lp], single_roi=single)
        frames_agree(got, want, pair_pixels(ivol.astype(np.float64), lvol))
        assert got.ROI_label.tolist() == ([1] if single else [3, 5])
    assert got["3MEAN"].iloc[0] == pytest.approx(ivol.mean())
