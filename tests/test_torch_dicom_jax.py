"""The port's DICOM support against the JAX package's, on the CPU:

- ``read_dicom`` (``io/dicom.py``, a verbatim copy) equal to JAX's, pixels
  and meta, on every case of tests/test_formats.py:55-240: the sample
  types, Hounsfield rescale, RLE Lossless, signed 8-bit RLE, JPEG
  baseline, JPEG-LS (``io/jpegls.py`` over the system CharLS; skipped as
  JAX's test skips where it is absent), and implicit VR and MONOCHROME1;
  the same errors for transfer syntaxes neither reads and where CharLS is
  missing;
- ``DicomTiledReader`` regions and ``DicomPairSource`` equal to JAX's;
- ``Nyxus.featurize_files`` on tiled, single-frame and signed Hounsfield
  pairs (``featurize_pair``) against JAX's in f64, in memory and at
  ``ram_limit=1`` (a tiled pair streams through ``DicomPairSource``, a
  single-frame one is decoded whole).  A tiled multi-frame file decoded whole is its whole pixel
  matrix in the port; JAX's ``read_gray`` returns its first frame, so the
  port's in-memory rows of a tiled pair are held against JAX's
  ``featurize`` of the decoded arrays;
tests/test_torch_dicom_files_jax.py holds a signed tiled pair, the
Hounsfield map, mixed formats and the CLI the same way, so that ``--dist
loadfile`` gives those JAX references a worker of their own.

rtol 1e-9 (atol 1e-12), 5e-7 for the fast_log2 entropies, NaN in the same
places, the name and label columns equal."""

import io
import os
import struct
import sys

import numpy as np
import pytest

import nyxus_tpu
from nyxus_tpu.io import dicom as jdicom
from nyxus_tpu.io import jpegls as jjpegls
from nyxus_tpu.io import readers as jreaders
from nyxus_tpu.pipeline import sources as jsources

import nyxus_tpu_torch
from nyxus_tpu_torch.io import dicom as tdicom
from nyxus_tpu_torch.io import jpegls as tjpegls
from nyxus_tpu_torch.io import readers as treaders
from nyxus_tpu_torch.pipeline import sources as tsources

from test_formats import _encapsulate, _rle_encode
from test_torch_zarr_jax import FEATS, _pair, frames_equal, pair_pixels
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

RLE = "1.2.840.10008.1.2.5"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
JPEGLS = "1.2.840.10008.1.2.4.80"


def _implicit(arr):
    """A single-frame implicit-VR little-endian DICOM of ``arr`` (file meta
    explicit, the data set without VRs)."""
    meta = jdicom._el(0x0002, 0x0010, b"UI", jdicom.IMPLICIT_LE.encode())

    def el(group, elem, val):
        if len(val) % 2:
            val += b"\x00"
        return struct.pack("<HHI", group, elem, len(val)) + val
    bits = arr.dtype.itemsize * 8
    body = (el(0x0028, 0x0002, struct.pack("<H", 1))
            + el(0x0028, 0x0004, b"MONOCHROME2")
            + el(0x0028, 0x0010, struct.pack("<H", arr.shape[0]))
            + el(0x0028, 0x0011, struct.pack("<H", arr.shape[1]))
            + el(0x0028, 0x0100, struct.pack("<H", bits))
            + el(0x0028, 0x0103, struct.pack("<H", int(arr.dtype.kind == "i")))
            + el(0x7FE0, 0x0010, arr.tobytes()))
    return b"\x00" * 128 + b"DICM" + meta + body


def _gray(arr, **kw):
    def make(path):
        tdicom.write_dicom_gray(path, arr, **kw)
    return make


def _bytes(data):
    def make(path):
        with open(path, "wb") as f:
            f.write(data)
    return make


def _jpeg():
    from PIL import Image
    yy, xx = np.mgrid[0:48, 0:64]
    img = (120 + 80 * np.sin(yy / 9.0) * np.cos(xx / 11.0)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _monochrome1(arr):
    def make(path):
        tdicom.write_dicom_gray(path, arr)
        with open(path, "rb") as f:
            data = f.read()
        assert data.count(b"MONOCHROME2") == 1
        with open(path, "wb") as f:
            f.write(data.replace(b"MONOCHROME2", b"MONOCHROME1"))
    return make


def _cases():
    r = np.random.default_rng(4)
    out = {}
    for dt, lo, hi in ((np.uint8, 0, 250), (np.int8, -100, 100),
                       (np.uint16, 0, 60000), (np.int16, -900, 2000),
                       (np.uint32, 0, 1 << 31), (np.int32, -70000, 70000)):
        out["native %s" % np.dtype(dt).name] = _gray(
            r.integers(lo, hi, (64, 80)).astype(dt))
    stored = r.integers(0, 4000, (32, 32)).astype(np.uint16)
    out["hounsfield"] = _gray(stored, slope=1.0, intercept=-1024.0)
    out["hounsfield signed"] = _gray((stored.astype(np.int32) - 2000)
                                     .astype(np.int16), intercept=-1024.0)
    out["rescale fractional"] = _gray(stored, slope=0.5, intercept=-10.25)
    out["monochrome1"] = _monochrome1(stored)
    out["implicit VR"] = _bytes(_implicit(
        r.integers(0, 60000, (21, 17)).astype(np.uint16)))
    img = r.integers(0, 60000, (37, 23)).astype(np.uint16)
    out["RLE 16-bit"] = _bytes(_encapsulate(RLE, _rle_encode(img), 37, 23,
                                            16))
    img8 = r.integers(-100, 100, (16, 16)).astype(np.int8)
    out["RLE signed 8-bit"] = _bytes(_encapsulate(
        RLE, _rle_encode(img8.view(np.uint8)), 16, 16, 8, signed=1))
    jpg = _jpeg()
    out["JPEG baseline"] = _bytes(_encapsulate(JPEG_BASELINE, jpg, 48, 64, 8))
    out["JPEG extended"] = _bytes(_encapsulate(JPEG_EXTENDED, jpg, 48, 64, 8))
    if jjpegls.available():
        img = r.integers(0, 4000, (41, 29)).astype(np.uint16)
        out["JPEG-LS"] = _bytes(_encapsulate(
            JPEGLS, jjpegls.encode(img, bits=16), 41, 29, 16))
        img = r.integers(-500, 1500, (24, 31)).astype(np.int16)
        out["JPEG-LS signed"] = _bytes(_encapsulate(
            JPEGLS, jjpegls.encode(img.view(np.uint16), bits=16), 24, 31, 16,
            signed=1))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_read_dicom_equals_jax(tmp_path, case):
    p = str(tmp_path / "a.dcm")
    CASES[case](p)
    got, meta = tdicom.read_dicom(p)
    want, jmeta = jdicom.read_dicom(p)
    assert meta == jmeta
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    g, w = treaders.read_gray(p), jreaders.read_gray(p)
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


def test_jpegls_codec_equals_jax():
    """CharLS loads in both (this machine has libcharls.so.2) or in
    neither; where it loads, both encode and decode alike."""
    assert tjpegls.available() == jjpegls.available()
    if not tjpegls.available():
        pytest.skip("libcharls not present")
    img = np.random.default_rng(2).integers(0, 4000, (19, 23)) \
        .astype(np.uint16)
    enc = tjpegls.encode(img, bits=16)
    assert enc == jjpegls.encode(img, bits=16)
    np.testing.assert_array_equal(tjpegls.decode(enc), img)


def test_smoke_dicom_writers_are_the_tests():
    """chip_smoke's copies of tests/test_formats.py's RLE encoder and
    encapsulated-file writer make the same bytes."""
    img = np.random.default_rng(3).integers(0, 60000, (33, 19)) \
        .astype(np.uint16)
    assert chip_smoke.rle_frame(img) == _rle_encode(img)
    frag = chip_smoke.rle_frame(img)
    assert chip_smoke.dicom_encapsulated(RLE, frag, 33, 19, 16) == \
        _encapsulate(RLE, frag, 33, 19, 16)
    assert chip_smoke.dicom_encapsulated(JPEGLS, b"abc", 3, 1, 8, 1) == \
        _encapsulate(JPEGLS, b"abc", 3, 1, 8, 1)


def _errors(path):
    out = []
    for mod in (tdicom, jdicom):
        try:
            mod.read_dicom(path)
            out.append(None)
        except ValueError as e:
            out.append(str(e).replace(path, "<path>"))
    return out


@pytest.mark.parametrize("ts", ["1.2.840.10008.1.2.2",
                                "1.2.840.10008.1.2.1.99",
                                "1.2.840.10008.1.2.4.70",
                                "1.2.840.10008.1.2.4.100"])
def test_unsupported_syntax_raises_as_jax(tmp_path, ts):
    """Big endian, deflated, JPEG lossless and MPEG2: JAX's error."""
    p = str(tmp_path / "bad.dcm")
    with open(p, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM"
                + tdicom._el(0x0002, 0x0010, b"UI", ts.encode()))
    t, j = _errors(p)
    assert t == j and "unsupported DICOM transfer syntax" in t


def test_not_dicom_and_no_charls_raise_as_jax(tmp_path, monkeypatch):
    """A file without the DICM preamble, and JPEG-LS where CharLS is not
    found (available() False): JAX's errors."""
    p = str(tmp_path / "x.dcm")
    with open(p, "wb") as f:
        f.write(b"\x00" * 200)
    t, j = _errors(p)
    assert t == j and "not a DICOM part-10 file" in t
    with open(p, "wb") as f:
        f.write(_encapsulate(JPEGLS, b"\xff\xd8\xff\xd9", 3, 4, 16))
    for mod in (tjpegls, jjpegls):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    assert not tjpegls.available()
    t, j = _errors(p)
    assert t == j and "CharLS" in t


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.int32],
                         ids=lambda d: np.dtype(d).name)
def test_tiled_reader_equals_jax(tmp_path, dtype):
    """DicomTiledReader's regions (across frames, past the matrix) and
    DicomPairSource's pairs equal JAX's; read_gray of a tiled file is its
    whole matrix in the port, the first frame in JAX; a single-frame file
    is refused with the message the port's file protocol keys on."""
    r = np.random.default_rng(7)
    info = np.iinfo(dtype)
    a = r.integers(max(info.min, -5000), min(info.max, 50000),
                   (200, 300)).astype(dtype)
    lab = (a % 5).astype(np.uint16)
    ip, lp = str(tmp_path / "i.dcm"), str(tmp_path / "l.dcm")
    tdicom.write_dicom_tiled(ip, a, tile=64)
    jdicom.write_dicom_tiled(lp, lab, tile=64)
    with open(ip, "rb") as f:
        port_bytes = f.read()
    jdicom.write_dicom_tiled(str(tmp_path / "j.dcm"), a, tile=64)
    with open(str(tmp_path / "j.dcm"), "rb") as f:
        assert f.read() == port_bytes
    with tdicom.DicomTiledReader(ip) as t, jdicom.DicomTiledReader(ip) as j:
        assert (t.height, t.width, t.n_frames) == (j.height, j.width,
                                                   j.n_frames) == (200, 300,
                                                                   20)
        for _ in range(20):
            y, x = int(r.integers(0, 210)), int(r.integers(0, 310))
            h, w = int(r.integers(1, 150)), int(r.integers(1, 150))
            got = t.read_region(y, x, h, w)
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(got, j.read_region(y, x, h, w))
            hh, ww = max(0, min(h, 200 - y)), max(0, min(w, 300 - x))
            np.testing.assert_array_equal(got[:hh, :ww],
                                          a[y:y + hh, x:x + ww])
    ts, js = tsources.DicomPairSource(ip, lp), jsources.DicomPairSource(ip, lp)
    assert ts.shape == js.shape == (200, 300)
    assert ts.int_transfer_u32_ok == js.int_transfer_u32_ok == \
        (a.dtype.kind == "u")
    for y, x, h, w in ((0, 0, 200, 300), (50, 250, 100, 100), (190, 1, 9, 64)):
        for k in range(2):
            np.testing.assert_array_equal(ts.read_pair(y, x, h, w)[k],
                                          js.read_pair(y, x, h, w)[k])
    whole = tsources.DicomPairSource(ip)
    assert whole.read_pair(150, 250, 64, 64)[1].sum() == 50 * 50
    ts.close(), js.close(), whole.close()
    np.testing.assert_array_equal(treaders.read_gray(ip), a)
    np.testing.assert_array_equal(jreaders.read_gray(ip), a[:64, :64])
    sp = str(tmp_path / "single.dcm")
    tdicom.write_dicom_gray(sp, a)
    for mod in (tdicom, jdicom):
        with pytest.raises(ValueError) as e:
            mod.DicomTiledReader(sp)
        assert str(e.value) == treaders.UNTILED_DICOM


def _write_pairs(root):
    """{kind: (intensity path, mask path, the intensities the port's file
    protocol decodes)} on tests/test_stream_sources.py's 256² pair."""
    intens, labels = _pair()
    out = {}
    ip, lp = str(root / "tiled_i.dcm"), str(root / "tiled_l.dcm")
    tdicom.write_dicom_tiled(ip, intens, tile=128)
    tdicom.write_dicom_tiled(lp, labels, tile=128)
    out["tiled"] = (ip, lp, intens)
    signed = (intens.astype(np.int32) - 20000).astype(np.int16)
    ip, sp = str(root / "tiled_signed_i.dcm"), str(root / "single_l.dcm")
    tdicom.write_dicom_tiled(ip, signed, tile=96)
    out["tiled signed"] = (ip, lp, signed)
    tdicom.write_dicom_gray(sp, labels)
    ip = str(root / "single_i.dcm")
    tdicom.write_dicom_gray(ip, intens)
    out["single-frame"] = (ip, sp, intens)
    ip = str(root / "hu_i.dcm")
    tdicom.write_dicom_gray(ip, signed, slope=1.0, intercept=-1024.0)
    out["signed HU"] = (ip, sp, signed.astype(np.int32) - 1024)
    ip = str(root / "hu_u_i.dcm")
    tdicom.write_dicom_gray(ip, intens, intercept=-1024.0)
    out["unsigned HU"] = (ip, sp, intens.astype(np.int32) - 1024)
    return out


@pytest.fixture(scope="module")
def dicom_pairs(tmp_path_factory):
    return _write_pairs(tmp_path_factory.mktemp("dicom"))


@pytest.mark.parametrize("ram_limit", [None, 1], ids=["in-memory",
                                                      "ram_limit=1"])
@pytest.mark.parametrize("kind", ["tiled", "single-frame", "signed HU"])
def test_featurize_files_equals_jax(dicom_pairs, kind, ram_limit,
                                    monkeypatch):
    featurize_pair(dicom_pairs, kind, ram_limit, monkeypatch)


def featurize_pair(dicom_pairs, kind, ram_limit, monkeypatch):
    """JAX's rows; a tiled pair at ram_limit=1 streams through
    DicomPairSource, every other case is decoded whole (a single-frame
    file through read_dicom, with _prep_intensity's shift of signed and
    Hounsfield data); in memory a tiled pair is held against JAX's
    featurize of the decoded arrays (see above)."""
    ip, lp, seen = dicom_pairs[kind]
    kw = dict(precision="f64")
    if ram_limit:
        kw["ram_limit"] = ram_limit
    streams = kind.startswith("tiled")
    labels = _pair()[1]
    if streams and not ram_limit:
        # JAX's file protocol would read the first frame alone: its
        # featurize of the decoded pair (int32, which JAX's shift does not
        # wrap), named as the files
        want = nyxus_tpu.Nyxus(FEATS, **kw).featurize(seen.astype(np.int32),
                                                      labels)
        want["intensity_image"], want["mask_image"] = ip, lp
    else:
        want = nyxus_tpu.Nyxus(FEATS, **kw).featurize_files([ip], [lp])
    nyx = nyxus_tpu_torch.Nyxus(FEATS, device="cpu", **kw)
    calls = []
    run_streamed = nyx._runner.run_streamed
    monkeypatch.setattr(nyx._runner, "run_streamed",
                        lambda src, **k: calls.append(type(src).__name__)
                        or run_streamed(src, **k))
    got = nyx.featurize_files([ip], [lp])
    streamed = streams and bool(ram_limit)
    assert calls == (["DicomPairSource"] if streamed else [])
    assert len(got) == 3
    pix = seen.astype(np.float64)
    if not streamed and pix.min() < 0:
        pix = pix - pix.min()          # _prep_intensity's shift
    frames_equal(got, want, pair_pixels(pix, labels))
