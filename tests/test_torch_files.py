"""The port's 2D file protocol on the CPU: dataset pairing, the mapping
file and the layout-A string pattern against the JAX package's
(tests/test_io_cli.py's cases), tile-streamed ROI discovery against JAX's,
and ``Nyxus.featurize_directory`` / ``featurize_files`` against the port's
own ``featurize`` on the same arrays: pandas, Arrow IPC and Parquet
output, the blacklist, and the tile-streamed run (``ram_limit=1``, and
``PairRunner.run_streamed`` at tile 64 over ROIs on the slide's border and
on tile seams) against the in-memory run at rtol 1e-9."""

import os

import numpy as np
import pandas as pd
import pytest

from conftest import make_blobs

from nyxus_tpu.io import dataset as jds
from nyxus_tpu.io import strpat as jstrpat
from nyxus_tpu.pipeline import labels as jlabels
from nyxus_tpu.pipeline.sources import ArrayPairSource as JArraySource

import nyxus_tpu_torch
from nyxus_tpu_torch import taxonomy as ttx
from nyxus_tpu_torch.config import EngineConfig as TConfig
from nyxus_tpu_torch.io import dataset as tds
from nyxus_tpu_torch.io import readers, strpat as tstrpat
from nyxus_tpu_torch.io.tiff import write_tiff
from nyxus_tpu_torch.pipeline import labels as tlabels
from nyxus_tpu_torch.pipeline.runner import PairRunner
from nyxus_tpu_torch.pipeline.sources import ArrayPairSource, TiffPairSource
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

# device families (intensity, moments) and host ones (contours, hull,
# calipers, edge, weighted moments read the contour distances)
FEATS = ["*ALL_INTENSITY*", "*ALL_MORPHOLOGY*", "WEIGHTED_HU_M1",
         "EDGE_MEAN_INTENSITY", "ROI_RADIUS_MEAN"]


def _pair(k):
    """192 x 176: over the RAM gate at ram_limit=1 (16 B/px > 512 KiB)."""
    intens, labels = make_blobs(192, 176, 8, seed=k)
    labels[:4, 30:60] = 40                 # a ROI on the slide's border
    labels[186:, 160:] = 41                # and one in its corner
    for lab in (40, 41):
        m = labels == lab
        intens[m] = 300 + 37 * np.arange(m.sum()) % 1000
    return intens, labels.astype(np.uint16)


@pytest.fixture(scope="module")
def tiff_dirs(tmp_path_factory):
    """Three pairs, tiled LZW (64-px tiles) and stripped Deflate."""
    root = tmp_path_factory.mktemp("data")
    for d in ("int", "seg"):
        (root / d).mkdir()
    for k in range(3):
        intens, labels = _pair(k)
        name = "img%d.tif" % k
        write_tiff(str(root / "int" / name), intens, tile_size=64)
        write_tiff(str(root / "seg" / name), labels, compression="deflate")
    return str(root / "int"), str(root / "seg")


def _nyx(features=FEATS, **kw):
    return nyxus_tpu_torch.Nyxus(features, device="cpu", precision="f64",
                                 **kw)


@pytest.fixture(scope="module")
def in_memory(tiff_dirs):
    return _nyx().featurize_directory(*tiff_dirs)


def _same_rows(got, want, rtol=0.0):
    assert list(got.columns) == list(want.columns)
    for c in got.columns[:4]:
        assert list(got[c]) == list(want[c]), c
    cols = list(want.columns[4:])
    if rtol:
        np.testing.assert_allclose(got[cols].to_numpy(float),
                                   want[cols].to_numpy(float), rtol=rtol,
                                   atol=1e-12)
    else:
        np.testing.assert_array_equal(got[cols].to_numpy(float),
                                      want[cols].to_numpy(float))


# -- pairing, mapping and string patterns against the JAX package ---------

def _both(fn_t, fn_j, *args):
    """The port's and JAX's result, or both errors' type and message."""
    out = []
    for fn in (fn_t, fn_j):
        try:
            out.append(("ok", fn(*args)))
        except (IOError, ValueError) as e:
            out.append((type(e), str(e)))
    assert out[0] == out[1]
    return out[0]


def test_pairing(tiff_dirs, tmp_path):
    int_dir, seg_dir = tiff_dirs
    ok, (i, l, ws) = _both(tds.read_2d_dataset, jds.read_2d_dataset,
                           int_dir, seg_dir, ".*")
    assert ok == "ok" and len(i) == 3 and not ws
    ok, (_, l2, ws2) = _both(tds.read_2d_dataset, jds.read_2d_dataset,
                             int_dir, int_dir, ".*")
    assert ws2 and all(x == "" for x in l2)
    ok, (i3, _, _) = _both(tds.read_2d_dataset, jds.read_2d_dataset,
                           int_dir, seg_dir, "img[01].tif")
    assert len(i3) == 2
    # the pairing errors: no match, a count mismatch, a missing name,
    # a missing directory
    extra = tmp_path / "seg2"
    extra.mkdir()
    for k in range(2):
        (extra / ("img%d.tif" % k)).write_bytes(b"")
    (extra / "other.tif").write_bytes(b"")
    for args in ((int_dir, seg_dir, "nothing"), (int_dir, str(extra), ".*"),
                 (int_dir, str(extra), "(img[01]|other).tif"),
                 (str(tmp_path / "none"), seg_dir, ".*")):
        ok, _ = _both(tds.read_2d_dataset, jds.read_2d_dataset, *args)
        assert ok != "ok"


def test_mapping(tiff_dirs, tmp_path):
    int_dir, seg_dir = tiff_dirs
    good = tmp_path / "map.txt"
    good.write_text("img0.tif img1.tif\n\nimg2.tif img2.tif\n")
    ok, (i, l, _) = _both(tds.read_2d_mapping, jds.read_2d_mapping, int_dir,
                          seg_dir, str(tmp_path), "map.txt")
    assert ok == "ok" and [os.path.basename(p) for p in l] == \
        ["img1.tif", "img2.tif"]
    for text in ("img0.tif\n", "img0.tif missing.tif\n", ""):
        (tmp_path / "bad.txt").write_text(text)
        ok, _ = _both(tds.read_2d_mapping, jds.read_2d_mapping, int_dir,
                      seg_dir, str(tmp_path), "bad.txt")
        assert ok != "ok"


def test_strpat_layout_a(tmp_path):
    """tests/test_io_cli.py:114-127's string-pattern cases, and a
    layout-A grouping of a directory, equal to JAX's."""
    for cls in (tstrpat.StringPattern, jstrpat.StringPattern):
        sp = cls("BRATS_{d+}_z{set d+}_t{d+}.ome.tif")
        assert sp.good() and sp.is_25d
        assert sp.match("BRATS_001_z004_t002.ome.tif") == \
            ("BRATS_001_z*_t002.ome.tif", "004")
        assert sp.match("BRATS_x_z004_t002.ome.tif") is None
        bad = cls("x{q+}.tif")
        assert not bad.good() and "{Expression}" in bad.ermsg
    names = ["a_z2.tif", "a_z10.tif", "a_z1.tif", "b.tif"]
    assert tstrpat.group_zstack(names, tstrpat.StringPattern(
        "a_z{set d+}.tif")) == {"a_z*.tif": ["1", "2", "10"]}
    for d in ("i", "s"):
        (tmp_path / d).mkdir()
        for n in names:
            (tmp_path / d / n).write_bytes(b"")
    _both(tds.read_3d_layoutA, jds.read_3d_layoutA, str(tmp_path / "i"),
          str(tmp_path / "s"), "a_z{set d+}.tif")


# -- streamed discovery ----------------------------------------------------

@pytest.mark.parametrize("tile", [64, 37, 2048])
def test_discover_streamed_equals_jax(tile):
    """Per-tile partials merged across tiles: the records and slide range
    of JAX's discover_rois_streamed on the same source, and of the
    in-memory discovery."""
    intens, labels = make_blobs(200, 170, 14, seed=9)
    labels[:3, :] = 77                      # one ROI across every tile
    got = tlabels.discover_rois_streamed(ArrayPairSource(intens, labels),
                                         tile)
    want = jlabels.discover_rois_streamed(JArraySource(intens, labels), tile)
    assert got[1:] == want[1:]
    assert [vars(r) for r in got[0]] == [vars(r) for r in want[0]]
    mem = tlabels._discover_rois_np(intens, labels)
    assert [vars(r) for r in got[0]] == [vars(r) for r in mem[0]]
    assert got[1:] == mem[1:]


def test_discover_streamed_empty():
    z = np.zeros((50, 60), np.uint16)
    assert tlabels.discover_rois_streamed(ArrayPairSource(z, z), 16) == \
        jlabels.discover_rois_streamed(JArraySource(z, z), 16)


# -- featurize_directory / featurize_files ---------------------------------

def test_featurize_directory_equals_featurize(tiff_dirs, in_memory):
    """Each slide's rows equal featurize on the decoded arrays, the names
    the file paths; uint16 slides reach the runner as uint16."""
    int_dir, seg_dir = tiff_dirs
    df = in_memory
    assert df.intensity_image.nunique() == 3
    nyx = _nyx()
    for k in range(3):
        ip = os.path.join(int_dir, "img%d.tif" % k)
        lp = os.path.join(seg_dir, "img%d.tif" % k)
        intens, labels = readers.read_gray(ip), readers.read_gray(lp)
        np.testing.assert_array_equal(intens, _pair(k)[0])
        np.testing.assert_array_equal(labels, _pair(k)[1])
        want = nyx.featurize(intens, labels, intensity_names=[ip],
                             label_names=[lp])
        sub = df[df.intensity_image == ip].reset_index(drop=True)
        _same_rows(sub, want)
        I, M, hu = nyx._load_pair_arrays(ip, lp, False)
        assert I.dtype == np.uint16 and M.dtype == np.uint32 and hu == 0.0


def test_arrow_and_parquet_equal_pandas(tiff_dirs, in_memory, tmp_path):
    nyx = _nyx()
    p = nyx.featurize_directory(*tiff_dirs, output_type="parquet",
                                output_path=str(tmp_path))
    assert p.endswith("NyxusFeatures.parquet") and p == nyx.get_parquet_file()
    _same_rows(pd.read_parquet(p), in_memory)
    a = nyx.featurize_directory(*tiff_dirs, output_type="arrowipc",
                                output_path=str(tmp_path / "f.arrow"))
    import pyarrow as pa
    with pa.memory_map(a) as src:
        t = pa.ipc.open_file(src).read_all().to_pandas()
    _same_rows(t, in_memory)
    with pytest.raises(ValueError, match="Invalid output type"):
        nyx.featurize_directory(*tiff_dirs, output_type="csv")


def test_blacklist(tiff_dirs):
    """tests/test_io_cli.py:75-89 through the port: blacklisted labels keep
    their row with -0.0; a per-file list names the mask's basename."""
    nyx = _nyx(["MEAN"])
    nyx.blacklist_roi("1,2")
    df = nyx.featurize_directory(*tiff_dirs)
    b = df[df.ROI_label.isin([1, 2])]
    assert len(b) > 0 and (b.MEAN == -0.0).all()
    assert (df[~df.ROI_label.isin([1, 2])].MEAN > 0).all()
    assert "global blacklist: 1,2" in nyx.roi_blacklist_get_summary()
    nyx.clear_roi_blacklist()
    nyx.blacklist_roi("img1.tif:3")
    df = nyx.featurize_directory(*tiff_dirs)
    hit = df.mask_image.str.endswith("img1.tif") & (df.ROI_label == 3)
    assert hit.sum() == 1 and (df[hit].MEAN == -0.0).all()
    assert (df[~hit].MEAN > 0).all()


def test_featurize_files_equals_directory(tiff_dirs, in_memory):
    int_dir, seg_dir = tiff_dirs
    names = ["img%d.tif" % k for k in range(3)]
    df = _nyx().featurize_files([os.path.join(int_dir, n) for n in names],
                                [os.path.join(seg_dir, n) for n in names])
    _same_rows(df, in_memory)


def test_streamed_equals_in_memory(tiff_dirs, in_memory):
    """ram_limit=1 puts every pair over the RAM gate (and shrinks the
    batch budget, so more buckets): the streamed run equals the in-memory
    run at rtol 1e-9, and every pair took run_streamed."""
    nyx = _nyx(ram_limit=1)
    streamed = []
    run_streamed = nyx._runner.run_streamed
    nyx._runner.run_streamed = lambda src, **kw: (
        streamed.append(src.shape), run_streamed(src, **kw))[1]
    assert nyx._stream_gate((192, 176)) and not _nyx()._stream_gate((192, 176))
    _same_rows(nyx.featurize_directory(*tiff_dirs), in_memory, rtol=1e-9)
    assert streamed == [(192, 176)] * 3


@pytest.mark.parametrize("tile", [64, 2048])
def test_run_streamed_tile_seams(tmp_path, tile):
    """PairRunner.run_streamed over a TIFF pair with ROIs on the border and
    across 64-px tile seams: the same labels and values as run."""
    intens, labels = make_blobs(150, 140, 12, seed=7)
    labels[58:70, 40:100] = 50              # across a row and a column seam
    labels[20:80, 134:] = 51                # on the right edge, across a seam
    labels = labels.astype(np.uint16)
    ip, lp = str(tmp_path / "i.tif"), str(tmp_path / "l.tif")
    write_tiff(ip, intens, tile_size=32)
    write_tiff(lp, labels, tile_size=48)
    runner = PairRunner(ttx.parse_feature_request(FEATS),
                        TConfig(precision="f64"), device="cpu")
    want_l, want_v = runner.run(intens, labels.astype(np.uint32))
    with TiffPairSource(ip, lp) as src:
        got_l, got_v = runner.run_streamed(src, tile=tile)
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(np.isnan(got_v), np.isnan(want_v))


def test_whole_slide_and_bad_pairs_raise(tiff_dirs, tmp_path, monkeypatch):
    """Whole-slide mode (no mask directory, or single_roi) gives one row an
    image, in memory and streamed alike, and under shard_slides each
    process's share of the images; pairs of mismatched or corrupt files
    raise."""
    int_dir, seg_dir = tiff_dirs
    nyx = _nyx(["MEAN", "AREA_PIXELS_COUNT", "BBOX_WIDTH"])
    ws = nyx.featurize_directory(int_dir)
    assert list(ws.ROI_label) == [1, 1, 1] and set(ws.mask_image) == {""}
    assert list(ws.AREA_PIXELS_COUNT) == [192 * 176] * 3
    assert list(ws.BBOX_WIDTH) == [177] * 3
    one = nyx.featurize_files([os.path.join(int_dir, "img0.tif")], [],
                              single_roi=True)
    assert len(one) == 1 and one.MEAN[0] == ws.MEAN[0]
    streamed = _nyx(["MEAN", "AREA_PIXELS_COUNT", "BBOX_WIDTH"],
                    ram_limit=1).featurize_directory(int_dir)
    _same_rows(streamed, ws, rtol=1e-12)
    with pytest.raises(IOError, match="does not exist"):
        nyx.featurize_directory(str(tmp_path / "none"), seg_dir)
    # a mask of another size, and a corrupt mask, raise from the pair
    for d in ("i", "s"):
        (tmp_path / d).mkdir()
    write_tiff(str(tmp_path / "i" / "a.tif"), np.ones((20, 30), np.uint16))
    write_tiff(str(tmp_path / "s" / "a.tif"), np.ones((20, 31), np.uint16))
    with pytest.raises(ValueError, match="dimension mismatch"):
        nyx.featurize_directory(str(tmp_path / "i"), str(tmp_path / "s"))
    (tmp_path / "s" / "a.tif").write_bytes(b"II*\0" + bytes(4))
    with pytest.raises(IOError):
        nyx.featurize_directory(str(tmp_path / "i"), str(tmp_path / "s"))
    # shard_slides under the environment override: process 1 of 2 takes
    # every second pair (here the one of three pairs the round-robin gives
    # it), with the rows the unsharded run gives those pairs
    monkeypatch.setenv("NYXUS_PROCESS_INDEX", "1")
    monkeypatch.setenv("NYXUS_PROCESS_COUNT", "2")
    part = _nyx(["MEAN", "AREA_PIXELS_COUNT", "BBOX_WIDTH"],
                shard_slides=True).featurize_directory(int_dir)
    names = sorted(set(ws.intensity_image))
    assert sorted(set(part.intensity_image)) == names[1::2]
    _same_rows(part, ws[ws.intensity_image.isin(names[1::2])]
               .reset_index(drop=True), rtol=0)
